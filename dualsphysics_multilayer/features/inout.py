"""Inlet/outlet open boundaries with fixed-capacity particle slots.

Re-design of the reference inout system (`JSphInOut` family,
SURVEY.md §2.10; runtime `JSphCpuSingle_InOut.cpp:72-251` ``InOutInit`` /
``InOutComputeStep``; GPU kernels `JSphGpu_InOut_iker.cu`).  The reference
grows/shrinks the particle arrays as inlet particles are created and outlet
particles removed; here the particle population is **fixed capacity**: dead
slots (special >= OUT) form a free pool, conversions are compaction-free
masked scatters, and the whole transition runs inside the jitted step with
static shapes.

Per zone and per step (the analog of ``InOutComputeStep``):

1. inout particles whose signed distance along the zone direction crosses the
   inlet plane (s > 0; the first lattice layer sits ON the plane) convert to
   plain fluid, and a replacement inout particle is spawned one zone-width
   behind them (the conveyor keeps the inter-particle spacing at dp;
   reference "creates new inlet particles" the same way);
2. inout particles that leave through the back of the zone (s < -width,
   outflow) are destroyed (special=OUT_MOVE, freeing their slot);
3. plain fluid particles that wander into the zone volume are captured as
   inout members (this is how an *outlet* ingests fluid; reference fluid->
   inout code transition);
4. every zone member gets its velocity imposed from the zone's profile
   (uniform/linear/parabolic x optional time series — `TpInVelMode`/
   `TpInVelProfile`, `JSphInOutDef.h:42-76`) and its density from the zone's
   mode (constant / hydrostatic; `TpInRhopMode` `JSphInOutDef.h:78-83`).

Zone tags live in dedicated typecode bits (`typesdef.code_inout`); inout
particles are fluid-typed, so the force/neighbour path sees them as regular
fluid neighbours with zero extra branches.

Like the reference, restart with inout zones is not supported
(`JSphCpuSingle_InOut.cpp:76`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph


@dataclass(frozen=True)
class InOutZone:
    """One open-boundary zone (reference `JSphInOutZone`).

    The zone volume is the box spanned by the inlet plane (through ``p0``,
    normal ``direction`` pointing INTO the fluid domain) and ``layers*dp``
    of depth behind it; ``tangent1``/``size1`` (and ``tangent2``/``size2``
    in 3D) bound it laterally.
    """
    p0: tuple                   # point on the inlet plane (zone center)
    direction: tuple            # unit normal, into the fluid domain
    layers: int                 # particle layers behind the plane
    tangent1: tuple             # lateral axis 1 (unit)
    size1: float                # extent along tangent1
    tangent2: tuple = (0.0, 1.0, 0.0)
    size2: float = 0.0          # extent along tangent2 (0 => 2D, unused)
    # lateral shape: "rect" (box/line) or "circle" (3-D disc of ``radius``
    # around p0 — `<zone3d><circle>`, _FmtXML_InOut.xml:214-218)
    shape: str = "rect"
    radius: float = 0.0
    # velocity: v(z,t) = (c0 + c1*z + c2*z^2) * timeseries(t)
    vel_profile: tuple = (0.0, 0.0, 0.0)   # (c0, c1, c2) in world z
    vel_times: tuple = ()       # ((t, factor), ...) -> linear interp, else 1
    # grid-interpolated velocity field (JSphInOutGridData, SWASH coupling):
    # overrides the analytical profile when set
    vel_grid: "InOutGridVel | None" = None
    # density mode: constant | hydrostatic
    rho_mode: str = "constant"
    # extrapolated modes (InVelM_Extrapolated / InRhop_Extrapolated): the
    # quantity is NOT imposed analytically; a ghost node mirrored across the
    # inlet plane interpolates it from the fluid with first-order MLS
    # correction (InteractionInOutExtrap, JSphCpu_InOut.cpp:55-238)
    vel_extrap: bool = False
    rho_extrap: bool = False
    # free-surface elevation (JSphInOutZsurf; `<imposezsurf mode=0|1|2>`,
    # _FmtXML_InOut.xml:304-330): fixed value, (t, zsurf) time series, or
    # calculated from the fluid near the inlet plane each step
    zsurf: float = 0.0
    zsurf_times: tuple = ()
    zsurf_calc: bool = False
    capture_fluid: bool = True  # convert stray fluid inside the zone (outlet)
    # refilling mode (TpInRefilling, JSphInOutDef.h:34-39):
    #   simplefull  — conveyor: a conversion spawns a replacement layer-deep
    #   simplezsurf — conveyor, but only spawn below the zone zsurf
    #   advanced    — periodic hole-filling of the zone lattice (reverse
    #                 flows / depleting outlets; <refillingrate> steps)
    refill: str = "simplefull"
    refillrate: int = 10
    # AWAS velocity correction (JSphInOutVelAwas; <imposevelocity><awas>)
    awas: "InOutAwas | None" = None


@dataclass(frozen=True)
class InOutAwas:
    """AWAS (active wave absorption) correction on an inout zone's imposed
    velocity (reference `JSphInOutVelAwas`, JSphInOutVelAwas.cpp:147-161):
    each step the free-surface level is measured at a gauge just inside the
    zone and compared with a target time series; the velocity correction

        velcorr = (zgauge - ztarget) * sqrt(-gravity.z / depth)   [inletmode]
                = (ztarget - zgauge) * sqrt(-gravity.z / depth)   [outlet]

    is added to the imposed zone velocity along the zone direction.  The
    reference measures zgauge with a vertical GaugeSwl sweep; here it is the
    column-mass elevation (a masked O(n) sum, jit-traceable, zero host
    round-trips) anchored at the bed ``z0``."""
    inletmode: bool = True
    startawas: float = 0.0        # time to start correcting
    depth: float = 1.0            # initial water depth at the zone
    zsurf_t: tuple = ()           # target SWL time series: times
    zsurf_v: tuple = ()           # target SWL time series: values (abs z)
    gauge_x: float = 0.0          # gauge position (world x)
    gauge_y: float = 0.0          # gauge position (world y; 3-D only)
    z0: float = 0.0               # bed elevation below the gauge
    band: float = 0.0             # gauge band half-width (default 1.5 dp)

    def ztarget(self, tabs):
        ts = jnp.asarray(self.zsurf_t, jnp.float32)
        zs = jnp.asarray(self.zsurf_v, jnp.float32)
        return jnp.interp(jnp.asarray(tabs, jnp.float32), ts, zs)


def _awas_velcorr(aw: InOutAwas, csp: CteSph, pos, code, tabs,
                  axis=None):
    """Scalar AWAS velocity correction for one zone at time ``tabs``.
    ``axis``: mesh axis name — the column-mass sum spans shards."""
    dp = csp.dp
    band = aw.band or 1.5 * dp
    fluid = td.is_fluid(code) & td.is_active(code)
    inband = fluid & (jnp.abs(pos[:, 0] - aw.gauge_x) <= band)
    if csp.simulate2d:
        colarea = 2.0 * band
        vol_per = dp ** 2
    else:
        inband = inband & (jnp.abs(pos[:, 1] - aw.gauge_y) <= 0.5 * dp)
        colarea = 2.0 * band * dp
        vol_per = dp ** 3
    colmass = jnp.sum(jnp.where(inband, vol_per, 0.0))
    if axis is not None:
        colmass = jax.lax.psum(colmass, axis)
    zgauge = aw.z0 + colmass / colarea
    gz = float(csp.gravity[2]) if csp.gravity[2] else -9.81
    coefdepth = math.sqrt(-gz / aw.depth)
    diff = zgauge - aw.ztarget(tabs)
    corr = (diff if aw.inletmode else -diff) * coefdepth
    return jnp.where(jnp.asarray(tabs) >= aw.startawas, corr, 0.0)


@dataclass(frozen=True)
class InOutCfg:
    zones: tuple                # (InOutZone, ...) — zone z gets tag z+1
    n_usable: int = 0           # free-slot scan limit (0 = whole array);
                                # set below the periodic ghost tail if both
                                # features are active
    # MLS determinant gate for the extrapolated modes (<determlimit>,
    # JSphInOut.cpp:145 — 1e-3 first-order, 1e+3 zeroth-order; default 1e+3)
    determlimit: float = 1e3

    def __post_init__(self):
        if len(self.zones) > td.MAX_INOUT_ZONES:
            raise ValueError(f"at most {td.MAX_INOUT_ZONES} inout zones")


def _unit(v):
    v = np.asarray(v, np.float64)
    return tuple(v / np.linalg.norm(v))


@dataclass(frozen=True)
class InOutGridVel:
    """Time x (x,z)-grid velocity table (reference JSphInOutGridData:
    `<gridveldata file=...>` CSV, e.g. SWASH output; `SetPosMin` plants the
    grid origin at the zone).  Tuples keep the config hashable; they embed
    as constants in the jitted step."""
    times: tuple                # (T,) increasing
    nx: int
    nz: int
    dpx: float
    dpz: float
    posmin: tuple = (0.0, 0.0)  # grid origin (x0, z0)
    velx: tuple = ()            # (T*nz*nx,) row-major [t][z][x]
    velz: tuple = ()            # same or () when vars == "velx"
    velcorr: float = 0.0        # subtracted from velx (paddle drift corr)

    def at(self, pos, tabs):
        """Clamped time-linear + (x,z)-bilinear sample at particle positions
        (InterpolateVelCpu, JSphInOutGridData.cpp:349-420)."""
        T = len(self.times)
        f32 = pos.dtype
        times = jnp.asarray(self.times, f32)
        vx = jnp.asarray(self.velx, f32).reshape(T, self.nz, self.nx)
        it = jnp.clip(jnp.searchsorted(times, jnp.asarray(tabs, f32),
                                       side="right") - 1, 0, T - 1)
        it2 = jnp.minimum(it + 1, T - 1)
        dt_ = times[it2] - times[it]
        ft = jnp.where(dt_ > 0, (tabs - times[it]) / jnp.maximum(dt_, 1e-30),
                       0.0)
        ft = jnp.clip(ft, 0.0, 1.0)
        gx = (1.0 - ft) * vx[it] + ft * vx[it2]          # (nz, nx)
        px = (pos[:, 0] - self.posmin[0]) / self.dpx
        pz = (pos[:, 2] - self.posmin[1]) / self.dpz
        cx = jnp.clip(jnp.floor(px).astype(jnp.int32), 0, self.nx - 1)
        cz = jnp.clip(jnp.floor(pz).astype(jnp.int32), 0, self.nz - 1)
        cx2 = jnp.minimum(cx + 1, self.nx - 1)
        cz2 = jnp.minimum(cz + 1, self.nz - 1)
        fx = jnp.clip(px - cx, 0.0, 1.0)
        fz = jnp.clip(pz - cz, 0.0, 1.0)

        def sample(g):
            v00 = g[cz, cx]
            v01 = g[cz, cx2]
            v10 = g[cz2, cx]
            v11 = g[cz2, cx2]
            return ((1 - fz) * ((1 - fx) * v00 + fx * v01)
                    + fz * ((1 - fx) * v10 + fx * v11))

        outx = sample(gx) - jnp.asarray(self.velcorr, f32)
        if self.velz:
            vz = jnp.asarray(self.velz, f32).reshape(T, self.nz, self.nx)
            gz = (1.0 - ft) * vz[it] + ft * vz[it2]
            outz = sample(gz)
        else:
            outz = jnp.zeros_like(outx)
        return outx, outz


def load_inout_gridvel(path, posmin=(0.0, 0.0), velcorr=0.0) -> InOutGridVel:
    """Load the reference gridveldata CSV (JSphInOutGridData::LoadDataCsv):
    header rows fmtversion / grid_dpx;grid_dpz;grid_nx;grid_nz;vars, then
    one row per time: t;velx[npt]...(;velz[npt]...)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                rows.append([p for p in line.replace(";", " ").replace(
                    ",", " ").split() if p])
    head = {k.lower(): i for i, k in enumerate(rows[0])}
    if "fmtversion" not in head:
        raise ValueError(f"{path}: fmtversion header missing")
    vals = rows[1]
    dpx = float(vals[head["grid_dpx"]])
    dpz = float(vals[head["grid_dpz"]])
    nx = int(float(vals[head["grid_nx"]]))
    nz = int(float(vals[head["grid_nz"]]))
    # vars may occupy the remaining columns ("velx velz" splits in two)
    varcols = rows[0][head["vars"]:]
    usevelz = any("velz" in " ".join(r[head["vars"]:]).lower()
                  for r in rows[:2]) or "velz" in " ".join(varcols).lower()
    npt = nx * nz
    times, vxs, vzs = [], [], []
    for r in rows[2:]:
        want = 1 + npt * (2 if usevelz else 1)
        if len(r) < want:
            continue
        times.append(float(r[0]))
        vxs.extend(float(x) for x in r[1:1 + npt])
        if usevelz:
            vzs.extend(float(x) for x in r[1 + npt:1 + 2 * npt])
    if not times:
        raise ValueError(f"{path}: no time rows parsed")
    return InOutGridVel(times=tuple(times), nx=nx, nz=nz, dpx=dpx, dpz=dpz,
                        posmin=tuple(posmin), velx=tuple(vxs),
                        velz=tuple(vzs), velcorr=velcorr)


def zone_points(zone: InOutZone, csp: CteSph):
    """Initial inout lattice for a zone: ``layers`` planes of dp-spaced
    points, layer l at signed distance -l*dp — the FIRST layer sits ON the
    inlet plane, matching a fluid lattice whose first column is one dp
    inside (the reference's point placement: golden channel run puts inout
    points at x = plane, plane-dp, ... with fluid from plane+dp), so
    conveyor conversions preserve dp spacing.

    Mirrors `JSphInOutPoints` point generation for the line/box shapes."""
    dp = csp.dp
    d = np.asarray(_unit(zone.direction))
    t1 = np.asarray(_unit(zone.tangent1))
    if zone.shape == "circle":
        # dp lattice clipped to the disc (JSphInOutPoints circle shape)
        r = zone.radius
        nr = max(1, int(round(2 * r / dp)))
        u = (np.arange(nr + 1) - nr / 2.0) * dp
        t2 = np.asarray(_unit(zone.tangent2))
        U1, U2 = np.meshgrid(u, u, indexing="ij")
        keep = U1 ** 2 + U2 ** 2 <= (r + 1e-9) ** 2
        lat = (U1[keep][:, None] * t1[None, :]
               + U2[keep][:, None] * t2[None, :])
    else:
        n1 = max(1, int(round(zone.size1 / dp)))
        u1 = (np.arange(n1) - (n1 - 1) / 2.0) * dp
        if csp.simulate2d or zone.size2 <= 0:
            lat = u1[:, None] * t1[None, :]
        else:
            t2 = np.asarray(_unit(zone.tangent2))
            n2 = max(1, int(round(zone.size2 / dp)))
            u2 = (np.arange(n2) - (n2 - 1) / 2.0) * dp
            lat = (u1[:, None, None] * t1[None, None, :]
                   + u2[None, :, None] * t2[None, None, :]).reshape(-1, 3)
    p0 = np.asarray(zone.p0, np.float64)
    pts = []
    for l in range(zone.layers):
        s = -l * dp
        pts.append(p0[None, :] + s * d[None, :] + lat)
    pts = np.concatenate(pts, axis=0)
    if zone.rho_mode == "hydrostatic" and zone.zsurf:
        pts = pts[pts[:, 2] <= zone.zsurf + 0.25 * dp]
    return pts


def init_inout(cfg: InOutCfg, csp: CteSph, st):
    """Create the initial zone particles in dead slots of ``st`` (host-side,
    at setup — the analog of ``InOutInit``, `JSphCpuSingle_InOut.cpp:72`).
    Returns the updated state."""
    pos = np.array(st.pos, np.float64)
    vel = np.array(st.vel, np.float64)
    rho = np.array(st.rho, np.float64)
    code = np.array(st.code)
    nlim = cfg.n_usable or len(code)
    free = np.flatnonzero(~np.asarray(td.is_active(code[:nlim])))
    k = 0
    for zi, zone in enumerate(cfg.zones):
        pts = zone_points(zone, csp)
        m = len(pts)
        if k + m > len(free):
            raise ValueError(
                f"not enough free particle slots for inout zone {zi}: need "
                f"{k + m}, have {len(free)} — raise the state capacity "
                f"(reference analog: ResizeParticlesSize on InOutInit)")
        sl = free[k:k + m]
        k += m
        pos[sl] = pts
        c = td.code_make(td.TYPE_FLUID, 0)
        c = td.code_set_inout(c, zi + 1)
        code[sl] = c
        v, r = _imposed(zone, csp, jnp.asarray(pts), 0.0)
        vel[sl] = np.asarray(v)
        rho[sl] = np.asarray(r)
    f32 = st.vel.dtype
    upd = dict(pos=jnp.asarray(pos, st.pos.dtype), vel=jnp.asarray(vel, f32),
               rho=jnp.asarray(rho, f32), code=jnp.asarray(code))
    if st.velm1 is not None:
        upd["velm1"] = upd["vel"]
    if st.rhom1 is not None:
        upd["rhom1"] = upd["rho"]
    return replace(st, **upd)


def _zsurf_at(zone: InOutZone, csp: CteSph, tabs, st=None, axis=None):
    """Effective zone zsurf (JSphInOutZsurf): fixed value, time series, or —
    for the calculated mode — the max fluid z within the zone's lateral
    footprint in a 2h band ahead of the inlet plane (the static-shape stand-in
    for the reference's gauge sweep `JSphInOutZsurf::ComputeZsurf`)."""
    if zone.zsurf_times:
        ts = jnp.asarray([t for t, _ in zone.zsurf_times], jnp.float32)
        zs = jnp.asarray([z for _, z in zone.zsurf_times], jnp.float32)
        return jnp.interp(jnp.asarray(tabs, jnp.float32), ts, zs)
    if zone.zsurf_calc and st is not None:
        pos, code = st.pos, st.code
        d = jnp.asarray(_unit(zone.direction), pos.dtype)
        t1 = jnp.asarray(_unit(zone.tangent1), pos.dtype)
        p0 = jnp.asarray(zone.p0, pos.dtype)
        rel = pos - p0[None, :]
        s = rel @ d
        m = (td.is_fluid(code) & td.is_active(code)
             & (s >= 0.0) & (s <= 2.0 * csp.kernelsize)
             & (jnp.abs(rel @ t1) <= zone.size1 * 0.5 + 0.5 * csp.dp))
        if not csp.simulate2d and zone.size2 > 0:
            t2 = jnp.asarray(_unit(zone.tangent2), pos.dtype)
            m &= jnp.abs(rel @ t2) <= zone.size2 * 0.5 + 0.5 * csp.dp
        zc = jnp.max(jnp.where(m, pos[:, 2], jnp.asarray(zone.zsurf,
                                                         pos.dtype)))
        return jax.lax.pmax(zc, axis) if axis is not None else zc
    return jnp.asarray(zone.zsurf, jnp.float32)


def _imposed(zone: InOutZone, csp: CteSph, pos, tabs, zsurf=None):
    """Imposed (vel, rho) for zone members at positions ``pos``, time ``tabs``
    (reference `JSphInOutVel` analytical modes + `JSphInOutZone` rhop modes)."""
    from ..ops import eos
    d = _unit(zone.direction)
    z = pos[:, 2]
    if zone.vel_grid is not None:
        # grid-interpolated world vx/vz (JSphInOutGridData::InterpolateVelCpu
        # writes velrhop.x/.z directly)
        gvx, gvz = zone.vel_grid.at(pos, tabs)
        vel = jnp.stack([gvx, jnp.zeros_like(gvx), gvz], axis=-1)
    else:
        c0, c1, c2 = zone.vel_profile
        mag = c0 + c1 * z + c2 * z * z
        if zone.vel_times:
            ts = jnp.asarray([t for t, _ in zone.vel_times], jnp.float32)
            vs = jnp.asarray([v for _, v in zone.vel_times], jnp.float32)
            mag = mag * jnp.interp(jnp.asarray(tabs, jnp.float32), ts, vs)
        vel = mag[:, None] * jnp.asarray(d, pos.dtype)[None, :]
    if zone.rho_mode == "hydrostatic":
        zs = zone.zsurf if zsurf is None else zsurf
        rho = eos.hydrostatic_rho(csp, z, zs)
    else:
        rho = jnp.full_like(z, csp.rhopzero)
    return vel, rho


def any_extrap(cfg: InOutCfg) -> bool:
    return any(z.vel_extrap or z.rho_extrap for z in cfg.zones)


def inout_extrapolate(cfg: InOutCfg, csp: CteSph, dom, st, origin=None):
    """Ghost-node extrapolation for zones with extrapolated vel/rhop modes
    (`InteractionInOutExtrap_Double`, JSphCpu_InOut.cpp:55-238).

    Per inout particle of such a zone: mirror it across the inlet plane into
    the fluid (ghost = pos - 2*s*d, s = signed plane distance < 0), gather
    fluid (non-inout) neighbours of the ghost, build the first-order MLS
    system — the SAME volume-weighted correction matrix as mDBC, with four
    right-hand sides (mass-weighted density + volume-weighted velocity
    components) — and evaluate the corrected field back at the particle.
    Determinant-gated 1st order -> 0th order (Shepard) -> keep-current, like
    the reference.  Returns updated (vel, rho)."""
    from ..ops import celldiv as cd
    from ..ops import kernels as K

    pos, vel, rho, code = st.pos, st.vel, st.rho, st.code
    n = pos.shape[0]
    f32 = vel.dtype
    active = td.is_active(code)
    itag = td.code_inout(code)

    sel = jnp.zeros((n,), bool)
    wantv = jnp.zeros((n,), bool)
    wantr = jnp.zeros((n,), bool)
    ghost = pos
    for zi, zone in enumerate(cfg.zones):
        if not (zone.vel_extrap or zone.rho_extrap):
            continue
        member = (itag == zi + 1) & active
        d = jnp.asarray(_unit(zone.direction), pos.dtype)
        p0 = jnp.asarray(zone.p0, pos.dtype)
        s = (pos - p0[None, :]) @ d
        ghost = jnp.where(member[:, None], pos - (2.0 * s)[:, None] * d, ghost)
        sel |= member
        if zone.vel_extrap:
            wantv |= member
        if zone.rho_extrap:
            wantr |= member
    if not any_extrap(cfg):
        return vel, rho

    div, _ = cd.divide(dom, pos, code, origin=origin)
    cand = cd.point_candidates(dom, div, ghost, origin)  # (n, M)
    cpos = cd.gather(pos, cand)
    cvel = cd.gather(vel, cand)
    crho = cd.gather(rho, cand, fill=1.0)
    ccode = cd.gather(code, cand,
                      fill=td.code_make(td.TYPE_FIXED, 0,
                                        td.SPECIAL_OUT_IGNORE))
    fluid_c = (td.is_fluid(ccode) & td.is_active(ccode)
               & ~td.is_inout(ccode) & (cand < n))

    dr = ghost[:, None, :] - cpos                        # (n, M, 3)
    rr2 = jnp.sum(dr * dr, axis=-1)
    ks2 = jnp.asarray(csp.kernelsize2, f32)
    pair = sel[:, None] & fluid_c & (rr2 <= ks2) & (rr2 >= 1e-18)
    pw = pair.astype(f32)
    rr2s = jnp.where(pair, rr2, ks2)

    wab = pw * K.kernel_wab(csp, rr2s)
    fac = pw * K.kernel_fac(csp, rr2s)
    fr = fac[..., None] * dr                             # (n, M, 3)

    massp2 = jnp.asarray(csp.massfluid, f32)
    volp2 = massp2 / crho                                # (n, M)

    dims = (0, 2) if csp.simulate2d else (0, 1, 2)
    d = 1 + len(dims)
    # correction matrix A: rows [vwab, vfr_k], cols [1, dr_k] (volume-weighted)
    vwab = wab * volp2
    rowsv = [vwab] + [fr[..., k] * volp2 for k in dims]
    amat = jnp.stack([
        jnp.stack([jnp.sum(r, 1)] + [jnp.sum(r * dr[..., k], 1)
                                     for k in dims], axis=-1)
        for r in rowsv], axis=-2)                        # (n, d, d)
    # RHS columns: density (mass-weighted), velocity components (vol-weighted)
    bcols = [jnp.stack([jnp.sum(massp2 * wab, 1)]
                       + [jnp.sum(massp2 * fr[..., k], 1) for k in dims],
                       axis=-1)]
    for q in range(3):
        vq = cvel[..., q]
        bcols.append(jnp.stack([jnp.sum(vwab * vq, 1)]
                               + [jnp.sum(fr[..., k] * volp2 * vq, 1)
                                  for k in dims], axis=-1))
    b = jnp.stack(bcols, axis=-1)                        # (n, d, 4)

    determ = jnp.linalg.det(amat)
    ok1 = jnp.abs(determ) >= cfg.determlimit
    eye = jnp.eye(d, dtype=f32)
    amat_safe = jnp.where(ok1[:, None, None], amat, eye)
    sol = jnp.linalg.solve(amat_safe, b)                 # (n, d, 4)
    dpos = pos - ghost                                   # particle - ghost
    dposd = jnp.stack([dpos[:, k] for k in dims], axis=-1)      # (n, d-1)
    val1 = sol[:, 0, :] - jnp.einsum("nk,nkq->nq", dposd, sol[:, 1:, :])

    a11 = amat[:, 0, 0]
    ok0 = a11 > 0
    val0 = b[:, 0, :] / jnp.where(ok0, a11, 1.0)[:, None]

    cur = jnp.concatenate([rho[:, None], vel], axis=1)   # [rho, vx, vy, vz]
    val = jnp.where(ok1[:, None], val1, jnp.where(ok0[:, None], val0, cur))

    new_rho = jnp.where(wantr, val[:, 0].astype(rho.dtype), rho)
    new_vel = jnp.where(wantv[:, None], val[:, 1:].astype(f32), vel)
    if csp.simulate2d:
        new_vel = new_vel.at[:, 1].set(0.0)
    return new_vel, new_rho


def inout_step(cfg: InOutCfg, csp: CteSph, st, dt, tabs, nstep=None,
               dom=None, origin=None, axis=None):
    """One inout transition pass (jit-traceable, static shapes).  Returns
    (state, overflow) where overflow counts spawn requests that found no free
    slot (the fail-loudly analog of the reference's array resize)."""
    pos, vel, rho, code = st.pos, st.vel, st.rho, st.code
    n = pos.shape[0]
    nlim = cfg.n_usable or n
    iarange = jnp.arange(n, dtype=jnp.int32)
    overflow = jnp.zeros((), jnp.int32)
    dp = csp.dp

    for zi, zone in enumerate(cfg.zones):
        tag = zi + 1
        d = jnp.asarray(_unit(zone.direction), pos.dtype)
        t1 = jnp.asarray(_unit(zone.tangent1), pos.dtype)
        p0 = jnp.asarray(zone.p0, pos.dtype)
        width = zone.layers * dp
        rel = pos - p0[None, :]
        s = rel @ d
        active = td.is_active(code)
        member = (td.code_inout(code) == tag) & active

        # lateral membership for fluid capture
        if zone.shape == "circle":
            t2 = jnp.asarray(_unit(zone.tangent2), pos.dtype)
            u1, u2 = rel @ t1, rel @ t2
            lat_ok = u1 * u1 + u2 * u2 <= (zone.radius + 0.5 * dp) ** 2
        else:
            lat_ok = jnp.abs(rel @ t1) <= (zone.size1 * 0.5 + 0.5 * dp)
            if not csp.simulate2d and zone.size2 > 0:
                t2 = jnp.asarray(_unit(zone.tangent2), pos.dtype)
                lat_ok &= jnp.abs(rel @ t2) <= (zone.size2 * 0.5 + 0.5 * dp)

        # 1) inout -> fluid conversion at the inlet plane
        # strict inequality: the first lattice layer sits exactly ON the
        # plane (s == 0) and must stay inout until it actually moves inside
        cross = member & (s > 0.0)
        code = jnp.where(cross, td.code_set_inout(code, 0), code)

        # 2) inout leaving through the back: destroyed
        out_back = member & (s < -width)
        deadcode = td.code_set_special(code, td.SPECIAL_OUT_MOVE)
        code = jnp.where(out_back, deadcode, code)

        # 3) fluid capture inside the zone volume (outlet ingestion)
        if zone.capture_fluid:
            plain_fluid = td.is_fluid(code) & ~td.is_inout(code) & \
                td.is_normal(code)
            cap = plain_fluid & (s < 0.0) & (s >= -width) & lat_ok
            code = jnp.where(cap, td.code_set_inout(code, tag), code)

        def free_slots(code):
            free = (~td.is_active(code)) & (iarange < nlim)
            nfree = jnp.sum(free.astype(jnp.int32))
            freerank = jnp.cumsum(free.astype(jnp.int32)) - 1
            slot_of_rank = jnp.full((n,), n, jnp.int32).at[
                jnp.where(free, freerank, n)].set(iarange, mode="drop")
            return nfree, slot_of_rank

        if zone.refill != "advanced":
            # 4) conveyor spawn: a replacement one width behind each crosser
            # (InRefill_SimpleFull); SimpleZsurf only spawns below zsurf
            spawn_pos = pos - width * d[None, :]
            req = cross
            if zone.refill == "simplezsurf" and (
                    zone.zsurf or zone.zsurf_times or zone.zsurf_calc):
                zs = _zsurf_at(zone, csp, tabs, st, axis=axis)
                req = req & (spawn_pos[:, 2] <= zs + 0.25 * dp)
            nfree, slot_of_rank = free_slots(code)
            nreq = jnp.sum(req.astype(jnp.int32))
            overflow += jnp.maximum(nreq - nfree, 0)
            # rank matching: k-th request <- k-th free slot
            reqrank = jnp.cumsum(req.astype(jnp.int32)) - 1
            ok = req & (reqrank < nfree)
            dst = jnp.where(ok, slot_of_rank[jnp.clip(reqrank, 0, n - 1)], n)
            newcode = td.code_set_inout(
                td.code_set_special(code, td.SPECIAL_NORMAL), tag)
            pos = pos.at[dst].set(spawn_pos, mode="drop")
            vel = vel.at[dst].set(vel, mode="drop")
            rho = rho.at[dst].set(rho, mode="drop")
            code = code.at[dst].set(newcode, mode="drop")
        else:
            # 4') advanced refilling (InRefill_Advanced + <refillingrate>):
            # every refillrate steps, re-occupy every hole of the zone's
            # dp-lattice that has no member within dp/2 — covers reverse
            # flows and depleting outlets where the conveyor never fires.
            latpts = jnp.asarray(zone_points(zone, csp), pos.dtype)  # (M,3)
            M = latpts.shape[0]
            lrel = latpts - p0[None, :]
            l_lay = jnp.round(-(lrel @ d) / dp).astype(jnp.int32)
            l_u1 = jnp.round(lrel @ t1 / dp).astype(jnp.int32)
            u1span = int(round(zone.size1 / dp)) + 3
            lkey = l_lay * (2 * u1span) + (l_u1 + u1span)
            nkey = zone.layers * 2 * u1span
            if not csp.simulate2d and zone.size2 > 0:
                t2z = jnp.asarray(_unit(zone.tangent2), pos.dtype)
                l_u2 = jnp.round(lrel @ t2z / dp).astype(jnp.int32)
                u2span = int(round(zone.size2 / dp)) + 3
                lkey = lkey * (2 * u2span) + (l_u2 + u2span)
                nkey = nkey * 2 * u2span

            def refill(args):
                pos, vel, rho, code, overflow = args
                memb = (td.code_inout(code) == tag) & td.is_active(code)
                prel = pos - p0[None, :]
                p_lay = jnp.round(-(prel @ d) / dp).astype(jnp.int32)
                p_u1 = jnp.round(prel @ t1 / dp).astype(jnp.int32)
                pkey = p_lay * (2 * u1span) + (p_u1 + u1span)
                if not csp.simulate2d and zone.size2 > 0:
                    p_u2 = jnp.round(prel @ t2z / dp).astype(jnp.int32)
                    pkey = pkey * (2 * u2span) + (p_u2 + u2span)
                covered = jnp.zeros((nkey,), jnp.int32).at[
                    jnp.where(memb, jnp.clip(pkey, 0, nkey - 1), nkey)
                ].max(1, mode="drop")
                hole = covered[jnp.clip(lkey, 0, nkey - 1)] == 0   # (M,)
                nfree, slot_of_rank = free_slots(code)
                nreq = jnp.sum(hole.astype(jnp.int32))
                overflow = overflow + jnp.maximum(nreq - nfree, 0)
                hrank = jnp.cumsum(hole.astype(jnp.int32)) - 1
                ok = hole & (hrank < nfree)
                dst = jnp.where(ok, slot_of_rank[jnp.clip(hrank, 0, n - 1)],
                                n)
                newc = td.code_set_inout(
                    td.code_make(td.TYPE_FLUID, 0), tag)
                pos = pos.at[dst].set(latpts, mode="drop")
                vel = vel.at[dst].set(0.0, mode="drop")
                rho = rho.at[dst].set(jnp.float32(csp.rhopzero), mode="drop")
                code = code.at[dst].set(jnp.asarray(newc, code.dtype),
                                        mode="drop")
                return pos, vel, rho, code, overflow

            tick = (nstep % max(zone.refillrate, 1)) == 0 \
                if nstep is not None else jnp.bool_(True)
            pos, vel, rho, code, overflow = jax.lax.cond(
                tick, refill, lambda a: a, (pos, vel, rho, code, overflow))

        # 5) impose zone velocity / density on all members (extrapolated
        # quantities are assigned by the ghost-node pass below instead)
        member2 = (td.code_inout(code) == tag) & td.is_active(code)
        iv, ir = _imposed(zone, csp, pos, tabs,
                          zsurf=_zsurf_at(zone, csp, tabs, st, axis=axis))
        if zone.awas is not None and not zone.vel_extrap:
            # the reference SUBTRACTS velcorr from the imposed velocity
            # (InterpolateVelCpu `velrhop[p]=TFloat4(v-velcorr,...)`,
            # JSphInOutGridData.cpp:383)
            vc = _awas_velcorr(zone.awas, csp, pos, code, tabs,
                               axis=axis)
            iv = iv - vc * d[None, :]
        if not zone.vel_extrap:
            vel = jnp.where(member2[:, None], iv.astype(vel.dtype), vel)
        if not zone.rho_extrap:
            rho = jnp.where(member2, ir.astype(rho.dtype), rho)

    if any_extrap(cfg):
        if dom is None:
            raise ValueError("inout zones with extrapolated vel/rhop modes "
                             "need the domain passed to inout_step")
        vel, rho = inout_extrapolate(
            cfg, csp, dom, replace(st, pos=pos, vel=vel, rho=rho, code=code),
            origin=origin)

    upd = dict(pos=pos, vel=vel, rho=rho, code=code)
    if st.velm1 is not None:
        m = td.is_inout(code)[:, None]
        upd["velm1"] = jnp.where(m, vel, st.velm1)
    if st.rhom1 is not None:
        upd["rhom1"] = jnp.where(td.is_inout(code), rho, st.rhom1)
    return replace(st, **upd), overflow


def slots_required(cfg: InOutCfg, csp: CteSph, t_horizon: float = 0.0) -> int:
    """Slot budget: initial zone particles + inflow over ``t_horizon`` at the
    peak profile velocity (capacity provisioning guidance for cases)."""
    total = 0
    for zone in cfg.zones:
        pts = len(zone_points(zone, csp))
        total += pts
        if t_horizon > 0:
            c0, c1, c2 = zone.vel_profile
            zs = [zone.p0[2] - zone.size1, zone.p0[2] + zone.size1]
            vmax = max(abs(c0 + c1 * z + c2 * z * z) for z in zs)
            perlayer = pts / max(zone.layers, 1)
            total += int(math.ceil(vmax * t_horizon / csp.dp) * perlayer)
    return total
