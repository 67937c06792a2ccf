"""Force points and mooring lines for floating bodies.

Replacement for the reference's closed-lib couplings
(`JDsFtForcePoints` — external point forces summed into the rigid solve,
`JSphCpuSingle.cpp:903-913, 1009-1015`; `JDsMooredFloatings` + MoorDyn+
`libdsphmoordyn`, SURVEY §2.12): body-attached fairlead points receive line
tensions that enter the 6-DOF solve as extra force + torque, evaluated
inside the jitted step (no host round trip).

The line model is a quasi-static elastic catenary approximation in the
spirit of lumped-mass MoorDyn's static limit:

* taut line (length > unstretched L0): axial tension
  T = k (l - L0) / L0 + c d(l)/dt  along the line, k = EA stiffness,
* slack line: zero tension (optionally a small net-weight pull),
* seabed/weight sag is not modeled (a later refinement can swap in the
  analytic catenary without touching the coupling).

`MooringCfg.forces(ftstate)` returns (ext_face, ext_fomegaace) shaped (B,3),
the exact quantities `features.floating.run_floating` accepts — mirroring
how the reference folds ForcePoints into FtoForces before FtCalcForces.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class MooringLine:
    """One line: world anchor -> body-fixed fairlead on body ``body``."""
    body: int
    anchor: tuple          # world coordinates
    fairlead: tuple        # body-frame offset from the body center (at t=0)
    length0: float         # unstretched length
    stiffness: float       # EA/L0-style axial stiffness (N per unit strain)
    damping: float = 0.0   # axial damping (N s/m)


@dataclass(frozen=True)
class MooringCfg:
    lines: tuple           # (MooringLine, ...)
    nbodies: int

    def forces(self, fts, f32=jnp.float32):
        """Line tensions -> per-body (force, torque) sums.  ``fts`` is the
        FloatingState (center/fvel/fomega/angles)."""
        from .floating import _euler_rot
        B = self.nbodies
        face = jnp.zeros((B, 3), f32)
        fom = jnp.zeros((B, 3), f32)
        R = _euler_rot(fts.angles)                    # (B,3,3)
        for ln in self.lines:
            b = ln.body
            r_local = jnp.asarray(ln.fairlead, f32)
            r_world = R[b] @ r_local                  # rotated arm
            p_fair = fts.center[b] + r_world
            v_fair = fts.fvel[b] + jnp.cross(fts.fomega[b], r_world)
            d = jnp.asarray(ln.anchor, f32) - p_fair  # fairlead -> anchor
            l = jnp.sqrt(jnp.sum(d * d) + 1e-12)
            u = d / l
            strain = (l - ln.length0) / ln.length0
            lrate = -jnp.sum(v_fair * u)              # d(l)/dt
            tension = jnp.maximum(
                ln.stiffness * strain + ln.damping * lrate, 0.0)
            taut = (strain > 0.0).astype(f32)
            f = taut * tension * u
            face = face.at[b].add(f)
            fom = fom.at[b].add(jnp.cross(r_world, f))
        return face, fom


@dataclass(frozen=True)
class ForcePoint:
    """External time-varying point force on a body (`JDsFtForcePoints`):
    force(t) linearly interpolated from a table, applied at a body-fixed
    point."""
    body: int
    point: tuple           # body-frame offset from the center
    times: tuple = (0.0,)
    forces: tuple = (0.0, 0.0, 0.0)   # (nt*3,) row-major

    def force_at(self, t, f32=jnp.float32):
        times = jnp.asarray(self.times, f32)
        vals = jnp.asarray(self.forces, f32).reshape(len(self.times), 3)
        if len(self.times) == 1:
            return vals[0]
        t = jnp.clip(t, times[0], times[-1])
        i = jnp.clip(jnp.searchsorted(times, t, side="right") - 1,
                     0, len(self.times) - 2)
        f = (t - times[i]) / jnp.maximum(times[i + 1] - times[i], 1e-12)
        return vals[i] * (1 - f) + vals[i + 1] * f


@dataclass(frozen=True)
class ForcePointsCfg:
    points: tuple
    nbodies: int

    def forces(self, fts, tabs, f32=jnp.float32):
        from .floating import _euler_rot
        B = self.nbodies
        face = jnp.zeros((B, 3), f32)
        fom = jnp.zeros((B, 3), f32)
        R = _euler_rot(fts.angles)
        for fp in self.points:
            b = fp.body
            r_world = R[b] @ jnp.asarray(fp.point, f32)
            f = fp.force_at(tabs, f32)
            face = face.at[b].add(f)
            fom = fom.at[b].add(jnp.cross(r_world, f))
        return face, fom


# ---------------------------------------------------------------------------
# Dynamic lumped-mass mooring lines (MoorDyn+ model)
# ---------------------------------------------------------------------------
# The reference couples to the closed `libdsphmoordyn_64.a` (JDsMooredFloatings
# -> MoorDyn_FairleadsCalc each step, JSphCpuSingle.cpp:1009-1015).  This is a
# native re-implementation of the underlying lumped-mass model (Hall & Goupee
# 2015, the MoorDyn paper): each line is N segments / N+1 nodes; internal
# nodes carry mass + directional added mass and feel segment tension,
# internal damping, net weight, Morison drag and seabed spring/damper/
# friction forces; end nodes are kinematic (anchor / connect frozen,
# fairlead driven by the body).  The whole system integrates with
# semi-implicit Euler at a fixed substep count inside the jitted SPH step —
# no host round trips.
# Parameters map 1:1 to the moordyn.xml schema (_FmtXML_MoorDyn.xml:
# solverOptions kBot/cBot/dtM/frictionCoefficient/fricDamp, linedefault
# e|ea/diameter/massDenInAir/ba/can/cat/cdn/cdt/breaktension).


@dataclass(frozen=True)
class MoorDynLine:
    """One dynamic line: anchor (world) -> fairlead (body frame offset)."""
    body: int
    anchor: tuple
    fairlead: tuple        # body-frame offset from the body center (at t=0)
    length0: float         # unstretched length
    ea: float              # axial stiffness EA [N]
    nseg: int = 20         # <segments>
    diameter: float = 0.0  # volume-equivalent diameter [m]
    massden: float = 0.0   # mass per length in air [kg/m]
    ba: float = -0.8       # internal damping [N s]; negative = -zeta ratio
    can: float = 1.0       # transverse added-mass coefficient
    cat: float = 0.0       # tangential added-mass coefficient
    cdn: float = 1.6       # transverse drag coefficient
    cdt: float = 0.05      # tangential drag coefficient
    breaktension: float = 0.0   # max tension (0 = unused)
    zbot: float = 0.0      # seabed elevation (freesurface - waterDepth)


@jax.tree_util.register_dataclass
@dataclass
class MoorState:
    """Node kinematics for all lines, padded to the widest line."""
    pos: jax.Array         # (L, NMAX+1, 3) f32
    vel: jax.Array         # (L, NMAX+1, 3) f32
    broken: jax.Array      # (L,) bool — line exceeded breaktension


@dataclass(frozen=True)
class MoorDynCfg:
    """Dynamic mooring system (replaces the closed MoorDyn+ coupling)."""
    lines: tuple           # (MoorDynLine, ...)
    nbodies: int
    rho_w: float = 1000.0  # water density
    g: float = 9.81
    kbot: float = 3.0e6    # bottom stiffness [Pa/m]
    cbot: float = 3.0e5    # bottom damping [Pa s/m]
    fric: float = 0.0      # bottom friction coefficient
    fricdamp: float = 200.0   # near-zero-speed friction damping
    nsub: int = 16         # line substeps per SPH step (static)
    start: float = 0.0     # <start value=...>
    ramptime: float = 0.0  # <start ramptime=...>
    cdscale_ic: float = 5.0   # drag scaling for dynamic-relaxation IC
    t_ic: float = 1.0      # seconds of dynamic relaxation at init
    dtm: float = 1e-4      # substep used for the IC relaxation

    dynamic = True         # marks the carry-state protocol for the stepper

    # -- padded parameter tables (host-side, built per trace) ---------------
    def _tables(self, f32=jnp.float32):
        L = len(self.lines)
        NM = max(ln.nseg for ln in self.lines)
        import numpy as _np
        t = {}

        def arr(fn):
            return jnp.asarray(_np.asarray([fn(ln) for ln in self.lines],
                                           _np.float32))
        t["l0seg"] = arr(lambda ln: ln.length0 / ln.nseg)
        t["ea"] = arr(lambda ln: ln.ea)
        t["d"] = arr(lambda ln: ln.diameter)
        # tiny mass floor so an unspecified massDenInAir stays integrable
        t["w"] = arr(lambda ln: max(ln.massden, 1e-4))
        t["can"] = arr(lambda ln: ln.can)
        t["cat"] = arr(lambda ln: ln.cat)
        t["cdn"] = arr(lambda ln: ln.cdn)
        t["cdt"] = arr(lambda ln: ln.cdt)
        t["zbot"] = arr(lambda ln: ln.zbot)
        t["btens"] = arr(lambda ln: ln.breaktension)
        # MoorDyn BA<0 convention: -zeta -> c = zeta*l0seg*sqrt(EA*w)
        def _c(ln):
            if ln.ba >= 0:
                return ln.ba
            w = max(ln.massden, 1e-4)
            return -ln.ba * (ln.length0 / ln.nseg) * math.sqrt(ln.ea * w)
        t["c"] = arr(_c)
        t["nseg"] = jnp.asarray([ln.nseg for ln in self.lines], jnp.int32)
        # masks: segment j live iff j < nseg; node i internal iff 0<i<nseg
        j = _np.arange(NM)
        segm = _np.asarray([j < ln.nseg for ln in self.lines], _np.float32)
        i = _np.arange(NM + 1)
        intm = _np.asarray([(i > 0) & (i < ln.nseg) for ln in self.lines],
                           _np.float32)
        t["segmask"] = jnp.asarray(segm)
        t["intmask"] = jnp.asarray(intm)
        t["NM"] = NM
        return t

    def _fairlead_kin(self, fts, f32=jnp.float32):
        """World fairlead position + velocity per line from the body state."""
        from .floating import _euler_rot
        R = _euler_rot(fts.angles)
        ps, vs = [], []
        for ln in self.lines:
            r = R[ln.body] @ jnp.asarray(ln.fairlead, f32)
            ps.append(fts.center[ln.body] + r)
            vs.append(fts.fvel[ln.body] + jnp.cross(fts.fomega[ln.body], r))
        return jnp.stack(ps).astype(f32), jnp.stack(vs).astype(f32)

    # -- physics ------------------------------------------------------------
    def _accel(self, t, P, V, cdscale=1.0):
        """Node accelerations + last-segment tension vectors.

        P,V: (L, NM+1, 3).  Returns (A, tlast, tmax) where A is zero on the
        end nodes (they are kinematic), tlast (L,3) is the tension vector of
        the fairlead-adjacent segment acting ON the fairlead and tmax (L,)
        the max segment tension magnitude for break checks."""
        f32 = P.dtype
        e = P[:, 1:, :] - P[:, :-1, :]                  # (L,NM,3)
        l = jnp.sqrt(jnp.sum(e * e, -1) + 1e-12)
        q = e / l[..., None]
        l0 = t["l0seg"][:, None]
        eps = (l - l0) / l0
        de = V[:, 1:, :] - V[:, :-1, :]
        epsdot = jnp.sum(de * q, -1) / l0
        tmag = jnp.maximum(t["ea"][:, None] * eps, 0.0) \
            + t["c"][:, None] * epsdot
        tmag = tmag * t["segmask"]
        Tv = tmag[..., None] * q                         # (L,NM,3)
        # internal nodes: F = Tv[i] - Tv[i-1]
        Fint = Tv[:, 1:, :] - Tv[:, :-1, :]              # nodes 1..NM-1
        F = jnp.zeros_like(P).at[:, 1:-1, :].set(Fint)
        # node tangents (average of adjacent segment directions)
        th = jnp.zeros_like(P)
        th = th.at[:, :-1, :].add(q).at[:, 1:, :].add(q)
        th = th / jnp.sqrt(jnp.sum(th * th, -1, keepdims=True) + 1e-12)
        A_cs = math.pi / 4.0 * t["d"] * t["d"]          # (L,)
        # net weight (in water) on internal nodes
        wnet = (t["w"] - self.rho_w * A_cs)[:, None] * self.g * t["l0seg"][:, None]
        F = F.at[:, :, 2].add(-wnet * t["intmask"])
        # Morison drag on the relative (still-water) velocity
        vt = jnp.sum(V * th, -1, keepdims=True) * th
        vn = V - vt
        vnm = jnp.sqrt(jnp.sum(vn * vn, -1, keepdims=True) + 1e-12)
        vtm = jnp.sqrt(jnp.sum(vt * vt, -1, keepdims=True) + 1e-12)
        dfac = (0.5 * self.rho_w * cdscale)
        Fd = -dfac * (t["cdn"] * t["d"] * t["l0seg"])[:, None, None] * vnm * vn \
             - dfac * (t["cdt"] * math.pi * t["d"] * t["l0seg"])[:, None, None] * vtm * vt
        F = F + Fd * t["intmask"][..., None]
        # seabed: vertical spring-damper + friction (per contact area d*l0)
        pen = t["zbot"][:, None] - P[:, :, 2]
        below = (pen > 0.0).astype(f32) * t["intmask"]
        ac = (t["d"] * t["l0seg"])[:, None]
        fnorm = jnp.maximum(self.kbot * ac * pen
                            - self.cbot * ac * V[:, :, 2], 0.0) * below
        F = F.at[:, :, 2].add(fnorm)
        if self.fric > 0.0:
            vxy = V[:, :, :2]
            vxym = jnp.sqrt(jnp.sum(vxy * vxy, -1, keepdims=True) + 1e-12)
            fmag = jnp.minimum(self.fric * fnorm[..., None],
                               self.fricdamp * ac[..., None] * vxym)
            F = F.at[:, :, :2].add(-fmag * vxy / vxym)
        # mass matrix inverse (analytic: m I + an (I-tt) + at tt)
        mn = (t["w"] * t["l0seg"])[:, None]
        an = (self.rho_w * t["can"] * A_cs * t["l0seg"])[:, None]
        at = (self.rho_w * t["cat"] * A_cs * t["l0seg"])[:, None]
        Ft = jnp.sum(F * th, -1, keepdims=True) * th
        Fn = F - Ft
        Acc = Fn / jnp.maximum(mn + an, 1e-12)[..., None] \
            + Ft / jnp.maximum(mn + at, 1e-12)[..., None]
        Acc = Acc * t["intmask"][..., None]
        # tension on the fairlead node (last live segment): -Tv[nseg-1]
        li = jnp.arange(len(self.lines))
        tlast = -Tv[li, t["nseg"] - 1, :]
        tmax = jnp.max(tmag, axis=1)
        return Acc, tlast, tmax

    def stable_dtm(self):
        """Stability bound for the lumped-mass chain under semi-implicit
        Euler: the stiffest ("optical") mode has w_max = 2*sqrt(k/m) with
        k = EA/l0seg, and the explicit internal-damping term needs
        lambda*h < 2 — 0.25 * l0seg * sqrt(w/EA) puts both at half their
        limits so the damping actually contracts."""
        return max(min(0.25 * (ln.length0 / ln.nseg)
                       * math.sqrt(max(ln.massden, 1e-4)
                                   / max(ln.ea, 1e-12))
                       for ln in self.lines), 1e-7)

    # -- public API ---------------------------------------------------------
    def init_state(self, fts, f32=jnp.float32):
        """Straight-line nodes + dynamic-relaxation IC (solverOptions
        dtIC/cdScaleIC/tmaxIC): integrate with scaled drag and frozen
        fairleads until (approximately) settled."""
        tb = self._tables()
        NM = tb["NM"]
        L = len(self.lines)
        pf, _ = self._fairlead_kin(fts, f32)
        anchors = jnp.asarray([ln.anchor for ln in self.lines], f32)
        frac = jnp.linspace(0.0, 1.0, NM + 1)[None, :, None]
        P = anchors[:, None, :] * (1 - frac) + pf[:, None, :] * frac
        V = jnp.zeros_like(P)
        st = MoorState(pos=P, vel=V,
                       broken=jnp.zeros((L,), bool))
        # never relax above the stability limit, whatever dtM says
        dtm = min(self.dtm, self.stable_dtm())
        nic = int(max(1, min(self.t_ic / dtm, 200000)))
        vf = jnp.zeros_like(pf)
        st = self._advance_raw(st, pf, vf, dtm * nic, nic,
                               cdscale=self.cdscale_ic, f32=f32)
        return MoorState(pos=st.pos, vel=jnp.zeros_like(st.vel),
                         broken=st.broken)

    def _advance_raw(self, mstate, pf_end, vf, dt, nsub, cdscale=1.0,
                     f32=jnp.float32):
        """Semi-implicit (symplectic) Euler over `nsub` substeps with the
        fairlead gliding at vf toward pf_end (MoorDyn's constant-velocity
        coupling ramp).  MoorDyn integrates with RK2 at a tiny dtM; at our
        fixed substep budget the symplectic update is the right trade —
        neutrally stable for the axial spring modes (RK2's |G|>1 for
        oscillatory eigenvalues compounds over the run) and one force
        evaluation per substep."""
        tb = self._tables()
        # clamp the substep to the axial-wave stability limit: an oversized
        # caller dt (e.g. the first SPH step running at dtini) integrates a
        # shorter, stable window instead of poisoning the state with NaNs
        h = jnp.minimum(jnp.asarray(dt, f32) / nsub,
                        f32(self.stable_dtm()))
        T = h * nsub
        anchors = jnp.asarray([ln.anchor for ln in self.lines], f32)
        nsg = tb["nseg"]

        def set_bc(P, V, k):
            # anchor at node 0; fairlead at node nseg (padded tail follows)
            pfk = pf_end - vf * (T - k * h)
            P = P.at[:, 0, :].set(anchors)
            V = V.at[:, 0, :].set(0.0)
            # write fairlead into every node >= nseg (tail stays attached)
            NM1 = P.shape[1]
            tailm = (jnp.arange(NM1)[None, :] >= nsg[:, None])[..., None]
            P = jnp.where(tailm, pfk[:, None, :], P)
            V = jnp.where(tailm, vf[:, None, :], V)
            return P, V

        def sub(carry, k):
            P, V, brk = carry
            P, V = set_bc(P, V, k.astype(f32))
            A1, _, tm1 = self._accel(tb, P, V, cdscale)
            V2 = V + h * A1
            P2 = P + h * V2
            brk = brk | ((tb["btens"] > 0) & (tm1 > tb["btens"]))
            return (P2, V2, brk), None

        (P, V, brk), _ = jax.lax.scan(
            sub, (mstate.pos.astype(f32), mstate.vel.astype(f32),
                  mstate.broken), jnp.arange(nsub))
        P, V = set_bc(P, V, jnp.asarray(float(nsub), f32))
        return MoorState(pos=P, vel=V, broken=brk)

    def advance(self, mstate, fts, dt, tabs=None, f32=jnp.float32):
        """Integrate the lines across one SPH step (the coupling instant of
        MoorDyn_FairleadsCalc)."""
        pf, vf = self._fairlead_kin(fts, f32)
        return self._advance_raw(mstate, pf, vf, dt, self.nsub, f32=f32)

    def fairlead_tensions(self, mstate, f32=jnp.float32):
        """Per-line tension vector acting on the fairlead (L,3) — the
        quantity MoorDyn+ reports per connection (savedata tension/force)."""
        tb = self._tables()
        _, tlast, _ = self._accel(tb, mstate.pos.astype(f32),
                                  mstate.vel.astype(f32))
        return tlast * (~mstate.broken)[:, None].astype(f32)

    def forces(self, fts, mstate, tabs=None, f32=jnp.float32):
        """Fairlead tensions -> per-body (force, torque), with the <start>
        ramp applied (JDsMooredFloatings start/ramptime)."""
        from .floating import _euler_rot
        tb = self._tables()
        _, tlast, _ = self._accel(tb, mstate.pos.astype(f32),
                                  mstate.vel.astype(f32))
        alive = (~mstate.broken)[:, None].astype(f32)
        tlast = tlast * alive
        if tabs is not None and (self.start > 0 or self.ramptime > 0):
            ramp = jnp.clip((tabs - self.start)
                            / jnp.maximum(self.ramptime, 1e-9), 0.0, 1.0) \
                if self.ramptime > 0 else (tabs >= self.start).astype(f32)
            tlast = tlast * ramp
        B = self.nbodies
        face = jnp.zeros((B, 3), f32)
        fom = jnp.zeros((B, 3), f32)
        R = _euler_rot(fts.angles)
        for k, ln in enumerate(self.lines):
            r_world = R[ln.body] @ jnp.asarray(ln.fairlead, f32)
            face = face.at[ln.body].add(tlast[k])
            fom = fom.at[ln.body].add(jnp.cross(r_world, tlast[k]))
        return face, fom
