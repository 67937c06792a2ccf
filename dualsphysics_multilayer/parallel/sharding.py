"""Domain decomposition over a device mesh: slab sharding + halo exchange.

The reference reserves a multi-device design but never ships one
(`TpMgDivMode` MGDIV_X/Y/Z `DualSphDef.h:494-510`, "belongs to Process-1/+1"
particle codes `DualSphDef.h:175-176`, `WithMpi` permanently false
`JSph.cpp:74`; SURVEY §2.8).  This module supplies it as a first-class
feature:

* the global cell grid is split into **slabs along x** (the MGDIV_X design)
  over a 1-D `jax.sharding.Mesh` axis; every shard owns a fixed-capacity
  particle buffer (the global state is simply sharded on the particle axis);
* each step runs under `shard_map`: **migration** moves particles whose
  x-cell changed owner to the adjacent shard (one `ppermute` per direction —
  CFL guarantees single-slab hops), and **halo exchange** copies edge-column
  particles to the neighbour as transient ghosts before every cell divide
  (ghosts are marked with the periodic special code, so like the reference's
  periodic ghosts they are excluded from AceMax and never integrated);
* the per-step dt is a global `lax.pmin`; diagnostics are `psum`/`pmax` —
  the two first-class communication patterns called out in SURVEY §5.8,
  which XLA hands to NCCL on GPUs.  The cards of one host are joined all
  to all, so the mesh is the 1-D slab axis of the algorithm alone.

Everything is static-shape: migration and ghost buffers have fixed capacities
with counted (never silent) overflow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph, TpShifting, TpStep, TpVisco
from ..ops import celldiv as cd
from ..ops import eos
from ..ops import forces as F
from ..ops import integrators as I
from ..ops.forces import SolverOpts
from ..models.wcsph import (SimState, Simulation, StepCarry, make_carry,
                            pinned_precision, select_path)
from ..ops.pallas import cellforce as CF

AXIS = "dd"   # mesh axis name for the domain decomposition


@dataclass(frozen=True)
class ShardCfg:
    """Static sharding configuration."""
    ndev: int
    gdom: cd.Domain       # global cell grid (nc[0] divisible by ndev)
    ldom: cd.Domain       # local slab grid: (ncx_loc + 2*halo columns, ...)
    n_local: int          # particle-slot capacity per shard
    mig_cap: int          # max migrants per direction per step
    ghost_cap: int        # max ghost particles per direction per divide
    # halo width in cells: 1 for first-order neighbourhoods (WCSPH); 2 for
    # the NN pipeline, whose per-particle effective viscosity is itself a
    # neighbourhood field consumed by the stress pass (ghost eta must be
    # computed from a complete support)
    halo: int = 1
    # per-shard slot rows at the block tail reserved for the periodic-ghost
    # region (features.periodic ghost_slots_required); migration never
    # places received particles there
    reserve_tail: int = 0

    @property
    def ncx_loc(self) -> int:
        return self.gdom.nc[0] // self.ndev

    @property
    def n_ext(self) -> int:
        return self.n_local + 2 * self.ghost_cap


def make_shard_cfg(gdom: cd.Domain, ndev: int, n_local: int,
                   mig_cap: int = 0, ghost_cap: int = 0,
                   halo: int = 1, reserve_tail: int = 0) -> ShardCfg:
    ncx = gdom.nc[0]
    if ncx % ndev:
        # grow the grid so the x-cells split evenly (cells beyond the fluid
        # stay empty and cost nothing through active-cell compaction)
        ncx = int(math.ceil(ncx / ndev) * ndev)
        gdom = replace(gdom, nc=(ncx, gdom.nc[1], gdom.nc[2]))
    ncx_loc = ncx // ndev
    if not ghost_cap:
        ghost_cap = max(256, halo * (n_local // 4))
    if not mig_cap:
        mig_cap = max(256, n_local // 8)
    # _pack slices order[:cap]: caps beyond the buffer length are unreachable
    ghost_cap = min(ghost_cap, n_local)
    mig_cap = min(mig_cap, n_local)
    ldom = cd.Domain(posmin=gdom.posmin, scell=gdom.scell,
                     nc=(ncx_loc + 2 * halo, gdom.nc[1], gdom.nc[2]),
                     simulate2d=gdom.simulate2d, cellcap=gdom.cellcap,
                     maxcells=min((ncx_loc + 2 * halo) * gdom.nc[1]
                                  * gdom.nc[2],
                                  n_local + 2 * ghost_cap))
    return ShardCfg(ndev=ndev, gdom=gdom, ldom=ldom, n_local=n_local,
                    mig_cap=mig_cap, ghost_cap=ghost_cap, halo=halo,
                    reserve_tail=reserve_tail)


# ---------------------------------------------------------------------------
# packing / ring exchange helpers (inside shard_map)
# ---------------------------------------------------------------------------

def _pack(flags, arrays, cap):
    """Compact flagged rows into a fixed-size buffer.  Returns
    (buffers, valid (cap,), n_packed, overflow)."""
    order = jnp.argsort(~flags, stable=True)     # flagged rows first
    take = order[:cap]
    cnt = jnp.sum(flags.astype(jnp.int32))
    valid = jnp.arange(cap, dtype=jnp.int32) < cnt
    out = [a[take] for a in arrays]
    overflow = jnp.maximum(cnt - cap, 0)
    return out, valid, take, overflow


def _shift(x, direction, ndev):
    """ppermute by +-1 along the mesh axis; devices with no source get zeros."""
    if ndev == 1:
        return jnp.zeros_like(x)
    if direction > 0:
        perm = [(i, i + 1) for i in range(ndev - 1)]
    else:
        perm = [(i, i - 1) for i in range(1, ndev)]
    return jax.lax.ppermute(x, AXIS, perm)


def _send_both(flag_l, flag_r, arrays, cap, ndev):
    """Pack left/right-flagged rows and exchange with both neighbours.
    Returns (recv_l_arrays, recv_l_valid, recv_r_arrays, recv_r_valid,
    sent_take_l, sent_take_r, n_l, n_r, overflow)."""
    buf_l, val_l, take_l, ov_l = _pack(flag_l, arrays, cap)
    buf_r, val_r, take_r, ov_r = _pack(flag_r, arrays, cap)
    # left-going buffers arrive from the right neighbour and vice versa
    recv_from_r = [_shift(a, -1, ndev) for a in buf_l]
    rvalid_from_r = _shift(val_l.astype(jnp.int32), -1, ndev) > 0
    recv_from_l = [_shift(a, +1, ndev) for a in buf_r]
    rvalid_from_l = _shift(val_r.astype(jnp.int32), +1, ndev) > 0
    return (recv_from_l, rvalid_from_l, recv_from_r, rvalid_from_r,
            take_l, take_r, val_l, val_r, ov_l + ov_r)


_DEAD = td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE)


_OPT_ARRAYS = ("velm1", "rhom1", "spstau", "boundnormal", "motionvel",
               "pose")


def _state_arrays(st: SimState):
    arrs = [st.pos, st.vel, st.rho, st.code, st.idp]
    names = ["pos", "vel", "rho", "code", "idp"]
    for nm in _OPT_ARRAYS:
        a = getattr(st, nm)
        if a is not None:
            arrs.append(a)
            names.append(nm)
    return names, arrs


def _rebuild_state(st: SimState, names, arrs) -> SimState:
    kw = dict(zip(names, arrs))
    return replace(st, **kw)


# ---------------------------------------------------------------------------
# migration & halo exchange
# ---------------------------------------------------------------------------

def migrate(cfg: ShardCfg, csp: CteSph, st: SimState, my):
    """Move particles whose owner slab changed to the adjacent shard.
    Returns (new_state, overflow_count)."""
    gdom = cfg.gdom
    live = td.is_active(st.code)
    xcell = jnp.floor((st.pos[:, 0] - gdom.posmin[0]) / gdom.scell).astype(jnp.int32)
    out_x = live & ((xcell < 0) | (xcell >= gdom.nc[0]))
    code = jnp.where(out_x, td.code_set_special(st.code, td.SPECIAL_OUT_POS),
                     st.code)
    st = replace(st, code=code)
    live = td.is_active(st.code)
    owner = jnp.clip(xcell // cfg.ncx_loc, 0, cfg.ndev - 1)
    go_l = live & (owner < my)
    go_r = live & (owner > my)

    names, arrs = _state_arrays(st)
    (recv_l, rv_l, recv_r, rv_r, take_l, take_r, val_l, val_r, ov) = \
        _send_both(go_l, go_r, arrs, cfg.mig_cap, cfg.ndev)

    # kill the rows actually sent (their slot frees up)
    code = st.code
    dead_code = jnp.asarray(_DEAD, code.dtype)
    code = code.at[take_l].set(jnp.where(val_l, dead_code, code[take_l]))
    code = code.at[take_r].set(jnp.where(val_r, dead_code, code[take_r]))
    st = replace(st, code=code)

    # merge the (up to 2*mig_cap) received rows into free slots
    recv = [jnp.concatenate([a, b], axis=0) for a, b in zip(recv_l, recv_r)]
    rvalid = jnp.concatenate([rv_l, rv_r], axis=0)
    # received code: trust sender but drop invalid rows
    ci = names.index("code")
    recv[ci] = jnp.where(rvalid, recv[ci], dead_code)

    live_now = td.is_active(st.code)
    if cfg.reserve_tail:
        # the tail rows belong to the periodic-ghost region: never place
        # migrants there (apply_periodic rewrites them every step)
        tail = jnp.arange(cfg.n_local) >= (cfg.n_local - cfg.reserve_tail)
        live_now = live_now | tail
    free_first = jnp.argsort(live_now, stable=True)      # dead slots first
    nfree = jnp.sum(~live_now)
    # compact received rows: valid first
    rorder = jnp.argsort(~rvalid, stable=True)
    recv = [a[rorder] for a in recv]
    rvalid = rvalid[rorder]
    nrecv = min(2 * cfg.mig_cap, cfg.n_local)
    ov = ov + jnp.sum(rvalid[nrecv:].astype(jnp.int32))
    recv = [a[:nrecv] for a in recv]
    rvalid = rvalid[:nrecv]
    dest = free_first[:nrecv]
    can_write = rvalid & (jnp.arange(nrecv) < nfree)
    ov = ov + jnp.sum((rvalid & ~can_write).astype(jnp.int32))

    merged = []
    for nm, a, r in zip(names, _state_arrays(st)[1], recv):
        cur = a[dest]
        neww = jnp.where(can_write.reshape((-1,) + (1,) * (r.ndim - 1)), r, cur)
        merged.append(a.at[dest].set(neww))
    return _rebuild_state(st, names, merged), ov


def exchange_ghosts(cfg: ShardCfg, st: SimState, my):
    """Copy live particles within one cell of the slab boundary to the
    neighbour shard as transient ghosts.  Returns extended arrays of length
    n_ext = n_local + 2*ghost_cap (ghost rows carry the periodic special
    code) plus an overflow count."""
    gdom = cfg.gdom
    scell = gdom.scell
    lbnd = gdom.posmin[0] + my.astype(jnp.float32) * (cfg.ncx_loc * scell)
    rbnd = lbnd + cfg.ncx_loc * scell
    live = td.is_active(st.code)
    x = st.pos[:, 0]
    near_l = live & (x < lbnd + cfg.halo * scell)
    near_r = live & (x >= rbnd - cfg.halo * scell)

    names, arrs = _state_arrays(st)
    (recv_l, rv_l, recv_r, rv_r, *_rest, ov) = _send_both(
        near_l, near_r, arrs, cfg.ghost_cap, cfg.ndev)

    ci = names.index("code")
    ghost_dead = jnp.asarray(_DEAD, st.code.dtype)
    for recv, rv in ((recv_l, rv_l), (recv_r, rv_r)):
        gcode = td.code_set_special(recv[ci], td.SPECIAL_PERIODIC)
        recv[ci] = jnp.where(rv, gcode, ghost_dead)

    ext = [jnp.concatenate([a, l, r], axis=0)
           for a, l, r in zip(arrs, recv_l, recv_r)]
    return names, ext, ov


def _shard_origin(cfg: ShardCfg, my):
    """Local-grid origin of shard ``my``: `halo` columns left of the slab."""
    gdom = cfg.gdom
    return jnp.stack([
        jnp.asarray(gdom.posmin[0], jnp.float32)
        + (my.astype(jnp.float32) * cfg.ncx_loc - float(cfg.halo))
        * gdom.scell,
        jnp.asarray(gdom.posmin[1], jnp.float32),
        jnp.asarray(gdom.posmin[2], jnp.float32)])


def _check_sharded_feats(feats):
    """Features supported under domain decomposition: local per-particle
    transforms (scripted motion, multi-layer pistons, damping, relaxation
    zones, accinput) need no extra communication; floating bodies psum
    their force/torque sums over the mesh axis, after which the entire
    body-coupling stack (6-DOF solve, chrono joints/contact, mooring
    lines, force points) runs replicated; inlet/outlet transitions are
    slot-local (spawns land in local free slots and migrate to their owner
    next step — ShardedSimulation sizes the halo to the widest zone band)
    with their zsurf/AWAS column measurements psum'd over the mesh; DEM
    contact runs on the halo-extended divide with id-keyed property
    tables."""
    if feats is None:
        return None
    if feats.periodic is not None and feats.periodic.axes[0]:
        raise NotImplementedError(
            "x-periodic conflicts with the x-slab decomposition; shard "
            "along a non-periodic axis (y/z periodicity is supported)")
    return feats


def _ftspec(st: SimState):
    """Replicated PartitionSpecs for the body state (FloatingState) when the
    sharded SimState carries one."""
    if st.ft is None:
        return None
    from ..features.floating import FloatingState
    return FloatingState(center=P(), fvel=P(), fomega=P(), angles=P())


def _sharded_floating(cfg, csp, feats, st, tabs, dt, predictor, ace, moor):
    """run_floating with partial sums psum'd over the mesh; the body solve
    and every body-level coupling (chrono joints/contact, mooring lines,
    force points) run replicated.  Ghosts are excluded from the sums
    inside run_floating.  Returns (st, moor')."""
    from ..features import floating as FT
    from ..models.wcsph import _ext_body_forces
    eface, efom = _ext_body_forces(feats, st, tabs, moor)
    posf, velf, fts = FT.run_floating(
        feats.floating, csp, st.ft, tabs, dt, predictor,
        st.pos, st.vel, st.code, ace,
        ext_face=eface, ext_fomegaace=efom,
        chrono=feats.chrono, chcontact=feats.chcontact,
        psum_axis=AXIS if cfg.ndev > 1 else None)
    st = replace(st, pos=posf, vel=velf, ft=fts)
    if not predictor and moor is not None:
        moor = feats.moorings.advance(moor, fts, dt, tabs=tabs)
    return st, moor


def _sharded_post_forces(csp, feats, tabs, st, fr):
    """accinput folds into the force result exactly like the single-chip
    _post_forces (JDsAccInput attachment, JSphCpu.cpp:452+)."""
    if feats is not None and feats.accinputs:
        from ..features import accinput as ACC
        ace = ACC.apply_accinput(feats.accinputs, csp, tabs, st.pos, st.vel,
                                 st.code, fr.ace)
        fr = replace(fr, ace=ace)
    return fr


def _apply_local_feats(csp, feats, tabs, dt, st: SimState) -> SimState:
    """Post-corrector feature hooks at the reference's attachment points
    (damping/relax zones after the corrector, motion at the loop end —
    JSphCpuSingle.cpp:683,715-718,1096); all are shard-local."""
    if feats is None:
        return st
    if feats.damping:
        from ..features import damping as DMP
        st = replace(st, vel=DMP.apply_damping(feats.damping, dt, st.pos,
                                               st.vel, st.code))
    if feats.relaxzones:
        from ..features import relaxzone as RZ
        st = replace(st, vel=RZ.apply_relaxzones(
            feats.relaxzones, csp, tabs, st.pos, st.vel, st.code, dt=dt))
    if feats.motions:
        from ..features import motion as MOT
        posm, velm = MOT.apply_motion(feats.motions, tabs, dt, st.pos,
                                      st.vel, st.code)
        upd = dict(pos=posm, vel=velm)
        if st.motionvel is not None:
            moving = td.is_moving(st.code)
            upd["motionvel"] = jnp.where(moving[:, None], velm, 0.0)
        st = replace(st, **upd)
    if feats.mlpistons:
        from ..features import mlpiston as MLP
        posm, velm = MLP.apply_mlpistons(feats.mlpistons, tabs, dt, st.pos,
                                         st.vel, st.code)
        st = replace(st, pos=posm, vel=velm)
    return st


# ---------------------------------------------------------------------------
# sharded step
# ---------------------------------------------------------------------------

def _sharded_mdbc(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                  st: SimState, my):
    """mDBC ghost-node prepass of the sharded step: exchange raw
    ghosts (completing every owned bound particle's ghost-node support —
    needs cfg.halo >= 2), correct on the extended arrays, keep the OWNED
    rows' corrected vel/rho.  The interaction's own exchange then ships the
    corrected boundary values (JSphCpuSingle::MdbcBoundCorrection analog)."""
    from ..ops import mdbc as MDBC
    if st.boundnormal is None:
        return st, jnp.zeros((), jnp.int32)
    names, ext, ghost_ov = exchange_ghosts(cfg, st, my)
    exd = dict(zip(names, ext))
    origin = _shard_origin(cfg, my)
    div, ext_code = cd.divide(cfg.ldom, exd["pos"], exd["code"],
                              origin=origin)
    vel2, rho2 = MDBC.mdbc_correction(
        csp, opts, cfg.ldom, div, exd["pos"], exd["vel"], exd["rho"],
        ext_code, exd["boundnormal"], exd.get("motionvel"), origin=origin)
    nl = cfg.n_local
    return (replace(st, vel=vel2[:nl], rho=rho2[:nl]),
            ghost_ov + div.overflow)


def _sharded_interaction(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                         st: SimState, my, ftomassp=None, feats=None,
                         dt=None, path="bucket", interpret=False):
    """Ghost exchange + local divide + fused forces (+ DEM contact over the
    halo-extended arrays) on the selected interaction ``path``; outputs are
    canonical local-slab order (first n_local rows)."""
    mdbc_ov = jnp.zeros((), jnp.int32)
    if opts.tboundary == td.TpBoundary.MDBC:
        st, mdbc_ov = _sharded_mdbc(cfg, csp, opts, st, my)
    names, ext, ghost_ov = exchange_ghosts(cfg, st, my)
    exd = dict(zip(names, ext))
    origin = _shard_origin(cfg, my)
    use_dem = feats is not None and feats.dem is not None
    div = None
    if path == "cellforce":
        # per-shard GPU kernel over the local slab's sorted divide, fed by
        # the halo-extended arrays (the halo keeps every owned particle's
        # 27-cell support local)
        sd, ext_code = cd.divide_sorted(
            cfg.ldom, exd["pos"], exd["code"],
            block=CF.tile_config(csp, opts)[0], origin=origin)
        fr = CF.interaction_forces(
            csp, opts, sd, exd["pos"], exd["vel"], exd["rho"], ext_code,
            ftomassp=ftomassp, spstau=exd.get("spstau"),
            state_sorted=False, interpret=interpret)
        div_overflow = sd.overflow
        if use_dem:
            div, ext_code = cd.divide(cfg.ldom, exd["pos"], ext_code,
                                      origin=origin)
    else:
        div, ext_code = cd.divide(cfg.ldom, exd["pos"], exd["code"],
                                  origin=origin)
        press = eos.press_from_rho(csp, exd["rho"])
        fr = F.interaction_forces(csp, opts, div, exd["pos"], exd["vel"],
                                  exd["rho"], press, ext_code,
                                  spstau=exd.get("spstau"),
                                  ftomassp=ftomassp)
        div_overflow = div.overflow
    if use_dem:
        # DEM contact at the reference's attachment point (right after the
        # SPH force pass, JSphCpu.cpp:990-1010); property tables keyed by
        # particle id, candidates from the halo-extended bucket divide
        from ..features import dem as DEM
        dem_ace, demdt = DEM.apply_dem(
            feats.dem, csp, cfg.ldom, div, exd["pos"], exd["vel"],
            ext_code, dt if dt is not None else csp.dtini,
            idp=exd["idp"], origin=origin)
        fr = replace(fr, ace=fr.ace + dem_ace,
                     viscdtmax=jnp.maximum(fr.viscdtmax, demdt))
    nl = cfg.n_local
    # propagate out-of-local-grid marking back to owned rows
    st = replace(st, code=ext_code[:nl])
    fr_local = F.Forces(
        ace=fr.ace[:nl], ar=fr.ar[:nl], viscdtmax=fr.viscdtmax,
        shiftposfs=None if fr.shiftposfs is None else fr.shiftposfs[:nl],
        shift_blocked=None if fr.shift_blocked is None else fr.shift_blocked[:nl],
        spsgradvel=None if fr.spsgradvel is None else fr.spsgradvel[:nl])
    return st, fr_local, div_overflow + ghost_ov + mdbc_ov


def make_sharded_step(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                      feats=None, path=None, interpret=False):
    """Per-shard symplectic step body (call inside shard_map); the Verlet
    twin is make_sharded_step_verlet (dispatched by opts.tstep in
    make_sharded_advance)."""
    feats = _check_sharded_feats(feats)
    ftomassp = (jnp.asarray(feats.floating.massp, jnp.float32)
                if feats is not None and feats.floating is not None else None)
    kw = dict(path=path or select_path(csp, opts), interpret=interpret)

    def reduce_max(x):
        return jax.lax.pmax(x, AXIS) if cfg.ndev > 1 else x

    def reduce_sum(x):
        return jax.lax.psum(x, AXIS) if cfg.ndev > 1 else x

    def step(carry: StepCarry) -> StepCarry:
        my = jax.lax.axis_index(AXIS) if cfg.ndev > 1 else jnp.zeros((), jnp.int32)
        st = carry.st
        dt = carry.dt_pre
        tabs = carry.tabs if carry.tabs is not None else carry.t

        st, mig_ov = migrate(cfg, csp, st, my)
        pov = jnp.zeros((), jnp.int32)
        if feats is not None and feats.periodic is not None:
            # per-shard y/z wrap + ghost regeneration (x stays the slab
            # axis; the reserved tail rows hold the ghosts)
            from ..features import periodic as PER
            st, p1 = PER.apply_periodic(feats.periodic, csp, st)
            pov = pov + p1

        # predictor
        st, fr1, ov1 = _sharded_interaction(cfg, csp, opts, st, my, ftomassp,
                                            feats=feats, dt=dt, **kw)
        fr1 = _sharded_post_forces(csp, feats, tabs, st, fr1)
        velmax = reduce_max(I.velocity_max(csp, st.vel, st.code))
        acemax = reduce_max(I.ace_max(fr1.ace, st.code))
        viscdt = reduce_max(fr1.viscdtmax)
        dt_p, bad_p = I.dt_variable(csp, acemax, velmax, viscdt)

        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)
        moor = carry.moor
        if feats is not None and feats.floating is not None:
            st, _ = _sharded_floating(cfg, csp, feats, st, tabs, dt * 0.5,
                                      True, fr1.ace, moor)
        if feats is not None and feats.periodic is not None:
            from ..features import periodic as PER
            st, p2 = PER.apply_periodic(feats.periodic, csp, st)
            pov = pov + p2

        # corrector
        st, fr2, ov2 = _sharded_interaction(cfg, csp, opts, st, my, ftomassp,
                                            feats=feats, dt=dt, **kw)
        fr2 = _sharded_post_forces(csp, feats, tabs, st, fr2)
        velmax2 = reduce_max(I.velocity_max(csp, st.vel, st.code))
        acemax2 = reduce_max(I.ace_max(fr2.ace, st.code))
        viscdt2 = reduce_max(fr2.viscdtmax)
        dt_c, bad_c = I.dt_variable(csp, acemax2, velmax2, viscdt2)

        shiftdisp = None
        if opts.shiftmode != TpShifting.NONE:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr2.shiftposfs, fr2.shift_blocked)
        out_corr = I.symplectic_corr(
            csp, pos_pre, vel_pre, rho_pre, st.rho, st.code,
            fr2.ace, fr2.ar, dt, shiftdisp, pose=st.pose)
        pos2, vel2, rho2, code2 = out_corr[:4]
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2,
                     pose=out_corr[4] if st.pose is not None else None)
        if feats is not None and feats.floating is not None:
            st, moor = _sharded_floating(cfg, csp, feats, st, tabs, dt,
                                         False, fr2.ace, moor)
        st = _apply_local_feats(csp, feats, tabs, dt, st)
        iov = jnp.zeros((), jnp.int32)
        if feats is not None and feats.inout is not None:
            from ..features import inout as IO
            st, iov = IO.inout_step(
                feats.inout, csp, st, dt, tabs, nstep=carry.nstep,
                dom=cfg.ldom, origin=_shard_origin(cfg, my),
                axis=AXIS if cfg.ndev > 1 else None)

        overflow = reduce_max(
            jnp.maximum(jnp.maximum(ov1, ov2), mig_ov) + pov + iov)
        return StepCarry(
            st=st, t=carry.t + dt, dt_pre=jnp.minimum(dt_p, dt_c),
            verlet_count=carry.verlet_count, nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow, overflow),
            dtmodif=carry.dtmodif + bad_p.astype(jnp.int32)
                    + bad_c.astype(jnp.int32),
            tabs=None if carry.tabs is None else carry.tabs + dt,
            moor=moor)

    return step


def make_sharded_step_verlet(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                             feats=None, path=None, interpret=False):
    """Sharded Verlet step (per-step migrate + ghost exchange +
    divide): the ComputeStep_Ver analog under domain decomposition."""
    feats = _check_sharded_feats(feats)
    ftomassp = (jnp.asarray(feats.floating.massp, jnp.float32)
                if feats is not None and feats.floating is not None else None)
    kw = dict(path=path or select_path(csp, opts), interpret=interpret)

    def reduce_max(x):
        return jax.lax.pmax(x, AXIS) if cfg.ndev > 1 else x

    def step(carry: StepCarry) -> StepCarry:
        my = (jax.lax.axis_index(AXIS) if cfg.ndev > 1
              else jnp.zeros((), jnp.int32))
        st = carry.st
        tabs = carry.tabs if carry.tabs is not None else carry.t

        st, mig_ov = migrate(cfg, csp, st, my)
        pov = jnp.zeros((), jnp.int32)
        if feats is not None and feats.periodic is not None:
            from ..features import periodic as PER
            st, p1 = PER.apply_periodic(feats.periodic, csp, st)
            pov = pov + p1

        st, fr, ov1 = _sharded_interaction(cfg, csp, opts, st, my, ftomassp,
                                           feats=feats, dt=carry.dt_pre, **kw)
        fr = _sharded_post_forces(csp, feats, tabs, st, fr)
        velmax = reduce_max(I.velocity_max(csp, st.vel, st.code))
        acemax = reduce_max(I.ace_max(fr.ace, st.code))
        viscdt = reduce_max(fr.viscdtmax)
        dt, bad, _d1, _d2 = I.dt_variable_parts(csp, acemax, velmax, viscdt)

        shiftdisp = None
        if opts.shiftmode != TpShifting.NONE:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr.shiftposfs, fr.shift_blocked)
        vcount = carry.verlet_count + 1
        use_m1 = vcount < opts.verlet_steps
        out_ver = I.verlet(
            csp, st.pos, st.vel, st.rho, st.velm1, st.rhom1, st.code,
            fr.ace, fr.ar, dt, use_m1, shiftdisp, pose=st.pose)
        pos2, vel2, rho2, code2 = out_ver[:4]
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2,
                     velm1=st.vel, rhom1=st.rho,
                     pose=out_ver[4] if st.pose is not None else None)
        moor = carry.moor
        if feats is not None and feats.floating is not None:
            st, moor = _sharded_floating(cfg, csp, feats, st, tabs, dt,
                                         False, fr.ace, moor)
        st = _apply_local_feats(csp, feats, tabs, dt, st)
        iov = jnp.zeros((), jnp.int32)
        if feats is not None and feats.inout is not None:
            from ..features import inout as IO
            st, iov = IO.inout_step(
                feats.inout, csp, st, dt, tabs, nstep=carry.nstep,
                dom=cfg.ldom, origin=_shard_origin(cfg, my),
                axis=AXIS if cfg.ndev > 1 else None)

        overflow = reduce_max(jnp.maximum(ov1, mig_ov) + pov + iov)
        return StepCarry(
            st=st, t=carry.t + dt, dt_pre=dt,
            verlet_count=jnp.where(use_m1, vcount, 0),
            nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow, overflow),
            dtmodif=carry.dtmodif + bad.astype(jnp.int32),
            tabs=None if carry.tabs is None else carry.tabs + dt,
            moor=moor)

    return step


def _sharded_interaction_nn(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                            phases, st: SimState, my):
    """Ghost exchange + local divide + the full NN multi-pass pipeline
    (PressGrad -> eta -> Morris/ConsEq) on the halo-extended arrays.  The
    2-cell halo (ShardCfg.halo=2) keeps every owned particle's stress-pass
    support complete: ghost eta within one kernel radius of the slab is
    computed from its own full neighbourhood."""
    from ..ops import forces_nn as NN
    names, ext, ghost_ov = exchange_ghosts(cfg, st, my)
    exd = dict(zip(names, ext))
    origin = _shard_origin(cfg, my)
    div, ext_code = cd.divide(cfg.ldom, exd["pos"], exd["code"],
                              origin=origin)
    fr, eta, tau = NN.interaction_forces_nn(
        csp, opts, phases, cfg.ldom, div, exd["pos"], exd["vel"],
        exd["rho"], ext_code)
    nl = cfg.n_local
    st = replace(st, code=ext_code[:nl])
    fr_local = F.Forces(
        ace=fr.ace[:nl], ar=fr.ar[:nl], viscdtmax=fr.viscdtmax,
        shiftposfs=None if fr.shiftposfs is None else fr.shiftposfs[:nl],
        shift_blocked=None if fr.shift_blocked is None
        else fr.shift_blocked[:nl],
        spsgradvel=None if fr.spsgradvel is None else fr.spsgradvel[:nl],
        viscetadtmax=fr.viscetadtmax)
    return st, fr_local, div.overflow + ghost_ov


def make_sharded_step_nn(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                         phases, feats=None):
    """Sharded symplectic step over the NN multiphase pipeline (the sharded
    twin of models.nnewtonian.make_nn_step).  Requires cfg.halo >= 2."""
    if cfg.halo < 2:
        raise ValueError("sharded NN needs make_shard_cfg(..., halo=2): "
                         "ghost effective viscosity is a neighbourhood "
                         "field consumed by the stress pass")
    feats = _check_sharded_feats(feats)

    def reduce_max(x):
        return jax.lax.pmax(x, AXIS) if cfg.ndev > 1 else x

    def step(carry: StepCarry) -> StepCarry:
        my = (jax.lax.axis_index(AXIS) if cfg.ndev > 1
              else jnp.zeros((), jnp.int32))
        st = carry.st
        dt = carry.dt_pre
        tabs = carry.tabs if carry.tabs is not None else carry.t

        st, mig_ov = migrate(cfg, csp, st, my)
        pov = jnp.zeros((), jnp.int32)
        if feats is not None and feats.periodic is not None:
            from ..features import periodic as PER
            st, p1 = PER.apply_periodic(feats.periodic, csp, st)
            pov = pov + p1

        # predictor
        st, fr1, ov1 = _sharded_interaction_nn(cfg, csp, opts, phases, st,
                                               my)
        fr1 = _sharded_post_forces(csp, feats, tabs, st, fr1)
        velmax = reduce_max(I.velocity_max(csp, st.vel, st.code))
        acemax = reduce_max(I.ace_max(fr1.ace, st.code))
        viscdt = reduce_max(fr1.viscdtmax)
        etadt = reduce_max(fr1.viscetadtmax)
        dt_p, bad_p = I.dt_variable(csp, acemax, velmax, viscdt, etadt,
                                    opts.relaxationdt)

        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)
        if feats is not None and feats.periodic is not None:
            from ..features import periodic as PER
            st, p2 = PER.apply_periodic(feats.periodic, csp, st)
            pov = pov + p2

        # corrector
        st, fr2, ov2 = _sharded_interaction_nn(cfg, csp, opts, phases, st,
                                               my)
        fr2 = _sharded_post_forces(csp, feats, tabs, st, fr2)
        velmax2 = reduce_max(I.velocity_max(csp, st.vel, st.code))
        acemax2 = reduce_max(I.ace_max(fr2.ace, st.code))
        viscdt2 = reduce_max(fr2.viscdtmax)
        etadt2 = reduce_max(fr2.viscetadtmax)
        dt_c, bad_c = I.dt_variable(csp, acemax2, velmax2, viscdt2, etadt2,
                                    opts.relaxationdt)

        shiftdisp = None
        if opts.shiftmode != TpShifting.NONE:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr2.shiftposfs, fr2.shift_blocked)
        out_corr = I.symplectic_corr(
            csp, pos_pre, vel_pre, rho_pre, st.rho, st.code,
            fr2.ace, fr2.ar, dt, shiftdisp, pose=st.pose)
        pos2, vel2, rho2, code2 = out_corr[:4]
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2,
                     pose=out_corr[4] if st.pose is not None else None)
        st = _apply_local_feats(csp, feats, tabs, dt, st)

        overflow = reduce_max(
            jnp.maximum(jnp.maximum(ov1, ov2), mig_ov) + pov)
        return StepCarry(
            st=st, t=carry.t + dt, dt_pre=jnp.minimum(dt_p, dt_c),
            verlet_count=carry.verlet_count, nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow, overflow),
            dtmodif=carry.dtmodif + bad_p.astype(jnp.int32)
                    + bad_c.astype(jnp.int32),
            tabs=None if carry.tabs is None else carry.tabs + dt)

    return step


def make_sharded_advance(cfg: ShardCfg, csp: CteSph, opts: SolverOpts,
                         mesh: Mesh, feats=None, phases=None, path=None,
                         interpret=False):
    """Jitted advance(carry, t_target) over the mesh: the global carry holds
    particle arrays sharded on axis 0 ((ndev*n_local, ...)) and replicated
    scalars.  ``phases``: NN multiphase config — selects the NN pipeline
    step (needs cfg.halo >= 2).  ``path``/``interpret`` as in
    models.wcsph.make_step."""
    if phases is not None:
        step = make_sharded_step_nn(cfg, csp, opts, phases, feats)
    elif opts.tstep == TpStep.VERLET:
        step = make_sharded_step_verlet(cfg, csp, opts, feats, path,
                                        interpret)
    else:
        step = make_sharded_step(cfg, csp, opts, feats, path, interpret)
    step = pinned_precision(step)

    def advance(carry: StepCarry, t_target, nstep_max):
        def body(c):
            return step(c)

        def cond(c):
            return (c.t < t_target) & (c.nstep < nstep_max)

        return jax.lax.while_loop(cond, body, carry)

    def specs_like(carry: StepCarry) -> StepCarry:
        st = carry.st
        shard = lambda a: None if a is None else P(AXIS)
        pst = SimState(pos=P(AXIS), vel=P(AXIS), rho=P(AXIS), code=P(AXIS),
                       idp=P(AXIS), velm1=shard(st.velm1),
                       rhom1=shard(st.rhom1), spstau=shard(st.spstau),
                       boundnormal=shard(st.boundnormal),
                       motionvel=shard(st.motionvel),
                       pose=shard(st.pose),
                       ft=_ftspec(st))
        mspec = None
        if carry.moor is not None:
            from ..features.moorings import MoorState
            mspec = MoorState(pos=P(), vel=P(), broken=P())
        return StepCarry(st=pst, t=P(), dt_pre=P(), verlet_count=P(),
                         nstep=P(), overflow=P(), dtmodif=P(),
                         tabs=None if carry.tabs is None else P(),
                         dthist=None if carry.dthist is None else P(),
                         awas=None if carry.awas is None else P(),
                         fthist=None if carry.fthist is None else P(),
                         moor=mspec)

    def wrap(carry: StepCarry, t_target,
             nstep_max=jnp.asarray(2 ** 30, jnp.int32)):
        if (carry.moor is None and feats is not None
                and feats.moorings is not None
                and getattr(feats.moorings, "dynamic", False)
                and carry.st.ft is not None):
            # dynamic-relaxation ICs for the (replicated) line state
            carry = replace(carry, moor=feats.moorings.init_state(carry.st.ft))
        pspec_carry = specs_like(carry)
        # check_vma=False: pallas_call out_shapes carry no vma metadata
        sharded = shard_map(advance, mesh=mesh,
                            in_specs=(pspec_carry, P(), P()),
                            out_specs=pspec_carry, check_vma=False)
        return sharded(carry, t_target, nstep_max)

    return jax.jit(wrap)


# ---------------------------------------------------------------------------
# host-side distribution
# ---------------------------------------------------------------------------

def shard_state(cfg: ShardCfg, st: SimState) -> SimState:
    """Distribute a (capacity n) canonical state into the (ndev*n_local)
    sharded layout by owner slab (host-side, done once at init)."""
    names, arrs = _state_arrays(st)
    arrs = [np.asarray(a) for a in arrs]
    d = dict(zip(names, arrs))
    code = d["code"]
    live = (np.right_shift(code, td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK) \
        < td.SPECIAL_OUT_POS
    xcell = np.floor((d["pos"][:, 0] - cfg.gdom.posmin[0]) / cfg.gdom.scell
                     ).astype(np.int64)
    owner = np.clip(xcell // cfg.ncx_loc, 0, cfg.ndev - 1)
    out = {nm: np.zeros((cfg.ndev * cfg.n_local,) + a.shape[1:], a.dtype)
           for nm, a in d.items()}
    out["code"][:] = _DEAD
    out["pos"][:] = -1e6
    out["rho"][:] = 1000.0
    for dev in range(cfg.ndev):
        sel = np.where(live & (owner == dev))[0]
        if len(sel) > cfg.n_local:
            raise ValueError(f"shard {dev} needs {len(sel)} slots > n_local="
                             f"{cfg.n_local}")
        lo = dev * cfg.n_local
        for nm, a in d.items():
            out[nm][lo:lo + len(sel)] = a[sel]
    kw = {nm: jnp.asarray(v) for nm, v in out.items()}
    for nm in ("velm1", "rhom1", "spstau"):
        kw.setdefault(nm, None)
    return SimState(ft=st.ft, **kw)   # body state stays replicated


# ---------------------------------------------------------------------------
# driver-facing dry run
# ---------------------------------------------------------------------------

def dryrun(n_devices: int) -> None:
    """Build an n-device mesh, jit the FULL sharded step (migration + halo
    exchange + fused forces + global dt reduction) on a tiny 3D dam break,
    and execute one advance on the plain, featured and mDBC paths."""
    from ..models import cases
    from ..typesdef import TpDensity

    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"dryrun needs {n_devices} devices, JAX has "
            f"{len(jax.devices())} ({jax.devices()[0].platform}); on the CPU "
            f"set XLA_FLAGS=--xla_force_host_platform_device_count="
            f"{n_devices} before JAX starts")

    devs = jax.devices()[:n_devices]
    mesh = Mesh(np.array(devs), (AXIS,))

    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    n_local = case.state.n  # safe capacity: any shard could hold everything
    cfg = make_shard_cfg(case.dom, n_devices, n_local)
    carry = make_carry(shard_state(cfg, case.state), case.csp, opts)
    advance = make_sharded_advance(cfg, case.csp, opts, mesh)
    out = advance(carry, jnp.asarray(2e-4, jnp.float32))
    jax.block_until_ready(out.st.pos)
    assert int(out.nstep) >= 1, "sharded step did not run"
    assert int(out.overflow) == 0, f"overflow={int(out.overflow)}"
    print(f"dryrun_multichip({n_devices}): OK — nstep={int(out.nstep)}, "
          f"t={float(out.t):.2e}, dt={float(out.dt_pre):.2e}, "
          f"path={select_path(case.csp, opts)}")

    # featured sharded path: scripted moving wall + damping zone through the
    # same mesh (shard-local feature hooks)
    from ..features.damping import DampingPlane
    from ..features.featureset import Features
    from ..features.motion import RECT, MotionDef, Segment
    code = np.asarray(case.state.code).copy()
    posn = np.asarray(case.state.pos)
    isb = np.asarray(td.code_type(case.state.code)) < td.TYPE_FLUID
    strip = isb & (posn[:, 0] > 0.82)
    code[strip] = td.code_make(td.TYPE_MOVING, 9)
    import dataclasses as _dc
    stf = _dc.replace(case.state, code=jnp.asarray(code))
    feats = Features(
        motions=(MotionDef(mk=9, segments=(
            Segment(kind=RECT, t0=0.0, t1=10.0, params=(-0.05, 0, 0)),)),),
        damping=(DampingPlane(point=(0.55, 0.15, 0.15),
                              limitpoint=(0.8, 0.15, 0.15)),))
    carry_f = make_carry(shard_state(cfg, stf), case.csp, opts)
    adv_f = make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats)
    outf = adv_f(carry_f, jnp.asarray(2e-4, jnp.float32))
    jax.block_until_ready(outf.st.pos)
    assert int(outf.overflow) == 0, f"feats overflow={int(outf.overflow)}"
    print(f"dryrun_multichip({n_devices}): featured path OK — "
          f"nstep={int(outf.nstep)} (motion+damping over the mesh)")

    # mDBC featured path: ghost-node correction + double halo refresh over
    # the mesh (BASELINE config 3 capability)
    from ..typesdef import TpBoundary, TpSlipMode
    case_m = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                              column=(0.3, 0.3, 0.2), obstacle=False,
                              mdbc=True)
    opts_m = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    cfg_m = make_shard_cfg(case_m.dom, n_devices, case_m.state.n, halo=2)
    carry_m = make_carry(shard_state(cfg_m, case_m.state), case_m.csp,
                         opts_m)
    adv_m = make_sharded_advance(cfg_m, case_m.csp, opts_m, mesh)
    outm = adv_m(carry_m, jnp.asarray(2e-4, jnp.float32))
    jax.block_until_ready(outm.st.pos)
    assert int(outm.overflow) == 0, f"mdbc overflow={int(outm.overflow)}"
    print(f"dryrun_multichip({n_devices}): mDBC path OK — "
          f"nstep={int(outm.nstep)} "
          f"(ghost-node correction + halo refresh over the mesh)")


# ---------------------------------------------------------------------------
# host-side sharded run driver
# ---------------------------------------------------------------------------

class ShardedSimulation(Simulation):
    """Host-side run driver over a device mesh: the same save-schedule/
    diagnostics loop as models.wcsph.Simulation, with the advance running
    the sharded step under shard_map (domain decomposition along x).

    Used by the CLI's ``-shard[:n]`` flag so a stock case XML runs across
    every chip of a slice; the carry's particle arrays are globally
    sharded jax.Arrays, and host drains (PART saves, gauges) gather them
    lazily via np.asarray at save ticks."""

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats=None, ndev: int = 0,
                 n_local: int = 0, phases=None, log=print):
        self.csp, self.opts, self.dom = csp, opts, dom
        self.feats = _check_sharded_feats(feats)
        ndev = ndev or len(jax.devices())
        mesh = Mesh(np.array(jax.devices()[:ndev]), (AXIS,))
        reserve = 0
        if feats is not None and feats.periodic is not None:
            from ..features.periodic import ghost_slots_required
            reserve = ghost_slots_required(feats.periodic)
        # halo=2: the NN eta field and the mDBC ghost-node support both
        # reach past one cell of the slab edge
        wide_halo = (phases is not None
                     or opts.tboundary == td.TpBoundary.MDBC)
        halo = 2 if wide_halo else 1
        if feats is not None and feats.inout is not None:
            import math as _m
            import dataclasses as _dc
            # conveyor spawns land up to layers*dp behind a crosser — they
            # must stay inside the local grid until the next migration; the
            # local free-slot limit is the full shard buffer
            band = max(z.layers * csp.dp for z in feats.inout.zones)
            halo = max(halo, int(_m.ceil(band / dom.scell)))
            feats = _dc.replace(feats, inout=_dc.replace(
                feats.inout, n_usable=0))
        cfg = make_shard_cfg(dom, ndev, n_local or state.n, halo=halo,
                             reserve_tail=reserve)
        self.path = "bucket" if phases is not None else select_path(csp, opts)
        self.carry = make_carry(shard_state(cfg, state), csp, opts)
        self.advance = make_sharded_advance(cfg, csp, opts, mesh,
                                            feats=feats, phases=phases,
                                            path=self.path)
        self.cfg, self.mesh = cfg, mesh
        self.part = 0
        self.time = 0.0
        self.log = log
