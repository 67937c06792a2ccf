"""Single-phase WCSPH solver: state, jitted step functions, and the run driver.

Re-design of the reference solver orchestration
(`/root/reference/src/source/JSphCpuSingle.cpp` ``Run``/``ComputeStep_Sym``/
``ComputeStep_Ver``; GPU twin `JSphGpuSingle.cpp:548-894`):

* the whole step — cell divide, force interaction, dt reduction, integration —
  is ONE jitted function; a `lax.while_loop` advances the state to the next
  output time entirely on device (zero host round-trips inside the loop, the
  property the reference achieves on GPU by keeping the loop device-resident,
  SURVEY §2.7);
* the symplectic step divides twice (predictor reuses the end-of-previous-step
  divide; corrector re-divides mid-step, `JSphCpuSingle.cpp:695-720`);
* dt bookkeeping matches `DtVariable` + ``SymplecticDtPre=min(dt_p,dt_c)``;
* particle population is fixed-capacity: excluded particles flip their
  typecode and stop participating (reference compacts them out and streams
  them to PartOut, `JCellDivCpu`); the host drains diagnostics at save ticks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph, TpShifting, TpStep, TpVisco
from ..ops import celldiv as cd
from ..ops import eos
from ..ops import forces as F
from ..ops import integrators as I
from ..ops import nbrlist as NB
from ..ops.forces import SolverOpts
from ..ops.pallas import cellforce as CF
from ..features import accinput as ACC
from ..features import awas as AWAS
from ..features import damping as DMP
from ..features import floating as FT
from ..features import inout as IO
from ..features import mlpiston as MLP
from ..features import motion as MOT
from ..features import relaxzone as RZ
from ..features.featureset import Features


@jax.tree_util.register_dataclass
@dataclass
class SimState:
    """Canonical particle state (SoA, fixed capacity, id-stable).

    The analog of the reference's pooled particle arrays (`JSphCpu.h`
    Idpc/Codec/Posc/Velrhopc/VelrhopM1c/SpsTauc...), never reordered."""
    pos: jax.Array            # (n,3)
    vel: jax.Array            # (n,3)
    rho: jax.Array            # (n,)
    code: jax.Array           # (n,) uint32
    idp: jax.Array            # (n,) uint32
    velm1: jax.Array | None = None   # Verlet M1 state
    rhom1: jax.Array | None = None
    spstau: jax.Array | None = None  # (n,6) SPS stress
    ft: "FT.FloatingState | None" = None   # floating body state
    boundnormal: jax.Array | None = None   # (n,3) mDBC normals
    motionvel: jax.Array | None = None     # (n,3) wall velocity for mDBC no-slip
    # compensated-position residual (SolverOpts.poscomp): pos + pose is the
    # true trajectory at ~2x24-bit precision (integrators.comp_pos_update)
    pose: jax.Array | None = None

    @property
    def n(self) -> int:
        return self.pos.shape[0]


@jax.tree_util.register_dataclass
@dataclass
class StepCarry:
    """Device-resident per-step scalars (the reference's TimeStep/DtPre/
    VerletStep/Nstep plus diagnostics)."""
    st: SimState
    t: jax.Array              # () f32 — time since interval start
    dt_pre: jax.Array         # () f32 — SymplecticDtPre / last dt
    verlet_count: jax.Array   # () i32
    nstep: jax.Array          # () i32
    overflow: jax.Array       # () i32 — max bucket overflow observed (must stay 0)
    dtmodif: jax.Array        # () i32 — dt clamped-to-min counter
    tabs: jax.Array | None = None     # () f32 — absolute sim time (motion clock)
    nbr: "NB.NbrList | None" = None   # Verlet neighbour list (nbrlist mode)
    # SaveDt diagnostics ring (cap, 6): [tabs, dt, dt1, dt2, acemax, viscdt]
    # written at row nstep %% cap (reference JDsSaveDt, SURVEY §2.13)
    dthist: jax.Array | None = None
    # per-paddle accumulated AWAS correction displacement (P,)
    awas: jax.Array | None = None
    # per-dt floating motion ring (cap, 1+9B): [t, center, fvel, fomega]
    # per body, row nstep %% cap (JFtMotionSave, SURVEY §2.9)
    fthist: jax.Array | None = None
    # amortized-rebuild neighbour structure of the GPU kernel path
    # (celldiv.SortDiv): the state lives in cell-sorted order; pos0 =
    # positions at the last rebuild, the displacement anchor of the
    # Verlet-list skin contract
    sdiv: "cd.SortDiv | None" = None
    pos0: jax.Array | None = None
    nrebuild: jax.Array | None = None
    # bucket divide for the mDBC ghost-node prepass, amortized under the
    # same skin contract (superset holds: stale cell within one scell of
    # any query point's current cell)
    bdiv: "cd.DivData | None" = None
    # dynamic mooring-line node state (features.moorings.MoorState — the
    # lumped-mass MoorDyn+ replacement integrates inside the step)
    moor: "object | None" = None


def select_path(csp: CteSph, opts: SolverOpts, platform: str = None) -> str:
    """The force-interaction path of a run, chosen by the code:

    * ``"nbrlist"`` when the configuration asks for the Verlet-list layout
      (``SolverOpts.use_nbrlist``);
    * on the GPU, ``"cellforce"`` — the fused kernel
      (ops.pallas.cellforce) — when it supports the configuration;
    * otherwise ``"bucket"``, the plain XLA path (ops.forces), which is also
      the CPU reference.

    ``platform`` defaults to JAX's default backend."""
    if opts.use_nbrlist:
        return "nbrlist"
    platform = platform or jax.default_backend()
    if platform == "gpu" and CF.supports(csp, opts):
        return "cellforce"
    return "bucket"


def _carries_layout(path: str, dom: cd.Domain, feats: Features) -> bool:
    """The kernel path keeps its sorted layout in the carry (rebuilt only
    when the skin contract demands it) unless a feature resizes the
    particle population mid-interval (periodic ghost slots, inout spawns)
    or indexes particles by static slot (DEM tables); those divide every
    step instead."""
    if path != "cellforce" or dom is None:
        return False
    return feats is None or (feats.periodic is None and feats.inout is None
                             and feats.dem is None)


_SORTED_FIELDS = ("pos", "vel", "rho", "code", "idp", "velm1", "rhom1",
                  "spstau", "boundnormal", "motionvel", "pose")


def _sorted_rebuild(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                    st: SimState, with_bdiv: bool = False):
    """Divide + permute the state into cell-sorted order (the reference's
    SortArray pass, JSphCpuSingle.cpp:450-467 — but run only when the skin
    contract demands it, not every step).  Returns (state, sdiv[, bdiv])."""
    block = CF.tile_config(csp, opts)[0]
    sd, code = cd.divide_sorted(dom, st.pos, st.code, block=block)
    st = replace(st, code=code)
    st = replace(st, **{f: getattr(st, f)[sd.order] for f in _SORTED_FIELDS
                        if getattr(st, f) is not None})
    if with_bdiv:
        bdiv, code2 = cd.divide(dom, st.pos, st.code)
        return replace(st, code=code2), sd, bdiv
    return st, sd


def _sorted_tick(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 margin: float, carry: StepCarry):
    """Verlet-list contract at the window level: rebuild the divide only
    when accumulated displacement (plus this step's worst-case motion) could
    exceed the cell skin — amortizes the whole divide + state permute over
    the steps in between.  Returns (carry, sdiv)."""
    st = carry.st
    act = td.is_active(st.code)
    d2 = jnp.max(jnp.where(
        act, jnp.sum((st.pos - carry.pos0) ** 2, axis=1), 0.0))
    vmax = I.velocity_max(csp, st.vel, st.code)
    need = (2.0 * jnp.sqrt(d2) + 4.0 * carry.dt_pre * vmax) \
        >= jnp.float32(0.95 * margin)
    with_bdiv = carry.bdiv is not None

    def rebuild(s):
        out = _sorted_rebuild(csp, opts, dom, s, with_bdiv=with_bdiv)
        if with_bdiv:
            s2, sd2, bd2 = out
            return s2, sd2, s2.pos, bd2
        s2, sd2 = out
        return s2, sd2, s2.pos, carry.bdiv

    def keep(s):
        return s, carry.sdiv, carry.pos0, carry.bdiv

    st, sdiv, pos0, bdiv = jax.lax.cond(need, rebuild, keep, st)
    carry = replace(carry, st=st, sdiv=sdiv, pos0=pos0, bdiv=bdiv,
                    nrebuild=carry.nrebuild + need.astype(jnp.int32))
    return carry, sdiv


def make_carry(st: SimState, csp: CteSph, opts: SolverOpts = None,
               feats: Features = None, dom: cd.Domain = None,
               path: str = None) -> StepCarry:
    """Initial carry.  ``path`` (default :func:`select_path`) decides whether
    the state starts in the kernel path's cell-sorted layout."""
    f32 = st.vel.dtype
    if (opts is not None and getattr(opts, "poscomp", False)
            and st.pose is None):
        st = replace(st, pose=jnp.zeros_like(st.pos))
    nbr = None
    if opts is not None and opts.use_nbrlist:
        nbr = NB.empty_list(st.n, opts.nbr_m or NB.auto_m(csp, opts.nbr_skin))
    sdiv = pos0 = nrebuild = bdiv = None
    if opts is not None and _carries_layout(
            path or select_path(csp, opts), dom, feats):
        with_bdiv = (opts.tboundary == td.TpBoundary.MDBC
                     and st.boundnormal is not None)
        out = jax.jit(lambda s: _sorted_rebuild(
            csp, opts, dom, s, with_bdiv=with_bdiv))(st)
        st, sdiv = out[:2]
        bdiv = out[2] if with_bdiv else None
        pos0 = st.pos
        nrebuild = jnp.ones((), jnp.int32)
    return StepCarry(
        st=st,
        t=jnp.zeros((), f32),
        dt_pre=jnp.asarray(csp.dtini, f32),
        verlet_count=jnp.zeros((), jnp.int32),
        nstep=jnp.zeros((), jnp.int32),
        overflow=jnp.zeros((), jnp.int32),
        dtmodif=jnp.zeros((), jnp.int32),
        tabs=jnp.zeros((), f32),
        nbr=nbr,
        dthist=(jnp.zeros((opts.savedt, 6), f32)
                if opts is not None and opts.savedt else None),
        awas=(jnp.zeros((len(feats.awas),), f32)
              if feats is not None and feats.awas else None),
        fthist=(jnp.zeros((opts.ftmotion,
                           1 + 9 * feats.floating.count), f32)
                if opts is not None and opts.ftmotion
                and feats is not None and feats.floating is not None
                else None),
        sdiv=sdiv,
        pos0=pos0,
        nrebuild=nrebuild,
        bdiv=bdiv,
        moor=(feats.moorings.init_state(st.ft)
              if feats is not None and feats.moorings is not None
              and getattr(feats.moorings, "dynamic", False)
              and st.ft is not None else None),
    )


def _record_ftmotion(carry: StepCarry, opts, st: SimState, t_next):
    """Write one [t, center, fvel, fomega] row into the ftmotion ring (the
    per-dt capture of JFtMotionSave::SaveFtData)."""
    if carry.fthist is None or st.ft is None:
        return carry.fthist
    row = jnp.concatenate([
        jnp.reshape(t_next, (1,)),
        st.ft.center.reshape(-1).astype(jnp.float32),
        st.ft.fvel.reshape(-1).astype(jnp.float32),
        st.ft.fomega.reshape(-1).astype(jnp.float32)])
    return carry.fthist.at[carry.nstep % opts.ftmotion].set(row)


def _mdbc_prepass(csp, opts, dom, st: SimState, divb=None):
    """mDBC ghost-node correction as a jnp pre-pass over a bucket divide —
    it only rewrites bound vel/rho before the boundary-type-agnostic force
    kernel (JSphCpuSingle::MdbcBoundCorrection, JSphCpuSingle.cpp:573).
    ``divb``: an amortized divide from the carry (skin contract)."""
    if divb is None:
        divb, codeb = cd.divide(dom, st.pos, st.code)
        st = replace(st, code=codeb)
    from ..ops import mdbc as MDBC
    vel2, rho2 = MDBC.mdbc_correction(
        csp, opts, dom, divb, st.pos, st.vel, st.rho, st.code,
        st.boundnormal, st.motionvel)
    return replace(st, vel=vel2, rho=rho2)


def _interaction(csp, opts, dom, st: SimState, ddtkh=None, feats=None,
                 tabs=None, dt=None, reuse=None, sdiv=None, bdiv=None,
                 nbr=None, path="bucket", interpret=False):
    """Divide + pre-interaction + forces (the body of
    `JSphCpuSingle::Interaction_Forces`, JSphCpuSingle.cpp:524-567).

    ``path`` (see :func:`select_path`): ``"cellforce"`` runs the fused GPU
    kernel over the cell-sorted divide — the carried ``sdiv`` when the state
    lives in sorted order, else a divide of its own — and ``"bucket"`` the
    jnp bucket path; a Verlet list ``nbr`` takes precedence.
    External accelerations (AccInput) are folded into the accumulators like
    the reference's PreInteractionVars_Forces (JSphCpu.cpp:445), entering
    AceMax and the dt control.

    ``reuse``: a divide structure from earlier in the same step.  The
    reference divides ONCE per symplectic step (`RunCellDivide` runs between
    predictor and corrector only, JSphCpuSingle.cpp:710); here the predictor
    divides and the corrector reuses its binning — field values are always
    re-read at the current state, only the cell assignment is a half-step
    stale (particles move <= CFL*h per step, a fraction of the 2h cell)."""
    ftomassp = None
    pov = None
    visco = None
    if feats is not None and feats.viscotime is not None and tabs is not None:
        # JDsViscoInput: Visco = table(TimeStep) each step
        # (JSphCpuSingle.cpp:1092), traced so the jit is stable
        visco = feats.viscotime.visco_at(tabs)
    if ddtkh is None and opts.ddtramp is not None and tabs is not None:
        # initial DDT ramp (RunInitialDDTRamp, JSphCpuSingle.cpp:650-663):
        # value=maxvalue while t<=tmaxv, then linear down to ddtvalue at
        # t=tramp; plain ddtvalue afterwards.  Traced scalar — one compile.
        tramp, tmaxv, vmax = opts.ddtramp
        t = jnp.asarray(tabs, jnp.float32)
        trr = max(tramp - tmaxv, 1e-30)
        blend = ((tramp - t) / trr) * (vmax - csp.ddtvalue) + csp.ddtvalue
        val = jnp.where(t <= tmaxv, vmax, blend)
        val = jnp.where(t < tramp, val, csp.ddtvalue)
        ddtkh = (csp.kernelsize * val).astype(jnp.float32)
    if feats is not None and feats.floating is not None:
        ftomassp = jnp.asarray(feats.floating.massp, jnp.float32)
    if reuse is None and feats is not None and feats.periodic is not None:
        from ..features import periodic as PER
        st, pov = PER.apply_periodic(feats.periodic, csp, st)
    if nbr is not None:
        # Verlet-list layout: the amortized (n, M) neighbour table replaces
        # the divide; all feature hooks run unchanged (they act on state /
        # rigid accumulators, not the interaction layout)
        if (opts.tboundary == td.TpBoundary.MDBC
                and st.boundnormal is not None):
            st = _mdbc_prepass(csp, opts, dom, st)
        press = eos.press_from_rho(csp, st.rho)
        fr = NB.interaction_forces_nbr(
            csp, opts, nbr, st.pos, st.vel, st.rho, press, st.code,
            spstau=st.spstau, ftomassp=ftomassp, ddtkh=ddtkh, visco=visco)
        if feats is not None and feats.dem is not None:
            from ..features import dem as DEM
            dem_ace, demdt = DEM.apply_dem_nbr(
                feats.dem, csp, nbr, st.pos, st.vel, st.code,
                dt if dt is not None else csp.dtini)
            fr = replace(fr, ace=fr.ace + dem_ace,
                         viscdtmax=jnp.maximum(fr.viscdtmax, demdt))
        fr = _post_forces(csp, feats, tabs, st, fr)
        return st, nbr, fr
    if path == "cellforce":
        if (opts.tboundary == td.TpBoundary.MDBC
                and st.boundnormal is not None):
            # mDBC ghost-node correction stays a jnp pre-pass over a bucket
            # divide; the kernel then consumes the corrected bound vel/rho
            # like any DBC run
            st = _mdbc_prepass(csp, opts, dom, st, divb=bdiv)
        if sdiv is not None:
            # carried layout: the state is already in sorted order
            sd, sorted_state = sdiv, True
        elif reuse is not None:
            sd, sorted_state = reuse, False
        else:
            sd, code = cd.divide_sorted(dom, st.pos, st.code,
                                        block=CF.tile_config(csp, opts)[0])
            st = replace(st, code=code)
            sorted_state = False
        fr = CF.interaction_forces(
            csp, opts, sd, st.pos, st.vel, st.rho, st.code,
            ftomassp=ftomassp, spstau=st.spstau, ddtkh=ddtkh, visco=visco,
            state_sorted=sorted_state, interpret=interpret)
        if feats is not None and feats.dem is not None:
            # DEM contact right after the SPH force pass (JSphCpu.cpp:
            # 990-1010); candidates come from a bucket divide
            from ..features import dem as DEM
            divb, _ = cd.divide(dom, st.pos, st.code)
            dem_ace, demdt = DEM.apply_dem(
                feats.dem, csp, dom, divb, st.pos, st.vel, st.code,
                dt if dt is not None else csp.dtini)
            fr = replace(fr, ace=fr.ace + dem_ace,
                         viscdtmax=jnp.maximum(fr.viscdtmax, demdt))
        fr = _post_forces(csp, feats, tabs, st, fr)
        if pov is not None:
            sd = replace(sd, overflow=sd.overflow + pov)
        return st, sd, fr
    if reuse is not None:
        div = reuse
    else:
        div, code = cd.divide(dom, st.pos, st.code)
        st = replace(st, code=code)
    if (opts.tboundary == td.TpBoundary.MDBC
            and st.boundnormal is not None):
        from ..ops import mdbc as MDBC
        vel2, rho2 = MDBC.mdbc_correction(
            csp, opts, dom, div, st.pos, st.vel, st.rho, st.code,
            st.boundnormal, st.motionvel)
        st = replace(st, vel=vel2, rho=rho2)
    press = eos.press_from_rho(csp, st.rho)
    fr = F.interaction_forces(csp, opts, div, st.pos, st.vel, st.rho, press,
                              st.code, spstau=st.spstau, ftomassp=ftomassp,
                              ddtkh=ddtkh, visco=visco)
    if feats is not None and feats.dem is not None:
        # DEM contact adds to floating accelerations and the dt reduction
        # at the reference's attachment point (InteractionForcesDEM runs
        # right after the SPH force pass, JSphCpu.cpp:990-1010)
        from ..features import dem as DEM
        dem_ace, demdt = DEM.apply_dem(feats.dem, csp, dom, div, st.pos,
                                       st.vel, st.code,
                                       dt if dt is not None else csp.dtini)
        fr = replace(fr, ace=fr.ace + dem_ace,
                     viscdtmax=jnp.maximum(fr.viscdtmax, demdt))
    fr = _post_forces(csp, feats, tabs, st, fr)
    if pov is not None:
        div = replace(div, overflow=div.overflow + pov)
    return st, div, fr


def _ext_body_forces(feats, st, tabs, moor=None):
    """Mooring/force-point contributions to the rigid solve (the analog of
    folding JDsFtForcePoints into FtoForces, JSphCpuSingle.cpp:903-913)."""
    face = fom = None
    if feats.moorings is not None:
        if getattr(feats.moorings, "dynamic", False):
            face, fom = feats.moorings.forces(st.ft, moor, tabs=tabs)
        else:
            face, fom = feats.moorings.forces(st.ft)
    if feats.forcepoints is not None:
        f2, m2 = feats.forcepoints.forces(st.ft, tabs)
        face = f2 if face is None else face + f2
        fom = m2 if fom is None else fom + m2
    return face, fom


def _post_forces(csp, feats, tabs, st, fr):
    if feats is not None and feats.accinputs:
        ace = ACC.apply_accinput(feats.accinputs, csp, tabs, st.pos, st.vel,
                                 st.code, fr.ace)
        fr = replace(fr, ace=ace)
    return fr


def _refresh_nbr(csp, opts, dom, carry: StepCarry):
    """Rebuild the Verlet list iff the skin condition demands it (lax.cond:
    the rebuild branch pays sort + candidate scan, the keep branch is free)."""
    st = carry.st

    def rebuild(_):
        return NB.build(dom, csp, opts, st.pos, st.code)

    def keep(_):
        return carry.nbr, st.code

    need = NB.needs_rebuild(csp, opts, carry.nbr, st.pos, st.code)
    nbr, code = jax.lax.cond(need, rebuild, keep, None)
    return replace(carry, st=replace(st, code=code), nbr=nbr)


def make_symplectic_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                         feats: Features = None, path: str = None,
                         interpret: bool = False):
    """Returns step(carry) -> carry implementing ComputeStep_Sym
    (JSphCpuSingle.cpp:695-722) with the feature hooks at the reference's
    attachment points: floating predictor dt/2 + corrector dt
    (JSphCpuSingle.cpp:707,715), damping after the corrector (:716-718),
    scripted motion at the loop end (:1096)."""

    path = path or select_path(csp, opts)
    carried = _carries_layout(path, dom, feats)
    use_nbr = opts.use_nbrlist
    margin = (dom.scell - csp.kernelsize) if dom is not None else 0.0
    kw = dict(path=path, interpret=interpret)

    def step(carry: StepCarry) -> StepCarry:
        st = carry.st
        dt = carry.dt_pre
        tabs = carry.tabs

        sdiv = nbr = None
        if carried and carry.sdiv is not None:
            carry, sdiv = _sorted_tick(csp, opts, dom, margin, carry)
            st = carry.st
        elif use_nbr:
            carry = _refresh_nbr(csp, opts, dom, carry)
            st = carry.st
            nbr = carry.nbr

        # ---------------- predictor ----------------
        st, div1, fr1 = _interaction(csp, opts, dom, st, feats=feats,
                                     tabs=tabs, dt=dt, sdiv=sdiv,
                                     bdiv=carry.bdiv, nbr=nbr, **kw)
        velmax1 = I.velocity_max(csp, st.vel, st.code)
        acemax1 = I.ace_max(fr1.ace, st.code)
        dt_p, bad_p = I.dt_variable(csp, acemax1, velmax1, fr1.viscdtmax)

        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        if opts.tvisco == TpVisco.LAMINAR_SPS:
            tau = F.compute_sps_tau(csp, st.rho, fr1.spsgradvel)
            tau = jnp.where(td.is_fluid(st.code)[:, None], tau, 0.0)
            st = replace(st, spstau=tau)
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)
        if feats is not None and feats.floating is not None:
            eface, efom = _ext_body_forces(feats, st, tabs, carry.moor)
            posf, velf, fts = FT.run_floating(
                feats.floating, csp, st.ft, tabs, dt * 0.5, True,
                st.pos, st.vel, st.code, fr1.ace,
                ext_face=eface, ext_fomegaace=efom,
                    chrono=feats.chrono, chcontact=feats.chcontact)
            st = replace(st, pos=posf, vel=velf, ft=fts)

        # ---------------- corrector ----------------
        # reuse the predictor's divide unless a feature rebuilds the particle
        # population mid-step (periodic ghost slots, inout spawns)
        reuse = div1 if (feats is None or (feats.periodic is None
                                           and feats.inout is None)) else None
        st, div2, fr2 = _interaction(csp, opts, dom, st, feats=feats,
                                     tabs=tabs, dt=dt, reuse=reuse,
                                     sdiv=sdiv, bdiv=carry.bdiv, nbr=nbr,
                                     **kw)
        velmax2 = I.velocity_max(csp, st.vel, st.code)
        acemax2 = I.ace_max(fr2.ace, st.code)
        dt_c, bad_c, dt1_c, dt2_c = I.dt_variable_parts(
            csp, acemax2, velmax2, fr2.viscdtmax)
        dthist = carry.dthist
        if dthist is not None:
            row = jnp.stack([tabs, dt, dt1_c, dt2_c, acemax2, fr2.viscdtmax])
            dthist = dthist.at[carry.nstep % opts.savedt].set(row)

        shiftdisp = None
        if opts.shiftmode != TpShifting.NONE:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr2.shiftposfs, fr2.shift_blocked)
        out_corr = I.symplectic_corr(
            csp, pos_pre, vel_pre, rho_pre, st.rho, st.code,
            fr2.ace, fr2.ar, dt, shiftdisp, pose=st.pose)
        pos2, vel2, rho2, code2 = out_corr[:4]
        if st.pose is not None:
            st = replace(st, pose=out_corr[4])
        if opts.tvisco == TpVisco.LAMINAR_SPS:
            tau = F.compute_sps_tau(csp, st.rho, fr2.spsgradvel)
            tau = jnp.where(td.is_fluid(st.code)[:, None], tau, 0.0)
            st = replace(st, spstau=tau)
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2)
        moor = carry.moor
        if feats is not None:
            if feats.floating is not None:
                eface, efom = _ext_body_forces(feats, st, tabs, moor)
                posf, velf, fts = FT.run_floating(
                    feats.floating, csp, st.ft, tabs, dt, False,
                    st.pos, st.vel, st.code, fr2.ace,
                    ext_face=eface, ext_fomegaace=efom,
                    chrono=feats.chrono, chcontact=feats.chcontact)
                st = replace(st, pos=posf, vel=velf, ft=fts)
                if moor is not None:
                    # integrate the lumped-mass lines to the end-of-step
                    # fairlead state (MoorDyn_FairleadsCalc coupling instant,
                    # JSphCpuSingle.cpp:1009-1015)
                    moor = feats.moorings.advance(moor, fts, dt, tabs=tabs)
            if feats.damping:
                st = replace(st, vel=DMP.apply_damping(
                    feats.damping, dt, st.pos, st.vel, st.code))
            if feats.relaxzones:
                st = replace(st, vel=RZ.apply_relaxzones(
                    feats.relaxzones, csp, tabs, st.pos, st.vel, st.code,
                    dt=dt))
            if feats.motions:
                posm, velm = MOT.apply_motion(feats.motions, tabs, dt,
                                              st.pos, st.vel, st.code)
                upd = dict(pos=posm, vel=velm)
                if st.motionvel is not None:
                    moving = td.is_moving(st.code)
                    upd["motionvel"] = jnp.where(moving[:, None], velm, 0.0)
                st = replace(st, **upd)
            if feats.mlpistons:
                posm, velm = MLP.apply_mlpistons(feats.mlpistons, tabs, dt,
                                                 st.pos, st.vel, st.code)
                st = replace(st, pos=posm, vel=velm)

        awas_corr = carry.awas
        if feats is not None and feats.awas:
            posa, vela, awas_corr = AWAS.apply_awas(
                feats.awas, csp, carry.awas, tabs, dt,
                st.pos, st.vel, st.code)
            st = replace(st, pos=posa, vel=vela)

        stepov = jnp.maximum(div1.overflow, div2.overflow)
        if feats is not None and feats.inout is not None:
            st, ioov = IO.inout_step(feats.inout, csp, st, dt, tabs,
                                     nstep=carry.nstep, dom=dom)
            stepov = stepov + ioov

        return replace(
            carry,
            st=st,
            t=carry.t + dt,
            dt_pre=jnp.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow, stepov),
            dtmodif=carry.dtmodif + bad_p.astype(jnp.int32)
                    + bad_c.astype(jnp.int32),
            tabs=tabs + dt,
            dthist=dthist,
            awas=awas_corr,
            fthist=_record_ftmotion(carry, opts, st, tabs + dt),
            moor=moor,
        )

    return step


def make_verlet_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                     feats: Features = None, path: str = None,
                     interpret: bool = False):
    """Returns step(carry) -> carry implementing ComputeStep_Ver
    (JSphCpuSingle.cpp:674-690) with the VerletSteps re-anchoring."""

    path = path or select_path(csp, opts)
    carried = _carries_layout(path, dom, feats)
    use_nbr = opts.use_nbrlist
    margin = (dom.scell - csp.kernelsize) if dom is not None else 0.0
    kw = dict(path=path, interpret=interpret)

    def step(carry: StepCarry) -> StepCarry:
        st = carry.st
        tabs = carry.tabs
        sdiv = nbr = None
        if carried and carry.sdiv is not None:
            carry, sdiv = _sorted_tick(csp, opts, dom, margin, carry)
            st = carry.st
        elif use_nbr:
            carry = _refresh_nbr(csp, opts, dom, carry)
            st = carry.st
            nbr = carry.nbr
        st, div1, fr = _interaction(csp, opts, dom, st, feats=feats,
                                    tabs=tabs, dt=carry.dt_pre, sdiv=sdiv,
                                    bdiv=carry.bdiv, nbr=nbr, **kw)
        velmax = I.velocity_max(csp, st.vel, st.code)
        acemax = I.ace_max(fr.ace, st.code)
        dt, bad, dt1, dt2 = I.dt_variable_parts(csp, acemax, velmax,
                                                fr.viscdtmax)
        dthist = carry.dthist
        if dthist is not None:
            row = jnp.stack([tabs, dt, dt1, dt2, acemax, fr.viscdtmax])
            dthist = dthist.at[carry.nstep % opts.savedt].set(row)

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
        if st.pose is not None:
            st = replace(st, pose=out_ver[4])
        if opts.tvisco == TpVisco.LAMINAR_SPS:
            tau = F.compute_sps_tau(csp, st.rho, fr.spsgradvel)
            tau = jnp.where(td.is_fluid(st.code)[:, None], tau, 0.0)
            st = replace(st, spstau=tau)
        # the reference swaps Velrhopc/VelrhopM1c: new M1 = pre-step state
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2,
                     velm1=st.vel, rhom1=st.rho)
        moor = carry.moor
        if feats is not None:
            if feats.floating is not None:
                eface, efom = _ext_body_forces(feats, st, tabs, moor)
                posf, velf, fts = FT.run_floating(
                    feats.floating, csp, st.ft, tabs, dt, False,
                    st.pos, st.vel, st.code, fr.ace,
                    ext_face=eface, ext_fomegaace=efom,
                    chrono=feats.chrono, chcontact=feats.chcontact)
                st = replace(st, pos=posf, vel=velf, ft=fts)
                if moor is not None:
                    moor = feats.moorings.advance(moor, fts, dt, tabs=tabs)
            if feats.damping:
                st = replace(st, vel=DMP.apply_damping(
                    feats.damping, dt, st.pos, st.vel, st.code))
            if feats.relaxzones:
                st = replace(st, vel=RZ.apply_relaxzones(
                    feats.relaxzones, csp, tabs, st.pos, st.vel, st.code,
                    dt=dt))
            if feats.motions:
                posm, velm = MOT.apply_motion(feats.motions, tabs, dt,
                                              st.pos, st.vel, st.code)
                st = replace(st, pos=posm, vel=velm)
            if feats.mlpistons:
                posm, velm = MLP.apply_mlpistons(feats.mlpistons, tabs, dt,
                                                 st.pos, st.vel, st.code)
                st = replace(st, pos=posm, vel=velm)

        awas_corr = carry.awas
        if feats is not None and feats.awas:
            posa, vela, awas_corr = AWAS.apply_awas(
                feats.awas, csp, carry.awas, tabs, dt,
                st.pos, st.vel, st.code)
            st = replace(st, pos=posa, vel=vela)

        stepov = div1.overflow
        if feats is not None and feats.inout is not None:
            st, ioov = IO.inout_step(feats.inout, csp, st, dt, tabs,
                                     nstep=carry.nstep, dom=dom)
            stepov = stepov + ioov

        return replace(
            carry,
            st=st,
            t=carry.t + dt,
            dt_pre=dt,
            verlet_count=jnp.where(use_m1, vcount, 0),
            nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow, stepov),
            dtmodif=carry.dtmodif + bad.astype(jnp.int32),
            tabs=tabs + dt,
            dthist=dthist,
            awas=awas_corr,
            moor=moor,
            fthist=_record_ftmotion(carry, opts, st, tabs + dt),
        )

    return step


def pinned_precision(step):
    """Run ``step`` with f32 matrix products at full precision.  The small
    products inside a step (rigid-body rotations and inertia, the mDBC and
    inout least-squares solves, joint and mooring geometry) feed the state;
    on the GPU XLA may otherwise run them in TF32 (~3 decimal digits).  The
    pair physics has no matrix products and is unaffected."""
    def step_highest(carry):
        with jax.default_matmul_precision("highest"):
            return step(carry)
    return step_highest


def make_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
              feats: Features = None, path: str = None,
              interpret: bool = False):
    """One solver step for ``opts.tstep``.  ``path`` defaults to
    :func:`select_path`; ``interpret`` runs the GPU kernel in Pallas
    interpret mode (tests reach the kernel path on the CPU this way)."""
    if opts.use_nbrlist and feats is not None and (
            feats.periodic is not None or feats.inout is not None):
        # ghost-slot re-selection / inlet spawns change the particle
        # population mid-run, which breaks the list's skin contract — those
        # configs use the per-step divide layouts
        raise NotImplementedError("nbrlist mode does not support periodic "
                                  "ghosts or inlet/outlet zones")
    if opts.tstep == TpStep.SYMPLECTIC:
        step = make_symplectic_step(csp, opts, dom, feats, path, interpret)
    else:
        step = make_verlet_step(csp, opts, dom, feats, path, interpret)
    return pinned_precision(step)


def make_advance(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 feats: Features = None, step=None):
    """advance(carry, t_target) — run steps until interval time >= t_target,
    fully on device (the reference's main loop `JSphCpuSingle.cpp:1090-1120`
    between PART saves)."""
    step = step or make_step(csp, opts, dom, feats)

    def advance(carry: StepCarry, t_target, nstep_max):
        def cond(c):
            return (c.t < t_target) & (c.nstep < nstep_max)

        return jax.lax.while_loop(cond, step, carry)

    return jax.jit(advance)


class Simulation:
    """Host-side run driver (the analog of `JSphCpuSingle::Run`,
    JSphCpuSingle.cpp:1049-1202): owns the jitted advance function, the save
    schedule, and host-side diagnostics drains."""

    def __init__(self, csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 state: SimState, feats: Features = None, step=None,
                 log=print, path: str = None):
        self.csp, self.opts, self.dom = csp, opts, dom
        self.feats = feats
        # the interaction path (select_path unless given, e.g. by a
        # benchmark comparing paths); a custom ``step`` runs its own
        self.path = path or select_path(csp, opts)
        self.carry = make_carry(state, csp, opts, feats, dom=dom,
                                path=self.path)
        self.advance = make_advance(
            csp, opts, dom, feats,
            step=step or make_step(csp, opts, dom, feats, path=self.path))
        self.part = 0
        self.time = 0.0        # global sim time (host f64 accumulator)
        self.log = log

    @property
    def state(self) -> SimState:
        return self.carry.st

    # excluded-fluid cap: fraction of the initial fluid allowed out before
    # the run aborts (XML <PartsOutMax>, reference NpfOutMax/NpMinimum check
    # JSphCpuSingle.cpp:1101-1106); None disables
    partsoutmax: float | None = None
    # directory for failure-evidence dumps (Error_BoundaryOut.vtk)
    errdir: str = "."

    def check_diagnostics(self):
        ov = int(self.carry.overflow)
        if ov:
            raise RuntimeError(
                f"cell bucket overflow: {ov} particle(s) dropped — increase "
                f"Domain.cellcap (reference analog: ResizeParticlesSize, "
                f"JSphCpuSingle.cpp:176)")
        st = self.carry.st
        code = np.asarray(st.code)
        sp = td.code_special(code)
        # OUT_IGNORE marks padding/never-active slots, not exclusions
        out = (sp >= td.SPECIAL_OUT_POS) & (sp != td.SPECIAL_OUT_IGNORE)
        bound_out = out & (td.code_type(code) < td.TYPE_FLUID)
        if bound_out.any():
            # fixed/moving boundary particles left the domain: fatal geometry
            # or motion error — dump the evidence like AbortBoundOut
            # (JSph.cpp:2477, Error_BoundaryOut.vtk) and abort
            import os
            from ..io import vtkout
            p = os.path.join(self.errdir, "Error_BoundaryOut.vtk")
            try:
                os.makedirs(self.errdir, exist_ok=True)
                vtkout.write_vtk_particles(
                    p, np.asarray(st.pos)[bound_out],
                    {"Idp": np.asarray(st.idp)[bound_out]})
            except OSError:
                p = "(vtk dump failed)"
            raise RuntimeError(
                f"{int(bound_out.sum())} boundary particle(s) excluded from "
                f"the domain (evidence: {p}; reference AbortBoundOut, "
                f"JSph.cpp:2477)")
        if self.partsoutmax is not None:
            fluid_out = int((out & (td.code_type(code) == td.TYPE_FLUID)
                             & ~td.is_floating(code)).sum())
            nfluid0 = getattr(self, "_nfluid0", None)
            if nfluid0 is None:
                act = td.is_active(code) | out
                self._nfluid0 = nfluid0 = int(
                    (td.code_type(code) == td.TYPE_FLUID)[act].sum())
            if nfluid0 and fluid_out > self.partsoutmax * nfluid0:
                raise RuntimeError(
                    f"excluded fluid particles ({fluid_out}) exceed "
                    f"PartsOutMax={self.partsoutmax:g} of {nfluid0} "
                    f"(reference NpMinimum check, JSphCpuSingle.cpp:1101)")

    # cap on steps per device call: keeps single executions bounded (some
    # runtimes watchdog launches longer than ~45 s) without extra host
    # syncs; adapted at runtime toward ~15 s per call
    steps_per_call = 256
    target_call_seconds = 15.0

    def _advance_to(self, carry, target):
        """Advance the interval clock to >= ``target`` (possibly several
        device calls, adapting steps_per_call toward target_call_seconds)."""
        while True:
            nmax = carry.nstep + self.steps_per_call
            tc0 = time.time()
            n0 = int(carry.nstep)
            carry = self.advance(carry, jnp.asarray(target, jnp.float32),
                                 nmax)
            carry.t.block_until_ready()
            tcall = time.time() - tc0
            ndone = int(carry.nstep) - n0
            if ndone > 0 and tcall > 1.0:
                per = tcall / ndone
                self.steps_per_call = max(
                    8, min(4096, int(self.target_call_seconds / per)))
            if float(carry.t) >= target:
                return carry

    def run(self, tmax: float, tout, on_save=None, max_steps=None,
            terminate=None, next_subtick=None, on_subtick=None):
        """Run to ``tmax`` saving every ``tout`` seconds of sim time.
        ``tout`` may be a float or an io.output.OutputTime variable schedule
        (JDsOutputTime).  ``terminate``: optional utils.runinfo.TerminateCheck
        polled between intervals (JSph::CheckTermination).

        ``next_subtick(t_abs) -> t or None`` / ``on_subtick(sim, t_abs)``:
        in-interval cadence hooks (per-gauge <computedt>, reference
        JDsGaugeSystem.cpp:447): the device loop breaks at the next pending
        tick inside the save interval and ``on_subtick`` runs there."""
        interval = (tout.interval if hasattr(tout, "interval")
                    else (lambda t: tout))
        t0 = time.time()
        if on_save:
            on_save(self)
        while self.time < tmax - 1e-5 * interval(self.time):
            if terminate is not None:
                newmax = terminate.poll()
                if newmax is not None:
                    tmax = min(tmax, max(newmax, self.time))
                    self.log(f"TERMINATE file: tmax -> {tmax:g}")
                    if self.time >= tmax:
                        break
            target = min(interval(self.time), tmax - self.time)
            carry = self.carry
            while True:
                stgt = target
                if next_subtick is not None:
                    nt = next_subtick(self.time + float(carry.t))
                    if nt is not None and nt - self.time < target - 1e-9:
                        stgt = min(max(nt - self.time, float(carry.t)),
                                   target)
                carry = self._advance_to(carry, stgt)
                if stgt >= target:
                    break
                self.carry = carry
                if on_subtick is not None:
                    on_subtick(self, self.time + float(carry.t))
            carry.t.block_until_ready()
            # keep the interval clock small so f32 time stays precise; the
            # sub-dt overshoot stays in carry.t for the next interval
            self.carry = replace(carry, t=carry.t - jnp.asarray(target, jnp.float32))
            self.time += target
            self.part += 1
            self.check_diagnostics()
            self._eta_print(tmax, t0)
            if on_save:
                on_save(self)
            if max_steps is not None and int(self.carry.nstep) >= max_steps:
                break
        self.walltime = time.time() - t0
        return self

    # ETA print schedule in wall-clock seconds (JTimeControl: the reference
    # prints estimates at 30,60,300,600,... s, JSphCpuSingle.cpp:1083)
    _eta_schedule = (30.0, 60.0, 300.0)
    _eta_next_idx = 0
    _eta_next = 30.0

    def _eta_print(self, tmax, t0):
        elapsed = time.time() - t0
        if elapsed < self._eta_next or self.time <= 0:
            return
        frac = min(self.time / tmax, 1.0)
        eta = elapsed / frac * (1.0 - frac)
        self.log(f"Part_{self.part:04d}  t={self.time:.6f}  "
                 f"steps={int(self.carry.nstep)}  "
                 f"{frac * 100:.1f}% done, estimated {eta:.0f}s left")
        if self._eta_next_idx + 1 < len(self._eta_schedule):
            self._eta_next_idx += 1
            self._eta_next = self._eta_schedule[self._eta_next_idx]
        else:
            self._eta_next = elapsed + self._eta_schedule[-1]
