"""Domain-decomposition tests on the 8-virtual-device CPU mesh: the sharded
step must reproduce the single-device solver (the jit-vs-sharded consistency
contract, SURVEY §4) and particles must migrate between slabs correctly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from jax.sharding import Mesh

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import (
    Simulation, make_advance, make_carry,
)
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.parallel import sharding as S
from dualsphysics_multilayer.typesdef import TpDensity

NDEV = 8


def has_devices():
    return len(jax.devices()) >= NDEV


pytestmark = pytest.mark.skipif(not has_devices(),
                                reason="needs 8 virtual devices")


def tiny_case():
    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    return case, opts


def sorted_by_id(pos, code, idp, n_real):
    """Canonicalize (id-sorted, live-only) for comparison across layouts."""
    live = np.asarray(td.is_active(jnp.asarray(code)))
    idp, pos = np.asarray(idp)[live], np.asarray(pos)[live]
    order = np.argsort(idp)
    return idp[order], pos[order]


def test_sharded_matches_single_device():
    case, opts = tiny_case()
    t_target = jnp.asarray(3e-3, jnp.float32)

    # single-device run
    import jax.numpy as jnp2
    nmax = jnp2.asarray(2 ** 30, jnp2.int32)
    adv1 = make_advance(case.csp, opts, case.dom)
    c1 = adv1(make_carry(case.state, case.csp), t_target, nmax)

    # sharded run
    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n)
    st = S.shard_state(cfg, case.state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh)
    c8 = adv8(make_carry(st, case.csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    np.testing.assert_allclose(float(c1.t), float(c8.t), rtol=1e-5)

    id1, p1 = sorted_by_id(c1.st.pos, c1.st.code, c1.st.idp, case.np_total)
    id8, p8 = sorted_by_id(c8.st.pos, c8.st.code, c8.st.idp, case.np_total)
    np.testing.assert_array_equal(id1, id8)
    # f32 reduction-order differences accumulate over steps; the trajectories
    # must agree to a tight tolerance relative to dp
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, f"sharded drift {err}"


def test_migration_moves_particles():
    """A particle pushed across a slab boundary must land on the neighbour
    shard with state intact."""
    case, opts = tiny_case()
    cfg = S.make_shard_cfg(case.dom, NDEV, max(case.state.n, 64))
    st = S.shard_state(cfg, case.state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))

    # find a live fluid particle on shard 0 and give it a position on shard 2
    code = np.asarray(st.code)
    pos = np.array(st.pos)
    live0 = np.where((np.right_shift(code, td.CODE_SPECIAL_SHIFT)
                      & td.CODE_SPECIAL_MASK) < td.SPECIAL_OUT_POS)[0]
    p = live0[0]
    slab_w = cfg.ncx_loc * cfg.gdom.scell
    target_x = cfg.gdom.posmin[0] + 1.5 * slab_w  # shard 1
    pos[p, 0] = target_x
    moved_id = int(np.asarray(st.idp)[p])
    st = jax.tree.map(lambda a: a, st)
    st = type(st)(pos=jnp.asarray(pos), vel=st.vel, rho=st.rho,
                  code=st.code, idp=st.idp, velm1=st.velm1, rhom1=st.rhom1,
                  spstau=st.spstau)

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def body(stt):
        my = jax.lax.axis_index(S.AXIS)
        out, ov = S.migrate(cfg, case.csp, stt, my)
        return out

    pst = type(st)(pos=P(S.AXIS), vel=P(S.AXIS), rho=P(S.AXIS),
                   code=P(S.AXIS), idp=P(S.AXIS), velm1=None, rhom1=None,
                   spstau=None)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(pst,), out_specs=pst,
                          ))
    out = f(st)
    idp = np.asarray(out.idp)
    code = np.asarray(out.code)
    live = (np.right_shift(code, td.CODE_SPECIAL_SHIFT)
            & td.CODE_SPECIAL_MASK) < td.SPECIAL_OUT_POS
    where = np.where(live & (idp == moved_id))[0]
    assert len(where) == 1, "migrated particle must exist exactly once"
    shard_of = int(where[0]) // cfg.n_local
    assert shard_of == 1, f"particle should be on shard 1, is on {shard_of}"
    np.testing.assert_allclose(np.asarray(out.pos)[where[0], 0], target_x,
                               rtol=1e-6)


def test_ghost_exchange_preserves_locals():
    """Ghost exchange only appends rows; owned rows are untouched."""
    case, opts = tiny_case()
    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n)
    st = S.shard_state(cfg, case.state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    def body(stt):
        my = jax.lax.axis_index(S.AXIS)
        names, ext, ov = S.exchange_ghosts(cfg, stt, my)
        d = dict(zip(names, ext))
        return d["pos"], d["code"], jax.lax.psum(ov, S.AXIS)

    pst = type(st)(pos=P(S.AXIS), vel=P(S.AXIS), rho=P(S.AXIS),
                   code=P(S.AXIS), idp=P(S.AXIS), velm1=None, rhom1=None,
                   spstau=None)
    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(pst,),
                          out_specs=(P(S.AXIS), P(S.AXIS), P()),
                          ))
    pos_ext, code_ext, ov = f(st)
    pos_ext = np.asarray(pos_ext).reshape(NDEV, cfg.n_ext, 3)
    code_ext = np.asarray(code_ext).reshape(NDEV, cfg.n_ext)
    pos_loc = np.asarray(st.pos).reshape(NDEV, cfg.n_local, 3)
    np.testing.assert_array_equal(pos_ext[:, :cfg.n_local], pos_loc)
    # ghost rows are marked periodic or dead
    gcode = code_ext[:, cfg.n_local:]
    special = (gcode >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK
    assert np.all((special == td.SPECIAL_PERIODIC)
                  | (special == td.SPECIAL_OUT_IGNORE))
    # some ghosts must actually exist (fluid near slab boundaries)
    assert np.sum(special == td.SPECIAL_PERIODIC) > 0


def _run_single(case, opts, t_target, path, feats=None, state=None):
    """Single-device advance on ``path`` (the kernel in interpret mode)."""
    from dualsphysics_multilayer.models.wcsph import make_step
    state = case.state if state is None else state
    step = make_step(case.csp, opts, case.dom, feats, path=path,
                     interpret=True)
    adv = make_advance(case.csp, opts, case.dom, feats, step=step)
    carry = make_carry(state, case.csp, opts, feats, dom=case.dom, path=path)
    return adv(carry, t_target, jnp.asarray(2 ** 30, jnp.int32))


def _run_sharded(case, opts, t_target, path, feats=None, state=None,
                 halo=1):
    state = case.state if state is None else state
    cfg = S.make_shard_cfg(case.dom, NDEV, state.n, halo=halo)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats,
                                  path=path, interpret=True)
    return adv8(make_carry(S.shard_state(cfg, state), case.csp, opts),
                t_target)


def _owned(c):
    code = np.asarray(c.st.code)
    live = np.asarray(td.is_active(jnp.asarray(code)))
    ghost = (np.right_shift(code, td.CODE_SPECIAL_SHIFT)
             & td.CODE_SPECIAL_MASK) == td.SPECIAL_PERIODIC
    sel = live & ~ghost
    idp = np.asarray(c.st.idp)[sel]
    pos = np.asarray(c.st.pos)[sel]
    o = np.argsort(idp)
    return idp[o], pos[o]


@pytest.mark.parametrize("single_path", ["cellforce", "bucket"])
def test_sharded_cellforce_matches_single_device(single_path):
    """The per-shard GPU kernel path (interpret mode on CPU) reproduces the
    single-device trajectory, on the kernel's carried sorted layout and on
    the bucket reference."""
    case, opts = tiny_case()
    t_target = jnp.asarray(2e-3, jnp.float32)
    c1 = _run_single(case, opts, t_target, single_path)
    c8 = _run_sharded(case, opts, t_target, "cellforce")
    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    id1, p1 = _owned(c1)
    id8, p8 = _owned(c8)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, f"sharded kernel drift {err}"


def test_sharded_feats_match_single_device():
    """Sharded step with shard-local features (scripted moving wall +
    damping zone): trajectories match the featured single-device solver
    (the feature hooks run at the same attachment points)."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features.featureset import Features
    from dualsphysics_multilayer.features.motion import (
        RECT, MotionDef, Segment)
    from dualsphysics_multilayer.features.damping import DampingPlane

    case, opts = tiny_case()
    # retype the right end wall into a moving mk=9 block pushing inward
    code = np.asarray(case.state.code).copy()
    pos = np.asarray(case.state.pos)
    isb = np.asarray(td.code_type(jnp.asarray(code))) < td.TYPE_FLUID
    strip = isb & (pos[:, 0] > 0.82)
    assert strip.any()
    code[strip] = td.code_make(td.TYPE_MOVING, 9)
    state = dcreplace(case.state, code=jnp.asarray(code))
    feats = Features(
        motions=(MotionDef(mk=9, segments=(
            Segment(kind=RECT, t0=0.0, t1=10.0, params=(-0.05, 0, 0)),)),),
        damping=(DampingPlane(point=(0.55, 0.15, 0.15),
                              limitpoint=(0.8, 0.15, 0.15)),))
    t_target = jnp.asarray(3e-3, jnp.float32)

    nmax = jnp.asarray(2 ** 30, jnp.int32)
    adv1 = make_advance(case.csp, opts, case.dom, feats)
    c1 = adv1(make_carry(state, case.csp, opts, feats), t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, state.n)
    st = S.shard_state(cfg, state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(st, case.csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)

    id1, p1 = sorted_by_id(c1.st.pos, c1.st.code, c1.st.idp, case.np_total)
    id8, p8 = sorted_by_id(c8.st.pos, c8.st.code, c8.st.idp, case.np_total)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, f"sharded feats drift {err}"
    # the moving wall actually moved (displacement = v*t, not zero)
    live1 = np.asarray(td.is_active(c1.st.code))
    mv = np.asarray(td.code_type(c1.st.code)) == td.TYPE_MOVING
    moved = np.asarray(c1.st.pos)[live1 & mv, 0].max()
    assert moved < pos[strip, 0].max() - 0.5 * 0.05 * float(c1.t)


def test_sharded_feats_reject_unsupported():
    """x-periodicity conflicts with the x-slab decomposition and raises
    loudly (y/z periodicity is supported)."""
    from dualsphysics_multilayer.features import periodic as PER
    from dualsphysics_multilayer.features.featureset import Features
    case, opts = tiny_case()
    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n)
    xper = PER.PeriodicCfg(axes=(True, False, False), lo=(0.0, 0, 0),
                           hi=(0.9, 0, 0), ghost_cap=64)
    with pytest.raises(NotImplementedError, match="x-periodic"):
        S.make_sharded_step(cfg, case.csp, opts, Features(periodic=xper))
    yper = PER.PeriodicCfg(axes=(False, True, False), lo=(0, 0.0, 0),
                           hi=(0, 0.3, 0), ghost_cap=64)
    S.make_sharded_step(cfg, case.csp, opts, Features(periodic=yper))


def test_sharded_floating_matches_single_device():
    """Floating rigid body under domain decomposition: per-shard force/
    torque partial sums psum over the mesh, the replicated 6-DOF solve and
    particle update match the single-device solver."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features import floating as FT
    from dualsphysics_multilayer.features.featureset import Features

    case, opts = tiny_case()
    # carve a floating box out of the fluid column (spans slab boundaries
    # once it moves): fluid particles in a small box -> body 0
    pos = np.asarray(case.state.pos)
    code = np.asarray(case.state.code).copy()
    isfl = np.asarray(td.code_type(case.state.code)) == td.TYPE_FLUID
    sel = isfl & (np.abs(pos[:, 0] - 0.15) < 0.08) \
        & (np.abs(pos[:, 1] - 0.15) < 0.08) & (pos[:, 2] > 0.05) \
        & (pos[:, 2] < 0.17)
    assert sel.sum() >= 8, sel.sum()
    code[sel] = td.code_make(td.TYPE_FLOATING, 0)
    ftcfg, ftstate = FT.make_floating([pos[sel]], [500.0], case.csp)
    state = dcreplace(case.state, code=jnp.asarray(code), ft=ftstate)
    feats = Features(floating=ftcfg)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
    t_target = jnp.asarray(3e-3, jnp.float32)

    nmax = jnp.asarray(2 ** 30, jnp.int32)
    adv1 = make_advance(case.csp, opts, case.dom, feats)
    c1 = adv1(make_carry(state, case.csp, opts, feats), t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, state.n)
    st = S.shard_state(cfg, state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(st, case.csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    # body state must match (it is replicated over the mesh)
    np.testing.assert_allclose(np.asarray(c8.st.ft.center),
                               np.asarray(c1.st.ft.center), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c8.st.ft.fvel),
                               np.asarray(c1.st.ft.fvel), atol=1e-5)
    id1, p1 = sorted_by_id(c1.st.pos, c1.st.code, c1.st.idp, case.np_total)
    id8, p8 = sorted_by_id(c8.st.pos, c8.st.code, c8.st.idp, case.np_total)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, f"sharded floating drift {err}"
    # the body actually felt the collapse (nonzero velocity by t_target)
    assert np.abs(np.asarray(c1.st.ft.fvel)).max() > 1e-5


def test_sharded_cellforce_floating_matches_single_device():
    """Floating body through the per-shard kernel path: the psum'd rigid
    solve + ghost-excluded sums track the single-device kernel run on its
    carried layout."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features import floating as FT
    from dualsphysics_multilayer.features.featureset import Features

    case, _ = tiny_case()
    pos = np.asarray(case.state.pos)
    code = np.asarray(case.state.code).copy()
    isfl = np.asarray(td.code_type(case.state.code)) == td.TYPE_FLUID
    sel = isfl & (np.abs(pos[:, 0] - 0.15) < 0.08) \
        & (np.abs(pos[:, 1] - 0.15) < 0.08) & (pos[:, 2] > 0.05) \
        & (pos[:, 2] < 0.17)
    assert sel.sum() >= 8
    code[sel] = td.code_make(td.TYPE_FLOATING, 0)
    ftcfg, ftstate = FT.make_floating([pos[sel]], [500.0], case.csp)
    state = dcreplace(case.state, code=jnp.asarray(code), ft=ftstate)
    feats = Features(floating=ftcfg)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
    t_target = jnp.asarray(3e-3, jnp.float32)

    c1 = _run_single(case, opts, t_target, "cellforce", feats, state)
    c8 = _run_sharded(case, opts, t_target, "cellforce", feats, state)
    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    np.testing.assert_allclose(np.asarray(c8.st.ft.center),
                               np.asarray(c1.st.ft.center), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c8.st.ft.fvel),
                               np.asarray(c1.st.ft.fvel), atol=1e-5)


def test_sharded_moored_floating_matches_single_device():
    """Floating body + dynamic mooring line under domain decomposition:
    the replicated line state (StepCarry.moor) integrates identically on
    every shard and the moored trajectory matches single-device."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features import floating as FT
    from dualsphysics_multilayer.features.featureset import Features
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)

    case, _ = tiny_case()
    pos = np.asarray(case.state.pos)
    code = np.asarray(case.state.code).copy()
    isfl = np.asarray(td.code_type(case.state.code)) == td.TYPE_FLUID
    sel = isfl & (np.abs(pos[:, 0] - 0.15) < 0.08) \
        & (np.abs(pos[:, 1] - 0.15) < 0.08) & (pos[:, 2] > 0.05) \
        & (pos[:, 2] < 0.17)
    assert sel.sum() >= 8
    code[sel] = td.code_make(td.TYPE_FLOATING, 0)
    ftcfg, ftstate = FT.make_floating([pos[sel]], [500.0], case.csp)
    c0 = np.asarray(ftstate.center)[0]
    moor = MoorDynCfg(lines=(MoorDynLine(
        body=0, anchor=(float(c0[0]), float(c0[1]), 0.0),
        fairlead=(0.0, 0.0, 0.0), length0=float(c0[2]) * 0.98,
        ea=2e3, nseg=6, diameter=0.003, massden=0.05),), nbodies=1,
        t_ic=0.05, nsub=10)
    state = dcreplace(case.state, code=jnp.asarray(code), ft=ftstate)
    feats = Features(floating=ftcfg, moorings=moor)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
    t_target = jnp.asarray(2e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(case.csp, opts, case.dom, feats)
    c1 = adv1(make_carry(state, case.csp, opts, feats), t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, state.n)
    st = S.shard_state(cfg, state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(st, case.csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    np.testing.assert_allclose(np.asarray(c8.st.ft.center),
                               np.asarray(c1.st.ft.center), atol=1e-6)
    # the mooring node state advanced identically (replicated)
    assert c8.moor is not None
    np.testing.assert_allclose(np.asarray(c8.moor.pos),
                               np.asarray(c1.moor.pos), atol=1e-5)


def test_sharded_nn_matches_single_device():
    """NN multiphase pipeline under domain decomposition (2-cell halo so
    ghost effective viscosity has full support): trajectories match the
    single-device NN solver."""
    from dualsphysics_multilayer.models import nnewtonian as NNM
    from dualsphysics_multilayer.typesdef import TpVisco

    case, phases = NNM.wet_dambreak_nn(dp=0.04)
    opts = SolverOpts(tvisco=TpVisco.LAMINAR_SPS,
                      tdensity=TpDensity.FOURTAKAS)
    t_target = jnp.asarray(2e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    step1 = NNM.make_nn_step(case.csp, opts, case.dom, phases)
    adv1 = make_advance(case.csp, opts, case.dom, step=step1)
    c1 = adv1(make_carry(case.state, case.csp), t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n, halo=2)
    st = S.shard_state(cfg, case.state)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, phases=phases)
    c8 = adv8(make_carry(st, case.csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    id1, p1 = sorted_by_id(c1.st.pos, c1.st.code, c1.st.idp, case.np_total)
    id8, p8 = sorted_by_id(c8.st.pos, c8.st.code, c8.st.idp, case.np_total)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, f"sharded NN drift {err}"


def test_sharded_yperiodic_matches_single_device():
    """y-periodic channel sharded along x: per-shard wrap + tail ghost
    regeneration (migration never touches the reserved tail) matches the
    single-device periodic run."""
    from dualsphysics_multilayer.features import periodic as PER
    from dualsphysics_multilayer.features.featureset import Features
    from dualsphysics_multilayer.models import cases as C
    from dualsphysics_multilayer.typesdef import make_ctesph

    dp = 0.05
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=0.2, coefh=1.0,
                      visco=0.05, coefsound=20.0)
    d = C.Draw(dp=dp, simulate2d=False)
    # water slab over a floor, open in y (periodic), walls in x
    d.box((0, 0, 0), (0.9 - dp, 0.4 - dp, 0.2), ptype=td.TYPE_FLUID, mk=0)
    d.box((-3 * dp, 0, -3 * dp), (0.9 + 2 * dp, 0.4 - dp, -dp),
          ptype=td.TYPE_FIXED, mk=0, faces="solid")
    d.box((-3 * dp, 0, 0), (-dp, 0.4 - dp, 0.4),
          ptype=td.TYPE_FIXED, mk=0, faces="solid")
    d.box((0.9, 0, 0), (0.9 + 2 * dp, 0.4 - dp, 0.4),
          ptype=td.TYPE_FIXED, mk=0, faces="solid")
    pos, code = d.build()
    pcfg = PER.PeriodicCfg(axes=(False, True, False), lo=(0, 0.0, 0),
                           hi=(0, 0.4, 0), ghost_cap=1024)
    cap = pos.shape[0] + PER.ghost_slots_required(pcfg)
    dom = C._make_domain(csp, pos, headroom=2.0)
    st0 = C._make_state(csp, pos, code, zsurf=0.2, capacity=cap)
    feats = Features(periodic=pcfg)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    t_target = jnp.asarray(2e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(csp, opts, dom, feats)
    c1 = adv1(make_carry(st0, csp, opts, feats), t_target, nmax)

    from dualsphysics_multilayer.parallel.sharding import ShardedSimulation
    cfg = S.make_shard_cfg(dom, NDEV, st0.n,
                           reserve_tail=PER.ghost_slots_required(pcfg))
    st = S.shard_state(cfg, st0)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(st, csp), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)

    def owned(c):
        code = np.asarray(c.st.code)
        live = np.asarray(td.is_active(jnp.asarray(code)))
        ghost = ((code >> td.CODE_SPECIAL_SHIFT)
                 & td.CODE_SPECIAL_MASK) == td.SPECIAL_PERIODIC
        sel = live & ~ghost
        idp = np.asarray(c.st.idp)[sel]
        pos = np.asarray(c.st.pos)[sel]
        o = np.argsort(idp)
        return idp[o], pos[o]

    id1, p1 = owned(c1)
    id8, p8 = owned(c8)
    assert len(id1) == len(id8)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * csp.dp, f"sharded periodic drift {err}"


def test_sharded_mdbc_matches_single_device():
    """mDBC under domain decomposition (BASELINE config 3 capability):
    the ghost-node correction runs on halo-extended supports (halo=2), the
    corrected bound vel/rho propagate to neighbour ghosts through the second
    refresh, and the trajectory matches the single-device mDBC run."""
    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False,
                            mdbc=True)
    from dualsphysics_multilayer.typesdef import TpBoundary, TpSlipMode
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                      tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    t_target = jnp.asarray(3e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(case.csp, opts, case.dom)
    c1 = adv1(make_carry(case.state, case.csp, opts, dom=case.dom),
              t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n, halo=2)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh)
    c8 = adv8(make_carry(S.shard_state(cfg, case.state), case.csp, opts),
              t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)

    def owned(c):
        code = np.asarray(c.st.code)
        live = np.asarray(td.is_active(jnp.asarray(code)))
        ghost = (np.right_shift(code, td.CODE_SPECIAL_SHIFT)
                 & td.CODE_SPECIAL_MASK) == td.SPECIAL_PERIODIC
        sel = live & ~ghost
        idp = np.asarray(c.st.idp)[sel]
        pos = np.asarray(c.st.pos)[sel]
        o = np.argsort(idp)
        return idp[o], pos[o]

    id1, p1 = owned(c1)
    id8, p8 = owned(c8)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, err


def test_sharded_mdbc_floating_matches_single_device():
    """Floating box + mDBC walls sharded (the full BASELINE config 3
    combination): body trajectory tracks the single-device run."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features import floating as FT
    from dualsphysics_multilayer.features.featureset import Features
    from dualsphysics_multilayer.typesdef import TpBoundary, TpSlipMode

    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False,
                            mdbc=True)
    pos = np.asarray(case.state.pos)
    code = np.asarray(case.state.code).copy()
    isfl = np.asarray(td.code_type(case.state.code)) == td.TYPE_FLUID
    sel = isfl & (np.abs(pos[:, 0] - 0.15) < 0.08) \
        & (np.abs(pos[:, 1] - 0.15) < 0.08) & (pos[:, 2] > 0.05) \
        & (pos[:, 2] < 0.17)
    assert sel.sum() >= 8
    code[sel] = td.code_make(td.TYPE_FLOATING, 0)
    ftcfg, ftstate = FT.make_floating([pos[sel]], [500.0], case.csp)
    state = dcreplace(case.state, code=jnp.asarray(code), ft=ftstate)
    feats = Features(floating=ftcfg)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True,
                      tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    t_target = jnp.asarray(3e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(case.csp, opts, case.dom, feats)
    c1 = adv1(make_carry(state, case.csp, opts, feats, dom=case.dom),
              t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, state.n, halo=2)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(S.shard_state(cfg, state), case.csp, opts),
              t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    np.testing.assert_allclose(np.asarray(c8.st.ft.center),
                               np.asarray(c1.st.ft.center), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c8.st.ft.fvel),
                               np.asarray(c1.st.ft.fvel), atol=1e-5)


def test_sharded_verlet_matches_single_device():
    """Verlet integrator under domain decomposition (the sharded step
    dispatches by opts.tstep): trajectories track the single-device Verlet
    run."""
    from dualsphysics_multilayer.typesdef import TpStep
    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False,
                            need_verlet=True)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                      tstep=TpStep.VERLET, verlet_steps=10)
    t_target = jnp.asarray(3e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(case.csp, opts, case.dom)
    c1 = adv1(make_carry(case.state, case.csp, opts, dom=case.dom),
              t_target, nmax)

    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh)
    c8 = adv8(make_carry(S.shard_state(cfg, case.state), case.csp, opts),
              t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)

    def owned(c):
        code = np.asarray(c.st.code)
        live = np.asarray(td.is_active(jnp.asarray(code)))
        ghost = (np.right_shift(code, td.CODE_SPECIAL_SHIFT)
                 & td.CODE_SPECIAL_MASK) == td.SPECIAL_PERIODIC
        sel = live & ~ghost
        idp = np.asarray(c.st.idp)[sel]
        pos = np.asarray(c.st.pos)[sel]
        o = np.argsort(idp)
        return idp[o], pos[o]

    id1, p1 = owned(c1)
    id8, p8 = owned(c8)
    np.testing.assert_array_equal(id1, id8)
    err = np.abs(p1 - p8).max()
    assert err < 1e-4 * case.csp.dp, err


def test_sharded_dem_matches_single_device():
    """DEM contact under domain decomposition: property tables keyed by
    particle id + halo-extended candidates reproduce the single-device
    dropped-box trajectory."""
    from dataclasses import replace as dcreplace
    from dualsphysics_multilayer.features.featureset import Features
    from test_dem import _dry_tank_with_boxes

    dp = 0.025
    csp, dom, st, ftcfg, demcfg = _dry_tank_with_boxes(
        dp, [((0.4, 0.15), (0.6, 0.35))], [800.0])
    st = dcreplace(st, ft=dcreplace(
        st.ft, fvel=jnp.asarray([[0.0, 0.0, -2.0]], jnp.float32)))
    vel = np.array(st.vel)
    vel[np.asarray(td.is_floating(st.code))] = (0.0, 0.0, -2.0)
    st = dcreplace(st, vel=jnp.asarray(vel))
    feats = Features(floating=ftcfg, dem=demcfg)
    opts = SolverOpts(tdensity=TpDensity.NONE, with_floating=True)
    t_target = jnp.asarray(5e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(csp, opts, dom, feats)
    c1 = adv1(make_carry(st, csp, opts, feats, dom=dom), t_target, nmax)

    cfg = S.make_shard_cfg(dom, NDEV, st.n)
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    st8 = S.shard_state(cfg, st)
    adv8 = S.make_sharded_advance(cfg, csp, opts, mesh, feats=feats)
    c8 = adv8(make_carry(st8, csp, opts), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)
    np.testing.assert_allclose(np.asarray(c8.st.ft.center),
                               np.asarray(c1.st.ft.center), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c8.st.ft.fvel),
                               np.asarray(c1.st.ft.fvel), atol=1e-5)


def test_sharded_inout_matches_single_device():
    """Inlet/outlet channel under domain decomposition: zone transitions are
    slot-local, spawns migrate to their owner, and the live population +
    fluid center of mass track the single-device run."""
    from dualsphysics_multilayer.features.featureset import Features

    case = cases.channel2d(dp=0.02, length=0.5, height=0.16, vel=0.4)
    iocfg = case.meta["inout"]
    opts = SolverOpts(tdensity=TpDensity.MOLTENI)
    feats = Features(inout=iocfg)
    t_target = jnp.asarray(5e-3, jnp.float32)
    nmax = jnp.asarray(2 ** 30, jnp.int32)

    adv1 = make_advance(case.csp, opts, case.dom, feats)
    c1 = adv1(make_carry(case.state, case.csp, opts, feats, dom=case.dom),
              t_target, nmax)

    import dataclasses as _dc
    feats8 = _dc.replace(feats, inout=_dc.replace(iocfg, n_usable=0))
    cfg = S.make_shard_cfg(case.dom, NDEV, case.state.n,
                           halo=max(1, int(np.ceil(
                               max(z.layers * case.csp.dp
                                   for z in iocfg.zones)
                               / case.dom.scell))))
    mesh = Mesh(np.array(jax.devices()[:NDEV]), (S.AXIS,))
    st8 = S.shard_state(cfg, case.state)
    adv8 = S.make_sharded_advance(cfg, case.csp, opts, mesh, feats=feats8)
    c8 = adv8(make_carry(st8, case.csp, opts), t_target)

    assert int(c8.overflow) == 0
    assert int(c1.nstep) == int(c8.nstep)

    def stats(c):
        code = np.asarray(c.st.code)
        sp = (code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK
        live = (sp < td.SPECIAL_OUT_POS) & (sp != td.SPECIAL_PERIODIC)
        fl = live & (((code >> td.CODE_TYPE_SHIFT) & td.CODE_TYPE_MASK)
                     == td.TYPE_FLUID)
        pos = np.asarray(c.st.pos)[fl]
        return int(fl.sum()), pos.mean(axis=0)

    n1, com1 = stats(c1)
    n8, com8 = stats(c8)
    assert abs(n1 - n8) <= 2, (n1, n8)
    np.testing.assert_allclose(com8, com1, atol=2e-3 * case.csp.dp)
