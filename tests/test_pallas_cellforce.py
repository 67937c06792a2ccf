"""GPU force kernel (ops/pallas/cellforce.py) against the O(N^2) oracle and
the bucket path, in Pallas interpret mode on the CPU; the sorted layout
(celldiv.divide_sorted) it walks; the interaction-path selection; and the
skin-amortized rebuild of the carried sorted layout.  The compiled kernel
is checked on the card by the ``gpu``-marked test at the end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import (
    _carries_layout, make_carry, make_step, select_path)
from dualsphysics_multilayer.ops import celldiv as cd
from dualsphysics_multilayer.ops import eos
from dualsphysics_multilayer.ops import forces as F
from dualsphysics_multilayer.ops.pallas import cellforce as CF
from dualsphysics_multilayer.typesdef import (
    TpBoundary, TpDensity, TpKernel, TpShifting, TpStep, TpVisco, make_ctesph)

from ref_naive import naive_forces
from test_forces import make_cloud, assert_close


def run_kernel(csp, opts, pos, vel, rho, code, spstau=None, block=8,
               state_sorted=False):
    """Sorted divide + kernel (interpret mode); canonical-order Forces."""
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, csp.kernelsize,
                         simulate2d=csp.simulate2d, cellcap=64)
    p = jnp.asarray(pos, jnp.float32)
    v = jnp.asarray(vel, jnp.float32)
    r = jnp.asarray(rho, jnp.float32)
    tau = None if spstau is None else jnp.asarray(spstau, jnp.float32)
    sd, code2 = cd.divide_sorted(dom, p, jnp.asarray(code), block=block)
    assert int(sd.overflow) == 0
    if not state_sorted:
        return CF.interaction_forces(csp, opts, sd, p, v, r, code2,
                                     spstau=tau, state_sorted=False,
                                     interpret=True)
    o = np.asarray(sd.order)
    fr = CF.interaction_forces(csp, opts, sd, p[o], v[o], r[o], code2[o],
                               spstau=None if tau is None else tau[o],
                               state_sorted=True, interpret=True)
    inv = np.argsort(o)
    return dataclasses.replace(
        fr, ace=np.asarray(fr.ace)[inv], ar=np.asarray(fr.ar)[inv],
        shiftposfs=(None if fr.shiftposfs is None
                    else np.asarray(fr.shiftposfs)[inv]),
        shift_blocked=(None if fr.shift_blocked is None
                       else np.asarray(fr.shift_blocked)[inv]),
        spsgradvel=(None if fr.spsgradvel is None
                    else np.asarray(fr.spsgradvel)[inv]))


def oracle(csp, opts, pos, vel, rho, code, spstau=None):
    press = np.asarray(eos.press_from_rho(csp, jnp.asarray(rho))).astype(
        np.float64)
    return naive_forces(csp, opts, pos, vel, rho, press, code, spstau=spstau)


def assert_shift_close(want, got):
    scale = np.abs(want["shiftposfs"]).max() + 1e-6
    np.testing.assert_allclose(np.asarray(got.shiftposfs),
                               want["shiftposfs"],
                               atol=2e-3 * scale, rtol=2e-3)
    np.testing.assert_array_equal(np.asarray(got.shift_blocked),
                                  want["shift_blocked"])


# ---------------------------------------------------------------------------
# kernel vs the O(N^2) oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", [TpDensity.NONE, TpDensity.MOLTENI,
                                      TpDensity.FOURTAKAS,
                                      TpDensity.FOURTAKAS_FULL])
def test_cellforce_matches_oracle(sim2d, tdensity):
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=tdensity)
    assert CF.supports(csp, opts)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=12)
    assert_close(oracle(csp, opts, pos, vel, rho, code),
                 run_kernel(csp, opts, pos, vel, rho, code))


def test_cellforce_viscoboundfactor():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05,
                      viscoboundfactor=0.3)
    opts = F.SolverOpts(tdensity=TpDensity.NONE)
    pos, vel, rho, code, nb = make_cloud(seed=13)
    assert_close(oracle(csp, opts, pos, vel, rho, code),
                 run_kernel(csp, opts, pos, vel, rho, code))


def test_cellforce_cubic_kernel():
    """Cubic spline with its tensile correction."""
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05,
                      tkernel=TpKernel.CUBIC)
    opts = F.SolverOpts(tdensity=TpDensity.MOLTENI)
    pos, vel, rho, code, nb = make_cloud(seed=14)
    assert_close(oracle(csp, opts, pos, vel, rho, code),
                 run_kernel(csp, opts, pos, vel, rho, code))


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("mode", [1, 2, 3])  # NO_BOUND, NO_FIXED, FULL
def test_cellforce_shifting_matches_oracle(mode, sim2d):
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        shiftmode=TpShifting(mode))
    assert CF.supports(csp, opts)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=21)
    want = oracle(csp, opts, pos, vel, rho, code)
    got = run_kernel(csp, opts, pos, vel, rho, code)
    assert_close(want, got)
    assert_shift_close(want, got)


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", [TpDensity.MOLTENI, TpDensity.FOURTAKAS])
def test_cellforce_floating_matches_oracle(tdensity, sim2d):
    """Floating particles: fluid-side momentum, DDT exclusion/blocking."""
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=tdensity, with_floating=True)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=22)
    code = np.array(code)
    # a slab of fluid becomes a floating body (fluid mass, so the
    # ftomassp-free oracle matches)
    code[nb:nb + 20] = td.code_make(td.TYPE_FLOATING, 0)
    assert_close(oracle(csp, opts, pos, vel, rho, code),
                 run_kernel(csp, opts, pos, vel, rho, code))


@pytest.mark.parametrize("sim2d", [False, True])
def test_cellforce_laminar_sps_matches_oracle(sim2d):
    """Laminar operator + SPS stress divergence + gradvel accumulation
    (JSphCpu.cpp:765-791)."""
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=1e-4)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        tvisco=TpVisco.LAMINAR_SPS)
    assert CF.supports(csp, opts)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=7)
    rng = np.random.default_rng(5)
    spstau = (rng.normal(size=(len(pos), 6)) * 1e-3).astype(np.float32)
    spstau[np.asarray(td.code_type(code)) != td.TYPE_FLUID] = 0.0
    want = oracle(csp, opts, pos, vel, rho, code, spstau=spstau)
    got = run_kernel(csp, opts, pos, vel, rho, code, spstau=spstau)
    assert_close(want, got)
    scale = np.abs(want["gradvel"]).max() + 1e-12
    np.testing.assert_allclose(np.asarray(got.spsgradvel), want["gradvel"],
                               atol=2e-4 * scale)


# ---------------------------------------------------------------------------
# block edges, padding, dead rows: tile shapes that cut blocks and candidate
# ranges at every offset must not change the result
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,chunk", [
    (1, 8),       # one target per block
    (8, 8),       # ranges cut into many short chunks
    (32, 16),     # the GPU configuration
    (16, 64),     # chunks wider than most ranges
])
def test_cellforce_tile_shapes(block, chunk, monkeypatch):
    monkeypatch.setattr(CF, "tile_config",
                        lambda csp, opts: (block, chunk, 4, 2))
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        shiftmode=TpShifting.FULL)
    pos, vel, rho, code, nb = make_cloud(seed=23)
    want = oracle(csp, opts, pos, vel, rho, code)
    got = run_kernel(csp, opts, pos, vel, rho, code, block=block)
    assert_close(want, got)
    assert_shift_close(want, got)


def test_cellforce_sorted_state_matches_gathered():
    """The carried-layout call (state already sorted) and the gather/scatter
    call give the same canonical forces."""
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    pos, vel, rho, code, nb = make_cloud(seed=24)
    a = run_kernel(csp, opts, pos, vel, rho, code)
    b = run_kernel(csp, opts, pos, vel, rho, code, state_sorted=True)
    np.testing.assert_allclose(np.asarray(a.ace), np.asarray(b.ace),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.ar), np.asarray(b.ar),
                               rtol=1e-6, atol=1e-3)
    assert float(a.viscdtmax) == float(b.viscdtmax)


@pytest.mark.parametrize("sim2d", [False, True])
def test_cellforce_dead_rows(sim2d):
    """Particles outside the map and particles excluded after the divide
    (stale rows of a carried layout) contribute nothing, and their own
    outputs are zero; live particles see the forces of the live set."""
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d, seed=25)
    n = len(pos)
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                         csp.kernelsize, simulate2d=sim2d, cellcap=64)
    pos = pos.copy()
    pos[-3:, 0] = 50.0                            # outside the map
    p = jnp.asarray(pos, jnp.float32)
    sd, code2 = cd.divide_sorted(dom, p, jnp.asarray(code), block=8)
    assert int(sd.nlive) == n - 3
    kill = np.zeros(n, bool)
    kill[nb:nb + 11] = True                       # excluded after the divide
    code3 = jnp.where(jnp.asarray(kill),
                      td.code_set_special(code2, td.SPECIAL_OUT_POS), code2)
    got = CF.interaction_forces(csp, opts, sd, p, jnp.asarray(vel, jnp.float32),
                                jnp.asarray(rho, jnp.float32), code3,
                                state_sorted=False, interpret=True)
    live = np.asarray(td.is_active(code3))
    assert live.sum() == n - 14
    want = oracle(csp, opts, pos[live], vel[live], rho[live], code[live])
    np.testing.assert_allclose(np.asarray(got.ace)[live], want["ace"],
                               atol=2e-3 * np.abs(want["ace"]).max(),
                               rtol=2e-3)
    np.testing.assert_allclose(np.asarray(got.ar)[live], want["ar"],
                               atol=2e-3 * np.abs(want["ar"]).max(),
                               rtol=2e-3)
    assert np.all(np.asarray(got.ace)[~live] == 0.0)
    assert np.all(np.asarray(got.ar)[~live] == 0.0)


# ---------------------------------------------------------------------------
# the sorted layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which,block", [("2d", 32), ("3d", 32), ("3d", 5)])
def test_divide_sorted_structure(which, block):
    case = (cases.dambreak2d(dp=0.04) if which == "2d"
            else cases.dambreak3d(dp=0.06))
    dom, st = case.dom, case.state
    sd, _ = cd.divide_sorted(dom, st.pos, st.code, block=block)
    order = np.asarray(sd.order)
    nlive = int(sd.nlive)
    assert nlive == int(np.asarray(td.is_active(st.code)).sum())
    assert sorted(order.tolist()) == list(range(st.n))
    blk = np.asarray(sd.blk)
    R = (blk.shape[1] - 2) // 2
    assert R == (3 if dom.simulate2d else 9)
    assert blk.shape[0] == cd.block_capacity(dom, st.n, block)
    start, count = blk[:, 0], blk[:, 1]
    used = count > 0
    assert (count <= block).all()
    # blocks partition the live sorted rows, each inside one (y,z) row
    rows = np.zeros(st.n, int)
    for s, c in zip(start[used], count[used]):
        rows[s:s + c] += 1
    assert (rows[:nlive] == 1).all() and (rows[nlive:] == 0).all()
    spos = np.asarray(st.pos)[order]
    cxyz = np.floor((spos - np.asarray(dom.posmin)) / dom.scell).astype(int)
    rid = cxyz[:, 2] * dom.nc[1] + cxyz[:, 1]
    for s, c in zip(start[used], count[used]):
        assert len(set(rid[s:s + c])) == 1
    # every live neighbour within kernelsize lies in one of the block's ranges
    ks = case.csp.kernelsize
    rng = np.random.default_rng(0)
    bsel = rng.choice(np.where(used)[0], size=min(40, used.sum()),
                      replace=False)
    for b in bsel:
        ws, we = blk[b, 2:2 + R], blk[b, 2 + R:]
        for t in range(start[b], start[b] + count[b]):
            d = np.linalg.norm(spos[:nlive] - spos[t], axis=1)
            nb_ = np.where(d <= ks)[0]
            inr = np.zeros(len(nb_), bool)
            for r in range(R):
                inr |= (nb_ >= ws[r]) & (nb_ < we[r])
            assert inr.all(), f"block {b}: neighbours outside its ranges"


def test_block_capacity_bound_sparse_rows():
    """One particle per occupied row (the sparse free-surface worst case)
    still fits the static block table."""
    dom = cd.make_domain((0, 0, 0), (1.0, 1.0, 1.0), 0.1)
    g = (np.arange(10) + 0.5) * 0.1
    y, z = np.meshgrid(g, g, indexing="ij")
    pos = np.stack([np.full(y.size, 0.05), y.ravel(), z.ravel()], axis=1)
    code = np.full(len(pos), td.code_make(td.TYPE_FLUID, 0), np.uint32)
    sd, _ = cd.divide_sorted(dom, jnp.asarray(pos, jnp.float32),
                             jnp.asarray(code), block=32)
    count = np.asarray(sd.blk)[:, 1]
    assert (count > 0).sum() == 100 and count.sum() == 100


def test_divide_sorted_shard_origin():
    """A traced grid origin (the sharded slab grids) shifts the cell ids: the
    divide over shifted positions and shifted origin is the same divide."""
    case = cases.dambreak3d(dp=0.06)
    dom, st = case.dom, case.state
    shift = jnp.asarray([0.37, -0.21, 0.05], jnp.float32)
    a, ca = cd.divide_sorted(dom, st.pos, st.code, block=16)
    b, cb = cd.divide_sorted(dom, st.pos + shift, st.code, block=16,
                             origin=jnp.asarray(dom.posmin, jnp.float32)
                             + shift)
    np.testing.assert_array_equal(np.asarray(a.blk), np.asarray(b.blk))
    np.testing.assert_array_equal(np.asarray(a.order), np.asarray(b.order))
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))


# ---------------------------------------------------------------------------
# interaction-path selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform,kw,want", [
    ("cpu", {}, "bucket"),
    ("gpu", {}, "cellforce"),
    ("gpu", {"tvisco": TpVisco.LAMINAR_SPS,
             "tboundary": TpBoundary.MDBC}, "cellforce"),
    ("gpu", {"symmetry": True}, "bucket"),
    ("gpu", {"tvisco": TpVisco.CONST_EQ}, "bucket"),
    ("gpu", {"use_nbrlist": True}, "nbrlist"),
])
def test_select_path(platform, kw, want):
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    assert select_path(csp, F.SolverOpts(**kw), platform=platform) == want


def test_select_path_default_platform_is_cpu_here():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    assert jax.devices()[0].platform == "cpu"
    assert select_path(csp, F.SolverOpts()) == "bucket"


def test_carried_layout_only_without_population_features():
    from dualsphysics_multilayer.features.featureset import Features
    dom = cd.make_domain((0, 0, 0), (1, 1, 1), 0.1)
    assert _carries_layout("cellforce", dom, None)
    assert not _carries_layout("bucket", dom, None)
    assert not _carries_layout("cellforce", None, None)
    assert not _carries_layout("cellforce", dom, Features(inout=object()))
    assert not _carries_layout("cellforce", dom, Features(dem=object()))


# ---------------------------------------------------------------------------
# the skin-amortized rebuild of the carried sorted layout: trajectories on
# the kernel path must match the per-step bucket path
# ---------------------------------------------------------------------------

def _run_steps(case, opts, nsteps, path, dom=None):
    dom = dom or case.dom
    step = jax.jit(make_step(case.csp, opts, dom, path=path, interpret=True))
    carry = make_carry(case.state, case.csp, opts, dom=dom, path=path)
    for _ in range(nsteps):
        carry = step(carry)
    return carry


def _by_idp(carry):
    act = np.asarray(td.is_active(carry.st.code))
    idp = np.asarray(carry.st.idp)
    order = np.argsort(np.where(act, idp, 2 ** 31), kind="stable")
    nl = int(act.sum())
    return np.asarray(carry.st.pos)[order[:nl]], nl


def test_sorted_layout_matches_bucket_path():
    case = cases.dambreak2d(dp=0.04)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    c_k = _run_steps(case, opts, 20, "cellforce")
    assert c_k.sdiv is not None
    assert int(c_k.overflow) == 0
    assert int(c_k.nrebuild) < 20          # the skin amortizes rebuilds
    c_b = _run_steps(case, opts, 20, "bucket")
    assert c_b.sdiv is None
    p1, n1 = _by_idp(c_k)
    p2, n2 = _by_idp(c_b)
    assert n1 == n2
    assert abs(float(c_k.t) - float(c_b.t)) < 1e-7
    np.testing.assert_allclose(p1, p2, atol=5e-6)


def test_sorted_layout_forced_rebuilds():
    """Zero-margin domain: the trigger fires every step; trajectories must
    still match and nrebuild counts the rebuilds."""
    case = cases.dambreak2d(dp=0.04)
    dom0 = dataclasses.replace(case.dom, scell=case.csp.kernelsize * 1.0005)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    c0 = _run_steps(case, opts, 12, "cellforce", dom=dom0)
    assert int(c0.nrebuild) >= 10
    c_b = _run_steps(case, opts, 12, "bucket")
    p1, n1 = _by_idp(c0)
    p2, n2 = _by_idp(c_b)
    assert n1 == n2
    np.testing.assert_allclose(p1, p2, atol=5e-6)


def test_sorted_layout_mdbc_matches_bucket_path():
    """mDBC on the carried layout: the ghost-node prepass runs on the
    amortized bucket divide (carry.bdiv)."""
    case = cases.dambreak3d(dp=0.06, tank=(0.9, 0.3, 0.3),
                            column=(0.3, 0.3, 0.2), obstacle=False, mdbc=True)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        tboundary=TpBoundary.MDBC,
                        slipmode=td.TpSlipMode.VEL0)
    c_k = _run_steps(case, opts, 8, "cellforce")
    assert c_k.bdiv is not None
    c_b = _run_steps(case, opts, 8, "bucket")
    p1, n1 = _by_idp(c_k)
    p2, n2 = _by_idp(c_b)
    assert n1 == n2
    np.testing.assert_allclose(p1, p2, atol=1e-4 * case.csp.dp)


def test_sorted_layout_verlet_matches_bucket_path():
    case = cases.dambreak2d(dp=0.04, need_verlet=True)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS, tstep=TpStep.VERLET,
                        verlet_steps=5)
    c_k = _run_steps(case, opts, 12, "cellforce")
    c_b = _run_steps(case, opts, 12, "bucket")
    p1, n1 = _by_idp(c_k)
    p2, n2 = _by_idp(c_b)
    assert n1 == n2
    np.testing.assert_allclose(p1, p2, atol=1e-4 * case.csp.dp)


# ---------------------------------------------------------------------------
# on the card: the compiled kernel against the bucket path
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cellforce_compiled_matches_bucket(gpu):
    case = cases.dambreak3d(dp=0.02)
    csp, dom, st = case.csp, case.dom, case.state
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    rng = np.random.default_rng(0)
    fl = np.asarray(td.code_type(st.code)) == td.TYPE_FLUID
    vel = jnp.asarray(np.where(fl[:, None], rng.normal(0, 0.3, (st.n, 3)),
                               0.0), jnp.float32)
    with jax.default_matmul_precision("highest"):
        div, code = cd.divide(dom, st.pos, st.code)
        ref = F.interaction_forces(csp, opts, div, st.pos, vel, st.rho,
                                   eos.press_from_rho(csp, st.rho), code)
        sd, code = cd.divide_sorted(dom, st.pos, st.code,
                                    block=CF.tile_config(csp, opts)[0])
        got = CF.interaction_forces(csp, opts, sd, st.pos, vel, st.rho, code,
                                    state_sorted=False)
    for a, b in ((got.ace, ref.ace), (got.ar, ref.ar)):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=2e-3 * np.abs(b).max())
