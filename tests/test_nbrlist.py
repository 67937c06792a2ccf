"""Verlet neighbour-list tests: list completeness, force parity with the
O(N^2) oracle, and nbr-mode simulation tracking the bucket-mode trajectory."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops import celldiv as cd
from dualsphysics_multilayer.ops import eos
from dualsphysics_multilayer.ops import forces as F
from dualsphysics_multilayer.ops import nbrlist as NB
from dualsphysics_multilayer.typesdef import TpDensity, TpVisco, make_ctesph

from ref_naive import naive_forces
from test_forces import make_cloud, assert_close


def build_for(csp, opts, pos, code):
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, csp.kernelsize,
                         simulate2d=csp.simulate2d, dp=csp.dp)
    nbr, code2 = NB.build(dom, csp, opts, jnp.asarray(pos, jnp.float32),
                          jnp.asarray(code))
    return dom, nbr, code2


def test_list_complete_vs_bruteforce():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25)
    opts = F.SolverOpts(use_nbrlist=True)
    rng = np.random.default_rng(0)
    n = 250
    pos = rng.uniform(0, 0.4, (n, 3))
    code = np.full(n, td.code_make(td.TYPE_FLUID, 0), np.uint32)
    dom, nbr, _ = build_for(csp, opts, pos, code)
    assert int(nbr.overflow) == 0
    idx = np.asarray(nbr.nbr)
    rcut = csp.kernelsize + opts.nbr_skin * csp.dp
    for i in range(n):
        want = set(np.where(
            (np.sum((pos - pos[i]) ** 2, axis=1) <= (rcut * (1 - 1e-6)) ** 2)
        )[0].tolist()) - {i}
        got = set(idx[i][idx[i] < n].tolist())
        missing = want - got
        assert not missing, f"particle {i} missing neighbours {missing}"


@pytest.mark.parametrize("tdensity", [TpDensity.NONE, TpDensity.FOURTAKAS])
def test_nbr_forces_match_oracle(tdensity):
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=tdensity, use_nbrlist=True)
    pos, vel, rho, code, nb = make_cloud(seed=8)
    press = np.asarray(eos.press_from_rho(csp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(csp, opts, pos, vel, rho, press, code)
    dom, nbr, code2 = build_for(csp, opts, pos, code)
    assert int(nbr.overflow) == 0
    got = NB.interaction_forces_nbr(
        csp, opts, nbr, jnp.asarray(pos, jnp.float32),
        jnp.asarray(vel, jnp.float32), jnp.asarray(rho, jnp.float32),
        jnp.asarray(press, jnp.float32), code2)
    assert_close(want, got)


def test_nbr_forces_laminar_sps():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=1e-4,
                      tvisco=TpVisco.LAMINAR_SPS)
    opts = F.SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=TpDensity.NONE,
                        use_nbrlist=True)
    pos, vel, rho, code, nb = make_cloud(seed=9)
    rng = np.random.default_rng(7)
    spstau = rng.normal(0, 1e-3, (pos.shape[0], 6))
    spstau[:nb] = 0.0
    press = np.asarray(eos.press_from_rho(csp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(csp, opts, pos, vel, rho, press, code, spstau=spstau)
    dom, nbr, code2 = build_for(csp, opts, pos, code)
    got = NB.interaction_forces_nbr(
        csp, opts, nbr, jnp.asarray(pos, jnp.float32),
        jnp.asarray(vel, jnp.float32), jnp.asarray(rho, jnp.float32),
        jnp.asarray(press, jnp.float32), code2,
        spstau=jnp.asarray(spstau, jnp.float32))
    assert_close(want, got)
    scale = np.abs(want["gradvel"]).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got.spsgradvel), want["gradvel"],
                               atol=2e-3 * scale, rtol=2e-3)


def test_nbr_simulation_matches_bucket_mode():
    """Full dam-break trajectories from both interaction layouts agree (same
    physics, different pair ordering -> tolerance well under dp)."""
    case = cases.dambreak2d(dp=0.05, tank=(1.6, 1.0), column=(0.4, 0.6))
    opts_b = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    opts_n = F.SolverOpts(tdensity=TpDensity.FOURTAKAS, use_nbrlist=True)

    sim_b = Simulation(case.csp, opts_b, case.dom, case.state)
    sim_b.run(tmax=0.05, tout=0.05)
    case2 = cases.dambreak2d(dp=0.05, tank=(1.6, 1.0), column=(0.4, 0.6))
    sim_n = Simulation(case2.csp, opts_n, case2.dom, case2.state)
    sim_n.run(tmax=0.05, tout=0.05)

    assert int(sim_n.carry.overflow) == 0
    nb_steps = int(sim_n.carry.nstep)
    assert abs(nb_steps - int(sim_b.carry.nstep)) <= 2
    pb = np.asarray(sim_b.state.pos)
    pn = np.asarray(sim_n.state.pos)
    live = np.asarray(td.is_active(sim_b.state.code))
    err = np.abs(pb[live] - pn[live]).max()
    assert err < 0.05 * case.csp.dp, f"layout divergence {err}"


def test_nbr_features_floating_motion_damping():
    """nbrlist mode now runs the full feature set through the main step:
    a floating-box case (floating + mDBC off, DEM off) must match the
    bucket-layout trajectories including the rigid body state."""
    import dataclasses
    from dualsphysics_multilayer.features.featureset import Features
    case = cases.floatingbox2d(dp=0.04)
    feats = Features(floating=case.meta["ftcfg"])
    opts_b = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                          with_floating=True)
    opts_n = dataclasses.replace(opts_b, use_nbrlist=True)

    sim_b = Simulation(case.csp, opts_b, case.dom, case.state, feats=feats)
    sim_b.run(tmax=0.04, tout=0.04)
    case2 = cases.floatingbox2d(dp=0.04)
    sim_n = Simulation(case2.csp, opts_n, case2.dom, case2.state,
                       feats=Features(floating=case2.meta["ftcfg"]))
    sim_n.run(tmax=0.04, tout=0.04)

    assert int(sim_n.carry.overflow) == 0
    cb = np.asarray(sim_b.state.ft.center)
    cn = np.asarray(sim_n.state.ft.center)
    assert np.abs(cb - cn).max() < 0.05 * case.csp.dp
    pb = np.asarray(sim_b.state.pos)
    pn = np.asarray(sim_n.state.pos)
    live = np.asarray(td.is_active(sim_b.state.code))
    assert np.abs(pb[live] - pn[live]).max() < 0.05 * case.csp.dp
