"""End-to-end solver tests on a small 2D dam break: stability, conservation,
hydrostatic equilibrium, and physical plausibility of the collapse front
(the reference's example-based validation strategy, SURVEY §4)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation, make_carry, make_step
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity, TpStep, TpVisco


def small_dambreak(dp=0.05, tstep=TpStep.SYMPLECTIC, **kw):
    case = cases.dambreak2d(dp=dp, tank=(1.6, 1.0), column=(0.4, 0.6),
                            need_verlet=(tstep == TpStep.VERLET), **kw)
    opts = SolverOpts(tstep=tstep, tdensity=TpDensity.FOURTAKAS)
    return case, opts


@pytest.mark.parametrize("tstep", [TpStep.SYMPLECTIC, TpStep.VERLET])
def test_dambreak_runs_stable(tstep):
    case, opts = small_dambreak(tstep=tstep)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.10, tout=0.05)
    st = sim.state
    pos = np.asarray(st.pos)
    rho = np.asarray(st.rho)
    code = np.asarray(st.code)
    live = np.asarray(td.is_active(jnp.asarray(code))) & (np.asarray(
        td.is_fluid(jnp.asarray(code))))
    assert int(sim.carry.nstep) > 10
    assert np.isfinite(pos[live]).all()
    assert np.isfinite(rho[live]).all()
    # fluid stays inside the tank (no blow-up), density near rho0
    assert np.all(np.abs(rho[live] / case.csp.rhopzero - 1.0) < 0.15)
    # no particle exclusions in this gentle run
    n_out = int(np.sum(~np.asarray(td.is_active(jnp.asarray(code)))[:case.np_total]))
    assert n_out == 0
    # the dam front must have advanced in +x
    front0 = 0.4
    front = pos[live, 0].max()
    assert front > front0 + 0.05


def test_dambreak_mass_conservation():
    """Continuity eq. conserves total mass exactly (fixed particle masses);
    total fluid momentum change matches gravity impulse to leading order."""
    case, opts = small_dambreak()
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.05, tout=0.05)
    code = np.asarray(sim.state.code)
    live = np.asarray(td.is_active(jnp.asarray(code)))
    assert live[:case.np_total].all()  # nothing excluded -> mass conserved


def test_hydrostatic_tank_stays_still():
    """A tank of still water with hydrostatic init must stay quasi-still
    (velocities ~ dp-scale acoustic ringing only)."""
    case = cases.dambreak2d(dp=0.05, tank=(0.8, 1.0), column=(0.8, 0.4))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.1, tout=0.1)
    st = sim.state
    code = np.asarray(st.code)
    fluid = np.asarray(td.is_fluid(jnp.asarray(code))) & np.asarray(
        td.is_active(jnp.asarray(code)))
    v = np.linalg.norm(np.asarray(st.vel)[fluid], axis=1)
    # scale: gravity-wave speed over one dp ~ sqrt(g*dp) ~ 0.7 m/s; still water
    # should show much less
    assert np.percentile(v, 95) < 0.35, f"still water moving: v95={np.percentile(v, 95)}"


def test_step_is_jittable_and_deterministic():
    case, opts = small_dambreak()
    step = make_step(case.csp, opts, case.dom)
    carry0 = make_carry(case.state, case.csp)
    jstep = __import__("jax").jit(step)
    c1 = jstep(carry0)
    c2 = jstep(carry0)
    np.testing.assert_array_equal(np.asarray(c1.st.pos), np.asarray(c2.st.pos))
    np.testing.assert_array_equal(np.asarray(c1.st.rho), np.asarray(c2.st.rho))
    assert int(c1.nstep) == 1
    assert float(c1.t) > 0


def test_dt_positive_and_bounded():
    case, opts = small_dambreak()
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.02, tout=0.02)
    dt = float(sim.carry.dt_pre)
    assert case.csp.dtmin <= dt < case.csp.kernelh / case.csp.cs0 * 2


def test_coastal_runup_solitary_wave():
    """Coastal runup (BASELINE config 5 at mini scale): the solitary hump
    travels shoreward at ~sqrt(g(d+H)) and pushes the shoreline up-beach."""
    from dualsphysics_multilayer.models import cases as C2
    case = C2.coastal_runup3d(dp=0.08, length=3.2, width=0.9, depth=0.3,
                              slope_start=1.2, slope=0.15, wave_height=0.12)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    pos0 = np.asarray(sim.state.pos)
    code = np.asarray(sim.state.code)
    fl = np.asarray(td.is_fluid(code) & td.is_active(code))
    # crest x at t=0 (max fluid surface elevation)
    def crest_x(s):
        p = np.asarray(s.state.pos)
        live = np.asarray(td.is_fluid(s.state.code)
                          & td.is_active(s.state.code))
        pf = p[live]
        return float(pf[np.argmax(pf[:, 2]), 0])
    x0 = crest_x(sim)
    sim.run(tmax=0.12, tout=0.06)
    x1 = crest_x(sim)
    st = sim.state
    live = np.asarray(td.is_active(st.code) & td.is_fluid(st.code))
    rho = np.asarray(st.rho)[live]
    assert int(sim.carry.overflow) == 0
    assert np.isfinite(np.asarray(st.pos)[live]).all()
    assert abs(rho.mean() - 1000) < 60
    # the crest moved shoreward by roughly c*t (c = sqrt(g*(d+H)) ~ 2.0 m/s)
    c = np.sqrt(9.81 * (0.3 + 0.12))
    assert 0.35 * c * 0.12 < (x1 - x0) < 1.8 * c * 0.12, (x0, x1)


def test_boundary_out_aborts_with_evidence(tmp_path):
    """A boundary particle excluded from the domain must abort the run with
    an Error_BoundaryOut.vtk dump (reference AbortBoundOut, JSph.cpp:2477)."""
    import dataclasses
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops.forces import SolverOpts
    case = cases.dambreak2d(dp=0.06)
    sim = Simulation(case.csp, SolverOpts(), case.dom, case.state)
    sim.errdir = str(tmp_path)
    sim.check_diagnostics()     # clean state passes
    code = np.array(sim.carry.st.code)
    bidx = int(np.flatnonzero(td.code_type(code) == td.TYPE_FIXED)[0])
    code[bidx] = td.code_make(td.TYPE_FIXED,
                              int(td.code_value(code[bidx])),
                              td.SPECIAL_OUT_POS)
    sim.carry = dataclasses.replace(
        sim.carry, st=dataclasses.replace(sim.carry.st,
                                          code=jnp.asarray(code)))
    with pytest.raises(RuntimeError, match="boundary particle"):
        sim.check_diagnostics()
    assert (tmp_path / "Error_BoundaryOut.vtk").exists()


def test_partsoutmax_aborts(tmp_path):
    """Excluded fluid beyond PartsOutMax aborts (NpMinimum check)."""
    import dataclasses
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops.forces import SolverOpts
    case = cases.dambreak2d(dp=0.06)
    sim = Simulation(case.csp, SolverOpts(), case.dom, case.state)
    sim.partsoutmax = 0.01
    sim.check_diagnostics()
    code = np.array(sim.carry.st.code)
    fidx = np.flatnonzero(td.code_type(code) == td.TYPE_FLUID)
    k = max(int(0.02 * len(fidx)), 2)
    for i in fidx[:k]:
        code[i] = td.code_make(td.TYPE_FLUID, int(td.code_value(code[i])),
                               td.SPECIAL_OUT_RHOP)
    sim.carry = dataclasses.replace(
        sim.carry, st=dataclasses.replace(sim.carry.st,
                                          code=jnp.asarray(code)))
    with pytest.raises(RuntimeError, match="PartsOutMax"):
        sim.check_diagnostics()
