"""mDBC boundary-correction tests (reference InteractionMdbcCorrectionT2)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops import celldiv as cd
from dualsphysics_multilayer.ops import mdbc as MDBC
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpBoundary, TpDensity, TpSlipMode


def test_mdbc_hydrostatic_extrapolation():
    """Bottom-wall particles under a hydrostatic column must get a density
    close to the hydrostatic value at their depth (first-order extrapolation
    through the ghost node), not rho0."""
    case = cases.dambreak2d(dp=0.04, tank=(1.0, 1.0), column=(1.0, 0.6),
                            mdbc=True)
    st = case.state
    div, code = cd.divide(case.dom, st.pos, st.code)
    opts = SolverOpts(tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    vel2, rho2 = MDBC.mdbc_correction(
        case.csp, opts, case.dom, div, st.pos, st.vel, st.rho, code,
        st.boundnormal, st.motionvel)
    pos = np.asarray(st.pos)
    rho2 = np.asarray(rho2)
    bound = np.asarray(td.is_bound(code))
    bottom = bound & (pos[:, 2] < 0.5 * case.csp.dp) & (pos[:, 0] > 0.2) & (pos[:, 0] < 0.8)
    # hydrostatic density at z=0 wall
    from dualsphysics_multilayer.ops import eos
    expect = float(eos.hydrostatic_rho(case.csp, jnp.asarray(0.0), 0.6))
    got = rho2[bottom].mean()
    assert abs(got - expect) / (expect - 1000.0) < 0.25, (got, expect)
    # and clearly distinct from rho0
    assert got > 1000.0 + 0.5 * (expect - 1000.0)


def test_mdbc_dambreak_runs_stable():
    case = cases.dambreak2d(dp=0.04, tank=(1.6, 1.0), column=(0.4, 0.6),
                            mdbc=True)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                      tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.VEL0)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.1, tout=0.1)
    st = sim.state
    live = np.asarray(td.is_active(st.code) & td.is_fluid(st.code))
    rho = np.asarray(st.rho)
    assert np.isfinite(np.asarray(st.pos)[live]).all()
    assert np.all(np.abs(rho[live] / 1000.0 - 1.0) < 0.15)
    # front advanced
    assert np.asarray(st.pos)[live, 0].max() > 0.45


def test_mdbc_noslip_velocity():
    """No-slip: corrected wall velocity = 2*v_wall - v_ghost; for a static
    wall under moving fluid the wall velocity opposes the fluid."""
    case = cases.dambreak2d(dp=0.04, tank=(1.0, 1.0), column=(1.0, 0.6),
                            mdbc=True)
    st = case.state
    import dataclasses
    vel = np.zeros((st.n, 3), np.float32)
    fluid = np.asarray(td.is_fluid(st.code))
    vel[fluid, 0] = 1.0
    st = dataclasses.replace(st, vel=jnp.asarray(vel))
    div, code = cd.divide(case.dom, st.pos, st.code)
    opts = SolverOpts(tboundary=TpBoundary.MDBC, slipmode=TpSlipMode.NO_SLIP)
    vel2, rho2 = MDBC.mdbc_correction(
        case.csp, opts, case.dom, div, st.pos, st.vel, st.rho, code,
        st.boundnormal, st.motionvel)
    vel2 = np.asarray(vel2)
    pos = np.asarray(st.pos)
    bound = np.asarray(td.is_bound(code))
    bottom = bound & (pos[:, 2] < 0.5 * case.csp.dp) & (pos[:, 0] > 0.2) & (pos[:, 0] < 0.8)
    # ghost velocity ~ fluid velocity (1.0 in x) -> wall velocity ~ -1.0
    assert vel2[bottom, 0].mean() < -0.5, vel2[bottom, 0].mean()
