"""Multiphase non-Newtonian solver tests (mphase JSphCpu_NN_SPH parity)."""

import numpy as np
import jax
import jax.numpy as jnp
import os

import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import nnewtonian as NNM
from dualsphysics_multilayer.models.wcsph import make_carry
from dualsphysics_multilayer.ops import forces_nn as NN
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity, TpVisco


def test_eta_effective_limits():
    """HBP reduces to Newtonian for m=0/n=1, Bingham-ish for large m, and
    power-law for tau_yield=0."""
    ph = NN.PhaseCfg(phases=(
        NN.Phase(mkfluid=0, rho0=1000, csound=50, visco=0.1,
                 tau_yield=0.0, hbp_m=0.0, hbp_n=1.0),        # Newtonian
        NN.Phase(mkfluid=1, rho0=1000, csound=50, visco=0.1,
                 tau_yield=0.01, hbp_m=100.0, hbp_n=1.0),     # Bingham-ish
        NN.Phase(mkfluid=2, rho0=1000, csound=50, visco=0.1,
                 tau_yield=0.0, hbp_m=0.0, hbp_n=0.5),        # shear-thinning
    ))
    from dualsphysics_multilayer.typesdef import make_ctesph
    csp = make_ctesph(simulate2d=True, dp=0.01, hswl=1.0)
    tb = ph.tables(csp)
    rates = jnp.asarray([0.1, 1.0, 10.0])
    # phase 0: Newtonian -> eta == visco at any rate
    eta0 = NN.eta_effective(tb, jnp.zeros(3, jnp.int32), rates)
    np.testing.assert_allclose(np.asarray(eta0), 0.1, rtol=1e-5)
    # phase 1: Bingham -> eta ~ visco + tau_yield/(2*rate), decreasing in rate
    eta1 = np.asarray(NN.eta_effective(tb, jnp.ones(3, jnp.int32), rates))
    assert eta1[0] > eta1[1] > eta1[2]
    expect_hi = 0.1 + 0.01 / (2 * 10.0)
    assert abs(eta1[2] - expect_hi) / expect_hi < 0.05
    # phase 2: power-law n=0.5 -> eta = k * rate^(-0.5)
    eta2 = np.asarray(NN.eta_effective(tb, jnp.full(3, 2, jnp.int32), rates))
    np.testing.assert_allclose(eta2, 0.1 * np.asarray(rates) ** -0.5,
                               rtol=1e-4)


def test_strain_rate_simple_shear():
    """gradvel for simple shear du/dz = g: D magnitude = g/2."""
    g = 2.0
    gradvel = jnp.zeros((1, 6)).at[0, 2].set(g)   # xz entry: du/dz + dw/dx
    D, magn = NN.strain_rate(gradvel)
    np.testing.assert_allclose(float(magn[0]), g / 2, rtol=1e-6)


def test_strain_magn_pair_simple_shear():
    """FDA per-pair strain for a simple-shear pair: dv=(g*dz,0,0) across
    dr=(0,0,dz) gives dvel a13=g, sxz=g/2 and the reference's full-matrix
    magnitude |II_1 - II_2| = g^2/4 (JSphCpu_Tensors.cpp:106-108 quirk:
    squared units, unlike the sym formulation's sqrt)."""
    g, dz = 2.0, 0.1
    dvw = jnp.asarray([[g * dz, 0.0, 0.0]])
    dr = jnp.asarray([[0.0, 0.0, dz]])
    rr2 = jnp.asarray([dz * dz])
    magn, S = NN.strain_magn_pair(dvw, dr, rr2)
    np.testing.assert_allclose(float(magn[0]), g * g / 4, rtol=1e-6)
    sxx, sxy, sxz, syy, syz, szz = [float(s[0]) for s in S]
    np.testing.assert_allclose(sxz, g / 2, rtol=1e-6)
    for v in (sxx, sxy, syy, syz, szz):
        assert abs(v) < 1e-12


@pytest.mark.parametrize("tvisco", [TpVisco.LAMINAR_SPS, TpVisco.CONST_EQ])
@pytest.mark.parametrize("velgrad", [td.TpVelGrad.SPH, td.TpVelGrad.FDA])
def test_wet_dambreak_nn_runs_stable(tvisco, velgrad):
    case, phases = NNM.wet_dambreak_nn(dp=0.04, tank=(1.2, 0.8),
                                       mud=(0.3, 0.25), water_depth=0.1)
    opts = SolverOpts(tvisco=tvisco, tdensity=TpDensity.FOURTAKAS,
                      velgrad=velgrad)
    step = NNM.make_nn_step(case.csp, opts, case.dom, phases)
    carry = make_carry(case.state, case.csp, opts)
    runk = jax.jit(lambda c: jax.lax.fori_loop(0, 400, lambda i, cc: step(cc), c))
    carry = runk(carry)
    st = carry.st
    live = np.asarray(td.is_active(st.code) & td.is_fluid(st.code))
    assert int(carry.overflow) == 0
    assert np.isfinite(np.asarray(st.pos)[live]).all()
    rho = np.asarray(st.rho)
    mk = np.asarray(td.code_value(st.code))
    mud = live & (mk == 1)
    wat = live & (mk == 0)
    # each phase stays near its own rest density
    assert abs(rho[mud].mean() - 1500) < 150, rho[mud].mean()
    assert abs(rho[wat].mean() - 1000) < 100, rho[wat].mean()
    # mud front advanced but is still a coherent column (yield stress)
    front = np.asarray(st.pos)[mud, 0].max()
    assert 0.3 < front < 1.1, front


def test_mud_slower_than_water():
    """A yield-stress mud column must collapse slower than a Newtonian water
    column of the same geometry (the qualitative NN validation)."""
    fronts = {}
    for name, (visc, ty, m) in dict(water=(0.01, 0.0, 0.0),
                                    mud=(0.5, 0.05, 100.0)).items():
        case, phases = NNM.wet_dambreak_nn(
            dp=0.04, tank=(1.2, 0.8), mud=(0.3, 0.25), water_depth=0.08,
            mud_visco=visc, tau_yield=ty, hbp_m=m)
        opts = SolverOpts(tvisco=TpVisco.LAMINAR_SPS,
                          tdensity=TpDensity.FOURTAKAS)
        step = NNM.make_nn_step(case.csp, opts, case.dom, phases)
        carry = make_carry(case.state, case.csp, opts)
        runk = jax.jit(lambda c, s=step: jax.lax.fori_loop(
            0, 600, lambda i, cc: s(cc), c))
        carry = runk(carry)
        st = carry.st
        live = np.asarray(td.is_active(st.code) & td.is_fluid(st.code))
        mk = np.asarray(td.code_value(st.code))
        fronts[name] = np.asarray(st.pos)[live & (mk == 1), 0].max()
    assert fronts["mud"] < fronts["water"] - 0.01, fronts

def test_nnphases_xml_loading():
    """The shipped wet-dam-break NN case XML loads end-to-end: 3 HBP phases
    parsed (JSph::InitMultiPhase schema), fluid starts at per-phase rest
    density, system cs0 per ConfigConstantsMP."""
    import numpy as np
    from dualsphysics_multilayer.io.xmlcase import load_case
    SRC = ("/root/reference/examples/mphase_nnewtonian/01_WetDambreak/"
           "CaseWetDambreak2DNN_Def.xml")
    if not os.path.exists(SRC):
        pytest.skip("needs the reference's shipped NN example case XML")
    case, opts, run = load_case(SRC)
    phases = case.meta["phases"]
    assert phases is not None and phases.count == 3
    assert [p.rho0 for p in phases.phases] == [2000.0, 1500.0, 1000.0]
    assert [p.hbp_m for p in phases.phases] == [100.0, 10.0, 0.0]
    assert opts.tvisco == TpVisco.LAMINAR_SPS
    assert opts.velgrad == td.TpVelGrad.FDA
    rho = np.asarray(case.state.rho)[:case.np_total]
    code = case.state.code
    for i, want in enumerate((2000.0, 1500.0)):
        sel = (np.asarray(td.is_fluid(code))[:case.np_total]
               & (np.asarray(td.code_value(code))[:case.np_total] == i))
        assert sel.sum() > 0
        np.testing.assert_allclose(rho[sel], want, atol=2.0)
    # rhop exclusion window spans all phases
    assert case.csp.rhopoutmin <= 0.6 * 1000
    assert case.csp.rhopoutmax >= 1.5 * 2000
