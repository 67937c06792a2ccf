"""Unit tests for SPH kernels & EOS vs the reference closed forms
(FunSphKernel.h, FunSphEos.h)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.ops import kernels as K
from dualsphysics_multilayer.ops import eos
from dualsphysics_multilayer.typesdef import TpKernel, make_ctesph


def csp_for(simulate2d, tkernel=TpKernel.WENDLAND, dp=0.01):
    return make_ctesph(simulate2d=simulate2d, dp=dp, hswl=1.0, tkernel=tkernel)


# ---- reference constant tables (hard decimals from FunSphKernel.h:191-203) --

def test_wendland_constants_match_reference():
    for sim2d in (True, False):
        csp = csp_for(sim2d)
        h = csp.kernelh
        if sim2d:
            assert np.isclose(csp.kwend.awen, 0.557 / h**2, rtol=2e-4)
            assert np.isclose(csp.kwend.bwen, -2.7852 / h**3, rtol=2e-4)
        else:
            assert np.isclose(csp.kwend.awen, 0.41778 / h**3, rtol=2e-4)
            assert np.isclose(csp.kwend.bwen, -2.08891 / h**4, rtol=2e-4)


@pytest.mark.parametrize("sim2d", [True, False])
@pytest.mark.parametrize("tker", [TpKernel.WENDLAND, TpKernel.CUBIC])
def test_kernel_normalization(sim2d, tker):
    """Integral of W over support == 1 (the defining property)."""
    csp = csp_for(sim2d, tker)
    h = csp.kernelh
    nquad = 400
    r = (np.arange(nquad) + 0.5) * (2 * h / nquad)
    w = np.asarray(K.kernel_wab(csp, jnp.asarray(r * r)))
    if sim2d:
        integral = np.sum(w * 2 * np.pi * r) * (2 * h / nquad)
    else:
        integral = np.sum(w * 4 * np.pi * r * r) * (2 * h / nquad)
    assert np.isclose(integral, 1.0, rtol=1e-3)


@pytest.mark.parametrize("sim2d", [True, False])
@pytest.mark.parametrize("tker", [TpKernel.WENDLAND, TpKernel.CUBIC])
def test_fac_is_gradient(sim2d, tker):
    """fac = (1/r) dW/dr checked against numeric differentiation of wab."""
    import jax
    csp = csp_for(sim2d, tker)
    h = csp.kernelh
    r = np.linspace(0.05 * h, 1.95 * h, 111)
    dr = 1e-6 * h
    with jax.enable_x64(True):
        w_plus = np.asarray(K.kernel_wab(csp, jnp.asarray((r + dr) ** 2, jnp.float64)))
        w_minus = np.asarray(K.kernel_wab(csp, jnp.asarray((r - dr) ** 2, jnp.float64)))
        fac = np.asarray(K.kernel_fac(csp, jnp.asarray(r * r, jnp.float64)))
    dwdr = (w_plus - w_minus) / (2 * dr)
    np.testing.assert_allclose(fac, dwdr / r, rtol=5e-4, atol=1e-6 * abs(dwdr).max())


def test_kernel_compact_support():
    csp = csp_for(False)
    ks = csp.kernelsize
    # Wendland W(2h)=0 exactly; beyond 2h callers mask by rr2<=ks^2
    assert abs(float(K.kernel_wab(csp, jnp.asarray(ks ** 2)))) < 1e-6 * csp.kwend.awen
    assert abs(float(K.kernel_fac(csp, jnp.asarray(ks ** 2)))) < 1e-6 * abs(csp.kwend.bwen)


def test_eos_roundtrip_and_reference_form():
    csp = csp_for(False)
    rho = jnp.asarray([950.0, 1000.0, 1050.0, 1100.0])
    p = eos.press_from_rho(csp, rho)
    # closed form b*((rho/rho0)^gamma - 1)
    expect = csp.cteb * ((np.asarray(rho) / csp.rhopzero) ** csp.gamma - 1.0)
    np.testing.assert_allclose(np.asarray(p), expect, rtol=1e-5)
    back = eos.rho_from_press(csp, p)
    np.testing.assert_allclose(np.asarray(back), np.asarray(rho), rtol=1e-5)
    assert float(eos.press_from_rho(csp, jnp.asarray(csp.rhopzero))) == 0.0


def test_hydrostatic_rho_monotone():
    csp = csp_for(False)
    z = jnp.asarray([0.0, 0.5, 1.0, 1.5])
    rho = np.asarray(eos.hydrostatic_rho(csp, z, 1.0))
    assert rho[0] > rho[1] > rho[2]
    assert np.isclose(rho[2], csp.rhopzero)
    assert np.isclose(rho[3], csp.rhopzero)  # above surface -> rho0


def test_ctesph_derivations():
    """ConfigConstants1/2 derivations (JSph.cpp:1392-1457)."""
    csp = make_ctesph(simulate2d=False, dp=0.0085, hswl=0.3, coefh=1.0,
                      gamma=7.0, rhopzero=1000.0, coefsound=20.0)
    h = 1.0 * np.sqrt(3 * 0.0085 ** 2)
    assert np.isclose(csp.kernelh, h)
    assert np.isclose(csp.kernelsize, 2 * h)
    cs0 = 20 * np.sqrt(9.81 * 0.3)
    assert np.isclose(csp.cs0, cs0)
    assert np.isclose(csp.cteb, cs0 ** 2 * 1000 / 7)
    assert np.isclose(csp.cs0, np.sqrt(csp.gamma * csp.cteb / csp.rhopzero))
    assert np.isclose(csp.massfluid, 1000 * 0.0085 ** 3)
    assert np.isclose(csp.eta2, (0.1 * h) ** 2)
    assert np.isclose(csp.ddtkh, 2 * h * 0.1)
    assert np.isclose(csp.ddtgz, 1000 * 9.81 / csp.cteb)
    assert np.isclose(csp.dtmin, (h / cs0) * 0.05)


def test_typecode_fields():
    c = td.code_make(td.TYPE_FLUID, 37)
    assert td.code_value(c) == 37
    assert bool(td.is_fluid(c)) and not bool(td.is_bound(c))
    assert bool(td.is_normal(c)) and bool(td.is_active(c))
    c2 = td.code_set_special(c, td.SPECIAL_OUT_RHOP)
    assert bool(td.is_out(c2)) and not bool(td.is_active(c2))
    assert td.code_value(c2) == 37 and bool(td.is_fluid(c2))
    c3 = td.code_make(td.TYPE_FLOATING, 2, td.SPECIAL_PERIODIC)
    assert bool(td.is_floating(c3)) and bool(td.is_periodic(c3))
    arr = jnp.asarray([c, c2, c3], jnp.uint32)
    np.testing.assert_array_equal(np.asarray(td.is_active(arr)), [True, False, True])
