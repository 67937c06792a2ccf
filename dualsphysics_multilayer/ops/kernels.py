"""SPH smoothing kernels as pure jnp functions.

Re-design of the reference's kernel layer
(`/root/reference/src/source/FunSphKernel.h`): Wendland C2
(`FunSphKernel.h:191-256`) and cubic spline with tensile correction
(`FunSphKernel.h:51-173`).  All functions are branch-free, vectorized over
arbitrary-shaped ``rr2`` arrays, and safe at rr2 == 0 (callers mask dead pairs
with the ``ALMOSTZERO`` rule, `DualSphDef.h`).

Convention (matches reference): ``wab`` is W(r); ``fac`` is (1/r) dW/dr so that
the kernel gradient is ``fac * dr``.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..typesdef import CteSph, TpKernel

_EPS = 1e-30  # guards 0/0 at rr2==0; such pairs are always masked by callers


def wendland_wab(csp: CteSph, rr2):
    """Wendland C2 W(r); reference `GetKernelWendland_Wab` (FunSphKernel.h:206)."""
    qq = jnp.sqrt(rr2) / csp.kernelh
    wqq1 = 1.0 - 0.5 * qq
    wqq2 = wqq1 * wqq1
    return csp.kwend.awen * (2.0 * qq + 1.0) * wqq2 * wqq2


def wendland_fac(csp: CteSph, rr2):
    """Wendland C2 (1/r)dW/dr; reference `GetKernelWendland_Fac` (FunSphKernel.h:217)."""
    rad = jnp.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 1.0 - 0.5 * qq
    return csp.kwend.bwen * qq * wqq1 * wqq1 * wqq1 / jnp.maximum(rad, _EPS)


def cubic_wab(csp: CteSph, rr2):
    """Cubic spline W(r); reference `GetKernelCubic_Wab` (FunSphKernel.h:88-101).
    Branchless: select between the q<=1 and 1<q<=2 polynomial pieces."""
    kc = csp.kcubic
    rad = jnp.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 2.0 - qq
    outer = kc.a24 * (wqq1 * wqq1 * wqq1)
    wqq2 = qq * qq
    inner = kc.a2 * (1.0 + (0.75 * qq - 1.5) * wqq2)
    return jnp.where(rad > csp.kernelh, outer, inner)


def cubic_fac(csp: CteSph, rr2):
    """Cubic spline (1/r)dW/dr; reference `GetKernelCubic_Fac` (FunSphKernel.h:104-118)."""
    kc = csp.kcubic
    rad = jnp.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 2.0 - qq
    outer = kc.c2 * wqq1 * wqq1
    inner = kc.c1 * qq + kc.d1 * qq * qq
    return jnp.where(rad > csp.kernelh, outer, inner) / jnp.maximum(rad, _EPS)


def cubic_tensil(csp: CteSph, rr2, rhop1, press1, rhop2, press2):
    """Cubic-spline tensile correction; reference `GetKernelCubic_Tensil`
    (FunSphKernel.h:138-150)."""
    wab = cubic_wab(csp, rr2)
    fab = wab * csp.kcubic.od_wdeltap
    fab = fab * fab
    fab = fab * fab  # fab^4
    t1 = (press1 / (rhop1 * rhop1)) * jnp.where(press1 > 0, 0.01, -0.2)
    t2 = (press2 / (rhop2 * rhop2)) * jnp.where(press2 > 0, 0.01, -0.2)
    return fab * (t1 + t2)


def kernel_wab(csp: CteSph, rr2):
    """W(r) for the configured kernel (trace-time dispatch, the analog of the
    reference `GetKernel_Wab<tker>` template, FunSphKernel.h:271-284)."""
    if csp.tkernel == TpKernel.WENDLAND:
        return wendland_wab(csp, rr2)
    return cubic_wab(csp, rr2)


def kernel_fac(csp: CteSph, rr2):
    """(1/r)dW/dr for the configured kernel."""
    if csp.tkernel == TpKernel.WENDLAND:
        return wendland_fac(csp, rr2)
    return cubic_fac(csp, rr2)
