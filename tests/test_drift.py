"""Position-precision drift budget (SURVEY §5.7).

The reference holds positions in f64 (CPU) / f64+PosCell (GPU,
`JSphGpu_ker.h:45`) because per-step displacements are far below the f32
ulp at domain scale: accumulating them in plain f32 drifts, and stalls
outright once |disp| < ulp(pos)/2.  This solver keeps pos plain f32 for
the pair kernels and carries a Kahan residual (SimState.pose,
integrators.comp_pos_update) updated by the integrators.

These tests run the REAL integrator update (ops.integrators.symplectic_corr
/ verlet) 50k steps at domain scale and check the budget: the compensated
trajectory must track the exact (f64) one to a small fraction of dp while
the plain-f32 trajectory demonstrably misses it.
"""

import jax
import jax.numpy as jnp
import numpy as np

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.ops import integrators as I
from dualsphysics_multilayer.typesdef import make_ctesph

NSTEP = 50_000
X0 = 50.0          # domain-scale position (coastal-runup class)
VEL = 1e-3         # slow creep: disp/step ~ 2e-9 << ulp(50) ~ 3.8e-6
DT = 2e-6
DP = 0.01


def _run(csp, pose0):
    n = 8
    pos0 = jnp.full((n, 3), X0, jnp.float32)
    vel = jnp.full((n, 3), VEL, jnp.float32)
    rho = jnp.full((n,), 1000.0, jnp.float32)
    code = jnp.full((n,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    zero = jnp.zeros((n, 3), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    dt = jnp.float32(DT)

    def body(_, carry):
        pos, pose = carry
        out = I.symplectic_corr(csp, pos, vel, rho, rho, code, zero, zeros,
                                dt, pose=pose)
        if pose is not None:
            return out[0], out[4]
        return out[0], None

    pos, pose = jax.lax.fori_loop(0, NSTEP, body, (pos0, pose0))
    total = pos.astype(jnp.float64)
    if pose is not None:
        total = total + pose.astype(jnp.float64)
    return np.asarray(total)


def test_drift_budget_compensated_positions():
    csp = make_ctesph(simulate2d=False, dp=DP, speedsound=20.0,
                      gravity=(0, 0, 0))
    exact = X0 + NSTEP * np.float64(np.float32(VEL)) \
        * np.float64(np.float32(DT))

    plain = _run(csp, None)
    comp = _run(csp, jnp.zeros((8, 3), jnp.float32))

    err_plain = np.abs(plain - exact).max()
    err_comp = np.abs(comp - exact).max()

    # the budget: compensated trajectories stay within 1% of dp of the
    # exact f64 path over 50k steps at x ~ 50 m
    assert err_comp < 0.01 * DP, err_comp
    # and the compensation is doing real work: plain f32 loses (nearly)
    # the whole displacement here (disp < ulp/2 stalls the accumulator)
    assert err_plain > 100.0 * max(err_comp, 1e-12), (err_plain, err_comp)
    assert err_plain > 0.5 * NSTEP * VEL * DT


def test_drift_budget_verlet():
    csp = make_ctesph(simulate2d=False, dp=DP, speedsound=20.0,
                      gravity=(0, 0, 0))
    n = 4
    pos0 = jnp.full((n, 3), X0, jnp.float32)
    vel = jnp.full((n, 3), VEL, jnp.float32)
    rho = jnp.full((n,), 1000.0, jnp.float32)
    code = jnp.full((n,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    zero = jnp.zeros((n, 3), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    dt = jnp.float32(DT)

    def body(_, carry):
        pos, pose = carry
        out = I.verlet(csp, pos, vel, rho, vel, rho, code, zero, zeros, dt,
                       jnp.bool_(False), pose=pose)
        return out[0], out[4]

    pos, pose = jax.lax.fori_loop(
        0, NSTEP, body, (pos0, jnp.zeros((n, 3), jnp.float32)))
    total = np.asarray(pos.astype(jnp.float64) + pose.astype(jnp.float64))
    exact = X0 + NSTEP * np.float64(np.float32(VEL)) \
        * np.float64(np.float32(DT))
    assert np.abs(total - exact).max() < 0.01 * DP
