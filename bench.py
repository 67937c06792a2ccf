"""Benchmark: particle-steps/sec on the BASELINE.json config matrix.

Runs the full device-resident step loop on the GPU and prints ONE JSON line
with the rate, the p50 step time, the interaction path the code selected,
the device as JAX reports it and the card's name and power limit.  Fails
when JAX finds no GPU.

Config selection (BENCH_CASE env; default ``dambreak3d``):
  dambreak3d   3D dam break with obstacle
  waveflume    2D wave flume, piston wavemaker + AWAS absorption
  floatingbox  floating box, mDBC boundaries + 6-DOF rigid solve
  nnmud        non-Newtonian mud dam break (HBP multiphase, SPH gradients)
Other knobs: BENCH_NP (target particle count), BENCH_STEPS (steps per
device call), BENCH_STEP=verlet (the Verlet integrator).
"""

import json
import os
import sys
import time

import jax

from dualsphysics_multilayer.utils.compilecache import enable_cache
enable_cache()


def _build(case_name, n_target):
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import make_carry, make_step
    from dualsphysics_multilayer.ops.forces import SolverOpts
    from dualsphysics_multilayer.typesdef import (TpBoundary, TpDensity,
                                                      TpSlipMode)

    if case_name == "dambreak3d":
        # pick dp to hit ~n_target particles in the reference dam-break
        # geometry (fluid 0.4x0.67x0.3 + tank walls): n_fluid ~ 0.0804/dp^3
        dp = (0.11 / n_target) ** (1.0 / 3.0)
        case = cases.dambreak3d(dp=dp, obstacle=True)
        # BENCH_STEP=verlet runs the reference's -verlet integrator (one
        # interaction/step instead of symplectic's two) as a SECONDARY
        # metric; the headline/driver config stays symplectic (the
        # reference default)
        from dualsphysics_multilayer.typesdef import TpStep
        tstep = (TpStep.VERLET if os.environ.get("BENCH_STEP") == "verlet"
                 else TpStep.SYMPLECTIC)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS,
                          tstep=tstep)
        step = make_step(case.csp, opts, case.dom)
        carry = make_carry(case.state, case.csp, opts, dom=case.dom)
        return case, opts, step, carry

    if case_name == "waveflume":
        dp = (6.0 * 0.4 / n_target) ** 0.5
        case = cases.waveflume2d(dp=dp)
        feats = case.meta.get("features")
        if feats is None:
            from dualsphysics_multilayer.features.featureset import Features
            feats = Features(motions=(case.meta["motion"],)
                             if "motion" in case.meta else ())
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
        step = make_step(case.csp, opts, case.dom, feats)
        carry = make_carry(case.state, case.csp, opts, feats, dom=case.dom)
        return case, opts, step, carry

    if case_name == "floatingbox":
        dp = (2.0 * 0.5 / n_target) ** 0.5
        case = cases.floatingbox2d(dp=dp)
        from dualsphysics_multilayer.features.featureset import Features
        feats = Features(floating=case.meta["ftcfg"])
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True,
                          tboundary=TpBoundary.MDBC,
                          slipmode=TpSlipMode.NO_SLIP)
        step = make_step(case.csp, opts, case.dom, feats)
        carry = make_carry(case.state, case.csp, opts, feats, dom=case.dom)
        return case, opts, step, carry

    if case_name == "nnmud":
        from dualsphysics_multilayer.models import nnewtonian as NNM
        from dualsphysics_multilayer.typesdef import TpVisco
        dp = (2.0 * 0.45 * 0.35 / n_target) ** 0.5 * 1.4
        case, phases = NNM.wet_dambreak_nn(dp=max(dp, 0.0025))
        opts = SolverOpts(tvisco=TpVisco.LAMINAR_SPS,
                          tdensity=TpDensity.FOURTAKAS)
        step = NNM.make_nn_step(case.csp, opts, case.dom, phases)
        carry = make_carry(case.state, case.csp, opts, dom=case.dom,
                           path="bucket")
        return case, opts, step, carry

    raise SystemExit(f"unknown BENCH_CASE {case_name!r}")


def main():
    from dualsphysics_multilayer.models.wcsph import select_path
    from dualsphysics_multilayer.utils.device import (gpu_name_power,
                                                          require_gpu)
    device = require_gpu()
    case_name = os.environ.get("BENCH_CASE", "dambreak3d")
    n_default = 300_000 if case_name == "dambreak3d" else 60_000
    n_target = int(os.environ.get("BENCH_NP", n_default))
    case, opts, step, carry = _build(case_name, n_target)
    n = case.np_total

    # measure K steps chained on device (like the production while_loop —
    # a per-step host sync would measure dispatch, not the solver)
    K = int(os.environ.get("BENCH_STEPS", 25))
    runk = jax.jit(lambda c: jax.lax.fori_loop(0, K, lambda i, cc: step(cc), c))
    carry = runk(carry)
    jax.block_until_ready(carry.st.pos)

    reps = 3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        carry = runk(carry)
        jax.block_until_ready(carry.st.pos)
        times.append((time.perf_counter() - t0) / K)
    times.sort()
    p50 = times[len(times) // 2]
    label = {"dambreak3d": "3D dam break",
             "waveflume": "2D wave flume piston+AWAS",
             "floatingbox": "floating box mDBC",
             "nnmud": "NN mud dam break"}[case_name]
    if os.environ.get("BENCH_STEP") == "verlet":
        label += " (Verlet)"
    out = {
        "metric": f"particle-steps/s ({label}, {n} particles)",
        "value": n / p50,
        "unit": "particle-steps/s",
        "p50_step_ms": p50 * 1e3,
        "np": n,
        "nstep": int(carry.nstep),
        "overflow": int(carry.overflow),
        "path": ("bucket" if case_name == "nnmud"
                 else select_path(case.csp, opts)),
        "device": device,
        "card": gpu_name_power(),
    }
    print(json.dumps(out))
    if int(carry.overflow):
        # an overflow drops particles from the interaction: the timing is
        # not comparable
        print(f"[bench] INVALID: overflow={int(carry.overflow)}",
              file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
