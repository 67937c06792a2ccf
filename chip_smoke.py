"""Smoke test of the solver on one NVIDIA GPU, through the entry points a
user calls, at the 845k-particle 3D dam break with obstacle.

    python chip_smoke.py           # phases 1-6 on one card
    python chip_smoke.py --multi   # 4-card sharded run vs one card, only

Each phase prints one line; any failure exits non-zero.  The last line of
standard output is one JSON object with the device as JAX reports it.
Exits non-zero, printing no result, when JAX finds no GPU.  Times are
information for the reader, printed beside the card's name and power
limit; they are not a benchmark.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

# 3D dam break with obstacle at the size BASELINE.md names (~1M particles)
DP = 0.0048
# --multi: the same case at ~4M particles (n grows as dp^-3)
DP_MULTI = 0.00286
# kernel vs bucket: f32 sums over ~170 neighbours in another order
TOL = 2e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


try:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dualsphysics_multilayer import typesdef as td
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops import celldiv as cd
    from dualsphysics_multilayer.ops import eos
    from dualsphysics_multilayer.ops import forces as F
    from dualsphysics_multilayer.ops.forces import SolverOpts
    from dualsphysics_multilayer.ops.pallas import cellforce as CF
    from dualsphysics_multilayer.typesdef import TpDensity
    from dualsphysics_multilayer.utils.compilecache import enable_cache
    from dualsphysics_multilayer.utils.device import (device_record,
                                                          gpu_name_power)
except ImportError as e:
    fail(f"cannot import the solver ({e}); run from a checkout of the repo")


def fluid_stats(st):
    """(live fluid mask, dam-front x, rho min, rho max, all finite)."""
    code = np.asarray(st.code)
    fl = np.asarray(td.is_active(code)) & (
        np.asarray(td.code_type(code)) == td.TYPE_FLUID)
    pos, vel, rho = (np.asarray(a) for a in (st.pos, st.vel, st.rho))
    live = np.asarray(td.is_active(code))
    finite = bool(np.isfinite(pos[live]).all() and np.isfinite(vel[live]).all()
                  and np.isfinite(rho[live]).all())
    return (fl, float(pos[fl, 0].max()), float(rho[fl].min()),
            float(rho[fl].max()), finite)


def phase_device(ncards: int) -> dict:
    dev = device_record()
    if dev["platform"] != "gpu":
        fail(f"JAX finds no GPU (platform {dev['platform']})")
    if dev["count"] < ncards:
        fail(f"needs {ncards} GPU(s), JAX sees {dev['count']}")
    card = gpu_name_power()
    phase("1 device", f"kind={dev['kind']} count={dev['count']} "
          f"nvidia-smi: {card}")
    return dev


def phase_compile(sim, card):
    t0 = time.perf_counter()
    compiled = sim.advance.lower(sim.carry, jnp.float32(1.0),
                                 jnp.int32(1)).compile()
    tc = time.perf_counter() - t0
    ma = compiled.memory_analysis()
    phase("2 compile", f"np={sim.carry.st.n} path={sim.path} "
          f"compile {tc:.1f} s; memory_analysis: "
          f"argument {ma.argument_size_in_bytes} B, "
          f"output {ma.output_size_in_bytes} B, "
          f"temp {ma.temp_size_in_bytes} B [{card}]")


def phase_kernel_vs_reference(sim, card):
    """50 steps, then one interaction from the kernel and from the bucket
    path on the same state, at full size."""
    sim.carry = sim.advance(sim.carry, jnp.float32(1.0), jnp.int32(50))
    c = sim.carry
    if int(c.nstep) != 50:
        fail(f"advance ran {int(c.nstep)} steps, not 50")
    st, csp, opts = c.st, sim.csp, sim.opts
    with jax.default_matmul_precision("highest"):
        got = jax.jit(lambda s, sd: CF.interaction_forces(
            csp, opts, sd, s.pos, s.vel, s.rho, s.code,
            state_sorted=True))(st, c.sdiv)

        def bucket(s):
            div, code = cd.divide(sim.dom, s.pos, s.code)
            return F.interaction_forces(csp, opts, div, s.pos, s.vel, s.rho,
                                        eos.press_from_rho(csp, s.rho), code)
        ref = jax.jit(bucket)(st)
    worst = 0.0
    for name, a, b in (("ace", got.ace, ref.ace), ("ar", got.ar, ref.ar)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = np.abs(b).max()
        err = np.abs(a - b)
        if not (err <= TOL * scale + TOL * np.abs(b)).all():
            fail(f"kernel {name} differs from the bucket path: max error "
                 f"{err.max():.3e} over scale {scale:.3e}")
        worst = max(worst, float(err.max() / scale))
    va, vb = float(got.viscdtmax), float(ref.viscdtmax)
    if abs(va - vb) > TOL * abs(vb):
        fail(f"viscdtmax kernel {va} vs bucket {vb}")
    vmax = float(jnp.max(jnp.abs(st.vel)))
    phase("3 kernel vs reference", f"np={st.n} after 50 steps (|v|max "
          f"{vmax:.3f} m/s): max error / max|field| = {worst:.3e} "
          f"(tolerance {TOL:g}), viscdtmax {va:.6e} vs {vb:.6e} [{card}]")


def phase_main_path(sim, card):
    """Simulation.run over 4 save intervals (~2000 steps)."""
    fl, front0, _, _, _ = fluid_stats(sim.carry.st)
    marks = []

    def on_save(s):
        jax.block_until_ready(s.carry.st.pos)
        marks.append((time.perf_counter(), int(s.carry.nstep)))

    t0 = time.perf_counter()
    sim.run(tmax=0.1, tout=0.025, on_save=on_save)
    wall = time.perf_counter() - t0
    c = sim.carry
    steps = [(b[1] - a[1], b[0] - a[0]) for a, b in zip(marks, marks[1:])]
    per = sorted(t / k for k, t in steps if k)
    nsteps = int(c.nstep) - marks[0][1]
    fl, front, rmin, rmax, finite = fluid_stats(c.st)
    if int(c.overflow) != 0:
        fail(f"overflow {int(c.overflow)}")
    if not finite:
        fail("non-finite particle state")
    if not (900.0 <= rmin and rmax <= 1100.0):
        fail(f"fluid density outside 1000 +-10%: [{rmin:.1f}, {rmax:.1f}]")
    if nsteps < 200:
        fail(f"only {nsteps} steps ran")
    # the collapsing column's front moves ~0.07 m by t = 0.1 s
    if not front > front0 + 0.02:
        fail(f"dam front did not advance: {front0:.4f} -> {front:.4f} m")
    p50 = per[len(per) // 2]
    phase("4 main path", f"Simulation.run t={sim.time:.3f} s, {nsteps} steps "
          f"in {wall:.1f} s, {sim.part} saves, overflow 0, rho "
          f"[{rmin:.1f}, {rmax:.1f}], front {front0:.4f} -> {front:.4f} m; "
          f"p50 step {p50 * 1e3:.3f} ms, "
          f"{c.st.n / p50:.4e} particle-steps/s [{card}]")


def phase_cli(card):
    from dualsphysics_multilayer import cli
    out = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        t0 = time.perf_counter()
        rc = cli.main(["-builtin", "dambreak3d", "-dp", str(DP),
                       "-tmax", "0.0005", "-tout", "0.0005",
                       "-dirout", out, "-sv:binx"])
        wall = time.perf_counter() - t0
        parts = sorted(f for f in os.listdir(out) if f.startswith("Part")
                       and f.endswith(".bi4"))
        if rc != 0 or len(parts) < 2:
            fail(f"cli rc={rc}, PART files {parts}")
        phase("5 cli", f"cli.main -builtin dambreak3d -dp {DP} rc=0, "
              f"{len(parts)} PART files ({', '.join(parts)}) in "
              f"{wall:.1f} s [{card}]")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def phase_other_cases(card):
    import bench
    msgs = []
    for name in ("waveflume", "floatingbox", "nnmud"):
        case, opts, step, carry = bench._build(name, 60_000)
        run20 = jax.jit(lambda c: jax.lax.fori_loop(
            0, 20, lambda i, cc: step(cc), c))
        t0 = time.perf_counter()
        carry = run20(carry)
        jax.block_until_ready(carry.st.pos)
        wall = time.perf_counter() - t0
        _, _, rmin, rmax, finite = fluid_stats(carry.st)
        if int(carry.overflow) != 0 or not finite or int(carry.nstep) != 20:
            fail(f"{name}: overflow {int(carry.overflow)}, finite {finite}, "
                 f"nstep {int(carry.nstep)}")
        msgs.append(f"{name} np={case.np_total} 20 steps ok "
                    f"(rho [{rmin:.1f}, {rmax:.1f}], {wall:.1f} s with "
                    f"compile)")
    phase("6 other cases", "; ".join(msgs) + f" [{card}]")


def dambreak_opts():
    return SolverOpts(tdensity=TpDensity.FOURTAKAS)


def run_multi(dp, ndev, interpret=False, nsteps=20):
    """The dam break through ShardedSimulation over ``ndev`` devices and
    through Simulation on one; returns a report line or raises."""
    from dualsphysics_multilayer.models.wcsph import make_step
    from dualsphysics_multilayer.models.wcsph import make_advance
    from dualsphysics_multilayer.parallel.sharding import (
        ShardedSimulation, make_sharded_advance)
    case = cases.dambreak3d(dp=dp, obstacle=True)
    opts = dambreak_opts()
    far = jnp.float32(1e3)

    sim1 = Simulation(case.csp, opts, case.dom, case.state)
    if interpret:
        sim1.advance = make_advance(case.csp, opts, case.dom, step=make_step(
            case.csp, opts, case.dom, path=sim1.path, interpret=True))
    c1 = sim1.advance(sim1.carry, far, jnp.int32(1))
    jax.block_until_ready(c1.st.pos)
    t0 = time.perf_counter()
    c1 = sim1.advance(c1, far, jnp.int32(nsteps + 1))
    jax.block_until_ready(c1.st.pos)
    t1 = time.perf_counter() - t0

    simn = ShardedSimulation(case.csp, opts, case.dom, case.state, ndev=ndev)
    if interpret:
        simn.advance = make_sharded_advance(simn.cfg, case.csp, opts,
                                            simn.mesh, path=simn.path,
                                            interpret=True)
    cn = simn.advance(simn.carry, far, jnp.int32(1))
    jax.block_until_ready(cn.st.pos)
    t0 = time.perf_counter()
    cn = simn.advance(cn, far, jnp.int32(nsteps + 1))
    jax.block_until_ready(cn.st.pos)
    tn = time.perf_counter() - t0

    def owned(c):
        code = np.asarray(c.st.code)
        live = np.asarray(td.is_active(code)) & (
            np.asarray(td.code_special(code)) != td.SPECIAL_PERIODIC)
        idp = np.asarray(c.st.idp)[live]
        o = np.argsort(idp)
        return idp[o], np.asarray(c.st.pos)[live][o]

    for c, nm in ((c1, "one device"), (cn, f"{ndev} devices")):
        if int(c.overflow) != 0:
            raise RuntimeError(f"{nm}: overflow {int(c.overflow)}")
        if int(c.nstep) != nsteps + 1:
            raise RuntimeError(f"{nm}: {int(c.nstep)} steps")
    id1, p1 = owned(c1)
    idn, pn = owned(cn)
    if len(id1) != len(idn) or not (id1 == idn).all():
        raise RuntimeError(f"live particles differ: {len(id1)} vs {len(idn)}")
    err = float(np.abs(p1 - pn).max())
    # f32 sums in another order (halo ghosts, per-shard sort) drift apart
    # by far less than dp in 20 steps
    if not err < 1e-4 * case.csp.dp:
        raise RuntimeError(f"positions differ by {err:.3e} m "
                           f"(limit 1e-4*dp = {1e-4 * case.csp.dp:.3e})")
    return (f"dam break np={case.np_total} path={simn.path}, {nsteps} steps: "
            f"{ndev} devices {tn:.3f} s, one device {t1:.3f} s; overflow 0, "
            f"live particles {len(id1)} on both, max |dpos| {err:.3e} m "
            f"(limit 1e-4*dp = {1e-4 * case.csp.dp:.3e} m)")


def main(argv):
    multi = "--multi" in argv
    ncards = 4 if multi else 1
    dev = phase_device(ncards)
    enable_cache()
    card = gpu_name_power()
    if multi:
        try:
            phase("multi", run_multi(DP_MULTI, 4) + f" [{card}]")
        except RuntimeError as e:
            fail(f"multi: {e}")
        dev = device_record()
    else:
        case = cases.dambreak3d(dp=DP, obstacle=True)
        sim = Simulation(case.csp, dambreak_opts(), case.dom, case.state,
                         log=lambda *a: None)
        if sim.path != "cellforce":
            fail(f"the GPU run selected path {sim.path}, not cellforce")
        phase_compile(sim, card)
        phase_kernel_vs_reference(sim, card)
        phase_main_path(sim, card)
        phase_cli(card)
        phase_other_cases(card)
    print(json.dumps({"ok": True, "device": dev}))


if __name__ == "__main__":
    main(sys.argv[1:])
