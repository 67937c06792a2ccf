"""The fused bucketed force pass must match the naive O(N^2) oracle built
straight from the reference equations (JSphCpu.cpp:548-822)."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.ops import celldiv as cd
from dualsphysics_multilayer.ops import eos
from dualsphysics_multilayer.ops import forces as F
from dualsphysics_multilayer.typesdef import (
    TpDensity, TpKernel, TpShifting, TpVisco, make_ctesph,
)

from ref_naive import naive_forces


def make_cloud(n=120, seed=0, sim2d=False, dp=0.05):
    """Jittered near-lattice cloud of fluid + a bound wall."""
    rng = np.random.default_rng(seed)
    side = 0.5
    nb = n // 4
    nf = n - nb
    pos = np.zeros((n, 3))
    # bound wall at z ~ 0
    pos[:nb, 0] = rng.uniform(0, side, nb)
    pos[:nb, 1] = 0.0 if sim2d else rng.uniform(0, side, nb)
    pos[:nb, 2] = rng.uniform(-dp, 0, nb)
    # fluid above
    pos[nb:, 0] = rng.uniform(0, side, nf)
    pos[nb:, 1] = 0.0 if sim2d else rng.uniform(0, side, nf)
    pos[nb:, 2] = rng.uniform(0, side / 2, nf)
    vel = rng.normal(0, 0.5, (n, 3))
    if sim2d:
        vel[:, 1] = 0.0
    vel[:nb] = 0.0
    rho = rng.uniform(980, 1050, n)
    code = np.array([td.code_make(td.TYPE_FIXED, 0)] * nb
                    + [td.code_make(td.TYPE_FLUID, 0)] * nf, np.uint32)
    return pos, vel, rho, code, nb


def run_both(csp, opts, pos, vel, rho, code, spstau=None, cellcap=64):
    press = np.asarray(eos.press_from_rho(csp, jnp.asarray(rho))).astype(np.float64)
    want = naive_forces(csp, opts, pos, vel, rho, press, code,
                        spstau=spstau)
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, csp.kernelsize,
                         simulate2d=csp.simulate2d, cellcap=cellcap)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32),
                       jnp.asarray(code))
    assert int(div.overflow) == 0
    got = F.interaction_forces(
        csp, opts, div, jnp.asarray(pos, jnp.float32),
        jnp.asarray(vel, jnp.float32), jnp.asarray(rho, jnp.float32),
        jnp.asarray(press, jnp.float32), jnp.asarray(code),
        spstau=None if spstau is None else jnp.asarray(spstau, jnp.float32))
    return want, got


def assert_close(want, got, rtol=2e-3):
    scale_ace = np.abs(want["ace"]).max() + 1e-6
    np.testing.assert_allclose(np.asarray(got.ace), want["ace"],
                               atol=rtol * scale_ace, rtol=rtol)
    scale_ar = np.abs(want["ar"]).max() + 1e-6
    np.testing.assert_allclose(np.asarray(got.ar), want["ar"],
                               atol=rtol * scale_ar, rtol=rtol)
    assert np.isclose(float(got.viscdtmax), want["viscdtmax"],
                      rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("sim2d", [False, True])
@pytest.mark.parametrize("tdensity", [TpDensity.NONE, TpDensity.MOLTENI,
                                      TpDensity.FOURTAKAS,
                                      TpDensity.FOURTAKAS_FULL])
def test_forces_artificial(sim2d, tdensity):
    csp = make_ctesph(simulate2d=sim2d, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tvisco=TpVisco.ARTIFICIAL, tdensity=tdensity)
    pos, vel, rho, code, nb = make_cloud(sim2d=sim2d)
    want, got = run_both(csp, opts, pos, vel, rho, code)
    assert_close(want, got)


def test_forces_cubic_kernel():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05,
                      tkernel=TpKernel.CUBIC)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    pos, vel, rho, code, nb = make_cloud(seed=2)
    want, got = run_both(csp, opts, pos, vel, rho, code)
    assert_close(want, got, rtol=4e-3)


def test_forces_laminar_sps():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=1e-4,
                      tvisco=TpVisco.LAMINAR_SPS)
    opts = F.SolverOpts(tvisco=TpVisco.LAMINAR_SPS, tdensity=TpDensity.NONE)
    pos, vel, rho, code, nb = make_cloud(seed=3)
    rng = np.random.default_rng(7)
    spstau = rng.normal(0, 1e-3, (pos.shape[0], 6))
    spstau[:nb] = 0.0
    want, got = run_both(csp, opts, pos, vel, rho, code, spstau=spstau)
    assert_close(want, got)
    scale = np.abs(want["gradvel"]).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got.spsgradvel), want["gradvel"],
                               atol=2e-3 * scale, rtol=2e-3)


def test_forces_shifting_accumulators():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS,
                        shiftmode=TpShifting.NO_BOUND)
    pos, vel, rho, code, nb = make_cloud(seed=4)
    want, got = run_both(csp, opts, pos, vel, rho, code)
    assert_close(want, got)
    scale = np.abs(want["shiftposfs"]).max() + 1e-9
    np.testing.assert_allclose(np.asarray(got.shiftposfs), want["shiftposfs"],
                               atol=2e-3 * scale, rtol=2e-3)
    np.testing.assert_array_equal(np.asarray(got.shift_blocked),
                                  want["shift_blocked"])


def test_forces_viscoboundfactor():
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05,
                      viscoboundfactor=0.3)
    opts = F.SolverOpts(tdensity=TpDensity.NONE)
    pos, vel, rho, code, nb = make_cloud(seed=5)
    want, got = run_both(csp, opts, pos, vel, rho, code)
    assert_close(want, got)


def test_momentum_conservation_fluid_only():
    """Sum of m*ace over an all-fluid cloud vanishes (pairwise antisymmetry of
    the pressure + artificial viscosity operators)."""
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.NONE)
    rng = np.random.default_rng(11)
    n = 200
    pos = rng.uniform(0, 0.4, (n, 3))
    vel = rng.normal(0, 0.3, (n, 3))
    rho = rng.uniform(990, 1020, n)
    code = np.full(n, td.code_make(td.TYPE_FLUID, 0), np.uint32)
    press = np.asarray(eos.press_from_rho(csp, jnp.asarray(rho)))
    dom = cd.make_domain((-.01,) * 3, (0.41,) * 3, csp.kernelsize, cellcap=64)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32), jnp.asarray(code))
    got = F.interaction_forces(csp, opts, div, jnp.asarray(pos, jnp.float32),
                               jnp.asarray(vel, jnp.float32),
                               jnp.asarray(rho, jnp.float32),
                               jnp.asarray(press, jnp.float32),
                               jnp.asarray(code))
    total = np.asarray(got.ace).sum(axis=0) * csp.massfluid
    scale = np.abs(np.asarray(got.ace)).max() * csp.massfluid
    assert np.all(np.abs(total) < 1e-3 * scale * n ** 0.5)


def test_symmetry_matches_full_domain():
    """vs_syymmetry: forces from a half-domain run with the y=0 mirror pass
    equal the full-domain forces on the y>0 particles (the property the
    reference's rsym plumbing implements, JSphCpu.cpp:631-822)."""
    from dualsphysics_multilayer.typesdef import make_ctesph
    dp = 0.05
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=0.25, visco=0.05)
    xs = np.arange(dp / 2, 0.4, dp)
    ys = np.arange(dp / 2, 0.3, dp)
    zs = np.arange(dp / 2, 0.3, dp)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    half = np.column_stack([X.ravel(), Y.ravel(), Z.ravel()])
    mirror = half * np.array([1.0, -1.0, 1.0])
    full = np.concatenate([half, mirror])

    def vel_of(p):
        # y-symmetric field: vx,vz even in y, vy odd in y
        return np.column_stack([
            0.3 * np.sin(6 * p[:, 2]), 0.25 * p[:, 1],
            0.2 * np.cos(5 * p[:, 0])])

    def forces(pos, symmetry):
        n = len(pos)
        code = np.full(n, td.code_make(td.TYPE_FLUID, 0), np.uint32)
        # a couple of bound rows at the bottom exercise the bound branches
        code[pos[:, 2] < dp] = td.code_make(td.TYPE_FIXED, 0)
        rho = np.full(n, 1000.0, np.float32) + 5 * np.sin(
            4 * pos[:, 0]).astype(np.float32)
        vel = vel_of(pos).astype(np.float32)
        press = eos.press_from_rho(csp, jnp.asarray(rho))
        dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                             csp.kernelsize, cellcap=96)
        div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32),
                           jnp.asarray(code))
        opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS, symmetry=symmetry)
        fr = F.interaction_forces(csp, opts, div, jnp.asarray(pos, jnp.float32),
                                  jnp.asarray(vel), jnp.asarray(rho), press,
                                  jnp.asarray(code))
        return np.asarray(fr.ace), np.asarray(fr.ar)

    ace_h, ar_h = forces(half, symmetry=True)
    ace_f, ar_f = forces(full, symmetry=False)
    nh = len(half)
    scale = np.abs(ace_f[:nh]).max()
    np.testing.assert_allclose(ace_h, ace_f[:nh], atol=2e-4 * scale)
    np.testing.assert_allclose(ar_h, ar_f[:nh],
                               atol=2e-4 * np.abs(ar_f[:nh]).max())


def test_ddt_ramp_traced():
    """-ddtramp (RunInitialDDTRamp, JSphCpuSingle.cpp:650-663): while
    t<=tmaxvalue the DDT constant is maxvalue, blending linearly down to
    DDTValue at t=tramp, plain DDTValue afterwards — computed as a traced
    scalar inside the step (no recompiles)."""
    from dualsphysics_multilayer.models.wcsph import _interaction

    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    pos, vel, rho, code, nb = make_cloud(n=100)
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01, csp.kernelsize,
                         cellcap=64)
    press = eos.press_from_rho(csp, jnp.asarray(rho, jnp.float32))

    def forces_at(tabs, ramp):
        opts = F.SolverOpts(tdensity=TpDensity.MOLTENI, ddtramp=ramp)
        from dualsphysics_multilayer.models.wcsph import SimState
        st = SimState(pos=jnp.asarray(pos, jnp.float32),
                      vel=jnp.asarray(vel, jnp.float32),
                      rho=jnp.asarray(rho, jnp.float32),
                      code=jnp.asarray(code),
                      idp=jnp.arange(len(pos), dtype=jnp.uint32))
        _, _, fr = _interaction(csp, opts, dom, st, tabs=jnp.float32(tabs))
        return np.asarray(fr.ar)

    def forces_ddtkh(ddtkh):
        opts = F.SolverOpts(tdensity=TpDensity.MOLTENI)
        div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32),
                           jnp.asarray(code))
        fr = F.interaction_forces(
            csp, opts, div, jnp.asarray(pos, jnp.float32),
            jnp.asarray(vel, jnp.float32), jnp.asarray(rho, jnp.float32),
            press, jnp.asarray(code), ddtkh=jnp.float32(ddtkh))
        return np.asarray(fr.ar)

    ramp = (0.5, 0.1, 1.0)       # tramp, tmaxvalue, maxvalue
    ks = csp.kernelsize
    # plateau: t<=tmaxvalue -> maxvalue
    np.testing.assert_allclose(forces_at(0.05, ramp), forces_ddtkh(ks * 1.0),
                               rtol=1e-6)
    # halfway through the blend: t=0.3 -> ((0.5-0.3)/0.4)*(1.0-v)+v
    v = csp.ddtvalue
    mid = ((0.5 - 0.3) / 0.4) * (1.0 - v) + v
    np.testing.assert_allclose(forces_at(0.3, ramp), forces_ddtkh(ks * mid),
                               rtol=1e-5)
    # after the ramp: plain ddtvalue
    np.testing.assert_allclose(forces_at(0.7, ramp), forces_ddtkh(ks * v),
                               rtol=1e-6)


def test_cell_chunked_matches_unchunked():
    """opts.cell_chunk (the bucket path's lax.map memory bound, needed at
    10M scale where one pass wants ~400 GB of (cells, K, K) temporaries)
    must reproduce the single-pass result exactly."""
    import dataclasses
    from dualsphysics_multilayer.ops import celldiv as cd
    from dualsphysics_multilayer.ops import eos
    csp = make_ctesph(simulate2d=False, dp=0.05, hswl=0.25, visco=0.05)
    opts = F.SolverOpts(tdensity=TpDensity.FOURTAKAS)
    pos, vel, rho, code, nb = make_cloud(n=160, seed=61)
    dom = cd.make_domain(pos.min(0) - 0.01, pos.max(0) + 0.01,
                         csp.kernelsize, cellcap=32)
    div, code2 = cd.divide(dom, jnp.asarray(pos), jnp.asarray(code))
    press = eos.press_from_rho(csp, jnp.asarray(rho))
    args = (jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(rho),
            press, code2)
    f0 = F.interaction_forces(csp, opts, div, *args)
    f1 = F.interaction_forces(csp, dataclasses.replace(opts, cell_chunk=7),
                              div, *args)
    # same math, different XLA schedule: f32 reassociation only
    sc = np.abs(np.asarray(f0.ace)).max() + 1e-6
    np.testing.assert_allclose(np.asarray(f1.ace), np.asarray(f0.ace),
                               rtol=2e-4, atol=2e-4 * sc)
    sr = np.abs(np.asarray(f0.ar)).max() + 1e-6
    np.testing.assert_allclose(np.asarray(f1.ar), np.asarray(f0.ar),
                               rtol=2e-4, atol=2e-4 * sr)
    assert np.isclose(float(f1.viscdtmax), float(f0.viscdtmax), rtol=1e-4)
