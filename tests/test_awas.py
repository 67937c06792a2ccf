"""Per-step AWAS tests (reference JWaveGen AWAS / awas_zsurf)."""

import jax.numpy as jnp
import numpy as np

import dualsphysics_multilayer.typesdef as td
from dualsphysics_multilayer.features.awas import AwasZsurf, measure_eta
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.features import wavegen as WG
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity, make_ctesph


def test_measure_eta_column():
    """Column-mass elevation: a uniform dp lattice of depth d reads eta=0;
    one extra layer reads eta=+dp."""
    dp = 0.02
    csp = make_ctesph(simulate2d=True, dp=dp, speedsound=10.0)
    depth = 0.3
    nz = int(round(depth / dp))
    xcols = np.arange(-3, 4) * dp  # 7 columns around the gauge at x=0
    xs, zs = np.meshgrid(xcols, (np.arange(nz) + 0.5) * dp)
    pos = np.stack([xs.ravel(), np.zeros(xs.size), zs.ravel()], axis=1)
    code = np.full(len(pos), td.code_make(td.TYPE_FLUID, 0), np.uint32)
    cfg = AwasZsurf(mk=10, height=0.1, period=1.0, depth=depth, swl=depth,
                    gauge_x=0.0, band=1.5 * dp)
    eta = float(measure_eta(cfg, csp, jnp.asarray(pos, jnp.float32),
                            jnp.asarray(code)))
    # 3 columns inside the band (|x| <= 1.5 dp), each nz*dp of water
    assert abs(eta) < 0.02 * depth, eta
    # one more layer on the in-band columns -> eta ~ +dp
    extra = np.stack([xcols[2:5], np.zeros(3),
                      np.full(3, (nz + 0.5) * dp)], axis=1)
    pos2 = np.concatenate([pos, extra])
    code2 = np.full(len(pos2), td.code_make(td.TYPE_FLUID, 0), np.uint32)
    eta2 = float(measure_eta(cfg, csp, jnp.asarray(pos2, jnp.float32),
                             jnp.asarray(code2)))
    assert abs(eta2 - dp) < 0.25 * dp, eta2


def test_awas_still_water_stays_still():
    """AWAS with a zero-height target on still water applies (almost) no
    correction, and the run stays stable."""
    depth = 0.25
    dp = 0.025
    case = cases.waveflume2d(dp=dp, flume=(1.2, 0.7), water=depth,
                             piston_freq=1.0, piston_amp=0.0, coefsound=10.0)
    awas = AwasZsurf(mk=10, height=0.0, period=1.2, depth=depth, swl=depth,
                     gauge_x=5 * dp, start=0.0)
    feats = Features(awas=(awas,))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    sim.run(tmax=0.4, tout=0.2)
    corr = float(np.asarray(sim.carry.awas)[0])
    # the correction never exceeds a fraction of dp on still water
    assert abs(corr) < 1.0 * dp, corr
    assert int(sim.carry.overflow) == 0
