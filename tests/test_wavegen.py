"""Wave generation tests: dispersion/Biesel closed forms + generated wave
height validation in a 2D flume."""

import numpy as np
import pytest

from dualsphysics_multilayer.features import wavegen as WG
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.features.gauges import GaugeSwl, GaugeSystem
from dualsphysics_multilayer.features.damping import DampingPlane
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity


def test_dispersion_limits():
    # deep water: k -> w^2/g
    k = WG.dispersion_k(period=2.0, depth=100.0)
    w = 2 * np.pi / 2.0
    assert abs(k - w * w / 9.81) / k < 1e-6
    # shallow water: c -> sqrt(g d)
    c = WG.wave_celerity(period=20.0, depth=0.5)
    assert abs(c - np.sqrt(9.81 * 0.5)) / c < 0.02


def test_biesel_shallow_limit():
    """kd -> 0: H/S -> kd (piston moves nearly as much as the wave is high
    times 1/kd)."""
    stroke, k = WG.biesel_piston(height=0.1, period=12.0, depth=0.5)
    kd = k * 0.5
    hs = 0.1 / stroke
    assert abs(hs - (2 * np.sinh(kd) ** 2
                     / (np.sinh(kd) * np.cosh(kd) + kd))) < 1e-9
    assert stroke > 0.1  # shallow water: stroke exceeds wave height


@pytest.mark.slow
def test_flume_generates_target_wave():
    """Piston waves in a small 2D flume: measured crest-to-trough height at a
    gauge ~0.5 wavelength downstream within a coarse band of the target.

    ~8k solver steps — too slow for the default CPU suite (marked slow;
    run with ``pytest -m slow``)."""
    H, T, depth = 0.1, 1.4, 0.35     # H = 5 dp (resolvable), H/L ~ 0.044
    dp = 0.02
    L = 2 * np.pi / WG.dispersion_k(T, depth)
    case = cases.waveflume2d(dp=dp, flume=(1.1 * L, 0.9), water=depth,
                             piston_freq=1.0 / T, piston_amp=0.0,
                             coefsound=10.0)
    motion = WG.piston_waves(10, height=H, period=T, depth=depth, order=2)
    feats = Features(
        motions=(motion,),
        damping=(DampingPlane(point=(0.72 * L, 0, 0),
                              limitpoint=(1.05 * L, 0, 0)),))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    gauge_x = 0.5 * L
    gs = GaugeSystem(case.csp, case.dom, gauges=(
        GaugeSwl("eta", (float(gauge_x), 0, 0), (float(gauge_x), 0, 0.9),
                 dp / 2),))
    etas = []

    def on_save(s):
        out = gs.run(s.time, s.state)
        etas.append((s.time, out["eta"][2]))

    sim.run(tmax=2.6 * T, tout=T / 12, on_save=on_save)
    t = np.array([e[0] for e in etas])
    z = np.array([e[1] for e in etas])
    # measure once the first crest has passed the gauge (arrival ~0.65 T)
    sel = t > 1.4 * T
    hmeas = z[sel].max() - z[sel].min()
    assert 0.5 * H < hmeas < 1.8 * H, (hmeas, H)
    # mean level stays near still-water depth
    assert abs(z[sel].mean() - depth) < 0.08 * depth


# ---------------------------------------------------------------------------
# Closed-lib paddle-trajectory goldens (libjwavegen via the rebuilt binary)
# ---------------------------------------------------------------------------
# Samples of WavePaddle_mkb0010.csv written by JWavePaddle::SaveMotion for
# H=0.08 T=1.2 d=0.3, order 2, ramp 1 period, phase 0: piston displacement
# [m] and flap angle [rad] (hinge at the bottom, draft 0).  These pinned the
# quartic startup ramp tau^2(3tau^2-8tau+6) (JWaveRegular::CalcFunRamp), the
# sin(wt+phase) phase convention, Madsen's 2nd-order piston amplitude and
# the flap CalcCtePos2nd branch; our trajectories matched the full 7.2 s
# table to <=1.1e-6 when recorded.

_GOLD_PISTON = [
    (0.05, 0.000099), (0.15, 0.002165), (0.3, 0.010062), (0.45, 0.012949),
    (0.6, 0.0), (0.75, -0.022830), (0.9, -0.036493), (1.05, -0.027265),
    (1.2, 0.0), (1.5, 0.038445), (4.5, -0.038445), (7.2, 0.0),
]
_GOLD_FLAP = [
    (0.05, 0.000583), (0.15, 0.012809), (0.3, 0.060718), (0.45, 0.079716),
    (0.6, 0.0), (0.75, -0.140544), (0.9, -0.220216), (1.05, -0.161284),
    (1.2, 0.0), (1.5, 0.231997), (4.5, -0.231997), (7.2, 0.0),
]


def test_piston_trajectory_matches_closed_lib():
    from dualsphysics_multilayer.features.motion import _segment_disp_vel
    md = WG.piston_waves(10, height=0.08, period=1.2, depth=0.3, order=2,
                         phase=0.0, gain=1.0, ramp=1.0)
    for t, ref in _GOLD_PISTON:
        x = sum(float(_segment_disp_vel(s, 0.0, t)[0][0])
                for s in md.segments)
        assert abs(x - ref) < 2e-6, (t, x, ref)


def test_flap_trajectory_matches_closed_lib():
    from dualsphysics_multilayer.features.motion import _segment_angle
    md = WG.flap_waves(10, height=0.08, period=1.2, depth=0.3, draft=0.0,
                       axis_p0=(0, -1, 0), axis_p1=(0, 1, 0), phase=0.0,
                       gain=1.0, ramp=1.0, order=2)
    for t, ref in _GOLD_FLAP:
        a = sum(float(_segment_angle(s, 0.0, t)[0]) for s in md.segments)
        assert abs(a - ref) < 3e-6, (t, a, ref)


_GOLD_SOLITARY = [
    (0.2, 0.000462), (0.6, 0.007249), (1.0, 0.062822), (1.2, 0.134087),
    (1.4, 0.222815), (1.6, 0.300832), (1.8, 0.348600), (2.0, 0.369216),
    (2.4, 0.378389), (2.65, 0.379092),
]


def test_solitary_trajectory_matches_closed_lib():
    """Goring (1978) implicit paddle law vs the closed-lib 3 s golden run
    (H=0.09 d=0.3 theory=2): matched to <=5e-5 m when recorded; stroke
    0.379094, generation time 2.65141 s."""
    ts, X, _ = WG.solitary_paddle_series(0.09, 0.3, theory=2,
                                         durationcoef=1.0)
    assert abs(X[-1] - 0.379094) < 2e-5
    assert abs(ts[-1] - 2.65141) < 2e-4
    for t, ref in _GOLD_SOLITARY:
        x = float(np.interp(t, ts, X))
        assert abs(x - ref) < 2e-4, (t, x, ref)
