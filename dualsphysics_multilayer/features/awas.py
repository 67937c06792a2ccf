"""Per-step AWAS: active wave absorption for piston wavemakers.

Re-design of the reference AWAS (`JWaveGen.h:148-164` PaddleUseAwas +
`JSphInOutVelAwas` / v5.0 `JWaveAwasZsurf`; configured by `<awas_zsurf>` in
`_FmtXML_WavePaddlesAwas.xml`): every step, the free-surface elevation is
measured just in front of the paddle and compared with the target wave; the
velocity correction

    u_c = gain * sqrt(g / depth) * (eta_target(t) - eta_measured)

is integrated into an extra paddle displacement that absorbs re-reflected
waves.  The reference measures eta through the gauge system each step
(`JSph::CalcMotionWaveGen`, JSph.cpp:2327); here the measurement and the
correction both live INSIDE the jitted step (zero host round-trips):

* eta_measured = column-integrated fluid mass in a band around the gauge x,
  divided by rho0 * band width (the mass-threshold SWL measure reduced to a
  masked sum — O(n) elementwise, no neighbour structure needed);
* the accumulated correction is a per-paddle scalar in the step carry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph


@dataclass(frozen=True)
class AwasZsurf:
    """AWAS configuration for one piston paddle (mkbound ``mk``)."""
    mk: int
    height: float            # target wave height H
    period: float            # wave period T
    depth: float             # water depth at the paddle
    swl: float               # still-water level (z of the free surface)
    gauge_x: float           # gauge x position (world, in front of the paddle)
    start: float = 0.0       # time to start correcting
    gain: float = 1.0
    phase: float = 0.0       # paddle phase (piston theory x ~ sin(wt+phase))
    direction: tuple = (1.0, 0.0, 0.0)
    band: float = 0.0        # gauge band half-width (default 1.5 dp)
    z0: float = 0.0          # bed elevation below the gauge

    def eta_target(self, t, g=9.81):
        """1st-order target elevation at the paddle face: in phase with the
        paddle velocity (eta = H/2 sin(wt + phase) for x(t) ~ -cos)."""
        w = 2.0 * math.pi / self.period
        return 0.5 * self.height * jnp.sin(w * t + self.phase)


def measure_eta(cfg: AwasZsurf, csp: CteSph, pos, code):
    """Column-mass surface elevation at the gauge (relative to the SWL)."""
    dp = csp.dp
    band = cfg.band or 1.5 * dp
    fluid = td.is_fluid(code) & td.is_active(code)
    inband = fluid & (jnp.abs(pos[:, 0] - cfg.gauge_x) <= band)
    if csp.simulate2d:
        colarea = 2.0 * band          # per unit y
        mass_per = csp.dp ** 2        # volume per particle per unit y
    else:
        # restrict to a dp-wide y band through the gauge line
        inband = inband & (jnp.abs(pos[:, 1] - 0.0) <= 0.5 * dp)
        colarea = 2.0 * band * dp
        mass_per = csp.dp ** 3
    h_col = jnp.sum(jnp.where(inband, mass_per, 0.0)) / colarea
    return h_col - (cfg.swl - cfg.z0)   # elevation above the SWL


def apply_awas(cfgs, csp: CteSph, corr, tabs, dt, pos, vel, code, g=9.81):
    """One AWAS update for all paddles.  ``corr`` is the carried (P,) array
    of accumulated correction displacements.  Returns (pos, vel, corr)."""
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    new_corr = []
    for i, cfg in enumerate(cfgs):
        eta = measure_eta(cfg, csp, pos, code)
        uc = cfg.gain * math.sqrt(g / cfg.depth) * (cfg.eta_target(tabs) - eta)
        uc = jnp.where(tabs >= cfg.start, uc, 0.0)
        d = jnp.asarray(cfg.direction, vel.dtype)
        sel = moving & (mkv == cfg.mk)
        pos = jnp.where(sel[:, None], pos + (uc * dt) * d[None, :], pos)
        vel = jnp.where(sel[:, None], vel + uc * d[None, :], vel)
        new_corr.append(corr[i] + uc * dt)
    return pos, vel, jnp.stack(new_corr)
