"""Relaxation zones: blend fluid velocity toward an analytic wave/current.

Re-design of the reference relaxation-zone machinery (`JRelaxZones.h` +
closed lib; in-tree GPU kernels `JRelaxZone_ker.cu` — uniform `:58`, regular
wave `KerSetFluidVel :145`, spectrum `KerSetFluidVelSpectrumSub :250`,
external `KerSetFluidVelExternal :374`, SURVEY §2.11): inside a zone, each
fluid particle's velocity is relaxed toward a target field,

    v <- f * v_target + (1 - f) * v_sph,

with the reference's tanh bump weight over the normalized distance
``vdis = (x - center_x) / widthhalf`` in [-1, 1]
(`JRelaxZone_ker.cu:161-162`):

    f = (tanh((vdis+a)b) - tanh((vdis-a)b) - fsub) / fdiv,
    fsub = tanh((1+a)b) - tanh((1-a)b),
    fdiv = tanh(a b) - tanh(-a b) - fsub,

which is 1 at the zone center and 0 at both edges; ``a``/``b`` are the XML
``<function psi beta>`` coefficients.  ``coefdt`` turns the blend into a
rate: the applied fraction is ``f * min(coefdt * dt, 1)``
(`_FmtXML_RelaxationZones.xml` "multiplies by dt value").

Targets:

* ``RelaxZoneRegular`` — 1st/2nd-order regular wave velocities
  (`KerCalcVelocityX/Z`, JRelaxZone_ker.cu:113-141):
  u = (wH/2) cosh(k(d+z))/sinh(kd) cos(wt + phi - kx) [+ 2nd-order term],
  w = -(wH/2) sinh(k(d+z))/sinh(kd) sin(wt + phi - kx), with optional
  Stokes-drift compensation u -= dc*(kH/2)^2 c cosh(2k(d+z))/(2 sinh^2(kd))
  (the `subdrift` branch's ctd*cosh(ctd2*(d+z)) with ctd2 = 2k).
* ``RelaxZoneSpectrum`` — irregular (JONSWAP / Pierson-Moskowitz) component
  sum (`KerCalcVelxzSpectrum`, JRelaxZone_ker.cu:215-235), components from
  `wavegen.spectrum_components` (regular/random/stretched/cosstretched
  discretizations), per-component Stokes drift compensation.
* ``RelaxZoneExternal`` — external (SWASH) velocity data on a (t, x, z)
  grid, sampled like the inout `gridveldata` channel
  (`KerCalcVelocityExternalXZ` bilinear + time-linear interpolation).
* ``RelaxZoneUniform`` — constant or time-tabled velocity in a box
  (`KerSetFluidVelUniform`; XML `<rz_uniform>` with `<velocitytimes>`).

Applied after the corrector, the same hook the reference uses
(`JSphCpuSingle.cpp:715-718` runs damping/relax after ComputeSymplecticCorr).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph


def _fweight(vdis, falpha=0.9, fbeta=1.0):
    """Reference tanh bump weight (JRelaxZone_ker.cu:161): 1 at vdis=0,
    0 at |vdis|=1."""
    a, b = falpha, fbeta
    fsub = math.tanh((1 + a) * b) - math.tanh((1 - a) * b)
    fdiv = math.tanh(a * b) - math.tanh(-a * b) - fsub
    f = (jnp.tanh((vdis + a) * b) - jnp.tanh((vdis - a) * b) - fsub) / fdiv
    return jnp.clip(f, 0.0, 1.0)


def _window(tabs, start, duration):
    """Active-time gate: start <= t (< start+duration when duration>0)."""
    on = jnp.asarray(tabs) >= start
    if duration > 0:
        on &= jnp.asarray(tabs) <= start + duration
    return on


@dataclass(frozen=True)
class RelaxZoneUniform:
    """Blend toward a constant / time-tabled velocity inside a box
    (reference `KerSetFluidVelUniform`, JRelaxZone_ker.cu:58; XML
    `<rz_uniform>` with optional `<velocitytimes>`)."""
    pmin: tuple
    pmax: tuple
    vel: tuple = (0.0, 0.0, 0.0)
    veltimes: tuple = ()       # velocitytimes table: times
    velvalues: tuple = ()      # velocitytimes table: speeds along direction
    direction: tuple = (1.0, 0.0, 0.0)
    axis: int = 0              # blend coordinate axis (box direction axis)
    falpha: float = 0.9        # <function psi>
    fbeta: float = 1.0         # <function beta>
    coefdt: float = 1000.0
    start: float = 0.0
    duration: float = 0.0
    # Oriented (rotated) domain box, reference plane form (dompla1..3 +
    # sizes, KerSetFluidVelUniform JRelaxZone_ker.cu:60-73).  When `axes`
    # is set, membership is 0 < (p-pmin)@e_i < sizes_i with e_i the rotated
    # unit axes; pmin is then the rotated box origin corner.
    axes: tuple = None         # ((e1),(e2),(e3)) unit vectors or None
    sizes: tuple = None        # box extents along axes (used with `axes`)

    def target_and_weight(self, csp, pos, tabs):
        if self.axes is not None:
            org = jnp.asarray(self.pmin, pos.dtype)
            inside = jnp.ones(pos.shape[0], bool)
            for ax in range(3):
                if csp.simulate2d and ax == 1:
                    continue
                e = jnp.asarray(self.axes[ax], pos.dtype)
                d = (pos - org) @ e
                inside &= (d >= 0.0) & (d <= self.sizes[ax])
            half = max(0.5 * self.sizes[self.axis], 1e-12)
            cen = org + 0.5 * sum(
                self.sizes[i] * jnp.asarray(self.axes[i], pos.dtype)
                for i in range(3))
            dirn = jnp.asarray(self.direction, pos.dtype)
            dirn = dirn / jnp.maximum(jnp.linalg.norm(dirn), 1e-12)
            vdis = ((pos - cen) @ dirn) / half
        else:
            inside = jnp.ones(pos.shape[0], bool)
            for ax in range(3):
                if csp.simulate2d and ax == 1:
                    continue
                inside &= (pos[:, ax] >= self.pmin[ax]) \
                    & (pos[:, ax] <= self.pmax[ax])
            c = 0.5 * (self.pmin[self.axis] + self.pmax[self.axis])
            half = max(0.5 * (self.pmax[self.axis] - self.pmin[self.axis]),
                       1e-12)
            vdis = (pos[:, self.axis] - c) / half
        f = jnp.where(inside, _fweight(vdis, self.falpha, self.fbeta), 0.0)
        f = jnp.where(_window(tabs, self.start, self.duration), f, 0.0)
        if self.veltimes:
            sp = jnp.interp(jnp.asarray(tabs, pos.dtype),
                            jnp.asarray(self.veltimes, pos.dtype),
                            jnp.asarray(self.velvalues, pos.dtype))
            tgt = sp * jnp.broadcast_to(
                jnp.asarray(self.direction, pos.dtype), pos.shape)
        else:
            tgt = jnp.broadcast_to(jnp.asarray(self.vel, pos.dtype),
                                   pos.shape)
        return tgt, f


@dataclass(frozen=True)
class RelaxZoneRegular:
    """Blend toward a 1st/2nd-order regular wave (reference `KerSetFluidVel`
    + `KerCalcVelocityX/Z`, JRelaxZone_ker.cu:113-176; XML
    `<rzwaves_regular>`)."""
    center: tuple             # central point of application (x0, y0, z0)
    width: float              # zone width (zone = center ± width/2)
    height: float             # wave height H
    period: float             # wave period T
    depth: float              # water depth d
    swl: float = 0.0          # still-water level (absolute z)
    order2: bool = False      # 2nd-order Stokes term
    phase: float = 0.0        # initial phase (radians)
    ramp: float = 0.0         # periods of initial ramp
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    start: float = 0.0
    duration: float = 0.0
    g: float = 9.81

    def target_and_weight(self, csp, pos, tabs):
        from .wavegen import dispersion_k
        k = dispersion_k(self.period, self.depth, self.g)
        w = 2.0 * math.pi / self.period
        half = max(0.5 * self.width, 1e-12)
        px = pos[:, 0] - self.center[0]
        vdis = px / half
        tw = jnp.maximum(jnp.asarray(tabs) - self.start, 0.0)
        # framp: linear startup over `ramp` wave periods
        framp = jnp.clip(tw / (self.ramp * self.period), 0.0, 1.0) \
            if self.ramp > 0 else 1.0
        z = pos[:, 2] - self.swl          # z=0 at SWL (reference pzd)
        cta = w * tw + self.phase
        sinh_kd = math.sinh(k * self.depth)
        wpf = 0.5 * self.height * w
        coshz = jnp.cosh(k * (self.depth + z))
        sinhz = jnp.sinh(k * (self.depth + z))
        u = wpf * coshz * jnp.cos(cta - k * px) / sinh_kd
        wv = -wpf * sinhz * jnp.sin(cta - k * px) / sinh_kd
        if self.order2:
            # 3/4 (pi H/L)^2 ce cosh(2k(d+z)) cos(2 cta - 2 k x)/sinh^4(kd)
            L = 2.0 * math.pi / k
            ce = self.g * self.period / (2.0 * math.pi) \
                * math.tanh(k * self.depth)
            ct2 = 0.75 * (math.pi * self.height / L) ** 2 * ce
            s4 = sinh_kd ** 4
            u = u + ct2 * jnp.cosh(2 * k * (self.depth + z)) \
                * jnp.cos(2 * cta - 2 * k * px) / s4
            wv = wv - ct2 * jnp.sinh(2 * k * (self.depth + z)) \
                * jnp.sin(2 * cta - 2 * k * px) / s4
        if self.driftcorrection:
            # Stokes-drift compensation: ctd cosh(2k(d+z)) with
            # ctd = dc (kH/2)^2 c / (2 sinh^2(kd))  (subdrift branch)
            ce = w / k
            ctd = self.driftcorrection * (0.5 * k * self.height) ** 2 \
                * ce / (2.0 * sinh_kd ** 2)
            u = u - ctd * jnp.cosh(2.0 * k * (self.depth + z))
        u = u * framp
        wv = wv * framp
        # coefdir = horizontal propagation direction: scales the horizontal
        # orbital component; the vertical component is direction-free
        tgt = jnp.stack([u * self.coefdir[0], u * self.coefdir[1], wv],
                        axis=-1)
        inside = jnp.abs(vdis) <= 1.0
        f = jnp.where(inside, _fweight(vdis, self.falpha, self.fbeta), 0.0)
        f = jnp.where(_window(tabs, self.start, self.duration), f, 0.0)
        return tgt.astype(pos.dtype), f


@dataclass(frozen=True)
class RelaxZoneSpectrum:
    """Blend toward an irregular (spectrum) wave field (reference
    `KerSetFluidVelSpectrumSub` + `KerCalcVelxzSpectrum`,
    JRelaxZone_ker.cu:215-330; XML `<rzwaves_spectrum>`)."""
    center: tuple
    width: float
    height: float             # significant wave height Hs
    period: float             # peak period Tp
    depth: float
    swl: float = 0.0
    spectrum: str = "jonswap"          # jonswap | pierson-moskowitz
    discretization: str = "stretched"  # regular|random|stretched|cosstretched
    peakcoef: float = 3.3
    waves: int = 50
    randomseed: int = 2
    serieini: float = 0.0
    ramptime: float = 0.0
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    start: float = 0.0
    duration: float = 0.0
    g: float = 9.81
    # component tables (filled by make_spectrum_zone; static tuples)
    comp_k: tuple = ()
    comp_amp: tuple = ()
    comp_w: tuple = ()
    comp_phase: tuple = ()

    def target_and_weight(self, csp, pos, tabs):
        half = max(0.5 * self.width, 1e-12)
        px = pos[:, 0] - self.center[0]
        vdis = px / half
        tw = jnp.maximum(jnp.asarray(tabs) - self.start, 0.0) + self.serieini
        framp = jnp.clip((tw - self.serieini) / self.ramptime, 0.0, 1.0) \
            if self.ramptime > 0 else 1.0
        z = pos[:, 2] - self.swl
        kl = jnp.asarray(self.comp_k, pos.dtype)          # (C,)
        waf = jnp.asarray(self.comp_amp, pos.dtype) \
            * jnp.asarray(self.comp_w, pos.dtype)         # amp*w
        wf = jnp.asarray(self.comp_w, pos.dtype)
        ph = jnp.asarray(self.comp_phase, pos.dtype)
        dz = self.depth + z[:, None]                      # (n, 1)
        sinh_kd = jnp.sinh(kl * self.depth)               # (C,)
        wft = wf * tw - kl * px[:, None] - ph             # (n, C)
        u = jnp.sum(waf * jnp.cosh(kl * dz) * jnp.cos(wft) / sinh_kd,
                    axis=1)
        wv = -jnp.sum(waf * jnp.sinh(kl * dz) * jnp.sin(wft) / sinh_kd,
                      axis=1)
        if self.driftcorrection:
            # per-component Stokes drift sum (the lib's single-cosh ctd is
            # its collapsed approximation of exactly this)
            amp = jnp.asarray(self.comp_amp, pos.dtype)
            ce = wf / jnp.maximum(kl, 1e-12)
            ctd = self.driftcorrection * (kl * amp) ** 2 * ce \
                / (2.0 * sinh_kd ** 2)
            u = u - jnp.sum(ctd * jnp.cosh(2.0 * kl * dz), axis=1)
        u = u * framp
        wv = wv * framp
        tgt = jnp.stack([u * self.coefdir[0], u * self.coefdir[1], wv],
                        axis=-1)
        inside = jnp.abs(vdis) <= 1.0
        f = jnp.where(inside, _fweight(vdis, self.falpha, self.fbeta), 0.0)
        f = jnp.where(_window(tabs, self.start, self.duration), f, 0.0)
        return tgt.astype(pos.dtype), f


def make_spectrum_zone(**kw) -> RelaxZoneSpectrum:
    """Build a RelaxZoneSpectrum with its component tables discretized from
    the spectrum (wavegen.spectrum_components + the dispersion relation)."""
    from .wavegen import dispersion_k, spectrum_components
    zone = RelaxZoneSpectrum(**kw)
    spec = "jonswap" if zone.spectrum.lower().startswith("j") \
        else "pierson-moskowitz"
    fc, amps, phases = spectrum_components(
        spectrum=spec, discretization=zone.discretization,
        hs=zone.height, tp=zone.period, nwaves=zone.waves,
        peakcoef=zone.peakcoef, seed=zone.randomseed, g=zone.g)
    ks = [dispersion_k(1.0 / f, zone.depth, zone.g) for f in fc]
    ws = [2.0 * math.pi * f for f in fc]
    import dataclasses as _dc
    return _dc.replace(zone, comp_k=tuple(ks), comp_amp=tuple(amps),
                       comp_w=tuple(ws), comp_phase=tuple(phases))


@dataclass(frozen=True)
class RelaxZoneExternal:
    """Blend toward external (SWASH) velocity data on a (t, x, z) grid
    (reference `KerSetFluidVelExternal`, JRelaxZone_ker.cu:374; XML
    `<rzwaves_external_1d>`).  ``grid`` is an inout-style
    `features.inout.InOutGridVel` (the same bilinear + time-linear
    sampler the reference uses for both channels)."""
    center: tuple
    width: float
    grid: "object"            # features.inout.InOutGridVel
    depth: float = 0.0
    swl: float = 0.0
    usevelz: bool = False
    coefdir: tuple = (1.0, 0.0, 0.0)
    coefdt: float = 1000.0
    falpha: float = 0.9
    fbeta: float = 1.0
    driftcorrection: float = 0.0
    driftinitialramp: float = 0.0
    start: float = 0.0
    duration: float = 0.0

    def target_and_weight(self, csp, pos, tabs):
        half = max(0.5 * self.width, 1e-12)
        px = pos[:, 0] - self.center[0]
        vdis = px / half
        vx, vz = self.grid.at(pos, tabs)
        if not self.usevelz:
            vz = jnp.zeros_like(vx)
        tgt = jnp.stack([vx * self.coefdir[0], vx * self.coefdir[1], vz],
                        axis=-1)
        inside = jnp.abs(vdis) <= 1.0
        f = jnp.where(inside, _fweight(vdis, self.falpha, self.fbeta), 0.0)
        f = jnp.where(_window(tabs, self.start, self.duration), f, 0.0)
        return tgt.astype(pos.dtype), f


def apply_relaxzones(zones, csp: CteSph, tabs, pos, vel, code, dt=None):
    """Blend all zones into the fluid velocity (post-corrector hook).
    ``dt`` enables the reference's coefdt rate: applied fraction =
    f * min(coefdt*dt, 1) (coefdt=0 disables the factor)."""
    fluid = td.is_fluid(code) & td.is_normal(code)
    for zn in zones:
        tgt, f = zn.target_and_weight(csp, pos, tabs)
        if dt is not None:
            cdt = getattr(zn, "coefdt", 0.0)
            if cdt:
                f = f * jnp.minimum(cdt * jnp.asarray(dt, f.dtype), 1.0)
        f = jnp.where(fluid, f, 0.0)[:, None]
        vel = vel * (1.0 - f) + tgt.astype(vel.dtype) * f
    return vel
