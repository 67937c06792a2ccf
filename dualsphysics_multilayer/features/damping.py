"""Velocity damping zones (numerical beaches / absorbers).

Re-design of `JDsDamping` (`JDsDamping.h:119-260`, GPU kernels
`JSphGpu_ker.cu:2762-2936`): each zone reduces fluid velocity by a factor
``f = redumax * over^factorxyz`` scaled by dt, where ``over`` ramps 0..1
across the zone.  Zone shapes: plane (with optional bounding domain), box,
cylinder — all evaluated as pure masked jnp, applied after the corrector
(`JSphCpuSingle.cpp:716-718` RunDamping hook).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td


@dataclass(frozen=True)
class DampingPlane:
    """Damping between two parallel planes: full strength at limitpoint's
    plane, zero at the point plane (reference `JDsDamping_Plane`)."""
    point: tuple        # a point on the zero-damping plane
    limitpoint: tuple   # a point on the full-damping plane
    overlimit: float = 0.0   # extra distance after limit at full damping
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        p0 = jnp.asarray(self.point, jnp.float32)
        p1 = jnp.asarray(self.limitpoint, jnp.float32)
        nvec = p1 - p0
        dist = float(np.linalg.norm(np.asarray(self.limitpoint)
                                    - np.asarray(self.point)))
        nhat = nvec / max(dist, 1e-12)
        s = jnp.einsum("nd,d->n", pos - p0, nhat)
        over = jnp.clip(s / dist, 0.0, 1.0)
        over = jnp.where(s > dist + self.overlimit, 1.0, over)
        return jnp.where(s > 0, over, 0.0)


@dataclass(frozen=True)
class DampingBox:
    """Damping ramping from an inner box surface to an outer box
    (reference `JDsDamping_Box`)."""
    boxmin1: tuple
    boxmax1: tuple      # inner (zero damping inside)
    boxmin2: tuple
    boxmax2: tuple      # outer (full damping outside)
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        bmin1 = jnp.asarray(self.boxmin1, jnp.float32)
        bmax1 = jnp.asarray(self.boxmax1, jnp.float32)
        bmin2 = jnp.asarray(self.boxmin2, jnp.float32)
        bmax2 = jnp.asarray(self.boxmax2, jnp.float32)
        # normalized penetration beyond the inner box toward the outer box
        lo = jnp.where(pos < bmin1,
                       (bmin1 - pos) / jnp.maximum(bmin1 - bmin2, 1e-12), 0.0)
        hi = jnp.where(pos > bmax1,
                       (pos - bmax1) / jnp.maximum(bmax2 - bmax1, 1e-12), 0.0)
        over = jnp.max(jnp.maximum(lo, hi), axis=1)
        inside2 = jnp.all((pos >= bmin2) & (pos <= bmax2), axis=1)
        return jnp.where(inside2, jnp.clip(over, 0.0, 1.0), 1.0) * \
            (jnp.max(jnp.maximum(lo, hi), axis=1) > 0)


@dataclass(frozen=True)
class DampingCylinder:
    """Radial damping between radii (reference `JDsDamping_Cylinder`)."""
    point1: tuple
    point2: tuple       # cylinder axis
    limitmin: float     # radius where damping starts
    limitmax: float     # radius of full damping
    redumax: float = 10.0
    factorxyz: tuple = (1.0, 1.0, 1.0)

    def factor(self, pos):
        p1 = np.asarray(self.point1, np.float64)
        p2 = np.asarray(self.point2, np.float64)
        ax = p2 - p1
        ax = ax / max(np.linalg.norm(ax), 1e-12)
        axj = jnp.asarray(ax, jnp.float32)
        rel = pos - jnp.asarray(p1, jnp.float32)
        along = jnp.einsum("nd,d->n", rel, axj)
        radial = rel - along[:, None] * axj
        r = jnp.sqrt(jnp.sum(radial * radial, axis=1))
        over = (r - self.limitmin) / max(self.limitmax - self.limitmin, 1e-12)
        return jnp.clip(over, 0.0, 1.0)


def apply_damping(zones, dt, pos, vel, code):
    """vel *= (1 - dt*redumax)^over per zone component-scaled by factorxyz
    (`JDsDamping::ComputeDampingCpu`).  Fluid particles only."""
    if not zones:
        return vel
    fluid = td.is_fluid(code) & td.is_active(code)
    for z in zones:
        over = z.factor(pos)
        fdamp = jnp.power(jnp.clip(1.0 - dt * z.redumax, 0.0, 1.0), over)
        fxyz = jnp.asarray(z.factorxyz, jnp.float32)
        scale = 1.0 - fxyz[None, :] * (1.0 - fdamp[:, None])
        vel = jnp.where((fluid & (over > 0))[:, None], vel * scale, vel)
    return vel
