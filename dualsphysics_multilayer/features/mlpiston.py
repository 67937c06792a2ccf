"""Multi-layer pistons: depth-varying piston velocity from external data.

Re-design of the reference `JMLPistons` (header + closed lib; in-tree GPU
part `JMLPistonsGpu`, SURVEY §2.11; XML `<mlayerpistons>`): a moving-boundary
block whose horizontal velocity varies per LAYER (z band), driven by a
time-series table (typically written by SWASH or another wave model).  Each
moving particle of the block interpolates its layer velocity bilinearly in
(t, z) and advances with it — reproducing a depth-resolved incident wave at
the boundary.

`<piston1d>` drives the whole block with one (t, z) table; `<piston2d>`
carries several ``<veldata>`` columns at different y positions (each its own
(t, z) table + ``timedataini`` offset) and every particle interpolates
linearly between its two neighbouring columns (`_FmtXML_MLPistons.xml`).
``smooth``/``smoothz``/``smoothy`` apply that many passes of a [1,2,1]/4
filter over the layer (and column) axis of the static tables at load time.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td


@dataclass(frozen=True)
class MLPiston1D:
    """Layered piston for one moving mk block."""
    mk: int
    times: tuple           # (nt,) sample times
    zlayers: tuple         # (nl,) layer center elevations (ascending)
    vels: tuple            # (nt*nl,) x-velocity samples, row-major (t, z)
    direction: tuple = (1.0, 0.0, 0.0)

    def velocity_at(self, t, z):
        """Bilinear (t, z) interpolation of the layer velocity table."""
        times = jnp.asarray(self.times, jnp.float32)
        zl = jnp.asarray(self.zlayers, jnp.float32)
        nt, nl = len(self.times), len(self.zlayers)
        v = jnp.asarray(self.vels, jnp.float32).reshape(nt, nl)
        t = jnp.clip(t, times[0], times[-1])
        it = jnp.clip(jnp.searchsorted(times, t, side="right") - 1, 0, nt - 2)
        ft = (t - times[it]) / jnp.maximum(times[it + 1] - times[it], 1e-12)
        z = jnp.clip(z, zl[0], zl[-1])
        iz = jnp.clip(jnp.searchsorted(zl, z, side="right") - 1, 0, nl - 2)
        fz = (z - zl[iz]) / jnp.maximum(zl[iz + 1] - zl[iz], 1e-12)
        v00 = v[it, iz]
        v01 = v[it, iz + 1]
        v10 = v[it + 1, iz]
        v11 = v[it + 1, iz + 1]
        return ((1 - ft) * ((1 - fz) * v00 + fz * v01)
                + ft * ((1 - fz) * v10 + fz * v11))


@dataclass(frozen=True)
class MLPiston2D:
    """2-D layered piston (`<piston2d>`): velocity columns at several y
    positions, linearly interpolated in y between neighbours (reference
    JMLPiston2D via the closed lib; data model `_FmtXML_MLPistons.xml`)."""
    mk: int
    cols: tuple            # MLPiston1D per <veldata>, ascending posy order
    posy: tuple            # (ncol,) y position of each column
    direction: tuple = (1.0, 0.0, 0.0)

    def velocity_at(self, t, y, z):
        if len(self.cols) == 1:
            return self.cols[0].velocity_at(t, z)
        vs = jnp.stack([c.velocity_at(t, z) for c in self.cols])  # (ncol, n)
        py = jnp.asarray(self.posy, jnp.float32)
        yc = jnp.clip(y, py[0], py[-1])
        i = jnp.clip(jnp.searchsorted(py, yc, side="right") - 1,
                     0, len(self.posy) - 2)
        f = (yc - py[i]) / jnp.maximum(py[i + 1] - py[i], 1e-12)
        lane = jnp.arange(vs.shape[1])
        return (1 - f) * vs[i, lane] + f * vs[i + 1, lane]


def smooth_table(vals, passes, axis=-1):
    """[1, 2, 1]/4 box smoothing along ``axis``, edge-clamped, applied
    ``passes`` times (the reference's `smooth`/`smoothz`/`smoothy` motion
    smoothing levels)."""
    v = np.asarray(vals, np.float64)
    if v.shape[axis] < 3:
        return v
    for _ in range(int(passes)):
        lo = np.take(v, [0], axis=axis)
        hi = np.take(v, [-1], axis=axis)
        vp = np.concatenate([lo, v, hi], axis=axis)
        n = v.shape[axis]
        v = (np.take(vp, range(0, n), axis=axis)
             + 2.0 * np.take(vp, range(1, n + 1), axis=axis)
             + np.take(vp, range(2, n + 2), axis=axis)) / 4.0
    return v


def load_mlpiston_csv(path, timedataini=0.0):
    """Layered-velocity CSV -> (times (nt,), vels (nt, nl)): optional header
    line, then ``time v_layer1 .. v_layerN`` rows ('#' comments, any of
    space/;/, as separator — the format our ReadSwash `-savecsv` writes).
    ``timedataini`` shifts the series start (reference `<timedataini>`)."""
    times, rows = [], []
    with open(path) as f:
        for line in f:
            toks = [t for t in line.split("#", 1)[0]
                    .replace(";", " ").replace(",", " ").split() if t]
            if not toks:
                continue
            try:
                vals = [float(t) for t in toks]
            except ValueError:
                continue        # header
            times.append(vals[0])
            rows.append(vals[1:])
    if not rows:
        raise ValueError(f"mlpiston velocity file {path!r} has no data rows")
    nl = min(len(r) for r in rows)
    t = np.asarray(times, np.float64) + float(timedataini)
    order = np.argsort(t)
    return t[order], np.asarray([r[:nl] for r in rows], np.float64)[order]


def make_piston1d(mk, times, vels, zmin, zmax, *, incz=0.0, smooth=0,
                  direction=(1.0, 0.0, 0.0)) -> MLPiston1D:
    """Build an MLPiston1D whose layer centers split the piston's particle
    z-extent [zmin, zmax] into equal bands, column 0 = bottom layer (the
    reference derives the bands from the piston particles in
    `JMLPistons::PreparePiston`); ``incz`` offsets the bands."""
    vels = np.asarray(vels, np.float64)
    nl = vels.shape[1]
    if smooth:
        vels = smooth_table(vels, smooth, axis=1)
    if nl == 1:
        zl = (0.5 * (zmin + zmax) + incz,)
        # duplicate the single layer so the bilinear table is well-formed
        zl = (zl[0] - 1e-6, zl[0] + 1e-6)
        vels = np.repeat(vels, 2, axis=1)
        nl = 2
    else:
        band = (zmax - zmin) / nl
        zl = tuple(zmin + incz + band * (i + 0.5) for i in range(nl))
    return MLPiston1D(mk=mk, times=tuple(np.asarray(times, np.float64)),
                      zlayers=tuple(zl), vels=tuple(vels.reshape(-1)),
                      direction=tuple(direction))


def apply_mlpistons(pistons, tabs, dt, pos, vel, code):
    """Advance multi-layer piston particles by their layer velocity
    (the analog of `JSphCpu::MovePiston1d/2d`, JSphCpu.h piston hooks).
    Returns (pos, vel)."""
    if not pistons:
        return pos, vel
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    for p in pistons:
        sel = moving & (mkv == p.mk)
        if isinstance(p, MLPiston2D):
            vmag = p.velocity_at(tabs, pos[:, 1], pos[:, 2])
        else:
            vmag = p.velocity_at(tabs, pos[:, 2])
        d = jnp.asarray(p.direction, vel.dtype)
        pvel = vmag[:, None] * d[None, :]
        pos = jnp.where(sel[:, None], pos + pvel * dt, pos)
        vel = jnp.where(sel[:, None], pvel, vel)
    return pos, vel
