"""Measurement gauges computed on the live particle state.

Re-design of the reference gauge system (`JDsGaugeSystem.h/cpp`,
`JDsGaugeItem.h:70-73,183-393`, GPU kernels `JDsGauge_ker.cu:50-311`):

* GaugeVel   — SPH-interpolated velocity at a point,
* GaugeSwl   — free-surface level along a segment (mass-sum threshold walk),
* GaugeMaxZ  — highest fluid particle near a vertical column,
* GaugeForce — total force on the boundary particles of one mk
               (sum of m * ace over the block).

All are pure jnp over the cell structure's point-candidate search and can run
inside jit (they also back AWAS wave absorption and inout zsurf, as in the
reference).  Results are drained to CSV by the run driver at save ticks.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph
from ..ops import celldiv as cd
from ..ops import kernels as K


def _sph_sum(csp, dom, div, pos, code, points, values=None):
    """Shepard sums at query points: returns (sum_w*m/rho ... ) pieces."""
    cand = cd.point_candidates(dom, div, points)
    n = div.ncap
    cpos = cd.gather(pos, cand)
    ccode = cd.gather(code, cand,
                      fill=td.code_make(td.TYPE_FIXED, 0, td.SPECIAL_OUT_IGNORE))
    fluid = td.is_fluid(ccode) & td.is_active(ccode) & (cand < n)
    dr = points[:, None, :] - cpos
    rr2 = jnp.sum(dr * dr, axis=-1)
    pair = fluid & (rr2 <= csp.kernelsize2)
    wab = jnp.where(pair, K.kernel_wab(csp, jnp.where(pair, rr2,
                                                      csp.kernelsize2)), 0.0)
    masswab = csp.massfluid * wab
    out = dict(masssum=jnp.sum(masswab, axis=1))
    if values is not None:
        crho = cd.gather(values["rho"], cand, fill=1.0)
        vol = masswab / crho
        out["shepard"] = jnp.sum(vol, axis=1)
        if "vel" in values:
            cvel = cd.gather(values["vel"], cand)
            out["velsum"] = jnp.einsum("nm,nmd->nd", vol, cvel)
    return out


@dataclass(frozen=True)
class GaugeVel:
    """SPH velocity at a point (GAUGE_Vel, JDsGaugeItem.h:183)."""
    name: str
    point: tuple

    def compute(self, csp, dom, div, state):
        pts = jnp.asarray([self.point], jnp.float32)
        s = _sph_sum(csp, dom, div, state.pos, state.code, pts,
                     values=dict(rho=state.rho, vel=state.vel))
        shep = jnp.maximum(s["shepard"], 1e-6)
        return np.asarray(s["velsum"] / shep[:, None])[0]


@dataclass(frozen=True)
class GaugeSwl:
    """Surface water level along a segment (GAUGE_Swl, JDsGaugeItem.h:249):
    sample points every ``pointdp``; the surface is where the kernel mass sum
    drops through ``masslimit`` (0.5 * reference mass by default)."""
    name: str
    point0: tuple
    point2: tuple
    pointdp: float
    masslimit: float = 0.0

    def compute(self, csp, dom, div, state):
        p0 = np.asarray(self.point0, np.float64)
        p2 = np.asarray(self.point2, np.float64)
        length = np.linalg.norm(p2 - p0)
        k = max(2, int(np.ceil(length / self.pointdp)) + 1)
        pts = jnp.asarray(p0[None, :] + (p2 - p0)[None, :]
                          * np.linspace(0, 1, k)[:, None], jnp.float32)
        s = _sph_sum(csp, dom, div, state.pos, state.code, pts)
        mass = np.asarray(s["masssum"])
        # fully submerged point: sum(m*W) ~ m/volume = rho0; the surface is
        # where it drops through half that (the reference's masslimit idea)
        mlimit = self.masslimit or 0.5 * csp.rhopzero
        above = mass >= mlimit
        if not above.any():
            return np.asarray(p0, np.float64)
        last = np.where(above)[0].max()
        frac = last / (k - 1)
        return p0 + (p2 - p0) * frac


@dataclass(frozen=True)
class GaugeMaxZ:
    """Max fluid z within ``distlimit`` of a vertical line (GAUGE_MaxZ)."""
    name: str
    point0: tuple
    height: float
    distlimit: float

    def compute(self, csp, dom, div, state):
        pos = np.asarray(state.pos)
        code = state.code
        fluid = np.asarray(td.is_fluid(code) & td.is_active(code))
        p0 = np.asarray(self.point0)
        d2 = (pos[:, 0] - p0[0]) ** 2 + (pos[:, 1] - p0[1]) ** 2
        sel = fluid & (d2 <= self.distlimit ** 2) \
            & (pos[:, 2] <= p0[2] + self.height)
        return float(pos[sel, 2].max()) if sel.any() else float(p0[2])


@dataclass(frozen=True)
class GaugeForce:
    """Sum of pressure forces on the boundary particles of one mkbound
    (GAUGE_Force, JDsGaugeItem.h:355): per bound particle
    ace = sum_fluid -m_f (P1+P2)/(rho1 rho2) gradW (the pressure-only
    momentum term, `KerInteractionGaugeForce` JDsGauge_ker.cu:311-368);
    F = massbound * sum(ace)."""
    name: str
    mkbound: int

    def compute(self, csp, dom, div, state):
        from ..ops import eos as EOS
        pos = np.asarray(state.pos)
        code = state.code
        act = np.asarray(td.is_active(code) & td.is_normal(code))
        bsel = act & np.asarray(td.is_bound(code)
                                & (td.code_value(code) == self.mkbound))
        fsel = act & np.asarray(td.is_fluid(code))
        if not bsel.any() or not fsel.any():
            return np.zeros(3)
        rho = np.asarray(state.rho)
        press = np.asarray(EOS.press_from_rho(csp, jnp.asarray(rho)))
        bp, fp = pos[bsel], pos[fsel]
        brho, frho = rho[bsel], rho[fsel]
        bprs, fprs = press[bsel], press[fsel]
        F = np.zeros(3)
        # chunk the bound side so the (nb, nf) pair block stays small
        for i0 in range(0, len(bp), 256):
            b = slice(i0, i0 + 256)
            dr = bp[b, None, :] - fp[None, :, :]
            rr2 = np.einsum("bfd,bfd->bf", dr, dr)
            m = (rr2 <= csp.kernelsize2) & (rr2 >= 1e-18)
            fac = np.asarray(K.kernel_fac(
                csp, jnp.asarray(np.where(m, rr2, csp.kernelsize2),
                                 jnp.float32)))
            prs = (bprs[b, None] + fprs[None, :]) \
                / (brho[b, None] * frho[None, :])
            coef = np.where(m, -prs * csp.massfluid * fac, 0.0)
            F += np.einsum("bf,bfd->d", coef, dr)
        return F * csp.massbound

    def compute_from_forces(self, csp, state, ace):
        code = state.code
        sel = np.asarray(td.is_bound(code) & td.is_active(code)
                         & (td.code_value(code) == self.mkbound))
        return np.asarray(ace)[sel].sum(axis=0) * csp.massbound


class GaugeSystem:
    """Host-side gauge runner (the JGaugeSystem analog).

    Cadence model matches the reference (`JDsGaugeItem.h:70-73`,
    `JDsGaugeSystem.cpp:447`): a gauge with a ``computedt`` ticks on its own
    time grid start + k*computedt (the run driver breaks the device loop at
    the next pending tick — see models.wcsph.Simulation.run ``next_subtick``);
    a gauge without one ticks at save cadence (the reference's default
    computedt = TimeOut)."""

    def __init__(self, csp, dom, gauges=(), windows=None, computedts=None):
        self.csp, self.dom = csp, dom
        self.gauges = list(gauges)
        self.history = {g.name: [] for g in gauges}
        # per-gauge <computetime start end> windows: {name: (start, end)}
        self.windows = dict(windows or {})
        # per-gauge <computedt> cadence: {name: dt}
        self.computedts = {k: v for k, v in (computedts or {}).items()
                           if v and v > 0}
        self._last = {}

    def _grid_start(self, name):
        w = self.windows.get(name)
        return w[0] if w is not None else 0.0

    def next_time(self, t):
        """Earliest pending computedt tick > t over all gauges (None if no
        gauge has a computedt, or all are past their windows)."""
        times = []
        for g in self.gauges:
            cdt = self.computedts.get(g.name)
            if not cdt:
                continue
            start = self._grid_start(g.name)
            k = max(0, int(np.floor((t - start) / cdt + 1e-9)) + 1)
            nx = start + k * cdt
            w = self.windows.get(g.name)
            if w is not None and nx > w[1] + 1e-12:
                continue
            times.append(nx)
        return min(times) if times else None

    def run(self, t, state, at_save=True):
        div = None
        out = {}
        for g in self.gauges:
            w = self.windows.get(g.name)
            if w is not None and not (w[0] <= t <= w[1]):
                continue
            cdt = self.computedts.get(g.name)
            if cdt:
                # run iff a grid tick start + k*cdt lies in (last, t]
                start = self._grid_start(g.name)
                k = int(np.floor((t - start) / cdt + 1e-9))
                tick = start + k * cdt
                last = self._last.get(g.name)
                if tick < start - 1e-12 or (last is not None
                                            and tick <= last + 1e-12):
                    continue
                self._last[g.name] = t
            elif not at_save:
                continue
            if hasattr(g, "compute"):
                if div is None:
                    div, _ = cd.divide(self.dom, state.pos, state.code)
                v = g.compute(self.csp, self.dom, div, state)
                self.history[g.name].append((t, np.asarray(v)))
                out[g.name] = v
        return out

    def save_csv(self, dirout):
        import os
        os.makedirs(dirout, exist_ok=True)
        for name, rows in self.history.items():
            if not rows:
                continue
            with open(os.path.join(dirout, f"Gauge_{name}.csv"), "w") as f:
                f.write("time;values\n")
                for t, v in rows:
                    vv = np.atleast_1d(v).ravel()
                    f.write(f"{t};" + ";".join(f"{x:g}" for x in vv) + "\n")
