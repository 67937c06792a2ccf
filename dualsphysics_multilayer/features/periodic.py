"""Periodic open boundaries via fixed ghost slots.

Re-design of the reference periodic machinery (`JSphCpuSingle::RunPeriodic`
JSphCpuSingle.cpp:361-431, GPU `KerPeriodicMakeList/KerPeriodicDuplicate*`
JSphGpu_ker.cu:2445-2696): instead of list surgery with capacity-retry
resizes, a fixed tail region of the particle arrays holds the ghosts —
regenerated (compaction + scatter, all static-shape) at every step start:

1. live particles that crossed a periodic edge wrap by the period,
2. old ghosts die,
3. particles (and previously created ghosts, which covers corners — the
   reference's sequential per-axis duplication does the same) within
   KernelSize of an edge are copied to the opposite side into ghost slots,
   marked with the PERIODIC special code (excluded from AceMax and from
   exclusion marking, exactly like reference periodic particles).

v1 supports axis-aligned periodicity (the reference also supports inclined
period vectors via the xperincy... increments; those slot into the same shift
arithmetic later).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph


@dataclass(frozen=True)
class PeriodicCfg:
    axes: tuple            # e.g. (True, False, False) for x-periodic
    lo: tuple              # periodic box lower corner
    hi: tuple              # upper corner (period = hi - lo per axis)
    ghost_cap: int         # ghost slots per axis pass (tail region)

    @property
    def naxes(self):
        return sum(1 for a in self.axes if a)


def apply_periodic(cfg: PeriodicCfg, csp: CteSph, st):
    """Wrap + regenerate ghosts.  Returns (state, overflow)."""
    n = st.pos.shape[0]
    ks = csp.kernelsize
    pos, vel, rho, code = st.pos, st.vel, st.rho, st.code
    extras = {}
    for nm in ("velm1", "rhom1", "spstau", "boundnormal", "motionvel"):
        a = getattr(st, nm)
        if a is not None:
            extras[nm] = a

    # ---- 1) wrap normal particles that crossed an edge ----------------------
    normal = td.is_normal(code) & td.is_active(code)
    for ax in range(3):
        if not cfg.axes[ax]:
            continue
        L = cfg.hi[ax] - cfg.lo[ax]
        x = pos[:, ax]
        shift = jnp.where(x >= cfg.hi[ax], -L, jnp.where(x < cfg.lo[ax], L, 0.0))
        pos = pos.at[:, ax].add(jnp.where(normal, shift, 0.0))

    # ---- 2) kill old ghosts ---------------------------------------------------
    isghost = td.is_periodic(code)
    dead = jnp.asarray(td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE),
                       code.dtype)
    code = jnp.where(isghost, dead, code)

    # ---- 3) duplicate edge particles into ghost slots ------------------------
    G = cfg.ghost_cap
    overflow = jnp.zeros((), jnp.int32)
    seg = 0
    gbase = n - 2 * cfg.naxes * G   # tail region start
    for ax in range(3):
        if not cfg.axes[ax]:
            continue
        L = cfg.hi[ax] - cfg.lo[ax]
        live = td.is_active(code)
        x = pos[:, ax]
        for side, shift in ((0, +L), (1, -L)):
            near = live & ((x < cfg.lo[ax] + ks) if side == 0
                           else (x >= cfg.hi[ax] - ks))
            order = jnp.argsort(~near, stable=True)
            take = order[:G]
            cnt = jnp.sum(near.astype(jnp.int32))
            valid = jnp.arange(G) < cnt
            overflow = overflow + jnp.maximum(cnt - G, 0)
            dst = gbase + seg * G + jnp.arange(G)
            seg += 1
            gpos = pos[take].at[:, ax].add(shift)
            gcode = td.code_set_special(code[take], td.SPECIAL_PERIODIC)
            pos = pos.at[dst].set(jnp.where(valid[:, None], gpos, pos[dst]))
            vel = vel.at[dst].set(jnp.where(valid[:, None], vel[take],
                                            vel[dst]))
            rho = rho.at[dst].set(jnp.where(valid, rho[take], rho[dst]))
            code = code.at[dst].set(jnp.where(valid, gcode, code[dst]))
            for nm, a in extras.items():
                src = a[take]
                if a.ndim == 2:
                    extras[nm] = a.at[dst].set(
                        jnp.where(valid[:, None], src, a[dst]))
                else:
                    extras[nm] = a.at[dst].set(jnp.where(valid, src, a[dst]))

    st = replace(st, pos=pos, vel=vel, rho=rho, code=code, **extras)
    return st, overflow


def ghost_slots_required(cfg: PeriodicCfg) -> int:
    return 2 * cfg.naxes * cfg.ghost_cap
