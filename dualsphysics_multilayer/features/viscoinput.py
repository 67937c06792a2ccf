"""Time-varying viscosity input (the JDsViscoInput channel).

Reference: `/root/reference/src/source/JDsViscoInput.h/cpp` — a CSV table
(time, viscosity) loaded by the ``<parameters>`` key ``ViscoTime``
(`JSph.cpp` LoadConfigParameters); each step the solver looks up
``Visco = table(TimeStep)`` before the force interaction
(`JSphCpuSingle.cpp:1092` ``ViscoTime->GetVisco``).

Design: the table is a pair of static device arrays; the per-step lookup
is a traced ``jnp.interp`` on the absolute-time carry scalar, feeding the
``visco`` traced argument of the force paths — no recompilation as viscosity
evolves (same pattern as the DDT ramp's traced ``ddtkh``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ViscoInput:
    """Static (times, values) viscosity time series."""
    times: tuple        # strictly increasing
    values: tuple

    def visco_at(self, tabs):
        """Traced lookup: linear interpolation, clamped at the ends (the
        reference's JLinearValue::GetValue semantics)."""
        t = jnp.asarray(self.times, jnp.float32)
        v = jnp.asarray(self.values, jnp.float32)
        return jnp.interp(jnp.asarray(tabs, jnp.float32), t, v)


def load_viscoinput(path) -> ViscoInput:
    """Load the reference CSV/ASCII format: '#'-comments, one 'time value'
    pair per row, separators space/;/, (JReadDatafile + JDsViscoInput::
    LoadFile)."""
    times, values = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = [p for p in line.replace(";", " ").replace(",", " ").split()
                     if p]
            if len(parts) < 2:
                continue
            try:
                tv, vv = float(parts[0]), float(parts[1])
            except ValueError:
                continue        # header row
            times.append(tv)
            values.append(vv)
    if not times:
        raise ValueError(f"ViscoTime file {path!r} has no (time, visco) rows")
    order = np.argsort(times)
    return ViscoInput(times=tuple(np.asarray(times)[order]),
                      values=tuple(np.asarray(values)[order]))
