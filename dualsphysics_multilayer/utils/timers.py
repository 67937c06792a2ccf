"""Named phase timers.

The reference wraps every stage in named timers (`JDsTimers`, CPU ontology
`JDsTimersCpu.h:28-85`: NL-Limits/MakeSort/SortData, CF-PreForces/Forces,
SU-ComputeStep/Floating/Motion/...) and prints a table at the end
(`ShowTimes`).  Under XLA the production step is ONE fused device program;
these host timers cover the phases the run driver sees (device calls, saves).
"""

from __future__ import annotations

import time
from collections import defaultdict


class Timers:
    """Named accumulating wall timers (TmStart/TmStop/ShowTimes analog)."""

    def __init__(self):
        self.acc = defaultdict(float)
        self.counts = defaultdict(int)
        self._t0 = {}

    def start(self, name):
        self._t0[name] = time.perf_counter()

    def stop(self, name):
        dt = time.perf_counter() - self._t0.pop(name)
        self.acc[name] += dt
        self.counts[name] += 1
        return dt

    def table(self):
        total = sum(self.acc.values()) or 1.0
        rows = [f"{'Timer':<24}{'calls':>8}{'total_s':>12}{'%':>8}"]
        for k in sorted(self.acc, key=lambda k: -self.acc[k]):
            rows.append(f"{k:<24}{self.counts[k]:>8}{self.acc[k]:>12.4f}"
                        f"{100 * self.acc[k] / total:>8.1f}")
        return "\n".join(rows)
