"""Time-varying external acceleration per mk block.

Re-design of `JDsAccInput` (`JDsAccInput.h/cpp`, GPU `JDsAccInput_ker.cu`,
`StAceInput` `DualSphDef.h:286-295`): each input drives one fluid mk (or a
set of mkbound blocks) with a linear + angular acceleration time series,
optionally replacing gravity.  The angular terms follow
`JDsAccInput::RunCpu` (JDsAccInput.cpp:340-395):

    a += dw/dt x r  +  w x (w x r)  +  2 w x (v - v_frame)

with w (velang) and v_frame (vellin) pre-integrated from the acceleration
series by forward Euler exactly like the reference builds its VelData table
(JDsAccInput.cpp:242-268).  Angular values are rad/s^2
(`_FmtXML_AccInput.xml`).  Applied during pre-interaction so it enters
AceMax and the dt control like any other force (`PreInteractionVars_Forces`,
JSphCpu.cpp:445).

Note: the reference's Coriolis x/y/z lines drop ``v_frame`` from one product
each (e.g. ``2wy*vz - 2wz*(vy-vly)`` instead of ``2wy*(vz-vlz) - ...``,
JDsAccInput.cpp:383-385); this implementation computes the full cross
product 2 w x (v - v_frame) — identical whenever vellin is zero (the common
case: pure rotation inputs).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td


@dataclass(frozen=True)
class AccInput:
    mkfluid: int = -1            # fluid mk target (-1 when mkbound used)
    mkbound: tuple = ()          # bound mk targets (reference mkbound list)
    times: tuple = ()            # (k,)
    acclin: tuple = ()           # (k*3,) linear acceleration samples
    accang: tuple = ()           # (k*3,) angular acceleration (rad/s^2) or ()
    centre: tuple = (0.0, 0.0, 0.0)
    gravity_enabled: bool = True   # False => this input replaces gravity
    tstart: float = 0.0          # activation window (<time start end>)
    tend: float = 1e30
    # pre-integrated frame velocities (filled by _integrate; static tuples)
    vellin: tuple = ()           # (k*3,)
    velang: tuple = ()           # (k*3,)

    def __post_init__(self):
        if self.times and not self.vellin:
            lin, ang = _integrate(self.times, self.acclin, self.accang)
            object.__setattr__(self, "vellin", lin)
            object.__setattr__(self, "velang", ang)

    def at(self, t):
        times = jnp.asarray(self.times, jnp.float32)
        k = len(self.times)

        def table(vals):
            if not vals:
                return None
            tab = jnp.asarray(vals, jnp.float32).reshape(k, 3)
            tt = jnp.clip(t, times[0], times[-1])
            i = jnp.clip(jnp.searchsorted(times, tt, side="right") - 1,
                         0, max(k - 2, 0))
            w = (tt - times[i]) / jnp.maximum(times[i + 1] - times[i], 1e-12)
            return tab[i] + (tab[i + 1] - tab[i]) * w

        z3 = jnp.zeros(3, jnp.float32)
        alin = table(self.acclin)
        aang = table(self.accang)
        vlin = table(self.vellin)
        vang = table(self.velang)
        return (alin if alin is not None else z3,
                aang if aang is not None else z3,
                vlin if vlin is not None else z3,
                vang if vang is not None else z3)


def _integrate(times, acclin, accang):
    """Forward-Euler running velocity tables from the acceleration series
    (the reference's VelData build, JDsAccInput.cpp:242-268)."""
    t = np.asarray(times, np.float64)
    k = len(t)
    lin = np.asarray(acclin, np.float64).reshape(k, 3) if acclin \
        else np.zeros((k, 3))
    ang = np.asarray(accang, np.float64).reshape(k, 3) if accang \
        else np.zeros((k, 3))
    vlin = np.zeros((k, 3))
    vang = np.zeros((k, 3))
    for i in range(1, k):
        dt = t[i] - t[i - 1]
        vlin[i] = vlin[i - 1] + lin[i] * dt
        vang[i] = vang[i - 1] + ang[i] * dt
    return tuple(vlin.reshape(-1)), tuple(vang.reshape(-1))


def load_accinput_csv(path):
    """Load the reference acctimesfile CSV (`CaseForcesData_*.csv`): rows of
    ``time alinx aliny alinz [aangx aangy aangz]``, '#' comments, any of
    space/;/, separators."""
    times, lins, angs = [], [], []
    with open(path) as f:
        for line in f:
            toks = [p for p in line.split("#", 1)[0]
                    .replace(";", " ").replace(",", " ").split() if p]
            if not toks:
                continue
            try:
                vals = [float(x) for x in toks]
            except ValueError:
                continue
            times.append(vals[0])
            row = vals[1:] + [0.0] * max(0, 7 - len(vals))
            lins.extend(row[0:3])
            angs.extend(row[3:6])
    if not times:
        raise ValueError(f"accinput file {path!r} has no data rows")
    return tuple(times), tuple(lins), tuple(angs)


def apply_accinput(inputs, csp, t, pos, vel, code, ace):
    """Add external accelerations to ``ace`` (the interaction accumulator,
    pre-gravity).  Mirrors `JDsAccInput::RunCpu` term-for-term."""
    if not inputs:
        return ace
    mkv = td.code_value(code)
    act = td.is_active(code)
    fluid = td.is_fluid(code) & act
    bound = ~td.is_fluid(code) & act
    grav = jnp.asarray(csp.gravity, jnp.float32)
    for inp in inputs:
        if inp.mkbound:
            sel = bound & jnp.isin(mkv, jnp.asarray(inp.mkbound))
        else:
            sel = fluid & (mkv == inp.mkfluid)
        on = (jnp.asarray(t) >= inp.tstart) & (jnp.asarray(t) <= inp.tend)
        alin, aang, vlin, vang = inp.at(t)
        add = jnp.broadcast_to(alin, ace.shape)
        if not inp.gravity_enabled:
            add = add - grav
        if inp.accang:
            r = pos - jnp.asarray(inp.centre, jnp.float32)
            # term1: dw/dt x r
            add = add + jnp.cross(jnp.broadcast_to(aang, r.shape), r)
            # term2: w x (w x r) (centripetal)
            inner = jnp.cross(jnp.broadcast_to(vang, r.shape), r)
            add = add + jnp.cross(jnp.broadcast_to(vang, r.shape), inner)
            # term3: 2 w x (v - v_frame) (Coriolis)
            add = add + jnp.cross(
                jnp.broadcast_to(2.0 * vang, r.shape), vel - vlin)
        ace = jnp.where((sel & on)[:, None], ace + add, ace)
    return ace
