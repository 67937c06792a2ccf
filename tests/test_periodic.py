"""Periodic boundary tests: an x-periodic channel behaves like an infinite
one (still water stays still; particles wrap; momentum-driven flow streams)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases as C
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.features import periodic as PER
from dualsphysics_multilayer.features import accinput as ACC
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.typesdef import TpDensity, make_ctesph


def periodic_channel(dp=0.04, length=0.8, depth=0.3, height=0.8):
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=depth, coefh=1.0,
                      visco=0.05, coefsound=20.0)
    d = C.Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (length - dp, 0, depth), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, -3 * dp), (length - dp, 0, -dp),
          ptype=td.TYPE_FIXED, mk=0, faces="solid")
    pos, code = d.build()
    pcfg = PER.PeriodicCfg(axes=(True, False, False), lo=(0.0, 0, 0),
                           hi=(length, 0, 0), ghost_cap=256)
    cap = pos.shape[0] + PER.ghost_slots_required(pcfg)
    dom = C._make_domain(csp, pos, headroom=height / depth)
    st = C._make_state(csp, pos, code, zsurf=depth, capacity=cap)
    return csp, dom, st, pcfg, pos.shape[0]


def test_periodic_still_water_stays_still():
    """Without side walls, only the periodic ghosts keep the edge columns in
    equilibrium — if ghosting is wrong the edges collapse immediately."""
    csp, dom, st, pcfg, n = periodic_channel()
    feats = Features(periodic=pcfg)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(csp, opts, dom, st, feats=feats)
    sim.run(tmax=0.15, tout=0.15)
    stf = sim.state
    fluid = np.asarray(td.is_fluid(stf.code) & td.is_active(stf.code)
                       & td.is_normal(stf.code))
    v = np.linalg.norm(np.asarray(stf.vel)[fluid], axis=1)
    assert int(sim.carry.overflow) == 0
    assert np.percentile(v, 95) < 0.35, np.percentile(v, 95)
    # columns at the edges specifically must not have collapsed
    pos = np.asarray(stf.pos)
    edge = fluid & ((pos[:, 0] < 0.08) | (pos[:, 0] > 0.72))
    assert np.abs(np.asarray(stf.vel)[edge]).max() < 0.6


def test_periodic_wrap_and_streaming():
    """A body force along x drives a net stream; particles wrap around and
    none are lost."""
    csp, dom, st, pcfg, n = periodic_channel()
    acc = ACC.AccInput(mkfluid=0, times=(0.0, 10.0),
                       acclin=(2.0, 0, 0, 2.0, 0, 0))
    feats = Features(periodic=pcfg, accinputs=(acc,))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(csp, opts, dom, st, feats=feats)
    n_live0 = int(np.sum(np.asarray(td.is_active(st.code)
                                    & td.is_normal(st.code))))
    sim.run(tmax=0.4, tout=0.4)
    stf = sim.state
    norm = np.asarray(td.is_active(stf.code) & td.is_normal(stf.code))
    assert int(np.sum(norm)) == n_live0, "particles lost through the boundary"
    fluid = norm & np.asarray(td.is_fluid(stf.code))
    pos = np.asarray(stf.pos)
    # all normal fluid stays inside the periodic box (wrapped)
    assert pos[fluid, 0].min() >= -csp.dp
    assert pos[fluid, 0].max() <= 0.8 + csp.dp
    # net streaming developed
    vx = np.asarray(stf.vel)[fluid, 0].mean()
    assert vx > 0.3, vx
