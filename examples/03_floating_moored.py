"""Buoyant floating box held by two dynamic lumped-mass mooring lines
(the MoorDyn+ model re-implemented on-device): mDBC boundaries + native
6-DOF rigid solve (reference coupling: JDsMooredFloatings +
libdsphmoordyn)."""
import sys

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import dualsphysics_multilayer as dsph
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.features.moorings import (MoorDynCfg,
                                                           MoorDynLine)

case = cases.floatingbox2d(dp=0.01)
ftcfg = case.meta["ftcfg"]
c0 = np.asarray(case.state.ft.center)[0]
moor = MoorDynCfg(nbodies=1, lines=(
    MoorDynLine(body=0, anchor=(c0[0] - 0.4, 0.0, 0.0),
                fairlead=(-0.1, 0.0, -0.05), length0=0.45,
                ea=2.9e3, nseg=10, diameter=3.7e-3, massden=0.06),
    MoorDynLine(body=0, anchor=(c0[0] + 0.4, 0.0, 0.0),
                fairlead=(0.1, 0.0, -0.05), length0=0.45,
                ea=2.9e3, nseg=10, diameter=3.7e-3, massden=0.06)))
feats = Features(floating=ftcfg, moorings=moor)
opts = dsph.SolverOpts(tdensity=dsph.TpDensity.FOURTAKAS,
                       with_floating=True,
                       tboundary=dsph.TpBoundary.MDBC)
sim = dsph.Simulation(case.csp, opts, case.dom, case.state, feats=feats)
sim.run(tmax=1.5, tout=0.1,
        on_save=lambda s: print(
            f"t={s.time:.2f}s  box center="
            f"{np.asarray(s.state.ft.center)[0].round(4)}"))
