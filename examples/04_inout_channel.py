"""Open-boundary channel: inlet at x=0 (uniform imposed velocity + AWAS
free-surface correction) and outlet at x=L (reference inletoutlet examples,
SURVEY §2.10)."""
import sys

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

import dataclasses
import numpy as np
import dualsphysics_multilayer as dsph
from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.features.featureset import Features

case = cases.channel2d(dp=0.01, vel=0.4)
feats = Features(inout=case.meta["inout"])
sim = dsph.Simulation(case.csp, dsph.SolverOpts(), case.dom, case.state,
                      feats=feats)


def on_save(s):
    code = s.state.code
    nfl = int(np.asarray(td.is_fluid(code) & td.is_active(code)).sum())
    print(f"t={s.time:.2f}s  active fluid particles={nfl}")


sim.run(tmax=1.5, tout=0.1, on_save=on_save)
