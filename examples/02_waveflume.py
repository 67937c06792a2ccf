"""2-D wave flume: 2nd-order piston wavemaker with AWAS absorption and an
SWL gauge at mid-flume (the reference wave-paddle workflow,
`_FmtXML_WavePaddles.xml`)."""
import sys

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import dualsphysics_multilayer as dsph
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.features.gauges import GaugeSwl, GaugeSystem

case = cases.waveflume2d(dp=0.01)
feats = case.meta.get("features")
sim = dsph.Simulation(case.csp,
                      dsph.SolverOpts(tdensity=dsph.TpDensity.FOURTAKAS),
                      case.dom, case.state, feats=feats)
gs = GaugeSystem(case.csp, case.dom, gauges=(
    GaugeSwl("eta_mid", (3.0, 0, 0), (3.0, 0, 1.0), 0.02),))


def on_save(s):
    out = gs.run(s.time, s.state)
    print(f"t={s.time:.2f}s  eta(x=3m)={out['eta_mid'][2]:.4f} m")


sim.run(tmax=6.0, tout=0.2, on_save=on_save)
gs.save_csv("out_waveflume")
print("gauge CSV in out_waveflume/")
