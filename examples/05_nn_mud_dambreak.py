"""Non-Newtonian wet dam break: HBP (Herschel-Bulkley-Papanastasiou)
rheology, two phases, the mphase_nnewtonian/01_WetDambreak workflow.
Runs the SHIPPED NN case XML unmodified."""
import subprocess
import sys

args = [sys.executable, "-m", "dualsphysics_multilayer.cli",
        "-case", "/root/reference/examples/mphase_nnewtonian/"
                 "01_WetDambreak/CaseWetDambreak2DNN_Def.xml",
        "-dirout", "out_nnmud", "-sv:binx", "-tmax:0.5", "-tout:0.05"]
if "--cpu" in sys.argv:
    args.insert(3, "-cpu")
sys.exit(subprocess.call(args))
