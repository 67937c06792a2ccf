"""dualsphysics_multilayer — an SPH framework in JAX.

Re-designs the full capability surface of DualSPHysics v5.2 + its
non-Newtonian multiphase solver (reference: wjin33/DualSPHysics_MultiLayer,
analyzed in SURVEY.md) as an idiomatic JAX/XLA/Pallas engine: fixed-shape
cell-bucket neighbour search, fused jitted pairwise force kernels,
device-resident step loops, a fused force kernel for NVIDIA GPUs
(Pallas through Triton), and domain sharding over device meshes.
"""

from . import typesdef
from .typesdef import (
    CteSph, make_ctesph,
    TpStep, TpKernel, TpVisco, TpBoundary, TpDensity, TpShifting,
    TpSlipMode, TpRigidMode,
)
from .ops.forces import SolverOpts
from .models.wcsph import SimState, Simulation, make_step, make_advance, make_carry

__version__ = "0.1.0"
