"""Core vocabulary of the SPH framework.

This module is the re-design of the reference's shared type layer
(`/root/reference/src/source/TypesDef.h`, `DualSphDef.h`):

* solver option enums (step scheme, kernel, viscosity, boundary, DDT, shifting,
  rigid mode) mirroring `DualSphDef.h:315-513`;
* the per-particle ``typecode`` bitfield mirroring the semantics of
  `DualSphDef.h:136-223` (type, special status, mk value) but with a clean
  uint32 layout chosen for branchless jnp masking;
* ``CteSph`` — the frozen constants struct (reference `StCteSph`,
  `DualSphDef.h:374-402`) holding every SPH constant.  It is a *hashable,
  static* Python dataclass: constants are baked into the jitted step function
  at trace time, the JAX analog of the reference's template monomorphization
  (`JSphCpu.h:216-241`) + CUDA ``__constant__`` memory (`JSphGpu_ker.cu:36`).

Nothing in here allocates device arrays.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Solver option enums (reference DualSphDef.h)
# ---------------------------------------------------------------------------

class TpStep(enum.Enum):
    """Time-integration scheme (`DualSphDef.h:315`)."""
    VERLET = 1
    SYMPLECTIC = 2


class TpKernel(enum.Enum):
    """SPH smoothing kernel (`DualSphDef.h:322`)."""
    CUBIC = 1
    WENDLAND = 2


class TpVisco(enum.Enum):
    """Viscosity treatment (`DualSphDef.h:329`, mphase adds ConstEq)."""
    ARTIFICIAL = 1
    LAMINAR_SPS = 2
    CONST_EQ = 3          # non-Newtonian constitutive-equation path (mphase)


class TpBoundary(enum.Enum):
    """Boundary condition scheme (`DualSphDef.h:336`)."""
    DBC = 1
    MDBC = 2


class TpSlipMode(enum.Enum):
    """mDBC slip mode (`DualSphDef.h:342`)."""
    VEL0 = 1
    NO_SLIP = 2
    FREE_SLIP = 3


class TpDensity(enum.Enum):
    """Density diffusion term (`DualSphDef.h:357`)."""
    NONE = 0
    MOLTENI = 1          # DDT_DDT   (Molteni & Colagrossi 2009)
    FOURTAKAS = 2        # DDT_DDT2  (Fourtakas et al. 2019)
    FOURTAKAS_FULL = 3   # DDT_DDT2Full (also applied to bound neighbours)


class TpShifting(enum.Enum):
    """Particle shifting mode (`DualSphDef.h:365`)."""
    NONE = 0
    NO_BOUND = 1
    NO_FIXED = 2
    FULL = 3


class TpInterStep(enum.Enum):
    """Which interaction of the step is running (`DualSphDef.h:349`)."""
    VERLET = 1
    SYM_PREDICTOR = 2
    SYM_CORRECTOR = 3


class TpRigidMode(enum.Enum):
    """Floating-body solve mode (`DualSphDef.h:414`)."""
    FREE = 0
    SPH = 1
    DEM = 2
    CHRONO = 3


class TpVelGrad(enum.Enum):
    """Velocity-gradient formulation for the NN solver (mphase `DualSphDef.h:368`)."""
    FDA = 1
    SPH = 2


class TpPhaseType(enum.Enum):
    """Multiphase rheology type (mphase `DualSphDef.h:303-331`)."""
    NEWTONIAN = 0
    NON_NEWTONIAN = 1


# ---------------------------------------------------------------------------
# Particle typecode bitfield
# ---------------------------------------------------------------------------
# Layout (uint32):
#   bits  0..15 : value   (mk-block index, floating-body index, or inout zone)
#   bits 16..17 : type    (0 fixed, 1 moving, 2 floating, 3 fluid)
#   bits 18..20 : special (0 normal, 1 periodic, 2 out-pos, 3 out-rhop,
#                          4 out-move, 5 out-ignore)
# Functionally equivalent to the reference's 16-bit code (`DualSphDef.h:136-223`)
# with more headroom for mk values and inout zones.

CODE_VALUE_MASK = 0x0000FFFF
CODE_TYPE_SHIFT = 16
CODE_TYPE_MASK = 0x3
CODE_SPECIAL_SHIFT = 18
CODE_SPECIAL_MASK = 0x7

TYPE_FIXED = 0
TYPE_MOVING = 1
TYPE_FLOATING = 2
TYPE_FLUID = 3

SPECIAL_NORMAL = 0
SPECIAL_PERIODIC = 1
SPECIAL_OUT_POS = 2
SPECIAL_OUT_RHOP = 3
SPECIAL_OUT_MOVE = 4
SPECIAL_OUT_IGNORE = 5


def code_make(ptype: int, value: int, special: int = SPECIAL_NORMAL) -> int:
    """Build a typecode from its fields (host-side int)."""
    return (value & CODE_VALUE_MASK) | (ptype << CODE_TYPE_SHIFT) | (special << CODE_SPECIAL_SHIFT)


# jnp-friendly accessors: work on traced uint32 arrays as well as ints.

def code_type(code):
    return (code >> CODE_TYPE_SHIFT) & CODE_TYPE_MASK


def code_value(code):
    return code & CODE_VALUE_MASK


def code_special(code):
    return (code >> CODE_SPECIAL_SHIFT) & CODE_SPECIAL_MASK


def code_set_special(code, special):
    """Return code with its special field replaced."""
    cleared = code & ~(CODE_SPECIAL_MASK << CODE_SPECIAL_SHIFT)
    return cleared | (special << CODE_SPECIAL_SHIFT)


def is_fluid(code):
    return code_type(code) == TYPE_FLUID


def is_floating(code):
    return code_type(code) == TYPE_FLOATING


def is_bound(code):
    return code_type(code) < TYPE_FLOATING


def is_fixed(code):
    return code_type(code) == TYPE_FIXED


def is_moving(code):
    return code_type(code) == TYPE_MOVING


def is_normal(code):
    return code_special(code) == SPECIAL_NORMAL


def is_periodic(code):
    return code_special(code) == SPECIAL_PERIODIC


def is_out(code):
    return code_special(code) >= SPECIAL_OUT_POS


def is_active(code):
    """Particle participates in the simulation (not excluded)."""
    return code_special(code) < SPECIAL_OUT_POS


ALMOSTZERO = 1e-18  # reference DualSphDef.h ALMOSTZERO: min rr2 for a pair


# ---------------------------------------------------------------------------
# Inlet/outlet zone tag (bits 21..25, above the special field)
# ---------------------------------------------------------------------------
# The reference packs inout zone membership into its typecode value field
# (`DualSphDef.h:210-223` CODE_TYPE_FLUID_INOUT + zone number); here the zone
# id+1 lives in dedicated high bits so `code_value` (mk) stays intact for
# accinput/motion/floating lookups.  Zone tag 0 = not an inout particle.

CODE_INOUT_SHIFT = 21
CODE_INOUT_MASK = 0x1F
MAX_INOUT_ZONES = 31


def code_inout(code):
    """Inout zone tag (0 = none, z+1 = member of zone z)."""
    return (code >> CODE_INOUT_SHIFT) & CODE_INOUT_MASK


def code_set_inout(code, tag):
    cleared = code & ~(CODE_INOUT_MASK << CODE_INOUT_SHIFT)
    return cleared | (tag << CODE_INOUT_SHIFT)


def is_inout(code):
    return code_inout(code) != 0


# ---------------------------------------------------------------------------
# Kernel constant bundles (reference FunSphKernelDef.h)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KWendlandCte:
    """Wendland C2 constants (reference `StKWendlandCte`, exact closed forms of
    `FunSphKernel.h:191-203`; the reference stores 5-digit truncations)."""
    awen: float
    bwen: float


@dataclass(frozen=True)
class KCubicCte:
    """Cubic-spline constants (reference `StKCubicCte`, `FunSphKernel.h:51-84`)."""
    a2: float
    aa: float
    a24: float
    c1: float
    d1: float
    c2: float
    od_wdeltap: float


def wendland_ctes(simulate2d: bool, h: float) -> KWendlandCte:
    """Exact Wendland C2 normalization. 2D: a=7/(4*pi*h^2); 3D: a=21/(16*pi*h^3).
    Gradient coefficient b = -5*a/h (reference `FunSphKernel.h:191-203`)."""
    if simulate2d:
        a = 7.0 / (4.0 * math.pi * h * h)
    else:
        a = 21.0 / (16.0 * math.pi * h ** 3)
    return KWendlandCte(awen=a, bwen=-5.0 * a / h)


def cubic_ctes(simulate2d: bool, h: float) -> KCubicCte:
    """Cubic-spline constants incl. tensile-correction normalizer
    (reference `FunSphKernel.h:51-84`)."""
    if simulate2d:
        a1 = 10.0 / (math.pi * 7.0)
        a2 = a1 / (h * h)
        aa = a1 / (h ** 3)
    else:
        a1 = 1.0 / math.pi
        a2 = a1 / (h ** 3)
        aa = a1 / (h ** 4)
    deltap = 1.0 / 1.5
    wdeltap = a2 * (1.0 - 1.5 * deltap * deltap + 0.75 * deltap ** 3)
    return KCubicCte(
        a2=a2, aa=aa, a24=0.25 * a2,
        c1=-3.0 * aa, d1=9.0 * aa / 4.0, c2=-3.0 * aa / 4.0,
        od_wdeltap=1.0 / wdeltap,
    )


# ---------------------------------------------------------------------------
# CteSph — all SPH constants (reference StCteSph, DualSphDef.h:374-402)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CteSph:
    """Frozen SPH constants; hashable so a jitted step specializes on it.

    Derivations follow `JSph::ConfigConstants1/2` (`JSph.cpp:1392-1457`):
    kernelsize = 2*h; cs0 = sqrt(gamma*b/rho0); eta2 = (0.1*h)^2;
    ddtkh = kernelsize*ddtvalue; ddtgz = rho0*|g_z|/b;
    SPS Smagorinsky/Blin constants from dp.
    """
    simulate2d: bool
    tkernel: TpKernel
    kwend: KWendlandCte
    kcubic: KCubicCte
    kernelh: float
    kernelsize: float
    kernelsize2: float
    cteb: float
    gamma: float
    rhopzero: float
    dp: float
    massfluid: float
    massbound: float
    gravity: tuple  # (gx, gy, gz)
    cs0: float
    eta2: float
    # viscosity
    visco: float
    viscoboundfactor: float
    spssmag: float
    spsblin: float
    # density diffusion
    ddtvalue: float
    ddtkh: float
    ddtgz: float
    # shifting
    shiftcoef: float = -2.0
    shifttfs: float = 0.0
    # dt control
    cflnumber: float = 0.2
    coefdtmin: float = 0.05
    dtini: float = 0.0
    dtmin: float = 0.0
    dtfixed: float = 0.0
    dtallparticles: bool = False
    # density clipping (exclusion window)
    rhopoutmin: float = 700.0
    rhopoutmax: float = 1300.0

    @property
    def dim(self) -> int:
        return 2 if self.simulate2d else 3

    def replace(self, **kw) -> "CteSph":
        return dataclasses.replace(self, **kw)


def make_ctesph(
    *,
    simulate2d: bool,
    dp: float,
    rhopzero: float = 1000.0,
    gamma: float = 7.0,
    gravity: tuple = (0.0, 0.0, -9.81),
    coefh: float = 1.0,
    hdp: float = 0.0,
    hswl: float = 0.0,
    coefsound: float = 20.0,
    speedsystem: float = 0.0,
    speedsound: float = 0.0,
    tkernel: TpKernel = TpKernel.WENDLAND,
    visco: float = 0.01,
    viscoboundfactor: float = 1.0,
    tvisco: TpVisco = TpVisco.ARTIFICIAL,
    ddtvalue: float = 0.1,
    shiftcoef: float = -2.0,
    shifttfs: float = 0.0,
    cflnumber: float = 0.2,
    coefdtmin: float = 0.05,
    dtini: float = 0.0,
    dtmin: float = 0.0,
    dtfixed: float = 0.0,
    dtallparticles: bool = False,
    rhopoutmin: float = 700.0,
    rhopoutmax: float = 1300.0,
) -> CteSph:
    """Derive the full constants set from case-level inputs.

    Mirrors the constants pipeline GenCase + `JSph::ConfigConstants1/2`
    (`JSph.cpp:1392-1457`): h from coefh (h=coefh*sqrt(dim*dp^2)) or hdp
    (h=hdp*dp); speedsystem defaults to the dam-break propagation speed
    sqrt(g*hswl); cs0 = coefsound*speedsystem unless given; b = cs0^2*rho0/gamma.
    """
    dim = 2 if simulate2d else 3
    if hdp:
        h = hdp * dp
    else:
        h = coefh * math.sqrt(dim) * dp
    g = abs(gravity[2])
    if not speedsound:
        if not speedsystem:
            speedsystem = math.sqrt(g * hswl) if hswl > 0 else 0.0
        speedsound = coefsound * speedsystem
    if speedsound <= 0:
        raise ValueError("speedsound could not be derived: give speedsound, "
                         "speedsystem, or hswl")
    cs0 = speedsound
    cteb = cs0 * cs0 * rhopzero / gamma
    massfluid = rhopzero * dp ** dim
    massbound = massfluid
    kernelsize = 2.0 * h
    # SPS constants (JSph::ConfigConstants2, JSph.cpp:1437-1443)
    dp_sps = math.sqrt(dp * dp * dim) / dim
    spssmag = (0.12 * dp_sps) ** 2 if tvisco == TpVisco.LAMINAR_SPS else 0.0
    spsblin = (2.0 / 3.0) * 0.0066 * dp_sps * dp_sps if tvisco == TpVisco.LAMINAR_SPS else 0.0
    if not dtini:
        dtini = h / cs0
    if not dtmin:
        dtmin = (h / cs0) * coefdtmin
    return CteSph(
        simulate2d=simulate2d,
        tkernel=tkernel,
        kwend=wendland_ctes(simulate2d, h),
        kcubic=cubic_ctes(simulate2d, h),
        kernelh=h,
        kernelsize=kernelsize,
        kernelsize2=kernelsize * kernelsize,
        cteb=cteb,
        gamma=gamma,
        rhopzero=rhopzero,
        dp=dp,
        massfluid=massfluid,
        massbound=massbound,
        gravity=tuple(gravity),
        cs0=cs0,
        eta2=(0.1 * h) ** 2,
        visco=visco,
        viscoboundfactor=viscoboundfactor,
        spssmag=spssmag,
        spsblin=spsblin,
        ddtvalue=ddtvalue,
        ddtkh=kernelsize * ddtvalue,
        ddtgz=rhopzero * g / cteb,
        shiftcoef=shiftcoef,
        shifttfs=shifttfs,
        cflnumber=cflnumber,
        coefdtmin=coefdtmin,
        dtini=dtini,
        dtmin=dtmin,
        dtfixed=dtfixed,
        dtallparticles=dtallparticles,
        rhopoutmin=rhopoutmin,
        rhopoutmax=rhopoutmax,
    )
