"""Per-pair WCSPH physics, shared by every interaction layout.

This is the single source of truth for the pair terms of the reference's
interaction loops (`/root/reference/src/source/JSphCpu.cpp:548-822`,
GPU twin `JSphGpu_ker.cu:512-748`): momentum (pressure + tensile), continuity,
delta-SPH density diffusion (Molteni / Fourtakas), artificial and
laminar+SPS viscosity, and shifting accumulators.

Callers lay pairs out however their neighbour structure dictates — cell-bucket
tiles (A,K,K), Verlet neighbour lists (N,M), or the GPU kernel's (targets x
candidates) register tiles (:mod:`.pallas.cellforce`) — build the
broadcasted per-pair inputs, call :func:`pair_terms`, and reduce over their
candidate axis.  Keeping the physics layout-agnostic is the analog of the
reference's single templated pair body reused by CPU and GPU.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpDensity, TpKernel, TpShifting, TpVisco
from . import kernels as K


@dataclass
class PairInputs:
    """Broadcasted per-pair fields.  Index 1 = target, 2 = candidate.
    All arrays share one pair shape (...,); vectors are given by component:
    ``dr``/``dv`` are (x, y, z) tuples and the SPS stresses 6-tuples, so a
    GPU kernel's power-of-two pair tiles and the jnp layouts run the same
    code."""
    dr: tuple              # r1 - r2, (x, y, z)
    rr2: jax.Array
    pair: jax.Array        # bool: pair participates at all
    dv: tuple              # v1 - v2, (x, y, z)
    mass2: jax.Array
    rho1: jax.Array
    rho2: jax.Array
    press1: jax.Array
    press2: jax.Array
    bound_t: jax.Array     # bool: target is boundary (fixed/moving)
    bound_c: jax.Array     # bool: candidate is boundary
    ft_t: jax.Array        # bool: target is floating
    ft_c: jax.Array        # bool: candidate is floating
    fixed_c: jax.Array     # bool: candidate is fixed boundary
    tau_t: tuple | None = None   # 6-tuple target SPS stress (zero for non-fluid)
    tau_c: tuple | None = None   # 6-tuple candidate SPS stress (zero for non-fluid)


@dataclass
class PairTerms:
    """Per-pair contributions; reduce over your candidate axis.
    Boolean flags are per-pair 'poison' markers to be any-reduced."""
    ace: tuple                       # (x, y, z)
    ar: jax.Array
    delta: jax.Array | None
    delta_blocked: jax.Array | None
    shift: tuple | None              # (x, y, z, concentration)
    shift_blocked: jax.Array | None
    gradvel: tuple | None            # (xx, xy, xz, yy, yz, zz)
    visc: jax.Array                  # per-pair dot_rr2 (masked to -inf outside)


_NEG = np.float32(-3.4e38)   # plain numpy: no backend init at import time


def split3(v):
    """(..., k) array -> tuple of its k trailing components."""
    return tuple(v[..., i] for i in range(v.shape[-1]))


def pair_terms(csp: CteSph, opts, p: PairInputs, ddtkh,
               visco=None) -> PairTerms:
    """``visco``: traced viscosity scalar for the JDsViscoInput channel
    (time-varying ``<parameters> ViscoTime`` CSV, `JSphCpuSingle.cpp:1092`);
    defaults to the static ``csp.visco``."""
    f32 = p.rr2.dtype
    cbar = jnp.asarray(csp.cs0, f32)
    eta2 = jnp.asarray(csp.eta2, f32)
    if visco is None:
        visco = jnp.asarray(csp.visco, f32)
    ks2 = jnp.asarray(csp.kernelsize2, f32)

    pw = p.pair.astype(f32)
    rr2s = jnp.where(p.pair, p.rr2, ks2)
    fac = K.kernel_fac(csp, rr2s)
    frx, fry, frz = (fac * d for d in p.dr)
    drx, dry, drz = p.dr
    dvx, dvy, dvz = p.dv

    dvfr = dvx * frx + dvy * fry + dvz * frz
    drfr = drx * frx + dry * fry + drz * frz
    dot = drx * dvx + dry * dvy + drz * dvz
    dot_rr2 = dot / (rr2s + eta2)

    bb = p.bound_t & p.bound_c
    w_comp = pw * (1.0 - bb.astype(f32))        # bound-bound pairs never interact
    w_mom = pw * (1.0 - p.bound_t.astype(f32))  # momentum: fluid-side targets only

    # momentum (JSphCpu.cpp:713-716)
    prs = (p.press1 + p.press2) / (p.rho1 * p.rho2)
    if csp.tkernel == TpKernel.CUBIC:
        prs = prs + K.cubic_tensil(csp, rr2s, p.rho1, p.press1, p.rho2, p.press2)
    # every force term is a coefficient times fr (or dv): accumulate the
    # coefficient and expand to components once
    cfr = -(w_mom * prs * p.mass2)
    cdv = None

    # continuity (JSphCpu.cpp:720, bound form :601)
    ar = w_comp * p.mass2 * dvfr * (p.rho1 / p.rho2)

    # density diffusion term
    delta = delta_blocked = None
    if opts.tdensity != TpDensity.NONE:
        w_ddt = w_mom * (1.0 - p.ft_t.astype(f32))
        if opts.tdensity == TpDensity.MOLTENI:
            # Molteni & Colagrossi 2009 (JSphCpu.cpp:724-731)
            visc_densi = ddtkh * cbar * (p.rho1 / p.rho2 - 1.0) / (rr2s + eta2)
            delta = w_ddt * visc_densi * drfr * p.mass2
            blocked = p.pair & (~p.bound_t) & ~p.ft_t
            if opts.tboundary == TpBoundary.DBC:
                blocked_b = blocked & p.bound_c
            else:
                blocked_b = jnp.zeros_like(p.bound_c)
            delta_blocked = blocked_b | (blocked & p.ft_c)
        else:
            # Fourtakas et al. 2019 (JSphCpu.cpp:733-740); FULL also applies
            # to bound pairs without the poison
            applies = (jnp.ones_like(p.bound_c)
                       if opts.tdensity == TpDensity.FOURTAKAS else ~p.bound_c)
            rh = 1.0 + csp.ddtgz * drz
            drhop = csp.rhopzero * rh ** (1.0 / csp.gamma) - csp.rhopzero
            visc_densi = ddtkh * cbar * ((p.rho2 - p.rho1) - drhop) / (rr2s + eta2)
            w2 = w_ddt * (applies & ~p.ft_c & ~p.bound_c).astype(f32)
            delta = -w2 * visc_densi * drfr * p.mass2 / p.rho2
            delta_blocked = (p.pair & (~p.bound_t) & ~p.ft_t & p.bound_c
                             & applies)

    # shifting accumulators (JSphCpu.cpp:743-750)
    shift = shift_blocked = None
    if opts.shiftmode != TpShifting.NONE:
        massrhop = w_mom * p.mass2 / p.rho2
        shift = (massrhop * frx, massrhop * fry, massrhop * frz,
                 -massrhop * drfr)
        if opts.shiftmode == TpShifting.NO_BOUND:
            shift_blocked = p.pair & (~p.bound_t) & (p.bound_c | p.ft_c)
        elif opts.shiftmode == TpShifting.NO_FIXED:
            shift_blocked = p.pair & (~p.bound_t) & p.fixed_c
        else:
            shift_blocked = jnp.zeros_like(p.pair)

    # viscosity (JSphCpu.cpp:757-791)
    visc = jnp.where(w_comp > 0, dot_rr2, _NEG)
    visco_eff = jnp.where(p.bound_c, visco * jnp.float32(csp.viscoboundfactor),
                          visco)
    gradvel = None
    extra = (0.0, 0.0, 0.0)
    if opts.tvisco == TpVisco.ARTIFICIAL:
        amubar = csp.kernelh * dot_rr2
        robar = (p.rho1 + p.rho2) * 0.5
        pi_visc = jnp.where((dot < 0) & (w_mom > 0),
                            (-visco_eff * cbar * amubar / robar) * p.mass2, 0.0)
        cfr = cfr - pi_visc
    elif opts.tvisco == TpVisco.LAMINAR_SPS:
        robar2 = p.rho1 + p.rho2
        temp = 4.0 * visco_eff / ((rr2s + eta2) * robar2)
        cdv = w_mom * p.mass2 * temp * drfr
        keep_c = ~p.bound_c & ~p.ft_c
        txx, txy, txz, tyy, tyz, tzz = (
            a + jnp.where(keep_c, b, 0.0) for a, b in zip(p.tau_t, p.tau_c))
        m2w = w_mom * p.mass2
        extra = (m2w * (txx * frx + txy * fry + txz * frz),
                 m2w * (txy * frx + tyy * fry + tyz * frz),
                 m2w * (txz * frx + tyz * fry + tzz * frz))
        volp2 = -(w_mom * (1.0 - p.ft_t.astype(f32))) * p.mass2 / p.rho2
        gx, gy, gz = dvx * volp2, dvy * volp2, dvz * volp2
        gradvel = (gx * frx, gx * fry + gy * frx, gx * frz + gz * frx,
                   gy * fry, gy * frz + gz * fry, gz * frz)

    fr3, dv3 = (frx, fry, frz), (dvx, dvy, dvz)
    ace = tuple(cfr * fr3[i] + extra[i]
                + (0.0 if cdv is None else cdv * dv3[i]) for i in range(3))
    return PairTerms(ace=ace, ar=ar, delta=delta, delta_blocked=delta_blocked,
                     shift=shift, shift_blocked=shift_blocked, gradvel=gradvel,
                     visc=visc)


def particle_flags(csp: CteSph, code, ftomassp=None, with_floating=False):
    """Per-particle masks + mass derived from typecodes (one place, reused by
    every layout)."""
    ptype = td.code_type(code)
    fluidside = ptype >= td.TYPE_FLOATING
    floating = ptype == td.TYPE_FLOATING
    fixed = ptype == td.TYPE_FIXED
    if with_floating and ftomassp is not None:
        mass = jnp.where(floating,
                         jnp.take(ftomassp, td.code_value(code), mode="clip"),
                         jnp.where(fluidside, csp.massfluid, csp.massbound)
                         .astype(jnp.float32))
    else:
        mass = jnp.where(fluidside, csp.massfluid, csp.massbound).astype(jnp.float32)
    return fluidside, floating, fixed, mass
