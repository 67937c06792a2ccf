"""mDBC boundary correction (modified Dynamic Boundary Condition).

Re-design of `JSphCpu::InteractionMdbcCorrectionT2`
(`/root/reference/src/source/JSphCpu.cpp:1020-1190`; GPU twins
`KerInteractionMdbcCorrection_Fast/_Dbl`, `JSphGpu_ker.cu:912-1190`):

for every boundary particle carrying a non-zero normal, a ghost node is
mirrored into the fluid at ``pos + boundnormal``; fluid neighbours of the
ghost node build a first-order moving-least-squares system (3x3 in 2D,
4x4 in 3D) whose solution extrapolates density (and its gradient) back to
the boundary particle; velocity is the 0th-order ghost interpolation with
slip handling:

* VEL0     — boundary velocity stays zero (density only),
* NO_SLIP  — v_bound = 2*v_wall - v_ghost,
* FREE_SLIP — tangential ghost velocity kept, normal reversed.

The determinant-gated solve falls back to the 0th-order Shepard value
(a11 > 0), then to rho0 — exactly the reference's gating.  Everything is a
batched masked linsolve: the reference's per-particle branching becomes a
(nb, d, d) `jnp.linalg.solve` with `jnp.where` selects (branchless, SURVEY
§7 hard part 4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, TpSlipMode
from . import celldiv as cd
from . import kernels as K

DETERMLIMIT = 1e-3   # first-order gate (reference `determlimit`)


def mdbc_correction(csp: CteSph, opts, dom: cd.Domain, div: cd.DivData,
                    pos, vel, rho, code, boundnormal, motionvel=None,
                    origin=None):
    """Returns (vel, rho) with corrected boundary values.  ``origin``:
    traced grid anchor override (sharded slab grids)."""
    n = div.ncap
    f32 = pos.dtype
    sel = (td.is_bound(code) & td.is_active(code)
           & (jnp.sum(boundnormal * boundnormal, axis=1) > 0))

    gpos = pos + boundnormal
    cand = cd.point_candidates(dom, div, gpos, origin)   # (n, M)
    M = cand.shape[1]

    cpos = cd.gather(pos, cand)
    cvel = cd.gather(vel, cand)
    crho = cd.gather(rho, cand, fill=1.0)
    ccode = cd.gather(code, cand,
                      fill=td.code_make(td.TYPE_FIXED, 0, td.SPECIAL_OUT_IGNORE))
    fluid_c = (td.is_fluid(ccode) & td.is_active(ccode) & (cand < n))

    dr = gpos[:, None, :] - cpos                      # (n, M, 3)
    rr2 = jnp.sum(dr * dr, axis=-1)
    ks2 = jnp.asarray(csp.kernelsize2, f32)
    pair = sel[:, None] & fluid_c & (rr2 <= ks2)
    pw = pair.astype(f32)
    rr2s = jnp.where(pair, rr2, ks2)

    wab = pw * K.kernel_wab(csp, rr2s)
    fac = pw * K.kernel_fac(csp, rr2s)
    frx = fac * dr[..., 0]
    fry = fac * dr[..., 1]
    frz = fac * dr[..., 2]

    massp2 = jnp.asarray(csp.massfluid, f32)
    volp2 = massp2 / crho

    # density + gradient RHS (mass-weighted)
    rhop1 = jnp.sum(massp2 * wab, axis=1)
    grx = jnp.sum(massp2 * frx, axis=1)
    gry = jnp.sum(massp2 * fry, axis=1)
    grz = jnp.sum(massp2 * frz, axis=1)

    vwab = wab * volp2
    sumwab = jnp.sum(vwab, axis=1)
    vfrx, vfry, vfrz = frx * volp2, fry * volp2, frz * volp2

    velg = jnp.einsum("nm,nmd->nd", vwab, cvel)      # 0th-order ghost velocity

    dx, dy, dz = dr[..., 0], dr[..., 1], dr[..., 2]
    if csp.simulate2d:
        # rows: [shepard, d/dx, d/dz]; cols: [1, dx, dz]
        rows = (vwab, vfrx, vfrz)
        b = jnp.stack([rhop1, grx, grz], axis=-1)
        d = 3
        amat = jnp.stack([
            jnp.stack([jnp.sum(r, 1), jnp.sum(r * dx, 1), jnp.sum(r * dz, 1)],
                      axis=-1) for r in rows], axis=-2)
        dpos = -boundnormal[:, (0, 2)]
    else:
        rows = (vwab, vfrx, vfry, vfrz)
        b = jnp.stack([rhop1, grx, gry, grz], axis=-1)
        d = 4
        amat = jnp.stack([
            jnp.stack([jnp.sum(r, 1), jnp.sum(r * dx, 1), jnp.sum(r * dy, 1),
                       jnp.sum(r * dz, 1)], axis=-1) for r in rows], axis=-2)
        dpos = -boundnormal

    determ = jnp.linalg.det(amat)
    ok1 = jnp.abs(determ) >= DETERMLIMIT
    eye = jnp.eye(d, dtype=f32)
    amat_safe = jnp.where(ok1[:, None, None], amat, eye)
    sol = jnp.linalg.solve(amat_safe, b[..., None])[..., 0]   # (n, d)
    rhoghost = sol[:, 0]
    grad = -sol[:, 1:]
    rho1st = rhoghost + jnp.sum(grad * dpos, axis=-1)

    a11 = amat[:, 0, 0]
    rho0th = rhop1 / jnp.where(a11 > 0, a11, 1.0)
    rhofinal = jnp.where(ok1, rho1st,
                         jnp.where(a11 > 0, rho0th, csp.rhopzero))

    # threshold on kernel completeness (-mdbc_threshold; 0 = always apply)
    if opts.mdbc_threshold > 0:
        apply = sel & (sumwab >= opts.mdbc_threshold)
    else:
        apply = sel

    new_rho = jnp.where(apply, rhofinal, rho)

    if opts.slipmode == TpSlipMode.VEL0:
        return vel, new_rho

    a11s = jnp.where(a11 > 0, a11, 1.0)
    vg = velg / a11s[:, None]
    if csp.simulate2d:
        vg = vg.at[:, 1].set(0.0)
    mv = motionvel if motionvel is not None else jnp.zeros_like(vel)
    if opts.slipmode == TpSlipMode.NO_SLIP:
        vfinal = 2.0 * mv - vg
    else:  # FREE_SLIP (reference marks experimental; same formulation)
        norm = jnp.sqrt(jnp.sum(boundnormal * boundnormal, axis=1,
                                keepdims=True))
        nhat = jnp.abs(boundnormal) / jnp.where(norm > 0, norm, 1.0)
        normvel = vg * nhat
        tangvel = vg - normvel
        moving = jnp.sum(mv * mv, axis=1, keepdims=True) > 0
        normmot = mv * nhat
        vfinal = jnp.where(moving, 2.0 * normmot - normvel, tangvel - normvel)
    new_vel = jnp.where(apply[:, None], vfinal, vel)
    return new_vel, new_rho
