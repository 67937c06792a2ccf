"""Floating rigid bodies: 6-DOF solve from SPH particle forces.

Re-design of the reference floating-body machinery
(`JSphCpuSingle::RunFloating` JSphCpuSingle.cpp:897-1016, GPU twins
`KerFtCalcForcesSum/KerFtCalcForces/KerFtCalcForcesRes/KerFtUpdate`
`JSphGpu_ker.cu:2032-2360`):

* per-body force/torque = segment-sum of particle accelerations
  (`FtCalcForcesSum`): one scatter-add keyed by the typecode body index —
  no FtRidp indirection needed because typecodes carry the body id;
* angular acceleration = I^-1 * torque with the initial inertia tensor
  rotated to the current orientation, I = R I0 R^T (`FtCalcForces`);
* semi-implicit update: center += fvel*dt (old fvel); fvel += face*dt;
  fomega += omegaace*dt (`FtCalcForcesRes`), with 2-D component zeroing,
  DOF constraints (`FtApplyConstraints`, TpFtConstrains DualSphDef.h:445),
  and the FtPause warm-up freeze;
* particle update: ballistic pos += dt*vel then rigid velocity
  vel = fvel + fomega x (pos - center) — exactly the reference order;
* body state (center/fvel/fomega/angles) commits only on the corrector
  (predictor=False), matching `RunFloating`'s ``if(!predictor)``.

Chrono/MoorDyn couplings attach at the same place the reference calls the
closed libs (external force hook) — see features/forcepoints (later round).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph


@dataclass(frozen=True)
class FloatingCfg:
    """Static per-body constants (reference StFloatingData constants,
    DualSphDef.h:227-243).  Tuples of length B (hashable)."""
    count: int
    mass: tuple           # (B,) total mass
    massp: tuple          # (B,) per-particle mass
    inertia0: tuple       # (B*9,) initial inertia tensors (row-major)
    ftpause: float = 0.0
    translation_dof: tuple = ()   # (B*3,) 1/0; empty = all free
    rotation_dof: tuple = ()
    mkbound: tuple = ()           # (B,) source mkbound per body (io/chrono)
    # (B*3,) per-body SPH-force scaling (chrono <scaleforce>, the factor the
    # reference applies to forces handed to libdsphchrono); empty = 1
    scaleforce: tuple = ()


@jax.tree_util.register_dataclass
@dataclass
class FloatingState:
    """Dynamic body state (reference StFloatingData dynamics)."""
    center: jax.Array     # (B,3)
    fvel: jax.Array       # (B,3)
    fomega: jax.Array     # (B,3)
    angles: jax.Array     # (B,3) accumulated rotation (rad), ref 'angles'


def _euler_rot(ang):
    """Rotation matrix from accumulated XYZ rotation angles (the reference
    composes fmath::RotMatrix3x3(angles); adequate for the incremental
    integration it feeds)."""
    cx, sx = jnp.cos(ang[..., 0]), jnp.sin(ang[..., 0])
    cy, sy = jnp.cos(ang[..., 1]), jnp.sin(ang[..., 1])
    cz, sz = jnp.cos(ang[..., 2]), jnp.sin(ang[..., 2])
    rx = jnp.stack([jnp.stack([jnp.ones_like(cx), 0 * cx, 0 * cx], -1),
                    jnp.stack([0 * cx, cx, -sx], -1),
                    jnp.stack([0 * cx, sx, cx], -1)], -2)
    ry = jnp.stack([jnp.stack([cy, 0 * cy, sy], -1),
                    jnp.stack([0 * cy, jnp.ones_like(cy), 0 * cy], -1),
                    jnp.stack([-sy, 0 * cy, cy], -1)], -2)
    rz = jnp.stack([jnp.stack([cz, -sz, 0 * cz], -1),
                    jnp.stack([sz, cz, 0 * cz], -1),
                    jnp.stack([0 * cz, 0 * cz, jnp.ones_like(cz)], -1)], -2)
    return rz @ ry @ rx


def run_floating(cfg: FloatingCfg, csp: CteSph, fts: FloatingState,
                 t, dt, predictor: bool, pos, vel, code, ace,
                 ext_face=None, ext_fomegaace=None, chrono=None,
                 chcontact=None, psum_axis=None):
    """One floating update.  Returns (pos, vel, new_state).

    ``chrono``: optional features.chrono.ChronoCfg — when present, body
    accelerations come from the constrained KKT solve (joints/springs)
    instead of the independent per-body solve, the attachment point where
    the reference exchanges state with libdsphchrono
    (`JSphCpuSingle.cpp:930-945`).  ``chcontact``: optional
    features.chcollision.ChContactCfg — mesh-collision forces joining the
    same accumulators (the reference's Chrono NSC/SMC contact).

    ``psum_axis``: mesh axis name for domain-decomposed runs — the
    per-particle force/torque sums become partial sums psum'd over the
    axis, after which the (replicated) body solve and the local particle
    update proceed unchanged."""
    B = cfg.count
    f32 = vel.dtype
    floating = td.is_floating(code) & td.is_active(code)
    bidx = jnp.where(floating, td.code_value(code).astype(jnp.int32), B)

    massp = jnp.asarray(cfg.massp, f32)
    mass = jnp.asarray(cfg.mass, f32)
    I0 = jnp.asarray(cfg.inertia0, f32).reshape(B, 3, 3)
    grav = jnp.asarray(csp.gravity, f32)

    # ---- force/torque sums (FtCalcForcesSum) -------------------------------
    # periodic/halo ghost copies never contribute to the sums (the reference
    # builds FtRidp from normal particles only)
    summing = floating & (td.code_special(code) != td.SPECIAL_PERIODIC)
    sidx = jnp.where(summing, bidx, B)
    mp = jnp.where(summing, massp[jnp.minimum(bidx, B - 1)], 0.0)
    force = ace * mp[:, None]
    if cfg.scaleforce:
        # chrono <scaleforce>: scale each particle's force vector before the
        # sums so the torque is the torque OF the scaled forces
        sf_scale = jnp.asarray(cfg.scaleforce, f32).reshape(B, 3)
        force = force * jnp.take(sf_scale, jnp.minimum(bidx, B - 1), axis=0)
    face_sum = jnp.zeros((B, 3), f32).at[sidx].add(force, mode="drop")
    dist = pos - jnp.take(fts.center, jnp.minimum(bidx, B - 1), axis=0)
    tq = jnp.cross(dist, force)
    fomegaace_sum = jnp.zeros((B, 3), f32).at[sidx].add(tq, mode="drop")
    if psum_axis is not None:
        face_sum = jax.lax.psum(face_sum, psum_axis)
        fomegaace_sum = jax.lax.psum(fomegaace_sum, psum_axis)
    if ext_face is not None:
        face_sum = face_sum + ext_face
    if ext_fomegaace is not None:
        fomegaace_sum = fomegaace_sum + ext_fomegaace

    # ---- body accelerations (FtCalcForces) ---------------------------------
    R = _euler_rot(fts.angles)
    inert = R @ I0 @ jnp.swapaxes(R, -1, -2)
    if chcontact is not None:
        from . import chcollision as CC
        cface, ctq, _ = CC.contact_forces(chcontact, B, R, fts.center,
                                          fts.fvel, fts.fomega, dt)
        face_sum = face_sum + cface
        fomegaace_sum = fomegaace_sum + ctq
    if chrono is not None:
        from . import chrono as CH
        sf, st_ = CH.spring_forces(chrono, R, fts.center, fts.fvel,
                                   fts.fomega, f32=f32)
        tq_tor = CH.hinge_torsion(chrono, R, fts.fomega, fts.angles, f32=f32)
        face, omegaace = CH.solve_constrained(
            chrono, mass, inert, R, fts.center, fts.fvel, fts.fomega,
            face_sum + sf + mass[:, None] * grav,
            fomegaace_sum + st_ + tq_tor, dt)
    else:
        omegaace = jnp.linalg.solve(inert, fomegaace_sum[..., None])[..., 0]
        face = (face_sum + mass[:, None] * grav) / mass[:, None]

    # ---- result integration (FtCalcForcesRes) ------------------------------
    fomega = fts.fomega + dt * omegaace
    fvel = fts.fvel
    if csp.simulate2d:
        face = face.at[:, 1].set(0.0)
        fomega = fomega.at[:, 0].set(0.0).at[:, 2].set(0.0)
        fvel = fvel.at[:, 1].set(0.0)
    fcenter = fts.center + dt * fvel
    fvel = fvel + dt * face

    # ---- DOF constraints (FtApplyConstraints) ------------------------------
    if cfg.translation_dof:
        tdof = jnp.asarray(cfg.translation_dof, f32).reshape(B, 3)
        fvel = fvel * tdof
        fcenter = fts.center + (fcenter - fts.center) * tdof
    if cfg.rotation_dof:
        rdof = jnp.asarray(cfg.rotation_dof, f32).reshape(B, 3)
        fomega = fomega * rdof

    # ---- FtPause freeze ------------------------------------------------------
    frozen = t < cfg.ftpause
    fcenter = jnp.where(frozen, fts.center, fcenter)
    fvel = jnp.where(frozen, jnp.zeros_like(fvel), fvel)
    fomega = jnp.where(frozen, jnp.zeros_like(fomega), fomega)

    # ---- particle update ----------------------------------------------------
    newpos = jnp.where((floating & ~frozen)[:, None], pos + dt * vel, pos)
    dist = newpos - jnp.take(fcenter, jnp.minimum(bidx, B - 1), axis=0)
    fv = jnp.take(fvel, jnp.minimum(bidx, B - 1), axis=0)
    fo = jnp.take(fomega, jnp.minimum(bidx, B - 1), axis=0)
    rigidvel = fv + jnp.cross(fo, dist)
    newvel = jnp.where((floating & ~frozen)[:, None], rigidvel, vel)

    # ---- commit body state on corrector only --------------------------------
    if predictor:
        new_state = fts
    else:
        new_state = FloatingState(
            center=jnp.where(frozen, fts.center, fcenter),
            fvel=jnp.where(frozen, fts.fvel, fvel),
            fomega=jnp.where(frozen, fts.fomega, fomega),
            angles=jnp.where(frozen, fts.angles, fts.angles + fomega * dt))
    return newpos, newvel, new_state


def make_floating(body_particles, body_rho, csp: CteSph, *, ftpause=0.0,
                  translation_dof=None, rotation_dof=None):
    """Build (FloatingCfg, FloatingState) from per-body particle positions.
    Mass/center/inertia computed from the lattice like GenCase does for
    `<floatings>` blocks (massbody = rhopbody * dp^dim * count)."""
    B = len(body_particles)
    masses, massps, inert, centers = [], [], [], []
    dim = 2 if csp.simulate2d else 3
    for pts, rhob in zip(body_particles, body_rho):
        pts = np.asarray(pts, np.float64)
        n = len(pts)
        mp = rhob * csp.dp ** dim
        m = mp * n
        c = pts.mean(axis=0)
        r = pts - c
        ixx = (mp * (r[:, 1] ** 2 + r[:, 2] ** 2)).sum()
        iyy = (mp * (r[:, 0] ** 2 + r[:, 2] ** 2)).sum()
        izz = (mp * (r[:, 0] ** 2 + r[:, 1] ** 2)).sum()
        ixy = -(mp * r[:, 0] * r[:, 1]).sum()
        ixz = -(mp * r[:, 0] * r[:, 2]).sum()
        iyz = -(mp * r[:, 1] * r[:, 2]).sum()
        I = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        if csp.simulate2d:
            # keep the matrix invertible in 2-D (only Iyy matters)
            I[0, 0] = max(I[0, 0], 1e-12)
            I[2, 2] = max(I[2, 2], 1e-12)
        masses.append(m)
        massps.append(mp)
        inert.append(I.reshape(-1))
        centers.append(c)
    cfg = FloatingCfg(
        count=B,
        mass=tuple(float(m) for m in masses),
        massp=tuple(float(m) for m in massps),
        inertia0=tuple(float(x) for I in inert for x in I),
        ftpause=ftpause,
        translation_dof=(tuple(float(x) for d in translation_dof for x in d)
                         if translation_dof else ()),
        rotation_dof=(tuple(float(x) for d in rotation_dof for x in d)
                      if rotation_dof else ()),
    )
    state = FloatingState(
        center=jnp.asarray(np.array(centers), jnp.float32),
        fvel=jnp.zeros((B, 3), jnp.float32),
        fomega=jnp.zeros((B, 3), jnp.float32),
        angles=jnp.zeros((B, 3), jnp.float32),
    )
    return cfg, state
