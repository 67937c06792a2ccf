"""Time integrators: Symplectic predictor/corrector and Verlet, plus the
variable-dt controller.

Re-designs of the reference integrator routines as pure functions over
canonical particle arrays (masks instead of the [0,Npb)/[Npb,Np) loop split):

* `JSphCpu::ComputeSymplecticPre`  (JSphCpu.cpp:1406)
* `JSphCpu::ComputeSymplecticCorr` (JSphCpu.cpp:1510)
* `JSphCpu::ComputeVerletVarsFluid`/`ComputeVelrhopBound`/`ComputeVerlet`
  (JSphCpu.cpp:1300-1400)
* `JSphCpu::DtVariable` (JSphCpu.cpp:1614-1639)

Gravity is added here (interaction `ace` excludes it, as in the reference).
Density floors for bound/floating particles (avoid fluid absorption) follow
the reference exactly.  Out-of-range density marks formerly-normal fluid
particles OUT_RHOP (`CODE_SetOutRhop`); they are dropped from the cell
structure at the next divide.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph


def _split_masks(code):
    bound = td.is_bound(code) & td.is_active(code)
    floating = td.is_floating(code) & td.is_active(code)
    fluid = td.is_fluid(code) & td.is_active(code)
    return bound, floating, fluid


def _mark_outrhop(csp: CteSph, code, rho, fluid):
    out = fluid & td.is_normal(code) & ((rho < csp.rhopoutmin) | (rho > csp.rhopoutmax))
    return jnp.where(out, td.code_set_special(code, td.SPECIAL_OUT_RHOP), code)


def symplectic_pre(csp: CteSph, pos, vel, rho, code, ace, ar, dt):
    """Predictor half-step (JSphCpu.cpp:1406-1500).  Returns
    (pos_new, vel_new, rho_new, code_new); callers keep the inputs as the
    ``Pre`` arrays for the corrector."""
    f32 = vel.dtype
    dt05 = dt * 0.5
    bound, floating, fluid = _split_masks(code)
    grav = jnp.asarray(csp.gravity, f32)

    rho_new = rho + dt05 * ar
    rho_new = jnp.where((bound | floating) & (rho_new < csp.rhopzero),
                        csp.rhopzero, rho_new)

    vel_new = vel + (ace + grav) * dt05
    # bound/floating velocities pass through unchanged: fixed walls stay 0,
    # MOVING walls keep the velocity RunMotion assigned (the reference never
    # rewrites bound velrhop.xyz in the integrator), floating bodies are
    # overwritten by RunFloating afterwards
    vel_new = jnp.where(fluid[:, None], vel_new, vel)

    pos_new = jnp.where(fluid[:, None], pos + vel * dt05, pos)

    code_new = _mark_outrhop(csp, code, rho_new, fluid)
    return pos_new, vel_new, rho_new, code_new


def comp_pos_update(pos, pose, disp, fluid):
    """Compensated (Kahan two-sum) position accumulation: ``pos + pose``
    carries the true position to ~2x24-bit precision while the stored
    ``pos`` stays plain f32 for the pair kernels.

    This is the answer to the reference's f64 positions + f32 PosCell
    pair math (`JSphGpu_ker.h:45`, SURVEY §5.7): per-step displacements are
    orders of magnitude below the position's f32 ulp at domain scale, so a
    plain `pos += disp` drifts (or stalls outright once disp < ulp/2); the
    recovered rounding error rides along in ``pose`` and re-enters the next
    update, keeping long-run trajectories at reference precision without
    f64 anywhere in the hot path."""
    y = disp + pose
    pos_new = pos + y
    pose_new = y - (pos_new - pos)
    fl = fluid[:, None]
    return (jnp.where(fl, pos_new, pos),
            jnp.where(fl, pose_new, pose))


def symplectic_corr(csp: CteSph, pos_pre, vel_pre, rho_pre, rho_now, code,
                    ace, ar, dt, shiftdisp=None, pose=None):
    """Corrector full step (JSphCpu.cpp:1510-1610).  ``rho_now`` is the
    predictor-stage density (used in the epsilon-rdot update).  ``pose``:
    compensated-position residual (see comp_pos_update) — when given, a
    fifth output returns its update."""
    f32 = vel_pre.dtype
    dt05 = dt * 0.5
    bound, floating, fluid = _split_masks(code)
    grav = jnp.asarray(csp.gravity, f32)

    eps_rdot = (-ar / rho_now) * dt
    rho_new = rho_pre * (2.0 - eps_rdot) / (2.0 + eps_rdot)
    rho_new = jnp.where((bound | floating) & (rho_new < csp.rhopzero),
                        csp.rhopzero, rho_new)

    vel_new = vel_pre + (ace + grav) * dt
    vel_new = jnp.where(fluid[:, None], vel_new, vel_pre)

    disp = (vel_pre + vel_new) * dt05
    if shiftdisp is not None:
        disp = disp + shiftdisp
    code_new = _mark_outrhop(csp, code, rho_new, fluid)
    if pose is not None:
        pos_new, pose_new = comp_pos_update(pos_pre, pose, disp, fluid)
        return pos_new, vel_new, rho_new, code_new, pose_new
    pos_new = jnp.where(fluid[:, None], pos_pre + disp, pos_pre)
    return pos_new, vel_new, rho_new, code_new


def verlet(csp: CteSph, pos, vel, rho, velm1, rhom1, code, ace, ar, dt,
           use_m1, shiftdisp=None, pose=None):
    """Verlet step (JSphCpu.cpp:1300-1400).  ``use_m1`` selects the leapfrog
    (dt2=2dt against the M1 state) vs the periodic Euler re-anchoring step
    (every ``VerletSteps``).  Returns (pos, vel_new, rho_new, code[, pose]);
    the caller stores (vel, rho) as the next M1 state (the reference's
    array swap)."""
    f32 = vel.dtype
    bound, floating, fluid = _split_masks(code)
    grav = jnp.asarray(csp.gravity, f32)
    acegr = ace + grav

    base_v = jnp.where(use_m1, velm1, vel) if velm1 is not None else vel
    base_r = jnp.where(use_m1, rhom1, rho) if rhom1 is not None else rho
    dt2 = jnp.where(use_m1, 2.0 * dt, dt)

    rho_new = base_r + dt2 * ar
    rho_new = jnp.where((bound | floating) & (rho_new < csp.rhopzero),
                        csp.rhopzero, rho_new)

    vel_new = base_v + acegr * dt2
    vel_new = jnp.where(fluid[:, None], vel_new, vel)

    disp = vel * dt + acegr * (0.5 * dt * dt)
    if shiftdisp is not None:
        disp = disp + shiftdisp
    code_new = _mark_outrhop(csp, code, rho_new, fluid)
    if pose is not None:
        pos_new, pose_new = comp_pos_update(pos, pose, disp, fluid)
        return pos_new, vel_new, rho_new, code_new, pose_new
    pos_new = jnp.where(fluid[:, None], pos + disp, pos)
    return pos_new, vel_new, rho_new, code_new


def dt_variable_parts(csp: CteSph, acemax, velmax, viscdtmax,
                      viscetadtmax=None, lamda=0.2):
    """Adaptive dt (JSphCpu.cpp:1614-1639): dt1 = sqrt(h/|a|max);
    dt2 = h/(max(cs0,10*velmax) + h*viscdtmax); dt = CFL*min, clamped to DtMin.
    Returns (dt, clamped?, dt1, dt2) — dt1/dt2 feed the SaveDt diagnostics
    channel (JDsSaveDt, JSphCpu.cpp:1636).

    ``viscetadtmax`` (multiphase only) adds the mphase viscous control
    dt3 = h^2/(ViscEtaDtMax*lamda) with lamda the RelaxationDt execution
    parameter, default 0.2 (mphase JSphCpu.cpp:1687, JSph.cpp:616)."""
    h = csp.kernelh
    dt1 = jnp.where(acemax > 0, jnp.sqrt(h / jnp.maximum(acemax, 1e-30)),
                    jnp.asarray(3.4e38, acemax.dtype))
    dt2 = h / (jnp.maximum(csp.cs0, velmax * 10.0) + h * viscdtmax)
    dtm = jnp.minimum(dt1, dt2)
    if viscetadtmax is not None:
        dt3 = h * h / jnp.maximum(viscetadtmax * lamda, 1e-30)
        dtm = jnp.minimum(dtm, dt3)
    dt = csp.cflnumber * dtm
    if csp.dtfixed:
        dt = jnp.asarray(csp.dtfixed, dt.dtype)
    bad = jnp.isnan(dt) | jnp.isinf(dt) | (dt < csp.dtmin)
    return jnp.where(bad, csp.dtmin, dt), bad, dt1, dt2


def dt_variable(csp: CteSph, acemax, velmax, viscdtmax,
                viscetadtmax=None, lamda=0.2):
    """(dt, clamped?) — see :func:`dt_variable_parts`."""
    dt, bad, _, _ = dt_variable_parts(csp, acemax, velmax, viscdtmax,
                                      viscetadtmax, lamda)
    return dt, bad


def velocity_max(csp: CteSph, vel, code):
    """Max |v| for the dt control (JSphCpu::PreInteraction_Forces,
    JSphCpu.cpp:452-480): fluid+floating particles unless DtAllParticles."""
    if csp.dtallparticles:
        sel = td.is_active(code)
    else:
        sel = td.is_active(code) & ~td.is_bound(code)
    v2 = jnp.sum(vel * vel, axis=-1)
    return jnp.sqrt(jnp.max(jnp.where(sel, v2, 0.0)))


def ace_max(ace, code):
    """Max |ace| for dt1 (JSphCpuSingle::ComputeAceMax,
    JSphCpuSingle.cpp:584-644): fluid-side normal particles, excluding
    periodic ghosts and inout particles."""
    sel = ~td.is_bound(code) & td.is_normal(code)
    a2 = jnp.sum(ace * ace, axis=-1)
    return jnp.sqrt(jnp.max(jnp.where(sel, a2, 0.0)))
