"""Scripted boundary motion (moving walls, pistons, flaps).

Re-design of the reference motion stack (`JMotion.h/cpp` +
`JMotionMov.h` movement primitives + `JDsMotion` solver adapter,
~3,300 LoC of hierarchical object/event machinery, SURVEY §2.9): here a
motion is a *pure function of time* evaluated inside the jitted step — a
per-moving-mk piecewise timeline of analytic primitives, compiled to masked
jnp arithmetic (no event objects, no host round-trips).

Primitives (mirroring `JMotionMov.h:78-319`): wait, rectilinear (constant
velocity), rectilinear-accelerated, sinusoidal-rectilinear, rotation about an
axis (constant/accelerated/sinusoidal angular velocity), and time-series
tables with linear interpolation (the `JLinearValue`/`mvfile` path).

The solver applies the result exactly like `JSphCpu::RunMotion`
(JSphCpu.cpp:1752-1790): moving bound particles get a per-step displacement
(linear or rotational) and carry the motion velocity into the next force
interaction (DBC walls push fluid through the dv terms).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .. import typesdef as td

# segment kinds
WAIT = 0
RECT = 1       # constant velocity;        params: vx vy vz
RECT_ACE = 2   # accelerated linear;       params: vx0.. ax..
SIN_RECT = 3   # sinusoidal linear;        params: freq, phase, ampx..z
ROT = 4        # constant angular vel;     params: axis p1(3), p2(3), degrees/s
ROT_ACE = 5    # accelerated rotation;     params: + ang accel
SIN_ROT = 6    # sinusoidal rotation;      params: axis p1, p2, freq, phase, amp(deg)
TABLE = 7      # time series (linear interp) of velocity
SPECTRUM = 8   # multi-component sinusoid sum (irregular/focused waves);
#                params: dir(3), ramptime; times: omegas; values: (amp,phase)*
SPECTRUM_ROT = 9  # rotational spectrum; params: p1(3) p2(3) ramptime;
#                   params: times: omegas; values: (amp_rad, phase)*
# circular-path family (JMotionMovCir*: the object TRANSLATES along the
# circle a reference point sweeps about the axis — orientation unchanged,
# unlike mvrot); params: axis p1(3), p2(3), <angle-law like the rot twin>,
# then ref(3) LAST
CIR = 10       # params: p1 p2 deg/s _ _ ref(3)  (law slots match ROT)
CIR_ACE = 11   # params: p1 p2 w0 acc _ ref(3)
SIN_CIR = 12   # params: p1 p2 freq phase amp(deg) ref(3)
ROT_FILE = 13  # rotation angle time-series (mvrotfile); params p1 p2;
#                times: t knots, values: angle(rad) knots
TABLE_POS = 14  # position time-series (mvrectfile: fields are POSITIONS);
#                times: t knots, values: (x,y,z) knots

# angle law shared with the rotational twin (same params[6:] layout)
_CIR_LAW = {CIR: ROT, CIR_ACE: ROT_ACE, SIN_CIR: SIN_ROT}


@dataclass(frozen=True)
class Segment:
    kind: int
    t0: float
    t1: float
    params: tuple = ()
    # TABLE payload (times, vel (k,3)) as tuples for hashability
    times: tuple = ()
    values: tuple = ()


@dataclass(frozen=True)
class MotionDef:
    """Timeline of segments for one moving mk block."""
    mk: int
    segments: tuple  # of Segment
    loop_t: float = 0.0   # if >0, timeline repeats with this period
    # loop window start: times past loop_start wrap into
    # [loop_start, loop_start + loop_t) — the reference's movement chains
    # whose ``next`` points back mid-timeline (begin start= offsets)
    loop_start: float = 0.0
    # motion freeze time (begin finish=..): no displacement past it
    t_end: float = 0.0


def _wgramp(t, tr):
    """JWaveGen startup ramp envelope: tau^2(3tau^2-8tau+6), tau=min(t/tr,1)
    (JWaveRegular::CalcFunRamp; env(1)=1, env'(1)=0)."""
    tau = jnp.minimum(t / tr, 1.0)
    return tau * tau * (3.0 * tau * tau - 8.0 * tau + 6.0)


def _wgramp_d(t, tr):
    """d/dt of _wgramp."""
    tau = jnp.minimum(t / tr, 1.0)
    return jnp.where(t < tr, 12.0 * tau * (tau - 1.0) ** 2 / tr, 0.0)


def _segment_disp_vel(seg: Segment, t0, t1):
    """Analytic displacement over [t0,t1] (clipped to the segment) and the
    velocity at t1 for linear primitives; returns (disp (3,), vel (3,)).
    Times are relative to the segment start."""
    a = jnp.maximum(t0 - seg.t0, 0.0)
    b = jnp.clip(t1 - seg.t0, 0.0, seg.t1 - seg.t0)
    b = jnp.maximum(b, a)
    active_end = (t1 >= seg.t0) & (t1 < seg.t1)
    if seg.kind == RECT:
        v = jnp.asarray(seg.params[:3], jnp.float32)
        disp = v * (b - a)
        vel = jnp.where(active_end, v, 0.0)
    elif seg.kind == RECT_ACE:
        v0 = jnp.asarray(seg.params[:3], jnp.float32)
        ac = jnp.asarray(seg.params[3:6], jnp.float32)
        disp = v0 * (b - a) + 0.5 * ac * (b * b - a * a)
        vel = jnp.where(active_end, v0 + ac * b, 0.0)
    elif seg.kind == SIN_RECT:
        f, ph = seg.params[0], seg.params[1]
        amp = jnp.asarray(seg.params[2:5], jnp.float32)
        w = 2.0 * math.pi * f
        if len(seg.params) > 5 and seg.params[5] > 0:
            # startup ramp (JWaveGen 'ramp'): x = env(t) A sin(wt+ph) with
            # the closed lib's quartic env = tau^2(3tau^2 - 8tau + 6)
            # (JWaveRegular::CalcFunRamp, disassembled + fitted to the
            # WavePaddle_mkb CSV to 8e-7; env(1)=1, env'(1)=0)
            tr = seg.params[5]
            ea, eb = _wgramp(a, tr), _wgramp(b, tr)
            disp = amp * (eb * jnp.sin(w * b + ph) - ea * jnp.sin(w * a + ph))
            denv = _wgramp_d(b, tr)
            vel = jnp.where(active_end,
                            amp * (denv * jnp.sin(w * b + ph)
                                   + eb * w * jnp.cos(w * b + ph)), 0.0)
        else:
            disp = amp * (jnp.sin(w * b + ph) - jnp.sin(w * a + ph))
            vel = jnp.where(active_end, amp * w * jnp.cos(w * b + ph), 0.0)
    elif seg.kind == SPECTRUM:
        dirv = jnp.asarray(seg.params[:3], jnp.float32)
        tr = seg.params[3] if len(seg.params) > 3 else 0.0
        w = jnp.asarray(seg.times, jnp.float32)
        ap = jnp.asarray(seg.values, jnp.float32).reshape(-1, 2)
        amp, ph = ap[:, 0], ap[:, 1]

        def x_of(tt):
            s = jnp.sum(amp * jnp.sin(w * tt + ph))
            if tr > 0:
                return _wgramp(tt, tr) * s
            return s

        def v_of(tt):
            dv = jnp.sum(amp * w * jnp.cos(w * tt + ph))
            if tr > 0:
                return (_wgramp(tt, tr) * dv
                        + _wgramp_d(tt, tr) * jnp.sum(amp * jnp.sin(w * tt
                                                                    + ph)))
            return dv

        disp = dirv * (x_of(b) - x_of(a))
        vel = jnp.where(active_end, dirv * v_of(b), 0.0)
    elif seg.kind == TABLE:
        # knots are stored absolute; a/b are segment-relative
        times = jnp.asarray(seg.times, jnp.float32) - seg.t0
        vals = jnp.asarray(seg.values, jnp.float32).reshape(len(seg.times), 3)
        # displacement = integral of piecewise-linear velocity; evaluate via
        # cumulative trapezoid sampled at the segment knots
        cum = jnp.concatenate([
            jnp.zeros((1, 3), jnp.float32),
            jnp.cumsum(0.5 * (vals[1:] + vals[:-1])
                       * (times[1:] - times[:-1])[:, None], axis=0)], axis=0)

        def pos_at(tt):
            tt = jnp.clip(tt, times[0], times[-1])
            i = jnp.clip(jnp.searchsorted(times, tt, side="right") - 1,
                         0, len(seg.times) - 2)
            dtl = tt - times[i]
            vi = vals[i] + (vals[i + 1] - vals[i]) * (
                dtl / jnp.maximum(times[i + 1] - times[i], 1e-12))
            return cum[i] + 0.5 * (vals[i] + vi) * dtl, vi

        pa, _ = pos_at(a)
        pb, vb = pos_at(b)
        disp = pb - pa
        vel = jnp.where(active_end, vb, 0.0)
    elif seg.kind == TABLE_POS:
        # position time-series (mvrectfile: file columns ARE positions)
        times = jnp.asarray(seg.times, jnp.float32) - seg.t0
        ps = jnp.asarray(seg.values, jnp.float32).reshape(len(seg.times), 3)

        def pos_at(tt):
            tt = jnp.clip(tt, times[0], times[-1])
            i = jnp.clip(jnp.searchsorted(times, tt, side="right") - 1,
                         0, len(seg.times) - 2)
            span = jnp.maximum(times[i + 1] - times[i], 1e-12)
            f = (tt - times[i]) / span
            return (ps[i] + (ps[i + 1] - ps[i]) * f,
                    (ps[i + 1] - ps[i]) / span)

        pa, _ = pos_at(a)
        pb, vb = pos_at(b)
        disp = pb - pa
        vel = jnp.where(active_end, vb, 0.0)
    else:  # WAIT
        disp = jnp.zeros(3, jnp.float32)
        vel = jnp.zeros(3, jnp.float32)
    started = t1 > seg.t0
    return jnp.where(started, disp, 0.0), vel


def _segment_angle(seg: Segment, t0, t1):
    """Rotation angle swept over [t0,t1] (radians) + angular speed at t1."""
    a = jnp.maximum(t0 - seg.t0, 0.0)
    b = jnp.clip(t1 - seg.t0, 0.0, seg.t1 - seg.t0)
    b = jnp.maximum(b, a)
    active_end = (t1 >= seg.t0) & (t1 < seg.t1)
    d2r = math.pi / 180.0
    kind = _CIR_LAW.get(seg.kind, seg.kind)
    if kind == ROT_FILE:
        times = jnp.asarray(seg.times, jnp.float32) - seg.t0
        angs = jnp.asarray(seg.values, jnp.float32)

        def ang_at(tt):
            tt = jnp.clip(tt, times[0], times[-1])
            i = jnp.clip(jnp.searchsorted(times, tt, side="right") - 1,
                         0, len(seg.times) - 2)
            span = jnp.maximum(times[i + 1] - times[i], 1e-12)
            f = (tt - times[i]) / span
            return (angs[i] + (angs[i + 1] - angs[i]) * f,
                    (angs[i + 1] - angs[i]) / span)

        anga, _ = ang_at(a)
        angb, wb = ang_at(b)
        dang = angb - anga
        wend = jnp.where(active_end, wb, 0.0)
        started = t1 > seg.t0
        return jnp.where(started, dang, 0.0), wend
    seg = seg if kind == seg.kind else Segment(
        kind=kind, t0=seg.t0, t1=seg.t1, params=seg.params,
        times=seg.times, values=seg.values)
    if kind == ROT:
        w = seg.params[6] * d2r
        dang = w * (b - a)
        wend = jnp.where(active_end, w, 0.0)
    elif seg.kind == ROT_ACE:
        w0 = seg.params[6] * d2r
        al = seg.params[7] * d2r
        dang = w0 * (b - a) + 0.5 * al * (b * b - a * a)
        wend = jnp.where(active_end, w0 + al * b, 0.0)
    elif seg.kind == SPECTRUM_ROT:
        tr = seg.params[6] if len(seg.params) > 6 else 0.0
        w = jnp.asarray(seg.times, jnp.float32)
        ap = jnp.asarray(seg.values, jnp.float32).reshape(-1, 2)
        amp, ph = ap[:, 0], ap[:, 1]

        def ang_of(tt):
            s = jnp.sum(amp * jnp.sin(w * tt + ph))
            if tr > 0:
                return _wgramp(tt, tr) * s
            return s

        def w_of(tt):
            dv = jnp.sum(amp * w * jnp.cos(w * tt + ph))
            if tr > 0:
                return (_wgramp(tt, tr) * dv
                        + _wgramp_d(tt, tr) * jnp.sum(amp * jnp.sin(w * tt
                                                                    + ph)))
            return dv

        dang = ang_of(b) - ang_of(a)
        wend = jnp.where(active_end, w_of(b), 0.0)
    else:  # SIN_ROT
        f, ph, amp = seg.params[6], seg.params[7], seg.params[8] * d2r
        w = 2.0 * math.pi * f
        if len(seg.params) > 9 and seg.params[9] > 0:
            # JWaveGen startup ramp (same quartic as the linear paddles)
            tr = seg.params[9]
            ea, eb = _wgramp(a, tr), _wgramp(b, tr)
            dang = amp * (eb * jnp.sin(w * b + ph) - ea * jnp.sin(w * a + ph))
            wend = jnp.where(active_end,
                             amp * (_wgramp_d(b, tr) * jnp.sin(w * b + ph)
                                    + eb * w * jnp.cos(w * b + ph)), 0.0)
        else:
            dang = amp * (jnp.sin(w * b + ph) - jnp.sin(w * a + ph))
            wend = jnp.where(active_end, amp * w * jnp.cos(w * b + ph), 0.0)
    started = t1 > seg.t0
    return jnp.where(started, dang, 0.0), wend


def _axis_of(seg: Segment):
    p1 = np.asarray(seg.params[:3], np.float32)
    p2 = np.asarray(seg.params[3:6], np.float32)
    ax = p2 - p1
    ax = ax / max(np.linalg.norm(ax), 1e-12)
    return jnp.asarray(p1), jnp.asarray(ax)


def _rot_matrix(axis, ang):
    """Rodrigues rotation matrix (3,3) about unit axis by ang."""
    c = jnp.cos(ang)
    s = jnp.sin(ang)
    x, y, z = axis[0], axis[1], axis[2]
    kmat = jnp.array([[0.0, -1.0, 1.0], [1.0, 0.0, -1.0], [-1.0, 1.0, 0.0]])
    kmat = jnp.stack([jnp.stack([0.0 * x, -z, y]),
                      jnp.stack([z, 0.0 * x, -x]),
                      jnp.stack([-y, x, 0.0 * x])])
    eye = jnp.eye(3)
    return eye * c + s * kmat + (1 - c) * jnp.outer(axis, axis)


def motion_step(mdef: MotionDef, t, dt):
    """Evaluate one moving block over [t, t+dt].

    Returns (lin_disp (3,), vel (3,), rot (3,3), rot_center (3,), is_rot).
    Composition across segments is additive for linear moves and
    angle-additive for rotations about a common axis (the dominant reference
    use cases: pistons, flaps, gates)."""
    if mdef.t_end:
        te = jnp.float32(mdef.t_end)
        t, dt = jnp.minimum(t, te), jnp.maximum(
            jnp.minimum(t + dt, te) - jnp.minimum(t, te), 0.0)
    if mdef.loop_t:
        ls = jnp.float32(mdef.loop_start)
        t = jnp.where(t < ls, t, ls + jnp.mod(t - ls, mdef.loop_t))
    t0 = t
    t1 = t + dt
    disp = jnp.zeros(3, jnp.float32)
    vel = jnp.zeros(3, jnp.float32)
    ang = jnp.zeros((), jnp.float32)
    wvel = jnp.zeros((), jnp.float32)
    axis = jnp.array([0.0, 1.0, 0.0])
    center = jnp.zeros(3, jnp.float32)
    has_rot = False
    for seg in mdef.segments:
        if seg.kind in (ROT, ROT_ACE, SIN_ROT, SPECTRUM_ROT, ROT_FILE):
            da, wv = _segment_angle(seg, t0, t1)
            ang = ang + da
            wvel = wvel + wv
            center, axis = _axis_of(seg)
            has_rot = True
        elif seg.kind in (CIR, CIR_ACE, SIN_CIR):
            # translate along the circle the ref point sweeps: disp =
            # (R(ang1) - R(ang0)) (ref - c), vel = w x radius(t1)
            ang0, _ = _segment_angle(seg, seg.t0, t0)
            ang1, wv = _segment_angle(seg, seg.t0, t1)
            c, ax = _axis_of(seg)
            ref = jnp.asarray(seg.params[-3:], jnp.float32)
            r0 = ref - c
            p0 = _rot_matrix(ax, ang0) @ r0
            p1 = _rot_matrix(ax, ang1) @ r0
            disp = disp + (p1 - p0)
            vel = vel + jnp.cross(wv * ax, p1)
        else:
            d, v = _segment_disp_vel(seg, t0, t1)
            disp = disp + d
            vel = vel + v
    rot = _rot_matrix(axis, ang) if has_rot else jnp.eye(3)
    return disp, vel, rot, center, has_rot, axis, wvel


def apply_motion(motions, t, dt, pos, vel, code):
    """Apply all moving-block motions (the analog of `JSphCpu::RunMotion`,
    JSphCpu.cpp:1762: MoveLinBound / MoveMatBound).  Returns (pos, vel)."""
    if not motions:
        return pos, vel
    moving = td.is_moving(code) & td.is_active(code)
    mkv = td.code_value(code)
    for mdef in motions:
        sel = moving & (mkv == mdef.mk)
        disp, mvel, rot, center, has_rot, axis, wvel = motion_step(mdef, t, dt)
        if has_rot:
            rel = pos - center
            newp = rel @ rot.T + center + disp
            # particle velocity = omega x r (+ linear)
            omega = axis * wvel
            pvel = jnp.cross(jnp.broadcast_to(omega, newp.shape),
                             newp - center) + mvel
        else:
            newp = pos + disp
            pvel = jnp.broadcast_to(mvel, pos.shape)
        pos = jnp.where(sel[:, None], newp, pos)
        vel = jnp.where(sel[:, None], pvel, vel)
    return pos, vel


# ---- convenience constructors ----------------------------------------------

def piston_sinusoidal(mk, *, freq, amplitude, direction=(1.0, 0.0, 0.0),
                      tstart=0.0, tend=1e30, phase=0.0) -> MotionDef:
    """Sinusoidal piston (wavemaker building block; `JMotionMov` MovRectSinu)."""
    d = np.asarray(direction, np.float64)
    amp = tuple(float(a) for a in amplitude * d)
    return MotionDef(mk=mk, segments=(
        Segment(kind=SIN_RECT, t0=tstart, t1=tend,
                params=(freq, phase) + amp),))


def linear_motion(mk, *, vel, tstart=0.0, tend=1e30) -> MotionDef:
    return MotionDef(mk=mk, segments=(
        Segment(kind=RECT, t0=tstart, t1=tend, params=tuple(vel)),))


def rotation_motion(mk, *, axis_p1, axis_p2, degrees_per_s, tstart=0.0,
                    tend=1e30) -> MotionDef:
    return MotionDef(mk=mk, segments=(
        Segment(kind=ROT, t0=tstart, t1=tend,
                params=tuple(axis_p1) + tuple(axis_p2) + (degrees_per_s,)),))


def table_motion(mk, times, velocities, *, tstart=0.0) -> MotionDef:
    """Velocity time-series motion (the `mvfile`/`JLinearValue` path)."""
    times = tuple(float(x) + tstart for x in times)
    vals = tuple(float(v) for row in velocities for v in row)
    return MotionDef(mk=mk, segments=(
        Segment(kind=TABLE, t0=times[0], t1=times[-1], times=times,
                values=vals),))
