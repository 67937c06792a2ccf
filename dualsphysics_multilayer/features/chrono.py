"""Native rigid-body constraint solver — the Project-Chrono coupling
replacement.

Reference: `JChronoObjects` + `JChronoData` + the closed `libdsphchrono.so`
wrapping Project Chrono (`/root/reference/src/source/JChronoObjects.cpp`,
`JChronoData.h:361-560`; XML schema `doc/xml_format/_FmtXML_Chrono.xml`).
Each step the reference hands per-body SPH force/torque to Chrono, Chrono
integrates the constrained multibody system (joints, springs), and body
center/vel/omega come back (`JSphCpuSingle.cpp:930-945`).

Design: instead of a host library round-trip, the constrained
Newton-Euler system is assembled and solved ON DEVICE inside the jitted step:

    [ M  -J^T ] [qacc]   [ F        ]
    [ J    0  ] [lam ] = [ rhs_stab ]

with M = blockdiag(m_i I3, I_i(world)), J the joint Jacobians at acceleration
level, and Baumgarte stabilization pulling position/velocity drift back to
the constraint manifold.  B bodies and m constraint rows give a dense
(6B+m)^2 solve — tiny (B <= dozens), so `jnp.linalg.solve` is microseconds on
the MXU and the whole coupling stays inside the device-resident step loop
(the reference pays a host sync every step).

Supported links (JChLink::TpLink): spheric (ball joint), hinge (+ torsional
stiffness/damping about the axis), pointline (slide along an axis),
linearspring, coulombdamping, pulley (belt ratio: r1*w1.a = r2*w2.a about
the shared axis, JChLinkPulley `JChronoData.h:539-561`).
``idbody2 = -1`` means ground/world (the reference's fixed "domain" body).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ChLink:
    """One link (JChLink + subclasses).  Geometry is given in WORLD
    coordinates of the initial configuration, like the XML; body-local
    anchors are derived at config time."""
    type: str                      # hinge|spheric|pointline|spring|coulomb
    b1: int
    b2: int = -1                   # -1 = ground
    rotpoint: tuple = (0.0, 0.0, 0.0)
    rotvector: tuple = (0.0, 0.0, 1.0)
    slidevector: tuple = (0.0, 0.0, 1.0)
    pt1: tuple = (0.0, 0.0, 0.0)   # spring attach on body1 (world @ t0)
    pt2: tuple = (0.0, 0.0, 0.0)   # spring attach on body2/ground
    stiffness: float = 0.0
    damping: float = 0.0
    restlength: float = 0.0
    coulomb: float = 0.0
    radius: float = 0.0            # pulley radius on body1
    radius2: float = 0.0           # pulley radius on body2


@dataclass(frozen=True)
class ChronoCfg:
    """Static link table + derived body-local anchors (tuples, hashable)."""
    links: tuple                   # of ChLink
    # body-local anchor offsets per link, derived from initial centers:
    # local1[i] = anchor - center0[b1], local2[i] likewise (or world anchor
    # for ground links)
    local1: tuple = ()
    local2: tuple = ()

    @property
    def njoint_rows(self):
        return sum(_LINK_ROWS[l.type] for l in self.links)


_LINK_ROWS = {"spheric": 3, "hinge": 5, "pointline": 2,
              "spring": 0, "coulomb": 0, "pulley": 1}


def make_chrono(links, centers0) -> ChronoCfg:
    """Derive body-local anchors from the initial body centers (the anchor
    bookkeeping Chrono does via body frames)."""
    centers0 = np.asarray(centers0, np.float64)
    loc1, loc2 = [], []
    for l in links:
        anchor = np.asarray(l.rotpoint if l.type in ("spheric", "hinge",
                                                     "pointline")
                            else l.pt1, np.float64)
        anchor2 = np.asarray(l.rotpoint if l.type in ("spheric", "hinge",
                                                      "pointline")
                             else l.pt2, np.float64)
        loc1.append(tuple(anchor - centers0[l.b1]))
        loc2.append(tuple(anchor2 - centers0[l.b2]) if l.b2 >= 0
                    else tuple(anchor2))
    return ChronoCfg(links=tuple(links), local1=tuple(loc1),
                     local2=tuple(loc2))


def _basis_perp(n):
    """Two unit vectors orthogonal to n (static numpy)."""
    n = np.asarray(n, np.float64)
    n = n / max(np.linalg.norm(n), 1e-30)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else \
        np.array([0.0, 1.0, 0.0])
    u = np.cross(n, a)
    u /= max(np.linalg.norm(u), 1e-30)
    v = np.cross(n, u)
    return u, v


def spring_forces(cfg: ChronoCfg, R, center, fvel, fomega, f32=jnp.float32):
    """Explicit force links (linearspring + coulombdamping): returns
    (face (B,3), torque (B,3)) world-frame force/torque increments
    (JChLinkLinearSpring: F = -k(|d|-L0) d^ - c (vrel . d^) d^)."""
    B = center.shape[0]
    face = jnp.zeros((B, 3), f32)
    tq = jnp.zeros((B, 3), f32)
    for i, l in enumerate(cfg.links):
        if l.type not in ("spring", "coulomb"):
            continue
        r1 = R[l.b1] @ jnp.asarray(cfg.local1[i], f32)
        p1 = center[l.b1] + r1
        v1 = fvel[l.b1] + jnp.cross(fomega[l.b1], r1)
        if l.b2 >= 0:
            r2 = R[l.b2] @ jnp.asarray(cfg.local2[i], f32)
            p2 = center[l.b2] + r2
            v2 = fvel[l.b2] + jnp.cross(fomega[l.b2], r2)
        else:
            p2 = jnp.asarray(cfg.local2[i], f32)
            v2 = jnp.zeros(3, f32)
        d = p1 - p2
        dist = jnp.sqrt(jnp.sum(d * d) + 1e-30)
        dhat = d / dist
        vrel = jnp.sum((v1 - v2) * dhat)
        fmag = -l.stiffness * (dist - l.restlength) - l.damping * vrel
        if l.type == "coulomb" and l.coulomb:
            # Coulomb (dry-friction) damping: constant-magnitude force
            # opposing relative motion (JChLinkCoulombDamping)
            fmag = fmag - l.coulomb * jnp.sign(vrel)
        f = fmag * dhat
        face = face.at[l.b1].add(f)
        tq = tq.at[l.b1].add(jnp.cross(r1, f))
        if l.b2 >= 0:
            face = face.at[l.b2].add(-f)
            tq = tq.at[l.b2].add(jnp.cross(r2, -f))
    return face, tq


def solve_constrained(cfg: ChronoCfg, mass, inert, R, center, fvel, fomega,
                      face_sum, tq_sum, dt):
    """Solve the constrained Newton-Euler KKT system; returns per-body
    (linear acc (B,3), angular acc (B,3)).

    ``face_sum``/``tq_sum``: total world force/torque per body (SPH + gravity
    + springs + external).  Baumgarte gains are tied to dt so stabilization
    stays stable under the explicit symplectic outer integrator."""
    B = mass.shape[0]
    f32 = face_sum.dtype
    m = cfg.njoint_rows
    nv = 6 * B

    # generalized mass matrix
    M = jnp.zeros((nv, nv), f32)
    for b in range(B):
        M = M.at[6 * b:6 * b + 3, 6 * b:6 * b + 3].set(
            jnp.eye(3, dtype=f32) * mass[b])
        M = M.at[6 * b + 3:6 * b + 6, 6 * b + 3:6 * b + 6].set(inert[b])
    F = jnp.concatenate([
        jnp.concatenate([face_sum[b], tq_sum[b]]) for b in range(B)])

    if m == 0:
        acc = jnp.linalg.solve(M, F)
        acc = acc.reshape(B, 6)
        return acc[:, :3], acc[:, 3:]

    # Baumgarte: Cdd = -2/(g*dt) Cd - 1/(g*dt)^2 C
    gdt = 5.0 * dt
    kd = 2.0 / gdt
    kp = 1.0 / (gdt * gdt)

    def skew(v):
        return jnp.array([[0.0, -v[2], v[1]],
                          [v[2], 0.0, -v[0]],
                          [-v[1], v[0], 0.0]], f32)

    rows_J = []
    rows_rhs = []

    def point_rows(b1, b2, loc1, loc2):
        """3 rows: world acceleration of anchor-on-b1 == anchor-on-b2."""
        r1 = R[b1] @ jnp.asarray(loc1, f32)
        J = jnp.zeros((3, nv), f32)
        J = J.at[:, 6 * b1:6 * b1 + 3].set(jnp.eye(3, dtype=f32))
        J = J.at[:, 6 * b1 + 3:6 * b1 + 6].set(-skew(r1))
        p1 = center[b1] + r1
        v1 = fvel[b1] + jnp.cross(fomega[b1], r1)
        cent = jnp.cross(fomega[b1], jnp.cross(fomega[b1], r1))
        if b2 >= 0:
            r2 = R[b2] @ jnp.asarray(loc2, f32)
            J = J.at[:, 6 * b2:6 * b2 + 3].add(-jnp.eye(3, dtype=f32))
            J = J.at[:, 6 * b2 + 3:6 * b2 + 6].add(skew(r2))
            p2 = center[b2] + r2
            v2 = fvel[b2] + jnp.cross(fomega[b2], r2)
            cent = cent - jnp.cross(fomega[b2], jnp.cross(fomega[b2], r2))
        else:
            p2 = jnp.asarray(loc2, f32)
            v2 = jnp.zeros(3, f32)
        C = p1 - p2
        Cd = v1 - v2
        rhs = -cent - kd * Cd - kp * C
        return J, rhs

    for i, l in enumerate(cfg.links):
        if l.type in ("spring", "coulomb"):
            continue
        if l.type in ("spheric", "hinge"):
            J, rhs = point_rows(l.b1, l.b2, cfg.local1[i], cfg.local2[i])
            rows_J.append(J)
            rows_rhs.append(rhs)
        if l.type == "hinge":
            # axis alignment: the world axis of b1 stays aligned with the
            # world axis of b2 (or the fixed world axis for ground links):
            # u.n1 = 0, v.n1 = 0 for u,v spanning the plane normal to n2
            u0, v0 = _basis_perp(l.rotvector)
            a_local = np.asarray(l.rotvector, np.float64)
            a_local /= max(np.linalg.norm(a_local), 1e-30)
            n1 = R[l.b1] @ jnp.asarray(a_local, f32)
            for w0 in (u0, v0):
                if l.b2 >= 0:
                    w = R[l.b2] @ jnp.asarray(w0, f32)
                else:
                    w = jnp.asarray(w0, f32)
                # C = w . n1 ; Cd = w . (omega1 x n1) + (omega2 x w) . n1
                J = jnp.zeros((1, nv), f32)
                J = J.at[0, 6 * l.b1 + 3:6 * l.b1 + 6].set(
                    jnp.cross(n1, w))
                Cd = jnp.dot(w, jnp.cross(fomega[l.b1], n1))
                cent = jnp.dot(w, jnp.cross(
                    fomega[l.b1], jnp.cross(fomega[l.b1], n1)))
                if l.b2 >= 0:
                    J = J.at[0, 6 * l.b2 + 3:6 * l.b2 + 6].set(
                        jnp.cross(w, n1))
                    Cd = Cd + jnp.dot(n1, jnp.cross(fomega[l.b2], w))
                    cent = cent + jnp.dot(n1, jnp.cross(
                        fomega[l.b2], jnp.cross(fomega[l.b2], w))) \
                        + 2.0 * jnp.dot(jnp.cross(fomega[l.b2], w),
                                        jnp.cross(fomega[l.b1], n1))
                C = jnp.dot(w, n1)
                rows_J.append(J)
                rows_rhs.append(jnp.reshape(-cent - kd * Cd - kp * C, (1,)))
        elif l.type == "pulley":
            # belt constraint: r1*(w1.a) - r2*(w2.a) = const -> acceleration
            # level r1*(wd1.a) - r2*(wd2.a) = -kd*Cd (velocity-only
            # stabilization; a belt has no preferred phase)
            a = np.asarray(l.rotvector, np.float64)
            a /= max(np.linalg.norm(a), 1e-30)
            av = jnp.asarray(a, f32)
            Jp = jnp.zeros((1, nv), f32)
            Jp = Jp.at[0, 6 * l.b1 + 3:6 * l.b1 + 6].set(l.radius * av)
            Cd = l.radius * jnp.dot(fomega[l.b1], av)
            if l.b2 >= 0:
                Jp = Jp.at[0, 6 * l.b2 + 3:6 * l.b2 + 6].set(-l.radius2 * av)
                Cd = Cd - l.radius2 * jnp.dot(fomega[l.b2], av)
            rows_J.append(Jp)
            rows_rhs.append(jnp.reshape(-kd * Cd, (1,)))
        elif l.type == "pointline":
            # anchor of b1 stays on the line through rotpoint along
            # slidevector: 2 rows perpendicular to the axis
            J3, rhs3 = point_rows(l.b1, l.b2, cfg.local1[i], cfg.local2[i])
            u0, v0 = _basis_perp(l.slidevector)
            for w0 in (u0, v0):
                w = jnp.asarray(w0, f32)
                rows_J.append((w[None, :] @ J3))
                rows_rhs.append(jnp.reshape(jnp.dot(w, rhs3), (1,)))

    J = jnp.concatenate(rows_J, axis=0)
    rhs = jnp.concatenate([jnp.atleast_1d(r) for r in rows_rhs])
    m = J.shape[0]
    K = jnp.zeros((nv + m, nv + m), f32)
    K = K.at[:nv, :nv].set(M)
    K = K.at[:nv, nv:].set(-J.T)
    K = K.at[nv:, :nv].set(J)
    b = jnp.concatenate([F, rhs])
    sol = jnp.linalg.solve(K, b)
    acc = sol[:nv].reshape(B, 6)
    return acc[:, :3], acc[:, 3:]


def hinge_torsion(cfg: ChronoCfg, R, fomega, angles, f32=jnp.float32):
    """Optional torsional stiffness/damping about hinge axes
    (JChLinkHinge stiffness [Nm/rad] / damping [Nms/rad]): torque
    -k*theta - c*thetad, with theta the accumulated relative rotation
    about the axis (adequate for the incremental angles the solver keeps)."""
    B = fomega.shape[0]
    tq = jnp.zeros((B, 3), f32)
    for l in cfg.links:
        if l.type != "hinge" or (not l.stiffness and not l.damping):
            continue
        a = np.asarray(l.rotvector, np.float64)
        a /= max(np.linalg.norm(a), 1e-30)
        av = jnp.asarray(a, f32)
        th1 = jnp.dot(angles[l.b1], av)
        w1 = jnp.dot(fomega[l.b1], av)
        if l.b2 >= 0:
            th1 = th1 - jnp.dot(angles[l.b2], av)
            w1 = w1 - jnp.dot(fomega[l.b2], av)
        t = (-l.stiffness * th1 - l.damping * w1) * av
        tq = tq.at[l.b1].add(t)
        if l.b2 >= 0:
            tq = tq.at[l.b2].add(-t)
    return tq
