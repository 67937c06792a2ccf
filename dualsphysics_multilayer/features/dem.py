"""DEM contact forces for floating bodies (rigid mode DEM).

Re-design of the reference's built-in discrete-element contact
(`JSphCpu::InteractionForcesDEM`, `/root/reference/src/source/JSphCpu.cpp:828-
960`; GPU `KerInteractionForcesDem`, `JSphGpu_ker.cu:1407`): floating
particles feel a visco-elastic Hertzian normal force plus a regularized
Coulomb tangential force against boundary particles and particles of *other*
floating bodies when their lattice spheres (radius dp/2) overlap.

The physics (same model family the reference cites — Lemieux 2008 generalized
rigidity, Cummins 2010 generalized damping):

* material constant  tau = (1 - nu^2) / E  per mk / body,
* stiffness          kn  = 4/(3 (tau1+tau2)) * sqrt(dp/4),
* effective mass     m*  = m1/2 against boundary, m1 m2/(m1+m2) body-body
  (body masses, not particle masses),
* overlap            o   = dp - |r12|;  contact iff o > 0,
* damping            gn  = -2 ln(e) sqrt(m* kn) / sqrt(pi + ln(e)^2),
  e = mean restitution coefficient,
* normal force       fn  = kn o^1.5 - gn o^0.25 (v12.n),
* tangential         ft  = min(kfric fn tanh(8 vt),  2 (kn dt - gn) vt / 7),
* dt safety          demdt = (0.2*40/3.21) (m*/kn)^-0.4 |vn|^0.2, folded into
  the viscdt reduction that bounds dt2.

Shape: the reference loops floating particles over 27-cell ranges; here
the (static) floating-particle index set gathers its padded cell-bucket
candidates via `celldiv.point_candidates` — one dense (nf, NN*K) masked pair
block, no atomics, results scatter-added into the canonical ace array.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph
from ..ops import celldiv as cd


@dataclass(frozen=True, eq=False)
class DemCfg:
    """Static DEM tables (the analog of the `StDemData` array,
    `DualSphDef.h:259-268`, filled from `<properties>` XML by
    `JSph::LoadDemData`, `JSph.cpp:1189-1227`)."""
    ft_idx: np.ndarray      # (nf,) canonical indices of floating particles
    # per-particle tables (n,) — only non-fluid entries are meaningful
    c_tau: np.ndarray       # (1-nu^2)/E
    c_kfric: np.ndarray
    c_restitu: np.ndarray
    c_mass: np.ndarray      # body total mass (floating); unused for bound
    c_massp: np.ndarray     # particle mass (floating target side)
    c_group: np.ndarray     # int32 contact group (mk / 10000+body); -1 = none
    c_isbound: np.ndarray   # bool


def make_dem(csp: CteSph, code, ftcfg, *, float_props, bound_props=None):
    """Build the DEM tables host-side (typecodes of bound/floating particles
    never change, so the tables are static).

    ``float_props``: per-body ``dict(young=, poisson=, kfric=, restitu=)``.
    ``bound_props``: ``{mk: dict(...)}`` for boundary mks; walls without an
    entry inherit the first body's values (the reference requires a
    `<properties>` entry for every colliding mk)."""
    code = np.asarray(code)
    n = len(code)
    ctype = np.asarray(td.code_type(code))
    cval = np.asarray(td.code_value(code)).astype(np.int64)
    isfloat = ctype == td.TYPE_FLOATING
    isbound = ctype < td.TYPE_FLOATING

    def tau_of(p):
        return (1.0 - p["poisson"] ** 2) / p["young"]

    c_tau = np.full(n, 1.0, np.float32)
    c_kfric = np.zeros(n, np.float32)
    c_restitu = np.full(n, 0.5, np.float32)
    c_mass = np.ones(n, np.float32)
    c_massp = np.full(n, csp.massbound, np.float32)
    c_group = np.full(n, -1, np.int32)

    for b, props in enumerate(float_props):
        sel = isfloat & (cval == b)
        c_tau[sel] = tau_of(props)
        c_kfric[sel] = props["kfric"]
        c_restitu[sel] = props["restitu"]
        c_mass[sel] = ftcfg.mass[b]
        c_massp[sel] = ftcfg.massp[b]
        c_group[sel] = 10000 + b

    default = float_props[0]
    bprops = dict(bound_props or {})
    for mk in np.unique(cval[isbound]):
        props = bprops.get(int(mk), default)
        sel = isbound & (cval == mk)
        c_tau[sel] = tau_of(props)
        c_kfric[sel] = props["kfric"]
        c_restitu[sel] = props["restitu"]
        c_group[sel] = int(mk)

    ft_idx = np.flatnonzero(isfloat).astype(np.int32)
    return DemCfg(ft_idx=ft_idx, c_tau=c_tau, c_kfric=c_kfric,
                  c_restitu=c_restitu, c_mass=c_mass, c_massp=c_massp,
                  c_group=c_group, c_isbound=isbound)


def apply_dem(cfg: DemCfg, csp: CteSph, dom: cd.Domain, div: cd.DivData,
              pos, vel, code, dt, idp=None, origin=None):
    """Compute DEM contact accelerations over the current cell division.
    Returns ``(ace_add, demdtmax)``: ``ace_add`` is (n,3), zero outside
    floating particles; ``demdtmax`` joins the viscdt max reduction.

    ``idp``: pass the particle-id array when the state is NOT in canonical
    order (sharded slabs, permuted layouts) — the static property tables
    are keyed by id instead of slot, and the floating rows are located
    dynamically (the layout-independent form of the reference's StDemData
    indexing).  ``origin``: traced grid anchor (sharded slab grids)."""
    fidx, p1valid = _float_rows(cfg, code, idp)
    cand = cd.point_candidates(dom, div, pos[fidx], origin)   # (nf, M)
    return _dem_from_candidates(cfg, csp, cand, pos, vel, code, dt,
                                idp=idp, fidx=fidx, p1valid=p1valid)


def apply_dem_nbr(cfg: DemCfg, csp: CteSph, nbr, pos, vel, code, dt,
                  idp=None):
    """DEM over the Verlet neighbour list (nbrlist mode): the floating
    particles' own list rows are the candidate set — DEM contact range (dp)
    is well inside the list radius (kernelsize + skin), so coverage is
    guaranteed by the same skin contract."""
    fidx, p1valid = _float_rows(cfg, code, idp)
    return _dem_from_candidates(cfg, csp, nbr.nbr[fidx], pos, vel, code, dt,
                                idp=idp, fidx=fidx, p1valid=p1valid)


def _float_rows(cfg: DemCfg, code, idp):
    """Rows of the floating particles in the CURRENT layout: the static
    canonical list when the state is canonical, else a dynamic select of
    the (globally constant) floating count.  Ghost copies (periodic
    special) are excluded — their body sums are owner-side."""
    if idp is None:
        return jnp.asarray(cfg.ft_idx), None
    isf = td.is_floating(code) & td.is_active(code) & td.is_normal(code)
    nf = len(cfg.ft_idx)
    fidx = jnp.argsort(~isf, stable=True)[:nf]
    return fidx, isf[fidx]


def _dem_from_candidates(cfg: DemCfg, csp: CteSph, cand, pos, vel, code, dt,
                         idp=None, fidx=None, p1valid=None):
    n = pos.shape[0]
    f32 = vel.dtype
    if fidx is None:
        fidx = jnp.asarray(cfg.ft_idx)
    dp = jnp.asarray(csp.dp, f32)
    ncanon = len(cfg.c_tau)

    def prop(tbl, rows):
        """Static property lookup: by slot (canonical layouts) or by
        particle id (permuted/sharded layouts)."""
        t = jnp.asarray(tbl)
        if idp is None:
            return t[rows]
        key = jnp.clip(idp[rows], 0, ncanon - 1).astype(jnp.int32)
        return t[key]

    p1pos = pos[fidx]
    p1vel = vel[fidx]
    p1tau = prop(cfg.c_tau, fidx)
    p1kfric = prop(cfg.c_kfric, fidx)
    p1rest = prop(cfg.c_restitu, fidx)
    p1mass = prop(cfg.c_mass, fidx)
    p1massp = prop(cfg.c_massp, fidx)
    p1group = prop(cfg.c_group, fidx)
    if p1valid is not None:
        # dynamic selection may pad with non-floating rows
        p1group = jnp.where(p1valid, p1group, -2)

    valid = cand < n
    ci = jnp.minimum(cand, n - 1)
    cpos = pos[ci]
    cvel = vel[ci]
    ccode = code[ci]
    ctau = prop(cfg.c_tau, ci)
    ckfric = prop(cfg.c_kfric, ci)
    crest = prop(cfg.c_restitu, ci)
    cmass = prop(cfg.c_mass, ci)
    cgroup = prop(cfg.c_group, ci)
    cisbound = prop(cfg.c_isbound, ci)

    dr = p1pos[:, None, :] - cpos                          # (nf, M, 3)
    rr2 = jnp.sum(dr * dr, axis=-1)
    rad = jnp.sqrt(jnp.maximum(rr2, 1e-18))
    pair = (valid & (cgroup >= 0) & (cgroup != p1group[:, None])
            & td.is_active(ccode) & ~td.is_fluid(ccode)
            & (rr2 >= td.ALMOSTZERO))
    if p1valid is not None:
        pair = pair & p1valid[:, None]

    nu_mass = jnp.where(
        cisbound, 0.5 * p1mass[:, None],
        p1mass[:, None] * cmass / (p1mass[:, None] + cmass))
    kn = 4.0 / (3.0 * (p1tau[:, None] + ctau)) * jnp.sqrt(0.25 * dp)
    dv = p1vel[:, None, :] - cvel
    nrm = dr / rad[..., None]
    vn = jnp.sum(dv * nrm, axis=-1)

    # dt safety term: the reference computes it for every in-range pair
    demvisc = ((0.2 * 40.0 / 3.21)
               * jnp.power(nu_mass / kn, -0.4)
               * jnp.power(jnp.abs(vn), 0.2))
    demdtmax = jnp.max(jnp.where(pair, demvisc, 0.0),
                       initial=jnp.float32(0.0))

    overlap = dp - rad
    contact = pair & (overlap > 0.0)
    eij = jnp.clip(0.5 * (p1rest[:, None] + crest), 1e-4, 0.999999)
    ln_e = jnp.log(eij)
    gn = -(2.0 * ln_e * jnp.sqrt(nu_mass * kn)) / jnp.sqrt(math.pi
                                                           + ln_e * ln_e)
    ovl = jnp.maximum(overlap, 0.0)
    fn = kn * ovl ** 1.5 - gn * ovl ** 0.25 * vn
    inv_mp1 = 1.0 / p1massp[:, None]
    w = contact.astype(f32)
    ace = (w * fn * inv_mp1)[..., None] * nrm              # normal

    dvt = dv - vn[..., None] * nrm
    vt = jnp.sqrt(jnp.maximum(jnp.sum(dvt * dvt, axis=-1), 1e-18))
    tdir = dvt / vt[..., None]
    ft_elast = 2.0 * (kn * dt - gn) * vt / 7.0
    kfric_ij = 0.5 * (p1kfric[:, None] + ckfric)
    ft = jnp.minimum(kfric_ij * fn * jnp.tanh(8.0 * vt), ft_elast)
    ace = ace + (w * ft * inv_mp1)[..., None] * tdir       # tangential

    ace_f = jnp.sum(ace, axis=1)                           # (nf, 3)
    if csp.simulate2d:
        ace_f = ace_f.at[:, 1].set(0.0)
    ace_add = jnp.zeros((n, 3), f32).at[fidx].add(ace_f)
    return ace_add, demdtmax
