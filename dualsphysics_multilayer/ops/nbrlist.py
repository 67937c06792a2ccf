"""Verlet neighbour lists with skin: the high-throughput interaction layout.

The reference rebuilds its cell structure and walks 27-cell candidate ranges
every step (`JCellDivCpuSingle::Divide` + `JCellSearch_inline.h`), paying the
~10x checked-vs-real pair ratio (tracked by its own PIPS metric, `JDsPips.h`)
on every interaction.  This module replaces it with a classic Verlet list:
candidates within ``kernelsize + skin`` are compacted ONCE into a fixed-width
(n, M) neighbour table and reused until any particle has moved more than
skin/2 (CFL makes that ~10-30 steps), amortizing the candidate scan; in the
3D dam break about 40% of the list's entries are real pairs, against ~13% of
a 27-cell walk's candidates.

The force-time rr2 <= kernelsize^2 test keeps the physics exact — the list
only over-approximates the candidate set (standard MD technique; the skin
rule guarantees no pair can enter the kernel support unseen).

Build pipeline (all static-shape, jit-safe):
  sort by cell id -> dense cellstart table (searchsorted) -> per-particle
  9-row candidate windows (the reference's z/y row iteration,
  `JCellSearch_inline.h:33-92`) -> prefix-sum compaction into (n, M) with a
  counted overflow diagnostic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, TpVisco
from . import celldiv as cd
from . import pairphys as PP
from .forces import FLT_MAX, Forces


@jax.tree_util.register_dataclass
@dataclass
class NbrList:
    """Fixed-width neighbour table in canonical particle order."""
    nbr: jax.Array        # (n, M) int32 canonical neighbour index, or n (empty)
    pos_ref: jax.Array    # (n, 3) positions at build time (skin displacement test)
    overflow: jax.Array   # () int32 — neighbours dropped; MUST be 0
    ncap: int = field(metadata=dict(static=True), default=0)


def auto_m(csp: CteSph, skin_dp: float) -> int:
    """Neighbour capacity: lattice points within kernelsize + skin, with
    compression margin, rounded up to a multiple of 8."""
    r = csp.kernelsize / csp.dp + skin_dp
    if csp.simulate2d:
        m = math.pi * (r + 0.5) ** 2 * 1.15
    else:
        m = 4.0 / 3.0 * math.pi * (r + 0.5) ** 3 * 1.10
    return int(-(-m // 8) * 8)


def empty_list(n: int, m: int) -> NbrList:
    """Placeholder list that forces a rebuild on first use."""
    return NbrList(nbr=jnp.full((n, m), n, jnp.int32),
                   pos_ref=jnp.full((n, 3), jnp.inf, jnp.float32),
                   overflow=jnp.zeros((), jnp.int32), ncap=n)


def needs_rebuild(csp: CteSph, opts, nbr: NbrList, pos, code):
    """True when any active particle moved more than skin/2 since build."""
    lim = (opts.nbr_skin * csp.dp * 0.5) ** 2
    d = pos - nbr.pos_ref
    d2 = jnp.sum(d * d, axis=-1)
    d2 = jnp.where(td.is_active(code), d2, 0.0)
    return jnp.max(d2) > lim


def build(dom: cd.Domain, csp: CteSph, opts, pos, code):
    """Build the neighbour list.  Returns (NbrList, new_code) — escaped
    particles are marked OUT_POS exactly as in `celldiv.divide`."""
    n = pos.shape[0]
    M = opts.nbr_m or auto_m(csp, opts.nbr_skin)
    rcut = csp.kernelsize + opts.nbr_skin * csp.dp
    rcut2 = rcut * rcut
    # the builder bins on its own, coarser grid (cell side = rcut, so one
    # cell ring suffices); map-limit semantics stay those of ``dom``
    bdom = cd.make_domain(dom.posmin, dom.posmax, rcut,
                          simulate2d=dom.simulate2d, dp=csp.dp)
    ncells = bdom.ncells
    ncx, ncy, ncz = bdom.nc
    W = 3 * bdom.cellcap                   # worst-case particles in 3 x-cells

    cxyz = cd.cell_coords(dom, pos)
    inside = jnp.all((cxyz >= 0) & (cxyz < jnp.array(dom.nc, jnp.int32)), axis=1)
    cxyz = cd.cell_coords(bdom, pos)
    inside = inside & jnp.all(
        (cxyz >= 0) & (cxyz < jnp.array(bdom.nc, jnp.int32)), axis=1)
    active = td.is_active(code)
    newly_out = active & ~inside
    new_code = jnp.where(newly_out,
                         td.code_set_special(code, td.SPECIAL_OUT_POS), code)
    live = active & inside

    cellid = (cxyz[:, 2] * ncy + cxyz[:, 1]) * ncx + cxyz[:, 0]
    cellid = jnp.where(live, cellid, ncells)
    order = jnp.argsort(cellid, stable=True)          # sorted-space -> canonical
    scid = cellid[order]
    spos = pos[order]

    # dense cell -> first-sorted-index table (the analog of BeginCell)
    cellstart = jnp.searchsorted(scid, jnp.arange(ncells + 1, dtype=scid.dtype),
                                 side="left").astype(jnp.int32)

    # per-particle 9 (dy,dz) candidate row windows over 3 x-cells
    scx = cxyz[order, 0]
    scy = cxyz[order, 1]
    scz = cxyz[order, 2]
    xlo = jnp.maximum(scx - 1, 0)
    xhi = jnp.minimum(scx + 1, ncx - 1)
    dys = (0,) if dom.simulate2d else (-1, 0, 1)
    wstarts, wends = [], []
    slive = live[order]
    for dz in (-1, 0, 1):
        for dy in dys:
            ny = scy + dy
            nz = scz + dz
            ok = slive & (ny >= 0) & (ny < ncy) & (nz >= 0) & (nz < ncz)
            row = (nz * ncy + ny) * ncx
            s = jnp.where(ok, cellstart[jnp.clip(row + xlo, 0, ncells)], 0)
            e = jnp.where(ok, cellstart[jnp.clip(row + xhi + 1, 0, ncells)], 0)
            wstarts.append(s)
            wends.append(e)
    wstart = jnp.stack(wstarts, axis=1)               # (n, R)
    wend = jnp.stack(wends, axis=1)
    R = wstart.shape[1]

    # candidate enumeration at fixed width W per row, chunked over particle
    # blocks to bound peak memory (the (B,R,W) tensors are transient)
    B = 2048
    nblocks = -(-n // B)
    npad = nblocks * B
    pad = npad - n

    def padded(x, fill=0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)

    wstart_p = padded(wstart).reshape(nblocks, B, R)
    wend_p = padded(wend).reshape(nblocks, B, R)
    srow_p = padded(jnp.arange(n, dtype=jnp.int32), n).reshape(nblocks, B)
    ar_w = jnp.arange(W, dtype=jnp.int32)

    def chunk(args):
        ws, we, srow = args                            # (B,R), (B,R), (B,)
        cand = ws[:, :, None] + ar_w[None, None, :]    # (B, R, W)
        cand_ok = cand < we[:, :, None]
        cand_cl = jnp.minimum(cand, n - 1)
        cpos = spos[cand_cl]                           # (B, R, W, 3)
        tpos = spos[jnp.minimum(srow, n - 1)]
        d = tpos[:, None, None, :] - cpos
        rr2 = jnp.sum(d * d, axis=-1)
        keep = cand_ok & (rr2 <= rcut2) & (cand_cl != srow[:, None, None])
        rank = jnp.cumsum(keep, axis=-1) - 1
        counts = keep.sum(axis=-1)
        offs = jnp.concatenate(
            [jnp.zeros((B, 1), counts.dtype),
             jnp.cumsum(counts, axis=1)[:, :-1]], axis=1)
        dest = offs[:, :, None] + rank
        writable = keep & (dest < M)
        ovf = jnp.sum((keep & ~writable).astype(jnp.int32))
        dest = jnp.where(writable, dest, M)
        rows = jnp.full((B, M + 1), n, jnp.int32)
        cand_canon = order[cand_cl]
        rows = rows.at[jnp.arange(B)[:, None, None], dest].set(
            jnp.where(writable, cand_canon, n), mode="drop")
        return rows[:, :M], ovf

    rows, ovfs = jax.lax.map(chunk, (wstart_p, wend_p, srow_p))
    nbr_sorted = rows.reshape(npad, M)[:n]
    overflow = ovfs.sum()

    # rows are in sorted space; scatter back to canonical target order
    nbr = jnp.zeros((n, M), jnp.int32).at[order].set(nbr_sorted)

    return NbrList(nbr=nbr, pos_ref=pos, overflow=overflow, ncap=n), new_code


def interaction_forces_nbr(csp: CteSph, opts, nbr: NbrList,
                           pos, vel, rho, press, code,
                           spstau=None, ftomassp=None, ddtkh=None,
                           visco=None) -> Forces:
    """Fused force interaction over the neighbour list (same physics as the
    bucket path — both call :func:`pairphys.pair_terms`).  Outputs are already
    in canonical order (no scatter)."""
    n = nbr.ncap
    f32 = pos.dtype
    if ddtkh is None:
        ddtkh = jnp.asarray(csp.ddtkh, f32)
    idx = nbr.nbr                                      # (n, M)

    pos_c = cd.gather(pos, idx)
    vel_c = cd.gather(vel, idx)
    rho_c = cd.gather(rho, idx, fill=1.0)
    press_c = cd.gather(press, idx)
    code_c = cd.gather(code, idx,
                       fill=td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE))
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    tau_c = cd.gather(spstau, idx) if use_sps else None

    fluidside, floating, fixed, mass = PP.particle_flags(
        csp, code, ftomassp, opts.with_floating)
    fluidside_c, floating_c, fixed_c, mass_c = PP.particle_flags(
        csp, code_c, ftomassp, opts.with_floating)

    active_t = td.is_active(code)
    active_c = td.is_active(code_c) & (idx < n)

    dr = tuple(pos[:, None, k] - pos_c[..., k] for k in range(3))
    rr2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
    ks2 = jnp.asarray(csp.kernelsize2, f32)
    pair = (active_t[:, None] & active_c & (rr2 <= ks2)
            & (rr2 >= td.ALMOSTZERO))

    p = PP.PairInputs(
        dr=dr, rr2=rr2, pair=pair,
        dv=tuple(vel[:, None, k] - vel_c[..., k] for k in range(3)),
        mass2=mass_c,
        rho1=rho[:, None], rho2=rho_c,
        press1=press[:, None], press2=press_c,
        bound_t=(~fluidside)[:, None], bound_c=~fluidside_c,
        ft_t=floating[:, None], ft_c=floating_c,
        fixed_c=fixed_c,
        tau_t=(PP.split3(jnp.where(fluidside[:, None], spstau, 0.0)[:, None, :])
               if use_sps else None),
        tau_c=PP.split3(tau_c) if use_sps else None,
    )
    terms = PP.pair_terms(csp, opts, p, ddtkh, visco)

    def csum(comps):
        return jnp.stack([c.sum(axis=1) for c in comps], axis=-1)

    ace = csum(terms.ace)
    if csp.simulate2d:
        ace = ace.at[:, 1].set(0.0)
    ar = terms.ar.sum(axis=-1)
    viscdtmax = jnp.maximum(jnp.max(terms.visc), 0.0)

    shiftposfs = shift_blocked = None
    if terms.shift is not None:
        shiftposfs = csum(terms.shift)
        shift_blocked = terms.shift_blocked.any(-1) | (floating & active_t)
    if terms.delta is not None:
        blocked = terms.delta_blocked.any(-1) | (floating & active_t)
        ar = ar + jnp.where(blocked, 0.0, terms.delta.sum(axis=-1))
    spsgradvel = csum(terms.gradvel) if terms.gradvel is not None else None

    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shiftposfs,
                  shift_blocked=shift_blocked, spsgradvel=spsgradvel)
