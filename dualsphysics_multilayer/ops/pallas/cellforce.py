"""GPU force kernel: fused WCSPH pair forces over cell-sorted ranges.

The hot loop of the solver (reference `InteractionForcesFluid`, ~90% of its
runtime, SURVEY §3.2; CUDA twin `KerInteractionForcesFluid`,
`JSphGpu_ker.cu:654`) written as a Pallas kernel through Triton
(``backend="triton"``).  Like the reference CUDA kernel it works on the
cell-sorted state (:func:`celldiv.divide_sorted`):

* one program handles a block of up to ``block_t`` sorted targets from one
  (y,z) cell-row and reads its own loop bounds from the block table;
* it walks the block's 9 (2D: 3) neighbour-row ranges — in each row the
  x-adjacent cells are one contiguous range of the sorted arrays — in
  masked chunks of ``block_c`` candidates;
* the pair physics is :func:`pairphys.pair_terms`, the same source the jnp
  layouts run, evaluated on (block_t, block_c) register tiles in f32; the
  accumulators stay in registers and each program writes only its own
  targets, so no atomics are needed.  The per-target viscdt maxima are
  reduced by XLA afterwards.

Covered: Wendland and cubic kernels, artificial or laminar+SPS viscosity,
DDT none/Molteni/Fourtakas/full, shifting, floating bodies (per-particle
mass) and DBC or mDBC (the ghost-node correction is a jnp pre-pass that
rewrites bound vel/rho before the boundary-type-agnostic force loop).  Other
configurations take the bucket path (ops.forces).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from ... import typesdef as td
from ...typesdef import CteSph, TpBoundary, TpDensity, TpShifting, TpVisco
from .. import eos
from .. import pairphys as PP
from ..forces import FLT_MAX, Forces, SolverOpts

# input channels: pos, vel, rho, press, mass, kind (+ 6 SPS stresses)
_NBASE = 10
# fill of masked lanes: finite values, so masked pairs stay NaN-free
_OTHER = (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, -1.0)


def supports(csp: CteSph, opts: SolverOpts) -> bool:
    """Configurations the kernel covers (see the module docstring)."""
    return (opts.tvisco in (TpVisco.ARTIFICIAL, TpVisco.LAMINAR_SPS)
            and opts.tboundary in (TpBoundary.DBC, TpBoundary.MDBC)
            and not opts.symmetry)


def tile_config(csp: CteSph, opts: SolverOpts):
    """(block_t, block_c, num_warps, num_stages) for the configuration;
    block_t is the ``block`` to build the divide with.

    A pair tile holds block_t*block_c pairs and every pair temporary lives
    in registers, so tiles stay small: 4 pairs per thread.  32 targets are
    about half the particles of a cell, so a block rarely spans more than
    two x-cells and its candidate ranges stay near the 3-cell minimum.
    Chosen by timing the 845k-particle 3D dam break on an H100 (PERF.md):
    32x16 beat 16x32, 32x32, 64x16, 32x64 and 64x32."""
    return 32, 16, 4, 2


def _kernel(blk_ref, prm_ref, *refs, csp, opts, BT, BC, R, nin):
    fin, outs = refs[:nin], refs[nin:]
    f32 = jnp.float32
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    use_shift = opts.shiftmode != TpShifting.NONE
    b = pl.program_id(0)
    t0 = blk_ref[b, 0]
    tn = blk_ref[b, 1]
    ti = jnp.arange(BT, dtype=jnp.int32)
    tidx = t0 + ti
    tmask = ti < tn
    others = _OTHER + (0.0,) * (nin - _NBASE)

    def load(idx, mask):
        return [plt.load(r.at[idx], mask=mask, other=o)
                for r, o in zip(fin, others)]

    tf = load(tidx, tmask)
    kind_t = tf[9]
    act_t = tmask & (kind_t >= 0.0)
    visco = prm_ref[0]
    ddtkh = prm_ref[1]
    ks2 = f32(csp.kernelsize2)

    def col(v):
        return v[:, None]

    def row(v):
        return v[None, :]

    zero = jnp.zeros((BT,), f32)
    nacc = 7 + (5 if use_shift else 0) + (6 if use_sps else 0)
    acc0 = tuple(zero for _ in range(nacc))
    acc0 = acc0[:6] + (jnp.full((BT,), -FLT_MAX, f32),) + acc0[7:]

    def chunk(cs, ce, i, acc):
        cidx = cs + i * BC + jnp.arange(BC, dtype=jnp.int32)
        cf = load(cidx, cidx < ce)
        kind_c = cf[9]
        dr = tuple(col(tf[k]) - row(cf[k]) for k in range(3))
        rr2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
        pair = (col(act_t) & row(kind_c >= 0.0) & (rr2 <= ks2)
                & (rr2 >= f32(td.ALMOSTZERO)))
        bound_c = row(kind_c < f32(td.TYPE_FLOATING))
        p = PP.PairInputs(
            dr=dr, rr2=rr2, pair=pair,
            dv=tuple(col(tf[3 + k]) - row(cf[3 + k]) for k in range(3)),
            mass2=row(cf[8]), rho1=col(tf[6]), rho2=row(cf[6]),
            press1=col(tf[7]), press2=row(cf[7]),
            bound_t=col(kind_t < f32(td.TYPE_FLOATING)), bound_c=bound_c,
            ft_t=col(kind_t == f32(td.TYPE_FLOATING)),
            ft_c=row(kind_c == f32(td.TYPE_FLOATING)),
            fixed_c=row(kind_c == f32(td.TYPE_FIXED)),
            tau_t=(tuple(col(jnp.where(kind_t >= f32(td.TYPE_FLOATING),
                                       tf[_NBASE + k], 0.0))
                         for k in range(6)) if use_sps else None),
            tau_c=(tuple(row(cf[_NBASE + k]) for k in range(6))
                   if use_sps else None))
        t = PP.pair_terms(csp, opts, p, ddtkh, visco)

        def sum1(x):
            return jnp.sum(x, axis=1)

        def any1(x):
            return jnp.max(x.astype(f32), axis=1)

        new = [acc[0] + sum1(t.ace[0]), acc[1] + sum1(t.ace[1]),
               acc[2] + sum1(t.ace[2]), acc[3] + sum1(t.ar)]
        if t.delta is not None:
            new += [acc[4] + sum1(t.delta),
                    jnp.maximum(acc[5], any1(t.delta_blocked))]
        else:
            new += [acc[4], acc[5]]
        new.append(jnp.maximum(acc[6], jnp.max(t.visc, axis=1)))
        k = 7
        if use_shift:
            new += [acc[k + j] + sum1(t.shift[j]) for j in range(4)]
            new.append(jnp.maximum(acc[k + 4], any1(t.shift_blocked)))
            k += 5
        if use_sps:
            new += [acc[k + j] + sum1(t.gradvel[j]) for j in range(6)]
        return tuple(new)

    def rows(r, acc):
        cs = blk_ref[b, 2 + r]
        ce = blk_ref[b, 2 + R + r]
        nch = (ce - cs + (BC - 1)) // BC
        return jax.lax.fori_loop(0, nch, functools.partial(chunk, cs, ce),
                                 acc)

    acc = jax.lax.fori_loop(0, R, rows, acc0)

    ar = acc[3]
    if opts.tdensity != TpDensity.NONE:
        blocked = (acc[5] > 0.0) | (kind_t == f32(td.TYPE_FLOATING))
        ar = ar + jnp.where(blocked, 0.0, acc[4])
    res = [acc[0], acc[1], acc[2], ar, acc[6]] + list(acc[7:])
    for o_ref, v in zip(outs, res):
        plt.store(o_ref.at[tidx], v, mask=tmask)


def interaction_forces(csp: CteSph, opts: SolverOpts, sd, pos, vel, rho,
                       code, *, ftomassp=None, spstau=None, ddtkh=None,
                       visco=None, state_sorted=False,
                       interpret=False) -> Forces:
    """Run the kernel over a :class:`celldiv.SortDiv` and return Forces with
    the contract of ops.forces.interaction_forces.

    ``state_sorted``: the particle arrays are already in the divide's sorted
    order (the carried layout of models.wcsph); otherwise they are gathered
    into it and the results scattered back to canonical order.
    ``interpret`` runs the kernel in Pallas interpret mode (CPU tests).
    A program handles one block of the divide: ``sd.block`` targets."""
    n = sd.ncap
    A, W = sd.blk.shape
    R = (W - 2) // 2
    BT = sd.block
    _, BC, warps, stages = tile_config(csp, opts)
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    use_shift = opts.shiftmode != TpShifting.NONE
    if not state_sorted:
        o = sd.order
        pos, vel, rho, code = pos[o], vel[o], rho[o], code[o]
        if use_sps and spstau is not None:
            spstau = spstau[o]

    f32 = jnp.float32
    press = eos.press_from_rho(csp, rho)
    _fs, _ft, _fx, mass = PP.particle_flags(csp, code, ftomassp,
                                            opts.with_floating)
    kind = jnp.where(td.is_active(code), td.code_type(code).astype(f32),
                     -1.0)
    fields = [pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1],
              vel[:, 2], rho, press, mass, kind]
    if use_sps:
        tau = spstau if spstau is not None else jnp.zeros((n, 6), f32)
        fields += [tau[:, k] for k in range(6)]
    prm = jnp.stack([jnp.asarray(csp.visco if visco is None else visco, f32),
                     jnp.asarray(csp.ddtkh if ddtkh is None else ddtkh, f32)])
    nout = 5 + (5 if use_shift else 0) + (6 if use_sps else 0)
    kern = functools.partial(_kernel, csp=csp, opts=opts, BT=BT, BC=BC, R=R,
                             nin=len(fields))
    out = pl.pallas_call(
        kern,
        out_shape=[jax.ShapeDtypeStruct((n,), f32)] * nout,
        grid=(A,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=warps,
                                           num_stages=stages),
        interpret=interpret,
        name="sph_cellforce",
    )(sd.blk, prm, *[jnp.asarray(f, f32) for f in fields])

    # rows past nlive belong to no block and were never written
    live = jnp.arange(n, dtype=jnp.int32) < sd.nlive
    out = [jnp.where(live, v, 0.0) for v in out]
    visc = jnp.where(live, out[4], -FLT_MAX)
    ace = jnp.stack(out[:3], axis=1)
    if csp.simulate2d:
        ace = ace.at[:, 1].set(0.0)     # JSphCpuSingle.cpp:544-550
    ar = out[3]
    shiftposfs = shift_blocked = spsgradvel = None
    k = 5
    if use_shift:
        shiftposfs = jnp.stack(out[k:k + 4], axis=1)
        shift_blocked = (out[k + 4] > 0.0) | (
            live & (td.code_type(code) == td.TYPE_FLOATING))
        k += 5
    if use_sps:
        spsgradvel = jnp.stack(out[k:k + 6], axis=1)
    if not state_sorted:
        o = sd.order

        def back(a):
            return None if a is None else jnp.zeros_like(a).at[o].set(a)

        ace, ar, shiftposfs, shift_blocked, spsgradvel = (
            back(ace), back(ar), back(shiftposfs), back(shift_blocked),
            back(spsgradvel))
    return Forces(ace=ace, ar=ar,
                  viscdtmax=jnp.maximum(jnp.max(visc), 0.0),
                  shiftposfs=shiftposfs, shift_blocked=shift_blocked,
                  spsgradvel=spsgradvel)
