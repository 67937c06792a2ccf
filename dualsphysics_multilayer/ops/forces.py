"""Fused WCSPH force interaction over the cell-bucket structure.

Re-design of the reference's interaction loops (fluid targets:
`/root/reference/src/source/JSphCpu.cpp:631-822`; bound targets:
`JSphCpu.cpp:548-625`; GPU twins `JSphGpu_ker.cu:471-748`).  ONE fused gather
pass over the bucket structure computes every accumulator for every target
type with per-pair masks (the reference runs separate fluid-cell/bound-cell
passes); the template pyramid `JSphCpu.cpp:966-1015` becomes trace-time
branching on ``SolverOpts``.  The pair physics itself lives in
:mod:`.pairphys` and is shared with the Verlet-neighbour-list path
(:mod:`.nbrlist`) and the GPU kernel (:mod:`.pallas.cellforce`).

Acceleration excludes gravity (added by the integrator), as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpDensity, TpShifting, TpVisco
from . import celldiv as cd
from . import pairphys as PP

FLT_MAX = np.float32(3.4e38)   # plain numpy: no backend init at import time


@dataclass(frozen=True)
class SolverOpts:
    """Trace-time solver configuration (the template parameters of
    `JSphCpu.h:216-241` plus feature toggles)."""
    tstep: "td.TpStep" = td.TpStep.SYMPLECTIC
    tvisco: TpVisco = TpVisco.ARTIFICIAL
    tdensity: TpDensity = TpDensity.FOURTAKAS
    tboundary: TpBoundary = TpBoundary.DBC
    slipmode: "td.TpSlipMode" = td.TpSlipMode.NO_SLIP
    shiftmode: TpShifting = TpShifting.NONE
    with_floating: bool = False
    verlet_steps: int = 40
    mdbc_threshold: float = 0.0
    # Verlet neighbour-list mode (rebuild-when-needed, SURVEY §7 hard part 2)
    use_nbrlist: bool = False
    nbr_m: int = 0            # neighbours per particle (0 = auto from dp/ks)
    nbr_skin: float = 0.5     # skin radius in units of dp
    # bucket-path memory bound: process the cell axis in lax.map chunks of
    # this many cells.  None = auto (8192 chunks above 64k cells, one pass
    # below); 0 = force one pass regardless of size.  The per-neighbour-cell
    # temporaries are (cells, K, K) — at 10M particles one pass wants
    # ~400 GB, chunked at 8192 cells it peaks ~1.3 GB.  The GPU kernel path
    # (ops/pallas/cellforce.py) never materializes these.
    cell_chunk: int = None
    # compensated (two-float) position accumulation: pos stays plain f32
    # for the pair kernels while a Kahan residual keeps long-run
    # trajectories at the reference's f64-position precision
    # (integrators.comp_pos_update; reference JSphGpu_ker.h:45 PosCell)
    poscomp: bool = True
    # per-dt diagnostics ring capacity (the JDsSaveDt channel; 0 = off).
    # Must cover the steps between two PART saves to drain losslessly.
    savedt: int = 0
    # per-dt floating-motion ring capacity (the JFtMotionSave channel /
    # <vs_ftmottionsv>, PartFloatMotion.fbi4; 0 = off).  Same drain contract
    # as savedt; the host filters to the configured tout2 cadence.
    ftmotion: int = 0
    # NN multiphase velocity-gradient formulation (mphase TpVelGrad:
    # SPH = 3-pass accumulated gradients, FDA = per-pair finite-difference
    # approximation, JSphCpu_NN_FDA.cpp)
    velgrad: "td.TpVelGrad" = td.TpVelGrad.SPH
    # mphase dt relaxation parameter lamda for dt3 = h^2/(ViscEtaDtMax*lamda)
    # (<parameters> key RelaxationDt, mphase JSph.cpp:616, default 0.2)
    relaxationdt: float = 0.2
    # lateral symmetry plane at y=0 (<parameters> Symmetry, vs_syymmetry):
    # targets within kernelsize of the plane also interact with the
    # y-mirrored image of each candidate (3-D + artificial visc only,
    # JSph.cpp:1174-1179 restrictions)
    symmetry: bool = False
    # initial DDT ramp (tramp, tmaxvalue, maxvalue): while t<tramp the DDT
    # constant is maxvalue (t<=tmaxvalue) then blends linearly down to
    # csp.ddtvalue at t=tramp (CLI -ddtramp, RunInitialDDTRamp
    # JSphCpuSingle.cpp:650-663).  Traced on the time carry: no recompiles.
    ddtramp: tuple | None = None


@jax.tree_util.register_dataclass
@dataclass
class Forces:
    """Canonical-order force accumulators for one interaction."""
    ace: jax.Array                 # (n,3) acceleration w/o gravity
    ar: jax.Array                  # (n,)  drho/dt (delta-SPH already folded in)
    viscdtmax: jax.Array           # ()    max dot(dv,dr)/(rr2+eta2) over pairs
    shiftposfs: jax.Array | None   # (n,4) shifting accum
    shift_blocked: jax.Array | None  # (n,) bool
    spsgradvel: jax.Array | None   # (n,6) velocity-gradient accum (SPS only)
    # multiphase only: max effective viscosity (mphase ViscEtaDtMax) feeding
    # dt3 = h^2/(ViscEtaDtMax*lamda); None on the single-phase path
    viscetadtmax: jax.Array | None = None


def interaction_forces(csp: CteSph, opts: SolverOpts, div: cd.DivData,
                       pos, vel, rho, press, code,
                       spstau=None, ftomassp=None, ddtkh=None,
                       visco=None) -> Forces:
    """One fused interaction over the bucket structure.

    ``ddtkh`` is a traced scalar so the DDT ramp (`JSphCpuSingle.cpp`
    ``RunInitialDDTRamp``) works without recompilation."""
    n = div.ncap
    A, Kcap = div.bucket_idx.shape[0] - 1, div.bucket_idx.shape[1]
    f32 = pos.dtype
    if ddtkh is None:
        ddtkh = jnp.asarray(csp.ddtkh, f32)

    # ---- one-time gathers into bucket layout (A+1, K, d) -------------------
    pos_b = cd.gather(pos, div.bucket_idx)
    vel_b = cd.gather(vel, div.bucket_idx)
    rho_b = cd.gather(rho, div.bucket_idx, fill=1.0)
    press_b = cd.gather(press, div.bucket_idx)
    code_b = cd.gather(code, div.bucket_idx,
                       fill=td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE))
    use_sps = opts.tvisco == TpVisco.LAMINAR_SPS
    tau_b = cd.gather(spstau, div.bucket_idx) if use_sps else None

    valid_b = div.bucket_idx < n
    fluidside_b, floating_b, fixed_b, mass_b = PP.particle_flags(
        csp, code_b, ftomassp, opts.with_floating)

    t = slice(0, A)
    fluidside_t, floating_t, valid_t = fluidside_b[t], floating_b[t], \
        valid_b[t]
    ks2 = jnp.asarray(csp.kernelsize2, f32)
    NO = div.neigh_slot.shape[1]

    def run_cells(pos_t, vel_t, rho_t, press_t, valid_tc, fls_t, flt_t,
                  tau_t_rows, nslot_rows):
        """The fused pair pass for one batch of cells: (B, K) targets vs
        their NO neighbour cells of candidates gathered from the shared
        bucket arrays.  Factored out so the cell axis can run whole (one
        pass) or under lax.map chunks (opts.cell_chunk) — the (B, K, K)
        temporaries are the entire memory footprint of the bucket path."""
        B = pos_t.shape[0]
        zK = jnp.zeros((B, Kcap), f32)
        acc = dict(
            ace=jnp.zeros((B, Kcap, 3), f32), ar=zK,
            visc=jnp.full((B, Kcap), -FLT_MAX),
            delta=zK, delta_blocked=jnp.zeros((B, Kcap), bool),
            shift=jnp.zeros((B, Kcap, 4), f32),
            shift_blocked=jnp.zeros((B, Kcap), bool),
            gradvel=jnp.zeros((B, Kcap, 6), f32) if use_sps else None,
        )

        # -- loop over neighbour cells (static unroll, 27 in 3D / 9 in 2D) --
        for o in range(NO):
            cslot = nslot_rows[:, o]
            pos_c, vel_c = pos_b[cslot], vel_b[cslot]
            rho_c, press_c = rho_b[cslot], press_b[cslot]
            valid_c = valid_b[cslot]

            dr = tuple(pos_t[:, :, None, k] - pos_c[:, None, :, k]
                       for k in range(3))                  # 3 x (B,K,K)
            rr2 = dr[0] * dr[0] + dr[1] * dr[1] + dr[2] * dr[2]
            pair = (valid_tc[:, :, None] & valid_c[:, None, :]
                    & (rr2 <= ks2) & (rr2 >= td.ALMOSTZERO))
            dv = tuple(vel_t[:, :, None, k] - vel_c[:, None, :, k]
                       for k in range(3))

            p = PP.PairInputs(
                dr=dr, rr2=rr2, pair=pair, dv=dv,
                mass2=mass_b[cslot][:, None, :],
                rho1=rho_t[:, :, None], rho2=rho_c[:, None, :],
                press1=press_t[:, :, None], press2=press_c[:, None, :],
                bound_t=(~fls_t)[:, :, None],
                bound_c=(~fluidside_b[cslot])[:, None, :],
                ft_t=flt_t[:, :, None],
                ft_c=floating_b[cslot][:, None, :],
                fixed_c=fixed_b[cslot][:, None, :],
                tau_t=(PP.split3(jnp.where(fls_t[..., None], tau_t_rows, 0.0)
                                 [:, :, None, :]) if use_sps else None),
                tau_c=(PP.split3(tau_b[cslot][:, None, :, :])
                       if use_sps else None),
            )

            def csum(comps):
                return jnp.stack([c.sum(axis=-1) for c in comps], axis=-1)

            def fold(terms):
                acc["ace"] = acc["ace"] + csum(terms.ace)
                acc["ar"] = acc["ar"] + terms.ar.sum(axis=-1)
                acc["visc"] = jnp.maximum(acc["visc"],
                                          terms.visc.max(axis=-1))
                if terms.delta is not None:
                    acc["delta"] = acc["delta"] + terms.delta.sum(axis=-1)
                    acc["delta_blocked"] = acc["delta_blocked"] \
                        | terms.delta_blocked.any(-1)
                if terms.shift is not None:
                    acc["shift"] = acc["shift"] + csum(terms.shift)
                    acc["shift_blocked"] = acc["shift_blocked"] \
                        | terms.shift_blocked.any(-1)
                if terms.gradvel is not None:
                    acc["gradvel"] = acc["gradvel"] + csum(terms.gradvel)

            fold(PP.pair_terms(csp, opts, p, ddtkh, visco))

            if opts.symmetry:
                # mirror pass (vs_syymmetry): candidates reflected across
                # y=0 (dr_y = y1 + y2, mirrored vy2 = -vy2), only for
                # targets with y <= KernelSize (JSphCpu.cpp:638/682)
                ysym_t = pos_t[:, :, None, 1] <= jnp.float32(csp.kernelsize)
                dr_m = (dr[0], pos_t[:, :, None, 1] + pos_c[:, None, :, 1],
                        dr[2])
                rr2_m = dr_m[0] * dr_m[0] + dr_m[1] * dr_m[1] \
                    + dr_m[2] * dr_m[2]
                pair_m = (valid_tc[:, :, None] & valid_c[:, None, :]
                          & ysym_t & (rr2_m <= ks2)
                          & (rr2_m >= td.ALMOSTZERO))
                dv_m = (dv[0], vel_t[:, :, None, 1] + vel_c[:, None, :, 1],
                        dv[2])
                import dataclasses as _dc
                p_m = _dc.replace(p, dr=dr_m, rr2=rr2_m, pair=pair_m,
                                  dv=dv_m)
                fold(PP.pair_terms(csp, opts, p_m, ddtkh, visco))
        if not use_sps:
            acc.pop("gradvel")
        return acc

    # auto-bound: one pass materializes (A, K, K) temporaries — at 64k+
    # cells that is tens of GB, so large divides chunk by default (the
    # small f32 reassociation this causes is below the solver's oracle
    # tolerances; cell_chunk=0 forces one pass, N forces N-cell chunks)
    CH = ((8192 if A > 65536 else 0) if opts.cell_chunk is None
          else opts.cell_chunk)
    tau_t_full = tau_b[t] if use_sps else None
    if CH and A > CH:
        # chunk the cell axis: pad every per-cell table to a chunk multiple
        # (sentinel row A = the all-invalid bucket row) and lax.map the pair
        # pass over (CH, K, K)-bounded chunks
        NCH = -(-A // CH)
        padr = NCH * CH - A

        def pc(x, fill):
            return jnp.pad(x, ((0, padr),) + ((0, 0),) * (x.ndim - 1),
                           constant_values=fill)

        def rs(x):
            return x.reshape((NCH, CH) + x.shape[1:])

        xs = (rs(pc(pos_b[t], 0.0)), rs(pc(vel_b[t], 0.0)),
              rs(pc(rho_b[t], 1.0)), rs(pc(press_b[t], 0.0)),
              rs(pc(valid_t, False)), rs(pc(fluidside_t, False)),
              rs(pc(floating_t, False)),
              rs(pc(tau_t_full, 0.0)) if use_sps else None,
              rs(pc(div.neigh_slot[:A], A)))

        def body(x):
            return run_cells(*x[:7], x[7], x[8])

        accs = jax.lax.map(body, xs)
        acc = {k: v.reshape((NCH * CH,) + v.shape[2:])[:A]
               for k, v in accs.items()}
    else:
        acc = run_cells(pos_b[t], vel_b[t], rho_b[t], press_b[t], valid_t,
                        fluidside_t, floating_t, tau_t_full,
                        div.neigh_slot[:A])
    if not use_sps:
        acc["gradvel"] = None

    if opts.tdensity != TpDensity.NONE:
        acc["delta_blocked"] = acc["delta_blocked"] | (floating_t & valid_t)
        acc["ar"] = acc["ar"] + jnp.where(acc["delta_blocked"], 0.0, acc["delta"])
    if opts.shiftmode != TpShifting.NONE:
        acc["shift_blocked"] = acc["shift_blocked"] | (floating_t & valid_t)

    # ---- scatter back to canonical order ------------------------------------
    tidx = div.bucket_idx[t]
    ace = cd.scatter_add(n, tidx, acc["ace"], width=3)
    if csp.simulate2d:
        ace = ace.at[:, 1].set(0.0)   # JSphCpuSingle.cpp:544-550
    ar = cd.scatter_add(n, tidx, acc["ar"])
    viscdtmax = jnp.maximum(jnp.max(jnp.where(valid_t, acc["visc"], -FLT_MAX)), 0.0)

    shiftposfs = shift_blocked = None
    if opts.shiftmode != TpShifting.NONE:
        shiftposfs = cd.scatter_add(n, tidx, acc["shift"], width=4)
        shift_blocked = cd.scatter_add(
            n, tidx, acc["shift_blocked"].astype(jnp.int32)) > 0

    spsgradvel = (cd.scatter_add(n, tidx, acc["gradvel"], width=6)
                  if use_sps else None)

    return Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shiftposfs,
                  shift_blocked=shift_blocked, spsgradvel=spsgradvel)


def compute_sps_tau(csp: CteSph, rho, gradvel):
    """SPS sub-particle-stress tensor from accumulated velocity gradients;
    reference `JSphCpu::ComputeSpsTau` (Smagorinsky + Blin)."""
    gxx, gxy, gxz, gyy, gyz, gzz = [gradvel[:, i] for i in range(6)]
    pow1 = gxx * gxx + gyy * gyy + gzz * gzz
    prr = pow1 + pow1 + gxy * gxy + gxz * gxz + gyz * gyz
    visc_sps = csp.spssmag * jnp.sqrt(prr)
    div_u = gxx + gyy + gzz
    sps_k = (2.0 / 3.0) * visc_sps * div_u
    sps_blin = csp.spsblin * prr
    sumsps = -(sps_k + sps_blin)
    two = visc_sps + visc_sps
    one_rho = 1.0 / rho
    return jnp.stack([
        one_rho * (two * gxx + sumsps),
        one_rho * (visc_sps * gxy),
        one_rho * (visc_sps * gxz),
        one_rho * (two * gyy + sumsps),
        one_rho * (visc_sps * gyz),
        one_rho * (two * gzz + sumsps),
    ], axis=-1)


def apply_shifting(csp: CteSph, opts: SolverOpts, dt, vel, code,
                   shiftposfs, shift_blocked):
    """Turn shifting accumulators into displacements; reference
    `JSphShifting::RunCpu` (JSphShifting.cpp).  Returns (n,3) displacement."""
    vmag = jnp.sqrt(jnp.sum(vel * vel, axis=-1))
    umagn = dt * csp.shiftcoef * csp.kernelh * vmag
    if csp.shifttfs:
        coeftfs = (2.0 if csp.simulate2d else 3.0) - csp.shifttfs
        conc = shiftposfs[:, 3]
        umagn = jnp.where(conc < csp.shifttfs, 0.0,
                          umagn * (conc - csp.shifttfs) / coeftfs)
    maxdist = csp.dp * 0.1
    disp = jnp.clip(shiftposfs[:, :3] * umagn[:, None], -maxdist, maxdist)
    ok = td.is_fluid(code) & td.is_normal(code) & ~shift_blocked
    return jnp.where(ok[:, None], disp, 0.0)
