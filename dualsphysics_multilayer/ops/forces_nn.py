"""Multiphase non-Newtonian (HBP) force interaction.

Re-design of the mphase fork's NN solver
(`/root/reference/src_mphase/DSPH_v5.0_NNewtonian/source/JSphCpu_NN_SPH.cpp`,
GPU twin `JSphGpu_NN_ker.cu`), the pipeline at `:663-695`:

1. **PressGrad** — per-phase Tait EOS pressure (multi-EOS: each phase has its
   own rho0/Cs0/B/gamma, `StPhaseArray` DualSphDef.h:324-331), momentum +
   continuity with per-phase masses, DDT restricted to same-phase pairs
   (``pp1==pp2`` gating), shifting with heavy-phase suppression, and
   velocity-gradient accumulation with the no-slip wall trick
   (``dv = 2*v1`` against boundary neighbours).
2. **Visco_eta** — per-particle strain-rate tensor D from the gradients
   (`GetStrainRateTensor_tsym`, JSphCpu_Tensors.cpp:185), then the
   Herschel-Bulkley-Papanastasiou effective viscosity with bi-viscosity
   regularization (`GetEta_Effective`, JSphCpu_Tensors.cpp:116-135).
3a. **Morris** — laminar operator with per-pair (eta1+eta2) viscosity
   (`_Morris`, JSphCpu_NN_SPH.cpp:336), or
3b. **ConsEq** — per-particle stress tau = 2*eta*D and SPH stress divergence
   (`_Visco_Stress_tensor` + `_ConsEq`, JSphCpu_NN_SPH.cpp:128,228).

Everything runs as fused bucket-tile passes over the same cell division;
phases are a trace-time constant table indexed by the fluid typecode value
(the reference keys phases by mkfluid the same way).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, TpBoundary, TpDensity, TpKernel, TpShifting, TpVisco
from . import celldiv as cd
from . import kernels as K
from .forces import FLT_MAX, Forces, SolverOpts


@dataclass(frozen=True)
class Phase:
    """One fluid phase (reference StPhaseCte + StPhaseArray)."""
    mkfluid: int
    rho0: float
    csound: float
    gamma: float = 7.0
    visco: float = 0.001          # HBP consistency k (or Newtonian mu)
    tau_yield: float = 0.0
    tau_max: float = 0.0
    bi_multi: float = 0.0
    hbp_m: float = 0.0            # Papanastasiou exponential coefficient
    hbp_n: float = 1.0            # Herschel-Bulkley power index
    newtonian: bool = False


@dataclass(frozen=True)
class PhaseCfg:
    """Static phase table; index = fluid typecode value (mkfluid)."""
    phases: tuple                 # of Phase, indexed by mkfluid

    @property
    def count(self):
        return len(self.phases)

    def tables(self, csp: CteSph):
        import numpy as np
        ph = self.phases
        dim = csp.dim
        f = lambda k: jnp.asarray([getattr(p, k) for p in ph], jnp.float32)
        rho0 = f("rho0")
        cs0 = f("csound")
        gamma = f("gamma")
        return dict(
            rho0=rho0, cs0=cs0, gamma=gamma,
            mass=rho0 * csp.dp ** dim,
            cteb=cs0 * cs0 * rho0 / gamma,
            visco=f("visco"), tau_yield=f("tau_yield"), tau_max=f("tau_max"),
            bi_multi=f("bi_multi"), hbp_m=f("hbp_m"), hbp_n=f("hbp_n"),
        )

    def system_cs0(self):
        return max(p.csound for p in self.phases)


def press_nn(tb, phase_idx, rho):
    """Per-phase Tait EOS (the mphase ComputePress_NN)."""
    r0 = tb["rho0"][phase_idx]
    b = tb["cteb"][phase_idx]
    g = tb["gamma"][phase_idx]
    return b * ((rho / r0) ** g - 1.0)


def strain_rate(gradvel):
    """Deviatoric strain tensor D + magnitude (GetStrainRateTensor_tsym,
    JSphCpu_Tensors.cpp:185-208).  gradvel (n,6) sym accumulation with
    off-diagonals already summed (xy = du/dy + dv/dx)."""
    gxx, gxy, gxz, gyy, gyz, gzz = [gradvel[:, i] for i in range(6)]
    divv = (gxx + gyy + gzz) / 3.0
    dxx, dyy, dzz = gxx - divv, gyy - divv, gzz - divv
    dxy, dxz, dyz = 0.5 * gxy, 0.5 * gxz, 0.5 * gyz
    ii1 = dxx * dyy + dyy * dzz + dxx * dzz
    ii2 = dxy * dxy + dyz * dyz + dxz * dxz
    ii = -ii1 + ii2
    magn = jnp.sqrt(jnp.maximum(ii, 0.0))
    D = jnp.stack([dxx, dxy, dxz, dyy, dyz, dzz], axis=-1)
    return D, magn


def eta_effective(tb, phase_idx, d_magn, ppx=None):
    """HBP effective viscosity (GetEta_Effective, JSphCpu_Tensors.cpp:116-136).

    ``ppx`` indexes the bi-viscosity constants tau_max/Bi_multi; the reference
    keys those by the TARGET's phase (`PhaseCte[ppx]` with ppx=pp1) while
    tau_yield/visco/m/n come from the argument phase — the FDA per-pair call
    passes pp2's rheology with pp1's regularisation (JSphCpu_NN_FDA.cpp:291).
    Defaults to ``phase_idx`` (the SPH per-particle call, pp1 everywhere)."""
    eps = td.ALMOSTZERO
    dm = jnp.maximum(d_magn, eps)
    if ppx is None:
        ppx = phase_idx
    visco = tb["visco"][phase_idx]
    tauy = tb["tau_yield"][phase_idx]
    taumax = tb["tau_max"][ppx]
    bimult = tb["bi_multi"][ppx]
    m_nn = tb["hbp_m"][phase_idx]
    n_nn = tb["hbp_n"][phase_idx]

    has_taumax = taumax > 0
    miou_yield = jnp.where(has_taumax, taumax / (2.0 * dm), tauy / (2.0 * dm))
    bi_region = has_taumax & (dm <= taumax / (2.0 * jnp.maximum(
        bimult * visco, eps)))
    miou_yield = jnp.where(bi_region, bimult * visco, miou_yield)
    miou_pap = miou_yield * (1.0 - jnp.exp(-m_nn * dm))
    low_rate = (miou_pap > m_nn * tauy) | (d_magn <= eps)
    term1 = jnp.where(has_taumax, miou_yield,
                      jnp.where(low_rate, m_nn * tauy, miou_pap))
    miou_hb = visco * dm ** (n_nn - 1.0)
    term2 = jnp.where(bi_region, visco,
                      jnp.where(low_rate, visco, miou_hb))
    return term1 + term2


def strain_magn_pair(dvw, dr, rr2):
    """Per-pair FDA strain rate (GetVelocityGradients_FDA +
    GetStrainRateTensor, JSphCpu_Tensors.cpp:80-112): full velocity-gradient
    tensor dvel = dv (outer) dr / rr2 (Fan et al. 2010), deviatoric strain
    D = sym(dvel) - (tr/3) I.

    The reference's FULL-matrix magnitude is ``sqrt(II_D^2) = |II_1 - II_2|``
    (JSphCpu_Tensors.cpp:106-108) — unlike the symmetric-tensor variant used
    by the SPH formulation which is ``sqrt(-II_1 + II_2)`` (``:200-202``).
    We reproduce that behavioural quirk for parity: eta(rate) curves differ
    between the two formulations in the reference too."""
    inv = 1.0 / rr2
    d11 = dvw[..., 0] * dr[..., 0] * inv
    d12 = dvw[..., 0] * dr[..., 1] * inv
    d13 = dvw[..., 0] * dr[..., 2] * inv
    d21 = dvw[..., 1] * dr[..., 0] * inv
    d22 = dvw[..., 1] * dr[..., 1] * inv
    d23 = dvw[..., 1] * dr[..., 2] * inv
    d31 = dvw[..., 2] * dr[..., 0] * inv
    d32 = dvw[..., 2] * dr[..., 1] * inv
    d33 = dvw[..., 2] * dr[..., 2] * inv
    divv = (d11 + d22 + d33) / 3.0
    sxx, syy, szz = d11 - divv, d22 - divv, d33 - divv
    sxy, sxz, syz = 0.5 * (d12 + d21), 0.5 * (d13 + d31), 0.5 * (d23 + d32)
    ii1 = sxx * syy + syy * szz + sxx * szz
    ii2 = sxy * sxy + syz * syz + sxz * sxz
    magn = jnp.abs(ii1 - ii2)
    return magn, (sxx, sxy, sxz, syy, syz, szz)


def interaction_forces_nn(csp: CteSph, opts: SolverOpts, phases: PhaseCfg,
                          dom, div: cd.DivData, pos, vel, rho, code,
                          tau=None, ddtkh=None):
    """Full NN interaction (PressGrad -> eta -> Morris/ConsEq).  Returns
    (Forces, visco_eta (n,), tau (n,6))."""
    n = div.ncap
    f32 = pos.dtype
    tb = phases.tables(csp)
    if ddtkh is None:
        ddtkh = jnp.asarray(csp.ddtkh, f32)
    use_conseq = opts.tvisco == TpVisco.CONST_EQ
    use_morris = opts.tvisco == TpVisco.LAMINAR_SPS
    # FDA: per-pair velocity gradient + eta + viscous force, all fused into
    # pass 1 (Interaction_ForcesCpuT_NN_FDA, JSphCpu_NN_FDA.cpp:129-348);
    # SPH: 3-pass accumulated gradients (JSphCpu_NN_SPH.cpp:663-695)
    use_fda = (opts.velgrad == td.TpVelGrad.FDA
               and (use_morris or use_conseq))
    NPH = phases.count

    # per-particle phase + press
    ptype = td.code_type(code)
    fluidside = ptype >= td.TYPE_FLOATING
    phase_idx = jnp.clip(td.code_value(code).astype(jnp.int32), 0, NPH - 1)
    # bound particles use the SYSTEM EOS, not phase 0
    # (ComputePress_NN, JSphCpu_Tensors.cpp:48-70)
    press_bound = csp.cteb * ((rho / csp.rhopzero) ** csp.gamma - 1.0)
    press = jnp.where(fluidside & td.is_active(code),
                      press_nn(tb, phase_idx, rho), press_bound)

    # ---- bucket gathers -----------------------------------------------------
    bidx = div.bucket_idx
    A, Kc = bidx.shape[0] - 1, bidx.shape[1]
    pos_b = cd.gather(pos, bidx)
    vel_b = cd.gather(vel, bidx)
    rho_b = cd.gather(rho, bidx, fill=1.0)
    press_b = cd.gather(press, bidx)
    code_b = cd.gather(code, bidx,
                       fill=td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE))
    valid_b = bidx < n
    fluidside_b = td.code_type(code_b) >= td.TYPE_FLOATING
    phase_b = jnp.clip(td.code_value(code_b).astype(jnp.int32), 0, NPH - 1)
    mass_b = jnp.where(fluidside_b, tb["mass"][phase_b], csp.massbound)
    cs0_b = tb["cs0"][phase_b]

    t = slice(0, A)
    ks2 = jnp.asarray(csp.kernelsize2, f32)

    def pair_loop(body, init):
        acc = init
        for o in range(div.neigh_slot.shape[1]):
            cslot = div.neigh_slot[:, o]
            dr = pos_b[t][:, :, None, :] - pos_b[cslot][:, None, :, :]
            rr2 = jnp.sum(dr * dr, axis=-1)
            pair = (valid_b[t][:, :, None] & valid_b[cslot][:, None, :]
                    & (rr2 <= ks2) & (rr2 >= td.ALMOSTZERO))
            bound_t = (~fluidside_b[t])[:, :, None]
            bound_c = (~fluidside_b[cslot])[:, None, :]
            pair = pair & ~(bound_t & bound_c)
            rr2s = jnp.where(pair, rr2, ks2)
            fac = K.kernel_fac(csp, rr2s)
            fr = fac[..., None] * dr
            env = dict(
                o=o, cslot=cslot, dr=dr, rr2=rr2s, pair=pair, fr=fr,
                pw=pair.astype(f32),
                bound_t=bound_t, bound_c=bound_c,
                rho1=rho_b[t][:, :, None], rho2=rho_b[cslot][:, None, :],
                vel1=vel_b[t][:, :, None, :], vel2=vel_b[cslot][:, None, :, :],
                mass2=jnp.where(bound_c, csp.massbound,
                                mass_b[cslot][:, None, :]),
                cbar=cs0_b[cslot][:, None, :],
                ph1=phase_b[t][:, :, None], ph2=phase_b[cslot][:, None, :],
            )
            acc = body(env, acc)
        return acc

    eta2c = jnp.asarray(csp.eta2, f32)
    press_t = press_b[t][:, :, None]

    # ================= pass 1: PressGrad =====================================
    def p1_body(e, acc):
        ace, ar, delta, dblk, gradvel, visc, shift, shiftblk, etamax = acc
        press2 = press_b[e["cslot"]][:, None, :]
        prs = (press_t + press2) / (e["rho1"] * e["rho2"])
        if csp.tkernel == TpKernel.CUBIC:
            prs = prs + K.cubic_tensil(csp, e["rr2"], e["rho1"], press_t,
                                       e["rho2"], press2)
        w_mom = e["pw"] * (1.0 - e["bound_t"].astype(f32))
        ace = ace - jnp.sum((w_mom * prs * e["mass2"])[..., None] * e["fr"],
                            axis=2)
        dv = e["vel1"] - e["vel2"]
        dvfr = jnp.sum(dv * e["fr"], axis=-1)
        drfr = jnp.sum(e["dr"] * e["fr"], axis=-1)
        r1over2 = e["rho1"] / e["rho2"]
        w_comp = e["pw"] * (1.0 - (e["bound_t"] & e["bound_c"]).astype(f32))
        ar = ar + jnp.sum(w_comp * e["mass2"] * dvfr * r1over2, axis=-1)

        samephase = (e["ph1"] == e["ph2"]) | e["bound_c"]
        if opts.tdensity == TpDensity.MOLTENI:
            vd = ddtkh * e["cbar"] * (r1over2 - 1.0) / (e["rr2"] + eta2c)
            dadd = jnp.where(samephase & ~e["bound_c"], vd * drfr * e["mass2"],
                             0.0)
            delta = delta + jnp.sum(w_mom * dadd, axis=-1)
            if opts.tboundary == TpBoundary.DBC:
                dblk = dblk | jnp.any(e["pair"] & ~e["bound_t"] & e["bound_c"],
                                      axis=-1)
        elif opts.tdensity in (TpDensity.FOURTAKAS, TpDensity.FOURTAKAS_FULL):
            applies = (jnp.ones_like(e["bound_c"])
                       if opts.tdensity == TpDensity.FOURTAKAS
                       else ~e["bound_c"])
            rh = 1.0 + csp.ddtgz * e["dr"][..., 2]
            drhop = csp.rhopzero * rh ** (1.0 / csp.gamma) - csp.rhopzero
            vd = ddtkh * e["cbar"] * ((e["rho2"] - e["rho1"]) - drhop) \
                / (e["rr2"] + eta2c)
            dsub = jnp.where(samephase & ~e["bound_c"],
                             vd * drfr * e["mass2"] / e["rho2"], 0.0)
            delta = delta - jnp.sum(w_mom * dsub * applies.astype(f32), axis=-1)
            dblk = dblk | jnp.any(e["pair"] & ~e["bound_t"] & e["bound_c"]
                                  & applies, axis=-1)

        if opts.shiftmode != TpShifting.NONE:
            heavy = (tb["mass"][e["ph1"]] > tb["mass"][e["ph2"]]) \
                & (e["ph1"] != e["ph2"]) & ~e["bound_c"]
            massrhop = jnp.where(heavy, 0.0, w_mom * e["mass2"] / e["rho2"])
            drfr_ = drfr
            shift = shift + jnp.stack(
                [(massrhop * e["fr"][..., 0]).sum(-1),
                 (massrhop * e["fr"][..., 1]).sum(-1),
                 (massrhop * e["fr"][..., 2]).sum(-1),
                 (-massrhop * drfr_).sum(-1)], axis=-1)
            if opts.shiftmode == TpShifting.NO_BOUND:
                shiftblk = shiftblk | jnp.any(
                    e["pair"] & ~e["bound_t"] & e["bound_c"], axis=-1)

        dot = jnp.sum(e["dr"] * dv, axis=-1)
        visc = jnp.maximum(visc, jnp.max(
            jnp.where(w_comp > 0, dot / (e["rr2"] + eta2c), -FLT_MAX), -1))

        # velocity gradients with the no-slip wall trick (dv=2*v1 for bound)
        if (use_morris or use_conseq) and not use_fda:
            dvw = jnp.where(e["bound_c"][..., None], 2.0 * e["vel1"], dv)
            volp2 = -(w_mom * (1.0 - e["bound_t"].astype(f32))) \
                * e["mass2"] / e["rho2"]
            gx, gy, gz = dvw[..., 0] * volp2, dvw[..., 1] * volp2, \
                dvw[..., 2] * volp2
            frx, fry, frz = e["fr"][..., 0], e["fr"][..., 1], e["fr"][..., 2]
            gradvel = gradvel + jnp.stack([
                (gx * frx).sum(-1), (gx * fry + gy * frx).sum(-1),
                (gx * frz + gz * frx).sum(-1), (gy * fry).sum(-1),
                (gy * frz + gz * fry).sum(-1), (gz * frz).sum(-1)], axis=-1)
        elif use_fda:
            # fused FDA viscous term (InteractionForcesFluid_NN_FDA_All
            # :283-313): per-pair gradient/strain/eta, then Morris or ConsEq
            dvw = jnp.where(e["bound_c"][..., None], 2.0 * e["vel1"], dv)
            magn, S = strain_magn_pair(dvw, e["dr"], e["rr2"])
            # rheology constants from pp2 (pp1 when the candidate is bound),
            # bi-viscosity regularisation from pp1 (JSphCpu_NN_FDA.cpp:200,291)
            phc = jnp.where(e["bound_c"], e["ph1"], e["ph2"])
            eta = eta_effective(tb, phc, magn, ppx=e["ph1"])
            etamax = jnp.maximum(etamax, jnp.max(jnp.where(
                e["pair"] & ~e["bound_t"], eta, 0.0), axis=-1))
            frx, fry, frz = e["fr"][..., 0], e["fr"][..., 1], e["fr"][..., 2]
            drfr = jnp.sum(e["dr"] * e["fr"], axis=-1)
            if use_morris:
                # Morris operator with the per-pair eta (:297-299)
                temp = 2.0 * eta / ((e["rr2"] + eta2c) * e["rho2"])
                vtemp = w_mom * e["mass2"] * temp * drfr
                ace = ace + jnp.sum(vtemp[..., None] * dvw, axis=2)
            else:
                # ConsEq: per-pair stress tau = 2*eta*D (:301-312)
                m2r = w_mom * e["mass2"] / e["rho2"] * (2.0 * eta)
                sxx, sxy, sxz, syy, syz, szz = S
                ace = ace + jnp.stack(
                    [(m2r * (sxx * frx + sxy * fry + sxz * frz)).sum(-1),
                     (m2r * (sxy * frx + syy * fry + syz * frz)).sum(-1),
                     (m2r * (sxz * frx + syz * fry + szz * frz)).sum(-1)],
                    axis=-1)
        return ace, ar, delta, dblk, gradvel, visc, shift, shiftblk, etamax

    zK = jnp.zeros((A, Kc), f32)
    init = (jnp.zeros((A, Kc, 3), f32), zK, zK, jnp.zeros((A, Kc), bool),
            jnp.zeros((A, Kc, 6), f32), jnp.full((A, Kc), -FLT_MAX),
            jnp.zeros((A, Kc, 4), f32), jnp.zeros((A, Kc), bool), zK)
    (ace_b, ar_b, delta_b, dblk_b, gradvel_b, visc_b, shift_b, shiftblk_b,
     etamax_b) = pair_loop(p1_body, init)

    if opts.tdensity != TpDensity.NONE:
        ar_b = ar_b + jnp.where(dblk_b, 0.0, delta_b)

    tidx = bidx[t]
    gradvel = cd.scatter_add(n, tidx, gradvel_b, width=6)

    # ================= pass 2: effective viscosity ===========================
    visco_eta = jnp.zeros((n,), f32)
    tau_p = jnp.zeros((n, 6), f32)
    if use_fda:
        # per-pair eta already applied in pass 1; expose the per-particle max
        # as the visco_eta diagnostic (the reference keeps the LAST pair's
        # value, JSphCpu_NN_FDA.cpp:338 — max is the deterministic analog)
        visco_eta = jnp.zeros((n,), f32).at[tidx.reshape(-1)].max(
            etamax_b.reshape(-1), mode="drop")
    elif use_morris or use_conseq:
        D, dmagn = strain_rate(gradvel)
        visco_eta = jnp.where(td.is_fluid(code) & td.is_active(code),
                              eta_effective(tb, phase_idx, dmagn), 0.0)
        if use_conseq:
            tau_p = 2.0 * visco_eta[:, None] * D   # GetStressTensor_sym

    # ================= pass 3: viscous forces ================================
    if use_fda:
        pass                                       # fused into pass 1
    elif use_morris or use_conseq:
        eta_b = cd.gather(visco_eta, bidx)
        tau_b = cd.gather(tau_p, bidx)

        def p3_body(e, acc):
            ace = acc
            w_mom = e["pw"] * (1.0 - e["bound_t"].astype(f32))
            dv = e["vel1"] - e["vel2"]
            dvw = jnp.where(e["bound_c"][..., None], 2.0 * e["vel1"], dv)
            if use_morris:
                eta1 = eta_b[t][:, :, None]
                eta2_ = jnp.where(e["bound_c"], eta1, eta_b[e["cslot"]][:, None, :])
                temp = (eta1 + eta2_) / ((e["rr2"] + eta2c) * e["rho2"])
                drfr = jnp.sum(e["dr"] * e["fr"], axis=-1)
                vtemp = w_mom * e["mass2"] * temp * drfr
                ace = ace + jnp.sum(vtemp[..., None] * dvw, axis=2)
            else:
                tau1 = tau_b[t][:, :, None, :]
                tau2 = jnp.where(e["bound_c"][..., None], tau1,
                                 tau_b[e["cslot"]][:, None, :, :])
                ts = tau1 + tau2
                frx, fry, frz = e["fr"][..., 0], e["fr"][..., 1], e["fr"][..., 2]
                m2r = w_mom * e["mass2"] / e["rho2"]
                ace = ace + jnp.stack([
                    (m2r * (ts[..., 0] * frx + ts[..., 1] * fry
                            + ts[..., 2] * frz)).sum(-1),
                    (m2r * (ts[..., 1] * frx + ts[..., 3] * fry
                            + ts[..., 4] * frz)).sum(-1),
                    (m2r * (ts[..., 2] * frx + ts[..., 4] * fry
                            + ts[..., 5] * frz)).sum(-1)], axis=-1)
            return ace

        ace_b = pair_loop(p3_body, ace_b)
    else:
        # per-phase artificial viscosity (JSphCpu_NN_SPH.cpp Morris pass,
        # VISCO_Artificial branch: visco_NN = PhaseCte[pp2].visco)
        def p3a_body(e, acc):
            ace = acc
            w_mom = e["pw"] * (1.0 - e["bound_t"].astype(f32))
            dv = e["vel1"] - e["vel2"]
            dot = jnp.sum(e["dr"] * dv, axis=-1)
            dot_rr2 = dot / (e["rr2"] + eta2c)
            visco_nn = tb["visco"][e["ph2"]]
            amubar = csp.kernelh * dot_rr2
            robar = (e["rho1"] + e["rho2"]) * 0.5
            pi = jnp.where((dot < 0) & (w_mom > 0),
                           (-visco_nn * e["cbar"] * amubar / robar)
                           * e["mass2"], 0.0)
            return ace - jnp.sum(pi[..., None] * e["fr"], axis=2)

        ace_b = pair_loop(p3a_body, ace_b)

    # ---- fold to canonical ----------------------------------------------------
    ace = cd.scatter_add(n, tidx, ace_b, width=3)
    if csp.simulate2d:
        ace = ace.at[:, 1].set(0.0)
    ar = cd.scatter_add(n, tidx, ar_b)
    viscdtmax = jnp.maximum(jnp.max(jnp.where(valid_b[t], visc_b,
                                              -FLT_MAX)), 0.0)
    # effective-viscosity dt control: ViscEtaDtMax = max eta over particles
    # (SPH: _Visco_eta pass; FDA: max over pairs) feeding the separate
    # dt3 = h^2/(ViscEtaDtMax*lamda) (JSphCpu.cpp:1687 mphase DtVariable)
    viscetadtmax = jnp.max(visco_eta)

    shiftposfs = shift_blocked = None
    if opts.shiftmode != TpShifting.NONE:
        shiftposfs = cd.scatter_add(n, tidx, shift_b, width=4)
        shift_blocked = cd.scatter_add(
            n, tidx, shiftblk_b.astype(jnp.int32)) > 0

    fr = Forces(ace=ace, ar=ar, viscdtmax=viscdtmax, shiftposfs=shiftposfs,
                shift_blocked=shift_blocked, spsgradvel=None,
                viscetadtmax=viscetadtmax)
    return fr, visco_eta, tau_p
