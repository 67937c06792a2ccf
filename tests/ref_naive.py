"""Naive O(N^2) numpy oracle for the WCSPH interaction, written directly from
the reference equations (JSphCpu.cpp:548-822).  Used to validate the fused
bucketed force pass on small particle sets."""

import numpy as np

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.typesdef import (
    TpDensity, TpKernel, TpShifting, TpVisco,
)

FLT_MAX = np.float32(3.4e38)


def wendland_fac(csp, rr2):
    rad = np.sqrt(rr2)
    qq = rad / csp.kernelh
    wqq1 = 1.0 - 0.5 * qq
    return csp.kwend.bwen * qq * wqq1 ** 3 / rad


def cubic_fac(csp, rr2):
    rad = np.sqrt(rr2)
    qq = rad / csp.kernelh
    if rad > csp.kernelh:
        return csp.kcubic.c2 * (2.0 - qq) ** 2 / rad
    return (csp.kcubic.c1 * qq + csp.kcubic.d1 * qq * qq) / rad


def cubic_wab(csp, rr2):
    rad = np.sqrt(rr2)
    qq = rad / csp.kernelh
    if rad > csp.kernelh:
        return csp.kcubic.a24 * (2.0 - qq) ** 3
    return csp.kcubic.a2 * (1.0 + (0.75 * qq - 1.5) * qq * qq)


def cubic_tensil(csp, rr2, rho1, p1, rho2, p2):
    fab = cubic_wab(csp, rr2) * csp.kcubic.od_wdeltap
    fab = fab ** 4
    t1 = (p1 / (rho1 * rho1)) * (0.01 if p1 > 0 else -0.2)
    t2 = (p2 / (rho2 * rho2)) * (0.01 if p2 > 0 else -0.2)
    return fab * (t1 + t2)


def naive_forces(csp, opts, pos, vel, rho, press, code, spstau=None):
    """Returns dict(ace, ar, viscdtmax, shiftposfs, shift_blocked, gradvel)."""
    n = pos.shape[0]
    ace = np.zeros((n, 3))
    ar = np.zeros(n)
    delta = np.zeros(n)
    blocked = np.zeros(n, bool)
    shift = np.zeros((n, 4))
    shift_blocked = np.zeros(n, bool)
    gradvel = np.zeros((n, 6))
    viscdt = 0.0
    ks2 = csp.kernelsize2

    typ = np.asarray(td.code_type(code))
    active = np.asarray(td.is_active(code))
    isb = (typ < td.TYPE_FLOATING) & active
    isft = (typ == td.TYPE_FLOATING) & active
    isfl = (typ == td.TYPE_FLUID) & active

    for i in range(n):
        if not active[i]:
            continue
        bound_t = isb[i]
        ft_t = isft[i]
        if ft_t:
            blocked[i] = True
            shift_blocked[i] = True
        for j in range(n):
            if i == j or not active[j]:
                continue
            bound_c = isb[j]
            if bound_t and bound_c:
                continue  # bound-bound pairs never interact
            dr = pos[i] - pos[j]
            rr2 = float(np.dot(dr, dr))
            if rr2 > ks2 or rr2 < td.ALMOSTZERO:
                continue
            if csp.tkernel == TpKernel.WENDLAND:
                fac = wendland_fac(csp, rr2)
            else:
                fac = cubic_fac(csp, rr2)
            fr = fac * dr
            mass2 = csp.massbound if bound_c else csp.massfluid
            dv = vel[i] - vel[j]
            dvfr = float(np.dot(dv, fr))
            drfr = float(np.dot(dr, fr))
            dot = float(np.dot(dr, dv))
            dot_rr2 = dot / (rr2 + csp.eta2)
            viscdt = max(viscdt, dot_rr2)

            # continuity (both target kinds)
            ar[i] += mass2 * dvfr * (rho[i] / rho[j])

            if bound_t:
                continue  # bound targets: only ar + viscdt

            # momentum
            prs = (press[i] + press[j]) / (rho[i] * rho[j])
            if csp.tkernel == TpKernel.CUBIC:
                prs += cubic_tensil(csp, rr2, rho[i], press[i], rho[j], press[j])
            ace[i] -= prs * mass2 * fr

            # DDT
            if opts.tdensity == TpDensity.MOLTENI and not ft_t:
                visc_densi = csp.ddtkh * csp.cs0 * (rho[i] / rho[j] - 1.0) / (rr2 + csp.eta2)
                dlt = visc_densi * drfr * mass2
                if bound_c:
                    blocked[i] = True  # DBC assumed
                else:
                    delta[i] += dlt
                if isft[j]:
                    blocked[i] = True
            elif opts.tdensity in (TpDensity.FOURTAKAS, TpDensity.FOURTAKAS_FULL) and not ft_t:
                applies = (opts.tdensity == TpDensity.FOURTAKAS) or not bound_c
                if applies and not isft[j]:
                    rh = 1.0 + csp.ddtgz * dr[2]
                    drhop = csp.rhopzero * rh ** (1.0 / csp.gamma) - csp.rhopzero
                    visc_densi = csp.ddtkh * csp.cs0 * ((rho[j] - rho[i]) - drhop) / (rr2 + csp.eta2)
                    dlt = visc_densi * drfr * mass2 / rho[j]
                    if bound_c:
                        blocked[i] = True
                    else:
                        delta[i] -= dlt

            # shifting
            if opts.shiftmode != TpShifting.NONE:
                massrhop = mass2 / rho[j]
                if opts.shiftmode == TpShifting.NO_BOUND and (bound_c or isft[j]):
                    shift_blocked[i] = True
                if (opts.shiftmode == TpShifting.NO_FIXED and bound_c
                        and typ[j] == td.TYPE_FIXED):
                    shift_blocked[i] = True
                shift[i, 0] += massrhop * fr[0]
                shift[i, 1] += massrhop * fr[1]
                shift[i, 2] += massrhop * fr[2]
                shift[i, 3] -= massrhop * drfr

            # viscosity
            visco_eff = csp.visco * (csp.viscoboundfactor if bound_c else 1.0)
            if opts.tvisco == TpVisco.ARTIFICIAL:
                if dot < 0:
                    amubar = csp.kernelh * dot_rr2
                    robar = (rho[i] + rho[j]) * 0.5
                    pi_visc = (-visco_eff * csp.cs0 * amubar / robar) * mass2
                    ace[i] -= pi_visc * fr
            elif opts.tvisco == TpVisco.LAMINAR_SPS:
                robar2 = rho[i] + rho[j]
                temp = 4.0 * visco_eff / ((rr2 + csp.eta2) * robar2)
                vtemp = mass2 * temp * drfr
                ace[i] += vtemp * dv
                tsum = spstau[i].copy() if not isb[i] else np.zeros(6)
                if not bound_c and not isft[j]:
                    tsum = tsum + spstau[j]
                txx, txy, txz, tyy, tyz, tzz = tsum
                ace[i] += mass2 * np.array([
                    txx * fr[0] + txy * fr[1] + txz * fr[2],
                    txy * fr[0] + tyy * fr[1] + tyz * fr[2],
                    txz * fr[0] + tyz * fr[1] + tzz * fr[2]])
                if not ft_t:
                    volp2 = -mass2 / rho[j]
                    dvx, dvy, dvz = dv * volp2
                    gradvel[i] += np.array([
                        dvx * fr[0], dvx * fr[1] + dvy * fr[0],
                        dvx * fr[2] + dvz * fr[0], dvy * fr[1],
                        dvy * fr[2] + dvz * fr[1], dvz * fr[2]])

    ar = ar + np.where(blocked, 0.0, delta)
    if csp.simulate2d:
        ace[:, 1] = 0.0
    return dict(ace=ace, ar=ar, viscdtmax=max(viscdt, 0.0), shiftposfs=shift,
                shift_blocked=shift_blocked, gradvel=gradvel)
