"""Multiphase non-Newtonian solver (the mphase model family).

Drives the HBP pipeline (`ops/forces_nn.py`) with the same symplectic
machinery as the single-phase solver — the analog of the mphase fork's
`JSphCpuSingle` with `MultiPhase` active
(`/root/reference/src_mphase/DSPH_v5.0_NNewtonian/source/JSphCpu_NN_SPH.cpp`,
`JSph::InitMultiPhase` JSph.cpp:3137-3216: system cs0 = max phase cs0,
per-phase mass/CteB).
"""

from __future__ import annotations

from dataclasses import replace

import jax.numpy as jnp
import numpy as np

from .. import typesdef as td
from ..typesdef import CteSph, TpShifting, TpVisco, make_ctesph
from ..ops import celldiv as cd
from ..ops import forces as F
from ..ops import forces_nn as NN
from ..ops import integrators as I
from ..ops.forces import SolverOpts
from .wcsph import SimState, StepCarry, pinned_precision
from . import cases as C


def make_nn_step(csp: CteSph, opts: SolverOpts, dom: cd.Domain,
                 phases: NN.PhaseCfg):
    """Symplectic predictor/corrector step over the NN pipeline
    (ComputeStep_Sym with the _NN_SPH interaction, JSphCpu_NN_SPH.cpp:663)."""

    def interaction(st: SimState):
        div, code = cd.divide(dom, st.pos, st.code)
        st = replace(st, code=code)
        fr, eta, tau = NN.interaction_forces_nn(
            csp, opts, phases, dom, div, st.pos, st.vel, st.rho, st.code)
        return st, div, fr

    def step(carry: StepCarry) -> StepCarry:
        st = carry.st
        dt = carry.dt_pre

        st, div1, fr1 = interaction(st)
        velmax1 = I.velocity_max(csp, st.vel, st.code)
        acemax1 = I.ace_max(fr1.ace, st.code)
        dt_p, bad_p = I.dt_variable(csp, acemax1, velmax1, fr1.viscdtmax,
                                    fr1.viscetadtmax, opts.relaxationdt)
        pos_pre, vel_pre, rho_pre = st.pos, st.vel, st.rho
        pos1, vel1, rho1, code1 = I.symplectic_pre(
            csp, st.pos, st.vel, st.rho, st.code, fr1.ace, fr1.ar, dt)
        st = replace(st, pos=pos1, vel=vel1, rho=rho1, code=code1)

        st, div2, fr2 = interaction(st)
        velmax2 = I.velocity_max(csp, st.vel, st.code)
        acemax2 = I.ace_max(fr2.ace, st.code)
        dt_c, bad_c = I.dt_variable(csp, acemax2, velmax2, fr2.viscdtmax,
                                    fr2.viscetadtmax, opts.relaxationdt)
        shiftdisp = None
        if opts.shiftmode != TpShifting.NONE:
            shiftdisp = F.apply_shifting(csp, opts, dt, st.vel, st.code,
                                         fr2.shiftposfs, fr2.shift_blocked)
        out_corr = I.symplectic_corr(
            csp, pos_pre, vel_pre, rho_pre, st.rho, st.code,
            fr2.ace, fr2.ar, dt, shiftdisp, pose=st.pose)
        pos2, vel2, rho2, code2 = out_corr[:4]
        st = replace(st, pos=pos2, vel=vel2, rho=rho2, code=code2,
                     pose=out_corr[4] if st.pose is not None else None)

        return replace(
            carry, st=st, t=carry.t + dt, dt_pre=jnp.minimum(dt_p, dt_c),
            nstep=carry.nstep + 1,
            overflow=jnp.maximum(carry.overflow,
                                 jnp.maximum(div1.overflow, div2.overflow)),
            dtmodif=carry.dtmodif + bad_p.astype(jnp.int32)
                    + bad_c.astype(jnp.int32),
            tabs=carry.tabs + dt)

    return pinned_precision(step)


def make_nn_csp(*, simulate2d, dp, phases: NN.PhaseCfg, gravity=(0, 0, -9.81),
                coefh=1.0, cflnumber=0.2, hswl=1.0, **kw) -> CteSph:
    """System constants for a multiphase run: cs0 = max phase cs0, rhop0 and
    masses of phase 0 as the bound reference (ConfigConstantsMP)."""
    cs0 = phases.system_cs0()
    csp = make_ctesph(simulate2d=simulate2d, dp=dp, gravity=gravity,
                      coefh=coefh, cflnumber=cflnumber, hswl=hswl,
                      speedsound=cs0, rhopzero=phases.phases[0].rho0, **kw)
    # the density-exclusion window must span every phase's rest density;
    # the dt floor drops 1e-5x like the reference's multiphase
    # ConfigConstantsMP (CoefDtMin *= 1e-5) — the HBP viscous dt3 control
    # legitimately drives dt far below the single-phase floor
    rmin = min(p.rho0 for p in phases.phases)
    rmax = max(p.rho0 for p in phases.phases)
    return csp.replace(rhopoutmin=0.6 * rmin, rhopoutmax=1.5 * rmax,
                       dtmin=csp.dtmin * 1e-5)


def wet_dambreak_nn(dp=0.02, *, tank=(2.0, 1.0), mud=(0.5, 0.3),
                    water_depth=0.15, mud_rho=1500.0, water_rho=1000.0,
                    mud_visco=0.1, hbp_m=10.0, hbp_n=1.0, tau_yield=0.001,
                    capacity=None):
    """2D wet dam break: an HBP mud column collapsing into a water layer
    (the examples/mphase_nnewtonian/01_WetDambreak family; phase parameters
    mirror CaseWetDambreak2DNN_Def.xml's <nnphases> block)."""
    g = 9.81
    cs_w = 20.0 * np.sqrt(g * max(mud[1], water_depth))
    phases = NN.PhaseCfg(phases=(
        NN.Phase(mkfluid=0, rho0=water_rho, csound=cs_w, visco=0.05,
                 tau_yield=0.0005, hbp_m=0.0, hbp_n=1.0),
        NN.Phase(mkfluid=1, rho0=mud_rho,
                 csound=cs_w * np.sqrt(mud_rho / water_rho), visco=mud_visco,
                 tau_yield=tau_yield, hbp_m=hbp_m, hbp_n=hbp_n),
    ))
    csp = make_nn_csp(simulate2d=True, dp=dp, phases=phases,
                      hswl=max(mud[1], water_depth))
    d = C.Draw(dp=dp, simulate2d=True)
    # water layer then mud column (overwrites water region)
    d.box((0, 0, 0), (tank[0], 0, water_depth), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (mud[0], 0, mud[1]), ptype=td.TYPE_FLUID, mk=1)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    pos, code = d.build()
    dom = C._make_domain(csp, pos)
    st = C._make_state(csp, pos, code, zsurf=water_depth, capacity=capacity)
    # mud column starts at rest density of its phase
    isfl = td.code_type(code) == td.TYPE_FLUID
    mk = np.asarray(td.code_value(code))
    rho = np.array(st.rho)
    ismud = np.asarray(isfl) & (mk == 1)
    rho[:len(pos)][ismud[:len(pos)]] = mud_rho
    import dataclasses
    st = dataclasses.replace(st, rho=jnp.asarray(rho, jnp.float32))
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    case = C.Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                  meta=dict(name="wet_dambreak_nn", dp=dp, phases=phases,
                            zsurf=water_depth))
    return case, phases
