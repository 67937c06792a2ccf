"""DEM contact tests (reference `InteractionForcesDEM`, JSphCpu.cpp:828-960).

Layered: an exact unit check of the Hertz/Coulomb pair force against a numpy
transcription of the model, then end-to-end drops where DEM keeps bodies from
tunneling through walls / each other at impact speeds where the conservative
SPH pressure bounce alone under-resolves the contact."""

import math
from dataclasses import replace as dcreplace

import jax.numpy as jnp
import numpy as np

import dualsphysics_multilayer.typesdef as td
from dualsphysics_multilayer.features import dem as DEM
from dualsphysics_multilayer.features import floating as FT
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import SimState, Simulation
from dualsphysics_multilayer.ops import celldiv as cd
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity, make_ctesph

PROPS = dict(young=1e6, poisson=0.3, kfric=0.45, restitu=0.2)


def test_dem_pair_force_matches_formula():
    """One floating particle overlapping one bound particle: apply_dem output
    equals the hand-evaluated visco-elastic Hertzian model."""
    dp = 0.1
    csp = make_ctesph(simulate2d=False, dp=dp, speedsound=20.0)
    # floor particle at origin; floating particle 0.6 dp above, moving down+x
    pos = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.6 * dp]], np.float32)
    vel = np.array([[0.0, 0.0, 0.0], [0.3, 0.0, -1.0]], np.float32)
    code = np.array([td.code_make(td.TYPE_FIXED, 0),
                     td.code_make(td.TYPE_FLOATING, 0)], np.uint32)

    class FtStub:
        mass = (5.0,)
        massp = (0.5,)

    cfg = DEM.make_dem(csp, code, FtStub(), float_props=[PROPS])
    dom = cd.make_domain((-1, -1, -1), (1, 1, 1), csp.kernelsize, dp=dp)
    div, _ = cd.divide(dom, jnp.asarray(pos), jnp.asarray(code))
    dt = 1e-4
    ace, demdt = DEM.apply_dem(cfg, csp, dom, div, jnp.asarray(pos),
                               jnp.asarray(vel), jnp.asarray(code), dt)
    ace = np.asarray(ace)
    assert np.allclose(ace[0], 0.0)          # bound side untouched

    # ---- numpy oracle of the model ----
    tau = (1 - PROPS["poisson"] ** 2) / PROPS["young"]
    kn = 4.0 / (3.0 * 2 * tau) * math.sqrt(dp / 4)
    m_eff = 5.0 / 2                          # against boundary: m1/2
    o = dp - 0.6 * dp
    nrm = np.array([0.0, 0.0, 1.0])
    dv = vel[1] - vel[0]
    vn = dv @ nrm                            # -1.0
    ln_e = math.log(PROPS["restitu"])
    gn = -(2 * ln_e * math.sqrt(m_eff * kn)) / math.sqrt(math.pi + ln_e ** 2)
    fn = kn * o ** 1.5 - gn * o ** 0.25 * vn
    exp = fn / 0.5 * nrm
    dvt = dv - vn * nrm
    vt = np.linalg.norm(dvt)
    ft_force = min(PROPS["kfric"] * fn * math.tanh(8 * vt),
                   2 * (kn * dt - gn) * vt / 7)
    exp = exp + ft_force / 0.5 * (dvt / vt)
    assert np.allclose(ace[1], exp, rtol=2e-3), (ace[1], exp)
    # dt safety term present
    expdem = (0.2 * 40 / 3.21) * (m_eff / kn) ** -0.4 * abs(vn) ** 0.2
    assert abs(float(demdt) - expdem) / expdem < 2e-3


def test_dem_same_body_excluded():
    """Overlapping particles of the SAME body exert no DEM force."""
    dp = 0.1
    csp = make_ctesph(simulate2d=False, dp=dp, speedsound=20.0)
    pos = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.5 * dp]], np.float32)
    vel = np.array([[0.0, 0.0, 0.1], [0.0, 0.0, -0.1]], np.float32)
    code = np.array([td.code_make(td.TYPE_FLOATING, 0),
                     td.code_make(td.TYPE_FLOATING, 0)], np.uint32)

    class FtStub:
        mass = (5.0,)
        massp = (0.5,)

    cfg = DEM.make_dem(csp, code, FtStub(), float_props=[PROPS])
    dom = cd.make_domain((-1, -1, -1), (1, 1, 1), csp.kernelsize, dp=dp)
    div, _ = cd.divide(dom, jnp.asarray(pos), jnp.asarray(code))
    ace, demdt = DEM.apply_dem(cfg, csp, dom, div, jnp.asarray(pos),
                               jnp.asarray(vel), jnp.asarray(code), 1e-4)
    assert np.allclose(np.asarray(ace), 0.0)
    assert float(demdt) == 0.0


def _dry_tank_with_boxes(dp, boxes, rhos):
    """Dry tank (floor + side walls), floating boxes at given positions."""
    csp = make_ctesph(simulate2d=True, dp=dp, speedsound=20.0, visco=0.05)
    d = cases.Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (1.0, 0, 1.0), ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right")
    for b, (pmin, pmax) in enumerate(boxes):
        d.box((pmin[0], 0, pmin[1]), (pmax[0], 0, pmax[1]),
              ptype=td.TYPE_FLOATING, mk=b)
    pos, code = d.build()
    isft = np.asarray(td.code_type(code) == td.TYPE_FLOATING)
    vals = np.asarray(td.code_value(code))
    body_pts = [pos[isft & (vals == b)] for b in range(len(boxes))]
    ftcfg, ftstate = FT.make_floating(body_pts, rhos, csp)
    dom = cases._make_domain(csp, pos, cellcap=cases.lattice_cellcap(csp, 2.0))
    st = cases._make_state(csp, pos, code, zsurf=0.0)
    st = dcreplace(st, ft=ftstate)
    demcfg = DEM.make_dem(csp, st.code, ftcfg,
                          float_props=[PROPS] * len(boxes))
    return csp, dom, st, ftcfg, demcfg


def test_dem_no_tunneling_at_impact():
    """A box slammed down at 3 m/s must not tunnel through the floor; the
    contact dissipates energy (rebound slower than impact)."""
    dp = 0.025
    csp, dom, st, ftcfg, demcfg = _dry_tank_with_boxes(
        dp, [((0.4, 0.15), (0.6, 0.35))], [800.0])
    st = dcreplace(st, ft=dcreplace(
        st.ft, fvel=jnp.asarray([[0.0, 0.0, -3.0]], jnp.float32)))
    vel = np.array(st.vel)
    ftsel = np.asarray(td.is_floating(st.code))
    vel[ftsel] = (0.0, 0.0, -3.0)
    st = dcreplace(st, vel=jnp.asarray(vel))
    feats = Features(floating=ftcfg, dem=demcfg)
    opts = SolverOpts(tdensity=TpDensity.NONE, with_floating=True)
    sim = Simulation(csp, opts, dom, st, feats=feats)
    zmins, vzs = [], []

    def on_save(s):
        stt = s.state
        sel = np.asarray(td.is_floating(stt.code) & td.is_active(stt.code))
        zmins.append(float(np.asarray(stt.pos)[sel, 2].min()))
        vzs.append(float(np.asarray(stt.ft.fvel)[0, 2]))

    sim.run(tmax=0.25, tout=0.0125, on_save=on_save)
    # never below the floor's top lattice row minus one dp
    assert min(zmins) > -1.0 * dp, min(zmins)
    # it bounced (upward at some sample) but slower than the 3 m/s impact
    assert max(vzs) > 0.1, vzs
    assert max(vzs) < 3.0, vzs
    assert int(sim.carry.overflow) == 0


def test_dem_boxes_repel():
    """A box dropped onto another box stacks instead of interpenetrating."""
    dp = 0.025
    csp, dom, st, ftcfg, demcfg = _dry_tank_with_boxes(
        dp, [((0.4, 0.0375), (0.6, 0.2)),    # resting on the floor
             ((0.42, 0.35), (0.58, 0.5))],   # dropped from above
        [800.0, 400.0])
    feats = Features(floating=ftcfg, dem=demcfg)
    opts = SolverOpts(tdensity=TpDensity.NONE, with_floating=True)
    sim = Simulation(csp, opts, dom, st, feats=feats)
    sim.run(tmax=0.5, tout=0.25)
    out = sim.state
    pos = np.asarray(out.pos)
    live = np.asarray(td.is_active(out.code))
    isft = np.asarray(td.is_floating(out.code))
    vals = np.asarray(td.code_value(out.code))
    b0 = live & isft & (vals == 0)
    b1 = live & isft & (vals == 1)
    # the upper box landed on the lower one: its lowest particle sits above
    # the lower box's top minus a small overlap
    top0 = pos[b0, 2].max()
    bot1 = pos[b1, 2].min()
    assert bot1 > top0 - 1.0 * dp, (top0, bot1)
    # no blow-up
    assert np.abs(np.asarray(out.ft.fvel)).max() < 3.0
    assert int(sim.carry.overflow) == 0


def test_dem_xml_properties(tmp_path):
    """<properties> material file + links + floating property attrs ->
    DemCfg; DOF and initial velocities parse (JCaseParts/JCaseProperties)."""
    from dualsphysics_multilayer.io import xmlcase
    (tmp_path / "mats.xml").write_text("""<?xml version="1.0"?>
<materials>
 <property name="steel">
  <Young_Modulus value="2.1e11"/><PoissonRatio value="0.3"/>
  <Restitution_Coefficient value="0.7"/><Kfric value="0.45"/>
 </property>
 <property name="pvc">
  <Young_Modulus value="3e9"/><PoissonRatio value="0.3"/>
  <Restitution_Coefficient value="0.6"/><Kfric value="0.45"/>
 </property>
</materials>""")
    xml = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/><hswl value="0" auto="true"/>
   <gamma value="7"/><speedsystem value="0" auto="true"/><coefsound value="20"/>
   <speedsound value="0" auto="true"/><coefh value="1.0"/><cflnumber value="0.2"/>
  </constantsdef>
  <mkconfig boundcount="240" fluidcount="10"/>
  <geometry>
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="2" y="0" z="1.5"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="1.2"/></drawbox>
    <setmkbound mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.5" y="0" z="0.6"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0.05"/><size x="2" y="0" z="0.4"/></drawbox>
   </mainlist></commands>
  </geometry>
  <floatings>
   <floating mkbound="1" rhopbody="500" property="pvc">
    <translationDOF x="1" y="0" z="1"/>
    <rotationDOF x="0" y="1" z="0"/>
    <linearvelini x="0.5" y="0" z="0"/>
   </floating>
  </floatings>
  <properties>
   <propertyfile file="mats.xml" path="materials"/>
   <links><link mkbound="0" property="steel"/></links>
  </properties>
 </casedef>
 <execution>
  <parameters>
   <parameter key="RigidAlgorithm" value="2"/>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "dem_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    feats = case.meta["features"]
    assert feats.dem is not None
    ftcfg = feats.floating
    assert ftcfg.translation_dof == (1.0, 0.0, 1.0)
    assert ftcfg.rotation_dof == (0.0, 1.0, 0.0)
    np.testing.assert_allclose(np.asarray(case.state.ft.fvel)[0],
                               [0.5, 0, 0])
    dem = feats.dem
    code = np.asarray(case.state.code)
    isb = np.asarray(td.code_type(code) < td.TYPE_FLOATING)
    isf = np.asarray(td.code_type(code) == td.TYPE_FLOATING)
    # bound (mk 0) tau = (1-0.3^2)/2.1e11 (steel); floating = pvc
    np.testing.assert_allclose(dem.c_tau[isb][0], (1 - 0.09) / 2.1e11,
                               rtol=1e-6)
    np.testing.assert_allclose(dem.c_tau[isf][0], (1 - 0.09) / 3e9,
                               rtol=1e-6)
    np.testing.assert_allclose(dem.c_restitu[isf][0], 0.6, rtol=1e-6)
