"""Feature subsystem tests: motion, floating bodies, damping, accinput."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.features import motion as MOT
from dualsphysics_multilayer.features import damping as DMP
from dualsphysics_multilayer.features import accinput as ACC
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.typesdef import TpDensity


def live_mask(st, kind=None):
    m = np.array(td.is_active(st.code))
    if kind == "fluid":
        m = m & np.asarray(td.is_fluid(st.code))
    elif kind == "moving":
        m = m & np.asarray(td.is_moving(st.code))
    elif kind == "floating":
        m = m & np.asarray(td.is_floating(st.code))
    return m


def test_motion_piston_tracks_analytic():
    """Sinusoidal piston wall follows amp*sin(2*pi*f*t) and drives fluid."""
    case = cases.waveflume2d(dp=0.04, flume=(2.0, 0.8), water=0.3,
                             piston_freq=1.0, piston_amp=0.05)
    feats = Features(motions=(case.meta["motion"],))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    x0 = np.asarray(case.state.pos)[live_mask(case.state, "moving"), 0].mean()
    sim.run(tmax=0.25, tout=0.25)
    st = sim.state
    t = float(sim.carry.tabs)
    xp = np.asarray(st.pos)[live_mask(st, "moving"), 0].mean()
    expect = x0 + 0.05 * np.sin(2 * np.pi * 1.0 * t)
    assert abs(xp - expect) < 1e-3, (xp, expect, t)
    # fluid must have been pushed (net x momentum nonzero)
    vflu = np.asarray(st.vel)[live_mask(st, "fluid")]
    assert np.abs(vflu[:, 0]).max() > 0.01


def test_floating_box_is_rigid_and_buoyant():
    # box bottom at z=0.32 with water to 0.5: 90% submerged, equilibrium for
    # rho=500 is 50% -> strong buoyant rise expected
    case = cases.floatingbox2d(dp=0.025, tank=(1.2, 1.0), water=0.5,
                               box=(0.2, 0.2), box_pos=(0.5, 0.32),
                               box_rho=500.0)
    feats = Features(floating=case.meta["ftcfg"])
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    ftsel = live_mask(case.state, "floating")
    p0 = np.asarray(case.state.pos)[ftsel]
    d0 = np.linalg.norm(p0[0] - p0[-1])
    c0 = float(np.asarray(case.state.ft.center)[0, 2])
    sim.run(tmax=0.3, tout=0.3)
    st = sim.state
    p1 = np.asarray(st.pos)[live_mask(st, "floating")]
    d1 = np.linalg.norm(p1[0] - p1[-1])
    # rigid: pairwise extent preserved to a fraction of dp
    assert abs(d1 - d0) < 0.2 * case.csp.dp, (d0, d1)
    # buoyant: a half-density box starting mostly submerged must rise
    c1 = float(np.asarray(st.ft.center)[0, 2])
    assert c1 > c0 + 0.005, (c0, c1)
    # body velocity is finite and sane
    assert np.isfinite(np.asarray(st.ft.fvel)).all()
    assert np.abs(np.asarray(st.ft.fvel)).max() < 5.0


def test_damping_zone_kills_velocity():
    case = cases.dambreak2d(dp=0.05, tank=(1.6, 1.0), column=(1.6, 0.4))
    zone = DMP.DampingPlane(point=(0.8, 0, 0), limitpoint=(1.4, 0, 0),
                            redumax=10.0)
    feats = Features(damping=(zone,))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    # give the fluid a uniform +x velocity
    import dataclasses
    st = case.state
    fluid = live_mask(st, "fluid")
    vel = np.array(st.pos) * 0.0
    vel[fluid, 0] = 0.5
    st = dataclasses.replace(st, vel=jnp.asarray(vel, jnp.float32))
    sim = Simulation(case.csp, opts, case.dom, st, feats=feats)
    sim.run(tmax=0.08, tout=0.08)
    pos = np.asarray(sim.state.pos)
    v = np.asarray(sim.state.vel)
    fl = live_mask(sim.state, "fluid")
    deep = fl & (pos[:, 0] > 1.3)       # fully inside the damped region
    free = fl & (pos[:, 0] < 0.5)       # outside the zone
    assert np.abs(v[deep, 0]).mean() < 0.5 * np.abs(v[free, 0]).mean()


def test_accinput_adds_body_force():
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(1.0, 0.4))
    acc = ACC.AccInput(mkfluid=0, times=(0.0, 10.0),
                       acclin=(3.0, 0.0, 0.0, 3.0, 0.0, 0.0))
    feats = Features(accinputs=(acc,))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    sim.run(tmax=0.05, tout=0.05)
    v = np.asarray(sim.state.vel)
    fl = live_mask(sim.state, "fluid")
    # bulk x-velocity ~ a*t
    vx = v[fl, 0].mean()
    assert 0.5 * 3.0 * 0.05 < vx < 1.5 * 3.0 * 0.05, vx


def test_motion_rotation_and_table():
    """Rotation motion spins a wall about an axis; table motion integrates a
    velocity time-series."""
    rot = MOT.rotation_motion(5, axis_p1=(0, 0, 0), axis_p2=(0, 1, 0),
                              degrees_per_s=90.0)
    disp, vel, R, c, has_rot, axis, w = MOT.motion_step(rot, jnp.float32(0.0),
                                                        jnp.float32(0.5))
    assert has_rot
    ang = np.arccos(np.clip((np.trace(np.asarray(R)) - 1) / 2, -1, 1))
    assert abs(ang - np.deg2rad(45.0)) < 1e-4

    tab = MOT.table_motion(6, times=[0.0, 1.0, 2.0],
                           velocities=[[1, 0, 0], [1, 0, 0], [0, 0, 0]])
    disp, vel, *_ = MOT.motion_step(tab, jnp.float32(0.0), jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(disp), [1.0, 0, 0], atol=1e-5)
    disp2, vel2, *_ = MOT.motion_step(tab, jnp.float32(1.0), jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(disp2), [0.5, 0, 0], atol=1e-5)


def test_viscoinput_table_and_equivalence(tmp_path):
    """JDsViscoInput: CSV loads/interps; a constant table reproduces the
    static-visco run exactly (the traced-visco path is value-identical)."""
    from dualsphysics_multilayer.features import viscoinput as VI
    f = tmp_path / "visco.csv"
    f.write_text("#t visco\n0.0;0.02\n1.0;0.06\n2.0;0.10\n")
    vt = VI.load_viscoinput(str(f))
    np.testing.assert_allclose(float(vt.visco_at(0.5)), 0.04, rtol=1e-6)
    np.testing.assert_allclose(float(vt.visco_at(5.0)), 0.10, rtol=1e-6)

    case = cases.dambreak2d(dp=0.05)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    const = VI.ViscoInput(times=(0.0, 1.0),
                          values=(case.csp.visco, case.csp.visco))
    runs = {}
    for name, feats in dict(
            static=None,
            table=Features(viscotime=const)).items():
        sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
        sim.run(tmax=0.04, tout=0.02)
        runs[name] = np.asarray(sim.carry.st.pos)
    np.testing.assert_allclose(runs["table"], runs["static"], atol=1e-6)


def test_ftmotion_save_channel(tmp_path):
    """JFtMotionSave: per-dt floating motion ring drains to
    PartFloatMotion.fbi4 with monotonically increasing times."""
    from dualsphysics_multilayer.io.output import OutputManager
    from dualsphysics_multilayer.io import jbinary as jb
    case = cases.floatingbox2d(dp=0.03, tank=(1.2, 1.0), water=0.5,
                               box=(0.2, 0.2), box_pos=(0.5, 0.32),
                               box_rho=500.0)
    feats = Features(floating=case.meta["ftcfg"])
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True,
                      ftmotion=2048)
    sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
    out = OutputManager(str(tmp_path), case, feats=feats)
    sim.run(tmax=0.04, tout=0.02, on_save=out)
    path = tmp_path / "PartFloatMotion.fbi4"
    assert path.exists()
    root = jb.read_file(str(path))
    times = [it.get("TimeStep") for it in root.items
             if it.name.startswith("PART_")]
    assert len(times) >= 10            # dt-level, far more than 2 PARTs
    assert all(b > a for a, b in zip(times, times[1:]))
    cen = [it.array("center").data for it in root.items
           if it.name.startswith("PART_")]
    assert np.isfinite(np.asarray(cen)).all()


def test_motion_circular_and_chain_xml(tmp_path):
    """mvcir translates along a circle (orientation preserved) and a
    next-chain with a loop produces periodic motion (JMotion vocabulary)."""
    from dualsphysics_multilayer.io import xmlcase
    xml = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
   <hswl value="0.3" auto="false"/><gamma value="7"/>
   <speedsound value="30" auto="false"/><coefh value="1.0"/>
   <cflnumber value="0.2"/>
  </constantsdef>
  <geometry>
   <definition dp="0.05"><pointmin x="-2" y="0" z="-2"/>
    <pointmax x="3" y="0" z="3"/></definition>
   <commands><mainlist>
    <setmkbound mk="7"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="0.9" y="0" z="-0.1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkbound mk="8"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1" y="0" z="1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1.5" y="0" z="-1.5"/><size x="0.2" y="0" z="0.2"/></drawbox>
   </mainlist></commands>
  </geometry>
  <motion>
   <objreal ref="7">
    <begin mov="1" start="0"/>
    <mvcir id="1" duration="10" anglesunits="degrees">
     <vel ang="90"/>
     <ref x="1" y="0" z="0"/>
     <axisp1 x="0" y="0" z="0"/><axisp2 x="0" y="1" z="0"/>
    </mvcir>
   </objreal>
   <objreal ref="8">
    <begin mov="1" start="0"/>
    <mvrect id="1" duration="0.5" next="2"><vel x="1" y="0" z="0"/></mvrect>
    <mvrect id="2" duration="0.5" next="1"><vel x="-1" y="0" z="0"/></mvrect>
   </objreal>
  </motion>
 </casedef>
 <execution><parameters>
  <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
 </parameters></execution>
</case>"""
    p = tmp_path / "mot_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    feats = case.meta["features"]
    mdefs = {m.mk: m for m in feats.motions}
    assert 7 in mdefs and 8 in mdefs
    # mk=8 chain loops with period 1.0
    assert abs(mdefs[8].loop_t - 1.0) < 1e-9
    # evaluate mvcir: after t=1s at 90 deg/s about +y through origin, the
    # ref point (1,0,0) rotates by -90deg about y... check displacement
    # magnitude equals chord length and orientation is NOT rotated
    import jax.numpy as jnp
    disp = jnp.zeros(3)
    t = 0.0
    dt = 0.01
    for _ in range(100):
        d, v, rot, ctr, has_rot, ax, wv = MOT.motion_step(mdefs[7], t, dt)
        disp = disp + d
        assert not has_rot                  # mvcir: translation only
        t += dt
    # 90 degrees about y: (1,0,0) -> (0,0,-+1); chord = sqrt(2)
    assert abs(float(jnp.linalg.norm(disp)) - np.sqrt(2.0)) < 1e-3
    # the chained piston returns to start after one full period
    disp8 = jnp.zeros(3)
    t = 0.0
    for _ in range(200):
        d, *_ = MOT.motion_step(mdefs[8], t, dt)
        disp8 = disp8 + d
        t += dt
    assert float(jnp.abs(disp8).max()) < 1e-4


def test_motion_rotfile_and_rectfile(tmp_path):
    """mvrotfile (angle table) and mvrectfile (position table) drive walls
    from data files (JLinearValue path)."""
    from dualsphysics_multilayer.io import xmlcase
    (tmp_path / "ang.dat").write_text("0 0\n1 90\n2 180\n")
    (tmp_path / "posx.dat").write_text("0 0\n1 0.5\n2 1.0\n")
    xml = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
   <hswl value="0.3" auto="false"/><gamma value="7"/>
   <speedsound value="30" auto="false"/><coefh value="1.0"/>
   <cflnumber value="0.2"/>
  </constantsdef>
  <geometry>
   <definition dp="0.05"><pointmin x="-2" y="0" z="-2"/>
    <pointmax x="3" y="0" z="3"/></definition>
   <commands><mainlist>
    <setmkbound mk="7"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="0.9" y="0" z="-0.1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkbound mk="8"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1" y="0" z="1"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
     <point x="-1.5" y="0" z="-1.5"/><size x="0.2" y="0" z="0.2"/></drawbox>
   </mainlist></commands>
  </geometry>
  <motion>
   <objreal ref="7">
    <begin mov="1" start="0"/>
    <mvrotfile id="1" duration="10" anglesunits="degrees">
     <file name="ang.dat"/>
     <axisp1 x="0" y="0" z="0"/><axisp2 x="0" y="1" z="0"/>
    </mvrotfile>
   </objreal>
   <objreal ref="8">
    <begin mov="1" start="0"/>
    <mvrectfile id="1" duration="10">
     <file name="posx.dat" fields="2" fieldtime="0" fieldx="1"/>
    </mvrectfile>
   </objreal>
  </motion>
 </casedef>
 <execution><parameters>
  <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
 </parameters></execution>
</case>"""
    p = tmp_path / "motf_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    mdefs = {m.mk: m for m in case.meta["features"].motions}
    import jax.numpy as jnp
    # rotation: 90 deg after 1 s
    ang = 0.0
    t = 0.0
    dt = 0.02
    for _ in range(50):
        d, v, rot, ctr, has_rot, ax, wv = MOT.motion_step(mdefs[7], t, dt)
        assert has_rot
        # accumulate angle from the incremental rotation about +y
        ang += float(jnp.arctan2(rot[0, 2], rot[0, 0]))
        t += dt
    assert abs(abs(ang) - np.pi / 2) < 1e-2, ang
    # position table: x moves 0.5 m in the first second
    disp = jnp.zeros(3)
    t = 0.0
    for _ in range(50):
        d, *_ = MOT.motion_step(mdefs[8], t, dt)
        disp = disp + d
        t += dt
    assert abs(float(disp[0]) - 0.5) < 1e-3


def test_accinput_angular_terms():
    """Angular accinput adds dw/dt x r + w x (w x r) + 2 w x (v - vl)
    with velang Euler-integrated from accang (JDsAccInput.cpp:340-395)."""
    import jax.numpy as jnp
    csp = cases.make_ctesph(simulate2d=False, dp=0.1, hswl=0.5)
    # constant angular acceleration 2 rad/s^2 about z, from t=0
    acc = ACC.AccInput(mkfluid=0, times=(0.0, 1.0, 2.0),
                       acclin=(0.0,) * 9,
                       accang=(0, 0, 2.0) * 3,
                       centre=(0.0, 0.0, 0.0))
    # velang at t=1: Euler forward -> w = (0,0,2)*1
    np.testing.assert_allclose(np.asarray(acc.at(1.0)[3]), [0, 0, 2.0],
                               atol=1e-6)
    pos = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
    vel = jnp.asarray([[0.0, 1.0, 0.0]], jnp.float32)
    code = jnp.asarray([td.code_make(td.TYPE_FLUID, 0)], jnp.uint32)
    ace = jnp.zeros((1, 3), jnp.float32)
    out = np.asarray(ACC.apply_accinput((acc,), csp, 1.0, pos, vel, code,
                                        ace))[0]
    # term1: (0,0,2) x (1,0,0) = (0,2,0); term2: w x (w x r) = (-4,0,0);
    # term3: 2w x v = 2*(0,0,2) x (0,1,0) = (-4,0,0)
    np.testing.assert_allclose(out, [-8.0, 2.0, 0.0], atol=1e-5)
    # outside the activation window: no force
    acc2 = ACC.AccInput(mkfluid=0, times=acc.times, acclin=acc.acclin,
                        accang=acc.accang, tstart=5.0)
    out2 = np.asarray(ACC.apply_accinput((acc2,), csp, 1.0, pos, vel, code,
                                         ace))[0]
    np.testing.assert_allclose(out2, 0.0, atol=1e-7)


def test_accinput_xml_parsing(tmp_path):
    """<special><accinputs> parses acctimes tables, time windows,
    globalgravity, mkbound lists and acctimesfile (_FmtXML_AccInput.xml)."""
    from dualsphysics_multilayer.io import xmlcase
    (tmp_path / "forces.csv").write_text(
        "#t ax ay az angx angy angz\n0;1;0;0;0;0;0\n5;1;0;0;0;0;0\n")
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="1" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="1" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="0.9" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <accinputs>
    <accinput mkfluid="0">
     <time start="0" end="10"/>
     <acccentre x="0" y="0" z="0"/>
     <globalgravity value="1"/>
     <acctimes>
      <timevalue time="0.0" linz="0"/>
      <timevalue time="0.5" linz="2" angy="5"/>
     </acctimes>
    </accinput>
    <accinput mkbound="0">
     <acccentre x="0" y="0" z="0"/>
     <globalgravity value="0"/>
     <acctimesfile value="forces.csv"/>
    </accinput>
   </accinputs>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "acc_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    a0, a1 = case.meta["features"].accinputs
    assert a0.mkfluid == 0 and a0.tend == 10.0 and a0.gravity_enabled
    assert a0.times == (0.0, 0.5)
    assert a0.accang[4] == 5.0          # angy at second sample
    assert a1.mkbound == (0,) and not a1.gravity_enabled
    assert a1.times == (0.0, 5.0) and a1.acclin[0] == 1.0
