"""Relaxation-zone and multi-layer-piston unit tests (SURVEY §2.11;
reference JRelaxZone_ker.cu / JMLPistons)."""

import math

import jax.numpy as jnp
import numpy as np

import dualsphysics_multilayer.typesdef as td
from dualsphysics_multilayer.features.mlpiston import (MLPiston1D,
                                                           apply_mlpistons)
from dualsphysics_multilayer.features.relaxzone import (
    RelaxZoneRegular, RelaxZoneUniform, apply_relaxzones)
from dualsphysics_multilayer.features.wavegen import dispersion_k
from dualsphysics_multilayer.typesdef import make_ctesph


def _csp():
    return make_ctesph(simulate2d=True, dp=0.1, speedsound=10.0)


def test_relaxzone_uniform_blend():
    csp = _csp()
    zone = RelaxZoneUniform(pmin=(0, -1, 0), pmax=(1, 1, 1), vel=(2.0, 0, 0))
    pos = jnp.asarray([[0.5, 0, 0.5],      # center: full blend (tanh bump)
                       [0.75, 0, 0.5],     # halfway out: partial
                       [1.5, 0, 0.5]],     # outside: untouched
                      jnp.float32)
    vel = jnp.zeros((3, 3), jnp.float32)
    code = jnp.full((3,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    out = np.asarray(apply_relaxzones((zone,), csp, 0.0, pos, vel, code))
    assert abs(out[0, 0] - 2.0) < 0.01
    # reference weight at vdis=0.5 (JRelaxZone_ker.cu:161)
    a, b = 0.9, 1.0
    fsub = math.tanh((1 + a) * b) - math.tanh((1 - a) * b)
    fdiv = math.tanh(a * b) - math.tanh(-a * b) - fsub
    fmid = (math.tanh((0.5 + a) * b) - math.tanh((0.5 - a) * b) - fsub) / fdiv
    assert abs(out[1, 0] - 2.0 * fmid) < 1e-3
    assert out[2, 0] == 0.0
    # bound particles are never blended
    codeb = jnp.full((3,), td.code_make(td.TYPE_FIXED, 0), jnp.uint32)
    outb = np.asarray(apply_relaxzones((zone,), csp, 0.0, pos, vel, codeb))
    assert np.all(outb == 0.0)
    # coefdt rate: applied fraction is f * min(coefdt*dt, 1)
    outd = np.asarray(apply_relaxzones((zone,), csp, 0.0, pos, vel, code,
                                       dt=1e-4))
    assert abs(outd[0, 0] - 2.0 * min(1000 * 1e-4, 1.0)) < 1e-3
    # velocitytimes table overrides the constant velocity
    import dataclasses as _dc
    zt = _dc.replace(zone, veltimes=(0.0, 2.0), velvalues=(0.0, 1.0),
                     direction=(1.0, 0, 0))
    outt = np.asarray(apply_relaxzones((zt,), csp, 1.0, pos, vel, code))
    assert abs(outt[0, 0] - 0.5) < 1e-3


def test_relaxzone_regular_airy_field():
    """Blended velocity at the zone center equals the 1st-order wave
    solution in the reference convention (KerCalcVelocityX/Z)."""
    csp = _csp()
    H, T, d = 0.1, 1.4, 0.35
    swl = d
    zone = RelaxZoneRegular(center=(1.0, 0, 0), width=0.8, height=H,
                            period=T, depth=d, swl=swl)
    k = dispersion_k(T, d)
    w = 2 * math.pi / T
    # particle at the zone center (weight=1), z = swl - d/2
    x, z = 1.0, swl - d / 2
    t = 0.3
    pos = jnp.asarray([[x, 0, z]], jnp.float32)
    vel = jnp.zeros((1, 3), jnp.float32)
    code = jnp.full((1,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    out = np.asarray(apply_relaxzones((zone,), csp, t, pos, vel, code))[0]
    wpf = 0.5 * H * w
    zz = z - swl
    u_exp = wpf * math.cosh(k * (d + zz)) * math.cos(w * t) / math.sinh(k * d)
    w_exp = -wpf * math.sinh(k * (d + zz)) * math.sin(w * t) / math.sinh(k * d)
    assert abs(out[0] - u_exp) < 5e-3 * abs(u_exp) + 1e-4, (out[0], u_exp)
    assert abs(out[2] - w_exp) < 5e-3 * abs(w_exp) + 1e-4, (out[2], w_exp)


def test_relaxzone_spectrum_and_drift():
    """Spectrum zone: component sum matches a manual Airy sum; drift
    correction subtracts the per-component Stokes profile."""
    from dualsphysics_multilayer.features.relaxzone import (
        make_spectrum_zone)
    csp = _csp()
    d = 0.5
    zone = make_spectrum_zone(center=(1.0, 0, 0), width=1.0, height=0.08,
                              period=1.6, depth=d, swl=d, waves=16,
                              randomseed=3)
    assert len(zone.comp_k) == 16
    t = 0.7
    z = d - 0.2
    pos = jnp.asarray([[1.0, 0, z]], jnp.float32)
    vel = jnp.zeros((1, 3), jnp.float32)
    code = jnp.full((1,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    out = np.asarray(apply_relaxzones((zone,), csp, t, pos, vel, code))[0]
    u_exp = sum(a * wv * math.cosh(kk * (d + (z - d)))
                * math.cos(wv * t - ph) / math.sinh(kk * d)
                for kk, a, wv, ph in zip(zone.comp_k, zone.comp_amp,
                                         zone.comp_w, zone.comp_phase))
    assert abs(out[0] - u_exp) < 2e-3 * max(abs(u_exp), 0.01)
    # drift correction reduces the mean x velocity
    import dataclasses as _dc
    zdc = _dc.replace(zone, driftcorrection=1.0)
    outd = np.asarray(apply_relaxzones((zdc,), csp, t, pos, vel, code))[0]
    assert outd[0] < out[0]


def test_mlpiston_bilinear_and_apply():
    times = (0.0, 1.0)
    zl = (0.0, 1.0)
    # v(t,z): corners 0, 2 (z) / 4, 6 (t=1)
    vels = (0.0, 2.0, 4.0, 6.0)
    p = MLPiston1D(mk=7, times=times, zlayers=zl, vels=vels)
    assert abs(float(p.velocity_at(0.0, 0.0)) - 0.0) < 1e-6
    assert abs(float(p.velocity_at(0.0, 1.0)) - 2.0) < 1e-6
    assert abs(float(p.velocity_at(1.0, 0.0)) - 4.0) < 1e-6
    assert abs(float(p.velocity_at(0.5, 0.5)) - 3.0) < 1e-6
    # clamping outside the table
    assert abs(float(p.velocity_at(5.0, 2.0)) - 6.0) < 1e-6

    pos = jnp.asarray([[0.0, 0, 0.5], [0.0, 0, 0.5]], jnp.float32)
    vel = jnp.zeros((2, 3), jnp.float32)
    code = jnp.asarray([td.code_make(td.TYPE_MOVING, 7),
                        td.code_make(td.TYPE_FLUID, 0)], jnp.uint32)
    dt = 0.1
    pos2, vel2 = apply_mlpistons((p,), 0.5, dt, pos, vel, code)
    pos2, vel2 = np.asarray(pos2), np.asarray(vel2)
    assert abs(vel2[0, 0] - 3.0) < 1e-6        # moving particle driven
    assert abs(pos2[0, 0] - 0.3) < 1e-6        # advanced by v*dt
    assert vel2[1, 0] == 0.0 and pos2[1, 0] == 0.0   # fluid untouched


def test_mlpiston2d_y_interpolation():
    """piston2d: columns at several y positions, linear interp between
    neighbours (_FmtXML_MLPistons.xml veldata/posy)."""
    from dualsphysics_multilayer.features.mlpiston import MLPiston2D
    times = (0.0, 1.0)
    zl = (0.0, 1.0)
    c0 = MLPiston1D(mk=5, times=times, zlayers=zl, vels=(1.0,) * 4)
    c1 = MLPiston1D(mk=5, times=times, zlayers=zl, vels=(3.0,) * 4)
    p = MLPiston2D(mk=5, cols=(c0, c1), posy=(0.0, 2.0))
    y = jnp.asarray([0.0, 1.0, 2.0, 5.0], jnp.float32)
    z = jnp.full((4,), 0.5, jnp.float32)
    v = np.asarray(p.velocity_at(0.5, y, z))
    np.testing.assert_allclose(v, [1.0, 2.0, 3.0, 3.0], atol=1e-6)

    pos = jnp.asarray([[0.0, 1.0, 0.5]], jnp.float32)
    vel = jnp.zeros((1, 3), jnp.float32)
    code = jnp.asarray([td.code_make(td.TYPE_MOVING, 5)], jnp.uint32)
    _, vel2 = apply_mlpistons((p,), 0.5, 0.1, pos, vel, code)
    assert abs(float(vel2[0, 0]) - 2.0) < 1e-6


def test_mlpiston_csv_and_xml(tmp_path):
    """<special><mlayerpistons> piston1d + piston2d parse from case XML;
    layer bands derive from the piston particle z extent."""
    from dualsphysics_multilayer.io import xmlcase

    (tmp_path / "velx.csv").write_text(
        "time;v1;v2;v3\n0.0;0.1;0.2;0.3\n2.0;0.5;0.6;0.7\n")
    (tmp_path / "velx_y1.csv").write_text(
        "time v1 v2 v3\n0.0 1.0 1.0 1.0\n2.0 1.0 1.0 1.0\n")
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
   <definition dp="0.05"><pointmin x="-0.3" y="0" z="0"/><pointmax x="2" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="10"/><drawbox><boxfill>solid</boxfill>
     <point x="-0.2" y="0" z="0"/><size x="0.1" y="0" z="0.6"/></drawbox>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.1" y="0" z="0.05"/><size x="1" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <mlayerpistons>
    <piston1d>
     <mkbound value="10"/>
     <filevelx value="velx.csv"/>
     <incz value="0.05"/>
     <timedataini value="0.5"/>
     <smooth value="1"/>
    </piston1d>
   </mlayerpistons>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "mlp_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    feats = case.meta["features"]
    assert len(feats.mlpistons) == 1
    pist = feats.mlpistons[0]
    assert pist.mk == 10
    # timedataini shifts the series
    assert pist.times[0] == 0.5 and pist.times[-1] == 2.5
    # 3 layers over the piston z extent [0, 0.6] + incz 0.05
    assert len(pist.zlayers) == 3
    np.testing.assert_allclose(pist.zlayers, [0.15, 0.35, 0.55], atol=1e-6)
    # the piston block got retyped to moving
    code = np.asarray(case.state.code)
    mv = (np.asarray(td.code_type(code)) == td.TYPE_MOVING) \
        & (np.asarray(td.code_value(code)) == 10)
    assert mv.any()


def test_relaxzones_xml_parsing(tmp_path):
    """<special><relaxationzones> parses all four zone kinds
    (_FmtXML_RelaxationZones.xml)."""
    from dualsphysics_multilayer.io import xmlcase
    from dualsphysics_multilayer.features.relaxzone import (
        RelaxZoneExternal, RelaxZoneRegular, RelaxZoneSpectrum,
        RelaxZoneUniform)
    # external grid CSV (inout gridveldata format)
    (tmp_path / "ext.csv").write_text(
        "fmtversion;grid_dpx;grid_dpz;grid_nx;grid_nz;vars\n"
        "1;0.5;0.1;2;3;velx\n"
        "0.0;1;1;1;1;1;1\n"
        "9.9;2;2;2;2;2;2\n")
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="4" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="4" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="3.9" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <relaxationzones>
    <rzwaves_regular>
     <start value="0"/><duration value="0"/>
     <waveorder value="2"/><waveheight value="0.16"/><waveperiod value="2"/>
     <depth value="0.35"/><swl value="0.35"/>
     <center x="0.5" y="0" z="0"/><width value="0.4"/>
     <phase value="0.5"/><ramp value="1"/>
     <coefdir x="1" y="0" z="0"/><coefdt value="1000"/>
     <function psi="0.9" beta="1"/>
     <driftcorrection value="1.0"/>
    </rzwaves_regular>
    <rzwaves_spectrum>
     <spectrum value="jonswap"/><peakcoef value="3.3"/>
     <discretization value="stretched"/>
     <waveheight value="0.1"/><waveperiod value="3"/><waves value="32"/>
     <randomseed value="2"/><depth value="0.35"/><swl value="0.35"/>
     <center x="1.5" y="0" z="0"/><width value="0.4"/>
     <ramptime value="1"/><serieini value="0"/>
     <function psi="0.9" beta="1"/>
    </rzwaves_spectrum>
    <rzwaves_external_1d>
     <depth value="0.35"/><swl value="0.35"/>
     <filesvel value="ext"/>
     <usevelz value="false"/>
     <center x="2.5" y="0" z="0"/><width value="0.4"/>
    </rzwaves_external_1d>
    <rz_uniform>
     <domainbox>
      <point x="3.0" y="-0.5" z="0"/><size x="0.5" y="1" z="0.5"/>
      <direction x="-1" y="0" z="0"/>
     </domainbox>
     <velocitytimes>
      <timevalue time="0.0" v="0"/><timevalue time="2.0" v="0.5"/>
     </velocitytimes>
    </rz_uniform>
   </relaxationzones>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "rz_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    zones = case.meta["features"].relaxzones
    assert len(zones) == 4
    reg, spec, ext, uni = zones
    assert isinstance(reg, RelaxZoneRegular) and reg.order2
    assert abs(reg.phase - 0.5 * math.pi) < 1e-12 and reg.ramp == 1.0
    assert reg.driftcorrection == 1.0
    assert isinstance(spec, RelaxZoneSpectrum)
    assert len(spec.comp_k) == 32 and spec.ramptime == 1.0
    assert isinstance(ext, RelaxZoneExternal)
    assert ext.grid.nx == 2 and ext.grid.nz == 3 and not ext.usevelz
    assert isinstance(uni, RelaxZoneUniform)
    assert uni.veltimes == (0.0, 2.0) and uni.axis == 0
    assert uni.direction[0] == -1.0

def test_rz_uniform_rotateaxis(tmp_path):
    """<rz_uniform><domainbox><rotateaxis>: the oriented box (reference
    three-plane membership, KerSetFluidVelUniform JRelaxZone_ker.cu:60-73)
    gives the same weights as the unrotated zone at inverse-rotated
    positions."""
    from dualsphysics_multilayer.io.xmlcase import _read_rotateaxis
    import xml.etree.ElementTree as ET

    rot = ET.fromstring(
        '<rotateaxis angle="35" anglesunits="degrees">'
        '<point1 x="3.0" y="0" z="0"/><point2 x="3.0" y="0" z="1"/>'
        '</rotateaxis>')
    R, a1 = _read_rotateaxis(rot)
    # plain zone
    org = np.array([3.0, -0.5, 0.0])
    sz = np.array([0.5, 1.0, 0.5])
    plain = RelaxZoneUniform(pmin=tuple(org), pmax=tuple(org + sz),
                             vel=(-2.0, 0, 0), direction=(-1, 0, 0), axis=0)
    rotz = RelaxZoneUniform(
        pmin=tuple(a1 + R @ (org - a1)),
        pmax=tuple(a1 + R @ (org - a1) + R @ sz),
        vel=tuple(R @ np.array([-2.0, 0, 0])),
        direction=tuple(R @ np.array([-1.0, 0, 0])),
        axis=0, axes=tuple(tuple(R[:, i]) for i in range(3)),
        sizes=tuple(sz))
    csp = make_ctesph(simulate2d=False, dp=0.05, speedsound=10.0)
    rng = np.random.default_rng(0)
    pts = org + rng.uniform(-0.3, 0.8, size=(200, 3)) * sz
    _, f_plain = plain.target_and_weight(csp, jnp.asarray(pts, jnp.float32),
                                         0.0)
    rpts = (a1 + (R @ (pts - a1).T).T)
    tgt, f_rot = rotz.target_and_weight(csp, jnp.asarray(rpts, jnp.float32),
                                        0.0)
    np.testing.assert_allclose(np.asarray(f_rot), np.asarray(f_plain),
                               atol=2e-4)
    # the blended target velocity is the rotated direction
    np.testing.assert_allclose(np.asarray(tgt)[0], R @ np.array([-2.0, 0, 0]),
                               atol=1e-6)


def test_rz_uniform_rotateaxis_xml(tmp_path):
    """rotateaxis round-trips through the case-XML parser."""
    from dualsphysics_multilayer.io import xmlcase
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="4" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="4" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="3.9" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <relaxationzones>
    <rz_uniform>
     <domainbox>
      <point x="3.0" y="-0.5" z="0"/><size x="0.5" y="1" z="0.5"/>
      <direction x="-1" y="0" z="0"/>
      <rotateaxis angle="-45" anglesunits="degrees">
       <point1 x="3.25" y="0" z="0"/><point2 x="3.25" y="1" z="0"/>
      </rotateaxis>
     </domainbox>
     <velocity value="0.6"/>
    </rz_uniform>
   </relaxationzones>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "rzrot_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    uni = case.meta["features"].relaxzones[0]
    assert isinstance(uni, RelaxZoneUniform)
    assert uni.axes is not None and uni.sizes == (0.5, 1.0, 0.5)
    # -45 deg about +y through (3.25,*,0), negated convention -> +45 ccw
    # about y: direction (-1,0,0) -> rotated in the x-z plane
    d = np.asarray(uni.direction)
    assert abs(np.linalg.norm(d) - 1.0) < 1e-9
    assert abs(d[0] - (-math.cos(math.pi / 4))) < 1e-9
    assert abs(d[1]) < 1e-12
    # axes stay orthonormal
    A = np.asarray(uni.axes)
    np.testing.assert_allclose(A @ A.T, np.eye(3), atol=1e-12)
    assert uni.axis == 0
