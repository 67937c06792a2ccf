"""Wave-theory completeness: flap transfer, JONSWAP spectrum, irregular /
focused / solitary paddles (the closed libjwavegen surface,
`_FmtXML_WavePaddles*.xml`)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from dualsphysics_multilayer.features import motion as MOT
from dualsphysics_multilayer.features import wavegen as WG


def _eval_x(mdef, ts):
    """Integrate motion_step displacements over a time grid."""
    x = [0.0]
    for a, b in zip(ts[:-1], ts[1:]):
        disp, vel, rot, cen, has_rot, axis, wvel = MOT.motion_step(
            mdef, jnp.asarray(a, jnp.float32), jnp.asarray(b - a, jnp.float32))
        x.append(x[-1] + float(disp[0]))
    return np.asarray(x)


def test_biesel_flap_limits():
    # deep water: flap H/S -> ~ piston's * (more efficient at high kd)
    s_p, k = WG.biesel_piston(0.1, 2.0, 5.0)
    s_f, k2 = WG.biesel_flap(0.1, 2.0, 5.0)
    assert k == k2
    assert s_f > s_p > 0       # flap needs a larger SWL stroke than piston


def test_jonswap_normalization():
    f = np.linspace(0.05, 2.0, 4000)
    s = WG.jonswap(f, hs=0.5, tp=2.0)
    m0 = np.trapezoid(s, f)
    assert abs(4.0 * math.sqrt(m0) - 0.5) < 0.01
    # peak at fp
    assert abs(f[np.argmax(s)] - 0.5) < 0.05


def test_spectrum_components_energy():
    fc, amps, ph = WG.spectrum_components(hs=0.5, tp=2.0, nwaves=100,
                                          discretization="regular")
    hs_rec = 4.0 * math.sqrt(0.5 * np.sum(amps ** 2))
    assert abs(hs_rec - 0.5) < 0.02
    # deterministic under the same seed
    fc2, amps2, ph2 = WG.spectrum_components(hs=0.5, tp=2.0, nwaves=100,
                                             discretization="regular")
    assert np.allclose(ph, ph2)


@pytest.mark.parametrize("disc", ["regular", "random", "stretched",
                                  "cosstretched"])
def test_spectrum_discretizations(disc):
    fc, amps, ph = WG.spectrum_components(hs=0.3, tp=1.5, nwaves=40,
                                          discretization=disc)
    assert len(fc) == 40 and np.all(np.diff(fc) > 0) and np.all(amps >= 0)


def test_piston_spectrum_motion():
    mdef = WG.piston_spectrum(10, hs=0.1, tp=1.6, depth=0.5, nwaves=16,
                              ramptime=1.0)
    ts = np.linspace(0, 8, 400)
    x = _eval_x(mdef, ts)
    assert np.abs(x).max() > 1e-4          # it moves
    assert np.abs(x[:25]).max() < np.abs(x).max()   # ramp suppresses start
    # zero-mean oscillation (no systematic drift beyond a stroke)
    assert abs(x[-1]) < np.abs(x).max()


def test_focused_phases_align():
    xf, depth, tp = 6.0, 0.5, 1.6
    mdef = WG.piston_focused(10, hs=0.1, tp=tp, depth=depth, xf=xf,
                             nwaves=32, fpretime=2.0)
    seg = mdef.segments[0]
    w = np.asarray(seg.times)
    ap = np.asarray(seg.values).reshape(-1, 2)
    # at focus (x=xf, t=tf): k*xf - w*tf + phi must be equal mod 2pi for all
    kp = WG.dispersion_k(tp, depth)
    cg = 0.5 * (2 * math.pi / tp / kp) * (1 + 2 * kp * depth
                                          / math.sinh(2 * kp * depth))
    tf = 2.0 + xf / cg
    ks = np.array([WG.dispersion_k(2 * math.pi / wi, depth) for wi in w])
    total = ks * xf - w * tf + ap[:, 1]
    total = np.mod(total - total[0] + math.pi, 2 * math.pi) - math.pi
    assert np.abs(total).max() < 1e-3


def test_solitary_series_goring():
    H, d = 0.05, 0.14
    ts, X, vel = WG.solitary_paddle_series(H, d, theory=2)
    # net stroke ~ H * duration-equivalent: known closed form S = sqrt(16Hd/3)
    s_theory = math.sqrt(16.0 * H * d / 3.0)
    assert abs(X[-1] - s_theory) / s_theory < 0.15
    assert vel[0] == 0.0 and vel[-1] == 0.0
    assert vel.max() > 0 and X[-1] > 0
    assert np.all(np.diff(X) >= -1e-12)    # monotone push


def test_piston_solitary_motiondef():
    mdef = WG.piston_solitary(10, height=0.05, depth=0.14, nwaves=2,
                              startcoefs=(1.0, 0.8), heights=(0.05, 0.07))
    assert len(mdef.segments) == 2
    ts = np.linspace(0, float(mdef.segments[-1].t1), 500)
    x = _eval_x(mdef, ts)
    # two pushes, both forward
    assert x[-1] > WG.solitary_paddle_series(0.05, 0.14)[1][-1] * 1.5


def test_flap_spectrum_motion():
    mdef = WG.flap_spectrum(11, hs=0.1, tp=1.6, depth=0.5,
                            axis_p0=(0, 0, 0), axis_p1=(0, 1, 0), nwaves=8)
    disp, vel, rot, cen, has_rot, axis, wvel = MOT.motion_step(
        mdef, jnp.asarray(0.37, jnp.float32), jnp.asarray(0.01, jnp.float32))
    assert has_rot
    assert abs(float(rot[0, 0]) - 1.0) < 0.5   # a finite rotation happened
    assert np.isfinite(float(wvel))


def test_xml_wavepaddle_parsing(tmp_path):
    """Full <wavepaddles> surface through the case loader."""
    xml = """<?xml version="1.0"?>
<case><casedef>
 <constantsdef>
  <gravity x="0" y="0" z="-9.81"/><rhop0 value="1000"/>
  <hswl value="0.4" auto="false"/><gamma value="7"/>
  <speedsystem value="2" auto="false"/><coefsound value="20"/>
  <coefh value="1.2"/><cflnumber value="0.2"/>
 </constantsdef>
 <geometry>
  <definition dp="0.05">
   <pointmin x="-1" y="0" z="-1"/><pointmax x="6" y="0" z="2"/>
  </definition>
  <commands><mainlist>
   <setmkbound mk="10"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="0" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="11"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="3" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkbound mk="12"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="4" y="0" z="0"/><size x="0.05" y="0" z="0.4"/></drawbox>
   <setmkfluid mk="0"/>
   <drawbox><boxfill>solid</boxfill>
    <point x="0.1" y="0" z="0"/><size x="2.8" y="0" z="0.3"/></drawbox>
  </mainlist></commands>
 </geometry>
</casedef>
<execution>
 <special>
  <wavepaddles>
   <piston_spectrum>
    <mkbound value="10"/><depth value="0.3"/>
    <spectrum value="jonswap"/><discretization value="stretched"/>
    <waveheight value="0.08"/><waveperiod value="1.4"/>
    <waves value="12"/><randomseed value="2"/>
   </piston_spectrum>
   <piston_solitary>
    <mkbound value="11"/><depth value="0.3"/>
    <waveheight value="0.05"/><theory value="2"/>
   </piston_solitary>
   <flap>
    <mkbound value="12"/><depth value="0.3"/>
    <flapaxis0 x="4.025" y="0" z="0"/><flapaxis1 x="4.025" y="1" z="0"/>
    <waveheight value="0.06"/><waveperiod value="1.2"/>
   </flap>
  </wavepaddles>
 </special>
 <parameters>
  <parameter key="TimeMax" value="0.1"/>
  <parameter key="TimeOut" value="0.05"/>
 </parameters>
</execution></case>"""
    p = tmp_path / "case_Def.xml"
    p.write_text(xml)
    from dualsphysics_multilayer.io.xmlcase import load_case
    case, opts, run = load_case(str(p))
    feats = case.meta["features"]
    kinds = sorted(seg.kind for m in feats.motions for seg in m.segments)
    assert MOT.SPECTRUM in kinds          # piston_spectrum
    assert MOT.TABLE in kinds             # solitary
    assert MOT.SIN_ROT in kinds           # flap
