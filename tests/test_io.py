"""I/O tests: JBinaryData roundtrip, PART write/read, VTK, restart continuity,
gauges."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.io import jbinary as jb
from dualsphysics_multilayer.io import partdata, vtkout
from dualsphysics_multilayer.io.output import OutputManager, restart_state
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.features.gauges import (
    GaugeMaxZ, GaugeSwl, GaugeSystem, GaugeVel,
)
from dualsphysics_multilayer.typesdef import TpDensity


def test_jbinary_roundtrip(tmp_path):
    root = jb.JItem(name="TestRoot")
    root.set_uint("U", 42).set_text("T", "hello world")
    root.set_double("D", 3.25).set_bool("B", True)
    root.set_double3("D3", (1.0, 2.0, 3.0)).set_ullong("LL", 1 << 40)
    root.add_array("Floats", jb.FLOAT, np.arange(10, dtype=np.float32))
    root.add_array("Vecs", jb.FLOAT3,
                   np.arange(12, dtype=np.float32).reshape(4, 3))
    child = root.child("Sub")
    child.set_int("I", -7)
    child.add_array("Ids", jb.UINT, np.arange(5, dtype=np.uint32))
    p = tmp_path / "t.bi4"
    jb.write_file(p, root)
    # header must carry the #FileJBD magic at fixed offsets
    raw = open(p, "rb").read()
    assert raw[:9] == b"#FileJBD " and raw[58:59] == b"\n" and raw[60] == 0
    back = jb.read_file(p)
    assert back.name == "TestRoot"
    assert back.get("U") == 42 and back.get("T") == "hello world"
    assert back.get("B") is True and back.get("LL") == 1 << 40
    np.testing.assert_allclose(back.get("D3"), (1.0, 2.0, 3.0))
    np.testing.assert_array_equal(back.array("Floats").data,
                                  np.arange(10, dtype=np.float32))
    np.testing.assert_array_equal(back.array("Vecs").data.reshape(-1),
                                  np.arange(12, dtype=np.float32))
    sub = back.find("Sub")
    assert sub.get("I") == -7
    np.testing.assert_array_equal(sub.array("Ids").data, np.arange(5))


def test_part_write_read_roundtrip(tmp_path):
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(0.5, 0.5))
    w = partdata.PartWriter(str(tmp_path), case.csp, np_total=case.np_total)
    path = w.save(3, 0.125, case.state, nstep=77)
    d = partdata.read_part(path)
    assert d["cpart"] == 3 and d["nstep"] == 77
    assert abs(d["timestep"] - 0.125) < 1e-12
    assert d["npok"] == case.np_total
    np.testing.assert_allclose(d["pos"], np.asarray(case.state.pos),
                               atol=1e-12)
    np.testing.assert_array_equal(d["idp"], np.arange(case.np_total))
    assert abs(d["ctes"]["H"] - case.csp.kernelh) < 1e-12


def test_vtk_writer(tmp_path):
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(0.5, 0.5))
    p = vtkout.write_state_vtk(str(tmp_path / "p.vtk"), case.state)
    raw = open(p, "rb").read()
    assert raw.startswith(b"# vtk DataFile")
    assert b"POINTS %d float" % case.np_total in raw
    assert b"SCALARS Rhop" in raw and b"VECTORS Vel" in raw


def test_restart_continuity(tmp_path):
    """Run A->B, checkpoint at A, restart from the PART, run to B again:
    trajectories must match (bitwise state restore modulo f32 io)."""
    case = cases.dambreak2d(dp=0.05, tank=(1.6, 1.0), column=(0.4, 0.6))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    out = OutputManager(str(tmp_path), case)
    sim.run(tmax=0.04, tout=0.02, on_save=out)

    # continue original to 0.06
    sim.run(tmax=0.06, tout=0.02)
    ref_pos = np.asarray(sim.state.pos)

    # restart from the t=0.04 PART
    st2, tstep, nstep = restart_state(str(tmp_path / "Part_0002.bi4"),
                                      case.state)
    assert abs(tstep - 0.04) < 1e-9
    sim2 = Simulation(case.csp, opts, case.dom, st2)
    sim2.time = tstep
    sim2.run(tmax=0.06, tout=0.02)
    pos2 = np.asarray(sim2.state.pos)

    live = np.array(td.is_active(sim.state.code))
    err = np.abs(ref_pos[live] - pos2[live]).max()
    # restart loses only the carry dt (re-derived) -> small divergence allowed
    assert err < 0.25 * case.csp.dp, err


def test_gauges(tmp_path):
    case = cases.dambreak2d(dp=0.04, tank=(1.0, 1.0), column=(1.0, 0.6))
    gs = GaugeSystem(case.csp, case.dom, gauges=(
        GaugeSwl("swl", (0.5, 0, 0), (0.5, 0, 1.0), 0.02),
        GaugeMaxZ("maxz", (0.5, 0, 0), 1.0, 0.1),
        GaugeVel("vel", (0.5, 0, 0.3)),
    ))
    out = gs.run(0.0, case.state)
    # still water at 0.6: SWL and MaxZ find the surface
    assert abs(out["swl"][2] - 0.6) < 3 * case.csp.dp, out["swl"]
    assert abs(out["maxz"] - 0.6) < 2 * case.csp.dp
    assert np.linalg.norm(out["vel"]) < 1e-6
    gs.save_csv(str(tmp_path))
    assert os.path.exists(tmp_path / "Gauge_swl.csv")


def test_native_codec_byte_identical(tmp_path):
    """The C++ serializer must produce byte-identical files to the Python
    reference implementation."""
    from dualsphysics_multilayer import native
    if native.load() is None:
        pytest.skip("no g++ available")
    root = jb.JItem(name="NTest")
    root.set_uint("U", 7).set_text("T", "abc").set_double("D", 1.5)
    root.set_bool("B", True).set_double3("D3", (0.5, -1.0, 2.0))
    root.set_ullong("LL", 123456789012345)
    root.add_array("A", jb.FLOAT, np.linspace(0, 1, 7, dtype=np.float32))
    sub = root.child("PART_0001")
    sub.set_uint("Cpart", 1)
    sub.add_array("Pos", jb.DOUBLE3,
                  np.arange(9, dtype=np.float64).reshape(3, 3))
    p1, p2 = tmp_path / "n.bi4", tmp_path / "p.bi4"
    jb.write_file(p1, root, native=True)
    jb.write_file(p2, root, native=False)
    b1, b2 = open(p1, "rb").read(), open(p2, "rb").read()
    assert b1 == b2, (len(b1), len(b2))
    back = jb.read_file(p1)
    assert back.get("LL") == 123456789012345
    assert back.find("PART_0001").array("Pos").data.shape == (3, 3)


def test_pips_and_timers():
    from dualsphysics_multilayer.utils import pips as P
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(0.5, 0.5))
    rep = P.pips_report(case.csp, case.dom, case.state, step_seconds=0.01)
    # rest lattice 2D: ~30-40 real neighbours per particle
    per_particle = rep["real_pairs"] / case.np_total
    assert 10 < per_particle < 60, per_particle
    assert rep["check_ratio"] > 1.0
    assert rep["pips"] == rep["real_pairs"] * 2 / 0.01

    from dualsphysics_multilayer.utils.log import save_run_csv
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        p = save_run_csv(d, dict(run="t", steps=10, psps=1e6))
        assert open(p).read().count("\n") == 2


def test_savedt_diagnostics_csv(tmp_path):
    """SaveDt channel records one row per step (reference JDsSaveDt)."""
    from dualsphysics_multilayer.io.output import OutputManager
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops.forces import SolverOpts
    from dualsphysics_multilayer.typesdef import TpDensity

    case = cases.dambreak2d(dp=0.08)
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, savedt=4096)
    om = OutputManager(str(tmp_path), case)
    sim = Simulation(case.csp, opts, case.dom, case.state)
    sim.run(tmax=0.04, tout=0.02, on_save=om)
    lines = (tmp_path / "SaveDt.csv").read_text().strip().splitlines()
    assert lines[0].startswith("Step;Time;Dt;Dt1;Dt2")
    assert len(lines) - 1 == int(sim.carry.nstep)
    dts = [float(l.split(";")[2]) for l in lines[1:]]
    assert all(dt > 0 for dt in dts)


def test_extradata_roundtrip(tmp_path):
    """PartExtra .bi4 (JDsExtraData): normals survive save -> restart."""
    import dataclasses
    from dualsphysics_multilayer.io import extradata
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(0.4, 0.5))
    st = case.state
    code = np.asarray(st.code)
    nbound = int((td.code_type(code) < td.TYPE_FLOATING).sum())
    rng = np.random.default_rng(3)
    nor = np.zeros((st.n, 3), np.float32)
    isb = np.asarray(td.code_type(code) < td.TYPE_FLOATING)
    nor[isb] = rng.normal(size=(isb.sum(), 3)).astype(np.float32)
    st = dataclasses.replace(st, boundnormal=jnp.asarray(nor))

    extradata.save_extradata(str(tmp_path), 3, 0.5, st, casenbound=nbound)
    extra = extradata.load_extradata(str(tmp_path), 3)
    assert extra is not None and len(extra["normals"]) == nbound
    back = extradata.apply_normals(extra, st.idp, st.code, st.n)
    np.testing.assert_allclose(back[isb], nor[isb], atol=0)
    assert extradata.load_extradata(str(tmp_path), 7) is None

    # the OutputManager writes the channel automatically for normal-carrying
    # states, and restart_state picks it up next to the PART file
    case2 = dataclasses.replace(case, state=st)
    sim = Simulation(case.csp, SolverOpts(tdensity=TpDensity.FOURTAKAS),
                     case.dom, st)
    out = OutputManager(str(tmp_path), case2)
    out(sim)
    assert (tmp_path / "PartExtra_0000.bi4").exists()
    st2, _, _ = restart_state(str(tmp_path / "Part_0000.bi4"), case.state)
    assert st2.boundnormal is not None
    np.testing.assert_allclose(np.asarray(st2.boundnormal)[isb], nor[isb],
                               atol=1e-7)


def test_numex_expressions():
    """JNumexLib replacement: arithmetic, vars, functions, ^ power, and the
    safety wall against non-arithmetic constructs."""
    from dualsphysics_multilayer.utils import numex as NX
    v = NX.NumexVars({"H": 0.05, "Rhop0": 1000.0})
    assert abs(v.compute("2*H+0.1") - 0.2) < 1e-12
    assert abs(v.compute("Rhop0*H^2") - 2.5) < 1e-9
    assert abs(v.compute("sqrt(4)+min(1,2)") - 3.0) < 1e-12
    assert abs(v.compute("sin(pi/2)") - 1.0) < 1e-12
    assert v.value("#H*2") == 0.1
    assert v.value("0.25") == "0.25"
    for bad in ("__import__('os')", "H.__class__", "open('x')",
                "[1,2]", "lambda: 1"):
        with pytest.raises(ValueError):
            v.compute(bad)


def test_xmlcase_uservars(tmp_path):
    """'#' expressions in <parameters> evaluate over <uservars>."""
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="1" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="1" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0.05"/><size x="0.4" y="0" z="0.3"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <uservars>
   <varnum name="tfactor" value="2.0"/>
  </uservars>
  <parameters>
   <parameter key="TimeMax" value="#0.1*tfactor"/>
   <parameter key="TimeOut" value="#H"/>
   <parameter key="Visco" value="#0.005*tfactor"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "case_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    assert abs(run["tmax"] - 0.2) < 1e-9
    assert abs(run["tout"] - case.csp.kernelh) < 1e-9
    assert abs(case.csp.visco - 0.01) < 1e-9


def test_draw_sphere_cylinder():
    """GenCase drawsphere/drawcylinder lattice fills + radial mDBC normals."""
    from dualsphysics_multilayer.models.cases import Draw
    dp = 0.05
    d = Draw(dp=dp, simulate2d=False)
    d.sphere((0.5, 0.5, 0.5), 0.2, ptype=td.TYPE_FIXED, mk=1)
    pos, code = d.build()
    r = np.linalg.norm(pos - 0.5, axis=1)
    assert len(pos) > 100 and r.max() <= 0.2 + 1e-9
    # solid ball: count close to (4/3)pi R^3 / dp^3
    expect = 4 / 3 * np.pi * 0.2**3 / dp**3
    assert abs(len(pos) - expect) / expect < 0.15
    # shell mode
    d2 = Draw(dp=dp, simulate2d=False)
    d2.sphere((0.5, 0.5, 0.5), 0.2, ptype=td.TYPE_FIXED, mk=1, solid=False)
    pos2, _ = d2.build()
    r2 = np.linalg.norm(pos2 - 0.5, axis=1)
    assert (r2 >= 0.2 - dp - 1e-9).all() and len(pos2) < len(pos)
    # normals point inward with |n| = dp
    assert np.allclose(np.linalg.norm(d2.points[next(iter(d2.points))][2]),
                       dp, atol=1e-12)
    # cylinder along z
    d3 = Draw(dp=dp, simulate2d=False)
    d3.cylinder((0.5, 0.5, 0.2), (0.5, 0.5, 0.8), 0.15,
                ptype=td.TYPE_FLUID, mk=0)
    pos3, _ = d3.build()
    rad = np.linalg.norm(pos3[:, :2] - 0.5, axis=1)
    assert rad.max() <= 0.15 + 1e-9
    assert pos3[:, 2].min() >= 0.2 - 1e-9 and pos3[:, 2].max() <= 0.8 + 1e-9
    expect3 = np.pi * 0.15**2 * 0.6 / dp**3
    assert abs(len(pos3) - expect3) / expect3 < 0.15


def test_gauge_force_hydrostatic():
    """GaugeForce: total pressure force on the bottom wall of a settled
    column ~ the column weight (KerInteractionGaugeForce pressure sum)."""
    from dualsphysics_multilayer.features.gauges import GaugeForce
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops.forces import SolverOpts
    from dualsphysics_multilayer.typesdef import TpDensity
    case = cases.dambreak2d(dp=0.03, tank=(0.6, 0.8), column=(0.6, 0.4))
    sim = Simulation(case.csp, SolverOpts(tdensity=TpDensity.FOURTAKAS),
                     case.dom, case.state)
    sim.run(tmax=0.25, tout=0.25)       # settle to near-hydrostatic
    gs = GaugeSystem(case.csp, case.dom,
                     gauges=(GaugeForce("fbottom", mkbound=0),))
    out = gs.run(0.25, sim.state)
    fz = out["fbottom"][2]
    # weight of the 0.6 x 0.4 column per unit width (2-D: dp^2 volumes)
    weight = 1000.0 * 9.81 * 0.6 * 0.4
    # the wall mk also includes the side walls; z-force is dominated by the
    # bottom reaction ~ +weight (fluid pushes down, wall feels -z... the
    # gauge reports the force ON the wall FROM the fluid: -z)
    assert 0.4 * weight < abs(fz) < 2.0 * weight, (fz, weight)


def test_gauges_xml_parsing(tmp_path):
    """<special><gauges> parses velocity/swl/maxz/force with compute
    windows and coef forms (_FmtXML_Gauges.xml)."""
    from dualsphysics_multilayer.io import xmlcase
    from dualsphysics_multilayer.features.gauges import (
        GaugeForce, GaugeMaxZ, GaugeSwl, GaugeVel)
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="4" y="0" z="2"/></definition>
   <commands><mainlist>
    <setmkbound mk="1"/><drawbox><boxfill>bottom</boxfill>
     <point x="0" y="0" z="0"/><size x="4" y="0" z="1.5"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0.05" y="0" z="0.05"/><size x="3.9" y="0" z="0.5"/></drawbox>
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution>
  <special>
   <gauges>
    <velocity name="Vel-0">
     <computetime start="0.05" end="0.11"/>
     <point x="1.0" y="0" z="0.1"/>
    </velocity>
    <swl name="Swl_x09">
     <masslimit coef="0.45"/>
     <pointdp coefdp="0.5"/>
     <point0 x="0.9" y="0" z="0"/><point2 x="0.9" y="0" z="2.1"/>
    </swl>
    <maxz name="MaxZ">
     <point0 x="0.9" y="0" z="0"/><height value="2.1"/>
     <distlimit coefh="0.1"/>
    </maxz>
    <force name="Force1"><target mkbound="1"/></force>
   </gauges>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "gauges_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    gl = case.meta["gauges"]
    assert len(gl) == 4
    v, s, m, f = gl
    assert isinstance(v, GaugeVel) and v.name == "Vel-0"
    assert case.meta["gauge_windows"]["Vel-0"] == (0.05, 0.11)
    assert isinstance(s, GaugeSwl)
    assert abs(s.pointdp - 0.5 * 0.05) < 1e-9
    assert abs(s.masslimit - 0.45 * 1000.0) < 1e-6
    assert isinstance(m, GaugeMaxZ)
    assert abs(m.distlimit - 0.1 * case.csp.kernelh) < 1e-9
    assert isinstance(f, GaugeForce) and f.mkbound == 1


def test_gauge_computedt_cadence(tmp_path):
    """A gauge with <computedt> smaller than tout ticks IN-INTERVAL: the run
    driver breaks the device loop at the pending gauge times and the gauge
    history gains more rows than there are PART saves (reference per-gauge
    cadence, JDsGaugeItem.h:70-73, JDsGaugeSystem.cpp:447)."""
    case = cases.dambreak2d(dp=0.05, tank=(1.0, 1.0), column=(0.5, 0.6))
    opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
    gs = GaugeSystem(case.csp, case.dom, gauges=(
        GaugeMaxZ("mz", (0.5, 0, 0), 1.0, 0.1),
        GaugeVel("v0", (0.5, 0, 0.3)),          # no computedt: save cadence
    ), computedts={"mz": 0.005})
    sim = Simulation(case.csp, opts, case.dom, case.state)
    saves = []

    def on_save(s):
        saves.append(s.time)
        gs.run(s.time, s.state, at_save=True)

    sim.run(tmax=0.04, tout=0.02, on_save=on_save,
            next_subtick=gs.next_time,
            on_subtick=lambda s, t: gs.run(t, s.state, at_save=False))
    nmz = len(gs.history["mz"])
    nv0 = len(gs.history["v0"])
    assert nv0 == len(saves)            # save-cadence gauge: one row per PART
    # computedt gauge: ~0.04/0.005 = 8 ticks (plus t=0), far more than saves
    assert nmz >= 6, (nmz, nv0, saves)
    tsmz = [t for t, _ in gs.history["mz"]]
    assert all(b > a for a, b in zip(tsmz, tsmz[1:]))
