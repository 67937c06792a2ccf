"""Mooring line / force point tests (reference JDsMooredFloatings +
JDsFtForcePoints, SURVEY §2.12)."""

import jax.numpy as jnp
import numpy as np

from dualsphysics_multilayer.features.floating import FloatingState
from dualsphysics_multilayer.features.featureset import Features
from dualsphysics_multilayer.features.moorings import (
    ForcePoint, ForcePointsCfg, MooringCfg, MooringLine)
from dualsphysics_multilayer.models import cases
from dualsphysics_multilayer.models.wcsph import Simulation
from dualsphysics_multilayer.ops.forces import SolverOpts
from dualsphysics_multilayer.typesdef import TpDensity


def _fts(center, vel=(0, 0, 0), omega=(0, 0, 0), ang=(0, 0, 0)):
    return FloatingState(
        center=jnp.asarray([center], jnp.float32),
        fvel=jnp.asarray([vel], jnp.float32),
        fomega=jnp.asarray([omega], jnp.float32),
        angles=jnp.asarray([ang], jnp.float32))


def test_mooring_line_tension_and_torque():
    # anchor straight below a fairlead offset from the center: taut when
    # stretched, slack otherwise; torque = r x F
    line = MooringLine(body=0, anchor=(1.0, 0, 0), fairlead=(0.5, 0, 0),
                       length0=1.0, stiffness=100.0)
    cfg = MooringCfg(lines=(line,), nbodies=1)
    # fairlead at (0.5,0,0)+center(0,0,0); anchor at 1.0 -> l=0.5 < L0: slack
    face, fom = cfg.forces(_fts((0.0, 0.0, 0.0)))
    assert np.allclose(np.asarray(face), 0.0)
    # move the body away: center (-1,0,0) -> fairlead (-0.5) -> l=1.5, strain
    # 0.5 -> T = 50 N toward the anchor (+x)
    face, fom = cfg.forces(_fts((-1.0, 0.0, 0.0)))
    assert abs(float(face[0, 0]) - 50.0) < 1e-3
    assert abs(float(face[0, 1])) < 1e-6 and abs(float(face[0, 2])) < 1e-6
    # vertical offset fairlead gives a pitch torque
    line2 = MooringLine(body=0, anchor=(2.0, 0, 1.0), fairlead=(0.0, 0, 1.0),
                        length0=1.0, stiffness=100.0)
    cfg2 = MooringCfg(lines=(line2,), nbodies=1)
    face2, fom2 = cfg2.forces(_fts((0.0, 0.0, 0.0)))
    # force +x applied at arm +z -> torque about -y... cross((0,0,1),(f,0,0))
    # = (0*0-1*0, 1*f-0*0, 0) = (0, f, 0)
    assert float(face2[0, 0]) > 0
    assert abs(float(fom2[0, 1]) - float(face2[0, 0])) < 1e-4


def test_forcepoint_interpolation():
    fp = ForcePoint(body=0, point=(0, 0, 0), times=(0.0, 1.0),
                    forces=(0, 0, 0, 10.0, 0, 0))
    cfg = ForcePointsCfg(points=(fp,), nbodies=1)
    face, _ = cfg.forces(_fts((0, 0, 0)), 0.5)
    assert abs(float(face[0, 0]) - 5.0) < 1e-5


def test_moored_buoyant_box_is_held_down():
    """A half-density box held 90% submerged by a taut vertical mooring rises
    much less than the same unmoored box."""
    kw = dict(dp=0.03, tank=(1.2, 1.0), water=0.5, box=(0.2, 0.2),
              box_pos=(0.5, 0.32), box_rho=500.0)

    def run(moor):
        case = cases.floatingbox2d(**kw)
        c0 = np.asarray(case.state.ft.center)[0]
        feats = Features(floating=case.meta["ftcfg"], moorings=moor)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
        sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
        sim.run(tmax=0.3, tout=0.3)
        return float(c0[2]), float(np.asarray(sim.state.ft.center)[0, 2])

    z0, z_free = run(None)
    # stiff short line from the tank floor to the box center
    moor = MooringCfg(lines=(MooringLine(
        body=0, anchor=(0.6, 0.0, 0.0), fairlead=(0.0, 0.0, 0.0),
        length0=0.42 + 0.005, stiffness=5e4, damping=200.0),), nbodies=1)
    _, z_moored = run(moor)
    assert z_free > z0 + 0.01           # unmoored box rises
    assert z_moored < z_free - 0.005    # mooring holds it down
    assert z_moored < 0.45              # never far above the line limit


def test_moorings_xml_parsing(tmp_path):
    """<special><moorings> + moordyn.xml parse into the dynamic MoorDynCfg
    (_FmtXML_MoorDyn.xml: solverOptions, linedefault ea / e+diameter,
    vesselconnection, fixconnection, connect nodes frozen at their initial
    position)."""
    from dualsphysics_multilayer.io import xmlcase
    (tmp_path / "moordyn.xml").write_text("""<?xml version="1.0"?>
<moordyn>
 <solverOptions><waterDepth value="0.5"/></solverOptions>
 <bodies><body ref="45"/></bodies>
 <connects><connect conref="1" x="0.2" y="0.0" z="0.1" M="1" V="0.1"/></connects>
 <lines>
  <linedefault><ea value="2.9e3"/><ba value="-0.8"/></linedefault>
  <line>
   <vesselconnection bodyref="45" x="0.25" y="0.0" z="0.45"/>
   <fixconnection x="-0.1" y="0.0" z="0.0"/>
   <length value="0.6"/><segments value="20"/>
   <ea value="3.1e3"/>
  </line>
  <line>
   <vesselconnection bodyref="45" x="0.35" y="0.0" z="0.45"/>
   <connect conref="1"/>
   <length value="0.3"/><segments value="10"/>
  </line>
 </lines>
</moordyn>""")
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
   <definition dp="0.05"><pointmin x="-0.5" y="0" z="-0.5"/><pointmax x="1" y="0" z="1"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom</boxfill>
     <point x="-0.4" y="0" z="0"/><size x="1.2" y="0" z="0.8"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="-0.35" y="0" z="0.05"/><size x="1.0" y="0" z="0.3"/></drawbox>
    <setmkbound mk="45"/><drawbox><boxfill>solid</boxfill>
     <point x="0.25" y="0" z="0.4"/><size x="0.1" y="0" z="0.1"/></drawbox>
   </mainlist></commands>
  </geometry>
  <floatings>
   <floating mkbound="45"><massbody value="0.5"/></floating>
  </floatings>
 </casedef>
 <execution>
  <special>
   <moorings>
    <mooredfloatings><floating mkbound="45"/></mooredfloatings>
    <moordyn file="moordyn.xml"/>
   </moorings>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/><parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "moor_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    mcfg = case.meta["features"].moorings
    assert mcfg is not None and len(mcfg.lines) == 2
    assert mcfg.dynamic and mcfg.nsub >= 1
    l0, l1 = mcfg.lines
    assert l0.body == 0 and l0.ea == 3.1e3 and l0.length0 == 0.6
    assert l0.anchor == (-0.1, 0.0, 0.0)
    assert l0.nseg == 20 and l1.nseg == 10
    # seabed plane = freesurface(0) - waterDepth
    assert l0.zbot == -0.5
    # fairlead is body-local (world - initial center)
    assert abs(l0.fairlead[0] - (0.25 - 0.3)) < 0.03
    # connect line frozen at the connect position
    assert l1.anchor == (0.2, 0.0, 0.1) and l1.ea == 2.9e3


# ---------------------------------------------------------------------------
# Dynamic lumped-mass model (MoorDynCfg — the MoorDyn+ re-implementation)
# ---------------------------------------------------------------------------

def test_moordyn_taut_line_tension():
    """A weightless taut line reproduces EA*strain at the fairlead."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    ln = MoorDynLine(body=0, anchor=(0, 0, 0), fairlead=(0, 0, 0),
                     length0=1.0, ea=1000.0, nseg=10, diameter=0.0,
                     massden=0.01, ba=-0.8)
    cfg = MoorDynCfg(lines=(ln,), nbodies=1, t_ic=0.5, dtm=2e-4, nsub=50)
    fts = _fts((1.1, 0.0, 0.0))
    ms = cfg.init_state(fts)
    face, fom = cfg.forces(fts, ms)
    # strain 0.1 -> T = 100 N pulling the fairlead toward the anchor (-x)
    assert abs(float(face[0, 0]) + 100.0) < 5.0
    assert abs(float(face[0, 1])) < 1e-3

    # stretching further increases the pull
    fts2 = _fts((1.15, 0.0, 0.0))
    ms2 = cfg.advance(ms, fts2, 0.01)
    assert np.isfinite(np.asarray(ms2.pos)).all()
    f2, _ = cfg.forces(fts2, ms2)
    assert float(f2[0, 0]) < float(face[0, 0])


def test_moordyn_catenary_half_weight():
    """A slack heavy chain hangs as a catenary: each support carries ~half
    the total line weight (downward force on the body)."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    ln = MoorDynLine(body=0, anchor=(0, 0, 0), fairlead=(0, 0, 0),
                     length0=2.0, ea=5e4, nseg=16, diameter=0.01,
                     massden=1.0, ba=-0.8, zbot=-10.0)
    cfg = MoorDynCfg(lines=(ln,), nbodies=1, rho_w=0.0, t_ic=2.0, dtm=1e-4)
    fts = _fts((1.0, 0.0, 0.0))
    ms = cfg.init_state(fts)
    f, _ = cfg.forces(fts, ms)
    W = 2.0 * 1.0 * 9.81
    assert -1.1 * W / 2 < float(f[0, 2]) < -0.7 * W / 2
    # horizontal pull toward the anchor
    assert float(f[0, 0]) < 0.0


def test_moordyn_seabed_rests_line():
    """With a seabed just below the anchors, a long slack line sheds most of
    its weight onto the bottom: fairlead vertical pull shrinks vs free
    hanging."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    kw = dict(body=0, anchor=(0, 0, 0), fairlead=(0, 0, 0), length0=3.0,
              ea=5e4, nseg=24, diameter=0.01, massden=1.0, ba=-0.8)
    fts = _fts((1.0, 0.0, 0.5))
    free = MoorDynCfg(lines=(MoorDynLine(zbot=-50.0, **kw),), nbodies=1,
                      rho_w=0.0, t_ic=2.0, dtm=1e-4)
    bed = MoorDynCfg(lines=(MoorDynLine(zbot=-0.02, **kw),), nbodies=1,
                     rho_w=0.0, t_ic=2.0, dtm=1e-4)
    ff, _ = free.forces(fts, free.init_state(fts))
    fb, _ = bed.forces(fts, bed.init_state(fts))
    assert float(fb[0, 2]) > float(ff[0, 2]) + 2.0   # much less pull-down


def test_moordyn_breaktension():
    """Exceeding <breaktension> severs the line (forces drop to zero)."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    ln = MoorDynLine(body=0, anchor=(0, 0, 0), fairlead=(0, 0, 0),
                     length0=1.0, ea=1000.0, nseg=8, massden=0.01,
                     breaktension=50.0)
    cfg = MoorDynCfg(lines=(ln,), nbodies=1, t_ic=0.2, dtm=2e-4, nsub=40)
    fts = _fts((1.2, 0.0, 0.0))     # strain 0.2 -> 200 N > 50 N
    ms = cfg.init_state(fts)
    ms = cfg.advance(ms, fts, 0.005)
    assert bool(np.asarray(ms.broken)[0])
    f, _ = cfg.forces(fts, ms)
    assert np.allclose(np.asarray(f), 0.0)


def test_moordyn_start_ramp():
    """<start value ramptime>: force is gated and ramped in."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    ln = MoorDynLine(body=0, anchor=(0, 0, 0), fairlead=(0, 0, 0),
                     length0=1.0, ea=1000.0, nseg=8, massden=0.01)
    cfg = MoorDynCfg(lines=(ln,), nbodies=1, t_ic=0.5, dtm=2e-4,
                     start=1.0, ramptime=1.0)
    fts = _fts((1.1, 0.0, 0.0))
    ms = cfg.init_state(fts)
    f0, _ = cfg.forces(fts, ms, tabs=jnp.asarray(0.5))
    fh, _ = cfg.forces(fts, ms, tabs=jnp.asarray(1.5))
    f1, _ = cfg.forces(fts, ms, tabs=jnp.asarray(2.5))
    assert np.allclose(np.asarray(f0), 0.0)
    assert abs(float(fh[0, 0]) - 0.5 * float(f1[0, 0])) < 2.0
    assert float(f1[0, 0]) < -90.0


def test_moordyn_moored_box_end_to_end():
    """The dynamic lumped-mass line holds a buoyant box down through the
    full jitted step loop (StepCarry.moor threading)."""
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    kw = dict(dp=0.03, tank=(1.2, 1.0), water=0.5, box=(0.2, 0.2),
              box_pos=(0.5, 0.32), box_rho=500.0)

    def run(moor):
        case = cases.floatingbox2d(**kw)
        c0 = np.asarray(case.state.ft.center)[0]
        feats = Features(floating=case.meta["ftcfg"], moorings=moor)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
        sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
        sim.run(tmax=0.3, tout=0.3)
        return float(c0[2]), float(np.asarray(sim.state.ft.center)[0, 2])

    z0, z_free = run(None)
    moor = MoorDynCfg(lines=(MoorDynLine(
        body=0, anchor=(0.6, 0.0, 0.0), fairlead=(0.0, 0.0, 0.0),
        length0=0.42 + 0.005, ea=5e4, nseg=10, diameter=0.004,
        massden=0.05, ba=-0.8),), nbodies=1, t_ic=0.2, nsub=20)
    _, z_moored = run(moor)
    assert z_free > z0 + 0.01
    assert z_moored < z_free - 0.005
    assert z_moored < 0.45


def test_moorings_output_files(tmp_path):
    """save_moorings writes the MooringsLines VTK polylines and the
    fairlead MooringsPoints.csv (reference savevtk_lines/savecsv_points)."""
    from types import SimpleNamespace
    from dualsphysics_multilayer.features.moorings import (
        MoorDynCfg, MoorDynLine)
    from dualsphysics_multilayer.io.output import OutputManager
    case = cases.floatingbox2d(dp=0.05)
    moor = MoorDynCfg(lines=(MoorDynLine(
        body=0, anchor=(0.2, 0.0, 0.0), fairlead=(0.0, 0.0, 0.0),
        length0=0.5, ea=1e3, nseg=6, massden=0.05),), nbodies=1,
        t_ic=0.05, dtm=2e-4)
    feats = Features(floating=case.meta["ftcfg"], moorings=moor)
    om = OutputManager(str(tmp_path), case, feats=feats)
    ms = moor.init_state(case.state.ft)
    sim = SimpleNamespace(part=3, time=0.5, state=case.state,
                          carry=SimpleNamespace(moor=ms))
    om.save_moorings(sim)
    vtk = tmp_path / "MooringsVtk" / "MooringsLines_0003.vtk"
    assert vtk.exists() and vtk.stat().st_size > 0
    csv = (tmp_path / "MooringsPoints.csv").read_text().splitlines()
    assert csv[0].startswith("time;line;broken")
    row = csv[1].split(";")
    assert float(row[0]) == 0.5 and row[1] == "0" and row[2] == "0"
    assert float(row[-1]) >= 0.0
