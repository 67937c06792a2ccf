"""Native Chrono-coupling replacement tests (features/chrono.py): joint
constraints hold under integration and springs reach the right equilibria."""

import numpy as np
import jax.numpy as jnp
import pytest

from dualsphysics_multilayer.features import chrono as CH


def _integrate(cfg, mass, I0, center0, steps=2000, dt=1e-3, g=-9.81,
               fvel0=None):
    """Minimal semi-implicit rigid integrator around solve_constrained
    (mirrors features.floating's update order)."""
    B = len(mass)
    mass = jnp.asarray(mass, jnp.float32)
    inert = jnp.asarray(I0, jnp.float32).reshape(B, 3, 3)
    center = jnp.asarray(center0, jnp.float32)
    fvel = (jnp.zeros((B, 3), jnp.float32) if fvel0 is None
            else jnp.asarray(fvel0, jnp.float32))
    fomega = jnp.zeros((B, 3), jnp.float32)
    angles = jnp.zeros((B, 3), jnp.float32)
    grav = jnp.asarray([0.0, 0.0, g], jnp.float32)
    traj = []
    from dualsphysics_multilayer.features.floating import _euler_rot
    for _ in range(steps):
        R = _euler_rot(angles)
        sf, stq = CH.spring_forces(cfg, R, center, fvel, fomega)
        tqt = CH.hinge_torsion(cfg, R, fomega, angles)
        face, oace = CH.solve_constrained(
            cfg, mass, inert, R, center, fvel, fomega,
            sf + mass[:, None] * grav, stq + tqt, jnp.float32(dt))
        center = center + dt * fvel
        fvel = fvel + dt * face
        fomega = fomega + dt * oace
        angles = angles + dt * fomega
        traj.append(np.asarray(center[0]))
    return np.asarray(traj), (center, fvel, fomega, angles)


def test_spheric_pendulum_holds_anchor():
    """Body hinged (ball joint) at a ground point 0.5 above its center:
    swings, conserves the anchor distance to < 1% over 2 s."""
    anchor = (0.0, 0.0, 1.0)
    c0 = [[0.4, 0.0, 0.7]]          # offset -> pendulum swings
    L = np.linalg.norm(np.asarray(c0[0]) - np.asarray(anchor))
    cfg = CH.make_chrono(
        [CH.ChLink("spheric", 0, -1, rotpoint=anchor)], c0)
    traj, _ = _integrate(cfg, [2.0], [np.eye(3) * 0.05], c0, steps=2000)
    d = np.linalg.norm(traj - np.asarray(anchor), axis=1)
    assert abs(d - L).max() < 0.01 * L, abs(d - L).max()
    # it actually swings: x crosses below the anchor
    assert traj[:, 0].min() < 0.05
    # and the pendulum period is right: T = 2*pi*sqrt(l_eff/g), with
    # l_eff = (I_c + m L^2)/(m L) for a physical pendulum
    leff = (0.05 + 2.0 * L**2) / (2.0 * L)
    T = 2 * np.pi * np.sqrt(leff / 9.81)
    x = traj[:, 0] - anchor[0]
    crossings = np.where(np.diff(np.signbit(x)))[0]
    assert len(crossings) >= 2
    half = np.diff(crossings).mean() * 1e-3
    assert abs(2 * half - T) / T < 0.08, (2 * half, T)


def test_hinge_restricts_axis():
    """Hinge about y: body may rotate only about y; the anchor stays put
    even under an off-axis initial kick."""
    anchor = (0.0, 0.0, 1.0)
    c0 = [[0.3, 0.0, 0.8]]
    cfg = CH.make_chrono(
        [CH.ChLink("hinge", 0, -1, rotpoint=anchor,
                   rotvector=(0.0, 1.0, 0.0))], c0)
    traj, (c, v, w, ang) = _integrate(
        cfg, [1.0], [np.eye(3) * 0.02], c0, steps=1500,
        fvel0=[[0.0, 0.3, 0.0]])   # kick along y (disallowed by the hinge)
    # anchor distance conserved
    L = np.linalg.norm(np.asarray(c0[0]) - np.asarray(anchor))
    d = np.linalg.norm(traj - np.asarray(anchor), axis=1)
    assert abs(d - L).max() < 0.015 * L
    # y never drifts (the hinge kills the kick): plane motion only
    assert np.abs(traj[:, 1]).max() < 0.01
    # rotation about x/z suppressed
    assert np.abs(np.asarray(ang)[0, [0, 2]]).max() < 0.02


def test_spring_equilibrium_extension():
    """Mass hanging from a ground spring: settles at L0 + m*g/k."""
    k, m, L0 = 200.0, 1.5, 0.4
    top = (0.0, 0.0, 2.0)
    c0 = [[0.0, 0.0, 2.0 - L0]]
    cfg = CH.make_chrono(
        [CH.ChLink("spring", 0, -1, pt1=tuple(c0[0]), pt2=top,
                   stiffness=k, damping=12.0, restlength=L0)], c0)
    traj, _ = _integrate(cfg, [m], [np.eye(3) * 0.01], c0, steps=6000)
    zeq = top[2] - (L0 + m * 9.81 / k)
    assert abs(traj[-1, 2] - zeq) < 2e-3, (traj[-1, 2], zeq)


def test_pointline_slides_only_along_axis():
    """Point-line joint: the body slides along z through the anchor but
    cannot leave the line."""
    c0 = [[0.0, 0.0, 1.0]]
    cfg = CH.make_chrono(
        [CH.ChLink("pointline", 0, -1, rotpoint=(0.0, 0.0, 1.0),
                   slidevector=(0.0, 0.0, 1.0))], c0)
    traj, _ = _integrate(cfg, [1.0], [np.eye(3) * 0.01], c0, steps=500,
                         fvel0=[[0.5, 0.0, 0.0]])  # sideways kick
    # x/y stay on the line, z falls freely
    assert np.abs(traj[:, :2]).max() < 5e-3
    t = 500 * 1e-3
    assert traj[-1, 2] < 1.0 - 0.4 * 9.81 * (t - 1e-3) ** 2 / 2 * 0.9


def test_two_body_hinge_chain():
    """Two bodies joined by a spheric link: the joint gap stays closed."""
    c0 = [[0.0, 0.0, 1.0], [0.0, 0.0, 0.6]]
    mid = (0.0, 0.0, 0.8)
    cfg = CH.make_chrono(
        [CH.ChLink("spheric", 0, -1, rotpoint=(0.0, 0.0, 1.2)),
         CH.ChLink("spheric", 0, 1, rotpoint=mid)], c0)
    B = 2
    mass = [1.0, 1.0]
    I0 = [np.eye(3) * 0.02, np.eye(3) * 0.02]
    import jax.numpy as jnp
    from dualsphysics_multilayer.features.floating import _euler_rot
    massj = jnp.asarray(mass, jnp.float32)
    inert = jnp.asarray(np.asarray(I0), jnp.float32)
    center = jnp.asarray(c0, jnp.float32)
    center = center.at[1, 0].add(0.05)       # perturb -> dynamics
    fvel = jnp.zeros((B, 3), jnp.float32)
    fomega = jnp.zeros((B, 3), jnp.float32)
    angles = jnp.zeros((B, 3), jnp.float32)
    grav = jnp.asarray([0, 0, -9.81], jnp.float32)
    dt = 1e-3
    gaps = []
    for _ in range(1500):
        R = _euler_rot(angles)
        face, oace = CH.solve_constrained(
            cfg, massj, inert, R, center, fvel, fomega,
            massj[:, None] * grav, jnp.zeros((B, 3), jnp.float32),
            jnp.float32(dt))
        center = center + dt * fvel
        fvel = fvel + dt * face
        fomega = fomega + dt * oace
        angles = angles + dt * fomega
        R = _euler_rot(angles)
        p0 = center[0] + R[0] @ jnp.asarray(cfg.local1[1], jnp.float32)
        p1 = center[1] + R[1] @ jnp.asarray(cfg.local2[1], jnp.float32)
        gaps.append(float(jnp.linalg.norm(p0 - p1)))
    # the 5 cm initial violation closes (Baumgarte) and stays closed
    assert max(gaps[-750:]) < 5e-3, max(gaps[-750:])
    assert gaps[-1] < 1e-3, gaps[-1]


def test_chrono_coupled_with_fluid():
    """Full coupling: a buoyant box tethered by a stiff ground spring barely
    rises, while the free box floats up (the SPH->constraint->SPH loop the
    reference routes through libdsphchrono)."""
    from dualsphysics_multilayer.models import cases
    from dualsphysics_multilayer.models.wcsph import Simulation
    from dualsphysics_multilayer.ops.forces import SolverOpts
    from dualsphysics_multilayer.features.featureset import Features
    from dualsphysics_multilayer.typesdef import TpDensity

    rises = {}
    for name, k in dict(free=0.0, tethered=5000.0).items():
        case = cases.floatingbox2d(dp=0.025, tank=(1.2, 1.0), water=0.5,
                                   box=(0.2, 0.2), box_pos=(0.5, 0.32),
                                   box_rho=500.0)
        ftcfg = case.meta["ftcfg"]
        ch = None
        if k:
            c0 = np.asarray(case.state.ft.center)
            ch = CH.make_chrono(
                [CH.ChLink("spring", 0, -1, pt1=tuple(c0[0]),
                           pt2=(c0[0, 0], 0.0, 0.0), stiffness=k,
                           damping=50.0,
                           restlength=float(c0[0, 2]))], c0)
        feats = Features(floating=ftcfg, chrono=ch)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS, with_floating=True)
        sim = Simulation(case.csp, opts, case.dom, case.state, feats=feats)
        c0z = float(np.asarray(case.state.ft.center)[0, 2])
        sim.run(tmax=0.25, tout=0.25)
        rises[name] = float(np.asarray(sim.state.ft.center)[0, 2]) - c0z
        assert np.isfinite(np.asarray(sim.state.pos)).all()
    assert rises["free"] > 0.005
    assert rises["tethered"] < 0.6 * rises["free"], rises


def test_chrono_xml_parsing(tmp_path):
    """<special><chrono> block parses into ChronoCfg with mkbound mapping."""
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
   <definition dp="0.05"><pointmin x="0" y="0" z="0"/><pointmax x="2" y="0" z="1.5"/></definition>
   <commands><mainlist>
    <setmkbound mk="0"/><drawbox><boxfill>bottom|left|right</boxfill>
     <point x="0" y="0" z="0"/><size x="2" y="0" z="1.2"/></drawbox>
    <setmkbound mk="1"/><drawbox><boxfill>solid</boxfill>
     <point x="0.5" y="0" z="0.6"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <setmkfluid mk="0"/><drawbox><boxfill>solid</boxfill>
     <point x="0" y="0" z="0.05"/><size x="2" y="0" z="0.5"/></drawbox>
   </mainlist></commands>
  </geometry>
  <floatings>
   <floating mkbound="1"><rhopbody value="500"/></floating>
  </floatings>
 </casedef>
 <execution>
  <special>
   <chrono>
    <bodyfixed id="ground" mkbound="0"/>
    <bodyfloating id="box" mkbound="1"/>
    <link_linearspring idbody1="ground" idbody2="box">
     <point_fb1 x="0.6" y="0" z="1.2"/>
     <point_fb2 x="0.6" y="0" z="0.7"/>
     <stiffness value="300"/><damping value="5"/>
     <rest_length value="0.5"/>
    </link_linearspring>
    <link_hinge idbody1="box" idbody2="ground">
     <rotpoint x="0.6" y="0" z="0.7"/>
     <rotvector x="0" y="1" z="0"/>
    </link_hinge>
   </chrono>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/>
   <parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "chrono_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    feats = case.meta["features"]
    assert feats.chrono is not None
    types = sorted(l.type for l in feats.chrono.links)
    assert types == ["hinge", "spring"]
    sp = [l for l in feats.chrono.links if l.type == "spring"][0]
    assert sp.b1 == 0 and sp.b2 == -1      # body slot first, ground second
    assert abs(sp.stiffness - 300.0) < 1e-9
    hg = [l for l in feats.chrono.links if l.type == "hinge"][0]
    assert hg.b1 == 0 and tuple(hg.rotvector) == (0.0, 1.0, 0.0)


def test_pulley_couples_rotation_rates():
    """Two wheels on parallel y-axes coupled by a pulley (belt) with
    r1=0.3, r2=0.1: driving body1 with a constant torque must keep
    r1*w1 == r2*w2 (belt speed equality, JChLinkPulley)."""
    c0 = [[0.0, 0.0, 1.0], [1.0, 0.0, 1.0]]
    axis = (0.0, 1.0, 0.0)
    r1, r2 = 0.3, 0.1
    links = [
        CH.ChLink("hinge", 0, -1, rotpoint=c0[0], rotvector=axis),
        CH.ChLink("hinge", 1, -1, rotpoint=c0[1], rotvector=axis),
        CH.ChLink("pulley", 0, 1, rotvector=axis, radius=r1, radius2=r2),
    ]
    cfg = CH.make_chrono(links, c0)
    mass = jnp.asarray([1.0, 1.0], jnp.float32)
    inert = jnp.asarray([np.eye(3) * 0.02] * 2, jnp.float32)
    center = jnp.asarray(c0, jnp.float32)
    fvel = jnp.zeros((2, 3), jnp.float32)
    fomega = jnp.zeros((2, 3), jnp.float32)
    angles = jnp.zeros((2, 3), jnp.float32)
    from dualsphysics_multilayer.features.floating import _euler_rot
    dt = 1e-3
    drive = jnp.asarray([[0.0, 0.5, 0.0], [0.0, 0.0, 0.0]], jnp.float32)
    for _ in range(500):
        R = _euler_rot(angles)
        face, oace = CH.solve_constrained(
            cfg, mass, inert, R, center, fvel, fomega,
            jnp.zeros((2, 3), jnp.float32), drive, jnp.float32(dt))
        center = center + dt * fvel
        fvel = fvel + dt * face
        fomega = fomega + dt * oace
        angles = angles + dt * fomega
    w1 = float(fomega[0, 1])
    w2 = float(fomega[1, 1])
    assert abs(w1) > 0.5                       # it spins
    assert abs(r1 * w1 - r2 * w2) < 0.02 * abs(r1 * w1), (w1, w2)


# ---------------------------------------------------------------------------
# Chrono collision meshes (features/chcollision)
# ---------------------------------------------------------------------------

def _cube_tris(size, center):
    """12-triangle cube mesh."""
    s = size / 2.0
    c = np.asarray(center, np.float64)
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)]) + c
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),   # x- x+
             (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),   # y- y+
             (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]   # z- z+
    return v[np.asarray(faces)]


def test_closest_on_tri_matches_brute():
    from dualsphysics_multilayer.features.chcollision import \
        closest_on_tri
    rng = np.random.default_rng(3)
    tri = rng.normal(size=(40, 3, 3))
    pts = rng.normal(size=(40, 3)) * 1.5
    q = np.asarray(closest_on_tri(jnp.asarray(pts), jnp.asarray(tri[:, 0]),
                                  jnp.asarray(tri[:, 1]),
                                  jnp.asarray(tri[:, 2])))
    d = np.linalg.norm(pts - q, axis=-1)
    # brute: dense barycentric sampling
    u = np.linspace(0, 1, 201)
    uu, vv = np.meshgrid(u, u)
    m = uu + vv <= 1.0
    uu, vv = uu[m], vv[m]
    for k in range(len(tri)):
        a, b, c = tri[k]
        grid = a[None] + uu[:, None] * (b - a)[None] + \
            vv[:, None] * (c - a)[None]
        db = np.linalg.norm(grid - pts[k][None], axis=-1).min()
        assert d[k] <= db + 1e-3, (k, d[k], db)
        assert d[k] >= db - 2e-2          # grid resolution slack


def test_obj_loader(tmp_path):
    from dualsphysics_multilayer.io.meshfile import load_obj
    p = tmp_path / "box.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    t = load_obj(str(p))
    assert t.shape == (2, 3, 3)
    # fan split preserves the quad's area
    def area(tr):
        return 0.5 * np.linalg.norm(np.cross(tr[1] - tr[0], tr[2] - tr[0]))
    assert abs(area(t[0]) + area(t[1]) - 1.0) < 1e-12


def test_contact_box_settles_on_floor():
    """A floating cube dropped onto a fixed floor mesh must come to rest at
    the contact distance instead of falling through (SMC penalty contact =
    the reference's Chrono collision channel)."""
    import jax
    from dualsphysics_multilayer.features import chcollision as CC
    dp = 0.05
    floor = np.array([[[-1, -1, 0], [1, -1, 0], [1, 1, 0]],
                      [[-1, -1, 0], [1, 1, 0], [-1, 1, 0]]], np.float64)
    size = 0.2
    z0 = size / 2 + 0.03                  # 5 mm above contact distance
    cube = _cube_tris(size, (0.0, 0.0, z0))     # world frame, like an .obj
    cc = CC.make_chcontact(
        [dict(ft=-1, tris=floor),
         dict(ft=0, tris=cube, center0=(0.0, 0.0, z0), mass=1.0)],
        dp=dp, distancedp=0.5)
    assert cc is not None
    m = 1.0
    g = jnp.asarray([0.0, 0.0, -9.81], jnp.float32)
    eye = jnp.eye(3, dtype=jnp.float32)[None]
    dt = 2e-5

    def body(_, st):
        center, fvel = st
        f, tq, _ = CC.contact_forces(cc, 1, eye, center, fvel,
                                     jnp.zeros((1, 3), jnp.float32),
                                     jnp.float32(dt))
        acc = f / m + g[None]
        fvel = fvel + dt * acc
        center = center + dt * fvel
        return center, fvel

    center = jnp.asarray([[0.0, 0.0, z0]], jnp.float32)
    fvel = jnp.zeros((1, 3), jnp.float32)
    run = jax.jit(lambda st: jax.lax.fori_loop(0, 30000, body, st))
    center, fvel = run((center, fvel))
    zc = float(center[0, 2])
    # rests between floor surface and cube-halfheight + contact distance
    assert size / 2 - 0.5 * dp * 0.8 < zc <= size / 2 + 0.5 * dp + 1e-3, zc
    assert abs(float(fvel[0, 2])) < 0.05
    assert abs(float(center[0, 0])) < 1e-3       # no lateral drift


def test_contact_xml_parsing(tmp_path):
    """<collision activate=true> + modelfile obj -> ChContactCfg."""
    from dualsphysics_multilayer.io import xmlcase
    cube = _cube_tris(0.2, (0.6, 0.0, 0.7))
    obj = ["v %g %g %g" % tuple(p) for p in cube.reshape(-1, 3)]
    obj += ["f %d %d %d" % (i * 3 + 1, i * 3 + 2, i * 3 + 3)
            for i in range(len(cube))]
    (tmp_path / "box.obj").write_text("\n".join(obj))
    (tmp_path / "floor.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nf 1 2 3 4\n")
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
     <point x="0" y="0" z="0.05"/><size x="2" y="0" z="0.5"/></drawbox>
   </mainlist></commands>
  </geometry>
  <floatings>
   <floating mkbound="1"><rhopbody value="500"/></floating>
  </floatings>
  <properties>
   <links><link mkbound="0" property="steel"/><link mkbound="1" property="steel"/></links>
   <property name="steel"><Young_Modulus value="2e6"/>
    <PoissonRatio value="0.3"/><Kfric value="0.4"/>
    <Restitution_Coefficient value="0.6"/></property>
  </properties>
 </casedef>
 <execution>
  <special>
   <chrono>
    <scaleforce>
     <body mkbound="1" x="0.5" y="1" z="1"/>
    </scaleforce>
    <collision activate="true">
     <distancedp value="0.5"/>
     <contactmethod value="1"/>
    </collision>
    <bodyfixed id="ground" mkbound="0" modelfile="floor.obj"/>
    <bodyfloating id="box" mkbound="1" modelfile="box.obj"/>
    <link_spheric idbody1="box">
     <rotpoint x="0.6" y="0" z="0.7"/>
    </link_spheric>
   </chrono>
  </special>
  <parameters>
   <parameter key="TimeMax" value="0.1"/>
   <parameter key="TimeOut" value="0.05"/>
  </parameters>
 </execution>
</case>"""
    p = tmp_path / "chcol_Def.xml"
    p.write_text(xml)
    case, opts, run = xmlcase.load_case(str(p))
    feats = case.meta["features"]
    cc = feats.chcontact
    assert cc is not None
    assert list(cc.body_ft) == [-1, 0]
    assert cc.tris.shape[0] == 2 and cc.trimask[1].sum() == 12
    assert abs(cc.ddp - 0.5 * 0.05) < 1e-9
    # floating body's mesh rebased to its center
    assert np.allclose(cc.center0[1], np.asarray(case.state.ft.center)[0],
                       atol=0.05)
    # <scaleforce> lands on the floating cfg
    sf = np.asarray(feats.floating.scaleforce).reshape(-1, 3)
    assert np.allclose(sf[0], [0.5, 1.0, 1.0])
