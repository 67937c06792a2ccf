"""GenCase geometry extensions: transform stack, prisms, mesh imports
(reference vocabulary: doc/xml_format/CaseTemplate.xml draw/transform
commands; the closed GenCase binary rasterizes the same way)."""

import struct

import numpy as np

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.io import meshfile
from dualsphysics_multilayer.io.xmlcase import load_case
from dualsphysics_multilayer.models.cases import Draw

_XML = """<?xml version="1.0"?>
<case>
 <casedef>
  <constantsdef>
   <gravity x="0" y="0" z="-9.81"/>
   <rhop0 value="1000"/><hswl value="0.1" auto="false"/>
   <gamma value="7"/><speedsound value="20" auto="false"/>
   <coefh value="1.0"/><cflnumber value="0.2"/>
  </constantsdef>
  <geometry>
   <definition dp="0.02">
    <pointmin x="-1" y="0" z="-1"/><pointmax x="2" y="0" z="2"/>
   </definition>
   <commands><mainlist>
    {cmds}
   </mainlist></commands>
  </geometry>
 </casedef>
 <execution><parameters>
   <parameter key="TimeMax" value="0.1"/>
   <parameter key="TimeOut" value="0.05"/>
 </parameters></execution>
</case>
"""


def _load(tmp_path, cmds):
    p = tmp_path / "Case_Def.xml"
    p.write_text(_XML.format(cmds=cmds))
    case, opts, params = load_case(str(p))
    return case


def test_rotated_drawbox(tmp_path):
    """A 45-degree rotated solid fluid box must produce ~the same particle
    count as the axis-aligned one, at rotated positions."""
    case0 = _load(tmp_path, """
    <setmkbound mk="0"/>
    <drawbox><boxfill>bottom</boxfill>
      <point x="-0.5" y="0" z="-0.3"/><size x="2.0" y="0" z="0.02"/></drawbox>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.4" y="0" z="0.2"/></drawbox>
    """)
    case1 = _load(tmp_path, """
    <setmkbound mk="0"/>
    <drawbox><boxfill>bottom</boxfill>
      <point x="-0.5" y="0" z="-0.3"/><size x="2.0" y="0" z="0.02"/></drawbox>
    <setmkfluid mk="0"/>
    <rotateline ang="45">
      <point x="0" y="0" z="0"/><point x="0" y="1" z="0"/>
    </rotateline>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.4" y="0" z="0.2"/></drawbox>
    """)
    code0 = np.asarray(case0.state.code)
    code1 = np.asarray(case1.state.code)
    nf0 = int((td.code_type(code0) == td.TYPE_FLUID).sum())
    nf1 = int((td.code_type(code1) == td.TYPE_FLUID).sum())
    assert abs(nf1 - nf0) / nf0 < 0.15
    # rotated 45 deg about the y line through the origin: the fluid's
    # (x,z) extents change from (0.4, 0.2) to ~(0.42, 0.42) diagonals
    pos1 = np.asarray(case1.state.pos)
    fl1 = np.asarray(td.code_type(code1) == td.TYPE_FLUID)
    zext = pos1[fl1, 2].max() - pos1[fl1, 2].min()
    assert 0.35 < zext < 0.5, zext


def test_draw_prism_solid():
    d = Draw(dp=0.05)
    base = [(0, 0, 0), (1, 0, 0), (0.5, 1.0, 0)]
    d.prism(base, (0, 0, 0.5), ptype=td.TYPE_FLUID, mk=0, solid=True)
    pos, code = d.build()
    assert len(pos) > 50
    # all inside the extruded triangle's bbox, half the box's volume-ish
    assert pos[:, 2].min() >= -1e-9 and pos[:, 2].max() <= 0.5 + 1e-9
    nfull = (1 / 0.05) ** 2 * (0.5 / 0.05)
    assert 0.3 * nfull < len(pos) < 0.75 * nfull


def test_stl_import(tmp_path):
    """Binary STL cube -> tri_surface boundary shell."""
    # 12 triangles of a unit cube
    faces = []
    for axis in range(3):
        for side in (0.0, 1.0):
            pts = []
            for u in ((0, 0), (1, 0), (1, 1), (0, 1)):
                p = [0.0, 0.0, 0.0]
                p[axis] = side
                p[(axis + 1) % 3] = float(u[0])
                p[(axis + 2) % 3] = float(u[1])
                pts.append(p)
            faces += [[pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]]]
    fn = tmp_path / "cube.stl"
    with open(fn, "wb") as f:
        f.write(b"\0" * 80)
        f.write(struct.pack("<I", len(faces)))
        for tri in faces:
            f.write(struct.pack("<3f", 0, 0, 0))
            for v in tri:
                f.write(struct.pack("<3f", *v))
            f.write(struct.pack("<H", 0))
    tris = meshfile.load_stl(str(fn))
    assert tris.shape == (12, 3, 3)
    d = Draw(dp=0.1)
    d.tri_surface(tris, ptype=td.TYPE_FIXED, mk=5)
    pos, code = d.build()
    # a dp-lattice shell of the unit cube: 11^3 - 9^3 = 602 points
    assert len(pos) == 11 ** 3 - 9 ** 3
    # every point on the surface
    on = np.any(np.isclose(pos, 0.0, atol=1e-6)
                | np.isclose(pos, 1.0, atol=1e-6), axis=1)
    assert on.all()


def test_vtk_ply_loaders(tmp_path):
    ply = tmp_path / "tri.ply"
    ply.write_text("""ply
format ascii 1.0
element vertex 4
property float x
property float y
property float z
element face 2
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
1 1 0
0 1 0
3 0 1 2
3 0 2 3
""")
    tris = meshfile.load_ply(str(ply))
    assert tris.shape == (2, 3, 3)

    vtk = tmp_path / "tri.vtk"
    vtk.write_text("""# vtk DataFile Version 3.0
mesh
ASCII
DATASET POLYDATA
POINTS 4 float
0 0 0
1 0 0
1 1 0
0 1 0
POLYGONS 1 5
4 0 1 2 3
""")
    tris = meshfile.load_vtk(str(vtk))
    assert tris.shape == (2, 3, 3)


def test_setvar_expressions_and_fillpoint(tmp_path):
    """<setvar> + #expressions in geometry attributes + <fillpoint> flood
    fill bounded by drawn walls (GenCase/JNumexLib behaviour)."""
    case = _load(tmp_path, """
    <setvar W="0.4" H="W/2"/>
    <setmkbound mk="0"/>
    <drawbox><boxfill>bottom|left|right|top</boxfill>
      <point x="0" y="0" z="0"/><size x="W" y="0" z="H+0.1"/></drawbox>
    <setmkfluid mk="0"/>
    <fillpoint x="W/2" y="0" z="0.05"><modefill>fluid</modefill></fillpoint>
    """)
    code = np.asarray(case.state.code)
    fl = td.code_type(code) == td.TYPE_FLUID
    bd = td.code_type(code) == td.TYPE_FIXED
    assert bd.sum() > 0 and fl.sum() > 0
    pos = np.asarray(case.state.pos)
    # the flood fill stayed inside the walls (0..0.4 x 0..0.3)
    assert pos[fl, 0].min() >= -1e-6 and pos[fl, 0].max() <= 0.4 + 1e-6
    assert pos[fl, 2].max() <= 0.3 + 1e-6
    # interior fully filled: ~ (0.4/0.02-1) * (0.3/0.02-1) points
    assert fl.sum() > 0.7 * (0.4 / 0.02) * (0.3 / 0.02)


def test_draw_ellipsoid():
    d = Draw(dp=0.05)
    d.ellipsoid((0, 0, 0), (1.0, 0.6, 0.4), ptype=td.TYPE_FLUID, mk=0)
    pos, code = d.build()
    # volume of the ellipsoid vs lattice count
    vol = 4 / 3 * np.pi * 0.5 * 0.3 * 0.2
    n_expect = vol / 0.05 ** 3
    assert 0.7 * n_expect < len(pos) < 1.3 * n_expect
    c = np.array([0.5, 0.3, 0.2])
    u = (pos - c) / np.array([0.5, 0.3, 0.2])
    assert (np.sum(u * u, axis=1) <= 1.0 + 1e-6).all()


def test_lineto_strip_fan_pyramid(tmp_path):
    case = _load(tmp_path, """
    <setmkbound mk="0"/>
    <setlinebegin x="0" y="0" z="0"/>
    <drawlineto x="0.5" y="0" z="0"/>
    <drawlineto x="0.5" y="0" z="0.5"/>
    <drawtrianglesstrip>
      <point x="0" y="0" z="1"/><point x="0.2" y="0" z="1"/>
      <point x="0" y="0" z="1.2"/><point x="0.2" y="0" z="1.2"/>
    </drawtrianglesstrip>
    <drawtrianglesfan>
      <point x="1" y="0" z="1"/><point x="1.2" y="0" z="1"/>
      <point x="1.2" y="0" z="1.2"/><point x="1" y="0" z="1.2"/>
    </drawtrianglesfan>
    <drawpyramid>
      <point x="1.5" y="0" z="0.5"/>
      <point x="1.3" y="0" z="0"/><point x="1.7" y="0" z="0"/>
    </drawpyramid>
    <setmkfluid mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="-0.5" y="0" z="-0.5"/><size x="0.2" y="0" z="0.2"/></drawbox>
    """)
    pos = np.asarray(case.state.pos)[:case.np_total]
    code = np.asarray(case.state.code)[:case.np_total]
    isb = td.code_type(code) < td.TYPE_FLOATING
    bpos = pos[np.asarray(isb)]
    # polyline from the cursor commands
    online = np.abs(bpos[:, 2]) < 1e-6
    assert (bpos[online][:, 0].max() >= 0.49)
    # strip + fan squares exist
    assert ((bpos[:, 2] >= 0.99) & (bpos[:, 0] <= 0.3)).sum() > 20
    assert ((bpos[:, 2] >= 0.99) & (bpos[:, 0] >= 0.9)).sum() > 20
    # pyramid has points near the apex
    apex = bpos[np.abs(bpos[:, 0] - 1.5) < 0.05]
    assert (apex[:, 2] > 0.4).any()


def test_drawwave_solitary(tmp_path):
    case = _load(tmp_path, """
    <setmkfluid mk="0"/>
    <drawwave depth="0.4" hmaxwave="0.2" x0="0.5" z0="0.4">
      <point x="-1" y="0" z="0"/><size x="3" y="0" z="1"/>
    </drawwave>
    """)
    pos = np.asarray(case.state.pos)[:case.np_total]
    code = np.asarray(case.state.code)[:case.np_total]
    isf = np.asarray(td.code_type(code) == td.TYPE_FLUID)
    fp = pos[isf]
    # crest near x0 reaches z0+hmax, far field stays at z0
    crest = fp[np.abs(fp[:, 0] - 0.5) < 0.05][:, 2].max()
    far = fp[fp[:, 0] > 1.5][:, 2].max()
    assert 0.56 < crest <= 0.62, crest
    assert abs(far - 0.4) < 0.05, far


def test_redraw_and_mkstack(tmp_path):
    case = _load(tmp_path, """
    <setmkbound mk="0"/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0" y="0" z="0"/><size x="0.2" y="0" z="0.2"/></drawbox>
    <mksave/>
    <setmkbound mk="3"/>
    <redrawbox mkbound="0">
      <point x="0" y="0" z="0.1"/><size x="0.3" y="0" z="0.2"/>
    </redrawbox>
    <mkload/>
    <drawbox><boxfill>solid</boxfill>
      <point x="0.5" y="0" z="0"/><size x="0.1" y="0" z="0.1"/></drawbox>
    """)
    code = np.asarray(case.state.code)[:case.np_total]
    pos = np.asarray(case.state.pos)[:case.np_total]
    mk = np.asarray(td.code_value(code))
    isb = np.asarray(td.code_type(code) < td.TYPE_FLOATING)
    # upper half of the first box re-mk'd to 3
    hi = isb & (pos[:, 2] > 0.11) & (pos[:, 0] < 0.3)
    lo = isb & (pos[:, 2] < 0.09) & (pos[:, 0] < 0.3)
    assert (mk[hi] == 3).all() and hi.sum() > 0
    assert (mk[lo] == 0).all() and lo.sum() > 0
    # mkload restored mk=0 for the second box
    second = isb & (pos[:, 0] > 0.45)
    assert (mk[second] == 0).all() and second.sum() > 0


def test_fillprism_and_fillfigure(tmp_path):
    xml = _XML.replace('<pointmin x="-1" y="0" z="-1"/><pointmax x="2" y="0" z="2"/>',
                       '<pointmin x="-1" y="-1" z="-1"/><pointmax x="2" y="1" z="2"/>')
    p = tmp_path / "Case3d_Def.xml"
    p.write_text(xml.format(cmds="""
    <setmkbound mk="0"/>
    <setdrawmode mode="face"/>
    <drawprism>
      <point x="0" y="-0.3" z="0"/><point x="0.6" y="-0.3" z="0"/>
      <point x="0.3" y="-0.3" z="0.6"/>
      <point x="0" y="0.3" z="0"/><point x="0.6" y="0.3" z="0"/>
      <point x="0.3" y="0.3" z="0.6"/>
    </drawprism>
    <fillprism x="0.3" y="0" z="0.2" mkfluid="1">
      <point x="0" y="-0.3" z="0"/><point x="0.6" y="-0.3" z="0"/>
      <point x="0.3" y="-0.3" z="0.6"/>
      <point x="0" y="0.3" z="0"/><point x="0.6" y="0.3" z="0"/>
      <point x="0.3" y="0.3" z="0.6"/>
    </fillprism>
    """))
    case, opts, params = load_case(str(p))
    code = np.asarray(case.state.code)[:case.np_total]
    pos = np.asarray(case.state.pos)[:case.np_total]
    isf = np.asarray(td.code_type(code) == td.TYPE_FLUID)
    assert isf.sum() > 100
    fp = pos[isf]
    # filled fluid stays inside the prism
    assert fp[:, 2].max() < 0.6 and fp[:, 0].min() > -0.01
    assert np.abs(fp[:, 1]).max() < 0.31


def test_fillfigure_mesh(tmp_path):
    xml = _XML.replace('<pointmin x="-1" y="0" z="-1"/><pointmax x="2" y="0" z="2"/>',
                       '<pointmin x="-1" y="-1" z="-1"/><pointmax x="2" y="1" z="2"/>')
    p = tmp_path / "Casefig_Def.xml"
    # closed unit cube as an indexed figure, fill its inside with fluid
    pts = "".join(f'<point x="{x}" y="{y}" z="{z}"/>'
                  for x in (0, 0.4) for y in (-0.2, 0.2) for z in (0, 0.4))
    # cube faces as triangles over vertex ids (x=0/1 ordering: bit2=x,bit1=y,bit0=z)
    faces = [(0,1,3),(0,3,2),(4,6,7),(4,7,5),(0,4,5),(0,5,1),
             (2,3,7),(2,7,6),(0,2,6),(0,6,4),(1,5,7),(1,7,3)]
    tris = "".join(f'<triangle x="{a}" y="{b}" z="{c}"/>' for a,b,c in faces)
    p.write_text(xml.format(cmds=f"""
    <setmkbound mk="0"/>
    <fillfigure x="0.2" y="0" z="0.2" mkfluid="2">
      <points>{pts}</points>
      <triangles>{tris}</triangles>
    </fillfigure>
    """))
    case, opts, params = load_case(str(p))
    code = np.asarray(case.state.code)[:case.np_total]
    pos = np.asarray(case.state.pos)[:case.np_total]
    isf = np.asarray(td.code_type(code) == td.TYPE_FLUID)
    assert isf.sum() > 100
    fp = pos[isf]
    # surface lattice points count as inside -> at most one dp overshoot
    assert fp[:, 0].min() >= -0.021 and fp[:, 0].max() <= 0.421
    assert fp[:, 2].min() >= -0.021 and fp[:, 2].max() <= 0.421
    assert np.asarray(td.code_value(code))[isf].max() == 2


def test_bathymetry_csv(tmp_path):
    # sloping seabed z = 0.1*x over a 2x? grid; 2D case so y=0 row only
    rows = ["x;y;z"]
    for i in range(41):
        for j in range(3):
            x = -1.0 + i * 0.075
            y = -0.1 + j * 0.1
            rows.append(f"{x};{y};{0.3 + 0.1 * x}")
    (tmp_path / "bathy.csv").write_text("\n".join(rows))
    case = _load(tmp_path, """
    <setmkbound mk="0"/>
    <drawfilecsv file="bathy.csv" mode="bathymetry"/>
    """)
    pos = np.asarray(case.state.pos)[:case.np_total]
    code = np.asarray(case.state.code)[:case.np_total]
    isb = np.asarray(td.code_type(code) < td.TYPE_FLOATING)
    bp = pos[isb]
    assert len(bp) > 20
    # surface follows z = 0.3 + 0.1x
    err = np.abs(bp[:, 2] - (0.3 + 0.1 * bp[:, 0]))
    assert np.median(err) < 0.05


def _read_mkcells_vtk(path):
    """Parse a GenCase `<cellsout>` golden (`*_MkCells.vtk`, legacy
    big-endian binary polydata: merged constant-Mk rectangles + CELL_DATA
    Mk) into {(ix, iz): Mk} dp-cell map."""
    data = open(path, "rb").read()

    def line(tag, start=0):
        i = data.index(tag, start)
        j = data.index(b"\n", i)
        return i, j, data[i:j].split()

    i, j, toks = line(b"POINTS")
    npts = int(toks[1])
    pts = np.frombuffer(data, dtype=">f4", count=npts * 3,
                        offset=j + 1).reshape(npts, 3)
    i, j, toks = line(b"POLYGONS")
    ncell, total = int(toks[1]), int(toks[2])
    arr = np.frombuffer(data, dtype=">i4", count=total, offset=j + 1)
    polys, k = [], 0
    for _ in range(ncell):
        m = arr[k]
        polys.append(arr[k + 1:k + 1 + m])
        k += 1 + m
    i, j, _ = line(b"LOOKUP_TABLE", line(b"CELL_DATA")[0])
    mks = np.frombuffer(data, dtype=">i4", count=ncell, offset=j + 1)
    return pts, polys, mks


def _golden_cells(path, dp):
    pts, polys, mks = _read_mkcells_vtk(path)
    cells = {}
    for poly, mk in zip(polys, mks):
        p = pts[poly]
        x0, x1 = p[:, 0].min(), p[:, 0].max()
        z0, z1 = p[:, 2].min(), p[:, 2].max()
        nx = int(round((x1 - x0) / dp))
        nz = int(round((z1 - z0) / dp))
        for ix in range(nx):
            for iz in range(nz):
                cx = x0 + dp * (ix + 0.5)
                cz = z0 + dp * (iz + 0.5)
                cells[(int(round(cx / dp)), int(round(cz / dp)))] = int(mk)
    return cells


def test_redrawnear_golden_mkcells():
    """runlist/redrawnear/fillbox lattice semantics vs the shipped GenCase
    cellsout goldens (examples/others/RedrawGenCase/*_MkCells.vtk).

    A handful of cells per snapshot sit exactly on cell boundaries of
    sloped drawlines where GenCase's float arithmetic rounds differently;
    the assertion allows <=1% (+cascade) divergence."""
    import os
    import pytest
    base = "/root/reference/examples/others/RedrawGenCase"
    if not os.path.isdir(base):
        pytest.skip("reference examples not mounted")
    for stem, nsnap, tol in (("RedrawSimple", 3, 0.02),
                             ("RedrawComplex", 15, 0.03)):
        case, opts, run = load_case(os.path.join(base, stem + ".xml"))
        snaps = case.meta["cellsout"]
        assert len(snaps) == nsnap
        dp = 0.05 if stem == "RedrawSimple" else 0.1
        mkboundfirst = 8 + 1      # mkconfig fluidcount=8
        for name, lattice in snaps:
            path = os.path.join(base, f"{stem}_{name}_MkCells.vtk")
            if not os.path.isfile(path):
                continue
            golden = _golden_cells(path, dp)
            ours = {}
            for (i, jj, k), (t, mk) in lattice.items():
                gmk = mk + 1 if t == td.TYPE_FLUID else mk + mkboundfirst
                ours[(i, k)] = gmk
            missing = {c for c in golden if c not in ours}
            extra = {c for c in ours if c not in golden}
            wrong = {c for c in golden
                     if c in ours and ours[c] != golden[c]}
            bad = len(missing) + len(extra) + len(wrong)
            assert bad <= max(12, tol * len(golden)), (
                stem, name, f"missing={len(missing)} extra={len(extra)} "
                            f"wrong={len(wrong)} of {len(golden)}",
                sorted(missing)[:5], sorted(extra)[:5])
