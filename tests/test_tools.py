"""Post-processing tool suite tests: run each tool end-to-end on a small
synthetic PART series and check the outputs (the reference ships these as
closed binaries; SURVEY §1 'External toolchain')."""

import os

import numpy as np
import pytest

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.io import jbinary as jb
from dualsphysics_multilayer.io import partdata
from dualsphysics_multilayer.io.floatdata import (FloatBi4Writer,
                                                      PartOutWriter,
                                                      read_floatbi4,
                                                      read_partout,
                                                      read_parthead,
                                                      write_parthead)
from dualsphysics_multilayer.tools import (bifileinfo, boundaryvtk,
                                               computeforces, flowtool,
                                               floatinginfo, isosurface,
                                               measuretool, partvtk,
                                               partvtkout, tracerparts)
from dualsphysics_multilayer.tools import common as TC
from dualsphysics_multilayer.typesdef import make_ctesph


class _St:
    def __init__(self, pos, vel, rho, code, idp):
        self.pos, self.vel, self.rho = pos, vel, rho
        self.code, self.idp = code, idp


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """Three PARTs of a settling 2D water column (dp=0.05): bottom wall
    (fixed) + fluid block, hand-built so values are predictable."""
    d = tmp_path_factory.mktemp("parts")
    dp = 0.05
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=0.4)
    # wall: z=0 row; fluid: 8x8 block above
    xw = np.arange(0, 1.0 + 1e-9, dp)
    wall = np.column_stack([xw, 0 * xw, 0 * xw - dp])
    fx, fz = np.meshgrid(np.arange(dp, 0.4, dp), np.arange(0, 0.4, dp))
    fluid = np.column_stack([fx.ravel(), 0 * fx.ravel(), fz.ravel() + dp])
    pos = np.concatenate([wall, fluid])
    nb, nf = len(wall), len(fluid)
    n = nb + nf
    code = np.concatenate([
        np.full(nb, td.code_make(td.TYPE_FIXED, 0), np.uint32),
        np.full(nf, td.code_make(td.TYPE_FLUID, 0), np.uint32)])
    idp = np.arange(n, dtype=np.uint32)
    w = partdata.PartWriter(str(d), csp, np_total=n, nfixed=nb, nfluid=nf,
                            posmin=tuple(pos.min(0)), posmax=tuple(pos.max(0)))
    for cpart in range(3):
        p = pos.copy()
        p[nb:, 0] += 0.01 * cpart          # drift fluid in +x
        vel = np.zeros((n, 3), np.float32)
        vel[nb:, 0] = 0.1 * cpart
        rho = np.full(n, 1000.0 + cpart, np.float32)
        w.save(cpart, 0.1 * cpart, _St(p, vel, rho, code, idp))
    return str(d), csp, nb, nf


def test_partvtk_vtk_csv(series, tmp_path):
    d, csp, nb, nf = series
    out = str(tmp_path / "fluid.vtk")
    csv = str(tmp_path / "all.csv")
    partvtk.main(["-dirin", d, "-savevtk", out,
                  "-onlytype:-all,+fluid", "-vars:+press,+mass",
                  "-savecsv", csv])
    assert os.path.exists(str(tmp_path / "fluid_0002.vtk"))
    txt = open(str(tmp_path / "all_0001.csv")).read().splitlines()
    assert txt[0].startswith("Pos.x")
    assert len(txt) == 1 + nb + nf


def test_partvtk_stats_energy(series, tmp_path):
    d, csp, nb, nf = series
    st = str(tmp_path / "stats.csv")
    en = str(tmp_path / "energy.csv")
    partvtk.main(["-dirin", d, "-savestatscsv", st, "-onlytype:-all,+fluid",
                  "-saveenergy", en])
    lines = open(en).read().splitlines()
    assert len(lines) == 4                       # header + 3 parts
    # kinetic energy grows with the imposed velocity ramp
    ek = [float(l.split(";")[2]) for l in lines[1:]]
    assert ek[0] == 0.0 and ek[2] > ek[1] > 0.0


def test_partvtk_filters(series, tmp_path):
    d, csp, nb, nf = series
    csv = str(tmp_path / "f.csv")
    partvtk.main(["-dirin", d, "-savecsv", csv, "-onlypos:0:-1:-1:0.2:1:1",
                  "-last:0"])
    rows = open(str(tmp_path / "f_0000.csv")).read().splitlines()[1:]
    assert all(float(r.split(";")[0]) <= 0.2 + 1e-9 for r in rows)


def test_measuretool_interpolation(series, tmp_path):
    d, csp, nb, nf = series
    csv = str(tmp_path / "probe")
    measuretool.main(["-dirin", d, "-pointsdef:pt=0.2:0:0.2",
                      "-vars:+rhop,+vel", "-savecsv", csv,
                      "-onlytype:-all,+fluid"])
    lines = open(csv + ".csv").read().splitlines()
    assert len(lines) == 4
    # interior probe: Shepard-corrected rhop ~ the particle value
    r0 = float(lines[1].split(";")[-1])
    assert abs(r0 - 1000.0) < 2.0
    vx2 = float(lines[3].split(";")[2])
    assert abs(vx2 - 0.2) < 0.02


def test_measuretool_elevation(series, tmp_path):
    d, csp, nb, nf = series
    csv = str(tmp_path / "eta.csv")
    measuretool.main(["-dirin", d, "-pointsdef:pt=0.2:0:0.0", "-elevation",
                      "-savecsv", csv, "-onlytype:-all,+fluid"])
    lines = open(csv).read().splitlines()
    eta = float(lines[1].split(";")[2])
    assert 0.3 < eta < 0.5                       # column top ~0.4


def test_isosurface(series, tmp_path):
    d, csp, nb, nf = series
    out = str(tmp_path / "iso.vtk")
    isosurface.main(["-dirin", d, "-saveiso", out, "-last:0",
                     "-distnode_dp:1.0"])
    p = str(tmp_path / "iso_0000.vtk")
    assert os.path.exists(p)
    assert b"LINES" in open(p, "rb").read()      # 2D case -> polylines


def test_computeforces(series, tmp_path):
    d, csp, nb, nf = series
    csv = str(tmp_path / "forces")
    computeforces.main(["-dirin", d, "-savecsv", csv, "-viscoart:0.1",
                        "-momentex_xyz:0.5:0:0"])
    lines = open(csv + ".csv").read().splitlines()
    hdr = lines[0].split(";")
    assert "ForceFluid.z" in hdr and "MexY" in hdr
    # part 0 has rho=rho0 exactly -> zero pressure -> zero force
    assert float(lines[1].split(";")[hdr.index("ForceFluid.z")]) == 0.0
    # part 2 is compressed (rho=1002): the column presses DOWN on the wall
    fz = float(lines[3].split(";")[hdr.index("ForceFluid.z")])
    assert fz < 0.0


def test_flowtool(series, tmp_path):
    d, csp, nb, nf = series
    boxes = tmp_path / "boxes.txt"
    boxes.write_text(
        "BOX @Left\n0 -1 0\n0.21 -1 0\n0.21 1 0\n0 1 0\n"
        "0 -1 1\n0.21 -1 1\n0.21 1 1\n0 1 1\n"
        "BOX @Right\n0.21 -1 0\n1.1 -1 0\n1.1 1 0\n0.21 1 0\n"
        "0.21 -1 1\n1.1 -1 1\n1.1 1 1\n0.21 1 1\n")
    csv = str(tmp_path / "flow.csv")
    flowtool.main(["-dirin", d, "-fileboxes", str(boxes), "-savecsv", csv])
    lines = open(csv).read().splitlines()
    hdr = lines[0].split(";")
    c_l = [int(l.split(";")[hdr.index("Count_Left")]) for l in lines[1:]]
    c_r = [int(l.split(";")[hdr.index("Count_Right")]) for l in lines[1:]]
    assert c_l[0] + c_r[0] == nf
    assert c_l[2] < c_l[0]                       # fluid drifts +x out of Left


def test_tracerparts(series, tmp_path):
    d, csp, nb, nf = series
    out = str(tmp_path / "traj.vtk")
    tracerparts.main(["-dirin", d, "-savevtk", out, "-maxparts:10",
                      "-onlypos:0:-1:-1:2:1:1"])
    assert b"LINES" in open(out, "rb").read()


def test_boundaryvtk(series, tmp_path):
    d, csp, nb, nf = series
    out = str(tmp_path / "bound.vtk")
    boundaryvtk.main(["-dirin", d, "-savevtkdata", out])
    assert os.path.exists(str(tmp_path / "bound_0000.vtk"))


def test_bifileinfo(series, capsys):
    d, csp, nb, nf = series
    bifileinfo.main([os.path.join(d, "Part_0000.bi4")])
    out = capsys.readouterr().out
    assert "JPartDataBi4" in out and "ARRAY Posd" in out


def test_floatdata_roundtrip(tmp_path):
    w = FloatBi4Writer(str(tmp_path), mkbound=[51], begin=[100], count=[20],
                       mass=[2.0], massp=[0.1])
    w.save_part(0, 0.0, center=[[0.5, 0, 0.3]], fvel=[[0, 0, 0]],
                fomega=[[0, 0, 0]])
    w.save_part(1, 0.1, center=[[0.5, 0, 0.25]], fvel=[[0, 0, -0.5]],
                fomega=[[0, 0, 0.1]])
    head, parts = read_floatbi4(str(tmp_path / "PartFloat.fbi4"))
    assert head["ftcount"] == 1 and head["mkbound"][0] == 51
    assert len(parts) == 2
    assert abs(parts[1]["center"][0, 2] - 0.25) < 1e-12
    assert abs(parts[1]["fomega"][0, 2] - 0.1) < 1e-7


def test_floatinginfo(tmp_path):
    w = FloatBi4Writer(str(tmp_path), mkbound=[51], begin=[0], count=[4],
                       mass=[1.0], massp=[0.25])
    for k in range(3):
        w.save_part(k, 0.05 * k, center=[[0.1 * k, 0, 0.3]],
                    fvel=[[0.2, 0, 0]], fomega=[[0, 0, 0]])
    out = str(tmp_path / "motion")
    floatinginfo.main(["-dirin", str(tmp_path), "-savemotion", out])
    p = out + "_mkbound51.csv"
    lines = open(p).read().splitlines()
    assert len(lines) == 4
    assert abs(float(lines[3].split(";")[2]) - 0.2) < 1e-9


def test_partout_and_partvtkout(tmp_path):
    w = PartOutWriter(str(tmp_path))
    w.save_part(1, 0.1, idp=[7, 9], pos=[[0, 0, 0], [1, 1, 1]],
                vel=[[0, 0, -1], [0, 0, -2]], rhop=[650.0, 1400.0],
                motive=[2, 2])
    parts = read_partout(str(tmp_path / "PartOut_000.obi4"))
    assert parts[0]["idp"].tolist() == [7, 9]
    csv = str(tmp_path / "out.csv")
    partvtkout.main(["-dirin", str(tmp_path), "-savecsv", csv])
    lines = open(csv).read().splitlines()
    assert len(lines) == 3 and lines[1].split(";")[2] == "7"


def test_parthead_roundtrip(tmp_path):
    csp = make_ctesph(simulate2d=False, dp=0.02, hswl=0.4)
    write_parthead(str(tmp_path), csp, casename="t",
                   mkblocks=[dict(type="Fluid", mk=1, mktype=0, count=100)])
    h = read_parthead(str(tmp_path / "Part_Head.ibi4"))
    assert h["CaseName"] == "t"
    assert h["mkblocks"][0]["count"] == 100
    assert abs(h["Dp"] - 0.02) < 1e-12


def test_pair_indices_bruteforce():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 1, (200, 3))
    tgt = rng.uniform(0, 1, (50, 3))
    r = 0.15
    ti, sj = TC.pair_indices(src, tgt, r)
    got = set(zip(ti.tolist(), sj.tolist()))
    d2 = ((tgt[:, None, :] - src[None, :, :]) ** 2).sum(-1)
    want = set(zip(*np.where(d2 < r * r)))
    assert got == want


def test_range_and_typesel():
    assert TC.parse_range_filter("1,3-5,9").tolist() == [1, 3, 4, 5, 9]
    t = TC.parse_typesel("-all,+fluid")
    assert t == {td.TYPE_FLUID}
    t2 = TC.parse_typesel("-bound")
    assert t2 == {td.TYPE_FLUID}


def test_readswash_correctcsv_and_vtk(tmp_path):
    """ReadSwash rebuild: drift correction zeroes net displacement; the
    velocity VTK export writes one file per sample time."""
    import numpy as np
    from dualsphysics_multilayer.tools import readswash as RS
    # a biased sine: net drift over [0, 2]
    t = np.linspace(0.0, 2.0, 101)
    v = 0.3 + np.sin(2 * np.pi * t)
    src = tmp_path / "vel.csv"
    src.write_text("time;v0\n" + "\n".join(f"{a};{b}" for a, b in zip(t, v)))
    rc = RS.main(["-correctcsv:2.0", str(src), str(tmp_path / "velc.csv"),
                  "-dirout", str(tmp_path)])
    assert rc == 0
    t2, v2, _ = RS.read_series_csv(str(tmp_path / "velc.csv"))
    disp = np.trapezoid(v2[:, 0], t2)
    assert abs(disp) < 1e-6, disp
    # shape preserved (only the constant offset removed)
    assert np.allclose(np.diff(v2[:, 0]), np.diff(v), atol=1e-9)

    # multi-layer x/z series -> VTK point clouds
    m = 4
    vx = np.tile(v[:, None], (1, m))
    (tmp_path / "velx.csv").write_text(
        "time;" + ";".join(f"v{i}" for i in range(m)) + "\n"
        + "\n".join(f"{a};" + ";".join(f"{x}" for x in row)
                    for a, row in zip(t, vx)))
    rc = RS.main(["-savevtkveldp:0.05", str(tmp_path / "vel"),
                  "-file_velx", str(tmp_path / "velx.csv"),
                  "-dt", "0.5", "-tmin", "0", "-tmax", "2.0",
                  "-dirout", str(tmp_path)])
    assert rc == 0
    vtks = sorted(tmp_path.glob("vel_*.vtk"))
    assert len(vtks) == 5
    assert vtks[0].read_bytes()[:26].startswith(b"# vtk")


def test_readswash_sws_table(tmp_path):
    """Lenient SWASH table reader: time-marker rows split layered blocks."""
    from dualsphysics_multilayer.tools import readswash as RS
    sws = tmp_path / "run.sws"
    lines = ["% SWASH layered velocity output"]
    for tt in (0.0, 0.5, 1.0):
        lines.append(f"{tt}")
        for x in (0.0, 0.1, 0.2):
            lines.append(f"{x} {0.1 + tt} {0.2 + tt}")
    sws.write_text("\n".join(lines))
    times, data = RS.read_sws(str(sws))
    assert list(times) == [0.0, 0.5, 1.0]
    assert data.shape == (3, 3, 3)
    rc = RS.main(["-savecsv", str(sws), str(tmp_path / "out.csv"),
                  "-dirout", str(tmp_path)])
    assert rc == 0
    t2, v2, _ = RS.read_series_csv(str(tmp_path / "out_velx.csv"))
    assert v2.shape == (3, 6)
