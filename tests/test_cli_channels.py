"""CLI flag surface + run-results channels (Run.csv, Timers.csv, PIPS.csv,
OutputTime schedule, TERMINATE, -nortimes byte-diffable outputs)."""

import json
import os

import numpy as np
import pytest

from dualsphysics_multilayer import cli
from dualsphysics_multilayer.io.output import OutputTime
from dualsphysics_multilayer.utils.runinfo import (TerminateCheck,
                                                       save_res)


def test_normalize_colon_forms():
    # "=" form: values may start with "-" (negative -domain_fixed coords)
    out = cli._normalize(["-tmax:1.6", "-partbegin:20", "restartdir",
                          "-svpips:2", "-stable", "-sv:binx,info",
                          "-domain_fixed:-1:-1:-1:1:1:1"])
    assert out == ["-tmax=1.6", "-partbegin=20", "restartdir",
                   "-svpips=2", "-stable", "-sv=binx,info",
                   "-domain_fixed=-1:-1:-1:1:1:1"]


def test_opt_response_file(tmp_path):
    f = tmp_path / "r.opt"
    f.write_text("-tmax:0.5\n-cfl:0.3\n")
    out = cli._normalize(["-opt", str(f), "-dp", "0.1"])
    assert "-tmax=0.5" in out and "-cfl=0.3" in out


def test_output_time_schedule():
    s = OutputTime([(0.0, 0.01), (0.1, 0.5), (0.2, 0.001)])
    assert s.interval(0.0) == 0.01
    assert s.interval(0.05) == 0.01
    assert s.interval(0.1) == 0.5
    assert s.interval(0.35) == 0.001
    with pytest.raises(ValueError):
        OutputTime([(0.5, 0.01)])


def test_terminate_check(tmp_path):
    t = TerminateCheck(str(tmp_path))
    assert t.poll() is None
    (tmp_path / "TERMINATE").write_text("0.25")
    assert t.poll() == 0.25
    assert t.poll() is None          # unchanged -> no retrigger


def test_save_res(tmp_path):
    p = save_res(str(tmp_path), runname="r", appname="a", casenp=100,
                 tsim=1.0, ttot=2.0, timestep=1.0, nstep=500, part=10,
                 nout=0, maxparticles=100, maxcells=64, nbound=10,
                 nfixed=10, dp=0.1, kernelh=0.15)
    lines = open(p).read().splitlines()
    assert lines[0].startswith("#RunName")
    assert lines[1].split(";")[0] == "r"
    save_res(str(tmp_path), runname="r2", appname="a", casenp=1, tsim=1,
             ttot=1, timestep=1, nstep=1, part=1, nout=0, maxparticles=1,
             maxcells=1, nbound=0, nfixed=0, dp=0.1, kernelh=0.15)
    assert len(open(p).read().splitlines()) == 3


def test_cli_ver_info(capsys):
    assert cli.main(["-ver"]) == 0
    v = json.loads(capsys.readouterr().out)
    assert "wcsph" in v["features"]
    assert cli.main(["-info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert "partvtk" in info["features"]["tools"]


@pytest.mark.slow
def test_cli_end_to_end_channels(tmp_path):
    """Small builtin run exercising -svres/-svtimers/-svpips/-nortimes and
    the tool suite on the produced output."""
    d = str(tmp_path / "out")
    rc = cli.main(["-builtin", "dambreak2d", "-dp", "0.05",
                   "-tmax:0.05", "-tout:0.025", "-dirout", d,
                   "-svtimers", "-svpips:1", "-nortimes", "-svdomainvtk",
                   "-runname", "chan"])
    assert rc == 0
    for f in ("Run.csv", "Timers.csv", "PIPS.csv", "Domain.vtk"):
        assert os.path.exists(os.path.join(d, f)), f
    assert os.path.exists(os.path.join(d, "Part_Head.ibi4"))
    row = open(os.path.join(d, "Run.csv")).read().splitlines()[1]
    assert row.split(";")[0] == "chan"
    # tools run on the produced series
    from dualsphysics_multilayer.tools import partvtk
    partvtk.main(["-dirin", d, "-savecsv", str(tmp_path / "pv.csv")])
    assert os.path.exists(str(tmp_path / "pv_0000.csv"))


def test_dsphconfig_defaults(tmp_path, monkeypatch):
    """Machine-level DsphConfig.xml feeds the CLI defaults (JDsphConfig)."""
    from dualsphysics_multilayer import cli
    (tmp_path / "DsphConfig.xml").write_text(
        '<?xml version="1.0"?><dsphconfig><common>'
        '<createdirs v="0"/><csvseparator v="1"/>'
        '</common></dsphconfig>')
    monkeypatch.chdir(tmp_path)
    cfg = cli.load_dsphconfig()
    assert cfg == dict(createdirs=0, csvsep=1)
    p = cli.build_parser()
    p.set_defaults(**cfg)
    args = p.parse_args([])
    assert args.createdirs == 0 and args.csvsep == 1
    # explicit flags still win
    args = p.parse_args(["-csvsep", "0"])
    assert args.csvsep == 0


def test_new_reference_flags_parse():
    """-ddtramp/-saveposdouble/-svextraparts/-svnormals/-cellfixed/
    -restartchrono reach the parser in reference colon form
    (JSphCfgRun.cpp:85-208)."""
    out = cli._normalize(["-ddtramp:2.0:0.5:1.5", "-saveposdouble:0",
                          "-svextraparts:10", "-svnormals:1", "-cellfixed:1",
                          "-restartchrono:1", "-mdbc_fast:1"])
    args = cli.build_parser().parse_args(out + ["-builtin", "dambreak2d"])
    assert args.ddtramp == "2.0:0.5:1.5"
    assert args.saveposdouble == 0
    assert args.svextraparts == "10"
    assert args.svnormals and args.cellfixed and args.restartchrono


def test_extraparts_cadence(tmp_path):
    """-svextraparts interval and range-list cadence follows
    JDsExtraDataSave::CheckSave (cpart>0 && cpart%N==0 && filter)."""
    def checksave(om, cpart):
        if om._extraparts_n is None:
            return True
        return (cpart > 0 and cpart % om._extraparts_n == 0
                and (om._extraparts_set is None
                     or cpart in om._extraparts_set))

    class OM:     # cadence logic only, no case needed
        _extraparts_n = None
        _extraparts_set = None
    om = OM()
    # interval form
    om._extraparts_n, om._extraparts_set = 5, None
    assert [c for c in range(12) if checksave(om, c)] == [5, 10]
    # range-list form
    from dualsphysics_multilayer.tools.common import parse_range_filter
    om._extraparts_n = 1
    om._extraparts_set = set(int(v) for v in parse_range_filter("2,6-8"))
    assert [c for c in range(12) if checksave(om, c)] == [2, 6, 7, 8]


def test_saveposdouble_float_part(tmp_path):
    """-saveposdouble:0 writes float 'Pos' (the reference default array
    name, JPartDataBi4.cpp:360-372); default writes double 'Posd'."""
    import jax.numpy as jnp
    from dualsphysics_multilayer import typesdef as td
    from dualsphysics_multilayer.io import jbinary as jb
    from dualsphysics_multilayer.io import partdata
    from dualsphysics_multilayer.typesdef import make_ctesph

    csp = make_ctesph(simulate2d=True, dp=0.1, hswl=0.3)

    class St:
        pos = jnp.asarray(np.random.rand(8, 3), jnp.float32)
        vel = jnp.zeros((8, 3), jnp.float32)
        rho = jnp.full((8,), 1000.0, jnp.float32)
        code = jnp.asarray([td.code_make(td.TYPE_FLUID, 0)] * 8)
        idp = jnp.arange(8, dtype=jnp.uint32)

    for posdouble, name in ((True, "Posd"), (False, "Pos")):
        w = partdata.PartWriter(str(tmp_path / f"pd{int(posdouble)}"), csp,
                                posdouble=posdouble, np_total=8, nfluid=8)
        path = w.save(1, 0.5, St())
        root = jb.read_file(path)
        part = root.items[0] if root.items else root
        names = {a.name for it in [root] + list(root.items)
                 for a in it.arrays}
        assert name in names and ("Pos" if posdouble else "Posd") \
            not in names


def test_cli_shard_end_to_end(tmp_path):
    """-shard:N runs the case through ShardedSimulation over the virtual
    mesh and produces the normal PART output."""
    import jax
    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs 4 virtual devices")
    d = str(tmp_path / "outsh")
    rc = cli.main(["-builtin", "dambreak2d", "-dp", "0.05",
                   "-tmax:0.03", "-tout:0.015", "-dirout", d,
                   "-shard:4", "-runname", "shard"])
    assert rc == 0
    assert os.path.exists(os.path.join(d, "Part_Head.ibi4"))
    assert os.path.exists(os.path.join(d, "Part_0002.bi4"))
    from dualsphysics_multilayer.io import partdata
    part = partdata.read_part(os.path.join(d, "Part_0002.bi4"))
    # live particles survived the gather (dead shard slots dropped)
    assert part["pos"].shape[0] > 100
    assert np.isfinite(part["pos"]).all()


def test_cli_domain_fixed_and_svcsv(tmp_path):
    """-domain_fixed rebuilds the cell grid over the given box (the round-2
    crash path, JSphCfgRun.cpp:176) and -sv:csv writes per-PART CSVs
    (JOutputCsv::SaveCsv) — both EXECUTED, not just parsed."""
    d = str(tmp_path / "out")
    rc = cli.main(["-builtin", "dambreak2d", "-dp", "0.09",
                   "-tmax:0.004", "-tout:0.002", "-dirout", d,
                   "-domain_fixed:-0.5:-0.2:-0.5:4.5:0.2:5.0",
                   "-sv:binx,csv", "-runname", "domfix"])
    assert rc == 0
    csvs = sorted(f for f in os.listdir(d) if f.startswith("PartCsv_"))
    assert csvs, f"no PartCsv written in {os.listdir(d)}"
    lines = open(os.path.join(d, csvs[-1])).read().splitlines()
    assert lines[0].split(";")[:4] == ["Idp", "Pos.x [m]", "Pos.y [m]",
                                      "Pos.z [m]"]
    rows = np.loadtxt(os.path.join(d, csvs[-1]), delimiter=";", skiprows=1)
    assert rows.shape[1] == 9
    assert (np.diff(rows[:, 0]) > 0).all()      # sorted by Idp
    # every particle inside the fixed domain box
    assert rows[:, 1].min() >= -0.5 and rows[:, 1].max() <= 4.5
    assert rows[:, 3].min() >= -0.5 and rows[:, 3].max() <= 5.0


def test_cli_cellmode_half_rejected():
    """-cellmode:half must be rejected loudly (by-design: windows are
    already kernel-radius-trimmed at sub-cell granularity), never a silent
    no-op."""
    with pytest.raises(SystemExit, match="cellmode:half"):
        cli.main(["-builtin", "dambreak2d", "-dp", "0.09",
                  "-cellmode:half", "-tmax:0.001", "-tout:0.001",
                  "-sv:none"])
