"""Command-line entry point.

The analog of the reference `main.cpp` + `JSphCfgRun` (flag surface
`JSphCfgRun.cpp:85-208`): loads a case (DualSPHysics XML, a restart PART, or
a built-in benchmark case), merges CLI overrides, runs the solver, writes
bi4/VTK/CSV output, and prints the run resume.

    dsphjax -case examples/CaseDambreak_Def.xml -dirout out -sv:vtk
    dsphjax -builtin dambreak3d -dp 0.01 -tmax:1.6 -tout:0.02
    dsphjax -case ... -partbegin:20 out_prev   # restart

Reference colon-form flags (-tmax:1.6, -partbegin:20 dir, -svpips:2) are
accepted alongside space-separated values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# flags that take a value and may appear in the reference's colon form
_COLON_FLAGS = {
    "gpu",
    "tmax", "tout", "cfl", "dp", "ddt", "ddtvalue", "shifting", "verlet",
    "rhopout", "svpips", "ftpause", "domain_fixed", "cellmode",
    "mdbc_threshold", "csvsep", "createdirs", "nsteps", "partbegin",
    "viscoart", "viscolamsps", "viscoboundfactor", "sv", "ompthreads",
    "savedt", "initnorpla", "initnorpart", "ddtramp", "svextraparts",
    "saveposdouble", "shard",
}
# flags that are boolean but may carry :0/:1
_BOOL_FLAGS = {"svres", "svtimers", "svdomainvtk", "svsteps", "nortimes",
               "createdirs", "svnormals", "cellfixed", "restartchrono",
               "mdbc_fast", "stable"}


def _normalize(argv):
    """Expand -opt response files and split reference colon-form flags."""
    out = []
    i = 0
    argv = list(argv)
    while i < len(argv):
        a = argv[i]
        if a == "-opt":
            i += 1
            with open(argv[i]) as f:
                argv[i + 1:i + 1] = f.read().split()
        elif a.startswith("-") and ":" in a[1:]:
            name, val = a[1:].split(":", 1)
            if name in _COLON_FLAGS:
                # "=" form so values starting with "-" (negative domain
                # coordinates) are not mistaken for options by argparse
                out.append(f"-{name}={val}")
            elif name in _BOOL_FLAGS:
                out.extend([f"-{name}"] if val not in ("0", "false")
                           else [])
            else:
                out.append(a)   # e.g. -sv:binx handled by argparse value
        else:
            out.append(a)
        i += 1
    return out


def _use_gpu(gid: str) -> None:
    """-gpu[:id]: run on GPU card ``id``.  Rejects ids that do not exist;
    must run before the first backend touch."""
    import jax
    try:
        idx = int(gid or 0)
    except ValueError:
        raise SystemExit(f"-gpu:{gid}: the card id must be an integer")
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        raise SystemExit(f"-gpu:{gid}: JAX finds no GPU")
    if not 0 <= idx < len(devs):
        raise SystemExit(f"-gpu:{gid}: no such card (JAX sees "
                         f"{len(devs)} GPU(s), ids 0..{len(devs) - 1})")
    jax.config.update("jax_default_device", devs[idx])


def build_parser():
    p = argparse.ArgumentParser(
        prog="dsphjax",
        description="SPH solver in JAX (DualSPHysics-capability rebuild)")
    p.add_argument("-cpu", action="store_true",
                   help="run on CPU (reference -cpu, JSphCfgRun.cpp:93)")
    p.add_argument("-gpu", nargs="?", const="0", default=None,
                   help="run on GPU card [:id] (reference -gpu[:id])")
    p.add_argument("-case", help="DualSPHysics case XML (*_Def.xml)")
    p.add_argument("-builtin", help="built-in case: dambreak2d dambreak3d "
                                    "floatingbox2d waveflume2d channel2d")
    p.add_argument("-dp", type=float, default=0.0, help="override dp (builtin)")
    p.add_argument("-name", default=None, help="case name override")
    p.add_argument("-runname", default=None, help="run name (Run.csv)")
    p.add_argument("-dirout", default="out", help="output directory")
    p.add_argument("-dirdataout", default="",
                   help="subdirectory for PART data (reference default "
                        "'data'; empty = directly in dirout)")
    p.add_argument("-tmax", type=float, default=None)
    p.add_argument("-tout", type=float, default=None)
    p.add_argument("-symplectic", action="store_true")
    p.add_argument("-verlet", type=int, nargs="?", const=40, default=None,
                   metavar="STEPS")
    p.add_argument("-wendland", action="store_true")
    p.add_argument("-cubic", action="store_true")
    p.add_argument("-viscoart", type=float, default=None, metavar="V")
    p.add_argument("-viscolamsps", type=float, default=None, metavar="V")
    p.add_argument("-viscoboundfactor", type=float, default=None)
    p.add_argument("-ddt", type=int, default=None, choices=[0, 1, 2, 3])
    p.add_argument("-ddtvalue", type=float, default=None)
    p.add_argument("-ddtramp", default=None, metavar="TRAMP:TMAX:MAXVALUE",
                   help="initial DDT ramp: total ramp time, time at "
                        "maxvalue, maxvalue (reference -ddtramp, "
                        "RunInitialDDTRamp JSphCpuSingle.cpp:650)")
    p.add_argument("-shifting", type=int, default=None, choices=[0, 1, 2, 3])
    p.add_argument("-dbc", action="store_true", help="force classic DBC")
    p.add_argument("-mdbc", action="store_true")
    p.add_argument("-mdbc_noslip", action="store_true")
    p.add_argument("-mdbc_freeslip", action="store_true")
    p.add_argument("-mdbc_fast", action="store_true",
                   help="accepted for compatibility (single-precision ghost "
                        "solve is already the default)")
    p.add_argument("-mdbc_threshold", type=float, default=None)
    p.add_argument("-cfl", type=float, default=None)
    p.add_argument("-ftpause", type=float, default=None)
    p.add_argument("-rhopout", default=None, metavar="MIN:MAX")
    p.add_argument("-domain_fixed", default=None,
                   metavar="XMIN:YMIN:ZMIN:XMAX:YMAX:ZMAX",
                   help="fix the simulation domain limits")
    p.add_argument("-cellmode", default=None, choices=["full", "half"],
                   help="cell size 2h (full) or h (half)")
    p.add_argument("-cellfixed", action="store_true",
                   help="accepted for compatibility: the cell domain is "
                        "always fixed (static shapes, SURVEY §7)")
    p.add_argument("-stable", action="store_true",
                   help="accepted for compatibility: XLA runs are "
                        "deterministic by construction (SURVEY §5.2)")
    p.add_argument("-ompthreads", type=int, default=None,
                   help="accepted for compatibility (host thread count)")
    p.add_argument("-sv", default="binx",
                   help="output formats: binx,info,vtk,csv,none (comma list)")
    p.add_argument("-svres", action="store_true", default=True,
                   help="write Run.csv summary (default on)")
    p.add_argument("-no-svres", dest="svres", action="store_false")
    p.add_argument("-svtimers", action="store_true",
                   help="write per-interval timing CSV")
    p.add_argument("-shard", type=int, nargs="?", const=0, default=None,
                   help="run domain-decomposed over the device mesh "
                        "(-shard:N limits to N devices; default all)")
    p.add_argument("-svpips", type=int, nargs="?", const=1, default=None,
                   metavar="MODE", help="compute PIPS throughput metric")
    p.add_argument("-svdomainvtk", action="store_true",
                   help="write the domain box as VTK")
    p.add_argument("-svnormals", action="store_true",
                   help="save per-PART boundary-normal VTK "
                        "(SaveVtkNormals, JSphCpuSingle.cpp:1177)")
    p.add_argument("-saveposdouble", type=int, nargs="?", const=1, default=1,
                   metavar="0/1",
                   help="PART position precision: 1=double (default here; "
                        "restart-exact), 0=float (the reference default)")
    p.add_argument("-svextraparts", default="", metavar="N|LIST",
                   help="PART cadence for extra data (mDBC normals .ebi4): "
                        "interval N or a range list '2,10-20' "
                        "(JDsExtraDataSave::Config)")
    p.add_argument("-svsteps", action="store_true",
                   help="debug: save a PART every step")
    p.add_argument("-nortimes", action="store_true",
                   help="strip wall-clock times from bi4 (byte-diffable "
                        "outputs, reference -nortimes)")
    p.add_argument("-savedt", type=int, nargs="?", const=4096, default=None,
                   metavar="CAP", help="record per-dt diagnostics (SaveDt.csv)")
    p.add_argument("-createdirs", type=int, default=1)
    p.add_argument("-csvsep", type=int, default=0,
                   help="CSV separator: 0=semicolon 1=comma")
    p.add_argument("-partbegin", default=None, metavar="N[:FIRST]",
                   help="restart from PART N (directory: -restartdir or "
                        "the next positional token)")
    p.add_argument("-restartdir", default=None,
                   help="directory holding the restart PART files")
    p.add_argument("-restartchrono", action="store_true",
                   help="allow restart with Chrono-coupled bodies (the "
                        "reference refuses by default: Chrono contact state "
                        "is not in the PART files)")
    p.add_argument("-nsteps", type=int, default=None,
                   help="debug: stop after N steps")
    p.add_argument("-initnorpla", action="append", default=[],
                   metavar="mkbound=..:normal=x:y:z[:point=..]",
                   help="assign plane boundary normals (JDsInitialize from "
                        "CLI, JSphCfgRun.cpp:162)")
    p.add_argument("-initnorpart", action="append", default=[],
                   metavar="mkbound=..[:maxdisth=v]",
                   help="compute boundary normals from the particle "
                        "distribution")
    p.add_argument("-ver", action="store_true", help="print version and exit")
    p.add_argument("-info", action="store_true",
                   help="print features/hardware JSON and exit")
    p.add_argument("rest", nargs="*", help=argparse.SUPPRESS)
    return p


def load_dsphconfig(paths=None):
    """Machine-level DsphConfig.xml defaults (JDsphConfig: the reference
    reads it next to the binary, `bin/linux/DsphConfig.xml`): here next to
    the package, in cwd, or at $DSPHCONFIG.  Returns {} when absent."""
    import xml.etree.ElementTree as ET
    cand = paths or [
        os.environ.get("DSPHCONFIG", ""),
        os.path.join(os.getcwd(), "DsphConfig.xml"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "DsphConfig.xml"),
    ]
    for p in cand:
        if p and os.path.isfile(p):
            root = ET.parse(p).getroot()
            com = root.find("common")
            out = {}
            if com is not None:
                for tag, key in (("createdirs", "createdirs"),
                                 ("csvseparator", "csvsep")):
                    el = com.find(tag)
                    if el is not None and el.get("v") is not None:
                        out[key] = int(float(el.get("v")))
            return out
    return {}


def main(argv=None):
    from .utils.compilecache import enable_cache
    enable_cache()
    argv = _normalize(sys.argv[1:] if argv is None else argv)
    parser = build_parser()
    dcfg = load_dsphconfig()
    if dcfg:
        parser.set_defaults(**dcfg)
    args = parser.parse_args(argv)
    if args.cpu:
        # must precede the first backend touch
        import jax as _jx
        _jx.config.update("jax_platforms", "cpu")
    elif args.gpu is not None:
        _use_gpu(args.gpu)
    import dualsphysics_multilayer as dsph
    if args.ver:
        print(json.dumps({
            "name": "dualsphysics_multilayer",
            "version": dsph.__version__,
            "features": ["wcsph", "dbc", "mdbc", "verlet", "symplectic",
                         "wendland", "cubic", "ddt", "shifting",
                         "laminar+sps", "floating", "motion", "damping",
                         "accinput", "gauges", "bi4", "vtk", "restart",
                         "sharding", "gpu-kernel"]}))
        return 0
    if args.info:
        # the analog of the reference's -info feature report (main.cpp:102-133)
        import jax as _jax
        devs = _jax.devices()
        print(json.dumps({
            "name": "dualsphysics_multilayer",
            "version": dsph.__version__,
            "features": {
                "solvers": ["wcsph", "nnewtonian-multiphase"],
                "kernels": ["wendland", "cubic"],
                "steps": ["symplectic", "verlet"],
                "viscosity": ["artificial", "laminar+sps", "consteq-hbp"],
                "ddt": ["none", "molteni", "fourtakas", "fourtakas-full"],
                "boundary": ["dbc", "mdbc(vel0,noslip,freeslip)"],
                "open_boundaries": ["periodic", "inlet/outlet"],
                "bodies": ["floating-6dof", "dem", "moordyn-lumped-mass",
                           "forcepoints"],
                "waves": ["piston(1st/2nd,ramp,awas)", "flap-theory",
                          "irregular(jonswap/pm)", "solitary", "focused",
                          "relaxation-zones(regular/spectrum/external/"
                          "uniform)", "multilayer-piston-1d/2d",
                          "inout-awas"],
                "io": ["bi4", "vtk", "csv", "restart", "savedt", "xml-case",
                       "fbi4", "obi4", "parthead", "run-csv"],
                "tools": ["gencase", "partvtk", "partvtkout", "measuretool",
                          "isosurface", "computeforces", "floatinginfo",
                          "boundaryvtk", "tracerparts", "flowtool",
                          "bifileinfo", "readswash"],
                "scaling": ["gpu-force-kernel", "mesh-domain-sharding"],
            },
            "backend": _jax.default_backend(),
            "devices": [str(d) for d in devs],
        }, indent=1))
        return 0

    import jax
    from .models import cases as C
    from .models.wcsph import Simulation
    from .io.output import OutputManager, OutputTime, restart_state
    from .ops.forces import SolverOpts
    from .typesdef import (TpBoundary, TpDensity, TpKernel, TpShifting,
                           TpSlipMode, TpStep, TpVisco)

    # ---- load case ----------------------------------------------------------
    if args.case:
        from .io.xmlcase import load_case
        case, opts, run = load_case(args.case, mdbc=args.mdbc)
    elif args.builtin:
        kw = {}
        if args.dp:
            kw["dp"] = args.dp
        builder = getattr(C, args.builtin)
        if args.builtin == "dambreak2d" and args.mdbc:
            kw["mdbc"] = True
        case = builder(**kw)
        opts = SolverOpts(tdensity=TpDensity.FOURTAKAS)
        run = dict(tmax=1.0, tout=0.05)
    else:
        print("error: give -case <xml> or -builtin <name>", file=sys.stderr)
        return 2

    # ---- CLI overrides (JSph::LoadConfigCommands analog) ---------------------
    csp = case.csp
    oc = {}
    if args.verlet is not None:
        oc.update(tstep=TpStep.VERLET, verlet_steps=args.verlet)
    if args.symplectic:
        oc.update(tstep=TpStep.SYMPLECTIC)
    if args.viscoart is not None:
        oc.update(tvisco=TpVisco.ARTIFICIAL)
        csp = csp.replace(visco=args.viscoart)
    if args.viscolamsps is not None:
        oc.update(tvisco=TpVisco.LAMINAR_SPS)
        csp = csp.replace(visco=args.viscolamsps)
    if args.ddt is not None:
        oc.update(tdensity=TpDensity(args.ddt))
    if args.shifting is not None:
        oc.update(shiftmode=TpShifting(args.shifting))
    if args.dbc:
        oc.update(tboundary=TpBoundary.DBC)
    if args.mdbc or args.mdbc_noslip or args.mdbc_freeslip:
        slip = (TpSlipMode.NO_SLIP if args.mdbc_noslip
                else TpSlipMode.FREE_SLIP if args.mdbc_freeslip
                else TpSlipMode.VEL0)
        oc.update(tboundary=TpBoundary.MDBC, slipmode=slip)
    if args.mdbc_threshold is not None:
        oc.update(mdbc_threshold=args.mdbc_threshold)
    if args.savedt is not None:
        oc.update(savedt=args.savedt)
    opts = dataclasses.replace(opts, **oc)
    if args.wendland:
        csp = csp.replace(tkernel=TpKernel.WENDLAND)
    if args.cubic:
        csp = csp.replace(tkernel=TpKernel.CUBIC)
    if args.viscoboundfactor is not None:
        csp = csp.replace(viscoboundfactor=args.viscoboundfactor)
    if args.cfl is not None:
        csp = csp.replace(cflnumber=args.cfl)
    if args.rhopout:
        lo, hi = args.rhopout.split(":")
        csp = csp.replace(rhopoutmin=float(lo), rhopoutmax=float(hi))
    if args.ddtvalue is not None:
        csp = csp.replace(ddtvalue=args.ddtvalue,
                          ddtkh=csp.kernelsize * args.ddtvalue)
    if args.ddtramp:
        # -ddtramp:tramp:tmax:maxvalue (validation per JSphCfgRun.cpp:349-353)
        v = [float(x) for x in args.ddtramp.split(":")]
        tramp, tmaxv, vmax = (v + [0.0, 0.0, 0.0])[:3]
        if tramp > 0 and vmax > 0:
            opts = dataclasses.replace(
                opts, ddtramp=(tramp, min(tmaxv, tramp), vmax))
    dom = case.dom
    if args.domain_fixed:
        # -domain_fixed:xmin:ymin:zmin:xmax:ymax:zmax (JSphCfgRun.cpp:176):
        # rebuild the cell grid over the fixed box (nc recomputed) keeping
        # the case grid's cell size/capacity
        f = [float(x) for x in args.domain_fixed.split(":")]
        if len(f) != 6 or any(f[i + 3] <= f[i] for i in range(3)):
            raise SystemExit("-domain_fixed needs xmin:ymin:zmin:xmax:ymax:"
                             "zmax with max > min on every axis")
        from .ops import celldiv as _cd
        dom = _cd.make_domain(tuple(f[:3]), tuple(f[3:6]),
                              dom.scell, simulate2d=dom.simulate2d,
                              cellcap=dom.cellcap, maxcells=dom.maxcells)
    if args.cellmode == "half":
        # By-design rejection, not a silent no-op: half cells trade memory
        # for tighter candidate ranges (reference TpCellMode,
        # DualSphDef.h:477-481), but the bucket layout pads every cell to
        # its capacity and the kernel's ranges span whole cells, so both
        # would pay for 5x5 neighbour cells instead of 3x3.
        raise SystemExit(
            "-cellmode:half is not supported: the cell layouts are built "
            "on full cells (cell side = kernel size); use -cellmode:full")
    tmax = args.tmax if args.tmax is not None else run["tmax"]
    tout = args.tout if args.tout is not None else run["tout"]
    tsched = run.get("tout_table")
    if args.svsteps:
        tout = 1e-9     # a PART every step (debug -svsteps)
    elif args.tout is None and tsched is not None:
        tout = OutputTime(tsched)

    st = case.state
    t0 = 0.0
    if args.partbegin is not None:
        _f = case.meta.get("features")
        if _f is not None and _f.inout is not None:
            # reference restriction (JSphCpuSingle_InOut.cpp:76)
            raise SystemExit("Restart with inlet/outlet conditions is not "
                             "allowed.")
        if (_f is not None and getattr(_f, "chrono", None) is not None
                and not args.restartchrono):
            # reference -restartchrono gate (JSph.cpp RestartCheckData)
            raise SystemExit("Restart with active Chrono coupling needs "
                             "-restartchrono:1 (contact state is not saved "
                             "in the PART files).")
        from .io.partdata import part_filename
        pb = str(args.partbegin).split(":")[0]
        pdir = args.restartdir or (args.rest[0] if args.rest else args.dirout)
        path = os.path.join(pdir, part_filename(int(pb)))
        st, t0, _ = restart_state(path, st)
        print(f"restart from {path} at t={t0:.6f}")

    if args.initnorpla or args.initnorpart:
        from .features.initialize import apply_initialize, parse_initnor_cli
        ops = []
        for spec in args.initnorpla:
            ops.extend(parse_initnor_cli(spec, kind="plane"))
        for spec in args.initnorpart:
            ops.extend(parse_initnor_cli(spec, kind="parts"))
        st = apply_initialize(ops, csp, st)
        opts = dataclasses.replace(opts, tboundary=TpBoundary.MDBC)

    feats = case.meta.get("features")
    if feats is None and ("ftcfg" in case.meta or "motion" in case.meta):
        from .features.featureset import Features
        feats = Features(
            motions=(case.meta["motion"],) if "motion" in case.meta else (),
            floating=case.meta.get("ftcfg"))
    if feats is not None and feats.floating is not None:
        if args.ftpause is not None:
            feats = dataclasses.replace(
                feats, floating=dataclasses.replace(
                    feats.floating, ftpause=args.ftpause))
        opts = dataclasses.replace(opts, with_floating=True)

    step = None
    path = None
    phases = case.meta.get("phases")
    if phases is not None:
        # multiphase NN case (<special><nnphases>): the NN step family runs
        # the bucket pipeline (ops/forces_nn.py) on every platform
        from .models.nnewtonian import make_nn_step
        step = make_nn_step(csp, opts, dom, phases)
        path = "bucket"
    if args.shard is not None:
        # -shard[:n]: domain decomposition over the device mesh (the
        # multi-device mode the reference reserves but never shipped,
        # SURVEY §2.8); NN cases run the sharded NN pipeline (2-cell halo)
        from .parallel.sharding import ShardedSimulation
        sim = ShardedSimulation(csp, opts, dom, st, feats=feats,
                                ndev=args.shard or 0, phases=phases)
        print(f"[dsphjax] sharded over {sim.cfg.ndev} device(s)")
    else:
        sim = Simulation(csp, opts, dom, st, feats=feats, step=step,
                         path=path)
    sim.time = t0
    sim.errdir = args.dirout
    pom = run.get("partsoutmax")
    if pom is not None and pom < 1.0:
        sim.partsoutmax = pom
    sv = set(args.sv.split(","))
    on_save = None
    datadir = os.path.join(args.dirout, args.dirdataout) \
        if args.dirdataout else args.dirout
    gsys = None
    if case.meta.get("gauges"):
        # <special><gauges> probes, drained to Gauge_*.csv; per-gauge
        # <computedt> ticks break the device loop in-interval (JGaugeSystem,
        # JDsGaugeSystem.cpp:447; default computedt = TimeOut, §2.13)
        from .features.gauges import GaugeSystem
        gsys = GaugeSystem(csp, dom, case.meta["gauges"],
                           windows=case.meta.get("gauge_windows"),
                           computedts=case.meta.get("gauge_computedts"))
    if sv - {"none"}:
        on_save = OutputManager(datadir, case, save_vtk="vtk" in sv,
                                save_info="info" in sv, feats=feats,
                                casename=args.name, nortimes=args.nortimes,
                                posdouble=bool(args.saveposdouble),
                                extraparts=args.svextraparts,
                                svnormals=args.svnormals, gauges=gsys,
                                save_csv="csv" in sv,
                                csvsep=";" if args.csvsep == 0 else ",")
        if run.get("ftmotion_tout") is not None:
            on_save.ftmotion_tout = run["ftmotion_tout"]
    if args.svdomainvtk and on_save is not None:
        from .io import vtkout
        import numpy as np
        lo, hi = np.asarray(dom.posmin), np.asarray(dom.posmax)
        corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                            [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                            [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                            [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                           np.float32)
        edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                 (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
        vtkout.write_vtk_mesh(os.path.join(args.dirout, "Domain.vtk"),
                              corners, lines=[np.array(e) for e in edges])

    from .utils.runinfo import TerminateCheck
    terminate = TerminateCheck(args.dirout) if on_save is not None else None

    print(f"[dsphjax] case={case.meta.get('name')} np={case.np_total} "
          f"dp={csp.dp:g} h={csp.kernelh:g} cs0={csp.cs0:g} "
          f"backend={jax.default_backend()} "
          f"device={jax.devices()[0].device_kind} path={sim.path}")
    # resolved-configuration record (the reproducibility dump of
    # JSph::VisuConfig, JSph.cpp:1463-1614) -> Run.out
    try:
        from .utils.log import RunLog
        rlog = RunLog(args.dirout, echo=False)
        rlog.print("[VisuConfig] resolved run configuration:")
        for k in ("dp", "kernelh", "kernelsize", "cs0", "cteb", "gamma",
                  "rhopzero", "massfluid", "massbound", "visco",
                  "viscoboundfactor", "cflnumber", "dtini", "dtmin",
                  "ddtvalue", "ddtkh", "eta2", "gravity", "simulate2d",
                  "rhopoutmin", "rhopoutmax", "shiftcoef", "shifttfs"):
            rlog.print(f"  {k}={getattr(csp, k, None)}")
        for k in ("tstep", "tvisco", "tdensity", "tboundary", "slipmode",
                  "shiftmode", "velgrad", "symmetry",
                  "use_nbrlist", "with_floating", "verlet_steps",
                  "relaxationdt"):
            rlog.print(f"  {k}={getattr(opts, k, None)}")
        rlog.print(f"  path={sim.path}")
        rlog.print(f"  np={case.np_total} npb={case.npb} tmax={tmax:g} "
                   f"domain={dom.posmin}..{dom.posmax} cells={dom.nc} "
                   f"cellcap={dom.cellcap}")
    except OSError:
        pass
    wall0 = time.time()
    timers_rows = [] if args.svtimers else None
    if timers_rows is not None:
        orig_on_save = on_save
        last = [wall0, 0]

        def on_save_timed(s):
            now = time.time()
            nstep = int(s.carry.nstep)
            timers_rows.append([s.part, f"{s.time:.6f}", nstep - last[1],
                                f"{now - last[0]:.4f}"])
            last[0], last[1] = now, nstep
            if orig_on_save:
                orig_on_save(s)

        on_save = on_save_timed
    next_subtick = on_subtick = None
    if gsys is not None and gsys.computedts:
        next_subtick = gsys.next_time

        def on_subtick(s, t_abs):
            gsys.run(t_abs, s.state, at_save=False)

    sim.run(tmax=tmax, tout=tout, on_save=on_save, max_steps=args.nsteps,
            terminate=terminate, next_subtick=next_subtick,
            on_subtick=on_subtick)
    wall = time.time() - wall0
    nstep = int(sim.carry.nstep)
    psps = case.np_total * nstep / max(wall, 1e-9)
    print(f"[dsphjax] done: t={sim.time:.6g} steps={nstep} "
          f"wall={wall:.1f}s ({psps:.3g} "
          f"particle-steps/s) parts={sim.part} dtmodif={int(sim.carry.dtmodif)}")
    sep = ";" if args.csvsep == 0 else ","
    if timers_rows:
        with open(os.path.join(args.dirout, "Timers.csv"), "w") as f:
            f.write(sep.join(["Part", "Time", "Steps", "WallSeconds"]) + "\n")
            for r in timers_rows:
                f.write(sep.join(str(x) for x in r) + "\n")
    if args.svpips is not None:
        from .utils.pips import pips_report
        rep = pips_report(csp, dom, sim.state, wall / max(nstep, 1))
        with open(os.path.join(args.dirout, "PIPS.csv"), "w") as f:
            f.write(sep.join(rep.keys()) + "\n")
            f.write(sep.join(str(v) for v in rep.values()) + "\n")
        print(f"[dsphjax] PIPS: {rep}")
    if args.svres and sv - {"none"}:
        from .utils.runinfo import save_res
        save_res(args.dirout,
                 runname=args.runname or case.meta.get("name", "run"),
                 appname=f"dsphjax-{dsph.__version__}",
                 casenp=case.np_total, tsim=sim.time, ttot=wall,
                 timestep=sim.time, nstep=nstep, part=sim.part,
                 nout=0, maxparticles=case.np_total,
                 maxcells=getattr(dom, "ncells", 0),
                 nbound=0, nfixed=0, dp=csp.dp, kernelh=csp.kernelh,
                 runmode=f"{jax.default_backend()}-{sim.path}",
                 configinfo=f"tstep={opts.tstep.name}",
                 csvsep=sep)
    return 0


if __name__ == "__main__":
    sys.exit(main())
