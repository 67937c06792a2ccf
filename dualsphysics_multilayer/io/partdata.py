"""PART snapshot files (.bi4) + run metadata, DualSPHysics-layout-compatible.

Mirrors `JPartDataBi4` (`/root/reference/src/source/JPartDataBi4.cpp`): the
root item "JPartDataBi4" carries the case config values (ConfigBasic
:JPartDataBi4.cpp:160, ConfigParticles :203, ConfigCtes :233, ConfigSimMap
:243, ConfigSimPeri/Div) and one "PART_%04u" child item with the AddPartInfo
values (:305) and the particle arrays Idp/Pos/Vel/Rhop (:360-372) — so PART
files written here carry the same structure the stock post-processing tools
(PartVTK, MeasureTool, ...) consume, and files produced by GenCase /
DualSPHysics load back through :func:`read_part`.

Every PART file is a full checkpoint (SURVEY §5.4): :func:`read_part` +
`Simulation`'s restart path reproduce the reference's `-partbegin` contract.
"""

from __future__ import annotations

import datetime
import os

import numpy as np

from . import jbinary as jb
from .. import typesdef as td


def part_filename(cpart, piece=0, npiece=1):
    """`JPartDataBi4::GetFileNamePart` naming ("Part_0001.bi4")."""
    return f"Part_{cpart:04d}.bi4"


class PartWriter:
    """Writes Part_XXXX.bi4 snapshots (the analog of JSph::SavePartData,
    JSph.cpp:2581)."""

    def __init__(self, dirout, csp, *, casename="case", appname=None,
                 np_total=0, nfixed=0, nmoving=0, nfloat=0, nfluid=0,
                 posmin=(0, 0, 0), posmax=(0, 0, 0), nortimes=False,
                 posdouble=True):
        self.posdouble = posdouble
        # nortimes: strip wall-clock values so outputs are byte-diffable
        # (the reference's -nortimes debug flag, JSphCfgRun.cpp:206)
        self.nortimes = nortimes
        self.dirout = dirout
        os.makedirs(dirout, exist_ok=True)
        self.csp = csp
        self.casename = casename
        self.appname = appname or "dualsphysics_multilayer"
        self.counts = (np_total, nfixed, nmoving, nfloat, nfluid)
        self.posmin, self.posmax = posmin, posmax

    def _config_root(self, root):
        csp = self.csp
        root.set_uint("Piece", 0)
        root.set_uint("Npiece", 1)
        root.set_text("RunCode", "jax")
        root.set_text("Date", "" if self.nortimes
                      else datetime.datetime.now().isoformat(" ")[:19])
        root.set_text("AppName", self.appname)
        root.set_text("CaseName", self.casename)
        root.set_bool("Data2d", csp.simulate2d)
        root.set_double("Data2dPosY", 0.0)
        root.set_double3("MapPosMin", self.posmin)
        root.set_double3("MapPosMax", self.posmax)
        root.set_int("PeriMode", 0)
        root.set_double3("PeriXinc", (0, 0, 0))
        root.set_double3("PeriYinc", (0, 0, 0))
        root.set_double3("PeriZinc", (0, 0, 0))
        root.set_int("AxisDiv", 0)
        npt, nfx, nmv, nft, nfl = self.counts
        root.set_ullong("CaseNp", npt)
        root.set_ullong("CaseNfixed", nfx)
        root.set_ullong("CaseNmoving", nmv)
        root.set_ullong("CaseNfloat", nft)
        root.set_ullong("CaseNfluid", nfl)
        root.set_double3("CasePosMin", self.posmin)
        root.set_double3("CasePosMax", self.posmax)
        root.set_bool("NpDynamic", False)
        root.set_bool("ReuseIds", False)
        root.set_double("Dp", csp.dp)
        root.set_double("H", csp.kernelh)
        root.set_double("B", csp.cteb)
        root.set_double("Rhop0", csp.rhopzero)
        root.set_double("Gamma", csp.gamma)
        root.set_double("MassBound", csp.massbound)
        root.set_double("MassFluid", csp.massfluid)

    def save(self, cpart, timestep, state, *, nstep=0, runtime=0.0,
             extra_arrays=None):
        """Write one PART from a SimState (host-side; drains live particles
        only, like the reference's NpbOk+Npf staging)."""
        pos = np.asarray(state.pos)
        vel = np.asarray(state.vel)
        rho = np.asarray(state.rho)
        idp = np.asarray(state.idp)
        code = np.asarray(state.code)
        live = ((code >> td.CODE_SPECIAL_SHIFT) & td.CODE_SPECIAL_MASK) \
            < td.SPECIAL_OUT_POS
        # stable id order like the reference's PART output
        sel = np.where(live)[0]
        sel = sel[np.argsort(idp[sel])]
        npok = len(sel)

        root = jb.JItem(name="JPartDataBi4")
        self._config_root(root)
        part = root.child(f"PART_{cpart:04d}")
        part.set_uint("Cpart", cpart)
        part.set_double("TimeStep", float(timestep))
        part.set_uint("Npok", npok)
        part.set_uint("Nout", int((~live).sum()))
        part.set_uint("Step", int(nstep))
        part.set_double("RunTime", 0.0 if self.nortimes else float(runtime))
        part.set_double3("DomainMin", tuple(pos[sel].min(0)) if npok else (0,) * 3)
        part.set_double3("DomainMax", tuple(pos[sel].max(0)) if npok else (0,) * 3)
        part.add_array("Idp", jb.UINT, idp[sel].astype(np.uint32))
        # reference naming: "Pos" is float3, doubles go in "Posd"
        # (JPartDataBi4::AddPartData, JPartDataBi4.cpp:360-372).  Default is
        # double (restart-exact); -saveposdouble:0 selects the reference's
        # float default (JSph.cpp:2011 warns restart from float drifts).
        if self.posdouble:
            part.add_array("Posd", jb.DOUBLE3, pos[sel].astype(np.float64))
        else:
            part.add_array("Pos", jb.FLOAT3, pos[sel].astype(np.float32))
        part.add_array("Vel", jb.FLOAT3, vel[sel].astype(np.float32))
        part.add_array("Rhop", jb.FLOAT, rho[sel].astype(np.float32))
        # typecode array for exact restart (framework extension)
        part.add_array("Code", jb.UINT, code[sel].astype(np.uint32))
        if extra_arrays:
            for name, (typ, arr) in extra_arrays.items():
                part.add_array(name, typ, np.asarray(arr)[sel])
        path = os.path.join(self.dirout, part_filename(cpart))
        jb.write_file(path, root, filecode="JPartDataBi4")
        return path


def read_part(path):
    """Load a PART/case .bi4 (ours or DualSPHysics/GenCase).  Returns a dict
    with config values and particle arrays (the JPartsLoad4::LoadParticles
    contract, JPartsLoad4.cpp:151)."""
    root = jb.read_file(path)
    if root.name != "JPartDataBi4":
        raise ValueError(f"{path}: unexpected root item {root.name}")
    part = None
    for it in root.items:
        if it.name.startswith("PART_") or it.name == "Case":
            part = it
            break
    if part is None and root.items:
        part = root.items[0]
    if part is None:
        raise ValueError(f"{path}: no PART item found")

    def arr(name, alt=None):
        a = part.array(name) or (part.array(alt) if alt else None)
        return None if a is None else a.data

    pos = arr("Pos", "Posd")
    if pos is None:
        # split double2+double encoding (GPU runs): Posxy + Posz
        pxy, pz = arr("Posxy"), arr("Posz")
        if pxy is not None:
            pos = np.column_stack([pxy[:, 0], pxy[:, 1], pz])
    out = dict(
        casename=root.get("CaseName"),
        data2d=bool(root.get("Data2d", False)),
        counts={k: int(root.get(k, 0)) for k in
                ("CaseNp", "CaseNfixed", "CaseNmoving", "CaseNfloat",
                 "CaseNfluid")},
        ctes={k: root.get(k) for k in
              ("Dp", "H", "B", "Rhop0", "Gamma", "MassBound", "MassFluid")},
        mapposmin=root.get("MapPosMin"),
        mapposmax=root.get("MapPosMax"),
        cpart=int(part.get("Cpart", 0)),
        timestep=float(part.get("TimeStep", 0.0)),
        nstep=int(part.get("Step", 0)),
        npok=int(part.get("Npok", 0)),
        idp=arr("Idp", "Idpd"),
        pos=pos,
        vel=arr("Vel"),
        rhop=arr("Rhop"),
        code=arr("Code"),
    )
    return out
