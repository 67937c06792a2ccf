"""Floating-body history (PartFloat.fbi4), excluded-particle stream
(PartOut_000.obi4) and run metadata head (Part_Head.ibi4) channels.

Format layouts follow the reference writers:
* fbi4 — `JPartFloatBi4.cpp:246-334`: root "JPartFloatBi4" with FormatVer,
  FtCount + head arrays (mkbound/begin/count/mass/massp/radius) and one
  "PART_xxxx" child per save carrying center(double3), fvel/fomega(float3),
  facelin/faceang(float3).
* obi4 — `JPartOutBi4Save.cpp:124-204`: per-PART items with Idp/Posd/Vel/
  Rhop + Motive (1=pos out, 2=rhop out, 3=move out).
* Part_Head.ibi4 — `JPartDataHead.cpp:211-271`: run constants + the MkBlocks
  table used by restart validation (`JSph::RestartCheckData` JSph.cpp:1993).
"""

from __future__ import annotations

import os

import numpy as np

from . import jbinary as jb

MOTIVE_NONE, MOTIVE_POS, MOTIVE_RHOP, MOTIVE_MOVE = 0, 1, 2, 3


class FloatBi4Writer:
    """Accumulates floating-body state per PART and (re)writes
    PartFloat.fbi4 (the reference appends to the same single file)."""

    def __init__(self, dirout, *, mkbound, begin, count, mass, massp,
                 radius=None, filename="PartFloat.fbi4"):
        self.path = os.path.join(dirout, filename)
        self.n = len(mkbound)
        self.head = dict(
            mkbound=np.asarray(mkbound, np.uint16),
            begin=np.asarray(begin, np.uint32),
            count=np.asarray(count, np.uint32),
            mass=np.asarray(mass, np.float32),
            massp=np.asarray(massp, np.float32),
            radius=np.asarray(radius if radius is not None
                              else np.zeros(self.n), np.float32))
        self.parts = []

    def save_part(self, cpart, timestep, *, center, fvel, fomega,
                  facelin=None, faceang=None, step=0, demdtforce=0.0,
                  flush=True):
        zeros = np.zeros((self.n, 3), np.float32)
        self.parts.append(dict(
            cpart=int(cpart), step=int(step), timestep=float(timestep),
            demdtforce=float(demdtforce),
            center=np.asarray(center, np.float64).reshape(self.n, 3),
            fvel=np.asarray(fvel, np.float32).reshape(self.n, 3),
            fomega=np.asarray(fomega, np.float32).reshape(self.n, 3),
            facelin=(np.asarray(facelin, np.float32).reshape(self.n, 3)
                     if facelin is not None else zeros),
            faceang=(np.asarray(faceang, np.float32).reshape(self.n, 3)
                     if faceang is not None else zeros)))
        if flush:
            self._flush()

    def _flush(self):
        root = jb.JItem(name="JPartFloatBi4")
        root.set_uint("FormatVer", 180423)
        root.set_uint("FtCount", self.n)
        root.add_array("mkbound", jb.USHORT, self.head["mkbound"])
        root.add_array("begin", jb.UINT, self.head["begin"])
        root.add_array("count", jb.UINT, self.head["count"])
        root.add_array("mass", jb.FLOAT, self.head["mass"])
        root.add_array("massp", jb.FLOAT, self.head["massp"])
        root.add_array("radius", jb.FLOAT, self.head["radius"])
        for p in self.parts:
            it = root.child(f"PART_{p['cpart']:04d}")
            it.set_uint("Cpart", p["cpart"])
            it.set_uint("Step", p["step"])
            it.set_double("TimeStep", p["timestep"])
            it.set_double("DemDtForce", p["demdtforce"])
            it.add_array("center", jb.DOUBLE3, p["center"])
            it.add_array("fvel", jb.FLOAT3, p["fvel"])
            it.add_array("fomega", jb.FLOAT3, p["fomega"])
            it.add_array("facelin", jb.FLOAT3, p["facelin"])
            it.add_array("faceang", jb.FLOAT3, p["faceang"])
        jb.write_file(self.path, root, filecode="JPartFloatBi4")
        return self.path


def read_floatbi4(path):
    """Returns (head dict, list of per-PART dicts)."""
    root = jb.read_file(path)
    if root.name != "JPartFloatBi4":
        raise ValueError(f"{path}: unexpected root {root.name}")
    head = dict(ftcount=int(root.get("FtCount", 0)))
    for nm in ("mkbound", "begin", "count", "mass", "massp", "radius"):
        a = root.array(nm)
        head[nm] = None if a is None else a.data
    parts = []
    for it in root.items:
        if not it.name.startswith("PART_"):
            continue
        p = dict(cpart=int(it.get("Cpart", 0)), step=int(it.get("Step", 0)),
                 timestep=float(it.get("TimeStep", 0.0)))
        for nm in ("center", "fvel", "fomega", "facelin", "faceang"):
            a = it.array(nm)
            p[nm] = None if a is None else a.data
        parts.append(p)
    return head, parts


class PartOutWriter:
    """Excluded-particle stream PartOut_000.obi4 (one item per PART with a
    non-empty exclusion batch)."""

    def __init__(self, dirout, block=0):
        self.path = os.path.join(dirout, f"PartOut_{block:03d}.obi4")
        self.parts = []
        self.nout_total = 0

    def save_part(self, cpart, timestep, *, idp, pos, vel, rhop, motive):
        nout = len(idp)
        if nout == 0:
            return
        self.nout_total += nout
        self.parts.append(dict(
            cpart=int(cpart), timestep=float(timestep), nout=nout,
            idp=np.asarray(idp, np.uint32),
            pos=np.asarray(pos, np.float64).reshape(nout, 3),
            vel=np.asarray(vel, np.float32).reshape(nout, 3),
            rhop=np.asarray(rhop, np.float32),
            motive=np.asarray(motive, np.uint8)))
        self._flush()

    def _flush(self):
        root = jb.JItem(name="JPartOutBi4")
        root.set_uint("FmtVersion", 180423)
        root.set_uint("Piece", 0)
        root.set_uint("Npiece", 1)
        root.set_uint("Block", 0)
        for p in self.parts:
            it = root.child(f"PART_{p['cpart']:04d}")
            it.set_uint("Cpart", p["cpart"])
            it.set_double("TimeStep", p["timestep"])
            it.set_uint("Nout", p["nout"])
            it.add_array("Idp", jb.UINT, p["idp"])
            it.add_array("Posd", jb.DOUBLE3, p["pos"])
            it.add_array("Vel", jb.FLOAT3, p["vel"])
            it.add_array("Rhop", jb.FLOAT, p["rhop"])
            it.add_array("Motive", jb.UCHAR, p["motive"])
        jb.write_file(self.path, root, filecode="JPartOutBi4")
        return self.path


def read_partout(path):
    root = jb.read_file(path)
    parts = []
    for it in root.items:
        if not it.name.startswith("PART_"):
            continue
        parts.append(dict(
            cpart=int(it.get("Cpart", 0)),
            timestep=float(it.get("TimeStep", 0.0)),
            idp=it.array("Idp").data,
            pos=(it.array("Posd") or it.array("Pos")).data,
            vel=it.array("Vel").data,
            rhop=it.array("Rhop").data,
            motive=it.array("Motive").data))
    return parts


def write_parthead(dirout, csp, *, casename="case", appname="dsphjax",
                   mkblocks=(), mapposmin=(0, 0, 0), mapposmax=(0, 0, 0),
                   firstpart=0):
    """Part_Head.ibi4 (JPartDataHead.cpp:211-271): run constants + MkBlocks
    table.  ``mkblocks``: list of dicts(type,mk,mktype,count)."""
    root = jb.JItem(name="JPartDataHead")
    root.set_uint("FmtVersion", 180423)
    root.set_text("AppName", appname)
    root.set_text("CaseName", casename)
    root.set_bool("Data2d", csp.simulate2d)
    root.set_double("Data2dPosY", 0.0)
    root.set_uint("Npiece", 1)
    root.set_uint("FirstPart", firstpart)
    root.set_double3("CasePosMin", mapposmin)
    root.set_double3("CasePosMax", mapposmax)
    root.set_bool("NpDynamic", False)
    root.set_bool("ReuseIds", False)
    root.set_double3("MapPosMin", mapposmin)
    root.set_double3("MapPosMax", mapposmax)
    root.set_int("PeriMode", 0)
    root.set_double("Dp", csp.dp)
    root.set_double("H", csp.kernelh)
    root.set_double("B", csp.cteb)
    root.set_double("Gamma", csp.gamma)
    root.set_double("RhopZero", csp.rhopzero)
    root.set_double("MassBound", csp.massbound)
    root.set_double("MassFluid", csp.massfluid)
    mkit = root.child("MkBlocks")
    mkit.set_uint("Count", len(mkblocks))
    for c, b in enumerate(mkblocks):
        it = mkit.child(f"MkBlock_{c:03d}")
        it.set_text("Type", b.get("type", "Fluid"))
        it.set_uint("Mk", b.get("mk", 0))
        it.set_uint("MkType", b.get("mktype", 0))
        it.set_uint("Count", b.get("count", 0))
    path = os.path.join(dirout, "Part_Head.ibi4")
    jb.write_file(path, root, filecode="JPartDataHead")
    return path


def read_parthead(path):
    root = jb.read_file(path)
    out = {k: root.get(k) for k in
           ("AppName", "CaseName", "Data2d", "Dp", "H", "B", "Gamma",
            "RhopZero", "MassBound", "MassFluid", "FirstPart")}
    blocks = []
    mkit = root.find("MkBlocks")
    if mkit is not None:
        for it in mkit.items:
            blocks.append(dict(type=it.get("Type"), mk=int(it.get("Mk", 0)),
                               mktype=int(it.get("MkType", 0)),
                               count=int(it.get("Count", 0))))
    out["mkblocks"] = blocks
    return out
