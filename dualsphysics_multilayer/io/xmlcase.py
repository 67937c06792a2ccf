"""DualSPHysics case-definition XML loader.

Re-implements the case-configuration stack the reference spreads over
GenCase + `JXml`/`JCaseCtes`/`JCaseEParms` (SURVEY §2.15): parses the
`*_Def.xml` files shipped with the reference examples — `<constantsdef>`
(JCaseCtes), `<geometry>` drawbox commands (the GenCase subset our lattice
generator covers), `<parameters>` key/value execution config (JCaseEParms,
full key list visible in examples/main/01_DamBreak/CaseDambreak_Def.xml:66-99)
and `<simulationdomain>` 'default +- x%' expressions — directly into a
runnable Case.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import (CteSph, TpBoundary, TpDensity, TpKernel, TpShifting,
                        TpStep, TpVisco, make_ctesph)
from ..models import cases as C
from ..ops import celldiv as cd
from ..ops.forces import SolverOpts


def _fget(el, name, attr="value", default=None):
    node = el.find(name)
    if node is None:
        return default
    v = node.get(attr)
    return default if v is None else float(v)


def _sget(el, name, attr="value", default=None):
    node = el.find(name)
    if node is None:
        return default
    v = node.get(attr)
    return default if v is None else v


def _params(root):
    out = {}
    for p in root.iter("parameter"):
        out[p.get("key")] = p.get("value")
    return out


def _sim_domain(root, pmin, pmax):
    """Apply `<simulationdomain>` posmin/posmax 'default +- x[%]' expressions
    (JSph::ConfigDomainResize, JSph.cpp:407)."""
    sd = root.find(".//simulationdomain")
    if sd is None:
        return pmin, pmax

    def apply(expr, base, size, sign):
        if expr is None or expr.strip() == "default":
            return base
        e = expr.replace("default", "").strip()
        if not e:
            return base
        if e.endswith("%"):
            return base + sign * float(e[:-1].lstrip("+- ")) / 100.0 * size * \
                (1 if "+" in e or not e.startswith("-") else -1)
        return base + float(e)

    size = pmax - pmin
    node = sd.find("posmin")
    if node is not None:
        for i, ax in enumerate("xyz"):
            pmin[i] = apply(node.get(ax), pmin[i], size[i], -1)
    node = sd.find("posmax")
    if node is not None:
        for i, ax in enumerate("xyz"):
            pmax[i] = apply(node.get(ax), pmax[i], size[i], +1)
    return pmin, pmax


def _xyz(el, default=(0.0, 0.0, 0.0)):
    if el is None:
        return default
    return tuple(float(el.get(a, d)) for a, d in zip("xyz", default))


def _read_rotateaxis(rot):
    """Rotation matrix + pivot from a ``<rotateaxis angle=..>`` (or 2-D
    ``<rotate angle=..>``) node.  Reference rotations are CLOCKWISE for
    positive angles (JMatrix4::MatrixRot, JMatrix4.h:356) so the angle is
    negated, matching the rest of this parser.  For ``<rotate>`` (2-D, no
    point1/point2 children) the axis is +y through ``pivot2d``."""
    ang = -float(rot.get("angle", 0.0))
    if rot.get("anglesunits", "degrees").startswith("d"):
        ang = np.deg2rad(ang)
    p1n, p2n = rot.find("point1"), rot.find("point2")
    if p1n is not None and p2n is not None:
        a1 = np.array(_xyz(p1n))
        ax = np.array(_xyz(p2n)) - a1
    else:                         # 2-D <rotate>: +y axis through the pivot
        a1 = np.zeros(3)
        ax = np.array([0.0, 1.0, 0.0])
    ax = ax / max(np.linalg.norm(ax), 1e-300)
    cth, sth = np.cos(ang), np.sin(ang)
    kx = np.array([[0, -ax[2], ax[1]],
                   [ax[2], 0, -ax[0]],
                   [-ax[1], ax[0], 0]])
    R = np.eye(3) + sth * kx + (1 - cth) * (kx @ kx)
    return R, a1


def _fillmode(cmd, mode):
    """(type, mk) for the fill* commands: explicit mkfluid/mkbound
    attributes override the current setmk mode; `<modefill>void</modefill>`
    without an explicit mk erases nothing drawable -> (None, 0)."""
    mf = cmd.find("modefill")
    mfv = (mf.text or "").strip() if mf is not None else ""
    if cmd.get("mkfluid") is not None and mfv != "bound":
        return td.TYPE_FLUID, int(float(cmd.get("mkfluid")))
    if cmd.get("mkbound") is not None:
        return td.TYPE_FIXED, int(float(cmd.get("mkbound")))
    if mfv == "void":
        return None, 0
    return mode["type"], mode["mk"]


def _redraw_filter(cmd):
    """Optional (type, mk) filter of `<redraw>`/`<redrawbox>`."""
    if cmd.get("mkfluid") is not None:
        return td.TYPE_FLUID, int(float(cmd.get("mkfluid")))
    if cmd.get("mkbound") is not None:
        return td.TYPE_FIXED, int(float(cmd.get("mkbound")))
    return None, None


def _mesh_inside_pred(tris):
    """Point-in-closed-triangle-mesh via ray-crossing parity
    (Moller-Trumbore against every face, vectorized over faces) — the
    region test behind GenCase `<fillfigure>` seed fills.  The ray uses a
    fixed irrational direction so it cannot slide along lattice-aligned
    faces or shared edges (the classic parity failure)."""
    tris = np.asarray(tris, np.float64).reshape(-1, 3, 3)
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    e1, e2 = b - a, c - a
    d = np.array([0.57735026918962, 0.21132486540519, 0.78867513459481])
    d = d / np.linalg.norm(d)

    def pred(pts):
        out = np.zeros(len(pts), bool)
        h = np.cross(np.broadcast_to(d, e2.shape), e2)
        det = np.sum(e1 * h, axis=1)
        good = np.abs(det) > 1e-30
        dets = np.where(good, det, 1.0)
        for i, p in enumerate(np.asarray(pts, np.float64)):
            s = p[None, :] - a
            u = np.sum(s * h, axis=1) / dets
            q = np.cross(s, e1)
            v = np.sum(q * d[None, :], axis=1) / dets
            t = np.sum(e2 * q, axis=1) / dets
            hit = good & (u >= -1e-12) & (v >= -1e-12) \
                & (u + v <= 1.0 + 1e-12) & (t > 1e-12)
            out[i] = (hit.sum() % 2) == 1
        return out

    return pred


def _load_xyz_points(fn):
    """Scattered bathymetry points from an XYZ/CSV text file (x y z rows,
    comma/semicolon/space separated, headers skipped) or a VTK polydata
    (vertices of its cells)."""
    if fn.lower().endswith(".vtk"):
        from .meshfile import load_mesh
        return load_mesh(fn).reshape(-1, 3)
    rows = []
    with open(fn, "rb") as f:
        for ln in f.read().decode("latin1").splitlines():
            ln = ln.replace(",", " ").replace(";", " ")
            p = ln.split()
            if len(p) < 3:
                continue
            try:
                rows.append([float(p[0]), float(p[1]), float(p[2])])
            except ValueError:
                continue
    return np.asarray(rows, np.float64).reshape(-1, 3)


def _bathy_surface(xyz, gdp):
    """Scattered seabed points -> regular-grid surface triangles (GenCase
    `<drawbathymetry>`: rasterize z(x,y) onto a grid of spacing ``gdp``,
    holes filled by iterative neighbour averaging)."""
    xyz = np.asarray(xyz, np.float64)
    x0, y0 = xyz[:, 0].min(), xyz[:, 1].min()
    nx = max(int(round((xyz[:, 0].max() - x0) / gdp)) + 1, 2)
    ny = max(int(round((xyz[:, 1].max() - y0) / gdp)) + 1, 2)
    zs = np.zeros((nx, ny))
    zc = np.zeros((nx, ny))
    ix = np.clip(np.round((xyz[:, 0] - x0) / gdp).astype(int), 0, nx - 1)
    iy = np.clip(np.round((xyz[:, 1] - y0) / gdp).astype(int), 0, ny - 1)
    np.add.at(zs, (ix, iy), xyz[:, 2])
    np.add.at(zc, (ix, iy), 1.0)
    Z = np.where(zc > 0, zs / np.maximum(zc, 1.0), np.nan)
    for _ in range(nx + ny):
        nanm = np.isnan(Z)
        if not nanm.any():
            break
        Zp = np.pad(Z, 1, constant_values=np.nan)
        nbrs = np.stack([Zp[:-2, 1:-1], Zp[2:, 1:-1],
                         Zp[1:-1, :-2], Zp[1:-1, 2:]])
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fill = np.nanmean(nbrs, axis=0)
        Z = np.where(nanm & ~np.isnan(fill), fill, Z)
    gx = x0 + np.arange(nx) * gdp
    gy = y0 + np.arange(ny) * gdp
    tris = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            p00 = (gx[i], gy[j], Z[i, j])
            p10 = (gx[i + 1], gy[j], Z[i + 1, j])
            p01 = (gx[i], gy[j + 1], Z[i, j + 1])
            p11 = (gx[i + 1], gy[j + 1], Z[i + 1, j + 1])
            tris += [[p00, p10, p11], [p00, p11, p01]]
    return np.asarray(tris, np.float64)


def _parse_properties(cdef, casedir):
    """`<casedef><properties>`: DEM material table (JCaseProperties;
    values read by `JSph::LoadDemData`, JSph.cpp:1189-1227).  Returns
    ``(by_name, mk_links)`` — property dicts keyed by name, and
    {mkbound: name} from `<links>`."""
    import os as _os
    node = cdef.find("properties")
    by_name, links = {}, {}
    if node is None:
        return by_name, links

    def read_props(parent):
        for pr in parent.findall("property"):
            d = {}
            for tag, key in (("Young_Modulus", "young"),
                             ("PoissonRatio", "poisson"),
                             ("Kfric", "kfric"),
                             ("Restitution_Coefficient", "restitu")):
                v = _fget(pr, tag)
                if v is not None:
                    d[key] = v
            by_name[pr.get("name")] = d

    pf_node = node.find("propertyfile")
    if pf_node is not None:
        ppath = _os.path.join(casedir, pf_node.get("file"))
        proot = ET.parse(ppath).getroot()
        sub = proot
        for part in (pf_node.get("path") or "").split("."):
            if part and sub is not None and sub.tag != part:
                nxt = sub.find(part)
                sub = nxt if nxt is not None else sub
        read_props(sub if sub is not None else proot)
    read_props(node)
    ln = node.find("links")
    if ln is not None:
        for l in ln.findall("link"):
            mks = l.get("mkbound", "")
            name = l.get("property")
            for part in mks.split(","):
                if "-" in part:
                    a, bb = part.split("-")
                    for mk in range(int(a), int(bb) + 1):
                        links[mk] = name
                elif part.strip():
                    links[int(part)] = name
    return by_name, links


_DEM_DEFAULT = dict(young=1e8, poisson=0.3, kfric=0.5, restitu=0.6)


def _parse_floatings(cdef, pos, code, csp, casedir="."):
    """`<floatings>` blocks: retype the drawn bound particles of each
    mkbound to TYPE_FLOATING with a body index and build the rigid config
    (GenCase floating properties -> JCaseParts, SURVEY §2.15).  Returns
    (code, cfg, state, dem_info) with dem_info = (float_props, bound_props)
    material tables for the DEM channel."""
    from ..features import floating as FTmod
    fl = cdef.find("floatings")
    by_name, links = _parse_properties(cdef, casedir)
    if fl is None:
        return code, None, None, None
    dim = csp.dim
    bodies, rhos, mklist, fprops = [], [], [], []
    vel0, omega0, tdofs, rdofs = [], [], [], []
    mkv = np.asarray(td.code_value(code))
    ctype = np.asarray(td.code_type(code))
    for b, node in enumerate(fl.findall("floating")):
        mks = node.get("mkbound")
        mk = int(float(mks.split("-")[0])) if mks else 0
        sel = (ctype < td.TYPE_FLOATING) & (mkv == mk)
        if not sel.any():
            continue
        npts = int(sel.sum())
        rhon = node.find("rhopbody")
        massn = node.find("massbody")
        if massn is not None:
            rho_b = float(massn.get("value")) / (npts * csp.dp ** dim)
        elif rhon is not None:
            rho_b = float(rhon.get("value"))
        elif node.get("rhopbody"):
            rho_b = float(node.get("rhopbody"))
        elif node.get("massbody"):
            rho_b = float(node.get("massbody")) / (npts * csp.dp ** dim)
        else:
            rho_b = csp.rhopzero
        code[sel] = td.code_make(td.TYPE_FLOATING, len(bodies))
        bodies.append(pos[sel])
        rhos.append(rho_b)
        mklist.append(mk)
        # DEM material: the floating's property attribute
        pname = node.get("property")
        fprops.append({**_DEM_DEFAULT, **by_name.get(pname, {})})
        # initial velocities + DOF restrictions (CaseTemplate.xml:682-687)
        vel0.append(_xyz(node.find("linearvelini")))
        omega0.append(_xyz(node.find("angularvelini")))
        tdofs.append(_xyz(node.find("translationDOF"), (1.0, 1.0, 1.0)))
        rdofs.append(_xyz(node.find("rotationDOF"), (1.0, 1.0, 1.0)))
    if not bodies:
        return code, None, None, None
    use_tdof = any(t != (1.0, 1.0, 1.0) for t in tdofs)
    use_rdof = any(r != (1.0, 1.0, 1.0) for r in rdofs)
    cfg, state = FTmod.make_floating(
        bodies, rhos, csp,
        translation_dof=tdofs if use_tdof else None,
        rotation_dof=rdofs if use_rdof else None)
    import dataclasses as _dc
    cfg = _dc.replace(cfg, mkbound=tuple(mklist))
    if any(v != (0.0, 0.0, 0.0) for v in vel0 + omega0):
        import jax.numpy as _jnp
        state = _dc.replace(
            state, fvel=_jnp.asarray(np.array(vel0), _jnp.float32),
            fomega=_jnp.asarray(np.array(omega0), _jnp.float32))
    bound_props = {mk: {**_DEM_DEFAULT, **by_name.get(nm, {})}
                   for mk, nm in links.items()}
    return code, cfg, state, (fprops, bound_props)


def _retype_moving(code, mk):
    mkv = np.asarray(td.code_value(code))
    ctype = np.asarray(td.code_type(code))
    sel = (ctype == td.TYPE_FIXED) & (mkv == mk)
    code[sel] = td.code_make(td.TYPE_MOVING, mk)
    return code


def _parse_motion(cdef, code, casedir="."):
    """`<motion>` real objects -> MotionDefs (the JMotion XML vocabulary:
    mvrect/mvrectace/mvrectsinu/mvrot/mvrotace/mvrotsinu/mvcir/mvcirace/
    mvcirsinu/mvrectfile/mvrotfile/wait/mvnull, with `<begin mov start
    [finish]>` entry points and ``next=`` movement chains — a chain whose
    ``next`` revisits a movement becomes a periodic loop
    (`JMotionMov.h:78-319`, CaseTemplate.xml:747-928)."""
    import math as _m
    import os as _os
    from ..features.motion import (CIR, CIR_ACE, RECT, RECT_ACE, ROT,
                                   ROT_ACE, ROT_FILE, SIN_CIR, SIN_RECT,
                                   SIN_ROT, TABLE_POS, WAIT, MotionDef,
                                   Segment)
    mo = cdef.find("motion")
    if mo is None:
        return code, ()
    d2r = _m.pi / 180.0

    def fattr(el, name, d=0.0):
        v = el.get(name) if el is not None else None
        return float(v) if v is not None else d

    def angval(mv, tag, attr="ang", d=0.0):
        """Angle-like value honoring anglesunits (degrees default) —
        the engine's rot params are in DEGREES.  NEGATED: the reference's
        rotation matrix is clockwise about the axis for positive angles
        (JMatrix4::MatrixRot rz = [c s; -s c], JMatrix4.h:356 — verified
        against the built CPU binary on a rotating-gate case), while the
        engine's Rodrigues matrix is right-handed."""
        n = mv.find(tag)
        if n is None:
            return d
        v = float(n.get(attr, d))
        if mv.get("anglesunits", "degrees").lower().startswith("rad"):
            v = v / d2r
        return -v

    def load_cols(fname, spec):
        """Whitespace/CSV numeric table -> list of row tuples by column
        indices in ``spec`` (JReadDatafile)."""
        rows = []
        with open(_os.path.join(casedir, fname)) as f:
            for line in f:
                toks = line.split("#")[0].replace(";", " ") \
                    .replace(",", " ").split()
                try:
                    vals = [float(x) for x in toks]
                except ValueError:
                    continue
                if len(vals) > max(spec):
                    rows.append(tuple(vals[i] for i in spec))
        return rows

    def build_seg(mv, t0, dur):
        t1 = t0 + dur
        tag = mv.tag
        if tag == "mvrect":
            return Segment(kind=RECT, t0=t0, t1=t1,
                           params=_xyz(mv.find("vel")))
        if tag == "mvrectace":
            return Segment(kind=RECT_ACE, t0=t0, t1=t1,
                           params=_xyz(mv.find("velini"))
                           + _xyz(mv.find("ace")))
        if tag == "mvrectsinu":
            f = _xyz(mv.find("freq"))
            a = _xyz(mv.find("ampl"))
            phn = mv.find("phase")
            ph = _xyz(phn) if phn is not None else (0.0, 0.0, 0.0)
            phv = ph[0] if not mv.get("anglesunits", "degrees").lower() \
                .startswith("deg") else ph[0] * d2r
            return Segment(kind=SIN_RECT, t0=t0, t1=t1,
                           params=(max(f), phv) + a)
        axes = (_xyz(mv.find("axisp1")) + _xyz(mv.find("axisp2")))
        if tag == "mvrot":
            return Segment(kind=ROT, t0=t0, t1=t1,
                           params=axes + (angval(mv, "vel"),))
        if tag == "mvrotace":
            return Segment(kind=ROT_ACE, t0=t0, t1=t1,
                           params=axes + (angval(mv, "velini"),
                                          angval(mv, "ace")))
        if tag == "mvrotsinu":
            ph = angval(mv, "phase", attr="v") * d2r
            return Segment(kind=SIN_ROT, t0=t0, t1=t1,
                           params=axes + (fattr(mv.find("freq"), "v", 0.0),
                                          ph, angval(mv, "ampl", attr="v")))
        ref = _xyz(mv.find("ref")) if mv.find("ref") is not None \
            else (0.0, 0.0, 0.0)
        if tag == "mvcir":
            return Segment(kind=CIR, t0=t0, t1=t1,
                           params=axes + (angval(mv, "vel"),) + ref)
        if tag == "mvcirace":
            return Segment(kind=CIR_ACE, t0=t0, t1=t1,
                           params=axes + (angval(mv, "velini"),
                                          angval(mv, "ace")) + ref)
        if tag == "mvcirsinu":
            ph = angval(mv, "phase", attr="v") * d2r
            return Segment(kind=SIN_CIR, t0=t0, t1=t1,
                           params=axes + (fattr(mv.find("freq"), "v", 0.0),
                                          ph, angval(mv, "ampl", attr="v"))
                           + ref)
        if tag == "mvrectfile":
            fn = mv.find("file")
            ft = int(fattr(fn, "fieldtime", 0))
            cols, fill = [], []
            for i, ax in enumerate("xyz"):
                c = fn.get(f"field{ax}")
                cols.append(int(c) if c is not None else None)
                fill.append(c is None)
            spec = [ft] + [c for c in cols if c is not None]
            rows = load_cols(fn.get("name"), spec)
            if not rows:
                return None
            times, vals = [], []
            for r in rows:
                times.append(r[0])
                j = 1
                p = []
                for c in cols:
                    p.append(0.0 if c is None else r[j])
                    j += 0 if c is None else 1
                vals.extend(p)
            return Segment(kind=TABLE_POS, t0=t0, t1=t1,
                           times=tuple(times), values=tuple(vals))
        if tag == "mvrotfile":
            fn = mv.find("file")
            rows = load_cols(fn.get("name"), [0, 1])
            if not rows:
                return None
            rad = not mv.get("anglesunits",
                             "degrees").lower().startswith("deg")
            # negated like angval (reference clockwise convention)
            return Segment(kind=ROT_FILE, t0=t0, t1=t1, params=axes,
                           times=tuple(r[0] for r in rows),
                           values=tuple(-r[1] * (1.0 if rad else d2r)
                                        for r in rows))
        if tag in ("wait", "mvnull"):
            return Segment(kind=WAIT, t0=t0, t1=t1)
        return None

    def level_segments(node):
        """Segments from one object level's own begin chains."""
        movs = {int(mv.get("id", 0)): mv for mv in node
                if mv.tag not in ("begin", "objreal", "obj")}
        segs = []
        loop_t = loop_start = t_end = 0.0
        for b in node.findall("begin"):
            mid = int(b.get("mov"))
            tcur = float(b.get("start", 0.0))
            fin = b.get("finish")
            if fin is not None:
                t_end = max(t_end, float(fin))
            visited = {}
            while mid in movs:
                if mid in visited:
                    # chain loops: period = time since the first visit
                    loop_start = visited[mid]
                    loop_t = tcur - visited[mid]
                    break
                visited[mid] = tcur
                mv = movs[mid]
                dur = float(mv.get("duration", 0.0))
                dur = dur if dur > 0 else 1e30
                seg = build_seg(mv, tcur, dur)
                if seg is not None:
                    segs.append(seg)
                tcur += dur
                nxt = mv.get("next")
                if nxt is None or dur >= 1e30:
                    break
                mid = int(nxt)
        return segs, loop_t, loop_start, t_end

    out = []

    def walk(node, inherited):
        for child in node:
            if child.tag == "obj":
                walk(child, inherited + [child])
            elif child.tag == "objreal":
                mk = int(child.get("ref"))
                segs, loop_t, loop_start, t_end = level_segments(child)
                # parent <obj> wrappers contribute their (linear) chains
                # additively — the JMotion hierarchy composes parent motion
                # onto children (JMotionObj parent chains)
                for anc in inherited:
                    s2, lt2, ls2, te2 = level_segments(anc)
                    segs = s2 + segs
                    if loop_t == 0.0:
                        loop_t, loop_start = lt2, ls2
                    t_end = max(t_end, te2)
                if segs and any(s.kind != 0 for s in segs):
                    nonlocal code
                    code = _retype_moving(code, mk)
                    out.append(MotionDef(
                        mk=mk, segments=tuple(segs), loop_t=loop_t,
                        loop_start=loop_start, t_end=t_end))

    walk(mo, [])
    return code, tuple(out)


def _parse_chrono(root, ftcfg, ftstate, casedir=".", dp=0.0, dem_info=None):
    """`<special><chrono>` -> (features.chrono.ChronoCfg,
    features.chcollision.ChContactCfg) (JChronoObjects::LoadXml,
    `_FmtXML_Chrono.xml`): bodyfloating ids map to rigid-body indices by
    mkbound, bodyfixed ids are ground; link_* elements become native
    constraint rows; `<collision activate="true">` plus per-body
    ``modelfile`` meshes become the mesh-contact tables (materials from
    `<properties>` like `JSph::LoadDemData`)."""
    sp = root.find(".//execution/special")
    if sp is None:
        sp = root.find(".//special")
    ch = sp.find("chrono") if sp is not None else None
    if ch is None or ftcfg is None:
        return None, None, None
    from ..features import chrono as CH
    mk2body = {mk: b for b, mk in enumerate(ftcfg.mkbound)}
    ids = {}
    bodyels = []
    for b in ch:
        if b.tag in ("bodyfloating", "bodymoving"):
            mk = int(float(b.get("mkbound", "0")))
            ids[b.get("id")] = mk2body.get(mk, -1)
            bodyels.append((b, mk, ids[b.get("id")]))
        elif b.tag == "bodyfixed":
            ids[b.get("id")] = -1
            bodyels.append((b, int(float(b.get("mkbound", "0"))), -1))

    # ---- per-body force scaling (<scaleforce>) -----------------------------
    scaleforce = None
    sfn = ch.find("scaleforce")
    if sfn is not None and ftcfg is not None:
        sf = np.ones((ftcfg.count, 3), np.float64)
        for bel in sfn.findall("body"):
            for part in str(bel.get("mkbound", "")).split(","):
                part = part.strip()
                if not part:
                    continue
                mks = ([int(part)] if "-" not in part else
                       list(range(int(part.split("-")[0]),
                                  int(part.split("-")[1]) + 1)))
                for mk in mks:
                    b = mk2body.get(mk)
                    if b is not None:
                        sf[b] = [float(bel.get(a, 1.0)) for a in "xyz"]
        scaleforce = tuple(float(x) for x in sf.reshape(-1))

    # ---- collision meshes (Chrono NSC/SMC contact) -------------------------
    chcontact = None
    col = ch.find("collision")
    if col is not None and col.get("activate", "true").lower() \
            not in ("false", "0") and dp > 0:
        import os
        from ..features.chcollision import make_chcontact
        from .meshfile import load_mesh
        distancedp = 0.5
        dnode = col.find("distancedp")
        if dnode is not None and dnode.get("value") is not None:
            distancedp = float(dnode.get("value"))
        fprops, bprops = dem_info if dem_info is not None else ([], {})
        bodies = []
        for el, mk, ft in bodyels:
            mf = el.get("modelfile")
            if not mf:
                continue
            tris = load_mesh(os.path.join(casedir, mf))
            if ft >= 0:
                props = fprops[ft] if ft < len(fprops) else {}
                bd = dict(ft=ft, tris=tris,
                          center0=np.asarray(ftstate.center)[ft],
                          mass=ftcfg.mass[ft])
            else:
                props = (bprops or {}).get(mk, {})
                bd = dict(ft=-1, tris=tris)
            bd.update({k: props[k] for k in
                       ("young", "poisson", "kfric", "restitu") if k in props})
            bodies.append(bd)
        chcontact = make_chcontact(bodies, dp=dp, distancedp=distancedp)

    def fv(el, name, d=0.0):
        n = el.find(name)
        v = n.get("value") if n is not None else None
        return float(v) if v is not None else d

    links = []
    for el in ch:
        tag = el.tag
        if not tag.startswith("link_") or len(el) == 0:
            continue
        if el.get("active", "true").lower() in ("false", "0"):
            continue
        b1 = ids.get(el.get("idbody1"), -1)
        b2 = ids.get(el.get("idbody2"), -1)
        if b1 < 0:
            b1, b2 = b2, b1        # keep the real body in slot 1
        if b1 < 0:
            continue

        def xyz(name, d=(0.0, 0.0, 0.0)):
            n = el.find(name)
            return _xyz(n, d) if n is not None else d

        if tag == "link_hinge":
            links.append(CH.ChLink(
                "hinge", b1, b2, rotpoint=xyz("rotpoint"),
                rotvector=xyz("rotvector", (0.0, 0.0, 1.0)),
                stiffness=fv(el, "stiffness"), damping=fv(el, "damping")))
        elif tag == "link_spheric":
            links.append(CH.ChLink(
                "spheric", b1, b2, rotpoint=xyz("rotpoint"),
                stiffness=fv(el, "stiffness"), damping=fv(el, "damping")))
        elif tag == "link_pointline":
            links.append(CH.ChLink(
                "pointline", b1, b2, rotpoint=xyz("rotpoint"),
                slidevector=xyz("slidingvector", (0.0, 0.0, 1.0)),
                stiffness=fv(el, "stiffness"), damping=fv(el, "damping")))
        elif tag == "link_linearspring":
            links.append(CH.ChLink(
                "spring", b1, b2, pt1=xyz("point_fb1"), pt2=xyz("point_fb2"),
                stiffness=fv(el, "stiffness"), damping=fv(el, "damping"),
                restlength=fv(el, "rest_length")))
        elif tag == "link_coulombdamping":
            links.append(CH.ChLink(
                "coulomb", b1, b2, pt1=xyz("point_fb1"), pt2=xyz("point_fb2"),
                restlength=fv(el, "rest_length"),
                coulomb=fv(el, "damping")))
        elif tag == "link_pulley":
            links.append(CH.ChLink(
                "pulley", b1, b2, rotpoint=xyz("rotpoint"),
                rotvector=xyz("rotvector", (0.0, 0.0, 1.0)),
                radius=fv(el, "radius", 1.0), radius2=fv(el, "radius2", 1.0)))
    if not links:
        return None, chcontact, scaleforce
    import numpy as _np
    return (CH.make_chrono(links, _np.asarray(ftstate.center)), chcontact,
            scaleforce)


def _parse_nnphases(root, csp):
    """`<special><nnphases>` -> forces_nn.PhaseCfg (JSph::InitMultiPhase,
    src_mphase JSph.cpp:3137-3216): per-phase rhop/visco/tau_yield/HBP_m/
    HBP_n (+ optional csound/gamma/tau_max/Bi_multi), phases sorted by
    mkfluid.  Per-phase csound defaults to the system cs0 (ConfigConstantsMP
    computes CteB from the system cs0 when any phase omits it)."""
    node = root.find(".//special/nnphases")
    if node is None:
        return None
    from ..ops import forces_nn as NN
    phs = []
    for ele in node.findall("phase"):
        mk = int(float(ele.get("mkfluid", "0")))
        g = lambda tag, d=0.0: _fget(ele, tag, default=d)
        phs.append(NN.Phase(
            mkfluid=mk,
            rho0=g("rhop", csp.rhopzero),
            csound=g("csound", 0.0) or float(csp.cs0),
            gamma=g("gamma", 0.0) or float(csp.gamma),
            visco=g("visco", 0.001),
            tau_yield=g("tau_yield", 0.0),
            tau_max=g("tau_max", 0.0),
            bi_multi=g("Bi_multi", 0.0),
            hbp_m=g("HBP_m", 0.0),
            hbp_n=g("HBP_n", 1.0)))
    if not phs:
        return None
    phs.sort(key=lambda p: p.mkfluid)
    return NN.PhaseCfg(phases=tuple(phs))


def _parse_moorings(root, ftcfg, ftstate, casedir=".", csp=None):
    """`<special><moorings>` + the MoorDyn+ configuration file ->
    features.moorings.MoorDynCfg (reference `JDsMooredFloatings` +
    `libdsphmoordyn`, `_FmtXML_MoorDyn.xml`).

    The line model is the dynamic lumped-mass re-implementation
    in features.moorings (MoorDynCfg); `<connect>` nodes are frozen at
    their initial position (each conref line becomes a body<->fixed-point
    line)."""
    import os as _osm
    sp = root.find(".//execution/special")
    if sp is None:
        sp = root.find(".//special")
    mo = sp.find("moorings") if sp is not None else None
    if mo is None or mo.get("active", "true").lower() in ("false", "0"):
        return None
    if ftcfg is None:
        raise ValueError("<moorings> needs floating bodies")
    from ..features.moorings import MoorDynCfg, MoorDynLine
    mk2body = {mk: b for b, mk in enumerate(ftcfg.mkbound)}
    stt = mo.find("start")
    start = float(stt.get("value", 0)) if stt is not None else 0.0
    ramptime = float(stt.get("ramptime", 0)) if stt is not None else 0.0
    md = mo.find("moordyn")
    lines = []
    sol = {}
    if md is not None and md.get("active", "true").lower() \
            not in ("false", "0") and md.get("file"):
        fn = md.get("file")
        if not _osm.path.splitext(fn)[1]:
            fn += ".xml"
        mdroot = ET.parse(_osm.path.join(casedir, fn)).getroot()
        centers = np.asarray(ftstate.center)

        def _sopt(name, default):
            el = mdroot.find(f".//solverOptions/{name}")
            return float(el.get("value")) if el is not None else default
        freesurface = _sopt("freesurface", 0.0)
        waterdepth = _sopt("waterDepth", 0.0)
        sol = dict(kbot=_sopt("kBot", 3.0e6), cbot=_sopt("cBot", 3.0e5),
                   fric=_sopt("frictionCoefficient", 0.0),
                   fricdamp=_sopt("fricDamp", 200.0),
                   cdscale_ic=_sopt("cdScaleIC", 5.0),
                   t_ic=min(_sopt("tmaxIC", 1.0), 5.0))
        dtm_el = mdroot.find(".//solverOptions/dtM")
        dtm = float(dtm_el.get("value")) if dtm_el is not None else 1e-4
        dtm_auto = (dtm_el is None
                    or dtm_el.get("auto", "true").lower()
                    not in ("false", "0"))
        # per-body water-depth overrides (<bodies><body ref=N depth=..>)
        bodydepth = {}
        for bn in mdroot.findall(".//bodies/body"):
            dn = bn.find("depth")
            if dn is not None:
                bodydepth[int(float(bn.get("ref")))] = float(dn.get("value"))
        # line defaults (_FmtXML_MoorDyn.xml linedefault)
        dflt = dict(ea=0.0, diameter=0.0, massden=0.0, ba=-0.8, can=1.0,
                    cat=0.0, cdn=1.6, cdt=0.05, breaktension=0.0, e=0.0)
        _keys = dict(ea="ea", diameter="diameter", massdeninair="massden",
                     ba="ba", can="can", cat="cat", cdn="cdn", cdt="cdt",
                     breaktension="breaktension", e="e")

        def _props(el, base):
            out = dict(base)
            for ch in el:
                k = _keys.get(ch.tag.lower())
                if k is not None and ch.get("value") is not None:
                    out[k] = float(ch.get("value"))
            if not out["ea"] and out["e"] and out["diameter"]:
                # E given instead of EA: EA = E * pi d^2/4
                out["ea"] = out["e"] * math.pi * out["diameter"] ** 2 / 4.0
            return out
        ld = mdroot.find(".//lines/linedefault")
        if ld is not None:
            dflt = _props(ld, dflt)
        connects = {}
        for cn in mdroot.findall(".//connects/connect"):
            connects[cn.get("conref")] = (float(cn.get("x", 0)),
                                          float(cn.get("y", 0)),
                                          float(cn.get("z", 0)))

        def _end(ln, tag):
            el = ln.find(tag)
            if el is None:
                return None
            if tag == "connect":
                return ("fix", connects[el.get("conref")])
            p = (float(el.get("x", 0)), float(el.get("y", 0)),
                 float(el.get("z", 0)))
            br = el.get("bodyref")
            if br is not None and tag == "vesselconnection":
                return ("body", int(float(br)), p)
            return ("fix", p)

        for ln in mdroot.findall(".//lines/line"):
            pr = _props(ln, dflt)
            L0 = float(ln.find("length").get("value")) if ln.find("length") \
                is not None else 1.0
            segs = int(float(ln.find("segments").get("value"))) \
                if ln.find("segments") is not None else 20
            ends = [e for e in (_end(ln, "vesselconnection"),
                                _end(ln, "fixconnection"),
                                _end(ln, "connect")) if e is not None]
            bodyend = next((e for e in ends if e[0] == "body"), None)
            fixend = next((e for e in ends if e[0] == "fix"), None)
            if bodyend is None or fixend is None:
                continue        # connect<->connect line: no body coupling
            mk = bodyend[1]
            if mk not in mk2body:
                raise ValueError(f"moordyn line bodyref={mk} is not a "
                                 f"floating mkbound")
            b = mk2body[mk]
            fairlead = tuple(np.asarray(bodyend[2]) - centers[b])
            depth = waterdepth
            dn = ln.find("depth")
            if dn is not None:
                depth = float(dn.get("value"))
            elif mk in bodydepth:
                depth = bodydepth[mk]
            lines.append(MoorDynLine(
                body=b, anchor=tuple(fixend[1]), fairlead=fairlead,
                length0=L0, ea=pr["ea"], nseg=segs,
                diameter=pr["diameter"], massden=pr["massden"],
                ba=pr["ba"], can=pr["can"], cat=pr["cat"], cdn=pr["cdn"],
                cdt=pr["cdt"], breaktension=pr["breaktension"],
                zbot=freesurface - depth))
    if not lines:
        return None
    # substep sizing: dtM_auto -> MoorDynCfg.stable_dtm (chain-mode CFL);
    # nsub covers the largest possible SPH dt (dt2 <= cfl*h/cs0).  An
    # explicit (auto=false) dtM is still clamped for the substep COUNT so
    # a coarse user value cannot make the integration unstable.
    import dataclasses as _dc
    cfg = MoorDynCfg(lines=tuple(lines), nbodies=len(ftcfg.mkbound),
                     g=abs(csp.gravity[2]) if csp is not None else 9.81,
                     rho_w=csp.rhopzero if csp is not None else 1000.0,
                     start=start, ramptime=ramptime, **sol)
    stable = cfg.stable_dtm()
    if dtm_auto:
        dtm = max(min(stable, 1e-2), 1e-6)
    dtbound = (csp.cflnumber * csp.kernelh / csp.cs0) if csp is not None \
        else 16 * dtm
    nsub = int(min(max(math.ceil(dtbound / min(dtm, stable)), 1), 500))
    return _dc.replace(cfg, nsub=nsub, dtm=dtm)


def _parse_special(root, csp, code, zsurf, pos, casedir="."):
    """`<execution><special>` feature blocks -> Features pieces."""
    from ..features import wavegen as WG
    from ..features.awas import AwasZsurf
    from ..features.damping import (DampingBox, DampingCylinder, DampingPlane)
    from ..features.inout import InOutCfg, InOutZone
    sp = root.find(".//execution/special")
    if sp is None:
        sp = root.find(".//special")
    damping, motions, iozones, awas = [], [], [], []
    if sp is None:
        return code, dict(damping=(), motions=(), inout=None, awas=(),
                          mlpistons=(), relaxzones=(), accinputs=(),
                          gauges=(), gauge_windows={},
                          gauge_computedts={})

    dmp = sp.find("damping")
    if dmp is not None:
        for z in dmp.findall("dampingzone"):
            if z.get("active", "true").lower() in ("false", "0"):
                continue
            damping.append(DampingPlane(
                point=_xyz(z.find("limitmin")),
                limitpoint=_xyz(z.find("limitmax")),
                overlimit=_fget(z, "overlimit", default=0.0),
                redumax=_fget(z, "redumax", default=10.0),
                factorxyz=_xyz(z.find("factorxyz"), (1.0, 1.0, 1.0))))
        for z in dmp.findall("dampingbox"):
            lm = z.find("limitmin")
            lx = z.find("limitmax")
            damping.append(DampingBox(
                boxmin1=_xyz(lm.find("pointini")),
                boxmax1=_xyz(lm.find("pointend")),
                boxmin2=_xyz(lx.find("pointini")),
                boxmax2=_xyz(lx.find("pointend")),
                redumax=_fget(z, "redumax", default=10.0),
                factorxyz=_xyz(z.find("factorxyz"), (1.0, 1.0, 1.0))))
        for z in dmp.findall("dampingcylinder"):
            damping.append(DampingCylinder(
                point1=_xyz(z.find("point1")),
                point2=_xyz(z.find("point2")),
                limitmin=float(z.find("limitmin").get("radius")),
                limitmax=float(z.find("limitmax").get("radius")),
                redumax=_fget(z, "redumax", default=10.0),
                factorxyz=_xyz(z.find("factorxyz"), (1.0, 1.0, 1.0))))

    wp = sp.find("wavepaddles")
    if wp is not None:
        for pn in wp.findall("piston"):
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            H = _fget(pn, "waveheight", default=0.1)
            T = _fget(pn, "waveperiod", default=1.0)
            depth = _fget(pn, "depth", default=zsurf)
            phase = _fget(pn, "phase", default=0.0) * math.pi
            start = _fget(pn, "start", default=0.0)
            ramp = _fget(pn, "ramp", default=0.0)
            motions.append(WG.piston_waves(
                mk, height=H, period=T, depth=depth,
                order=int(_fget(pn, "waveorder", default=1)),
                phase=phase, tstart=start,
                gain=_fget(pn, "gainstroke", default=1.0),
                ramp=ramp,
                direction=_xyz(pn.find("pistondir"), (1.0, 0.0, 0.0))))
            an = pn.find("awas_zsurf")
            if an is not None:
                mkv = np.asarray(td.code_value(code))
                ctype = np.asarray(td.code_type(code))
                psel = (ctype == td.TYPE_MOVING) & (mkv == mk)
                paddle_x = float(pos[psel, 0].max()) if psel.any() else 0.0
                gx = _fget(an, "gaugex", default=None)
                if gx is None:
                    gxdp = _fget(an, "gaugex", attr="valuedp", default=5.0)
                    gx = (gxdp or 5.0) * csp.dp
                swl = _fget(an, "swl", default=zsurf)
                awas.append(AwasZsurf(
                    mk=mk, height=H, period=T, depth=depth, swl=swl,
                    gauge_x=paddle_x + gx,
                    start=_fget(an, "startawas",
                                default=start + ramp * T),
                    phase=phase))
        for pn in wp.findall("flap"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            motions.append(WG.flap_waves(
                mk, height=_fget(pn, "waveheight", default=0.1),
                period=_fget(pn, "waveperiod", default=1.0),
                depth=_fget(pn, "depth", default=zsurf),
                draft=_fget(pn, "variabledraft", default=0.0),
                axis_p0=_xyz(pn.find("flapaxis0")),
                axis_p1=_xyz(pn.find("flapaxis1"), (0.0, 1.0, 0.0)),
                phase=_fget(pn, "phase", default=0.0) * math.pi,
                tstart=_fget(pn, "start", default=0.0),
                gain=_fget(pn, "gainstroke", default=1.0),
                ramp=_fget(pn, "ramp", default=0.0),
                order=int(_fget(pn, "waveorder", default=1))))
        for pn in wp.findall("piston_spectrum"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            motions.append(WG.piston_spectrum(
                mk, hs=_fget(pn, "waveheight", default=0.1),
                tp=_fget(pn, "waveperiod", default=1.0),
                depth=_fget(pn, "depth", default=zsurf),
                spectrum=_sget(pn, "spectrum", default="jonswap") or
                "jonswap",
                discretization=_sget(pn, "discretization",
                                     default="stretched") or "stretched",
                nwaves=int(_fget(pn, "waves", default=50)),
                peakcoef=_fget(pn, "peakcoef", default=3.3),
                seed=int(_fget(pn, "randomseed", default=2)),
                tstart=_fget(pn, "start", default=0.0),
                ramptime=_fget(pn, "ramptime", default=0.0),
                gain=_fget(pn, "gainstroke", default=1.0),
                direction=_xyz(pn.find("pistondir"), (1.0, 0.0, 0.0))))
        for pn in wp.findall("flap_spectrum"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            motions.append(WG.flap_spectrum(
                mk, hs=_fget(pn, "waveheight", default=0.1),
                tp=_fget(pn, "waveperiod", default=1.0),
                depth=_fget(pn, "depth", default=zsurf),
                draft=_fget(pn, "variabledraft", default=0.0),
                axis_p0=_xyz(pn.find("flapaxis0")),
                axis_p1=_xyz(pn.find("flapaxis1"), (0.0, 1.0, 0.0)),
                spectrum=_sget(pn, "spectrum", default="jonswap") or
                "jonswap",
                discretization=_sget(pn, "discretization",
                                     default="stretched") or "stretched",
                nwaves=int(_fget(pn, "waves", default=50)),
                peakcoef=_fget(pn, "peakcoef", default=3.3),
                seed=int(_fget(pn, "randomseed", default=2)),
                tstart=_fget(pn, "start", default=0.0),
                ramptime=_fget(pn, "ramptime", default=0.0),
                gain=_fget(pn, "gainstroke", default=1.0)))
        for pn in wp.findall("piston_focused"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            mkv = np.asarray(td.code_value(code))
            ctype = np.asarray(td.code_type(code))
            psel = (ctype == td.TYPE_MOVING) & (mkv == mk)
            paddle_x = float(pos[psel, 0].max()) if psel.any() else 0.0
            motions.append(WG.piston_focused(
                mk, hs=_fget(pn, "waveheight", default=0.1),
                tp=_fget(pn, "waveperiod", default=1.0),
                depth=_fget(pn, "depth", default=zsurf),
                xf=_fget(pn, "xf", default=1.0),
                paddle_x=paddle_x,
                fphase_deg=_fget(pn, "fphase", default=0.0),
                spectrum=_sget(pn, "spectrum", default="jonswap") or
                "jonswap",
                discretization=_sget(pn, "discretization",
                                     default="regular") or "regular",
                nwaves=int(_fget(pn, "waves", default=128)),
                peakcoef=_fget(pn, "peakcoef", default=3.3),
                seed=int(_fget(pn, "randomseed", default=2)),
                tstart=_fget(pn, "start", default=0.0),
                ramptime=_fget(pn, "ramptime", default=0.0),
                fpretime=_fget(pn, "fpretime", default=5.0),
                gain=_fget(pn, "gainstroke", default=1.0),
                direction=_xyz(pn.find("pistondir"), (1.0, 0.0, 0.0))))
        for pn in wp.findall("piston_solitary"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            nw = int(_fget(pn, "waves", default=1))
            heights = [_fget(pn, "waveheight", default=0.05)]
            starts = []
            for i in (2, 3):
                heights.append(_fget(pn, f"waveheight{i}", default=0.0))
                starts.append(_fget(pn, f"startcoef{i}", default=0.0))
            motions.append(WG.piston_solitary(
                mk, height=heights[0],
                depth=_fget(pn, "depth", default=zsurf),
                theory=int(_fget(pn, "theory", default=2)),
                nwaves=nw,
                durationcoef=_fget(pn, "durationcoef", default=1.0),
                startcoefs=tuple([1.0] + starts),
                heights=tuple(heights),
                tstart=_fget(pn, "start", default=0.0),
                direction=_xyz(pn.find("pistondir"), (1.0, 0.0, 0.0))))

    mlpistons = []
    mlp = sp.find("mlayerpistons")
    if mlp is not None and mlp.get("active", "true").lower() \
            not in ("false", "0"):
        import os as _os
        from ..features.mlpiston import (load_mlpiston_csv, make_piston1d,
                                         smooth_table, MLPiston2D)

        def _zrange(mk):
            """Piston particle z extent (JMLPistons::PreparePiston derives
            the layer bands from the piston particles)."""
            sel = (np.asarray(td.code_type(code)) != td.TYPE_FLUID) \
                & (np.asarray(td.code_value(code)) == mk)
            if not sel.any():
                raise ValueError(f"mlayerpistons: no particles with "
                                 f"mkbound={mk}")
            z = pos[sel, 2]
            return float(z.min()), float(z.max())

        for pn in mlp.findall("piston1d"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            times, vels = load_mlpiston_csv(
                _os.path.join(casedir, _sget(pn, "filevelx")),
                timedataini=_fget(pn, "timedataini", default=0.0))
            zmin, zmax = _zrange(mk)
            mlpistons.append(make_piston1d(
                mk, times, vels, zmin, zmax,
                incz=_fget(pn, "incz", default=0.0),
                smooth=int(_fget(pn, "smooth", default=0))))
        for pn in mlp.findall("piston2d"):
            if pn.get("active", "true").lower() in ("false", "0"):
                continue
            mk = int(_fget(pn, "mkbound", default=0))
            code = _retype_moving(code, mk)
            incz = _fget(pn, "incz", default=0.0)
            smoothz = int(_fget(pn, "smoothz", default=0))
            smoothy = int(_fget(pn, "smoothy", default=0))
            zmin, zmax = _zrange(mk)
            coldefs = []
            for vd in pn.findall("veldata"):
                times, vels = load_mlpiston_csv(
                    _os.path.join(casedir, _sget(vd, "filevelx")),
                    timedataini=_fget(vd, "timedataini", default=0.0))
                coldefs.append((_fget(vd, "posy", default=0.0), times, vels))
            if not coldefs:
                raise ValueError("piston2d needs at least one <veldata>")
            coldefs.sort(key=lambda c: c[0])
            if smoothy and len(coldefs) >= 3 and \
                    len({c[2].shape for c in coldefs}) == 1:
                stack = smooth_table(
                    np.stack([c[2] for c in coldefs]), smoothy, axis=0)
                coldefs = [(py, t, stack[i])
                           for i, (py, t, _) in enumerate(coldefs)]
            cols = tuple(make_piston1d(mk, t, v, zmin, zmax, incz=incz,
                                       smooth=smoothz)
                         for _, t, v in coldefs)
            mlpistons.append(MLPiston2D(
                mk=mk, cols=cols, posy=tuple(c[0] for c in coldefs)))

    relaxzones = []
    rz = sp.find("relaxationzones")
    if rz is not None and rz.get("active", "true").lower() \
            not in ("false", "0"):
        import os as _os
        from ..features.relaxzone import (RelaxZoneExternal, RelaxZoneRegular,
                                          RelaxZoneUniform,
                                          make_spectrum_zone)

        def _rz_common(zn):
            fn = zn.find("function")
            return dict(
                start=_fget(zn, "start", default=0.0),
                duration=_fget(zn, "duration", default=0.0),
                coefdt=_fget(zn, "coefdt", default=1000.0),
                falpha=float(fn.get("psi", 0.9)) if fn is not None else 0.9,
                fbeta=float(fn.get("beta", 1.0)) if fn is not None else 1.0)

        for zn in rz.findall("rzwaves_regular"):
            if zn.get("active", "true").lower() in ("false", "0"):
                continue
            relaxzones.append(RelaxZoneRegular(
                center=_xyz(zn.find("center")),
                width=_fget(zn, "width", default=0.2),
                height=_fget(zn, "waveheight", default=0.1),
                period=_fget(zn, "waveperiod", default=1.0),
                depth=_fget(zn, "depth", default=zsurf),
                swl=_fget(zn, "swl", default=zsurf),
                order2=int(_fget(zn, "waveorder", default=1)) >= 2,
                phase=_fget(zn, "phase", default=0.0) * math.pi,
                ramp=_fget(zn, "ramp", default=0.0),
                coefdir=_xyz(zn.find("coefdir"), (1.0, 0.0, 0.0)),
                driftcorrection=_fget(zn, "driftcorrection", default=0.0),
                **_rz_common(zn)))
        for zn in rz.findall("rzwaves_spectrum"):
            if zn.get("active", "true").lower() in ("false", "0"):
                continue
            relaxzones.append(make_spectrum_zone(
                center=_xyz(zn.find("center")),
                width=_fget(zn, "width", default=0.2),
                height=_fget(zn, "waveheight", default=0.1),
                period=_fget(zn, "waveperiod", default=1.0),
                depth=_fget(zn, "depth", default=zsurf),
                swl=_fget(zn, "swl", default=zsurf),
                spectrum=_sget(zn, "spectrum", default="jonswap"),
                discretization=_sget(zn, "discretization",
                                     default="stretched"),
                peakcoef=_fget(zn, "peakcoef", default=3.3),
                waves=int(_fget(zn, "waves", default=50)),
                randomseed=int(_fget(zn, "randomseed", default=2)),
                serieini=_fget(zn, "serieini", default=0.0),
                ramptime=_fget(zn, "ramptime", default=0.0),
                coefdir=_xyz(zn.find("coefdir"), (1.0, 0.0, 0.0)),
                driftcorrection=_fget(zn, "driftcorrection", default=0.0),
                **_rz_common(zn)))
        for zn in rz.findall("rzwaves_external_1d"):
            if zn.get("active", "true").lower() in ("false", "0"):
                continue
            from ..features.inout import load_inout_gridvel
            fname = _sget(zn, "filesvel")
            mv = zn.find("movedata")
            org = (float(mv.get("x", 0)) if mv is not None else 0.0,
                   float(mv.get("z", 0)) if mv is not None else 0.0)
            grid = load_inout_gridvel(
                _os.path.join(casedir, fname if fname.endswith(".csv")
                              else fname + ".csv"), posmin=org)
            vz = _sget(zn, "usevelz", default="false")
            relaxzones.append(RelaxZoneExternal(
                center=_xyz(zn.find("center")),
                width=_fget(zn, "width", default=0.2),
                grid=grid,
                depth=_fget(zn, "depth", default=0.0),
                swl=_fget(zn, "swl", default=0.0),
                usevelz=str(vz).lower() in ("true", "1"),
                coefdir=_xyz(zn.find("coefdir"), (1.0, 0.0, 0.0)),
                driftcorrection=_fget(zn, "driftcorrection", default=0.0),
                driftinitialramp=_fget(zn, "driftinitialramp", default=0.0),
                **_rz_common(zn)))
        for zn in rz.findall("rz_uniform"):
            if zn.get("active", "true").lower() in ("false", "0"):
                continue
            db = zn.find("domainbox")
            p0 = _xyz(db.find("point")) if db is not None else (0, 0, 0)
            sz = _xyz(db.find("size")) if db is not None else (1, 1, 1)
            dirv = _xyz(db.find("direction"), (1.0, 0.0, 0.0)) \
                if db is not None else (1.0, 0.0, 0.0)
            rot = db.find("rotateaxis") if db is not None else None
            axes = sizes = None
            if rot is not None:
                # oriented domainbox: rotate corner + unit axes; membership
                # becomes the reference's three-plane test
                # (KerSetFluidVelUniform dompla1..3, JRelaxZone_ker.cu:60-73)
                R, a1 = _read_rotateaxis(rot)
                org = np.array([p0[i] if sz[i] >= 0 else p0[i] + sz[i]
                                for i in range(3)], np.float64)
                org = a1 + R @ (org - a1)
                axes = tuple(tuple(R[:, i]) for i in range(3))
                sizes = tuple(abs(float(s)) for s in sz)
                dirv = tuple(R @ np.asarray(dirv, np.float64))
            if rot is not None:
                pmin = tuple(org)
                pmax = tuple(org + np.asarray(axes).T @ np.asarray(sizes))
                # blend axis = box axis most aligned with the direction
                # (solve in the box frame since sizes are box-frame order)
                axis = int(np.argmax(np.abs(
                    np.linalg.solve(np.asarray(axes).T,
                                    np.asarray(dirv, np.float64)))))
            else:
                pmin = tuple(min(p0[i], p0[i] + sz[i]) for i in range(3))
                pmax = tuple(max(p0[i], p0[i] + sz[i]) for i in range(3))
                axis = int(np.argmax(np.abs(np.asarray(dirv))))
            vt = zn.find("velocitytimes")
            vts, vvs = (), ()
            if vt is not None:
                rows = [(float(e.get("time")), float(e.get("v")))
                        for e in vt.findall("timevalue")]
                rows.sort()
                vts = tuple(r[0] for r in rows)
                vvs = tuple(r[1] for r in rows)
            v0 = _fget(zn, "velocity", default=0.0)
            dirn = np.asarray(dirv, np.float64)
            dirn = tuple(dirn / max(np.linalg.norm(dirn), 1e-12))
            relaxzones.append(RelaxZoneUniform(
                pmin=pmin, pmax=pmax,
                vel=tuple(v0 * d for d in dirn),
                veltimes=vts, velvalues=vvs, direction=dirn, axis=axis,
                axes=axes, sizes=sizes,
                **_rz_common(zn)))

    accinputs = []
    ai = sp.find("accinputs")
    if ai is not None and ai.get("active", "true").lower() \
            not in ("false", "0"):
        import os as _os
        from ..features.accinput import AccInput, load_accinput_csv
        from ..tools.common import parse_range_filter
        for an in ai.findall("accinput"):
            if an.get("active", "true").lower() in ("false", "0"):
                continue
            tw = an.find("time")
            gg = _fget(an, "globalgravity", default=1.0)
            fil = an.find("acctimesfile")
            if fil is not None:
                times, lins, angs = load_accinput_csv(
                    _os.path.join(casedir, fil.get("value")))
            else:
                times, lins, angs = [], [], []
                at = an.find("acctimes")
                for tv in (at.findall("timevalue") if at is not None else ()):
                    times.append(float(tv.get("time", 0)))
                    lins.extend(float(tv.get(k, 0))
                                for k in ("linx", "liny", "linz"))
                    angs.extend(float(tv.get(k, 0))
                                for k in ("angx", "angy", "angz"))
                times, lins, angs = tuple(times), tuple(lins), tuple(angs)
            mkb = an.get("mkbound")
            accinputs.append(AccInput(
                mkfluid=int(float(an.get("mkfluid", -1))),
                mkbound=tuple(int(v) for v in parse_range_filter(mkb))
                if mkb else (),
                times=times, acclin=lins,
                accang=angs if any(angs) else (),
                centre=_xyz(an.find("acccentre")),
                gravity_enabled=bool(gg),
                tstart=float(tw.get("start", 0)) if tw is not None else 0.0,
                tend=float(tw.get("end", 1e30)) if tw is not None else 1e30))

    gauges = []
    gauge_windows = {}
    gauge_computedts = {}
    gnode = sp.find("gauges")
    if gnode is not None and gnode.get("active", "true").lower() \
            not in ("false", "0"):
        from ..features.gauges import (GaugeForce, GaugeMaxZ, GaugeSwl,
                                       GaugeVel)

        # <default><computedt value/> applies to gauges without their own
        # (reference JGaugeSystem defaults, _FmtXML_Gauges.xml:12)
        dflt = gnode.find("default")
        default_cdt = None
        if dflt is not None:
            dcd = dflt.find("computedt")
            if dcd is not None:
                default_cdt = float(dcd.get("value", 0.0)) or None

        def _window(el, name):
            ct = el.find("computetime")
            if ct is not None:
                gauge_windows[name] = (float(ct.get("start", 0.0)),
                                       float(ct.get("end", 1e30)))
            cd_el = el.find("computedt")
            cdt = (float(cd_el.get("value", 0.0)) if cd_el is not None
                   else default_cdt)
            if cdt:
                gauge_computedts[name] = cdt

        for el in gnode.findall("velocity"):
            if el.get("active", "true").lower() in ("false", "0"):
                continue
            name = el.get("name", f"vel{len(gauges)}")
            gauges.append(GaugeVel(name=name, point=_xyz(el.find("point"))))
            _window(el, name)
        for el in gnode.findall("swl"):
            if el.get("active", "true").lower() in ("false", "0"):
                continue
            name = el.get("name", f"swl{len(gauges)}")
            pdp = el.find("pointdp")
            if pdp is not None and pdp.get("coefdp") is not None:
                pointdp = float(pdp.get("coefdp")) * csp.dp
            else:
                pointdp = float(pdp.get("value")) if pdp is not None \
                    else 2.0 * csp.dp
            ml = el.find("masslimit")
            masslimit = 0.0
            if ml is not None:
                if ml.get("coef") is not None:
                    # coef of the reference's submerged mass; our mass sum
                    # saturates at ~rhopzero, so coef maps onto it directly
                    masslimit = float(ml.get("coef")) * csp.rhopzero
                elif ml.get("value") is not None:
                    masslimit = float(ml.get("value")) / csp.massfluid \
                        * csp.rhopzero
            gauges.append(GaugeSwl(
                name=name, point0=_xyz(el.find("point0")),
                point2=_xyz(el.find("point2")), pointdp=pointdp,
                masslimit=masslimit))
            _window(el, name)
        for el in gnode.findall("maxz"):
            if el.get("active", "true").lower() in ("false", "0"):
                continue
            name = el.get("name", f"maxz{len(gauges)}")
            dl = el.find("distlimit")
            dist = 2.0 * csp.dp
            if dl is not None:
                if dl.get("coefdp") is not None:
                    dist = float(dl.get("coefdp")) * csp.dp
                elif dl.get("coefh") is not None:
                    dist = float(dl.get("coefh")) * csp.kernelh
                elif dl.get("value") is not None:
                    dist = float(dl.get("value"))
            gauges.append(GaugeMaxZ(
                name=name, point0=_xyz(el.find("point0")),
                height=_fget(el, "height", default=1e30), distlimit=dist))
            _window(el, name)
        for el in gnode.findall("force"):
            if el.get("active", "true").lower() in ("false", "0"):
                continue
            name = el.get("name", f"force{len(gauges)}")
            tg = el.find("target")
            gauges.append(GaugeForce(
                name=name,
                mkbound=int(float(tg.get("mkbound", 0)))
                if tg is not None else 0))
            _window(el, name)

    io = sp.find("inout")
    iocfg = None
    if io is not None:
        def _perp(d):
            """Any unit vector perpendicular to d."""
            d = np.asarray(d, np.float64)
            a = np.array([0.0, 0.0, 1.0]) if abs(d[2]) < 0.9 \
                else np.array([1.0, 0.0, 0.0])
            t = np.cross(d, a)
            return t / np.linalg.norm(t)

        _DIRV = {"right": (1, 0, 0), "left": (-1, 0, 0),
                 "top": (0, 0, 1), "bottom": (0, 0, -1),
                 "back": (0, 1, 0), "front": (0, -1, 0)}

        for zn in io.findall("inoutzone"):
            layers = int(_fget(zn, "layers", default=4))
            treat = int(_fget(zn, "inputtreatment", default=0))
            shape, radius = "rect", 0.0
            z2 = zn.find("zone2d")
            z3 = zn.find("zone3d")
            zpart = (z2.find("particles") if z2 is not None else None)
            if zpart is None and z3 is not None:
                zpart = z3.find("particles")
            if zpart is not None:
                # zone from special fluid particles (`<particles mkfluid=N
                # direction=...>`, _FmtXML_InOut.xml:88-144): the mk block
                # spans the inout lattice; derive the inlet plane from its
                # bounding extent along the flow direction, then free those
                # particles — init_inout re-lattices the zone volume
                mkf = int(float(zpart.get("mkfluid", "0")))
                dirv = _DIRV.get(zpart.get("direction", "right"),
                                 (1.0, 0.0, 0.0))
                d3 = np.asarray(dirv, np.float64)
                mask = (np.asarray(td.code_type(code)) == td.TYPE_FLUID) \
                    & (np.asarray(td.code_value(code)) == mkf)
                if not mask.any():
                    continue
                P = np.asarray(pos)[mask]
                s = P @ d3
                layers = max(1, int(round((s.max() - s.min()) / csp.dp)) + 1)
                plane_s = s.max() + csp.dp
                t1 = _perp(d3)
                u1 = P @ t1
                if csp.simulate2d:
                    t2v, size2 = (0.0, 1.0, 0.0), 0.0
                else:
                    t2v = np.cross(d3, t1)
                    u2 = P @ t2v
                    size2 = float(u2.max() - u2.min()) + csp.dp
                    t2v = tuple(t2v)
                size1 = float(u1.max() - u1.min()) + csp.dp
                cen = P.mean(axis=0)
                p0 = cen + (plane_s - cen @ d3) * d3
                t1 = tuple(t1)
                code = np.asarray(code).copy()
                code[mask] = int(td.code_set_special(
                    td.code_make(td.TYPE_FLUID, mkf),
                    td.SPECIAL_OUT_IGNORE))
            elif z3 is not None and z3.find("circle") is not None:
                # 3-D disc zone (`<zone3d><circle>`, _FmtXML_InOut.xml:214)
                cn = z3.find("circle")
                p0 = np.array(_xyz(cn.find("point")))
                radius = _fget(cn, "radius", attr="v", default=0.0)
                dirv = _xyz(cn.find("direction"), (1.0, 0.0, 0.0))
                d3 = np.asarray(dirv, np.float64)
                d3 = d3 / np.linalg.norm(d3)
                t1v = _perp(d3)
                t2vv = np.cross(d3, t1v)
                rot = cn.find("rotateaxis")
                if rot is not None:
                    # rotated disc (Create3d_Circle rotateaxis,
                    # JSphInOutPoints.cpp:378-392)
                    R, a1 = _read_rotateaxis(rot)
                    p0 = a1 + R @ (p0 - a1)
                    d3 = R @ d3
                    t1v = R @ t1v
                    t2vv = R @ t2vv
                dirv = tuple(d3)
                t1 = tuple(t1v)
                t2v = tuple(t2vv)
                shape = "circle"
                size1 = size2 = 2.0 * radius + csp.dp
            elif z2 is not None and z2.find("line") is not None:
                ln = z2.find("line")
                p1 = np.array([float(ln.find("point").get("x")), 0.0,
                               float(ln.find("point").get("z"))])
                p2 = np.array([float(ln.find("point2").get("x")), 0.0,
                               float(ln.find("point2").get("z"))])
                dnode = ln.find("direction")
                dirv = np.array([float(dnode.get("x", 0)), 0.0,
                                 float(dnode.get("z", 0))])
                rot = ln.find("rotate")
                if rot is not None:
                    # 2-D inlet rotation about +y through point1
                    # (Create2d_Line, JSphInOutPoints.cpp:214-226)
                    R, _ = _read_rotateaxis(rot)
                    p2 = p1 + R @ (p2 - p1)
                    dirv = R @ dirv
                dirv = tuple(dirv)
                p0 = 0.5 * (p1 + p2)
                t1 = p2 - p1
                size1 = float(np.linalg.norm(t1)) + csp.dp
                t1 = tuple(t1 / np.linalg.norm(t1))
                t2v, size2 = (0.0, 1.0, 0.0), 0.0
            elif zn.find("zone3d") is not None \
                    and zn.find("zone3d").find("box") is not None:
                # 3-D box zone: a planar patch (one zero extent) + inflow
                # direction (`_FmtXML_InOut.xml:191-197`)
                bx = zn.find("zone3d").find("box")
                bp = np.array(_xyz(bx.find("point")))
                bs = np.array(_xyz(bx.find("size")))
                dirv = _xyz(bx.find("direction"), (1.0, 0.0, 0.0))
                p0 = bp + 0.5 * bs
                axes = [i for i in range(3) if bs[i] > 0]
                if len(axes) != 2:
                    # degenerate patch: treat the largest two extents
                    axes = list(np.argsort(bs)[-2:])
                e1 = np.zeros(3)
                e1[axes[0]] = 1.0
                e2 = np.zeros(3)
                e2[axes[1]] = 1.0
                t1 = tuple(e1)
                size1 = float(bs[axes[0]]) + csp.dp
                t2v = tuple(e2)
                size2 = float(bs[axes[1]]) + csp.dp
                rot = bx.find("rotateaxis")
                if rot is not None:
                    # rotate the zone frame around the given axis
                    # (`<rotateaxis>`, _FmtXML_InOut.xml:205-208)
                    R, a1 = _read_rotateaxis(rot)
                    p0 = a1 + R @ (p0 - a1)
                    dirv = tuple(R @ np.asarray(dirv, np.float64))
                    t1 = tuple(R @ np.asarray(t1, np.float64))
                    t2v = tuple(R @ np.asarray(t2v, np.float64))
            else:
                continue   # drawline point sets: later round
            iv = zn.find("imposevelocity")
            vmode = int(iv.get("mode", 0)) if iv is not None else 0
            vel_times = ()
            vel_grid = None
            vel_extrap = vmode == 2
            c0, c1, c2 = 0.0, 0.0, 0.0
            if vmode == 0 and iv is not None:
                c0 = _fget(iv, "velocity", attr="v", default=0.0)
                v2n = iv.find("velocity2")
                v3n = iv.find("velocity3")
                if v2n is not None:
                    # linear profile through (z,v),(z2,v2)
                    # (InVelP_Linear, _FmtXML_InOut.xml:232)
                    va, vb = float(v2n.get("v")), float(v2n.get("v2"))
                    za, zb = float(v2n.get("z")), float(v2n.get("z2"))
                    c1 = (vb - va) / (zb - za)
                    c0 = va - c1 * za
                elif v3n is not None:
                    # parabolic profile through 3 (z,v) points
                    # (InVelP_Parabolic, _FmtXML_InOut.xml:236)
                    vs3 = [float(v3n.get(a)) for a in ("v", "v2", "v3")]
                    zs3 = [float(v3n.get(a)) for a in ("z", "z2", "z3")]
                    c2, c1, c0 = np.polyfit(zs3, vs3, 2)
            elif vmode == 1 and iv is not None:
                tv = [(float(t.get("time")), float(t.get("v")))
                      for t in iv.iter("timevalue")]
                vel_times = tuple(tv)
                c0 = 1.0
            elif vmode == 3 and iv is not None:
                # interpolated grid velocity (JSphInOutGridData, mode 3)
                gn = iv.find("gridveldata")
                if gn is not None:
                    import os as _os
                    from ..features.inout import load_inout_gridvel
                    pz = iv.find("gridposzero")
                    org = ((float(pz.get("x", 0)), float(pz.get("z", 0)))
                           if pz is not None else (p0[0], 0.0))
                    vel_grid = load_inout_gridvel(
                        _os.path.join(casedir, gn.get("file")), posmin=org)
            # <imposevelocity><awas>: SWL-feedback velocity correction
            # (JSphInOutVelAwas::ReadXml, JSphInOutVelAwas.cpp:84-110)
            io_awas = None
            an = iv.find("awas") if iv is not None else None
            if an is not None:
                import os as _os
                from ..features.inout import InOutAwas
                depth = _fget(an, "depth", default=1.0)
                zf = an.find("zsurffile")
                if zf is not None:
                    rows = np.loadtxt(_os.path.join(casedir, zf.get("file")),
                                      comments="#", delimiter=None, ndmin=2)
                    zts = tuple(rows[:, 0])
                    zvs = tuple(rows[:, 1])
                else:
                    zts, zvs = (0.0,), (zsurf,)
                gxel = an.find("gaugex")
                gx = p0[0] + 5.0 * csp.dp  # default: 5*Dp inside the inlet
                if gxel is not None:
                    if gxel.get("value") is not None:
                        gx = float(gxel.get("value"))
                    elif gxel.get("valueh") is not None:
                        gx = p0[0] + float(gxel.get("valueh")) * csp.kernelh
                    elif gxel.get("valuedp") is not None:
                        gx = p0[0] + float(gxel.get("valuedp")) * csp.dp
                imv = _sget(an, "inletmode", default="true")
                io_awas = InOutAwas(
                    inletmode=str(imv).lower() in ("true", "1"),
                    startawas=_fget(an, "startawas", default=0.0),
                    depth=depth,
                    zsurf_t=zts, zsurf_v=zvs,
                    gauge_x=gx,
                    gauge_y=_fget(an, "gaugey", default=p0[1]),
                    z0=(zvs[0] if zvs else zsurf) - depth)
            ir = zn.find("imposerhop")
            rmode = int(ir.get("mode", 0)) if ir is not None else 0
            rho_mode = "hydrostatic" if rmode == 1 else "constant"
            rho_extrap = rmode == 2
            # <imposezsurf mode=0|1|2>: fixed / time series / calculated
            # (JSphInOutZsurf, _FmtXML_InOut.xml:304-330)
            zzs = zn.find("imposezsurf")
            zone_zsurf, zsurf_times, zsurf_calc = zsurf, (), False
            if zzs is not None:
                zmode = int(zzs.get("mode", 0))
                zone_zsurf = _fget(zzs, "zsurf", default=zsurf)
                if zmode == 1:
                    ztn = zzs.find("zsurftimes")
                    if ztn is not None:
                        zsurf_times = tuple(
                            (float(t.get("time")), float(t.get("zsurf")))
                            for t in ztn.iter("timevalue"))
                    else:
                        zf = zzs.find("zsurffile")
                        if zf is not None:
                            import os as _os
                            rows = np.loadtxt(
                                _os.path.join(casedir, zf.get("file")),
                                comments="#", delimiter=None, ndmin=2)
                            zsurf_times = tuple(map(tuple, rows[:, :2]))
                elif zmode == 2:
                    zsurf_calc = True
            # refilling mode (TpInRefilling; <refilling> per zone +
            # global <refillingrate>, _FmtXML_InOut.xml:15-17)
            refmode = int(_fget(zn, "refilling", default=0))
            refill = {0: "simplefull", 1: "simplezsurf",
                      2: "advanced"}.get(refmode, "simplefull")
            refrate = int(_fget(io, "refillingrate", default=10))
            iozones.append(InOutZone(
                p0=tuple(p0), direction=dirv, layers=layers,
                tangent1=t1, size1=size1,
                tangent2=t2v, size2=size2,
                vel_profile=(c0, c1, c2), vel_times=vel_times,
                vel_grid=vel_grid, vel_extrap=vel_extrap,
                rho_mode=rho_mode, zsurf=zone_zsurf, rho_extrap=rho_extrap,
                zsurf_times=zsurf_times, zsurf_calc=zsurf_calc,
                shape=shape, radius=radius,
                capture_fluid=(treat != 0),
                refill=refill, refillrate=refrate, awas=io_awas))
        if iozones:
            iocfg = InOutCfg(zones=tuple(iozones),
                             determlimit=float(_fget(io, "determlimit",
                                                     default=1e3)))
    return code, dict(damping=tuple(damping), motions=tuple(motions),
                      inout=iocfg, awas=tuple(awas),
                      mlpistons=tuple(mlpistons),
                      relaxzones=tuple(relaxzones),
                      accinputs=tuple(accinputs),
                      gauges=tuple(gauges), gauge_windows=gauge_windows,
                      gauge_computedts=gauge_computedts)


def load_case(path, *, mdbc=False, capacity=None):
    """Parse a *_Def.xml into (Case, SolverOpts, runparams dict)."""
    try:
        tree = ET.parse(path)
    except ET.ParseError:
        # tolerate tinyxml-isms the shipped cases use (e.g. the
        # `<!---Phase 1--->` triple-dash comments in
        # CaseWetDambreak2DNN_Def.xml) that strict XML rejects
        import io
        import re
        txt = open(path, encoding="latin1").read()
        txt = re.sub(r"<!-+-", "<!-- ", txt)
        txt = re.sub(r"-+->", " -->", txt)
        # stray '<' in attribute prose (e.g. comment="... <1 for shear
        # thinning" in the shipped HBP_n lines)
        txt = re.sub(r"<(?![a-zA-Z_/!?])", "&lt;", txt)
        tree = ET.parse(io.StringIO(txt))
    root = tree.getroot()
    cdef = root.find("casedef")
    ctes = cdef.find("constantsdef")
    geo = cdef.find("geometry")

    gravity = (float(ctes.find("gravity").get("x")),
               float(ctes.find("gravity").get("y")),
               float(ctes.find("gravity").get("z")))
    rhop0 = _fget(ctes, "rhop0", default=1000.0)
    gamma = _fget(ctes, "gamma", default=7.0)
    coefsound = _fget(ctes, "coefsound", default=20.0)
    speedsound = _fget(ctes, "speedsound", default=0.0) or 0.0
    coefh = _fget(ctes, "coefh", default=1.0)
    hdp = _fget(ctes, "_hdp", default=0.0) or 0.0
    hswl = _fget(ctes, "hswl", default=0.0) or 0.0
    cfl = _fget(ctes, "cflnumber", default=0.2)

    defn = geo.find("definition")
    dp = float(defn.get("dp"))
    ptmin = defn.find("pointmin")
    sim2d = ptmin is not None and ptmin.get("y") == ptmin.get("y") and \
        float(defn.find("pointmax").get("y")) == float(ptmin.get("y"))

    # ---- geometry commands (GenCase drawbox subset) -------------------------
    draw = C.Draw(dp=dp, simulate2d=sim2d)
    mode = dict(type=td.TYPE_FLUID, mk=0)
    drawmode = "full"
    zfluid_max = -1e30

    # geometry-time expression variables (JNumexLib in GenCase: <setvar>/
    # <newvar> + #expr attribute values; case constants are not derived yet,
    # so the table starts from Dp + <casedef><uservars>)
    from ..utils import numex as _NX
    nuxg = _NX.NumexVars({"Dp": dp})
    _NX.load_uservars(root, nuxg)

    def fnum(v, default=0.0):
        if v is None:
            return default
        s = str(v).strip()
        try:
            return float(s)
        except ValueError:
            return nuxg.compute(s.lstrip("#"))

    def xyzE(el, default=(0.0, 0.0, 0.0)):
        if el is None:
            return default
        return tuple(fnum(el.get(a), d) for a, d in zip("xyz", default))

    defn_lo = np.array([float(ptmin.get(a)) for a in "xyz"]) \
        if ptmin is not None else np.array([-1e9] * 3)
    _ptmax = defn.find("pointmax")
    defn_hi = np.array([float(_ptmax.get(a)) for a in "xyz"]) \
        if _ptmax is not None else np.array([1e9] * 3)
    # transformation-matrix stack (GenCase <move>/<rotate>/<scale>/
    # <matrixsave>/<matrixload>/<matrixreset>): commands compose onto M,
    # drawn geometry maps through it
    M = np.eye(4)
    mstack = []

    def X(p):
        q = M @ np.array([p[0], p[1], p[2], 1.0])
        return q[:3]

    def m_ident():
        return np.allclose(M, np.eye(4))

    def _rot_about(ang_deg, axis, pivot=(0.0, 0.0, 0.0)):
        a = np.asarray(axis, np.float64)
        a = a / max(np.linalg.norm(a), 1e-30)
        # the DualSPHysics transform stack rotates CLOCKWISE about the axis
        # for positive angles (JMatrix4::MatrixRot rz = [c s; -s c],
        # JMatrix4.h:356) — negate for the right-handed Rodrigues form below
        th = math.radians(-ang_deg)
        c, s = math.cos(th), math.sin(th)
        x, y, z = a
        R = np.array([
            [c + x * x * (1 - c), x * y * (1 - c) - z * s,
             x * z * (1 - c) + y * s],
            [y * x * (1 - c) + z * s, c + y * y * (1 - c),
             y * z * (1 - c) - x * s],
            [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s,
             c + z * z * (1 - c)]])
        T = np.eye(4)
        T[:3, :3] = R
        pv = np.asarray(pivot, np.float64)
        T[:3, 3] = pv - R @ pv
        return T

    linecur = None          # <setlinebegin>/<drawlineto> polyline cursor
    draw_active = True      # <setactive drawpoints=.../>
    mkstack = []            # <mksave>/<mkload>
    mknext_auto = False     # <setmknextauto>: mk += 1 after each draw
    cellsout_snaps = []     # <cellsout file=...> lattice snapshots

    # <list name=...> macro definitions, invoked by <runlist name=...>
    # (GenCase command lists, e.g. examples/others/RedrawGenCase)
    cmdlists = {l.get("name"): list(l)
                for l in geo.find("commands").findall("list")}

    def _expand(cmds, depth=0):
        out = []
        for c in cmds:
            if c.tag == "runlist":
                if depth > 16:
                    raise ValueError("runlist recursion too deep")
                out.extend(_expand(cmdlists.get(c.get("name"), ()),
                                   depth + 1))
            else:
                out.append(c)
        return out

    for cmd in _expand(geo.find("commands").find("mainlist")):
        tag = cmd.tag
        if tag == "setactive":
            v = cmd.get("drawpoints")
            if v is not None:
                draw_active = v.lower() not in ("false", "0")
            continue
        if not draw_active and (tag.startswith("draw")
                                or tag.startswith("fill")):
            continue
        if tag == "move":
            T = np.eye(4)
            T[:3, 3] = [float(cmd.get(a, 0.0)) for a in "xyz"]
            M = M @ T
        elif tag == "scale":
            T = np.eye(4)
            for i, a in enumerate("xyz"):
                T[i, i] = float(cmd.get(a, 1.0))
            M = M @ T
        elif tag in ("rotate", "rotateaxis"):
            ang = float(cmd.get("ang", cmd.get("angle", 0.0)))
            if tag == "rotate":
                axis = tuple(float(cmd.get(a, 0.0)) for a in "xyz") \
                    or (0.0, 0.0, 1.0)
                M = M @ _rot_about(ang, axis if any(axis) else (0, 0, 1))
            else:
                ax = cmd.find("axisp1")
                ax2 = cmd.find("axisp2")
                p1 = np.array(_xyz(ax))
                p2 = np.array(_xyz(ax2, (0.0, 0.0, 1.0)))
                M = M @ _rot_about(ang, p2 - p1, pivot=p1)
        elif tag == "rotateline":
            ang = float(cmd.get("ang", 0.0))
            pts = cmd.findall("point")
            if len(pts) >= 2:
                p1 = np.array(_xyz(pts[0]))
                p2 = np.array(_xyz(pts[1]))
                M = M @ _rot_about(ang, p2 - p1, pivot=p1)
        elif tag == "matrixsave":
            mstack.append(M.copy())
        elif tag == "matrixload":
            M = mstack.pop() if mstack else np.eye(4)
        elif tag == "matrixreset":
            M = np.eye(4)
        elif tag == "setmkfluid":
            mode = dict(type=td.TYPE_FLUID, mk=int(cmd.get("mk", 0)))
        elif tag == "setmkbound":
            mode = dict(type=td.TYPE_FIXED, mk=int(cmd.get("mk", 0)))
        elif tag == "setmkvoid":
            mode = dict(type=None, mk=0)
        elif tag == "drawbox" and mode["type"] is None:
            pt = cmd.find("point")
            sz = cmd.find("size")
            p0 = np.array(xyzE(pt))
            sv = np.array(xyzE(sz))
            draw.voidbox(tuple(p0), tuple(p0 + sv))
        elif tag == "drawbox" and mode is not None:
            fill = (cmd.find("boxfill").text or "solid").strip()
            pt = cmd.find("point")
            sz = cmd.find("size")
            p0 = np.array(xyzE(pt))
            s = np.array(xyzE(sz))
            faces = "solid" if "solid" in fill else fill.replace(" ", "")
            if m_ident():
                draw.box(tuple(p0), tuple(p0 + s), ptype=mode["type"],
                         mk=mode["mk"], faces=faces)
            else:
                # transformed box: solid via inverse-map predicate, face
                # modes via face triangles through M
                corners = np.array([X(p0 + s * np.array(b))
                                    for b in np.ndindex(2, 2, 2)])
                if faces == "solid":
                    Minv = np.linalg.inv(M)

                    def bpred(pts, p0=p0.copy(), s=s.copy(), Minv=Minv):
                        q = (Minv[:3, :3] @ pts.T).T + Minv[:3, 3]
                        eps = 1e-9
                        return np.all((q >= p0 - eps)
                                      & (q <= p0 + s + eps), axis=1)

                    draw.solid_pred(bpred, (corners.min(0) - dp,
                                            corners.max(0) + dp),
                                    ptype=mode["type"], mk=mode["mk"])
                else:
                    want = set(faces.split("|"))
                    tris = []
                    fdefs = {
                        "left": [(0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1)],
                        "right": [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
                        "front": [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
                        "back": [(0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1)],
                        "bottom": [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)],
                        "top": [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
                    }
                    for name, quad in fdefs.items():
                        if name in want or "all" in want:
                            q = [X(p0 + s * np.array(b)) for b in quad]
                            tris += [[q[0], q[1], q[2]], [q[0], q[2], q[3]]]
                    if tris:
                        draw.tri_surface(tris, ptype=mode["type"],
                                         mk=mode["mk"])
            if mode["type"] == td.TYPE_FLUID:
                zfluid_max = max(zfluid_max,
                                 float(np.array([X(p0 + s * np.array(b))
                                                 for b in np.ndindex(2, 2, 2)
                                                 ])[:, 2].max()))
        elif tag == "setdrawmode":
            drawmode = cmd.get("mode", "full")
        elif tag == "drawsphere" and mode is not None \
                and mode["type"] is not None:
            c = X(xyzE(cmd.find("point")))
            draw.sphere(c, fnum(cmd.get("radius")), ptype=mode["type"],
                        mk=mode["mk"], solid=(drawmode != "face"))
            if mode["type"] == td.TYPE_FLUID:
                zfluid_max = max(zfluid_max, c[2] + float(cmd.get("radius")))
        elif tag == "drawcylinder" and mode is not None \
                and mode["type"] is not None:
            pts = cmd.findall("point") + cmd.findall("point2")
            if len(pts) >= 2:
                c1, c2 = X(xyzE(pts[0])), X(xyzE(pts[1]))
                draw.cylinder(c1, c2, fnum(cmd.get("radius")),
                              ptype=mode["type"], mk=mode["mk"],
                              solid=(drawmode != "face"))
                if mode["type"] == td.TYPE_FLUID:
                    zfluid_max = max(zfluid_max, max(c1[2], c2[2]))
        elif tag == "fillbox" and mode is not None and mode["type"] is not None:
            seed = tuple(fnum(cmd.get(a), 0.0) for a in "xyz")
            pt = cmd.find("point")
            sz = cmd.find("size")
            p0 = np.array(xyzE(pt))
            sv = np.array(xyzE(sz))
            draw.fillbox(seed, tuple(p0), tuple(p0 + sv),
                         ptype=mode["type"], mk=mode["mk"])
            if mode["type"] == td.TYPE_FLUID:
                zfluid_max = max(zfluid_max, seed[2] if sv[2] > 1e20
                                 else p0[2] + sv[2])
        elif tag in ("drawpoint", "drawpoints") and mode["type"] is not None:
            for pn in ([cmd] if tag == "drawpoint" else cmd.findall("point")):
                draw.pointmark(X(_xyz(pn if tag == "drawpoints" else (
                    cmd.find("point") if cmd.find("point") is not None
                    else cmd))),
                               ptype=mode["type"], mk=mode["mk"])
        elif tag in ("drawline", "drawlines") and mode["type"] is not None:
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            for a, b in zip(pts[:-1], pts[1:]):
                draw.segment(a, b, ptype=mode["type"], mk=mode["mk"])
        elif tag in ("drawtriangle", "drawtriangles", "drawquadri") \
                and mode["type"] is not None:
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            tris = []
            if tag == "drawquadri" and len(pts) >= 4:
                tris = [[pts[0], pts[1], pts[2]], [pts[0], pts[2], pts[3]]]
            else:
                for i0 in range(0, len(pts) - 2, 3 if tag == "drawtriangles"
                                else len(pts)):
                    tris.append(pts[i0:i0 + 3])
                if tag == "drawtriangle" and len(pts) >= 3:
                    tris = [pts[:3]]
            if tris:
                draw.tri_surface(tris, ptype=mode["type"], mk=mode["mk"])
        elif tag in ("drawprism", "drawpolygon", "drawextrude") \
                and mode["type"] is not None:
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            exn = cmd.find("extrude")
            if exn is not None:
                ev = _xyz(exn, (0.0, 0.0, 0.0))
                evw = X(ev) - X((0.0, 0.0, 0.0))
            elif tag == "drawprism" and len(pts) >= 6 \
                    and len(pts) % 2 == 0:
                # template format: base polygon then the extruded copy
                # (CaseTemplate.xml:256-263)
                half = len(pts) // 2
                evw = np.asarray(pts[half]) - np.asarray(pts[0])
                pts = pts[:half]
            else:
                evw = np.zeros(3)
            if len(pts) >= 3:
                draw.prism(np.asarray(pts), evw, ptype=mode["type"],
                           mk=mode["mk"], solid=(drawmode != "face"))
        elif tag in ("drawfilestl", "drawfileply", "drawfilevtk") \
                and mode["type"] is not None:
            from .meshfile import load_mesh
            import os as _osm
            fn = cmd.get("file")
            tris = load_mesh(_osm.path.join(
                _osm.path.dirname(_osm.path.abspath(path)), fn))
            # optional local transform attributes of the draw command
            sc = cmd.find("drawscale")
            if sc is not None:
                tris = tris * np.array([[_xyz(sc, (1.0, 1.0, 1.0))]])
            mv = cmd.find("drawmove")
            if mv is not None:
                tris = tris + np.array([[_xyz(mv)]])
            rt = cmd.find("drawrotate")
            if rt is not None:
                Rm = _rot_about(float(rt.get("angx", 0.0)), (1, 0, 0))[:3, :3] \
                    @ _rot_about(float(rt.get("angy", 0.0)), (0, 1, 0))[:3, :3] \
                    @ _rot_about(float(rt.get("angz", 0.0)), (0, 0, 1))[:3, :3]
                tris = tris @ Rm.T
            shp = tris.reshape(-1, 3)
            shp = (M[:3, :3] @ shp.T).T + M[:3, 3]
            draw.tri_surface(shp.reshape(-1, 3, 3), ptype=mode["type"],
                             mk=mode["mk"])
        elif tag in ("setvar", "newvar"):
            # <setvar a="expr" b="expr"/>: sequential assignments over the
            # geometry variable table (JNumexLib)
            for k, v in cmd.attrib.items():
                if not k.startswith("_"):
                    nuxg.set(k, fnum(v))
        elif tag == "drawellipsoid" and mode["type"] is not None:
            pts = cmd.findall("point")
            if len(pts) >= 2:
                draw.ellipsoid(X(xyzE(pts[0])), X(xyzE(pts[1])),
                               radius=fnum(cmd.get("radius"), 1.0),
                               ptype=mode["type"], mk=mode["mk"],
                               solid=(drawmode != "face"))
        elif tag in ("fillpoint", "fillvoidpoint"):
            seed = X(tuple(fnum(cmd.get(a), 0.0) for a in "xyz"))
            mf = cmd.find("modefill")
            mfv = (mf.text or "").strip() if mf is not None else ""
            if tag == "fillvoidpoint" or mfv == "void":
                # region flood-erase: fill with a sentinel then delete
                pass  # void fill erases nothing drawn; no-op on empty space
            else:
                fm = mode["type"]
                fmk = mode["mk"]
                if cmd.get("mkfluid") is not None:
                    fm, fmk = td.TYPE_FLUID, int(float(cmd.get("mkfluid")))
                elif cmd.get("mkbound") is not None:
                    fm, fmk = td.TYPE_FIXED, int(float(cmd.get("mkbound")))
                if fm is not None:
                    draw.fillpoint(seed, (defn_lo, defn_hi), ptype=fm,
                                   mk=fmk)
                    if fm == td.TYPE_FLUID:
                        zfluid_max = max(zfluid_max, float(defn_hi[2]))
        elif tag == "setlinebegin":
            linecur = X(tuple(fnum(cmd.get(a), 0.0) for a in "xyz"))
        elif tag == "drawlineto" and mode["type"] is not None:
            p2 = X(tuple(fnum(cmd.get(a), 0.0) for a in "xyz"))
            if linecur is not None:
                draw.segment(linecur, p2, ptype=mode["type"], mk=mode["mk"])
            linecur = p2
        elif tag in ("drawtrianglesstrip", "drawtrianglesfan") \
                and mode["type"] is not None:
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            tris = []
            for i in range(len(pts) - 2):
                if tag == "drawtrianglesfan":
                    tris.append([pts[0], pts[i + 1], pts[i + 2]])
                else:
                    tris.append([pts[i], pts[i + 1], pts[i + 2]])
            if tris:
                draw.tri_surface(tris, ptype=mode["type"], mk=mode["mk"])
        elif tag == "drawfigure" and mode["type"] is not None:
            # indexed triangle list: <points> + <triangles> with vertex
            # indices in the triangle's x/y/z attributes (CaseTemplate.xml)
            pn = cmd.find("points")
            tn = cmd.find("triangles")
            if pn is not None and tn is not None:
                vtx = [X(_xyz(p)) for p in pn.findall("point")]
                tris = []
                for t in tn.findall("triangle"):
                    i, j, k = (int(float(t.get(a, 0))) for a in "xyz")
                    if max(i, j, k) < len(vtx):
                        tris.append([vtx[i], vtx[j], vtx[k]])
                if tris:
                    draw.tri_surface(tris, ptype=mode["type"], mk=mode["mk"])
        elif tag == "drawpyramid" and mode["type"] is not None:
            # apex first, then the base polygon (CaseTemplate.xml:250-255);
            # the face mask filter is not modelled — all faces rasterize
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            if len(pts) >= 3:
                apex, base = pts[0], pts[1:]
                m = len(base)
                tris = [[apex, base[i], base[(i + 1) % m]] for i in range(m)]
                ctr = np.mean(np.asarray(base), axis=0)
                tris += [[ctr, base[i], base[(i + 1) % m]] for i in range(m)]
                draw.tri_surface(tris, ptype=mode["type"], mk=mode["mk"])
        elif tag == "drawbeach" and mode["type"] is not None:
            # beach profile polyline extruded across the flume width: the
            # profile lies in a constant-y plane and extrudes back to y=0
            # (CaseTemplate.xml:307-314 gives all points at the far width)
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            if len(pts) >= 2:
                ybar = float(np.mean([p[1] for p in pts]))
                ev = np.array([0.0, -ybar, 0.0])
                tris = []
                for a, b in zip(pts[:-1], pts[1:]):
                    a = np.asarray(a)
                    b = np.asarray(b)
                    tris += [[a, b, b + ev], [a, b + ev, a + ev]]
                draw.tri_surface(tris, ptype=mode["type"], mk=mode["mk"])
        elif tag == "drawwave" and mode["type"] is not None:
            # solitary-wave initial fluid block: surface elevation
            # z0 + hmax*sech^2(k(x-x0)), k=sqrt(3 hmax / (4 depth^3))
            # (Boussinesq profile; template CaseTemplate.xml:345-348)
            depth = fnum(cmd.get("depth"), 1.0)
            hmax = fnum(cmd.get("hmaxwave"), 0.0)
            x0w = fnum(cmd.get("x0"), 0.0)
            z0w = fnum(cmd.get("z0"), 0.0)
            p0 = np.array(xyzE(cmd.find("point")))
            sv = np.array(xyzE(cmd.find("size")))
            kw = math.sqrt(3.0 * max(hmax, 1e-12)
                           / (4.0 * max(depth, 1e-12) ** 3))

            def wpred(pts, p0=p0, sv=sv):
                sech = 1.0 / np.cosh(kw * (pts[:, 0] - x0w))
                eta = z0w + hmax * sech * sech
                inb = np.all((pts >= p0[None] - 1e-9)
                             & (pts <= (p0 + sv)[None] + 1e-9), axis=1)
                return inb & (pts[:, 2] <= eta)

            draw.solid_pred(wpred, (p0, p0 + sv), ptype=mode["type"],
                            mk=mode["mk"])
            if mode["type"] == td.TYPE_FLUID:
                zfluid_max = max(zfluid_max, z0w + hmax)
        elif tag in ("drawbathymetry", "drawfilecsv") \
                and mode["type"] is not None:
            import os as _osb
            cdir = _osb.path.dirname(_osb.path.abspath(path))
            if tag == "drawfilecsv":
                pts3 = _load_xyz_points(_osb.path.join(cdir, cmd.get("file")))
                gdp = dp
            else:
                zp = cmd.find("zpoints")
                gn = cmd.find("grid")
                if gn is not None and gn.get("file"):
                    pts3 = _load_xyz_points(_osb.path.join(
                        cdir, gn.get("file")))
                    gdp = dp
                elif zp is None:
                    continue
                else:
                    pts3 = _load_xyz_points(_osb.path.join(
                        cdir, zp.get("file")))
                    gdp = fnum(gn.get("dp"), dp) if gn is not None else dp
                if zp is not None:
                    sc = zp.find("scale")
                    if sc is not None:
                        pts3 = pts3 * np.array([_xyz(sc, (1.0, 1.0, 1.0))])
                    mv = zp.find("move")
                    if mv is not None:
                        pts3 = pts3 + np.array([_xyz(mv)])
                    selq = zp.find("selection")
                    if selq is not None:
                        sp0 = np.array(_xyz(selq.find("point")))[:2]
                        ss = np.array(_xyz(selq.find("size")))[:2]
                        m2 = np.all((pts3[:, :2] >= sp0[None])
                                    & (pts3[:, :2] <= (sp0 + ss)[None]),
                                    axis=1)
                        pts3 = pts3[m2]
            # local transform children (drawfilecsv)
            sc = cmd.find("drawscale")
            if sc is not None:
                pts3 = pts3 * np.array([_xyz(sc, (1.0, 1.0, 1.0))])
            mv = cmd.find("drawmove")
            if mv is not None:
                pts3 = pts3 + np.array([_xyz(mv)])
            if len(pts3) >= 3:
                tris = _bathy_surface(pts3, gdp)
                shp = tris.reshape(-1, 3)
                shp = (M[:3, :3] @ shp.T).T + M[:3, 3]
                draw.tri_surface(shp.reshape(-1, 3, 3), ptype=mode["type"],
                                 mk=mode["mk"])
        elif tag == "fillprism":
            seed = X(tuple(fnum(cmd.get(a), 0.0) for a in "xyz"))
            pts = [X(_xyz(p)) for p in cmd.findall("point")]
            ft, fmk = _fillmode(cmd, mode)
            if ft is not None and len(pts) >= 6 and len(pts) % 2 == 0:
                from ..models.cases import prism_pred
                half = len(pts) // 2
                base = np.asarray(pts[:half])
                ev = np.asarray(pts[half]) - base[0]
                lo = np.minimum(base.min(0), (base + ev).min(0)) - dp
                hi = np.maximum(base.max(0), (base + ev).max(0)) + dp
                draw.fillpred(seed, (lo, hi), prism_pred(base, ev),
                              ptype=ft, mk=fmk)
        elif tag == "fillfigure":
            seed = X(tuple(fnum(cmd.get(a), 0.0) for a in "xyz"))
            pn = cmd.find("points")
            tn = cmd.find("triangles")
            ft, fmk = _fillmode(cmd, mode)
            if ft is not None and pn is not None and tn is not None:
                vtx = [X(_xyz(p)) for p in pn.findall("point")]
                tris = []
                for t in tn.findall("triangle"):
                    i, j, k = (int(float(t.get(a, 0))) for a in "xyz")
                    if max(i, j, k) < len(vtx):
                        tris.append([vtx[i], vtx[j], vtx[k]])
                if tris:
                    arr = np.asarray(tris)
                    lo = arr.reshape(-1, 3).min(0) - dp
                    hi = arr.reshape(-1, 3).max(0) + dp
                    draw.fillpred(seed, (lo, hi), _mesh_inside_pred(arr),
                                  ptype=ft, mk=fmk)
        elif tag == "redraw":
            ft, fmk = _redraw_filter(cmd)
            if ft is None and fmk is None:
                # filterless <redraw/>: paints EVERY cell of the definition
                # domain [pointmin, pointmax) with the current mk — incl.
                # void cells (RedrawComplex cellsout golden test_00: the
                # whole 365x130 grid carries the current Mk)
                pmn = _xyz(ptmin)
                pmx = _xyz(defn.find("pointmax"))
                draw.fill_domain(pmn, pmx, ptype=mode["type"],
                                 mk=mode["mk"])
            else:
                draw.redraw(ptype=mode["type"], mk=mode["mk"],
                            filter_type=ft, filter_mk=fmk)
        elif tag == "redrawbox":
            ft, fmk = _redraw_filter(cmd)
            pt = cmd.find("point")
            sz = cmd.find("size")
            if pt is not None and sz is not None:
                p0 = np.array(xyzE(pt))
                sv = np.array(xyzE(sz))
                draw.redraw(ptype=mode["type"], mk=mode["mk"],
                            filter_type=ft, filter_mk=fmk,
                            box=(X(p0), X(p0 + sv)))
        elif tag in ("redrawnear", "redrawnearbox"):
            # morphological repaint from border cells (CaseTemplate:514-541)
            dfl = cmd.find("dirfilter")
            dirs = None
            if dfl is not None and dfl.text and \
                    dfl.text.strip().lower() != "all":
                dirs = [d.strip() for d in dfl.text.split("|") if d.strip()]
            box = None
            if tag == "redrawnearbox":
                pt, sz = cmd.find("point"), cmd.find("size")
                if pt is not None and sz is not None:
                    p0 = np.array(xyzE(pt))
                    box = (X(p0), X(p0 + np.array(xyzE(sz))))
            tmk = cmd.get("targetmk")
            bmk = cmd.get("bordermk")
            draw.redrawnear(
                ptype=mode["type"], mk=mode["mk"],
                times=int(float(cmd.get("times", 1))),
                targettp=cmd.get("targettp", "fluid"),
                targetmk=int(float(tmk)) if tmk is not None else None,
                bordertp=cmd.get("bordertp", "bound"),
                bordermk=int(float(bmk)) if bmk is not None else None,
                dirs=dirs, box=box)
        elif tag == "cellsout":
            # GenCase debug channel: record the lattice snapshot (the
            # reference writes <file>_MkCells.vtk; exposed via
            # case.meta["cellsout"] and validated against the shipped
            # goldens in tests)
            cellsout_snaps.append((cmd.get("file", ""), draw.cell_mks()))
        elif tag == "mksave":
            mkstack.append(dict(mode))
        elif tag == "mkload":
            if mkstack:
                mode = mkstack.pop()
        elif tag == "setmknextauto":
            mknext_auto = cmd.get("auto", "true").lower() \
                not in ("false", "0")
        elif tag in ("setdpctes", "dpctesload", "dpctesreset", "setpattern",
                     "setshapemode", "shapeout", "setfrdrawmode",
                     "setboxlimitmode", "setnormalinvert", "setvarstr",
                     "setmkbackbound", "setmkbackfluid", "setmkbackvoid",
                     "setmkbackclear", "setmknextbound", "setmknextfluid"):
            # shape-output / rasterization-fineness controls: the lattice
            # generator resolves at dp, so these do not change the particle
            # set (GenCase uses them for VTK shape export and sub-dp shape
            # tesselation constants)
            pass
        # (other GenCase shapes: later rounds)
        if mknext_auto and (tag.startswith("draw") or tag.startswith("fill")) \
                and mode.get("type") is not None:
            mode = dict(mode, mk=mode["mk"] + 1)
    pos, code = draw.build()

    if not hswl:
        isfl = np.asarray(td.code_type(code) == td.TYPE_FLUID)
        hswl = (float(pos[isfl, 2].max() - pos[isfl, 2].min()) + dp
                if pos.ndim == 2 and isfl.any() else dp)

    csp = make_ctesph(
        simulate2d=sim2d, dp=dp, rhopzero=rhop0, gamma=gamma, gravity=gravity,
        coefh=coefh, hdp=hdp, hswl=hswl, coefsound=coefsound,
        speedsound=speedsound, cflnumber=cfl)

    # ---- feature blocks: floatings, motion, <special> -------------------------
    code = np.array(code)
    import os as _os0
    code, ftcfg, ftstate, dem_info = _parse_floatings(
        cdef, pos, code, csp,
        casedir=_os0.path.dirname(_os0.path.abspath(path)))
    code, motions = _parse_motion(
        cdef, code,
        casedir=_os0.path.dirname(_os0.path.abspath(path)))
    import os as _os
    code, specials = _parse_special(
        root, csp, code, zfluid_max, pos,
        casedir=_os.path.dirname(_os.path.abspath(path)))

    # canonical id order AFTER the retypes (floating/moving blocks): ids must
    # form one contiguous block per (type, mk) like GenCase assigns them —
    # the reference loader rejects split blocks (JCaseParts::Add "existing
    # mk") and our exporter feeds it
    torder = {td.TYPE_FIXED: 0, td.TYPE_MOVING: 1,
              td.TYPE_FLOATING: 2, td.TYPE_FLUID: 3}
    tkey = np.vectorize(lambda c: torder[int(c)])(
        np.asarray(td.code_type(code)))
    reorder = np.argsort(
        tkey * 1000 + np.asarray(td.code_value(code)), kind="stable")
    if not np.array_equal(reorder, np.arange(len(reorder))):
        pos = pos[reorder]
        code = code[reorder]
        if getattr(draw, "normals", None) is not None \
                and len(draw.normals) == len(reorder):
            draw.normals = draw.normals[reorder]

    # ---- execution parameters ------------------------------------------------
    P = _params(root)

    # user-defined expressions (JNumexLib + JCaseUserVars): '#'-prefixed
    # parameter values evaluate over uservars + case constants
    from ..utils import numex as NX
    nux = NX.case_vars(csp, casename=P.get("CaseName", "xmlcase"))
    NX.load_uservars(root, nux)

    def pf(key, default):
        v = P.get(key, default)
        if isinstance(v, str) and v.strip()[:1] == "#":
            return nux.compute(v.strip()[1:])
        return float(v)

    csp = csp.replace(
        visco=pf("Visco", 0.01),
        viscoboundfactor=pf("ViscoBoundFactor", 1.0),
        ddtvalue=pf("DensityDTvalue", 0.1),
        ddtkh=csp.kernelsize * pf("DensityDTvalue", 0.1),
        shiftcoef=pf("ShiftCoef", -2.0),
        shifttfs=pf("ShiftTFS", 0.0),
        coefdtmin=pf("CoefDtMin", 0.05),
        dtini=pf("DtIni", 0.0) or csp.dtini,
        dtmin=pf("DtMin", 0.0) or csp.dtmin,
        dtfixed=pf("DtFixed", 0.0),
        rhopoutmin=pf("RhopOutMin", 700.0),
        rhopoutmax=pf("RhopOutMax", 1300.0),
        tkernel=TpKernel(int(pf("Kernel", 2))),
    )
    tvisco = TpVisco(int(pf("ViscoTreatment", 1)))
    # Boundary=2 selects mDBC with SlipMode 1/2/3 (JSph::LoadConfigParameters
    # JSph.cpp:626-641); the -mdbc CLI kwarg forces it on top
    from ..typesdef import TpSlipMode
    xml_mdbc = int(pf("Boundary", 1)) == 2
    slipmode = TpSlipMode(int(pf("SlipMode", 1))) if xml_mdbc \
        else TpSlipMode.VEL0
    from ..typesdef import TpVelGrad
    opts = SolverOpts(
        tstep=TpStep(int(pf("StepAlgorithm", 1))),
        verlet_steps=int(pf("VerletSteps", 40)),
        tvisco=tvisco,
        tdensity=TpDensity(int(pf("DensityDT", 0))),
        tboundary=TpBoundary.MDBC if (mdbc or xml_mdbc) else TpBoundary.DBC,
        slipmode=slipmode,
        shiftmode=TpShifting(int(pf("Shifting", 0))),
        # mphase NN keys (JSph.cpp:610-622): VelocityGradientType 1=FDA 2=SPH,
        # RelaxationDt = dt3 lamda; both inert on single-phase runs
        velgrad=TpVelGrad(int(pf("VelocityGradientType", 1))),
        relaxationdt=pf("RelaxationDt", 0.2),
        # per-dt floating motion record (JFtMotionSave; <parameters>
        # FtSaveMotion = tout2, enabled when >= 0, JSph.cpp:592)
        ftmotion=(8192 if ftcfg is not None
                  and pf("FtSaveMotion", -1.0) >= 0 else 0),
        symmetry=bool(int(pf("Symmetry", 0))),
    )
    # <special><savedt>: per-dt diagnostics ring (JDsSaveDt,
    # _FmtXML_SaveDt.xml) — activates the same channel as CLI -savedt
    sdnode = root.find(".//special/savedt")
    if sdnode is not None and sdnode.get("active", "true").lower() \
            not in ("false", "0"):
        import dataclasses as _dcs
        opts = _dcs.replace(opts, savedt=8192)
    if opts.symmetry:
        # reference restrictions (JSph.cpp:1174-1179)
        if sim2d:
            raise ValueError("Symmetry is not allowed with 2-D simulations")
        if ftcfg is not None:
            raise ValueError("Symmetry is not allowed with floating bodies")
        if opts.tvisco != TpVisco.ARTIFICIAL:
            raise ValueError("Symmetry is only allowed with artificial "
                             "viscosity")
    mdbc = mdbc or xml_mdbc

    # ---- domain + state -------------------------------------------------------
    ks = csp.kernelsize
    pmin = pos.min(axis=0) - 2 * ks
    pmax = pos.max(axis=0) + 2 * ks
    pmin, pmax = _sim_domain(root, pmin, pmax)
    if sim2d:
        pmin[1], pmax[1] = pos[0, 1] - ks / 2, pos[0, 1] + ks / 2
    from ..models.cases import DOMAIN_SKIN
    # multiphase NN: heavy phases settle/stack beyond the dp-lattice count,
    # so the per-cell bucket capacity gets ~1.5x headroom
    phases = _parse_nnphases(root, csp)
    ccap = 0
    if phases is not None:
        import math as _m
        dim = 2 if sim2d else 3
        scell0 = ks * (1.0 + DOMAIN_SKIN)
        ccap = int((int(_m.floor(scell0 / dp) + 1) ** dim + 4) * 1.5)
    dom = cd.make_domain(tuple(pmin), tuple(pmax), ks, simulate2d=sim2d,
                         dp=dp, skin=DOMAIN_SKIN, cellcap=ccap)
    # tight active-cell capacity from the initial occupancy (x4 slack, like
    # cases._make_domain)
    cxyz = np.floor((pos - np.asarray(dom.posmin)) / dom.scell).astype(np.int64)
    cid = (cxyz[:, 2] * dom.nc[1] + cxyz[:, 1]) * dom.nc[0] + cxyz[:, 0]
    A = min(dom.ncells, pos.shape[0], max(1024, 4 * len(np.unique(cid))))
    import dataclasses
    dom = dataclasses.replace(dom, maxcells=A)
    iocfg = specials["inout"]
    if capacity is None and iocfg is not None:
        from ..features.inout import slots_required
        capacity = pos.shape[0] + slots_required(
            iocfg, csp, t_horizon=pf("TimeMax", 1.0)) + 256
    st = C._make_state(csp, pos, code, zsurf=zfluid_max,
                       need_verlet=(opts.tstep == TpStep.VERLET),
                       need_sps=(tvisco == TpVisco.LAMINAR_SPS),
                       capacity=capacity,
                       normals=draw.normals if mdbc else None)
    # multiphase NN phases (<special><nnphases>, JSph::InitMultiPhase):
    # fluid particles of a non-reference phase start at their phase rest
    # density (the per-phase EOS anchors there)
    if phases is not None:
        import dataclasses as _dcn
        mkmap = {p.mkfluid: i for i, p in enumerate(phases.phases)}
        codev = np.asarray(td.code_value(code))
        isfl = np.asarray(td.code_type(code) == td.TYPE_FLUID)
        rho = np.array(st.rho)
        newcode = np.array(st.code)
        for mk, i in mkmap.items():
            sel = isfl & (codev == mk)
            seln = np.zeros(st.n, bool)
            seln[:len(sel)] = sel
            if abs(phases.phases[i].rho0 - csp.rhopzero) > 1e-9:
                rho[seln] = phases.phases[i].rho0
            if i != mk:
                # dense phase indices in the fluid typecode value
                newcode[seln] = td.code_make(td.TYPE_FLUID, i)
        st = _dcn.replace(st, rho=jnp.asarray(rho, jnp.float32),
                          code=jnp.asarray(newcode))
        # system cs0 = max phase cs0 (ConfigConstantsMP); re-derive the
        # cs0-coupled constants.  The dt floor drops 1e-5x — the HBP
        # viscous dt3 control legitimately drives dt far below the
        # single-phase floor (ConfigConstantsMP: CoefDtMin *= 1e-5)
        cs0 = max(max(p.csound for p in phases.phases), float(csp.cs0))
        rmin = min(p.rho0 for p in phases.phases)
        rmax = max(p.rho0 for p in phases.phases)
        csp = csp.replace(
            cs0=cs0, cteb=cs0 * cs0 * csp.rhopzero / csp.gamma,
            dtini=min(csp.dtini, csp.kernelh / cs0),
            dtmin=csp.dtmin * 1e-5,
            rhopoutmin=min(csp.rhopoutmin, 0.6 * rmin),
            rhopoutmax=max(csp.rhopoutmax, 1.5 * rmax))
    if ftstate is not None:
        import dataclasses as _dc
        st = _dc.replace(st, ft=ftstate)
        opts = SolverOpts(**{**opts.__dict__, "with_floating": True})
    if iocfg is not None:
        from ..features.inout import init_inout
        st = init_inout(iocfg, csp, st)
    # <special><initialize> ops (JDsInitialize, applied once like
    # JSphCpuSingle::ConfigDomain -> RunInitialize, JSphCpuSingle.cpp:135)
    init_node = root.find(".//special/initialize")
    if init_node is not None:
        from ..features.initialize import (apply_initialize,
                                           parse_initialize_xml)
        init_ops = parse_initialize_xml(init_node)
        if init_ops:
            st = apply_initialize(init_ops, csp, st)
            if st.boundnormal is not None:
                opts = SolverOpts(**{**opts.__dict__,
                                     "tboundary": TpBoundary.MDBC})
    # time-varying viscosity table (<parameters> ViscoTime CSV next to the
    # case XML, JDsViscoInput; JSph.cpp LoadConfigParameters filevisco)
    viscotime = None
    fvisco = P.get("ViscoTime", "").strip()
    if fvisco:
        import os
        from ..features.viscoinput import load_viscoinput
        viscotime = load_viscoinput(
            os.path.join(os.path.dirname(os.path.abspath(path)), fvisco))
    # DEM contact when RigidAlgorithm=2 (JSph::LoadDemData; materials from
    # <properties> + the floating property attributes)
    demcfg = None
    if ftcfg is not None and dem_info is not None \
            and int(pf("RigidAlgorithm", 1)) == 2:
        from ..features.dem import make_dem
        fprops, bprops = dem_info
        demcfg = make_dem(csp, st.code, ftcfg, float_props=fprops,
                          bound_props=bprops)
    from ..features.featureset import Features
    import os as _os
    chronocfg, chcontact, scaleforce = _parse_chrono(
        root, ftcfg, ftstate, casedir=_os.path.dirname(_os.path.abspath(path)),
        dp=dp, dem_info=dem_info)
    mooringcfg = _parse_moorings(
        root, ftcfg, ftstate,
        casedir=_os.path.dirname(_os.path.abspath(path)), csp=csp)
    if scaleforce is not None and ftcfg is not None:
        import dataclasses as _dcsf
        ftcfg = _dcsf.replace(ftcfg, scaleforce=scaleforce)
    feats = Features(motions=tuple(motions) + specials["motions"],
                     damping=specials["damping"],
                     floating=ftcfg, inout=iocfg, awas=specials["awas"],
                     mlpistons=specials["mlpistons"],
                     relaxzones=specials["relaxzones"],
                     accinputs=specials["accinputs"],
                     moorings=mooringcfg,
                     viscotime=viscotime, dem=demcfg,
                     chrono=chronocfg, chcontact=chcontact)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    case = C.Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                  meta=dict(name=P.get("CaseName", "xmlcase"), dp=dp,
                            zsurf=zfluid_max, phases=phases,
                            gauges=specials["gauges"],
                            gauge_windows=specials["gauge_windows"],
                            gauge_computedts=specials.get(
                                "gauge_computedts", {}),
                            cellsout=cellsout_snaps,
                            features=feats if feats.any else None))
    run = dict(tmax=pf("TimeMax", 1.0), tout=pf("TimeOut", 0.01),
               partsoutmax=pf("PartsOutMax", 1.0))
    if opts.ftmotion:
        run["ftmotion_tout"] = pf("FtSaveMotion", 0.0)
    # variable PART-output schedule (<special><timeout>, JDsOutputTime,
    # `_FmtXML_TimeOut.xml`)
    tnode = root.find(".//special/timeout")
    if tnode is not None and \
            tnode.get("active", "true").lower() not in ("false", "0"):
        tab = [(float(el.get("time")), float(el.get("timeout")))
               for el in tnode.findall("tout")]
        if tab:
            run["tout_table"] = tab
    return case, opts, run
