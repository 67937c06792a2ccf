"""Built-in case construction: a GenCase-lite lattice generator + canonical
benchmark cases (dam breaks).

The reference workflow relies on the closed-source GenCase binary to turn XML
geometry into an initial particle lattice (`doc/help/GenCase_Help.out`,
invocation `examples/main/01_DamBreak/xCaseDambreak_linux64_CPU.sh`).  This
module reimplements the subset needed to *create* cases natively: dp-lattice
box drawing with solid/face fill and last-draw-wins overwrite semantics, id
assignment in the canonical order fixed < moving < floating < fluid (matching
the reference id layout, `JCaseParts`), and hydrostatic initial density
(GenCase ``rhopgradient=2`` water-column mode).

Benchmark geometries mirror the shipped examples:
* `dambreak2d` — `examples/main/01_DamBreak/CaseDambreakVal2D_Def.xml`
  (1 m x 2 m column in a 4 m x 3 m tank, dp=0.01, Koshizuka & Oka 1996).
* `dambreak3d` — `examples/main/01_DamBreak/CaseDambreak_Def.xml`
  (0.4 x 0.67 x 0.3 m column, 1.6 x 0.67 x 0.4 m tank, building obstacle).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import jax.numpy as jnp

from .. import typesdef as td
from ..typesdef import CteSph, make_ctesph
from ..ops import celldiv as cd
from ..ops import eos
from .wcsph import SimState

# cell-size skin for the amortized-rebuild layout of the GPU kernel path
# (celldiv.SortDiv): candidate volume grows ~(1+skin)^3 in exchange for divide-free
# steps while displacements stay under skin*kernelsize
DOMAIN_SKIN = 1.0 / 16.0

_EPS = 1e-6


def prism_pred(base, extrude):
    """Point-in-extruded-polygon predicate ((m,3)->bool): 2D even-odd test
    in the base plane x extrusion-interval test (shared by Draw.prism and
    the GenCase `<fillprism>` region fill)."""
    base = np.asarray(base, np.float64)
    ev = np.asarray(extrude, np.float64)
    m = len(base)
    eL = np.linalg.norm(ev)
    ez = ev / max(eL, _EPS)
    u0 = base[1] - base[0]
    u0 = u0 - np.dot(u0, ez) * ez
    u0 = u0 / max(np.linalg.norm(u0), _EPS)
    v0 = np.cross(ez, u0)
    b2 = np.stack([(base - base[0]) @ u0, (base - base[0]) @ v0], axis=1)

    def pred(pts):
        rel = np.asarray(pts) - base[0][None, :]
        t = rel @ ez
        px = rel @ u0
        py = rel @ v0
        inside = np.zeros(len(rel), bool)
        jm = m - 1
        for i in range(m):
            xi, yi = b2[i]
            xj, yj = b2[jm]
            crossed = ((yi > py) != (yj > py)) & (
                px < (xj - xi) * (py - yi) / (yj - yi + 1e-300) + xi)
            inside ^= crossed
            jm = i
        return inside & (t >= -_EPS) & (t <= eL + _EPS)

    return pred


@dataclass
class Draw:
    """dp-lattice drawing canvas with last-draw-wins overwrite (GenCase
    ``setmkfluid``/``setmkbound`` + ``drawbox`` semantics)."""
    dp: float
    simulate2d: bool = False
    pointref: tuple = (0.0, 0.0, 0.0)
    points: dict = field(default_factory=dict)   # (i,j,k) -> (ptype, mk, normal)

    def _irange(self, lo, hi, axis):
        r = self.pointref[axis]
        i0 = int(math.ceil((lo - r) / self.dp - _EPS))
        i1 = int(math.floor((hi - r) / self.dp + _EPS))
        return range(i0, i1 + 1)

    def box(self, pmin, pmax, *, ptype, mk, faces="solid"):
        """Draw a box.  ``faces`` is 'solid' or a subset of
        'bottom,top,left,right,front,back' (GenCase boxfill modes).
        left/right = x faces, front/back = y faces, bottom/top = z faces."""
        xs = self._irange(pmin[0], pmax[0], 0)
        ys = [0] if self.simulate2d else self._irange(pmin[1], pmax[1], 1)
        zs = self._irange(pmin[2], pmax[2], 2)
        if faces == "solid":
            sel = lambda i, j, k: True
            nrm = lambda i, j, k: (0.0, 0.0, 0.0)
        else:
            want = set(f.strip() for f in faces.split("|"))
            xs_l, ys_l, zs_l = list(xs), list(ys), list(zs)

            def sel(i, j, k):
                return (("left" in want and i == xs_l[0])
                        or ("right" in want and i == xs_l[-1])
                        or (not self.simulate2d and "front" in want and j == ys_l[0])
                        or (not self.simulate2d and "back" in want and j == ys_l[-1])
                        or ("bottom" in want and k == zs_l[0])
                        or ("top" in want and k == zs_l[-1]))

            def nrm(i, j, k):
                # inward normal for mDBC ghost nodes: |n| = dp (the ghost
                # node mirrored dp/2 past the interface; GenCase convention,
                # consumed at JSphCpu.cpp:1036 gpos = pos + boundnormal)
                v = np.zeros(3)
                if "left" in want and i == xs_l[0]:
                    v[0] += 1
                if "right" in want and i == xs_l[-1]:
                    v[0] -= 1
                if not self.simulate2d:
                    if "front" in want and j == ys_l[0]:
                        v[1] += 1
                    if "back" in want and j == ys_l[-1]:
                        v[1] -= 1
                if "bottom" in want and k == zs_l[0]:
                    v[2] += 1
                if "top" in want and k == zs_l[-1]:
                    v[2] -= 1
                nn = np.linalg.norm(v)
                if nn == 0:
                    return (0.0, 0.0, 0.0)
                v = v / nn * self.dp
                return (float(v[0]), float(v[1]), float(v[2]))
            xs, ys, zs = xs_l, ys_l, zs_l
        for k in zs:
            for j in ys:
                for i in xs:
                    if sel(i, j, k):
                        self.points[(i, j, k)] = (ptype, mk, nrm(i, j, k))

    def sphere(self, center, radius, *, ptype, mk, solid=True):
        """GenCase ``<drawsphere>``: lattice points within ``radius`` of
        ``center`` (solid) or within a dp-thick shell (face mode).  Boundary
        points get inward radial mDBC normals."""
        c = np.asarray(center, np.float64)
        lo, hi = c - radius - self.dp, c + radius + self.dp
        xs = self._irange(lo[0], hi[0], 0)
        ys = [0] if self.simulate2d else self._irange(lo[1], hi[1], 1)
        zs = self._irange(lo[2], hi[2], 2)
        r = self.pointref
        for k in zs:
            for j in ys:
                for i in xs:
                    p = np.array([r[0] + i * self.dp, r[1] + j * self.dp,
                                  r[2] + k * self.dp])
                    if self.simulate2d:
                        p[1] = c[1]
                    d = np.linalg.norm(p - c)
                    inside = d <= radius + _EPS if solid \
                        else (radius - self.dp - _EPS <= d <= radius + _EPS)
                    if not inside:
                        continue
                    if d > _EPS:
                        nv = (c - p) / d * self.dp
                    else:
                        nv = np.zeros(3)
                    self.points[(i, j, k)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]), float(nv[2])))

    def cylinder(self, p1, p2, radius, *, ptype, mk, solid=True):
        """GenCase ``<drawcylinder>``: lattice points within ``radius`` of
        the p1->p2 axis, between the end planes (solid) or on the dp-thick
        lateral shell (face mode)."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        ax = b - a
        L = np.linalg.norm(ax)
        if L < _EPS:
            return self.sphere(p1, radius, ptype=ptype, mk=mk, solid=solid)
        ax = ax / L
        lo = np.minimum(a, b) - radius - self.dp
        hi = np.maximum(a, b) + radius + self.dp
        xs = self._irange(lo[0], hi[0], 0)
        ys = [0] if self.simulate2d else self._irange(lo[1], hi[1], 1)
        zs = self._irange(lo[2], hi[2], 2)
        r = self.pointref
        for k in zs:
            for j in ys:
                for i in xs:
                    p = np.array([r[0] + i * self.dp, r[1] + j * self.dp,
                                  r[2] + k * self.dp])
                    if self.simulate2d:
                        p[1] = a[1]
                    t = np.dot(p - a, ax)
                    if t < -_EPS or t > L + _EPS:
                        continue
                    rad_v = (p - a) - t * ax
                    d = np.linalg.norm(rad_v)
                    inside = d <= radius + _EPS if solid \
                        else (radius - self.dp - _EPS <= d <= radius + _EPS)
                    if not inside:
                        continue
                    if d > _EPS:
                        nv = -rad_v / d * self.dp
                    else:
                        nv = np.zeros(3)
                    self.points[(i, j, k)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]), float(nv[2])))

    def voidbox(self, pmin, pmax):
        """GenCase ``setmkvoid`` + drawbox: erase lattice points in the box."""
        xs = set(self._irange(pmin[0], pmax[0], 0))
        ys = {0} if self.simulate2d else set(self._irange(pmin[1], pmax[1], 1))
        zs = set(self._irange(pmin[2], pmax[2], 2))
        for key in [k for k in self.points
                    if k[0] in xs and k[1] in ys and k[2] in zs]:
            del self.points[key]

    def fillbox(self, seed, pmin, pmax, *, ptype, mk):
        """GenCase ``<fillbox>`` with void mode: flood-fill the empty lattice
        region connected to ``seed``, bounded by the box and by already-drawn
        particles (walls).  This is how the reference cases fill water behind
        paddles/bathymetry."""
        from collections import deque

        def frange(lo_, hi_, axis):
            # fill regions are half-open at the far limit: a lattice point
            # exactly ON pmax is outside (GenCase fill semantics, validated
            # by the RedrawSimple test_02 cellsout golden — the z=size row
            # is NOT filled)
            idx = list(self._irange(lo_, hi_, axis))
            if idx and abs(self.pointref[axis] + idx[-1] * self.dp
                           - hi_) < _EPS:
                idx = idx[:-1]
            return idx

        xs = frange(pmin[0], pmax[0], 0)
        ys = [0] if self.simulate2d else frange(pmin[1], pmax[1], 1)
        zs = frange(pmin[2], pmax[2], 2)
        if not xs or not zs or (not ys):
            return
        lo = (xs[0], ys[0], zs[0])
        hi = (xs[-1], ys[-1], zs[-1])
        r = self.pointref
        s0 = tuple(int(round((seed[a] - r[a]) / self.dp)) for a in range(3))
        if self.simulate2d:
            s0 = (s0[0], 0, s0[2])
        if not all(lo[a] <= s0[a] <= hi[a] for a in range(3)) \
           or s0 in self.points:
            return
        steps = [(1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)]
        if not self.simulate2d:
            steps += [(0, 1, 0), (0, -1, 0)]
        seen = {s0}
        q = deque([s0])
        while q:
            node = q.popleft()
            self.points[node] = (ptype, mk, (0.0, 0.0, 0.0))
            for dx, dy, dz in steps:
                nb = (node[0] + dx, node[1] + dy, node[2] + dz)
                if nb in seen or nb in self.points:
                    continue
                if not all(lo[a] <= nb[a] <= hi[a] for a in range(3)):
                    continue
                seen.add(nb)
                q.append(nb)

    def fill_domain(self, pmin, pmax, *, ptype, mk):
        """Paint every lattice cell of [pmin, pmax) — void included — with
        the current mk/type (the filterless GenCase ``<redraw/>``; far limit
        half-open like the fill regions)."""
        def frange(lo_, hi_, axis):
            idx = list(self._irange(lo_, hi_, axis))
            if idx and abs(self.pointref[axis] + idx[-1] * self.dp
                           - hi_) < _EPS:
                idx = idx[:-1]
            return idx
        xs = frange(pmin[0], pmax[0], 0)
        ys = [0] if self.simulate2d else frange(pmin[1], pmax[1], 1)
        zs = frange(pmin[2], pmax[2], 2)
        for k in zs:
            for j in ys:
                for i in xs:
                    self.points[(i, j, k)] = (ptype, mk, (0.0, 0.0, 0.0))

    def _snap(self, p):
        r = self.pointref
        i = int(round((p[0] - r[0]) / self.dp))
        j = 0 if self.simulate2d else int(round((p[1] - r[1]) / self.dp))
        k = int(round((p[2] - r[2]) / self.dp))
        return (i, j, k)

    def pointmark(self, p, *, ptype, mk, normal=(0.0, 0.0, 0.0)):
        """GenCase ``<drawpoint(s)>``: one lattice point nearest ``p``."""
        self.points[self._snap(p)] = (ptype, mk, tuple(normal))

    def segment(self, p1, p2, *, ptype, mk):
        """GenCase ``<drawline(s)/lineto>``: rasterize the segment by dense
        sampling (dp/4 steps along the line), snapping each sample to the
        nearest lattice point
        — this marks every cell whose rounded (x,y,z) the continuous line
        visits, reproducing GenCase's corner-overlap pattern at row
        transitions (validated against the RedrawGenCase cellsout
        goldens)."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        L = np.linalg.norm(b - a)
        step = self.dp * 0.25
        ts = [min(k * step / L, 1.0)
              for k in range(int(math.floor(L / step)) + 1)] if L else [0.0]
        if ts[-1] < 1.0:
            ts.append(1.0)
        for t in ts:
            self.pointmark(a + t * (b - a), ptype=ptype, mk=mk)

    def tri_surface(self, tris, *, ptype, mk, normals=True):
        """Rasterize a triangle soup onto the lattice (GenCase
        ``<drawtriangle(s)/quadri/figure>`` and the ``<drawfilestl/ply/vtk>``
        mesh imports): each triangle is sampled on a barycentric grid at dp/2
        and the nearest lattice points are marked.  ``normals``: store the
        (inward = -face normal, GenCase convention flipped by modelnormal)
        triangle normal scaled to dp for mDBC."""
        tris = np.asarray(tris, np.float64).reshape(-1, 3, 3)
        for tri in tris:
            a, b, c = tri
            e1, e2 = b - a, c - a
            nrm = np.cross(e1, e2)
            nl = np.linalg.norm(nrm)
            nv = (-nrm / nl * self.dp) if (normals and nl > _EPS) \
                else np.zeros(3)
            n1 = max(1, int(math.ceil(np.linalg.norm(e1) / (self.dp * 0.5))))
            n2 = max(1, int(math.ceil(np.linalg.norm(e2) / (self.dp * 0.5))))
            for iu in range(n1 + 1):
                u = iu / n1
                for iv in range(n2 + 1):
                    v = iv / n2
                    if u + v > 1.0 + 1e-9:
                        continue
                    p = a + u * e1 + v * e2
                    self.points[self._snap(p)] = (
                        ptype, mk, (float(nv[0]), float(nv[1]),
                                    float(nv[2])))

    def solid_pred(self, pred, bbox, *, ptype, mk):
        """Fill every lattice point inside ``bbox`` where ``pred(points)``
        (vectorized (m,3)->bool) holds — the general path for transformed
        solids (rotated boxes, prisms, ellipsoids)."""
        lo, hi = np.asarray(bbox[0]), np.asarray(bbox[1])
        xs = list(self._irange(lo[0], hi[0], 0))
        ys = [0] if self.simulate2d else list(self._irange(lo[1], hi[1], 1))
        zs = list(self._irange(lo[2], hi[2], 2))
        if not xs or not ys or not zs:
            return
        r = self.pointref
        gi, gj, gk = np.meshgrid(xs, ys, zs, indexing="ij")
        keys = np.stack([gi.ravel(), gj.ravel(), gk.ravel()], axis=1)
        pts = keys * self.dp + np.asarray(r)[None, :]
        sel = np.asarray(pred(pts), bool)
        for (i, j, k) in keys[sel]:
            self.points[(int(i), int(j), int(k))] = (ptype, mk,
                                                     (0.0, 0.0, 0.0))

    def prism(self, base, extrude, *, ptype, mk, solid=True):
        """GenCase ``<drawprism>``/``<drawpolygon>``: polygon ``base``
        ((m,3) planar loop) extruded along ``extrude``.  Solid fills the
        interior; face mode rasterizes the lateral walls + caps."""
        base = np.asarray(base, np.float64)
        ev = np.asarray(extrude, np.float64)
        m = len(base)
        if not solid:
            for i in range(m):
                a, b = base[i], base[(i + 1) % m]
                self.tri_surface([[a, b, b + ev], [a, b + ev, a + ev]],
                                 ptype=ptype, mk=mk)
            for loop in (base, base + ev):
                ctr = loop.mean(axis=0)
                self.tri_surface(
                    [[ctr, loop[i], loop[(i + 1) % m]] for i in range(m)],
                    ptype=ptype, mk=mk)
            return
        # solid: point-in-prism via the base-plane 2D polygon test
        pred = prism_pred(base, ev)
        lo = np.minimum(base.min(0), (base + ev).min(0)) - self.dp
        hi = np.maximum(base.max(0), (base + ev).max(0)) + self.dp
        self.solid_pred(pred, (lo, hi), ptype=ptype, mk=mk)

    def ellipsoid(self, p1, p2, radius=1.0, *, ptype, mk, solid=True):
        """GenCase ``<drawellipsoid>``: center at the midpoint of the two
        points, semi-axes = half the per-axis extents scaled by ``radius``
        (degenerate axes fall back to radius itself).  Solid fill or a
        dp-thick shell; shell points get inward mDBC normals."""
        a = np.asarray(p1, np.float64)
        b = np.asarray(p2, np.float64)
        c = 0.5 * (a + b)
        semi = np.abs(b - a) * 0.5 * radius
        semi = np.where(semi < _EPS, radius, semi)
        if self.simulate2d:
            semi[1] = 1.0
        lo, hi = c - semi - self.dp, c + semi + self.dp

        def pred(pts):
            u = (pts - c[None, :]) / semi[None, :]
            r2 = np.sum(u * u, axis=1)
            if solid:
                return r2 <= 1.0 + _EPS
            inner = (np.abs(pts - c[None, :]) / np.maximum(
                semi[None, :] - self.dp, _EPS))
            return (r2 <= 1.0 + _EPS) & (np.sum(inner * inner, axis=1)
                                         >= 1.0 - _EPS)

        self.solid_pred(pred, (lo, hi), ptype=ptype, mk=mk)

    def fillpoint(self, seed, bounds, *, ptype, mk):
        """GenCase ``<fillpoint>``: flood-fill the empty lattice region
        connected to ``seed``, bounded by drawn particles and the given
        (definition) box."""
        self.fillbox(seed, bounds[0], bounds[1], ptype=ptype, mk=mk)

    def fillpred(self, seed, bounds, pred, *, ptype, mk):
        """Flood-fill like :meth:`fillbox` additionally constrained to a
        region predicate ``pred((m,3) world pts) -> bool`` (GenCase
        ``<fillprism>``/``<fillfigure>`` seed fills bounded by a shape)."""
        from collections import deque
        lo_w, hi_w = np.asarray(bounds[0]), np.asarray(bounds[1])
        xs = list(self._irange(lo_w[0], hi_w[0], 0))
        ys = [0] if self.simulate2d else list(self._irange(lo_w[1],
                                                           hi_w[1], 1))
        zs = list(self._irange(lo_w[2], hi_w[2], 2))
        if not xs or not ys or not zs:
            return
        lo = (xs[0], ys[0], zs[0])
        hi = (xs[-1], ys[-1], zs[-1])
        r = self.pointref

        def world(n):
            return np.array([r[a] + n[a] * self.dp for a in range(3)])

        def ok(n):
            return bool(np.asarray(pred(world(n)[None, :])).ravel()[0])

        s0 = tuple(int(round((seed[a] - r[a]) / self.dp)) for a in range(3))
        if self.simulate2d:
            s0 = (s0[0], 0, s0[2])
        if not all(lo[a] <= s0[a] <= hi[a] for a in range(3)) \
                or s0 in self.points or not ok(s0):
            return
        steps = [(1, 0, 0), (-1, 0, 0), (0, 0, 1), (0, 0, -1)]
        if not self.simulate2d:
            steps += [(0, 1, 0), (0, -1, 0)]
        seen = {s0}
        q = deque([s0])
        while q:
            node = q.popleft()
            self.points[node] = (ptype, mk, (0.0, 0.0, 0.0))
            for dx, dy, dz in steps:
                nb = (node[0] + dx, node[1] + dy, node[2] + dz)
                if nb in seen or nb in self.points:
                    continue
                if not all(lo[a] <= nb[a] <= hi[a] for a in range(3)):
                    continue
                if not ok(nb):
                    continue
                seen.add(nb)
                q.append(nb)

    def redraw(self, *, ptype, mk, filter_type=None, filter_mk=None,
               box=None):
        """GenCase ``<redraw>``/``<redrawbox>``: re-assign the current
        mk/type to existing particles, optionally only those matching a
        (type, mk) filter and/or inside a world-space box.  ``ptype=None``
        (setmkvoid) deletes them."""
        r = self.pointref
        out = []
        for ijk, (t, m, n) in self.points.items():
            if filter_type is not None and t != filter_type:
                continue
            if filter_mk is not None and m != filter_mk:
                continue
            if box is not None:
                p = [r[a] + ijk[a] * self.dp for a in range(3)]
                if not all(box[0][a] - _EPS <= p[a] <= box[1][a] + _EPS
                           for a in range(3)):
                    continue
            out.append(ijk)
        for ijk in out:
            if ptype is None:
                del self.points[ijk]
            else:
                self.points[ijk] = (ptype, mk, self.points[ijk][2])

    _DIRVECS = {"right": (1, 0, 0), "left": (-1, 0, 0),
                "back": (0, 1, 0), "front": (0, -1, 0),
                "top": (0, 0, 1), "bottom": (0, 0, -1)}

    def redrawnear(self, *, ptype, mk, times=1, targettp="fluid",
                   targetmk=None, bordertp="bound", bordermk=None,
                   dirs=None, box=None):
        """GenCase ``<redrawnear>``/``<redrawnearbox>``: repaint target
        cells (type/mk filtered; ``targettp='void'`` = empty lattice sites)
        that lie in an allowed direction from a border cell with the
        current mk/type, growing one layer per pass for ``times`` passes
        (newly painted cells join the border for the next pass).  ``dirs``
        is the <dirfilter> subset of top/bottom/left/right/front/back
        (CaseTemplate.xml:514-541)."""
        if dirs:
            use = [self._DIRVECS[d] for d in dirs
                   if not (self.simulate2d and d in ("front", "back"))]
        else:
            # default: the full neighbourhood incl. diagonals (the shipped
            # cellsout goldens paint diagonal void neighbours too)
            js = (0,) if self.simulate2d else (-1, 0, 1)
            use = [(di, dj, dk) for di in (-1, 0, 1) for dj in js
                   for dk in (-1, 0, 1) if (di, dj, dk) != (0, 0, 0)]
        r = self.pointref

        def inbox(ijk):
            if box is None:
                return True
            p = [r[a] + ijk[a] * self.dp for a in range(3)]
            return all(box[0][a] - _EPS <= p[a] <= box[1][a] + _EPS
                       for a in range(3))

        def match(entry, tp, mkf):
            if tp == "void":
                return entry is None
            if entry is None:
                return False
            t, m, _n = entry
            if tp == "fluid" and t != td.TYPE_FLUID:
                return False
            if tp == "bound" and t == td.TYPE_FLUID:
                return False
            if mkf is not None and m != mkf:
                return False
            return True

        border = {ijk for ijk, e in self.points.items()
                  if match(e, bordertp, bordermk) and inbox(ijk)}
        if bordertp == "void":
            # void border: empty sites adjacent to any occupied site —
            # gated by the box (redrawnearbox), so space outside the
            # operation box (e.g. beyond the definition domain) is not a
            # border (RedrawComplex test_14 golden keeps the domain edge)
            border = set()
            for ijk in self.points:
                for d in use:
                    nb = (ijk[0] - d[0], ijk[1] - d[1], ijk[2] - d[2])
                    if nb not in self.points and inbox(nb):
                        border.add(nb)
        for _ in range(max(int(times), 1)):
            paint = set()
            for b in border:
                for d in use:
                    t = (b[0] + d[0], b[1] + d[1], b[2] + d[2])
                    if t in paint or not inbox(t):
                        continue
                    if match(self.points.get(t), targettp, targetmk):
                        paint.add(t)
            if not paint:
                break
            for t in paint:
                old = self.points.get(t)
                if ptype is None:
                    self.points.pop(t, None)
                else:
                    self.points[t] = (ptype, mk,
                                      old[2] if old else (0.0, 0.0, 0.0))
            border |= paint

    def cell_mks(self):
        """{(i,j,k): (ptype, mk)} snapshot of the lattice (the GenCase
        ``<cellsout>`` debug channel)."""
        return {ijk: (t, m) for ijk, (t, m, _n) in self.points.items()}

    def build(self):
        """Assign canonical ids (fixed < moving < floating < fluid; within a
        type, draw-lattice order) and return (pos f64 (np,3), code u32 (np,))."""
        order = {td.TYPE_FIXED: 0, td.TYPE_MOVING: 1,
                 td.TYPE_FLOATING: 2, td.TYPE_FLUID: 3}
        items = sorted(self.points.items(),
                       key=lambda kv: (order[kv[1][0]], kv[0][2], kv[0][1], kv[0][0]))
        pos = np.array([[self.pointref[a] + ijk[a] * self.dp for a in range(3)]
                        for ijk, _ in items], dtype=np.float64)
        code = np.array([td.code_make(t, mk) for _, (t, mk, _n) in items],
                        dtype=np.uint32)
        self.normals = np.array([n for _, (_t, _mk, n) in items],
                                dtype=np.float64)
        return pos, code


@dataclass
class Case:
    """A fully-constructed runnable case."""
    csp: CteSph
    dom: cd.Domain
    state: SimState
    npb: int          # boundary particle count (fixed+moving)
    np_total: int
    meta: dict


def _make_state(csp: CteSph, pos, code, zsurf, *, dtype=jnp.float32,
                need_verlet=False, need_sps=False, capacity=None,
                normals=None):
    n = pos.shape[0]
    cap = capacity or n
    posf = np.zeros((cap, 3), np.float64)
    posf[:n] = pos
    posf[n:] = -1e6  # far outside the map
    codef = np.full((cap,), td.code_make(td.TYPE_FLUID, 0, td.SPECIAL_OUT_IGNORE),
                    np.uint32)
    codef[:n] = code
    rho = np.full((cap,), csp.rhopzero, np.float64)
    # hydrostatic init for fluid only (GenCase rhopgradient=2); bound and
    # floating particles start at rho0
    isfl = td.code_type(code) == td.TYPE_FLUID
    rho[:n] = np.where(
        np.asarray(isfl),
        np.asarray(eos.hydrostatic_rho(csp, jnp.asarray(posf[:n, 2]), zsurf)),
        csp.rhopzero)
    vel = np.zeros((cap, 3), np.float64)
    st = SimState(
        pos=jnp.asarray(posf, dtype),
        vel=jnp.asarray(vel, dtype),
        rho=jnp.asarray(rho, dtype),
        code=jnp.asarray(codef),
        idp=jnp.arange(cap, dtype=jnp.uint32),
        velm1=jnp.asarray(vel, dtype) if need_verlet else None,
        rhom1=jnp.asarray(rho, dtype) if need_verlet else None,
        spstau=jnp.zeros((cap, 6), dtype) if need_sps else None,
    )
    if normals is not None:
        nrm = np.zeros((cap, 3), np.float64)
        nrm[:n] = normals
        import dataclasses
        st = dataclasses.replace(
            st, boundnormal=jnp.asarray(nrm, dtype),
            motionvel=jnp.zeros((cap, 3), dtype))
    return st


def _make_domain(csp: CteSph, pos, *, headroom=0.5, maxcells=0, cellcap=0):
    """Static cell grid from particle bounds + KernelSize halo + free-surface
    headroom (the `<simulationdomain>` 'default + 50%' idiom).

    The active-cell capacity (A) is sized from an exact host-side count of
    the initially occupied cells x4 slack — the analog of the reference's
    shrink-wrapped cell domain (`JCellDivCpuSingle::CalcCellDomain`); runs
    that spread further trip the counted overflow diagnostic."""
    ks = csp.kernelsize
    pmin = pos.min(axis=0) - 2 * ks
    pmax = pos.max(axis=0) + 2 * ks
    pmax[2] += headroom * (pos[:, 2].max() - pos[:, 2].min())
    if csp.simulate2d:
        pmin[1] = pos[0, 1] - ks / 2
        pmax[1] = pos[0, 1] + ks / 2
    dom = cd.make_domain(tuple(pmin), tuple(pmax), ks,
                         simulate2d=csp.simulate2d, dp=csp.dp,
                         cellcap=cellcap, maxcells=maxcells,
                         skin=DOMAIN_SKIN)
    if not maxcells:
        cxyz = np.floor((pos - np.asarray(dom.posmin)) / dom.scell).astype(np.int64)
        ncx, ncy, _ = dom.nc
        cid = (cxyz[:, 2] * ncy + cxyz[:, 1]) * ncx + cxyz[:, 0]
        n_occupied = len(np.unique(cid))
        A = min(dom.ncells, pos.shape[0], max(1024, 4 * n_occupied))
        dom = cd.Domain(posmin=dom.posmin, scell=dom.scell, nc=dom.nc,
                        simulate2d=dom.simulate2d, cellcap=dom.cellcap,
                        maxcells=A)
    return dom


def dambreak2d(dp=0.02, *, tank=(4.0, 3.0), column=(1.0, 2.0),
               visco=0.02, need_verlet=False, need_sps=False,
               cellcap=0, capacity=None, mdbc=False) -> Case:
    """2D dam break (CaseDambreakVal2D_Def.xml geometry)."""
    hswl = column[1]
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=hswl, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (column[0], 0, column[1]), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    pos, code = d.build()
    dom = _make_domain(csp, pos, cellcap=cellcap)
    st = _make_state(csp, pos, code, zsurf=column[1],
                     need_verlet=need_verlet, need_sps=need_sps,
                     capacity=capacity,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak2d", dp=dp, zsurf=column[1]))


def lattice_cellcap(csp: CteSph, scale=1.0) -> int:
    """Worst-case dp-lattice points per kernelsize cell, scaled (floating
    bodies interpenetrate the fluid lattice, so such cases need ~2x)."""
    per_axis = int(math.floor(csp.kernelsize / csp.dp) + 1)
    return int(per_axis ** csp.dim * scale) + 4


def floatingbox2d(dp=0.02, *, tank=(2.0, 1.2), water=0.5,
                  box=(0.2, 0.2), box_pos=(0.9, 0.42), box_rho=500.0,
                  visco=0.05, ftpause=0.0, capacity=None) -> "Case":
    """2D floating box in a water tank (the 'floating box in waves' family,
    BASELINE config 3; reference examples/chrono + floatings blocks)."""
    from ..features import floating as FTmod
    hswl = water
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=hswl, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (tank[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (tank[0], 0, tank[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|left|right")
    d.box((box_pos[0], 0, box_pos[1]),
          (box_pos[0] + box[0], 0, box_pos[1] + box[1]),
          ptype=td.TYPE_FLOATING, mk=0)
    pos, code = d.build()
    # floating typecode value = body index
    isft = td.code_type(code) == td.TYPE_FLOATING
    ftcfg, ftstate = FTmod.make_floating(
        [pos[np.asarray(isft)]], [box_rho], csp, ftpause=ftpause)
    dom = _make_domain(csp, pos, cellcap=lattice_cellcap(csp, 2.0))
    st = _make_state(csp, pos, code, zsurf=water, capacity=capacity)
    import dataclasses
    st = dataclasses.replace(st, ft=ftstate)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    case = Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="floatingbox2d", dp=dp, zsurf=water,
                          ftcfg=ftcfg))
    return case


def waveflume2d(dp=0.02, *, flume=(6.0, 1.0), water=0.4,
                piston_freq=0.8, piston_amp=0.1, visco=0.02,
                coefsound=20.0, capacity=None) -> "Case":
    """2D wave flume with a sinusoidal piston wavemaker (the wave-flume
    family, BASELINE config 2; reference wavepaddles via JWaveGen)."""
    from ..features import motion as MOTmod
    csp = make_ctesph(simulate2d=True, dp=dp, hswl=water, coefh=1.0,
                      visco=visco, coefsound=coefsound)
    # the piston compresses the first fluid cells beyond lattice density
    cellcap = lattice_cellcap(csp, scale=2.0)
    d = Draw(dp=dp, simulate2d=True)
    d.box((0, 0, 0), (flume[0], 0, water), ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), (flume[0], 0, flume[1]),
          ptype=td.TYPE_FIXED, mk=0, faces="bottom|right")
    # piston: a moving wall column at x ~ 0, thick enough to cover the full
    # kernel support (2h = 2.83 dp) — thinner pistons leak fluid through the
    # DBC wall during fast strokes
    nlay = max(2, int(math.ceil(csp.kernelsize / dp)) + 1)
    d.box((-nlay * dp, 0, 0), (-dp, 0, flume[1]), ptype=td.TYPE_MOVING, mk=10)
    pos, code = d.build()
    dom = _make_domain(csp, pos, cellcap=cellcap)
    st = _make_state(csp, pos, code, zsurf=water, capacity=capacity)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    motion = MOTmod.piston_sinusoidal(10, freq=piston_freq,
                                      amplitude=piston_amp)
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="waveflume2d", dp=dp, zsurf=water,
                          motion=motion))


def channel2d(dp=0.02, *, length=0.6, height=0.2, vel=0.5, layers=3,
              t_horizon=2.0, capacity=None) -> "Case":
    """2D open channel driven by an inlet at x=0 and an outlet at x=length
    (the inout validation family, SURVEY §2.10; reference examples/inletoutlet).

    Zero gravity, uniform inlet velocity profile; walls above and below."""
    from ..features.inout import InOutCfg, InOutZone, slots_required
    csp = make_ctesph(simulate2d=True, dp=dp, gravity=(0.0, 0.0, 0.0),
                      speedsound=20.0 * vel, visco=0.02)
    w = (layers + 2) * dp
    d = Draw(dp=dp, simulate2d=True)
    # fluid starts one dp inside each zone plane: the first inout lattice
    # layer sits ON the plane (reference point placement)
    d.box((dp, 0, 0), (length - dp, 0, height), ptype=td.TYPE_FLUID, mk=0)
    # walls extend past both zones so zone particles keep wall support
    d.box((-w, 0, -3 * dp), (length + w, 0, -dp), ptype=td.TYPE_FIXED, mk=0)
    d.box((-w, 0, height + dp), (length + w, 0, height + 3 * dp),
          ptype=td.TYPE_FIXED, mk=0)
    pos, code = d.build()
    inlet = InOutZone(p0=(0.0, 0.0, height / 2), direction=(1, 0, 0),
                      layers=layers, tangent1=(0, 0, 1), size1=height + dp,
                      vel_profile=(vel, 0.0, 0.0), rho_mode="constant")
    outlet = InOutZone(p0=(length, 0.0, height / 2), direction=(-1, 0, 0),
                       layers=layers, tangent1=(0, 0, 1), size1=height + dp,
                       vel_profile=(-vel, 0.0, 0.0), rho_mode="constant")
    iocfg = InOutCfg(zones=(inlet, outlet))
    need = slots_required(iocfg, csp, t_horizon)
    cap = capacity or (pos.shape[0] + need + 256)
    # extra bucket headroom: captured fluid and the zone lattice can
    # transiently share cells at the outlet plane
    dom = _make_domain(csp, pos, cellcap=lattice_cellcap(csp, scale=2.5))
    st = _make_state(csp, pos, code, zsurf=0.0, capacity=cap)
    from ..features.inout import init_inout
    st = init_inout(iocfg, csp, st)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="channel2d", dp=dp, inout=iocfg, vel=vel))


def dambreak3d(dp=0.02, *, tank=(1.6, 0.67, 0.4), column=(0.4, 0.67, 0.3),
               obstacle=True, visco=0.1, need_verlet=False, need_sps=False,
               cellcap=0, capacity=None, headroom=1.0, mdbc=False) -> Case:
    """3D dam break with optional building obstacle (CaseDambreak_Def.xml)."""
    hswl = column[2]
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=hswl, coefh=1.0,
                      visco=visco, coefsound=20.0)
    d = Draw(dp=dp)
    d.box((0, 0, 0), column, ptype=td.TYPE_FLUID, mk=0)
    d.box((0, 0, 0), tank, ptype=td.TYPE_FIXED, mk=0,
          faces="bottom|left|right|front|back")
    if obstacle:
        d.box((0.9, 0.24, 0.0), (1.02, 0.36, 0.45),
              ptype=td.TYPE_FIXED, mk=1, faces="top|left|right|front|back")
    pos, code = d.build()
    dom = _make_domain(csp, pos, headroom=headroom, cellcap=cellcap)
    st = _make_state(csp, pos, code, zsurf=column[2],
                     need_verlet=need_verlet, need_sps=need_sps,
                     capacity=capacity,
                     normals=d.normals if mdbc else None)
    npb = int(np.sum(td.code_type(code) < td.TYPE_FLOATING))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="dambreak3d", dp=dp, zsurf=column[2]))


def coastal_runup3d(dp=0.02, *, length=8.0, width=2.0, depth=0.5,
                    slope_start=3.0, slope=0.1, wave_height=0.0,
                    need_sps=False, cellcap=0, capacity=None,
                    headroom=0.6) -> Case:
    """3-D coastal runup: flat offshore bed rising onto a plane beach
    (BASELINE.json config 5 — the 10-50M-particle scaling case, built
    vectorized in numpy because the lattice reaches tens of millions of
    points).

    Bed elevation b(x) = max(0, (x - slope_start) * slope); fluid fills
    b(x) <= z < depth (the still-water level).  ``wave_height`` > 0 seeds a
    solitary-wave hump + velocity profile offshore (Boussinesq first order:
    u = c * eta / (depth + eta)) so the case runs without a wavemaker."""
    g = 9.81
    csp = make_ctesph(simulate2d=False, dp=dp, hswl=depth, coefh=1.0,
                      visco=0.05, coefsound=20.0)
    nx = int(round(length / dp)) + 1
    ny = int(round(width / dp)) + 1
    nz = int(round((depth + max(wave_height, 0.0) * 1.5
                    + length * 0.0) / dp)) + 4
    xs = (np.arange(nx) * dp)
    ys = (np.arange(ny) * dp)
    zs = (np.arange(nz) * dp)
    bed = np.maximum(0.0, (xs - slope_start) * slope)        # (nx,)

    # fluid: z in [bed(x), swl + eta(x)); 3 bound layers under the bed and
    # at the lateral/back walls
    X, Z = np.meshgrid(xs, zs, indexing="ij")                # (nx, nz)
    bedx = bed[:, None]
    eta = np.zeros_like(xs)
    if wave_height > 0:
        # solitary hump centred offshore
        x0 = slope_start * 0.4
        kk = np.sqrt(3.0 * wave_height / (4.0 * depth ** 3))
        eta = wave_height / np.cosh(np.clip(kk * (xs - x0), -20, 20)) ** 2
    swl = depth + eta[:, None]                               # (nx, 1)
    fluid2d = (Z >= bedx - 1e-9) & (Z < swl - 1e-9)          # (nx, nz)
    bound2d = (Z >= bedx - 3 * dp - 1e-9) & (Z < bedx - 1e-9)

    def expand(mask2d, wall=False):
        """(nx, nz) mask -> (n, 3) positions over all y."""
        ix, iz = np.nonzero(mask2d)
        n2 = len(ix)
        pos = np.empty((n2 * ny, 3))
        pos[:, 0] = np.repeat(xs[ix], ny)
        pos[:, 1] = np.tile(ys, n2)
        pos[:, 2] = np.repeat(zs[iz], ny)
        return pos

    pos_bed = expand(bound2d)
    pos_fl = expand(fluid2d)
    # interior fluid only between walls (strip 3 lattice columns each side
    # for the side/back walls)
    wallw = 3 * dp + 1e-9
    keep = ((pos_fl[:, 1] > wallw) & (pos_fl[:, 1] < width - wallw)
            & (pos_fl[:, 0] > wallw))
    pos_fl = pos_fl[keep]
    # walls: back (x=0) + sides, up to the water column height
    zcol = depth + (wave_height * 1.5 if wave_height else 0.0) + 4 * dp
    wmask = np.zeros((nx, ny, 2), bool)
    side = np.empty((0, 3))
    planes = []
    for xw in range(3):
        planes.append(np.stack(np.meshgrid(xs[xw:xw + 1], ys,
                                           zs[zs < zcol], indexing="ij"),
                               axis=-1).reshape(-1, 3))
    for yw in list(range(3)) + list(range(ny - 3, ny)):
        planes.append(np.stack(np.meshgrid(xs, ys[yw:yw + 1],
                                           zs[zs < zcol], indexing="ij"),
                               axis=-1).reshape(-1, 3))
    side = np.concatenate(planes)
    # drop wall points below the bed (the bed layer covers them)
    side = side[side[:, 2] >= np.maximum(
        0.0, (side[:, 0] - slope_start) * slope) - 3 * dp - 1e-9]

    bound = np.concatenate([pos_bed, side])
    bound = np.unique(np.round(bound / dp).astype(np.int64), axis=0) * dp
    pos = np.concatenate([bound, pos_fl])
    code = np.concatenate([
        np.full(len(bound), td.code_make(td.TYPE_FIXED, 0), np.uint32),
        np.full(len(pos_fl), td.code_make(td.TYPE_FLUID, 0), np.uint32)])

    dom = _make_domain(csp, pos, headroom=headroom, cellcap=cellcap)
    st = _make_state(csp, pos, code, zsurf=depth, need_sps=need_sps,
                     capacity=capacity)
    if wave_height > 0:
        # solitary-wave velocity under the hump (u = c*eta/(d+eta))
        c = np.sqrt(g * (depth + wave_height))
        etap = wave_height / np.cosh(np.clip(
            np.sqrt(3.0 * wave_height / (4.0 * depth ** 3))
            * (pos[:, 0] - slope_start * 0.4), -20, 20)) ** 2
        u = np.where(code == td.code_make(td.TYPE_FLUID, 0),
                     c * etap / (depth + etap), 0.0)
        vel = np.array(st.vel)
        vel[:len(pos), 0] = u
        import dataclasses as _dc
        import jax.numpy as _jnp
        st = _dc.replace(st, vel=_jnp.asarray(vel, _jnp.float32))
    npb = int(len(bound))
    return Case(csp=csp, dom=dom, state=st, npb=npb, np_total=pos.shape[0],
                meta=dict(name="coastal_runup3d", dp=dp, zsurf=depth))
