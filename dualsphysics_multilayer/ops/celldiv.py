"""Fixed-shape cell division (neighbour structures).

Re-design of the reference's cell-linked-list layer
(`/root/reference/src/source/JCellDivCpu*.cpp`, `JCellDivGpu*_ker.cu`):
instead of a counting sort into variable-length per-cell ranges
(`JCellDivCpuSingle.cpp:276`, thrust radix sort `JCellDivGpu_ker.cu:116-121`),
particles are binned into a *static-shape* structure each step:

* particles are sorted by linear cell id (x-fastest, like `JDsDcell`),
* non-empty cells are compacted into an **active-cell table** of static
  capacity ``A`` (the analog of the reference's shrink-wrapped cell domain,
  `JCellDivCpuSingle.cpp:45-121` — empty space costs nothing),
* each active cell gets a **fixed-capacity bucket** of ``K`` particle slots,
* each active cell precomputes the active-slot ids of its 27 (3D) / 9 (2D)
  neighbour cells, so the force pass is a fully static gather
  (the analog of `JCellSearch_inline.h:33-92` neighbour ranges).

Everything is jit-compatible: no dynamic shapes, overflow is *counted* and
surfaced as a diagnostic instead of resized (the reference's retry-on-overflow
resize `JSphCpuSingle.cpp:393-407` becomes "provision capacity, fail loudly").

Canonical particle arrays are never reordered (ids are stable); the bucket
table holds indices into the canonical arrays.  Sentinels: particle index
``n`` (capacity) marks an empty bucket slot; active-slot ``A`` marks a
missing neighbour cell (row ``A`` of the bucket table is all-sentinel).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .. import typesdef as td


@dataclass(frozen=True)
class Domain:
    """Static cell-grid geometry (reference map/cell config, `JSph::ConfigCellDivision`
    `JSph.cpp:1772` + `JDsDcell` packing). ``scell`` = KernelSize (full cell mode,
    `TpCellMode` `DualSphDef.h:477`)."""
    posmin: tuple            # (x,y,z) map lower corner
    scell: float             # cell width (= kernelsize for full mode)
    nc: tuple                # (ncx, ncy, ncz) cell counts
    simulate2d: bool = False
    cellcap: int = 32        # K: max particles per cell bucket
    maxcells: int = 0        # A: active-cell capacity (0 = auto)

    @property
    def ncells(self) -> int:
        return self.nc[0] * self.nc[1] * self.nc[2]

    @property
    def posmax(self) -> tuple:
        return tuple(self.posmin[i] + self.nc[i] * self.scell for i in range(3))

    @property
    def nneigh(self) -> int:
        return 9 if self.simulate2d else 27

    def neigh_offsets(self):
        """Static list of (dx,dy,dz) neighbour-cell offsets."""
        dys = (0,) if self.simulate2d else (-1, 0, 1)
        return [(dx, dy, dz) for dz in (-1, 0, 1) for dy in dys for dx in (-1, 0, 1)]


def make_domain(posmin, posmax, kernelsize, *, simulate2d=False, dp=0.0,
                cellcap=0, maxcells=0, borders=0.0, skin=0.0) -> Domain:
    """Build the static cell grid covering [posmin-borders, posmax+borders].

    The reference computes map limits from loaded particles plus a KernelSize
    halo (`JSph::LoadCaseParticles`, `JSph.cpp:2036-2081`); here the grid is
    frozen at trace time (the `-cellfixed`/`CellDomFixed` behaviour,
    `DualSphDef.h` — dynamic shrink-wrap is a later optimization).

    ``skin`` inflates the cell size to kernelsize*(1+skin): cells then cover
    every pair up to ``skin*kernelsize`` of total particle displacement, the
    Verlet-list contract that lets the amortized-rebuild path (SortDiv) reuse
    one divide for many steps.  Candidate volume grows by ~(1+skin)^3, so
    keep it small (~1/16).

    ``cellcap`` (K) defaults to the exact worst case for a dp-lattice: a cube
    of side scell holds at most (floor(scell/dp)+1)^dim lattice points;
    WCSPH compression is ~1% so this bound holds throughout a run.
    """
    posmin = tuple(float(p) - borders for p in posmin)
    posmax = tuple(float(p) + borders for p in posmax)
    scell = float(kernelsize) * (1.0 + skin)
    nc = tuple(max(1, int(math.ceil((posmax[i] - posmin[i]) / scell)))
               for i in range(3))
    if simulate2d:
        nc = (nc[0], 1, nc[2])
    if not cellcap:
        dim = 2 if simulate2d else 3
        if dp:
            cellcap = int(math.floor(scell / dp) + 1) ** dim + 4
        else:
            cellcap = 20 if simulate2d else 68
    return Domain(posmin=posmin, scell=scell, nc=nc,
                  simulate2d=simulate2d, cellcap=cellcap, maxcells=maxcells)


@jax.tree_util.register_dataclass
@dataclass
class DivData:
    """Result of a cell division; consumed by every interaction pass
    (the analog of the reference ``StDivDataCpu/Gpu``)."""
    bucket_idx: jax.Array    # (A+1, K) int32: canonical particle index or n (sentinel); row A = all-sentinel
    neigh_slot: jax.Array    # (A, NN) int32: active slot of each neighbour cell, or A
    cell_slot: jax.Array     # (ncells+1,) int32: cell id -> active slot, or A
    nactive: jax.Array       # () int32: number of non-empty cells
    overflow: jax.Array      # () int32: particles dropped (bucket K or table A overflow); MUST be 0
    # static metadata
    ncap: int = field(metadata=dict(static=True), default=0)   # n: particle capacity


def cell_coords(dom: Domain, pos, origin=None):
    """Integer cell coordinates of each position (may be out of range).
    ``origin`` (traced) overrides the static grid anchor — used by domain
    sharding (per-shard slab origins) and, later, dynamic shrink-wrap."""
    if origin is None:
        origin = jnp.asarray(dom.posmin, dtype=pos.dtype)
    rel = (pos - origin) * (1.0 / dom.scell)
    return jnp.floor(rel).astype(jnp.int32)


def divide(dom: Domain, pos, code, origin=None):
    """Bin particles into the fixed-shape cell structure.

    Returns ``(DivData, new_code)`` where ``new_code`` marks formerly-normal
    particles that left the map as OUT_POS (the reference marks these during
    position update, `JSphCpu::UpdatePos`, and compacts them out in
    `JCellDivCpu`; here they simply stop participating).
    """
    n = pos.shape[0]
    ncells = dom.ncells
    K = dom.cellcap
    A = dom.maxcells or min(ncells, n)
    ncx, ncy, ncz = dom.nc

    cxyz = cell_coords(dom, pos, origin)
    inside = jnp.all((cxyz >= 0) & (cxyz < jnp.array(dom.nc, jnp.int32)), axis=1)
    active = td.is_active(code)
    # mark escaped actives as out-pos
    newly_out = active & ~inside
    new_code = jnp.where(newly_out, td.code_set_special(code, td.SPECIAL_OUT_POS), code)
    live = active & inside

    cellid = (cxyz[:, 2] * ncy + cxyz[:, 1]) * ncx + cxyz[:, 0]
    cellid = jnp.where(live, cellid, ncells)  # dead particles sort to the end

    # sort particles by cell id (the analog of the counting/radix sort,
    # JCellDivGpu_ker.cu:116-121); stable so results are deterministic.
    scid, order = jax.lax.sort_key_val(
        cellid, jnp.arange(n, dtype=jnp.int32), is_stable=True)

    # run detection over the sorted cell ids
    prev = jnp.concatenate([jnp.full((1,), -1, scid.dtype), scid[:-1]])
    newrun = scid != prev
    runid = jnp.cumsum(newrun.astype(jnp.int32)) - 1          # active slot per particle
    iarange = jnp.arange(n, dtype=jnp.int32)
    runstart = jax.lax.cummax(jnp.where(newrun, iarange, 0))
    rank = iarange - runstart                                  # rank within the cell

    svalid = scid < ncells
    nactive = jnp.sum((newrun & svalid).astype(jnp.int32))

    # bucket table (A+1, K): row A stays all-sentinel for missing neighbours
    in_bucket = svalid & (rank < K) & (runid < A)
    brow = jnp.where(in_bucket, runid, A)
    bcol = jnp.where(in_bucket, rank, 0)
    bucket_idx = jnp.full((A + 1, K), n, jnp.int32)
    bucket_idx = bucket_idx.at[brow, bcol].set(
        jnp.where(in_bucket, order, n).astype(jnp.int32), mode="drop")
    # row A may have been written by the A-sentinel path with value n already (fine)
    overflow = jnp.sum((svalid & ~in_bucket).astype(jnp.int32))

    # active cell table: cell id per active slot
    run_ok = newrun & svalid & (runid < A)
    slot_of_run = jnp.where(run_ok, runid, A)
    active_cell = jnp.full((A,), ncells, jnp.int32)
    active_cell = active_cell.at[slot_of_run].set(
        jnp.where(run_ok, scid, ncells).astype(jnp.int32), mode="drop")

    # dense cell -> active slot map (int32; the analog of BeginCell)
    cell_slot = jnp.full((ncells + 1,), A, jnp.int32)
    cell_slot = cell_slot.at[jnp.where(run_ok, scid, ncells)].set(
        jnp.where(run_ok, runid, A).astype(jnp.int32), mode="drop")
    cell_slot = cell_slot.at[ncells].set(A)

    # neighbour active slots per active cell
    acx = active_cell % ncx
    acy = (active_cell // ncx) % ncy
    acz = active_cell // (ncx * ncy)
    cols = []
    for (dx, dy, dz) in dom.neigh_offsets():
        nx, ny, nz = acx + dx, acy + dy, acz + dz
        ok = ((nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy)
              & (nz >= 0) & (nz < ncz) & (active_cell < ncells))
        ncell = jnp.where(ok, (nz * ncy + ny) * ncx + nx, ncells)
        cols.append(cell_slot[ncell])
    neigh_slot = jnp.stack(cols, axis=1)

    return DivData(bucket_idx=bucket_idx, neigh_slot=neigh_slot,
                   cell_slot=cell_slot, nactive=nactive, overflow=overflow,
                   ncap=n), new_code


def point_candidates(dom: Domain, div: DivData, points, origin=None):
    """Candidate particle indices around arbitrary query points (m,3):
    returns (m, NN*K) canonical indices (n = empty).  Used by mDBC ghost
    nodes, gauges, and inout extrapolation — the analog of running
    `nsearch::Init` at a free position (JSphCpu.cpp:1045).  ``origin``:
    traced grid anchor override (sharded slab grids)."""
    ncx, ncy, ncz = dom.nc
    ncells = dom.ncells
    A, K = div.bucket_idx.shape[0] - 1, div.bucket_idx.shape[1]
    cxyz = cell_coords(dom, points, origin)
    inside = jnp.all((cxyz >= 0) & (cxyz < jnp.array(dom.nc, jnp.int32)), axis=1)
    cols = []
    for (dx, dy, dz) in dom.neigh_offsets():
        nx = cxyz[:, 0] + dx
        ny = cxyz[:, 1] + dy
        nz = cxyz[:, 2] + dz
        ok = (inside & (nx >= 0) & (nx < ncx) & (ny >= 0) & (ny < ncy)
              & (nz >= 0) & (nz < ncz))
        ncell = jnp.where(ok, (nz * ncy + ny) * ncx + nx, ncells)
        cols.append(div.cell_slot[ncell])
    slots = jnp.stack(cols, axis=1)                  # (m, NN)
    cand = div.bucket_idx[slots]                     # (m, NN, K)
    return cand.reshape(points.shape[0], -1)


@jax.tree_util.register_dataclass
@dataclass
class SortDiv:
    """Cell-sorted divide for the GPU force kernel (ops.pallas.cellforce).

    The analog of the reference's GPU layout: particles radix-sorted by cell
    id (`JCellDivGpu_ker.cu:116-121`) plus its BeginEndCell table
    (`KerCalcBeginEndCell`, `JCellDivGpu_ker.cu:512`).  Sorted rows are cut
    into target blocks of at most ``block`` particles, each inside one (y,z)
    cell-row; each block carries the R = 9 (2D: 3) contiguous candidate
    ranges of its neighbour rows — in every row the x-adjacent cells form
    one range of the sorted arrays (`JCellSearch_inline.h:33-92`).  Every
    table is a true bound: nothing overflows."""
    order: jax.Array       # (n,) canonical index of each sorted row
    blk: jax.Array         # (A, 2+2R) int32: [start, count, wstart.., wend..]
    nlive: jax.Array       # () i32 — sorted rows [0, nlive) are live
    overflow: jax.Array    # () i32 — always 0 (the divide contract's field)
    ncap: int = field(metadata=dict(static=True), default=0)
    block: int = field(metadata=dict(static=True), default=0)  # max targets


def block_capacity(dom: Domain, n: int, block: int) -> int:
    """Static target-block count: a block never crosses a (y,z) cell-row, so
    every occupied row adds at most one partial block."""
    return -(-n // block) + min(dom.nc[1] * dom.nc[2], n)


def divide_sorted(dom: Domain, pos, code, block: int, origin=None):
    """Sort by cell and build the target-block/candidate-range table.

    Returns ``(SortDiv, new_code)``; ``new_code`` marks formerly-active
    particles that left the map as OUT_POS, exactly as :func:`divide`.
    Candidate ranges span the block's x-extent +-1 cell in each neighbour
    row, a superset of every member's neighbourhood; the kernel's rr2 cutoff
    discards the extras.  With a cell skin (``make_domain(skin=...)``) the
    table stays a superset while no particle has moved more than half the
    skin, which lets callers reuse it for many steps."""
    n = pos.shape[0]
    ncells = dom.ncells
    ncx, ncy, ncz = dom.nc
    A = block_capacity(dom, n, block)

    cxyz = cell_coords(dom, pos, origin)
    inside = jnp.all((cxyz >= 0) & (cxyz < jnp.array(dom.nc, jnp.int32)),
                     axis=1)
    active = td.is_active(code)
    newly_out = active & ~inside
    new_code = jnp.where(newly_out,
                         td.code_set_special(code, td.SPECIAL_OUT_POS), code)
    live = active & inside

    cellid = (cxyz[:, 2] * ncy + cxyz[:, 1]) * ncx + cxyz[:, 0]
    cellid = jnp.where(live, cellid, ncells)     # dead rows sort to the end
    scid, order = jax.lax.sort_key_val(
        cellid, jnp.arange(n, dtype=jnp.int32), is_stable=True)
    svalid = scid < ncells
    nlive = jnp.sum(svalid.astype(jnp.int32))
    cellstart = jnp.searchsorted(
        scid, jnp.arange(ncells + 1, dtype=scid.dtype),
        side="left").astype(jnp.int32)

    # target blocks: runs of one (y,z) row, chopped every `block` rows
    iar = jnp.arange(n, dtype=jnp.int32)
    srow = scid // ncx
    newrow = srow != jnp.concatenate([jnp.full((1,), -1, srow.dtype),
                                      srow[:-1]])
    rank = iar - jax.lax.cummax(jnp.where(newrow, iar, 0))
    newblk = svalid & (newrow | (rank % block == 0))
    bid = jnp.where(svalid, jnp.cumsum(newblk.astype(jnp.int32)) - 1, A)
    bstart = jnp.zeros((A,), jnp.int32).at[
        jnp.where(newblk, bid, A)].set(iar, mode="drop")
    bcount = jnp.zeros((A,), jnp.int32).at[bid].add(1, mode="drop")
    scx = scid % ncx
    xmin = jnp.full((A,), ncx, jnp.int32).at[bid].min(scx, mode="drop")
    xmax = jnp.zeros((A,), jnp.int32).at[bid].max(scx, mode="drop")
    brow = jnp.zeros((A,), jnp.int32).at[bid].max(srow, mode="drop")

    is_blk = bcount > 0
    by, bz = brow % ncy, brow // ncy
    xlo = jnp.maximum(xmin - 1, 0)
    xhi = jnp.minimum(xmax + 1, ncx - 1) + 1
    dys = (0,) if dom.simulate2d else (-1, 0, 1)
    ws, we = [], []
    for dz in (-1, 0, 1):
        for dy in dys:
            ny, nz = by + dy, bz + dz
            ok = is_blk & (ny >= 0) & (ny < ncy) & (nz >= 0) & (nz < ncz)
            row = (nz * ncy + ny) * ncx
            ws.append(jnp.where(ok, cellstart[jnp.clip(row + xlo, 0, ncells)],
                                0))
            we.append(jnp.where(ok, cellstart[jnp.clip(row + xhi, 0, ncells)],
                                0))
    blk = jnp.stack([bstart, bcount] + ws + we, axis=1)
    return SortDiv(order=order, blk=blk, nlive=nlive,
                   overflow=jnp.zeros((), jnp.int32), ncap=n,
                   block=block), new_code


def gather(field_arr, idx, fill=0.0):
    """Gather canonical particle data by bucket indices; sentinel index == n
    yields ``fill``.  Works for (n,) and (n, d) fields."""
    import numpy as np
    return jnp.take(field_arr, idx, axis=0, mode="fill",
                    fill_value=np.dtype(field_arr.dtype).type(fill))


def scatter_add(n, idx, values, width=None):
    """Scatter bucket-layout values back to canonical order.  Each live
    particle occupies exactly one bucket slot, so this is collision-free
    (the gather-only force formulation keeps the scatter race-free, like the
    reference's one-thread-per-target pattern, SURVEY §5.2)."""
    shape = (n,) if width is None else (n, width)
    out = jnp.zeros(shape, values.dtype)
    return out.at[idx.reshape(-1)].add(values.reshape((-1,) + values.shape[len(idx.shape):]),
                                       mode="drop")
