"""Cell-division tests: the fixed-shape bucket structure must reproduce the
exact neighbour sets of a brute-force O(N^2) search (the correctness contract
of JCellDivCpuSingle + JCellSearch_inline)."""

import numpy as np
import jax.numpy as jnp

from dualsphysics_multilayer import typesdef as td
from dualsphysics_multilayer.ops import celldiv as cd


def random_cloud(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, size=(n, 3))


def bucket_neighbour_pairs(dom, div, pos, ks):
    """All (i, j) pairs with |ri-rj| <= ks reachable through the structure."""
    bidx = np.asarray(div.bucket_idx)
    nslot = np.asarray(div.neigh_slot)
    n = pos.shape[0]
    pairs = set()
    A = nslot.shape[0]
    for a in range(A):
        targets = bidx[a][bidx[a] < n]
        for o in range(nslot.shape[1]):
            cs = nslot[a, o]
            cands = bidx[cs][bidx[cs] < n]
            for i in targets:
                for j in cands:
                    if i != j and np.sum((pos[i] - pos[j]) ** 2) <= ks * ks:
                        pairs.add((int(i), int(j)))
    return pairs


def brute_pairs(pos, ks, live=None):
    n = pos.shape[0]
    pairs = set()
    for i in range(n):
        for j in range(n):
            if i != j and (live is None or (live[i] and live[j])):
                if np.sum((pos[i] - pos[j]) ** 2) <= ks * ks:
                    pairs.add((i, j))
    return pairs


def test_divide_finds_all_pairs_3d():
    ks = 0.1
    pos = random_cloud(300, 0.0, 0.5)
    dom = cd.make_domain((0, 0, 0), (0.5, 0.5, 0.5), ks, cellcap=64)
    code = jnp.full((300,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, code2 = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    assert int(div.overflow) == 0
    got = bucket_neighbour_pairs(dom, div, pos, ks)
    want = brute_pairs(pos, ks)
    # cutoff-equal pairs can differ by f32 rounding; compare with slack
    missing = want - got
    for (i, j) in list(missing):
        r = np.sqrt(np.sum((pos[i] - pos[j]) ** 2))
        assert r > ks * (1 - 1e-5), f"missing pair {i},{j} at r={r}"
    assert len(missing) / max(len(want), 1) < 0.01


def test_divide_2d():
    ks = 0.08
    pos = random_cloud(200, 0.0, 0.4)
    pos[:, 1] = 0.0
    dom = cd.make_domain((0, -0.04, 0), (0.4, 0.04, 0.4), ks,
                         simulate2d=True, cellcap=64)
    assert dom.nc[1] == 1 and dom.nneigh == 9
    code = jnp.full((200,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    assert int(div.overflow) == 0
    got = bucket_neighbour_pairs(dom, div, pos, ks)
    want = brute_pairs(pos, ks)
    assert len(want - got) / max(len(want), 1) < 0.01


def test_out_of_domain_marking():
    ks = 0.1
    pos = np.array([[0.2, 0.2, 0.2], [0.9, 0.2, 0.2], [-0.5, 0.0, 0.0]])
    dom = cd.make_domain((0, 0, 0), (0.5, 0.5, 0.5), ks)
    code = jnp.full((3,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, code2 = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    out = np.asarray(td.is_out(code2))
    np.testing.assert_array_equal(out, [False, True, True])
    # already-out particles stay out and never re-enter buckets
    div2, code3 = cd.divide(dom, jnp.asarray(pos, jnp.float32), code2)
    assert int(div2.nactive) == 1


def test_bucket_each_live_particle_once():
    ks = 0.05
    n = 500
    pos = random_cloud(n, 0.0, 0.3, seed=3)
    dom = cd.make_domain((0, 0, 0), (0.3, 0.3, 0.3), ks, cellcap=32)
    code = jnp.full((n,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    assert int(div.overflow) == 0
    bidx = np.asarray(div.bucket_idx)
    live = bidx[bidx < n]
    assert len(live) == n
    assert len(set(live.tolist())) == n


def test_overflow_detection():
    """More particles in one cell than cellcap must be *counted*, not lost
    silently (the provision-capacity-fail-loudly contract, SURVEY §7)."""
    ks = 1.0
    n = 40
    pos = np.full((n, 3), 0.5)
    dom = cd.make_domain((0, 0, 0), (2.0, 2.0, 2.0), ks, cellcap=8)
    code = jnp.full((n,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    assert int(div.overflow) == n - 8


def test_scatter_gather_roundtrip():
    n = 100
    pos = random_cloud(n, 0.0, 0.3, seed=5)
    dom = cd.make_domain((0, 0, 0), (0.3, 0.3, 0.3), 0.06, cellcap=32)
    code = jnp.full((n,), td.code_make(td.TYPE_FLUID, 0), jnp.uint32)
    div, _ = cd.divide(dom, jnp.asarray(pos, jnp.float32), code)
    vals = jnp.asarray(np.arange(n, dtype=np.float32))
    b = cd.gather(vals, div.bucket_idx[:-1])
    back = cd.scatter_add(n, div.bucket_idx[:-1], b)
    np.testing.assert_allclose(np.asarray(back), np.asarray(vals))
