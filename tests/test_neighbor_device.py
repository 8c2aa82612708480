"""Device cell-grid search vs host ground truth (bit-compatible sets)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from molar_tpu.core.pbc import PBC_FULL, PbcDims, PeriodicBox
from molar_tpu.ops import neighbor, neighbor_host


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(17)
    n = 600
    box = PeriodicBox(np.diag([4.0, 5.0, 6.0]).astype(np.float32))
    coords = rng.uniform(-2, 8, (n, 3)).astype(np.float32)
    src = np.arange(n)
    tgt = rng.choice(n, 60, replace=False)
    tgt.sort()
    return box, coords, src, tgt


@pytest.mark.parametrize("cutoff", [0.3, 0.5, 0.9])
def test_within_matches_host(scene, cutoff):
    box, coords, src, tgt = scene
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    mask, overflow = jax.jit(
        neighbor.within_mask, static_argnames=("cutoff", "dims", "cap", "pbc")
    )(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=cutoff,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        dims=dims,
        cap=64,
    )
    assert not bool(overflow)
    got = src[np.asarray(mask)]
    want = neighbor_host.search_within(cutoff, coords, src, tgt, box, PBC_FULL)
    assert np.array_equal(got, want), (len(got), len(want))


def test_within_triclinic(scene):
    box = PeriodicBox.from_vectors_angles(4.0, 5.0, 6.0, 80.0, 85.0, 75.0)
    rng = np.random.default_rng(3)
    coords = rng.uniform(-2, 8, (400, 3)).astype(np.float32)
    src = np.arange(400)
    tgt = np.arange(0, 400, 7)
    cutoff = 0.5
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    mask, overflow = neighbor.within_mask(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=cutoff,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        corrections=jnp.asarray(box.padded_corrections()),
        dims=dims,
        cap=64,
    )
    assert not bool(overflow)
    got = src[np.asarray(mask)]
    want = neighbor_host.search_within(cutoff, coords, src, tgt, box, PBC_FULL)
    assert np.array_equal(got, want)


def test_cap_overflow_flag(scene):
    box, coords, src, tgt = scene
    dims = neighbor.grid_dims(box.box_extents(), 0.5)
    _, overflow = neighbor.within_mask(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=0.5,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        dims=dims,
        cap=1,
    )
    assert bool(overflow)


def test_contact_pairs_match_host(scene):
    box, coords, src, tgt = scene
    cutoff = 0.5
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    pairs, dist, count, overflow = neighbor.contact_pairs(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=cutoff,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        dims=dims,
        cap=64,
        max_pairs=1 << 14,
    )
    assert not bool(overflow)
    got_pairs = np.asarray(pairs)
    got_pairs = got_pairs[got_pairs[:, 0] >= 0]
    got = set(map(tuple, got_pairs.tolist()))
    hpairs, hdist = neighbor_host.search_pairs(cutoff, coords, src, tgt, box, PBC_FULL)
    want = set(map(tuple, hpairs.tolist()))
    assert got == want
    assert int(count) == len(want)
    # distances agree
    hd = {tuple(p): d for p, d in zip(hpairs.tolist(), hdist.tolist())}
    gd = np.asarray(dist)[np.asarray(pairs)[:, 0] >= 0]
    for p, d in zip(got_pairs.tolist(), gd.tolist()):
        assert abs(hd[tuple(p)] - d) < 1e-5


def test_vmap_over_frames(scene):
    box, coords, src, tgt = scene
    cutoff = 0.5
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    rng = np.random.default_rng(5)
    frames = np.stack([coords, coords + rng.normal(0, 0.05, coords.shape).astype(np.float32)])
    boxes = jnp.asarray(np.repeat(box.matrix[None], 2, axis=0))
    invs = jnp.asarray(np.repeat(box.inv[None], 2, axis=0))

    def one(c, b, i):
        return neighbor.within_mask(
            c, jnp.asarray(src), jnp.asarray(tgt), cutoff=cutoff, box=b, inv=i,
            dims=dims, cap=64,
        )

    masks, ofl = jax.vmap(one)(jnp.asarray(frames), boxes, invs)
    assert masks.shape == (2, len(src))
    for f in range(2):
        want = neighbor_host.search_within(cutoff, frames[f], src, tgt, box, PBC_FULL)
        got = src[np.asarray(masks[f])]
        assert np.array_equal(got, want)


def test_partial_pbc(scene):
    box, coords, src, tgt = scene
    cutoff = 0.5
    pd = PbcDims(True, False, True)
    # Extents along non-periodic dims: mimic host by using box dims anyway
    # (points outside the box along y are dropped by the host; the device
    # kernel wraps only periodic dims and clips cells, keeping behavior for
    # in-box points).
    inside = coords[:, 1] >= 0
    inside &= coords[:, 1] < box.matrix[1, 1]
    src2 = src[inside[src]]
    tgt2 = tgt[inside[tgt]]
    dims = neighbor.grid_dims(box.box_extents(), cutoff)
    mask, _ = neighbor.within_mask(
        jnp.asarray(coords),
        jnp.asarray(src2),
        jnp.asarray(tgt2),
        cutoff=cutoff,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        dims=dims,
        cap=64,
        pbc=pd.as_tuple(),
    )
    got = src2[np.asarray(mask)]
    want = neighbor_host.search_within(cutoff, coords, src2, tgt2, box, pd)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cutoff", [0.3, 0.5, 0.9])
def test_contact_pairs_dense_match_host(scene, cutoff):
    # same contract as the grid path, no grid: all src x tgt candidates
    box, coords, src, tgt = scene
    pairs, dist, count, overflow = jax.jit(
        neighbor.contact_pairs_dense,
        static_argnames=("cutoff", "max_pairs", "pbc"),
    )(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=cutoff,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        max_pairs=1 << 14,
    )
    assert not bool(overflow)
    got_pairs = np.asarray(pairs)
    got_pairs = got_pairs[got_pairs[:, 0] >= 0]
    got = set(map(tuple, got_pairs.tolist()))
    hpairs, hdist = neighbor_host.search_pairs(cutoff, coords, src, tgt, box, PBC_FULL)
    want = set(map(tuple, hpairs.tolist()))
    assert got == want
    assert int(count) == len(want)
    # distances match the host's per-pair values
    hmap = {tuple(p): d for p, d in zip(hpairs.tolist(), hdist.tolist())}
    for p, d in zip(got_pairs.tolist(), np.asarray(dist).tolist()):
        assert abs(hmap[tuple(p)] - d) < 1e-5


def test_contact_pairs_dense_triclinic():
    box = PeriodicBox.from_vectors_angles(4.0, 5.0, 6.0, 80.0, 85.0, 75.0)
    rng = np.random.default_rng(5)
    coords = rng.uniform(-2, 8, (300, 3)).astype(np.float32)
    src = np.arange(300)
    tgt = np.arange(0, 300, 5)
    pairs, dist, count, overflow = neighbor.contact_pairs_dense(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=0.6,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        corrections=jnp.asarray(box.padded_corrections()),
        max_pairs=1 << 14,
    )
    assert not bool(overflow)
    got_pairs = np.asarray(pairs)
    got_pairs = got_pairs[got_pairs[:, 0] >= 0]
    got = set(map(tuple, got_pairs.tolist()))
    hpairs, _ = neighbor_host.search_pairs(0.6, coords, src, tgt, box, PBC_FULL)
    want = set(map(tuple, hpairs.tolist()))
    assert got == want


def test_contact_pairs_dense_overflow_flag(scene):
    box, coords, src, tgt = scene
    _, _, count, overflow = neighbor.contact_pairs_dense(
        jnp.asarray(coords),
        jnp.asarray(src),
        jnp.asarray(tgt),
        cutoff=0.9,
        box=jnp.asarray(box.matrix),
        inv=jnp.asarray(box.inv),
        max_pairs=8,
    )
    assert int(count) > 8
    assert bool(overflow)


# The six cases the former hand-written stencil kernel was checked on (same
# boxes, cutoffs and caps), now on the XLA search: the dense stencil, a grid
# with a length-2 axis (wrap aliasing), the ghost-plane variant and partial
# PBC.
_XLA_CASES = {
    "dense-seed11-c0.5": dict(seed=11, n=700, nt=90, cutoff=0.5, cap=48,
                              tgt_cap=32),
    "dense-seed3-c0.8": dict(seed=3, n=700, nt=90, cutoff=0.8, cap=48,
                             tgt_cap=32),
    "small-grid-len2-axis": dict(seed=5, n=200, stride=5, cutoff=0.9,
                                 cap=128, tgt_cap=64,
                                 diag=(2.0, 4.0, 4.0), lo=0.0, hi=4.0),
    "ghost-seed7-c0.5": dict(seed=7, n=900, nt=120, cutoff=0.5, cap=64,
                             tgt_cap=32, ghost=True),
    "ghost-seed19-c0.9": dict(seed=19, n=900, nt=120, cutoff=0.9, cap=64,
                              tgt_cap=32, ghost=True),
    "ghost-partial-pbc": dict(seed=4, n=500, stride=6, cutoff=0.5, cap=64,
                              tgt_cap=32, ghost=True,
                              pbc=(True, False, True)),
}


@pytest.mark.parametrize("case", list(_XLA_CASES), ids=list(_XLA_CASES))
def test_within_mask_xla_matches_host(case):
    p = _XLA_CASES[case]
    rng = np.random.default_rng(p["seed"])
    box = PeriodicBox(np.diag(p.get("diag", (4.0, 5.0, 6.0))).astype(np.float32))
    coords = rng.uniform(p.get("lo", -2.0), p.get("hi", 8.0),
                         (p["n"], 3)).astype(np.float32)
    pbc = p.get("pbc", (True, True, True))
    src = np.arange(p["n"])
    if not pbc[1]:
        # a non-periodic axis only holds atoms inside the box
        src = src[(coords[:, 1] >= 0) & (coords[:, 1] < 5.0)]
    if "stride" in p:
        tgt = src[:: p["stride"]]
    else:
        tgt = np.sort(rng.choice(p["n"], p["nt"], replace=False))
    dims = neighbor.grid_dims(box.box_extents(), p["cutoff"])
    mask, ofl = neighbor.within_mask(
        jnp.asarray(coords), jnp.asarray(src), jnp.asarray(tgt), p["cutoff"],
        jnp.asarray(box.matrix), jnp.asarray(box.inv), dims=dims,
        cap=p["cap"], tgt_cap=p["tgt_cap"], pbc=pbc,
        ghost=p.get("ghost", False),
    )
    assert not bool(ofl)
    got = src[np.asarray(mask)]
    want = neighbor_host.search_within(p["cutoff"], coords, src, tgt, box,
                                       PbcDims(*pbc))
    assert np.array_equal(got, want), (len(got), len(want))
