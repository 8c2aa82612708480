"""Device (JAX) cell-grid neighbor search with periodic minimum-image.

The device re-expression of the reference's rayon cell-pair search
(molar/src/distance_search.rs): points are binned to cells with a
sort + searchsorted, cells materialize as a fixed-capacity (n_cells, cap)
member table, and each query atom scans its 27-cell neighborhood. All shapes
are static, so the whole search jits, vmaps over frames, and fuses with the
downstream analysis. Parallelism = the atom axis x frames via vmap/scan
(vs. rayon work-stealing over cell pairs).

Layout note: the hot path is **structure-of-arrays** — x/y/z live in
separate (n,) planes and candidate blocks are (n, cap). A (n, cap, 3) AoS
layout lets a compiler pad the size-3 minor axis to its tile width (this
happened on the accelerator the code was first written for, as a many-GB
allocation for a 100k-atom frame window). Min-image is computed
componentwise from the box matrix scalars.

Static-shape contract:

* ``dims`` (cells per axis) is a static arg — compute it host-side from the
  window's smallest box via :func:`grid_dims` (cells never smaller than the
  cutoff => correctness is invariant to dims, only speed changes);
* ``cap`` (max atoms/cell) is static; searches return an ``overflow`` flag —
  on True, the caller re-jits with a bigger cap (fixed-capacity + retry,
  SURVEY §7 hard part #1);
* contact lists are fixed-capacity ``(max_pairs, 2)`` + count (+ overflow).

The cutoff test is inclusive (d^2 <= cutoff^2, distance_search.rs:287) and an
atom present in both sets matches itself at d=0 (VMD-compatible `within`).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "grid_dims",
    "estimate_caps",
    "cell_table",
    "within_mask",
    "contact_pairs",
    "contact_pairs_dense",
]

_HI = jax.lax.Precision.HIGHEST

_OFFSETS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    dtype=np.int32,
)


def grid_dims(box_lengths, cutoff: float) -> tuple[int, int, int]:
    """Static per-axis cell counts: max(floor(extent/cutoff), 1)
    (distance_search.rs:103-114). Host helper."""
    return tuple(max(int(np.floor(float(l) / cutoff)), 1) for l in box_lengths)


def _mat3_cols(m):
    """The nine scalars of a (3,3) matrix (works for traced per-frame boxes)."""
    return (
        m[0, 0], m[0, 1], m[0, 2],
        m[1, 0], m[1, 1], m[1, 2],
        m[2, 0], m[2, 1], m[2, 2],
    )


def _apply3(m, x, y, z):
    """Componentwise m @ (x,y,z) for broadcast component planes."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = _mat3_cols(m)
    return (
        m00 * x + m01 * y + m02 * z,
        m10 * x + m11 * y + m12 * z,
        m20 * x + m21 * y + m22 * z,
    )


def _min_image_d2(dx, dy, dz, box, inv, corrections, pbc):
    """Squared min-image norm of component planes (any broadcast shape)."""
    fx, fy, fz = _apply3(inv, dx, dy, dz)
    if pbc[0]:
        fx = fx - jnp.round(fx)
    if pbc[1]:
        fy = fy - jnp.round(fy)
    if pbc[2]:
        fz = fz - jnp.round(fz)
    sx, sy, sz = _apply3(box, fx, fy, fz)
    d2 = sx * sx + sy * sy + sz * sz
    if corrections is None or not all(pbc):
        return d2
    # Triclinic correction: keep the shortest among the candidate shifts
    # (periodic_box.rs:286-318). corrections: (K, 3); zero rows are no-ops.
    best = d2
    for k in range(corrections.shape[0]):
        cx = sx + corrections[k, 0]
        cy = sy + corrections[k, 1]
        cz = sz + corrections[k, 2]
        best = jnp.minimum(best, cx * cx + cy * cy + cz * cz)
    return best


def _wrap_frac(coords, inv):
    fx, fy, fz = _apply3(inv, coords[..., 0], coords[..., 1], coords[..., 2])
    fx = fx - jnp.floor(fx)
    fy = fy - jnp.floor(fy)
    fz = fz - jnp.floor(fz)
    return fx, fy, fz


def _cell3(fx, fy, fz, dims):
    cx = jnp.clip((fx * dims[0]).astype(jnp.int32), 0, dims[0] - 1)
    cy = jnp.clip((fy * dims[1]).astype(jnp.int32), 0, dims[1] - 1)
    cz = jnp.clip((fz * dims[2]).astype(jnp.int32), 0, dims[2] - 1)
    return cx, cy, cz


def _rank_in_run(sorted_flat):
    """Rank of each element within its run of equal values (sorted input).

    ``i - cummax(run_start_positions)`` — an associative scan, NOT
    jnp.searchsorted(x, x), whose binary-search lowering was far slower on
    the accelerator this was first written for (not re-measured on a GPU).
    """
    m = sorted_flat.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), sorted_flat[1:] != sorted_flat[:-1]]
    )
    run_start = jax.lax.associative_scan(jnp.maximum, jnp.where(is_start, idx, -1))
    return idx - run_start


def cell_table(fx, fy, fz, dims: tuple[int, int, int], cap: int):
    """Bucket points by cell. Returns ((n_cells, cap) member table padded
    with -1, overflow bool)."""
    cx, cy, cz = _cell3(fx, fy, fz, dims)
    flat = (cx * dims[1] + cy) * dims[2] + cz
    n_cells = dims[0] * dims[1] * dims[2]
    order = jnp.argsort(flat)
    sorted_flat = flat[order]
    rank = _rank_in_run(sorted_flat)
    overflow = jnp.any(rank >= cap)
    slot = sorted_flat * cap + jnp.minimum(rank, cap - 1)
    table = (
        jnp.full((n_cells * cap,), -1, dtype=jnp.int32)
        .at[slot]
        .set(order.astype(jnp.int32))
        .reshape(n_cells, cap)
    )
    return table, overflow


def _neighbor_cell_ids(cx, cy, cz, off, dims, pbc):
    """Flat neighbor-cell id for one (3,) offset; -1 if out of range."""
    valid = jnp.ones(cx.shape, dtype=bool)
    ids = []
    for comp, d, per in ((cx, 0, pbc[0]), (cy, 1, pbc[1]), (cz, 2, pbc[2])):
        c = comp + off[d]
        if per:
            c = jnp.mod(c, dims[d])
        else:
            valid = valid & (c >= 0) & (c < dims[d])
            c = jnp.clip(c, 0, dims[d] - 1)
        ids.append(c)
    flat = (ids[0] * dims[1] + ids[1]) * dims[2] + ids[2]
    return jnp.where(valid, flat, -1)


def _dedupe_small_grid(nb_ids):
    """(n, 27) neighbor ids -> duplicates masked to -1 (tiny periodic grids
    alias different offsets to the same cell)."""
    s = jnp.sort(nb_ids, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((s.shape[0], 1), bool), s[:, 1:] == s[:, :-1]], axis=1
    )
    return jnp.where(dup, -1, s)


def _search_core(
    coords, src_idx, tgt_idx, cutoff, box, inv, corrections, dims, cap, pbc
):
    """Shared setup for the cell search.

    Returns (table, overflow, a ``step(o) -> (members, hit)`` function over
    offset index ``o``, and the wrapped src/tgt component planes). Callers
    drive the 27 offsets through ``lax.fori_loop`` — one compiled body
    instead of a 27x-unrolled graph (which took ~27 x 15 s of XLA compile
    time at 100k atoms).

    When ``corrections is None`` and every grid axis has >= 3 cells (no
    offset aliasing, in-cutoff image unique), the per-pair min-image chain is
    replaced by the per-(atom, offset) lattice shift (:func:`_cells_shift`).
    """
    src = coords[src_idx]
    tgt = coords[tgt_idx]
    sfx, sfy, sfz = _wrap_frac(src, inv)
    tfx, tfy, tfz = _wrap_frac(tgt, inv)
    # Wrapped lab coordinates: small displacements, single min-image exact.
    sx, sy, sz = _apply3(box, sfx, sfy, sfz)
    tx, ty, tz = _apply3(box, tfx, tfy, tfz)
    table, overflow = cell_table(tfx, tfy, tfz, dims, cap)
    cx, cy, cz = _cell3(sfx, sfy, sfz, dims)

    c2 = jnp.asarray(cutoff, src.dtype) ** 2
    offs_j = jnp.asarray(_OFFSETS)

    if corrections is None and min(dims) >= 3:

        def step(o):
            off = offs_j[o]
            cells, (shx, shy, shz), ok = _cells_shift(
                cx, cy, cz, off, dims, pbc, box, src.dtype
            )
            members = table[cells]  # (n, cap)
            valid = ok[:, None] & (members >= 0)
            cand = jnp.maximum(members, 0)
            dx = tx[cand] + shx[:, None] - sx[:, None]
            dy = ty[cand] + shy[:, None] - sy[:, None]
            dz = tz[cand] + shz[:, None] - sz[:, None]
            d2 = dx * dx + dy * dy + dz * dz
            return members, valid & (d2 <= c2)

        return table, overflow, step, (sx, sy, sz), (tx, ty, tz)

    nb_ids = jnp.stack(
        [_neighbor_cell_ids(cx, cy, cz, _OFFSETS[o], dims, pbc) for o in range(27)],
        axis=1,
    )  # (n, 27) — 27 tiny int ops; the heavy work stays in the loop body
    if min(dims) <= 2:
        nb_ids = _dedupe_small_grid(nb_ids)

    def step(o):
        cells = jax.lax.dynamic_index_in_dim(nb_ids, o, axis=1, keepdims=False)
        ok = cells >= 0
        members = table[jnp.maximum(cells, 0)]  # (n, cap)
        valid = ok[:, None] & (members >= 0)
        cand = jnp.maximum(members, 0)
        dx = tx[cand] - sx[:, None]
        dy = ty[cand] - sy[:, None]
        dz = tz[cand] - sz[:, None]
        d2 = _min_image_d2(dx, dy, dz, box, inv, corrections, pbc)
        return members, valid & (d2 <= c2)

    return table, overflow, step, (sx, sy, sz), (tx, ty, tz)


def _blocked_planes(values_list, flat, n_cells: int, cap: int, fill):
    """Scatter per-point planes into cell-blocked (n_cells, cap) layout.

    Returns (blocked planes, slot per point (sorted order), order, overflow).
    This is the blocked cell grid: per-cell rows are contiguous, so the
    neighbor scan is a row gather + dense block math instead of random
    per-atom gathers.

    ``slot`` is non-decreasing by construction (sorted cell ids x cap + rank)
    and unique unless a cell overflows ``cap`` — in which case the overflow
    flag invalidates the result anyway — so the scatters carry the
    sorted/unique hints.
    """
    order = jnp.argsort(flat)
    sorted_flat = flat[order]
    rank = _rank_in_run(sorted_flat)
    overflow = jnp.any(rank >= cap)
    slot = sorted_flat * cap + jnp.minimum(rank, cap - 1)
    out = []
    for v, f in zip(values_list, fill):
        out.append(
            jnp.full((n_cells * cap,), f, dtype=v.dtype)
            .at[slot]
            .set(v[order], indices_are_sorted=True, unique_indices=True)
            .reshape(n_cells, cap)
        )
    return out, slot, order, overflow


def _cell_neighbor_ids(dims, pbc):
    """(n_cells, 27) flat neighbor ids for every cell (host-precomputable but
    cheap enough to trace; -1 for out-of-range non-periodic)."""
    nx, ny, nz = dims
    cx, cy, cz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    cell3 = np.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=1)  # (n_cells, 3)
    nb = cell3[:, None, :] + _OFFSETS[None, :, :]
    valid = np.ones(nb.shape[:2], dtype=bool)
    for d, per in enumerate(pbc):
        if per:
            nb[:, :, d] %= dims[d]
        else:
            valid &= (nb[:, :, d] >= 0) & (nb[:, :, d] < dims[d])
            nb[:, :, d] = np.clip(nb[:, :, d], 0, dims[d] - 1)
    flat = (nb[:, :, 0] * ny + nb[:, :, 1]) * nz + nb[:, :, 2]
    flat = np.where(valid, flat, -1)
    if min(dims) <= 2:
        # Tiny periodic grids: offsets alias; mask duplicates per cell row.
        s = np.sort(flat, axis=1)
        dup = np.zeros_like(s, dtype=bool)
        dup[:, 1:] = s[:, 1:] == s[:, :-1]
        flat = np.where(dup, -1, s)
    return flat


def _unsort_mask(hit_blocks, s_slot, s_order, n):
    """Per-atom mask from cell-blocked hits: gather each sorted atom's slot,
    then undo the sort (s_order is a permutation, so indices are unique)."""
    hit_sorted = hit_blocks.reshape(-1)[s_slot]
    return (
        jnp.zeros(n, dtype=bool)
        .at[s_order]
        .set(hit_sorted, unique_indices=True)
    )


def estimate_caps(coords, inv, dims, tgt_idx=None, margin: float = 1.2,
                  round_to: int = 8):
    """Host-side frame-occupancy capacity estimate for the fixed-capacity
    cell tables (NOT a trajectory pre-pass — drift beyond the margin is
    absorbed by the overflow-retry contract).

    Returns (cap, tgt_cap, occupied_tgt_cells): each max occupancy scaled by
    ``margin`` (ceiling), then — in rounded mode only (``round_to > 1``) —
    given +2 slots of jitter headroom and rounded up to a multiple of
    ``round_to`` (stable static shapes => stable XLA cache keys).
    ``margin=1.0, round_to=1`` gives the exact raw counts for callers with
    their own tiering policy (no headroom is added in raw mode). ``tgt_idx``
    None makes the last two 0.
    """
    import math

    nx, ny, nz = dims
    frac = (np.asarray(coords, np.float64) @ np.asarray(inv, np.float64).T) % 1.0
    cx = np.minimum((frac[:, 0] * nx).astype(np.int64), nx - 1)
    cy = np.minimum((frac[:, 1] * ny).astype(np.int64), ny - 1)
    cz = np.minimum((frac[:, 2] * nz).astype(np.int64), nz - 1)
    cell = (cx * ny + cy) * nz + cz
    n_cells = nx * ny * nz

    def size(v):
        v = math.ceil(v * margin)
        if round_to > 1:
            v = (v + 2 + round_to - 1) // round_to * round_to
        return v

    cap = size(np.bincount(cell, minlength=n_cells).max())
    if tgt_idx is None:
        return cap, 0, 0
    tc = np.bincount(cell[np.asarray(tgt_idx)], minlength=n_cells)
    return cap, size(tc.max()), int((tc > 0).sum())


def _cells_shift(cx, cy, cz, off, dims, pbc, box, dtype):
    """Neighbor-cell ids plus the lab-frame lattice shift of that neighbor's
    periodic image, for one (3,) offset applied to cell coords ``cx/cy/cz``.

    The shift replaces per-pair min-image math: with every point wrapped into
    the unit cell and cells no smaller than the cutoff, the only image of a
    neighboring cell's contents that can be within cutoff is the one displaced
    by the wrap's lattice vector — known per (cell, offset), broadcast over
    the whole distance block (see distance_search.rs:39-60 for the reference's
    equivalent cell-pair shift plan).

    Returns (flat cell ids (clipped), (shift_x, shift_y, shift_z), ok mask).
    """
    ok = jnp.ones(cx.shape, dtype=bool)
    cs = []
    ws = []
    for comp, d, per in ((cx, 0, pbc[0]), (cy, 1, pbc[1]), (cz, 2, pbc[2])):
        c = comp + off[d]
        if per:
            w = jnp.where(c >= dims[d], 1, jnp.where(c < 0, -1, 0))
            c = c - w * dims[d]
        else:
            w = jnp.zeros_like(c)
            ok = ok & (c >= 0) & (c < dims[d])
            c = jnp.clip(c, 0, dims[d] - 1)
        cs.append(c)
        ws.append(w.astype(dtype))
    cells = (cs[0] * dims[1] + cs[1]) * dims[2] + cs[2]
    # Lab shift = box @ w (box columns are the box vectors).
    shx = box[0, 0] * ws[0] + box[0, 1] * ws[1] + box[0, 2] * ws[2]
    shy = box[1, 0] * ws[0] + box[1, 1] * ws[1] + box[1, 2] * ws[2]
    shz = box[2, 0] * ws[0] + box[2, 1] * ws[1] + box[2, 2] * ws[2]
    return cells, (shx, shy, shz), ok


def _ghost_planes(vals, flat_pad, dims, cap: int, box, pbc, fill):
    """Scatter component planes into a ghost-padded
    ``(nx+2, ny+2, nz+2, cap)`` grid and fill the ghost faces with wrapped
    copies whose coordinates are pre-shifted by the corresponding box vector.

    After this, the 27-offset stencil needs NO gathers, NO per-pair image
    math, and NO validity masks: each offset's neighbor block is a contiguous
    ``dynamic_slice``, wrapped images carry pre-shifted coordinates, and
    non-periodic out-of-range faces keep the sentinel fill (no hits).

    ``vals``: [x, y, z] per-point planes. ``flat_pad``: padded flat cell id
    per point. Returns ([3 padded planes], overflow).
    """
    nx, ny, nz = dims
    px, py, pz = nx + 2, ny + 2, nz + 2
    order = jnp.argsort(flat_pad)
    sorted_flat = flat_pad[order]
    rank = _rank_in_run(sorted_flat)
    overflow = jnp.any(rank >= cap)
    slot = sorted_flat * cap + jnp.minimum(rank, cap - 1)
    out = []
    for d, v in enumerate(vals):
        p = (
            jnp.full((px * py * pz * cap,), fill, dtype=v.dtype)
            .at[slot]
            .set(v[order], indices_are_sorted=True, unique_indices=True)
            .reshape(px, py, pz, cap)
        )
        # Ghost faces, axis by axis (x, then y with x-ghosts, then z with
        # both) so edges and corners compose the right multi-axis shifts.
        if pbc[0]:
            p = p.at[0].set(p[nx] - box[d, 0])
            p = p.at[nx + 1].set(p[1] + box[d, 0])
        if pbc[1]:
            p = p.at[:, 0].set(p[:, ny] - box[d, 1])
            p = p.at[:, ny + 1].set(p[:, 1] + box[d, 1])
        if pbc[2]:
            p = p.at[:, :, 0].set(p[:, :, nz] - box[d, 2])
            p = p.at[:, :, nz + 1].set(p[:, :, 1] + box[d, 2])
        out.append(p)
    return out, overflow


def _within_ghost(
    sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz,
    cutoff, box, dims, cap, tgt_cap, pbc, n_src,
):
    """Ghost-padded dense stencil: returns (mask over src order, overflow).

    One (n_cells, cap, tgt_cap) distance block per offset, with the target
    block obtained as a contiguous dynamic slice of the ghost-padded planes.
    """
    n_cells = dims[0] * dims[1] * dims[2]
    big_s = jnp.asarray(-1e17, sx.dtype)
    big_t = jnp.asarray(1e17, sx.dtype)
    (sxb, syb, szb), s_slot, s_order, s_ofl = _blocked_planes(
        [sx, sy, sz], sflat, n_cells, cap, [big_s, big_s, big_s]
    )
    tflat_pad = ((tcx + 1) * (dims[1] + 2) + (tcy + 1)) * (dims[2] + 2) + (
        tcz + 1
    )
    (gx, gy, gz), t_ofl = _ghost_planes(
        [tx, ty, tz], tflat_pad, dims, tgt_cap, box, pbc, big_t
    )
    c2 = jnp.asarray(cutoff, sx.dtype) ** 2
    offs_j = jnp.asarray(_OFFSETS)
    sxb3 = sxb[:, :, None]
    syb3 = syb[:, :, None]
    szb3 = szb[:, :, None]
    sizes = (dims[0], dims[1], dims[2], tgt_cap)

    def body(o, hit_blocks):
        off = offs_j[o] + 1  # slice starts in the padded grid
        # All starts must share one integer type (int64 default under x64).
        st = (off[0], off[1], off[2], jnp.zeros((), off.dtype))
        ntx = jax.lax.dynamic_slice(gx, st, sizes).reshape(n_cells, tgt_cap)
        nty = jax.lax.dynamic_slice(gy, st, sizes).reshape(n_cells, tgt_cap)
        ntz = jax.lax.dynamic_slice(gz, st, sizes).reshape(n_cells, tgt_cap)
        dx = ntx[:, None, :] - sxb3
        dy = nty[:, None, :] - syb3
        dz = ntz[:, None, :] - szb3
        d2 = dx * dx + dy * dy + dz * dz
        return hit_blocks | jnp.any(d2 <= c2, axis=2)

    hit_blocks = jax.lax.fori_loop(
        0, 27, body, jnp.zeros((n_cells, cap), dtype=bool)
    )
    return _unsort_mask(hit_blocks, s_slot, s_order, n_src), s_ofl | t_ofl


def within_mask(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    pbc=(True, True, True),
    tgt_cap: Optional[int] = None,
    max_tgt_cells: Optional[int] = None,
    ghost: bool = False,
):
    """Boolean mask over ``src_idx``: has >= 1 partner in ``tgt_idx`` within
    cutoff (min-image). One frame; vmap over a leading frame axis for windows.

    Cell-blocked algorithm: both sets are bucketed into (n_cells, cap) planes,
    and each of the 27 offsets is one dense (n_cells, cap_src, cap_tgt)
    distance block — structured row gathers + elementwise math only. With
    ``max_tgt_cells`` set (static), the sparse-target variant iterates only
    the occupied target cells (the right choice when the target selection is
    much smaller than the system).

    Two per-pair math regimes:

    * ``corrections is None`` (orthorhombic / no triclinic candidates): the
      periodic image is resolved per (cell, offset) as a broadcast lattice
      shift (:func:`_cells_shift`) — ~9 ops/pair instead of the ~45-op
      inverse-transform/round/forward-transform min-image chain, and padding
      can be a huge-coordinate sentinel (no rounding to pull it back to d=0),
      which drops the validity planes and their scatters. Offsets that alias
      to the same cell on tiny grids are *distinct images* here and are all
      evaluated (no dedupe), matching host min-image results.
    * triclinic (``corrections`` given): the proven per-pair min-image path
      with the correction-candidate sweep (periodic_box.rs:286-318).

    ``src_idx=None`` means "all atoms" and skips the per-component source
    gathers entirely (they are identity gathers in that case, ~3 wasted
    (n,)-gathers per frame in the hot path); the mask then covers every atom.

    Returns (mask (len(src_idx),), overflow bool). ``dims``/``cap``/``pbc``
    static; ``cap`` bounds src cells, ``tgt_cap`` (default cap) target cells.

    Contract notes:

    * When ``overflow`` is True the mask is UNDEFINED (clipped ranks make
      duplicate scatter slots, which XLA leaves unspecified) — callers must
      check the flag and retry at higher capacity (see
      tasks.trajectory.run_with_overflow_retry), never consume the mask.
    * ``corrections is None`` is a caller assertion that the box is
      orthorhombic (or that ±1-cell lattice images provably suffice). For a
      skewed box pass ``box.padded_corrections()`` — passing None silently
      selects the shift fast path, which can miss hits that need a
      correction candidate (periodic_box.rs:286-318).
    """
    tgt_cap = tgt_cap or cap
    n_cells = dims[0] * dims[1] * dims[2]
    # Per-component 1-D gathers instead of one (n, 3) row gather (slow to
    # compile, and a real gather for what is often the identity).
    x, y, z = coords[..., 0], coords[..., 1], coords[..., 2]
    src = coords if src_idx is None else jnp.stack(
        [x[src_idx], y[src_idx], z[src_idx]], axis=-1
    )
    tgt = jnp.stack([x[tgt_idx], y[tgt_idx], z[tgt_idx]], axis=-1)
    sfx, sfy, sfz = _wrap_frac(src, inv)
    tfx, tfy, tfz = _wrap_frac(tgt, inv)
    sx, sy, sz = _apply3(box, sfx, sfy, sfz)
    tx, ty, tz = _apply3(box, tfx, tfy, tfz)

    scx, scy, scz = _cell3(sfx, sfy, sfz, dims)
    sflat = (scx * dims[1] + scy) * dims[2] + scz
    tcx, tcy, tcz = _cell3(tfx, tfy, tfz, dims)
    tflat = (tcx * dims[1] + tcy) * dims[2] + tcz

    c2 = jnp.asarray(cutoff, src.dtype) ** 2
    offs_j = jnp.asarray(_OFFSETS)

    if corrections is None and ghost:
        return _within_ghost(
            sx, sy, sz, sflat, tx, ty, tz, tcx, tcy, tcz,
            cutoff, box, dims, cap, tgt_cap, pbc, src.shape[0],
        )

    if corrections is None:
        # Shift fast path: sentinel padding (opposite signs so pad-vs-pad
        # never differences to zero), no validity planes.
        big_s = jnp.asarray(-1e17, src.dtype)
        big_t = jnp.asarray(1e17, src.dtype)
        (sxb, syb, szb), s_slot, s_order, s_ofl = _blocked_planes(
            [sx, sy, sz], sflat, n_cells, cap, [big_s, big_s, big_s]
        )
        (txb, tyb, tzb), _, _, t_ofl = _blocked_planes(
            [tx, ty, tz], tflat, n_cells, tgt_cap, [big_t, big_t, big_t]
        )

        if max_tgt_cells is not None:
            sorted_t = jnp.sort(tflat)
            is_first = jnp.concatenate(
                [jnp.ones(1, bool), sorted_t[1:] != sorted_t[:-1]]
            )
            (occ_pos,) = jnp.nonzero(is_first, size=max_tgt_cells, fill_value=-1)
            occ_ofl = jnp.sum(is_first) > max_tgt_cells
            occ_valid = occ_pos >= 0
            occ = jnp.where(occ_valid, sorted_t[jnp.maximum(occ_pos, 0)], 0)
            ocx = occ // (dims[1] * dims[2])
            ocy = (occ // dims[2]) % dims[1]
            ocz = occ % dims[2]
            # Unoccupied padding rows gather cell 0's real targets; force
            # them to the sentinel so they cannot hit.
            pad = ~occ_valid[:, None, None]
            otx = jnp.where(pad, big_t, txb[occ][:, None, :])  # (T, 1, tcap)
            oty = jnp.where(pad, big_t, tyb[occ][:, None, :])
            otz = jnp.where(pad, big_t, tzb[occ][:, None, :])

            # One offset per loop iteration. Grouped (9/27 offsets per
            # iteration), T-minor transposed and ghost-padded forms were no
            # faster on the accelerator this was first tuned for, where the
            # stencil was bound by the (T,) row-gather rate; this form has
            # the fastest compile. Not yet compared on a GPU.
            def body(o, hit_blocks):
                off = offs_j[o]
                scells, (shx, shy, shz), ok = _cells_shift(
                    ocx, ocy, ocz, off, dims, pbc, box, src.dtype
                )
                # Source image near these targets = stored + shift.
                dx = otx - (sxb[scells][:, :, None] + shx[:, None, None])
                dy = oty - (syb[scells][:, :, None] + shy[:, None, None])
                dz = otz - (szb[scells][:, :, None] + shz[:, None, None])
                d2 = dx * dx + dy * dy + dz * dz
                hit = jnp.any(d2 <= c2, axis=2) & ok[:, None]  # (T, cap)
                return hit_blocks.at[scells].max(hit)

            hit_blocks = jax.lax.fori_loop(
                0, 27, body, jnp.zeros((n_cells, cap), dtype=bool)
            )
            return (
                _unsort_mask(hit_blocks, s_slot, s_order, src.shape[0]),
                s_ofl | t_ofl | occ_ofl,
            )

        ids = jnp.arange(n_cells, dtype=sflat.dtype)
        gcx = ids // (dims[1] * dims[2])
        gcy = (ids // dims[2]) % dims[1]
        gcz = ids % dims[2]

        def body(o, hit_blocks):
            off = offs_j[o]
            cells, (shx, shy, shz), ok = _cells_shift(
                gcx, gcy, gcz, off, dims, pbc, box, src.dtype
            )
            # Target image near these sources = stored + shift.
            dx = txb[cells][:, None, :] + shx[:, None, None] - sxb[:, :, None]
            dy = tyb[cells][:, None, :] + shy[:, None, None] - syb[:, :, None]
            dz = tzb[cells][:, None, :] + shz[:, None, None] - szb[:, :, None]
            d2 = dx * dx + dy * dy + dz * dz
            hit = jnp.any(d2 <= c2, axis=2) & ok[:, None]  # (n_cells, cap)
            return hit_blocks | hit

        hit_blocks = jax.lax.fori_loop(
            0, 27, body, jnp.zeros((n_cells, cap), dtype=bool)
        )
        return (
            _unsort_mask(hit_blocks, s_slot, s_order, src.shape[0]),
            s_ofl | t_ofl,
        )

    # Triclinic (min-image + corrections) path.
    # Pad slots carry an explicit validity plane — a coordinate sentinel
    # (like 1e30) would survive min-image rounding as d=0 and false-hit.
    zero = jnp.asarray(0.0, src.dtype)
    ones_s = jnp.ones(src.shape[0], dtype=bool)
    ones_t = jnp.ones(tgt.shape[0], dtype=bool)
    (sxb, syb, szb, svalid), s_slot, s_order, s_ofl = _blocked_planes(
        [sx, sy, sz, ones_s], sflat, n_cells, cap, [zero, zero, zero, False]
    )
    (txb, tyb, tzb, tvalid), _, _, t_ofl = _blocked_planes(
        [tx, ty, tz, ones_t], tflat, n_cells, tgt_cap, [zero, zero, zero, False]
    )

    nb_ids = jnp.asarray(_cell_neighbor_ids(dims, pbc))  # (n_cells, 27)

    if max_tgt_cells is not None:
        # Sparse-target path: iterate the occupied *target* cells only and
        # scatter hits into the neighboring source-cell blocks. When the
        # target selection covers a small fraction of the grid (ligand,
        # protein core), this skips the ~90% of cell rows whose whole
        # neighborhood is empty. ``max_tgt_cells`` is the static capacity for
        # the occupied-cell list (overflow flag covers the excess).
        sorted_t = jnp.sort(tflat)
        is_first = jnp.concatenate(
            [jnp.ones(1, bool), sorted_t[1:] != sorted_t[:-1]]
        )
        (occ_pos,) = jnp.nonzero(is_first, size=max_tgt_cells, fill_value=-1)
        occ_ofl = jnp.sum(is_first) > max_tgt_cells
        occ_valid = occ_pos >= 0
        occ = jnp.where(occ_valid, sorted_t[jnp.maximum(occ_pos, 0)], 0)
        # 3d coords of occupied cells
        ocx = occ // (dims[1] * dims[2])
        ocy = (occ // dims[2]) % dims[1]
        ocz = occ % dims[2]
        otx = txb[occ][:, None, :]  # (T, 1, tgt_cap)
        oty = tyb[occ][:, None, :]
        otz = tzb[occ][:, None, :]
        otv = tvalid[occ][:, None, :] & occ_valid[:, None, None]

        def body(o, hit_blocks):
            off = jnp.asarray(_OFFSETS)[o]
            ok = occ_valid
            cs = []
            for comp, d, per in ((ocx, 0, pbc[0]), (ocy, 1, pbc[1]), (ocz, 2, pbc[2])):
                c = comp + off[d]
                if per:
                    c = jnp.mod(c, dims[d])
                else:
                    ok = ok & (c >= 0) & (c < dims[d])
                    c = jnp.clip(c, 0, dims[d] - 1)
                cs.append(c)
            scells = (cs[0] * dims[1] + cs[1]) * dims[2] + cs[2]  # (T,)
            nsx = sxb[scells][:, :, None]  # (T, cap, 1)
            nsy = syb[scells][:, :, None]
            nsz = szb[scells][:, :, None]
            dx = otx - nsx
            dy = oty - nsy
            dz = otz - nsz
            d2 = _min_image_d2(dx, dy, dz, box, inv, corrections, pbc)
            hit = jnp.any(otv & (d2 <= c2), axis=2) & ok[:, None]  # (T, cap)
            return hit_blocks.at[scells].max(hit)

        hit_blocks = jax.lax.fori_loop(
            0, 27, body, jnp.zeros((n_cells, cap), dtype=bool)
        )
        hit_blocks = hit_blocks & svalid
        return (
            _unsort_mask(hit_blocks, s_slot, s_order, src.shape[0]),
            s_ofl | t_ofl | occ_ofl,
        )

    def body(o, hit_blocks):
        cells = jax.lax.dynamic_index_in_dim(nb_ids, o, axis=1, keepdims=False)
        ok = (cells >= 0)[:, None, None]
        safe = jnp.maximum(cells, 0)
        ntx = txb[safe][:, None, :]  # (n_cells, 1, tgt_cap) row gather
        nty = tyb[safe][:, None, :]
        ntz = tzb[safe][:, None, :]
        ntv = tvalid[safe][:, None, :]
        dx = ntx - sxb[:, :, None]
        dy = nty - syb[:, :, None]
        dz = ntz - szb[:, :, None]
        d2 = _min_image_d2(dx, dy, dz, box, inv, corrections, pbc)
        hit = jnp.any(ok & ntv & (d2 <= c2), axis=2)  # (n_cells, cap)
        return hit_blocks | hit

    hit_blocks = jax.lax.fori_loop(
        0, 27, body, jnp.zeros((n_cells, cap), dtype=bool)
    )
    hit_blocks = hit_blocks & svalid
    return (
        _unsort_mask(hit_blocks, s_slot, s_order, src.shape[0]),
        s_ofl | t_ofl,
    )


def contact_pairs_dense(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
):
    """Fixed-capacity contact list via the direct (n_src, n_tgt) distance
    matrix — no cell grid.

    Same contract as :func:`contact_pairs` (inclusive cutoff, global-index
    pairs padded with -1, implementation-defined order), but the candidate
    set is ALL src x tgt pairs. The measured winner when n_src * n_tgt is
    small (< ~2^21): at that scale the grid path's cost is its fixed
    (n_src, 27, cap) hit tables and the nonzero over them — a 4000 x 50
    protein-ligand search carries 7M candidate slots through the grid but
    only 200k through the dense matrix. Cutoff-independent (no dims/caps to
    size), so it also suits searches whose cutoff would make the grid
    degenerate. Reference workload: comparison_small.rs contact lists.
    """
    src = coords[src_idx]
    tgt = coords[tgt_idx]
    sfx, sfy, sfz = _wrap_frac(src, inv)
    tfx, tfy, tfz = _wrap_frac(tgt, inv)
    sx, sy, sz = _apply3(box, sfx, sfy, sfz)
    tx, ty, tz = _apply3(box, tfx, tfy, tfz)
    c2 = jnp.asarray(cutoff, src.dtype) ** 2
    dx = tx[None, :] - sx[:, None]
    dy = ty[None, :] - sy[:, None]
    dz = tz[None, :] - sz[:, None]
    d2 = _min_image_d2(dx, dy, dz, box, inv, corrections, pbc)
    hit = d2 <= c2
    count = jnp.sum(hit)
    (pos,) = jnp.nonzero(hit.reshape(-1), size=max_pairs, fill_value=-1)
    ok = pos >= 0
    safe = jnp.maximum(pos, 0)
    m = tgt_idx.shape[0]
    gi = src_idx[safe // m]
    gj = tgt_idx[safe % m]
    dist = jnp.sqrt(d2.reshape(-1)[safe])
    pairs = jnp.where(
        ok[:, None], jnp.stack([gi, gj], axis=1), jnp.int32(-1)
    ).astype(jnp.int32)
    dist = jnp.where(ok, dist, 0.0)
    return pairs, dist, count, count > max_pairs


def contact_pairs(
    coords,
    src_idx,
    tgt_idx,
    cutoff: float,
    box,
    inv,
    corrections=None,
    dims: tuple[int, int, int] = (1, 1, 1),
    cap: int = 32,
    max_pairs: int = 1 << 16,
    pbc=(True, True, True),
):
    """Fixed-capacity contact list between two selections (one frame).

    Returns (pairs (max_pairs, 2) int32 global indices padded with -1,
    distances (max_pairs,), count, overflow). Pair order is
    implementation-defined; sort before comparing across implementations.
    """
    _, overflow, step, (sx, sy, sz), (tx, ty, tz) = _search_core(
        coords, src_idx, tgt_idx, cutoff, box, inv, corrections, dims, cap, pbc
    )
    n = src_idx.shape[0]

    def body(o, acc):
        hit_acc, mem_acc = acc
        members, h = step(o)
        return (
            jax.lax.dynamic_update_index_in_dim(hit_acc, h, o, axis=1),
            jax.lax.dynamic_update_index_in_dim(mem_acc, members, o, axis=1),
        )

    hit, mem = jax.lax.fori_loop(
        0,
        27,
        body,
        (
            jnp.zeros((n, 27, cap), dtype=bool),
            jnp.full((n, 27, cap), -1, dtype=jnp.int32),
        ),
    )
    count = jnp.sum(hit)
    flat_hit = hit.reshape(-1)
    (pos,) = jnp.nonzero(flat_hit, size=max_pairs, fill_value=-1)
    ok = pos >= 0
    safe = jnp.maximum(pos, 0)
    cap_total = 27 * cap
    si = safe // cap_total
    mj = mem.reshape(-1)[safe]
    gi = src_idx[si]
    gj = tgt_idx[mj]
    dx = tx[mj] - sx[si]
    dy = ty[mj] - sy[si]
    dz = tz[mj] - sz[si]
    d2 = _min_image_d2(dx, dy, dz, box, inv, corrections, pbc)
    dist = jnp.sqrt(d2)
    pairs = jnp.where(
        ok[:, None], jnp.stack([gi, gj], axis=1), jnp.int32(-1)
    ).astype(jnp.int32)
    dist = jnp.where(ok, dist, 0.0)
    return pairs, dist, count, overflow | (count > max_pairs)
