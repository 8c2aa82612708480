"""Exact Lee-Richards SASA on device (batched, fixed-capacity).

The reference's SASA is the exact PowerSasa power diagram
(molar/src/sasa.rs:14-122). Round 1 shipped exact Lee-Richards on host
(ops/sasa_host.py) and approximate Shrake-Rupley on device; this module is
the exact device formulation: the SAME Lee-Richards slicing as the host
ground truth, re-expressed as dense batched tensor math so it jits, vmaps
over frames, and runs as elementwise math on the device:

* per atom: ``n_slices`` z-slabs relative to its own center (identical slab
  placement to the host, so parity is pure float error);
* per (atom, slice, neighbor): the neighbor's covering angular interval on
  the slice circle, wrap-split into two ``[lo, hi]`` slots in [-pi, pi];
* exact union length of the 2K intervals via lo-sort + running-cummax
  sweep: ``sum_i max(0, hi_i - max(lo_i, cummax_{j<i} hi_j))`` — the
  interval-union sweep is an associative scan, no data-dependent loops;
* exposed arc * R * dz accumulates the area (Lee-Richards band area).

Neighbor lists are fixed-capacity ``(N, K)`` index arrays (pad -1). For
trajectories, :func:`neighbor_lists` builds them host-side with a skin
margin (Verlet list): the list stays valid while no atom moved more than
``skin/2`` from its build position — check with :func:`max_displacement`
on device and rebuild on demand (same fixed-capacity + retry philosophy as
ops/neighbor.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.pbc import PBC_NONE
from . import neighbor_host

DEFAULT_PROBE = 0.14


def neighbor_lists(
    coords: np.ndarray,
    radii: np.ndarray,
    cap: int,
    skin: float = 0.0,
) -> tuple[np.ndarray, bool]:
    """Host-side fixed-capacity neighbor lists for LR-SASA.

    Neighbors = atoms j with ``|xi - xj| < ri + rj + skin`` (the spheres
    whose expanded radii can clip atom i's circles while no atom has moved
    more than skin/2). Returns ((N, cap) int32 padded with -1, overflowed).
    """
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(radii, np.float64)
    n = len(coords)
    out = np.full((n, cap), -1, np.int32)
    if n == 0:
        return out, False
    cut = float(2 * radii.max() + skin)
    pairs, _ = neighbor_host.search_pairs(
        cut, coords.astype(np.float32), np.arange(n), None, None, PBC_NONE
    )
    d = np.linalg.norm(coords[pairs[:, 0]] - coords[pairs[:, 1]], axis=1)
    keep = d < radii[pairs[:, 0]] + radii[pairs[:, 1]] + skin
    kept = pairs[keep]
    # Vectorized fixed-capacity fill: duplicate each pair in both directions,
    # sort by owner, rank within the owner's run (a Python loop over the
    # ~1M pair entries of a dense protein measured seconds per rebuild).
    owners = np.concatenate([kept[:, 0], kept[:, 1]])
    others = np.concatenate([kept[:, 1], kept[:, 0]]).astype(np.int32)
    order = np.argsort(owners, kind="stable")
    owners_s = owners[order]
    others_s = others[order]
    starts = np.searchsorted(owners_s, np.arange(n))
    rank = np.arange(len(owners_s)) - starts[owners_s]
    overflow = bool(np.any(rank >= cap))
    ok = rank < cap
    out[owners_s[ok], rank[ok]] = others_s[ok]
    return out, overflow


def max_displacement(coords, build_coords):
    """Max atom displacement since the neighbor list build (device scalar);
    the list is valid while this is < skin/2."""
    d = coords - build_coords
    return jnp.sqrt(jnp.max(jnp.sum(d * d, axis=-1)))


def sasa(
    coords,
    radii,
    nbr,
    n_slices: int = 64,
    block: int = 2048,
    sort_axis0: bool = False,
):
    """Per-atom exact Lee-Richards SASA (device). One frame.

    ``coords`` (N,3), ``radii`` (N,) = vdw + probe, ``nbr`` (N,K) padded -1.
    ``n_slices``/``block`` static. Memory peaks at (block, S, 2K) — lower
    ``block`` for very large K. Matches ops/sasa_host.sasa with the same
    ``n_slices`` to float32 accuracy.

    ``sort_axis0``: run the interval-union sort/scan along the MAJOR axis
    (intervals transposed to axis 0) instead of the minor axis. Which
    layout sorts faster depends on the backend; not yet measured on a GPU.
    """
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii, coords.dtype)
    n = coords.shape[0]
    k = nbr.shape[1]
    s = n_slices
    pi = jnp.asarray(np.pi, coords.dtype)

    pad = (-n) % block
    coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
    radii_p = jnp.pad(radii, (0, pad), constant_values=1.0)
    nbr_p = jnp.pad(nbr, ((0, pad), (0, 0)), constant_values=-1)

    def one_block(args):
        ci, ri, nb = args  # (B,3), (B,), (B,K)
        valid_n = nb >= 0
        nbs = jnp.maximum(nb, 0)
        xj = coords_p[:, 0][nbs.reshape(-1)].reshape(nbs.shape)
        yj = coords_p[:, 1][nbs.reshape(-1)].reshape(nbs.shape)
        zj = coords_p[:, 2][nbs.reshape(-1)].reshape(nbs.shape)
        rj = radii_p[nbs.reshape(-1)].reshape(nbs.shape)
        dx = xj - ci[:, 0:1]  # (B,K)
        dy = yj - ci[:, 1:2]
        dxy = jnp.sqrt(dx * dx + dy * dy)
        theta = jnp.arctan2(dy, dx)  # (B,K)

        dz = 2 * ri / s  # (B,)
        ks = jnp.arange(s, dtype=coords.dtype) + 0.5
        zrel = -ri[:, None] + dz[:, None] * ks[None, :]  # (B,S) z - zi
        rk2 = ri[:, None] ** 2 - zrel**2
        rk = jnp.sqrt(jnp.maximum(rk2, 0.0))  # (B,S)
        slice_live = rk2 > 0

        # neighbor circle radius in each slab: (B,S,K)
        dzj = (ci[:, 2:3, None] + zrel[:, :, None]) - zj[:, None, :]
        cj2 = rj[:, None, :] ** 2 - dzj * dzj
        cj = jnp.sqrt(jnp.maximum(cj2, 0.0))
        act = valid_n[:, None, :] & (cj2 > 0) & slice_live[:, :, None]

        d3 = dxy[:, None, :]
        r3 = rk[:, :, None]
        no_ovl = d3 >= r3 + cj
        fully = (d3 + r3 <= cj) & act
        inside = d3 + cj <= r3
        covers = act & ~no_ovl & ~fully & ~inside

        denom = jnp.where(covers, 2 * d3 * r3, 1.0)
        cos_half = jnp.clip((d3 * d3 + r3 * r3 - cj * cj) / denom, -1.0, 1.0)
        half = jnp.arccos(cos_half)
        lo = theta[:, None, :] - half
        hi = theta[:, None, :] + half
        # Wrap-split into two interval slots per neighbor. Empty slots get
        # the negative-length sentinel [pi, -pi] (zero contribution in the
        # sweep, never raises the running cummax). A neighbor wraps on at
        # most one side, so the two wrap pieces share one slot via min/max.
        lo1 = jnp.where(covers, jnp.maximum(lo, -pi), pi)
        hi1 = jnp.where(covers, jnp.minimum(hi, pi), -pi)
        lo_wrap = covers & (lo < -pi)
        hi_wrap = covers & (hi > pi)
        lo2 = jnp.where(lo_wrap, lo + 2 * pi, pi)
        hi2 = jnp.where(lo_wrap, pi, -pi)
        lo3 = jnp.where(hi_wrap, -pi, pi)
        hi3 = jnp.where(hi_wrap, hi - 2 * pi, -pi)
        los = jnp.concatenate([lo1, jnp.minimum(lo2, lo3)], axis=2)
        his = jnp.concatenate([hi1, jnp.maximum(hi2, hi3)], axis=2)

        # union sweep: sort by lo, running cummax of hi. Key-value lax.sort
        # (not argsort + take_along_axis: the two (B, S, 2K) computed-index
        # gathers were both slow and implicated in a device worker crash at
        # K ~ 300 on the 50k-atom workload on the previous accelerator).
        if sort_axis0:
            lo_t = jnp.transpose(los, (2, 0, 1))  # (2K, B, S)
            hi_t = jnp.transpose(his, (2, 0, 1))
            lo_s, hi_s = jax.lax.sort((lo_t, hi_t), dimension=0, num_keys=1)
            cum = jax.lax.associative_scan(jnp.maximum, hi_s, axis=0)
            prev = jnp.concatenate(
                [jnp.full_like(cum[:1], -pi), cum[:-1]], axis=0
            )
            contrib = jnp.maximum(0.0, hi_s - jnp.maximum(lo_s, prev))
            union = jnp.sum(contrib, axis=0)  # (B,S)
        else:
            lo_s, hi_s = jax.lax.sort((los, his), dimension=2, num_keys=1)
            cum = jax.lax.associative_scan(jnp.maximum, hi_s, axis=2)
            prev = jnp.concatenate(
                [jnp.full(cum[:, :, :1].shape, -pi), cum[:, :, :-1]], axis=2
            )
            contrib = jnp.maximum(0.0, hi_s - jnp.maximum(lo_s, prev))
            union = jnp.sum(contrib, axis=2)  # (B,S)

        any_full = jnp.any(fully, axis=2)
        exposed = jnp.where(
            slice_live & ~any_full, 2 * pi - union, 0.0
        )
        return jnp.sum(exposed, axis=1) * ri * dz  # (B,)

    blocks = jax.lax.map(
        one_block,
        (
            coords_p.reshape(-1, block, 3),
            radii_p.reshape(-1, block),
            nbr_p.reshape(-1, block, k),
        ),
    )
    return blocks.reshape(-1)[:n]


def neighbor_lists_device(
    coords,
    radii,
    extents,
    dims: tuple[int, int, int],
    cell_cap: int,
    k_cap: int,
    max_pairs: int,
    skin: float = 0.0,
):
    """Fixed-capacity LR-SASA neighbor lists built ON DEVICE (one frame).

    The host :func:`neighbor_lists` costs seconds per rebuild at protein
    density (it was the round-2 workload wall: ~7/8 windows rebuilt), so
    trajectories rebuild HERE instead — cell-blocked coordinate planes,
    a 27-offset stencil of row gathers, the ``|xi-xj| < ri+rj+skin`` test,
    and a direct per-row rank+scatter into the (N, k_cap) rows (no global
    pair list, no big sort; ``max_pairs`` is accepted for API stability
    but unused). With ``skin=0`` the lists are exact for the frame they
    are built from — and a ~3x smaller K than the round-2 Verlet skin=0.3
    lists, which is where the SASA kernel's union-sort spends its time.

    Membership at the |xi-xj| = ri+rj boundary is f32-jittery, but a
    touching sphere clips a measure-zero arc, so the SASA result is
    unaffected (the kernel re-checks actual slab overlap).

    ``coords`` must lie inside ``[0, extents)`` (non-PBC grid; the cell
    binning wraps out-of-box points). Returns ((N, k_cap) int32 padded -1,
    overflow bool) — overflow covers cell, pair, and row capacity.
    """
    from .neighbor import _OFFSETS, _blocked_planes

    coords = jnp.asarray(coords)
    n = coords.shape[0]
    radii = jnp.asarray(radii, coords.dtype)
    ext = np.asarray(extents, np.float64)
    nx, ny, nz = dims
    n_cells = nx * ny * nz

    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    # In-box fractional cells (non-PBC): clip handles edge/out-of-box atoms
    # conservatively (they land in border cells; correctness only needs the
    # in-box assumption of the docstring).
    fx = jnp.clip(x / ext[0], 0.0, 1.0 - 1e-7)
    fy = jnp.clip(y / ext[1], 0.0, 1.0 - 1e-7)
    fz = jnp.clip(z / ext[2], 0.0, 1.0 - 1e-7)
    cx = jnp.minimum((fx * nx).astype(jnp.int32), nx - 1)
    cy = jnp.minimum((fy * ny).astype(jnp.int32), ny - 1)
    cz = jnp.minimum((fz * nz).astype(jnp.int32), nz - 1)
    flat = (cx * ny + cy) * nz + cz

    # Cell-blocked coordinate/radius/id planes: per-offset candidate data
    # then comes from ROW gathers (structured, ~ns/row) instead of 24M
    # per-element gathers (measured ~10x slower in the first formulation).
    big = jnp.asarray(1e17, coords.dtype)
    rows_f = jnp.arange(n, dtype=jnp.int32)
    (xb, yb, zb, rb, ib), _slot, _order, t_ofl = _blocked_planes(
        [x, y, z, radii, rows_f], flat, n_cells, cell_cap,
        [big, big, big, jnp.asarray(0.0, coords.dtype), np.int32(-1)],
    )

    offs = jnp.asarray(_OFFSETS)
    dump = n * k_cap  # one extra slot swallows every non-hit lane

    def body(o, carry):
        count, out = carry
        off = offs[o]
        ncx = cx + off[0]
        ncy = cy + off[1]
        ncz = cz + off[2]
        ok = (
            (ncx >= 0) & (ncx < nx)
            & (ncy >= 0) & (ncy < ny)
            & (ncz >= 0) & (ncz < nz)
        )
        cells = jnp.where(ok, (ncx * ny + ncy) * nz + ncz, 0)
        xnb = xb[cells]  # (n, cell_cap) row gathers
        ynb = yb[cells]
        znb = zb[cells]
        rnb = rb[cells]
        inb = ib[cells]
        dx = xnb - x[:, None]
        dy = ynb - y[:, None]
        dz = znb - z[:, None]
        rr = rnb + radii[:, None] + skin
        d2 = dx * dx + dy * dy + dz * dz
        hit = (
            ok[:, None]
            & (inb >= 0)
            & (d2 < rr * rr)
            & (inb != rows_f[:, None])
        )
        # Exclusive per-row rank continuing across offsets (dtypes pinned to
        # int32 so the fori carry is stable under the x64 build).
        hit32 = hit.astype(jnp.int32)
        rank = count[:, None] + jnp.cumsum(hit32, axis=1, dtype=jnp.int32) - hit32
        slot = jnp.where(
            hit & (rank < k_cap), rows_f[:, None] * k_cap + rank, dump
        )
        out = out.at[slot.reshape(-1)].set(
            jnp.where(hit, inb, -1).astype(jnp.int32).reshape(-1)
        )
        count = count + jnp.sum(hit32, axis=1, dtype=jnp.int32)
        return count, out

    count0 = jnp.zeros(n, jnp.int32)
    out0 = jnp.full((n * k_cap + 1,), -1, jnp.int32)
    count, out = jax.lax.fori_loop(0, 27, body, (count0, out0))
    k_ofl = jnp.any(count > k_cap)
    return out[: n * k_cap].reshape(n, k_cap), t_ofl | k_ofl


def sasa_window(
    coords,
    radii,
    extents,
    dims: tuple[int, int, int],
    cell_cap: int,
    k_cap: int,
    max_pairs: int,
    n_slices: int = 32,
    block: int = 2048,
):
    """Exact LR-SASA for a (B, N, 3) window: device list build + evaluation
    per frame inside ONE scanned program — no host rebuilds, no drift
    checks, no per-window syncs. Returns (areas (B, N), overflow (B,));
    on overflow retry with larger caps (fixed-capacity + retry contract)."""

    def per_frame(carry, c):
        nbr, ofl = neighbor_lists_device(
            c, radii, extents, dims, cell_cap, k_cap, max_pairs
        )
        areas = sasa(c, radii, nbr, n_slices=n_slices, block=block)
        return carry, (areas, ofl)

    return jax.lax.scan(per_frame, 0, coords)[1]


def band_neighbor_lists(
    coords: np.ndarray,
    radii: np.ndarray,
    nbr: np.ndarray,
    n_slices: int,
    n_bands: int = 8,
    skin: float = 0.3,
    w_round: int = 32,
):
    """Z-banded neighbor windows for :func:`sasa_banded` (host, at build).

    Sorts each atom's neighbor list by dz = z_j - z_i and finds, for each of
    ``n_bands`` groups of consecutive z-slices, the contiguous window of
    z-sorted neighbors that can possibly clip any slice of that band —
    inclusive with ``rmax + skin`` slack, so extra neighbors are possible
    (harmless: a non-covering neighbor contributes nothing) but a covering
    neighbor can never be missed while drift stays < skin/2.

    Returns (nbz (N, K+W) z-sorted ids padded -1, starts (N, G) int32,
    W, G). The per-band interval-union then sorts 2W instead of 2K slots.
    """
    coords = np.asarray(coords, np.float64)
    radii = np.asarray(radii, np.float64)
    n, k = nbr.shape
    g = n_bands
    valid = nbr >= 0
    nbs = np.maximum(nbr, 0)
    dz = np.where(valid, coords[:, 2][nbs] - coords[:, 2][:, None], np.inf)
    ordz = np.argsort(dz, axis=1)
    nbz = np.take_along_axis(np.where(valid, nbr, -1), ordz, axis=1)
    dzs = np.take_along_axis(dz, ordz, axis=1)  # sorted, inf-padded
    rmax = float(radii.max())
    ri = radii[:, None]
    gs = np.arange(g)[None, :]
    band_h = 2 * ri / g
    lo = -ri + gs * band_h - (rmax + skin)
    hi = -ri + (gs + 1) * band_h + (rmax + skin)
    starts = (dzs[:, None, :] < lo[:, :, None]).sum(2).astype(np.int32)
    ends = (dzs[:, None, :] <= hi[:, :, None]).sum(2).astype(np.int32)
    w = int((ends - starts).max()) if n else 1
    w = max((w + w_round - 1) // w_round * w_round, w_round)
    nbz_pad = np.concatenate(
        [nbz, np.full((n, w), -1, nbz.dtype)], axis=1
    ).astype(np.int32)
    return nbz_pad, starts, w, g


def sasa_banded(
    coords,
    radii,
    nbz,
    starts,
    w: int,
    g: int,
    n_slices: int = 64,
    block: int = 2048,
    sort_axis0: bool = False,
):
    """Exact Lee-Richards SASA with z-banded neighbor windows.

    Same math and slab placement as :func:`sasa` (bit-comparable results up
    to float summation order), but each group of ``n_slices/g`` consecutive
    slices only considers its precomputed window of ``w`` z-sorted neighbors
    (:func:`band_neighbor_lists`) — the union sort runs at 2w instead of 2K
    slots, the dominant cost at protein densities (K ~ 330, w ~ K/2).
    """
    coords = jnp.asarray(coords)
    radii = jnp.asarray(radii, coords.dtype)
    n = coords.shape[0]
    s = n_slices
    assert s % g == 0, "n_slices must divide into n_bands"
    sg = s // g
    pi = jnp.asarray(np.pi, coords.dtype)

    pad = (-n) % block
    coords_p = jnp.pad(coords, ((0, pad), (0, 0)))
    radii_p = jnp.pad(radii, (0, pad), constant_values=1.0)
    nbz_p = jnp.pad(nbz, ((0, pad), (0, 0)), constant_values=-1)
    starts_p = jnp.pad(starts, ((0, pad), (0, 0)))

    def one_block(args):
        ci, ri, nbb, stb = args  # (B,3), (B,), (B,K+W), (B,G)
        b = ci.shape[0]
        dz_full = 2 * ri / s  # (B,)

        def band(gi, acc):
            st = jax.lax.dynamic_index_in_dim(
                stb, gi, axis=1, keepdims=False
            )  # (B,)
            win = st[:, None] + jnp.arange(w, dtype=st.dtype)[None, :]
            nb = jnp.take_along_axis(nbb, win, axis=1)  # (B,W)
            valid_n = nb >= 0
            nbs = jnp.maximum(nb, 0)
            xj = coords_p[:, 0][nbs.reshape(-1)].reshape(nbs.shape)
            yj = coords_p[:, 1][nbs.reshape(-1)].reshape(nbs.shape)
            zj = coords_p[:, 2][nbs.reshape(-1)].reshape(nbs.shape)
            rj = radii_p[nbs.reshape(-1)].reshape(nbs.shape)
            dx = xj - ci[:, 0:1]
            dy = yj - ci[:, 1:2]
            dxy = jnp.sqrt(dx * dx + dy * dy)
            theta = jnp.arctan2(dy, dx)

            ks = (
                gi.astype(coords.dtype) * sg
                + jnp.arange(sg, dtype=coords.dtype)
                + 0.5
            )
            zrel = -ri[:, None] + dz_full[:, None] * ks[None, :]  # (B,Sg)
            rk2 = ri[:, None] ** 2 - zrel**2
            rk = jnp.sqrt(jnp.maximum(rk2, 0.0))
            slice_live = rk2 > 0

            dzj = (ci[:, 2:3, None] + zrel[:, :, None]) - zj[:, None, :]
            cj2 = rj[:, None, :] ** 2 - dzj * dzj
            cj = jnp.sqrt(jnp.maximum(cj2, 0.0))
            act = valid_n[:, None, :] & (cj2 > 0) & slice_live[:, :, None]

            d3 = dxy[:, None, :]
            r3 = rk[:, :, None]
            no_ovl = d3 >= r3 + cj
            fully = (d3 + r3 <= cj) & act
            inside = d3 + cj <= r3
            covers = act & ~no_ovl & ~fully & ~inside

            denom = jnp.where(covers, 2 * d3 * r3, 1.0)
            cos_half = jnp.clip(
                (d3 * d3 + r3 * r3 - cj * cj) / denom, -1.0, 1.0
            )
            half = jnp.arccos(cos_half)
            lo = theta[:, None, :] - half
            hi = theta[:, None, :] + half
            lo1 = jnp.where(covers, jnp.maximum(lo, -pi), pi)
            hi1 = jnp.where(covers, jnp.minimum(hi, pi), -pi)
            lo_wrap = covers & (lo < -pi)
            hi_wrap = covers & (hi > pi)
            lo2 = jnp.where(lo_wrap, lo + 2 * pi, pi)
            hi2 = jnp.where(lo_wrap, pi, -pi)
            lo3 = jnp.where(hi_wrap, -pi, pi)
            hi3 = jnp.where(hi_wrap, hi - 2 * pi, -pi)
            los = jnp.concatenate([lo1, jnp.minimum(lo2, lo3)], axis=2)
            his = jnp.concatenate([hi1, jnp.maximum(hi2, hi3)], axis=2)

            if sort_axis0:
                lo_t = jnp.transpose(los, (2, 0, 1))
                hi_t = jnp.transpose(his, (2, 0, 1))
                lo_s, hi_s = jax.lax.sort(
                    (lo_t, hi_t), dimension=0, num_keys=1
                )
                cum = jax.lax.associative_scan(jnp.maximum, hi_s, axis=0)
                prev = jnp.concatenate(
                    [jnp.full_like(cum[:1], -pi), cum[:-1]], axis=0
                )
                contrib = jnp.maximum(0.0, hi_s - jnp.maximum(lo_s, prev))
                union = jnp.sum(contrib, axis=0)
            else:
                lo_s, hi_s = jax.lax.sort((los, his), dimension=2, num_keys=1)
                cum = jax.lax.associative_scan(jnp.maximum, hi_s, axis=2)
                prev = jnp.concatenate(
                    [jnp.full(cum[:, :, :1].shape, -pi), cum[:, :, :-1]],
                    axis=2,
                )
                contrib = jnp.maximum(0.0, hi_s - jnp.maximum(lo_s, prev))
                union = jnp.sum(contrib, axis=2)

            any_full = jnp.any(fully, axis=2)
            exposed = jnp.where(slice_live & ~any_full, 2 * pi - union, 0.0)
            return acc + jnp.sum(exposed, axis=1)

        arcs = jax.lax.fori_loop(0, g, band, jnp.zeros(b, coords.dtype))
        return arcs * ri * dz_full

    blocks = jax.lax.map(
        one_block,
        (
            coords_p.reshape(-1, block, 3),
            radii_p.reshape(-1, block),
            nbz_p.reshape(-1, block, nbz_p.shape[1]),
            starts_p.reshape(-1, block, g),
        ),
    )
    return blocks.reshape(-1)[:n]


class SasaSeries:
    """Reusable exact-SASA evaluator for trajectories (device).

    The reference PowerSasa keeps its power diagram alive and ``update``-s it
    per frame (molar/src/sasa.rs:52-121); the device analog keeps a
    fixed-capacity Verlet neighbor list alive and rebuilds it only when any
    atom drifted more than skin/2 from its build position. ``update(coords)``
    returns the exact per-atom areas for the new coordinates.

    >>> ss = SasaSeries(coords0, vdw, probe=0.14)
    >>> areas_t = [np.asarray(ss.update(c)) for c in frames]

    Passing ``extents=`` (box extents, coords in [0, ext)) — or ``box=``
    with an orthorhombic box, which derives them — selects DEVICE mode:
    skin=0 fixed-capacity lists rebuilt on device inside every evaluate
    (no drift checks or host rebuild stalls; the round-3 measured win).
    """

    def __init__(
        self,
        coords,
        vdw,
        probe: float = DEFAULT_PROBE,
        skin: float = 0.2,
        n_slices: int = 64,
        cap: int = 96,
        block: int = 2048,
        extents=None,
        box=None,
    ):
        if extents is None and box is not None:
            # Box known -> device mode by default: derive extents from an
            # orthorhombic box (PeriodicBox or (3,3) matrix, columns = box
            # vectors). Triclinic boxes fall back to host-Verlet mode (the
            # device grid assumes an axis-aligned cell).
            m = np.asarray(getattr(box, "matrix", box), np.float64)
            if np.allclose(m, np.diag(np.diag(m)), atol=1e-9):
                extents = tuple(np.diag(m))
        self.radii_np = np.asarray(vdw, np.float64) + probe
        self.skin = skin
        self.n_slices = n_slices
        self.block = block
        self.cap = cap
        self.rebuilds = 0
        self.extents = extents
        self._radii = jnp.asarray(self.radii_np, jnp.float32)
        if extents is not None:
            # Device mode (``extents`` = box extents, coords in [0, ext)):
            # skin=0 lists rebuilt ON DEVICE inside every evaluate — no
            # drift checks, no host rebuild stalls, ~3x smaller K.
            from .neighbor import estimate_caps, grid_dims

            c0 = np.asarray(coords, np.float64)
            cut = 2 * float(self.radii_np.max())
            self._dims = grid_dims(extents, cut)
            nb0, _ = neighbor_lists(c0, self.radii_np, cap=2048, skin=0.0)
            k0 = int((nb0 >= 0).sum(1).max())
            inv = np.diag(1.0 / np.asarray(extents, np.float64))
            cell0, _, _ = estimate_caps(
                c0, inv, self._dims, margin=1.0, round_to=1
            )
            self._k_cap = (int(k0 * 1.3) + 15) // 16 * 16
            self._cell_cap = (int(cell0 * 1.3) + 7) // 8 * 8
            self._make_device_fn()
            return
        self._build(np.asarray(coords, np.float64))

    def _make_device_fn(self):
        @jax.jit
        def fn(c):
            nbr, ofl = neighbor_lists_device(
                c, self._radii, self.extents, self._dims,
                self._cell_cap, self._k_cap, 0,
            )
            return (
                sasa(c, self._radii, nbr, n_slices=self.n_slices,
                     block=self.block),
                ofl,
            )

        self._device_fn = fn

    def _build(self, coords) -> None:
        while True:
            nbr, overflow = neighbor_lists(
                coords, self.radii_np, cap=self.cap, skin=self.skin
            )
            if not overflow:
                break
            self.cap += max(self.cap // 2, 16)
        self._nbr = jnp.asarray(nbr)
        self._build_coords = jnp.asarray(coords, jnp.float32)
        self._radii = jnp.asarray(self.radii_np, jnp.float32)

    def update(self, coords):
        """Exact per-atom SASA for new coordinates. Host mode reuses the
        Verlet list while it is still valid (drift < skin/2); device mode
        rebuilds fixed-capacity lists on device every call (escalating the
        static caps on overflow)."""
        c = jnp.asarray(coords, jnp.float32)
        if self.extents is not None:
            while True:
                areas, ofl = self._device_fn(c)
                if not bool(ofl):
                    return areas
                self.rebuilds += 1
                self._k_cap = (self._k_cap * 3 // 2 + 15) // 16 * 16
                self._cell_cap = (self._cell_cap * 3 // 2 + 7) // 8 * 8
                self._make_device_fn()
        if float(max_displacement(c, self._build_coords)) >= self.skin / 2:
            self.rebuilds += 1
            self._build(np.asarray(coords, np.float64))
        return sasa(
            c, self._radii, self._nbr, n_slices=self.n_slices, block=self.block
        )

    def areas(self, coords):
        return self.update(coords)
