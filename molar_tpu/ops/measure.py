"""Device (JAX) batched geometric measures.

The device execution model for per-frame analysis (SURVEY §7 / measure.rs
semantics): gather the selection's atoms once per frame window into
``(B, n, 3)`` blocks resident in device memory, then run every frame of the window
through one jitted, vmapped program. All functions here are pure jnp,
broadcast over arbitrary leading batch dims, and keep the reference numerics:

* PBC centers accumulate closest images relative to atom 0 (measure.rs:142-195);
* Kabsch: covariance ``sum m p2 p1^T``, SVD, ``sign(det(U V^T))`` reflection
  fix (measure.rs:613-643);
* inertia eigenvalues ascending, third axis = cross of first two.

Matmul-shaped contractions (covariance, inertia) use
``precision='highest'`` so a reduced-precision default (TF32 on a GPU)
cannot break the 1e-5 fidelity contract; everything else is element-wise
math.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.pbc import mat3_apply

__all__ = [
    "contiguous_segments_dense",
    "dense_segment_sum",
    "dense_segment_com_gyration",
    "center",
    "center_pbc",
    "gyration",
    "inertia_tensor",
    "rmsd",
    "rmsd_mw",
    "kabsch",
    "fit_transform",
    "apply_transform",
    "fit_rmsd",
    "min_image",
]

_HI = jax.lax.Precision.HIGHEST


def inv3x3(m):
    """Closed-form (adjugate) 3x3 inverse, batched over leading dims —
    lets pipelines ship only box matrices and invert on device."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack(
        [
            jnp.stack([A, B, C], axis=-1),
            jnp.stack([D, E, F], axis=-1),
            jnp.stack([G, H, I], axis=-1),
        ],
        axis=-2,
    )
    return adj / det[..., None, None]


def min_image(vec, boxes, invs, corrections=None, pbc=(True, True, True)):
    """Batched minimum-image: ``vec`` (..., 3), ``boxes``/``invs`` broadcastable
    (..., 3, 3) against vec's batch dims; ``corrections`` (..., K, 3) or None.

    ``pbc`` is static. Mirrors core.pbc.shortest_vector but with per-frame
    boxes (matrices batched along leading dims).
    """
    frac = jnp.einsum("...ij,...j->...i", invs, vec, precision=_HI)
    if all(pbc):
        frac = frac - jnp.round(frac)
    elif any(pbc):
        dims = jnp.asarray(pbc)
        frac = jnp.where(dims, frac - jnp.round(frac), frac)
    start = jnp.einsum("...ij,...j->...i", boxes, frac, precision=_HI)
    if corrections is None or not all(pbc):
        return start
    # corrections: (..., K, 3) — candidate shifts; zero rows are no-ops.
    cands = start[..., None, :] + corrections
    n2 = jnp.sum(cands * cands, axis=-1)
    start2 = jnp.sum(start * start, axis=-1)
    best = jnp.argmin(n2, axis=-1)
    cand_best = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    cand_n2 = jnp.take_along_axis(n2, best[..., None], axis=-1)[..., 0]
    return jnp.where((cand_n2 < start2)[..., None], cand_best, start)


def contiguous_segments_dense(segment_ids, weights=None):
    """Static slot-major dense layout for sorted contiguous segment ids.

    Scatter-free segment reduction (the per-residue splits of measure.rs /
    ``Sel.split_*`` always yield sorted contiguous runs): instead of a
    scatter (``segment_sum``, atomics on a GPU) or a per-frame scan,
    pad every run to the longest run length so segment sums become one
    static gather plus a small dense masked reduction with the segment
    axis last. The sums are deterministic, unlike a scatter-add's.

    Returns ``(idx, w, counts)``:

    * ``idx`` — ``(Lmax * nseg,)`` int32 gather indices, slot-major, so a
      gathered ``(..., n)`` array reshapes to ``(..., Lmax, nseg)`` with
      segments on the minor (lane) axis;
    * ``w`` — ``(Lmax, nseg)`` float32 carrying ``weights`` at live slots
      and 0 at padding (padding indices point at the run's last atom, so
      any value is safe there);
    * ``counts`` — per-segment run lengths.

    Exactness: each segment's sum is a <=Lmax-term dense sum, so f32
    error does not grow with n (a cumsum-and-difference formulation loses
    ~3 digits at n=4000 when values share a sign).
    """
    import numpy as np

    seg = np.asarray(segment_ids)
    n = seg.shape[0]
    starts = np.flatnonzero(np.diff(seg, prepend=seg[0] - 1))
    ends = np.append(starts[1:], n)
    counts = (ends - starts).astype(np.int64)
    lmax = int(counts.max())
    slot = np.arange(lmax)[:, None]
    idx = np.minimum(starts[None, :] + slot, ends[None, :] - 1)
    w = (slot < counts[None, :]).astype(np.float32)
    if weights is not None:
        w = w * np.asarray(weights, np.float32)[idx]
    return idx.reshape(-1).astype(np.int32), w, counts


def dense_segment_sum(values, idx, w):
    """Per-segment weighted sums over the last axis, scatter-free.

    ``values`` ``(..., n)`` with ``(idx, w)`` from
    :func:`contiguous_segments_dense` -> ``(..., nseg)``. The gather uses
    static indices (compiles to cheap slices) and the reduction runs over
    the small slot axis with segments on lanes.
    """
    lmax, nseg = w.shape
    g = jnp.take(values, idx, axis=-1)
    g = g.reshape(values.shape[:-1] + (lmax, nseg))
    return jnp.sum(g * w, axis=-2)


def dense_segment_com_gyration(coords, idx, w):
    """Per-segment COM and radius of gyration, scatter-free.

    ``coords`` ``(..., n, 3)`` with ``(idx, w)`` from
    :func:`contiguous_segments_dense` (w carrying masses) ->
    ``(com (..., nseg, 3), gyr (..., nseg))``. One static per-component
    1-D gather each (instead of an ``(n, 3)`` row gather), reductions over
    the small slot axis with segments last.
    """
    lmax, nseg = w.shape
    msum = jnp.sum(w, axis=0)
    coms = []
    g2 = 0.0
    for k in range(3):
        g = jnp.take(coords[..., k], idx, axis=-1)
        g = g.reshape(coords.shape[:-2] + (lmax, nseg))
        ck = jnp.sum(g * w, axis=-2) / msum
        coms.append(ck)
        d = g - ck[..., None, :]
        g2 = g2 + jnp.sum(d * d * w, axis=-2)
    return jnp.stack(coms, axis=-1), jnp.sqrt(g2 / msum)


def center(coords, weights=None):
    """(..., n, 3) -> (..., 3). COM (weights (n,)) or COG (None)."""
    if weights is None:
        return jnp.mean(coords, axis=-2)
    w = weights / jnp.sum(weights)
    return jnp.einsum("n,...ni->...i", w, coords, precision=_HI)


def center_pbc(coords, weights, boxes, invs, corrections=None, pbc=(True, True, True)):
    """PBC-aware center: closest images relative to atom 0, then average.

    ``boxes``/``invs``: (..., 3, 3) batched per frame; coords (..., n, 3)."""
    ref = coords[..., 0:1, :]
    d = coords - ref
    img = ref + min_image(
        d,
        boxes[..., None, :, :],
        invs[..., None, :, :],
        None if corrections is None else corrections[..., None, :, :],
        pbc,
    )
    return center(img, weights)


def gyration(coords, masses, boxes=None, invs=None, corrections=None, pbc=(True, True, True)):
    """Radius of gyration (..., n, 3) -> (...,)."""
    if boxes is None:
        c = center(coords, masses)
        d = coords - c[..., None, :]
    else:
        c = center_pbc(coords, masses, boxes, invs, corrections, pbc)
        d = min_image(
            coords - c[..., None, :],
            boxes[..., None, :, :],
            invs[..., None, :, :],
            None if corrections is None else corrections[..., None, :, :],
            pbc,
        )
    w = masses / jnp.sum(masses)
    return jnp.sqrt(jnp.einsum("n,...n->...", w, jnp.sum(d * d, axis=-1), precision=_HI))


def inertia_tensor(coords, masses, boxes=None, invs=None, corrections=None, pbc=(True, True, True)):
    """(..., 3, 3) inertia tensor about the (PBC) COM + the COM (..., 3)."""
    if boxes is None:
        c = center(coords, masses)
        d = coords - c[..., None, :]
    else:
        c = center_pbc(coords, masses, boxes, invs, corrections, pbc)
        d = min_image(
            coords - c[..., None, :],
            boxes[..., None, :, :],
            invs[..., None, :, :],
            None if corrections is None else corrections[..., None, :, :],
            pbc,
        )
    r2 = jnp.sum(d * d, axis=-1)
    # I = sum m (r^2 δij - xi xj)
    outer = jnp.einsum("...ni,...nj,n->...ij", d, d, masses, precision=_HI)
    tr = jnp.einsum("...n,n->...", r2, masses, precision=_HI)
    eye = jnp.eye(3, dtype=coords.dtype)
    return tr[..., None, None] * eye - outer, c


def inertia(coords, masses, boxes=None, invs=None, corrections=None, pbc=(True, True, True)):
    """(moments ascending, axes columns right-handed, com)."""
    t, c = inertia_tensor(coords, masses, boxes, invs, corrections, pbc)
    vals, vecs = jnp.linalg.eigh(t)
    third = jnp.cross(vecs[..., :, 0], vecs[..., :, 1])
    axes = jnp.stack([vecs[..., :, 0], vecs[..., :, 1], third], axis=-1)
    return vals, axes, c


def rmsd(coords1, coords2):
    """(..., n, 3) x (..., n, 3) -> (...,). Plain (unweighted) RMSD."""
    d = coords1 - coords2
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1), axis=-1))


def rmsd_mw(coords1, coords2, masses):
    w = masses / jnp.sum(masses)
    d = coords1 - coords2
    return jnp.sqrt(jnp.einsum("n,...n->...", w, jnp.sum(d * d, axis=-1), precision=_HI))


def _quat_to_rot(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            jnp.stack(
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                axis=-1,
            ),
            jnp.stack(
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                axis=-1,
            ),
        ],
        axis=-2,
    )
    return r


def kabsch(centered1, centered2, masses, iters: int = 60):
    """Optimal rotation R (..., 3, 3) minimizing sum m |R p1 - p2|^2.

    Inputs are COM-centered (..., n, 3). Solved via Horn's quaternion method:
    the optimal R is the dominant eigenvector of the 4x4 key matrix built
    from the covariance — found with shifted power iteration. This always
    yields a *proper* rotation (the reflection fix of measure.rs:613-643 is
    implicit in maximizing the quadratic form), matches the SVD solution to
    ~1e-6, and — the reason it exists — compiles as straight-line
    arithmetic instead of jnp.linalg.svd's iterative lowering (a library
    call per frame, and slow to compile).
    """
    m = masses / jnp.sum(masses)
    s = jnp.einsum("...ni,...nj,n->...ij", centered2, centered1, m, precision=_HI)
    s00, s01, s02 = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
    s10, s11, s12 = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
    s20, s21, s22 = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
    # Horn's K matrix for R p1 ~ p2 with cov = sum m p2 p1^T.
    k = jnp.stack(
        [
            jnp.stack([s00 + s11 + s22, s21 - s12, s02 - s20, s10 - s01], axis=-1),
            jnp.stack([s21 - s12, s00 - s11 - s22, s01 + s10, s02 + s20], axis=-1),
            jnp.stack([s02 - s20, s01 + s10, s11 - s00 - s22, s12 + s21], axis=-1),
            jnp.stack([s10 - s01, s02 + s20, s12 + s21, s22 - s00 - s11], axis=-1),
        ],
        axis=-2,
    )
    # Gershgorin shift makes the dominant eigenvalue of (K + shift I) the
    # largest in magnitude, so plain power iteration converges to lambda_max.
    shift = jnp.sum(jnp.abs(k), axis=(-2, -1), keepdims=True)
    ks = k + shift * jnp.eye(4, dtype=k.dtype)
    q = jnp.full(k.shape[:-2] + (4,), 0.5, dtype=k.dtype)

    def body(_, q):
        v = jnp.einsum("...ij,...j->...i", ks, q, precision=_HI)
        return v / jnp.linalg.norm(v, axis=-1, keepdims=True)

    q = jax.lax.fori_loop(0, iters, body, q)
    return _quat_to_rot(q)


def fit_transform(coords1, coords2, masses):
    """(R, t) superimposing sel1 onto sel2, mass-weighted by sel1
    (measure.rs:507-522). Batched over leading dims."""
    cm1 = center(coords1, masses)
    cm2 = center(coords2, masses)
    r = kabsch(coords1 - cm1[..., None, :], coords2 - cm2[..., None, :], masses)
    t = cm2 - jnp.einsum("...ij,...j->...i", r, cm1, precision=_HI)
    return r, t


def apply_transform(coords, r, t):
    """(..., n, 3) with affine (..., 3, 3), (..., 3)."""
    return jnp.einsum("...ij,...nj->...ni", r, coords, precision=_HI) + t[..., None, :]


def fit_rmsd(mobile, ref, masses):
    """RMSD of mobile frames to ref after optimal (mass-weighted) fit.

    ``mobile``: (..., n, 3) batched frames; ``ref``: (n, 3). The headline
    per-frame trajectory op (align benchmark, comparison_small.rs:7-28).
    Returns (rmsd (...,), r, t).
    """
    r, t = fit_transform(mobile, jnp.broadcast_to(ref, mobile.shape), masses)
    fitted = apply_transform(mobile, r, t)
    return rmsd_mw(fitted, ref, masses), r, t
