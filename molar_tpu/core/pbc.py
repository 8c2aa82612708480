"""Periodic box: triclinic minimum-image, wrapping, box algebra.

Semantics follow the reference ``PeriodicBox`` (molar/src/periodic_box.rs):

* the 3x3 box matrix stores box vectors in **columns** (a=M[:,0]...), which is the
  transpose of the mdtraj/MDAnalysis row convention (periodic_box.rs:6-13);
* minimum image = per-periodic-dim fractional rounding, then (triclinic + full-PBC
  only) try the precomputed lattice-correction candidates and keep the shortest
  (periodic_box.rs:286-318); partial PBC on a triclinic box skips the correction;
* ``from_vectors_angles`` rejects zero lengths and angles < 60 deg
  (periodic_box.rs:188-203);
* ``wrap_point`` reproduces the reference's sign quirk: a negative fractional part
  ``f`` maps through ``1.0 - f`` (periodic_box.rs:409-434). The distance-search
  grid uses the conventional wrap (``1.0 + f``), exposed here as ``wrap_frac``.

Two faces of the same math live here:

* :class:`PeriodicBox` — host-side numpy object, vectorized over point arrays,
  used by IO, selections, and system editing;
* the module-level pure functions (``shortest_vector``, ``wrap_coords``...) —
  dtype-agnostic, jit/vmap-friendly; they take the box as plain arrays
  (``matrix``, ``inv``, ``corrections``) so frames with different boxes batch
  along a leading axis. ``corrections`` has a *static* shape: (0,3) for
  orthorhombic boxes (zero-cost fast path), (26,3) zero-padded for triclinic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..config import FLOAT

__all__ = [
    "PeriodicBox",
    "PbcDims",
    "PBC_FULL",
    "PBC_NONE",
    "PeriodicBoxError",
    "build_tric_corrections",
    "shortest_vector",
    "wrap_coords",
]

N_TRIC_CANDIDATES = 26  # (i,j,k) in {-1,0,1}^3 minus the origin


class PeriodicBoxError(ValueError):
    """Invalid box construction or a PBC op on a missing box."""


@dataclass(frozen=True)
class PbcDims:
    """Which of the three dimensions are periodic (periodic_box.rs:70-128)."""

    x: bool = True
    y: bool = True
    z: bool = True

    @staticmethod
    def from_str(s: str) -> "PbcDims":
        """Parse 'yyn' / '110'-style strings used by the selection language."""
        s = s.strip().lower()
        if len(s) != 3 or any(c not in "yn10" for c in s):
            raise PeriodicBoxError(f"invalid pbc dims string: {s!r}")
        on = tuple(c in "y1" for c in s)
        return PbcDims(*on)

    def as_tuple(self) -> tuple[bool, bool, bool]:
        return (self.x, self.y, self.z)

    def as_array(self) -> np.ndarray:
        return np.array(self.as_tuple(), dtype=bool)

    @property
    def any(self) -> bool:
        return self.x or self.y or self.z

    @property
    def all(self) -> bool:
        return self.x and self.y and self.z


PBC_FULL = PbcDims(True, True, True)
PBC_NONE = PbcDims(False, False, False)


def build_tric_corrections(matrix: np.ndarray) -> np.ndarray:
    """Lattice shifts that can shorten a fractionally-reduced displacement.

    Empty (0,3) for orthogonal boxes. For triclinic boxes: all i*a+j*b+k*c with
    (i,j,k) in {-1,0,1}^3 minus the origin, pruned to |s| < 2*half_diag where
    half_diag bounds the reduced displacement (periodic_box.rs:25-66), then
    zero-padded to a static (26,3) so jitted code sees one shape per box kind.
    A zero-shift row is a no-op candidate (it reproduces the uncorrected vector),
    so the padding is semantically free.
    """
    m = np.asarray(matrix, dtype=FLOAT)
    off_diag = m - np.diag(np.diag(m))
    if not off_diag.any():
        return np.zeros((0, 3), dtype=FLOAT)
    a, b, c = m[:, 0], m[:, 1], m[:, 2]
    half_diag = 0.5 * max(
        np.linalg.norm(a + b + c),
        np.linalg.norm(a + b - c),
        np.linalg.norm(a - b + c),
        np.linalg.norm(-a + b + c),
    )
    bound2 = (2.0 * half_diag) ** 2
    out = np.zeros((N_TRIC_CANDIDATES, 3), dtype=FLOAT)
    n = 0
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                if i == 0 and j == 0 and k == 0:
                    continue
                s = i * a + j * b + k * c
                if float(s @ s) < bound2:
                    out[n] = s
                    n += 1
    return out


# ---------------------------------------------------------------------------
# Pure array functions (numpy or jax.numpy via the array namespace of inputs).
# These are the building blocks used inside jitted kernels.
# ---------------------------------------------------------------------------


def _xp(arr):
    """Array namespace of ``arr``: numpy for host ndarrays, else jax.numpy
    (device arrays and tracers)."""
    if isinstance(arr, (np.ndarray, np.generic)):
        return np
    import jax.numpy as jnp

    return jnp


def mat3_apply(m, vecs):
    """``m @ v`` for (...,3) row-vector arrays, written elementwise.

    A tiny (N,3)@(3,3) matmul could run at an accelerator's reduced default
    matmul precision (TF32 on a GPU, ~1e-3 relative error) and break the
    1e-5 RMSD fidelity bar. The elementwise form runs in exact f32 and fuses
    with surrounding ops. Works for numpy and jax inputs alike.
    """
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    xp = _xp(vecs)
    return xp.stack(
        [
            m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
            m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
            m[2, 0] * x + m[2, 1] * y + m[2, 2] * z,
        ],
        axis=-1,
    )


def shortest_vector(vec, matrix, inv, corrections, pbc_dims=(True, True, True)):
    """Minimum-image displacement(s). ``vec``: (..., 3) row vectors.

    ``pbc_dims`` must be a static (python) triple — it selects code paths.
    Triclinic correction applies only under full PBC (periodic_box.rs:301-318).
    """
    xp = _xp(vec)
    frac = mat3_apply(inv, vec)
    dims = np.array(pbc_dims, dtype=bool)
    if all(pbc_dims):
        frac = frac - xp.round(frac)
    elif any(pbc_dims):
        rounded = frac - xp.round(frac)
        frac = xp.where(xp.asarray(dims), rounded, frac)
    start = mat3_apply(matrix, frac)
    if corrections.shape[0] == 0 or not all(pbc_dims):
        return start
    cands = start[..., None, :] + corrections  # (..., K, 3)
    n2 = xp.sum(cands * cands, axis=-1)
    start2 = xp.sum(start * start, axis=-1)
    best = xp.argmin(n2, axis=-1)
    cand_best = xp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    cand_n2 = xp.take_along_axis(n2, best[..., None], axis=-1)[..., 0]
    return xp.where((cand_n2 < start2)[..., None], cand_best, start)


def wrap_coords(coords, matrix, inv):
    """Conventional wrap into the primary cell: frac -> frac - floor(frac).

    This is the wrap used to populate the distance-search grid
    (distance_search.rs:184-189), NOT the public ``wrap_point`` quirk.
    """
    xp = _xp(coords)
    frac = mat3_apply(inv, coords)
    frac = frac - xp.floor(frac)
    return mat3_apply(matrix, frac)


# ---------------------------------------------------------------------------
# Host-side object API
# ---------------------------------------------------------------------------


class PeriodicBox:
    """Host-side periodic box over numpy, vectorized over point arrays."""

    __slots__ = ("matrix", "inv", "corrections")

    def __init__(
        self,
        matrix: Sequence[Sequence[float]] | np.ndarray,
        angles: Sequence[float] | None = None,
    ):
        if angles is not None:
            # pymolar two-arg form: PeriodicBox([a, b, c], [alpha, beta,
            # gamma]) (molar.pyi:61).
            v = np.asarray(matrix, dtype=np.float64)
            ang = np.asarray(angles, dtype=np.float64)
            if v.shape != (3,) or ang.shape != (3,):
                raise PeriodicBoxError(
                    "vectors+angles form needs two length-3 sequences"
                )
            matrix = PeriodicBox.from_vectors_angles(*v, *ang).matrix
        m = np.array(matrix, dtype=FLOAT)
        if m.shape != (3, 3):
            raise PeriodicBoxError(f"box matrix must be 3x3, got {m.shape}")
        norms = np.linalg.norm(m, axis=0)
        if np.any(norms == 0.0):
            raise PeriodicBoxError("zero length box vector")
        try:
            inv = np.linalg.inv(m.astype(np.float64)).astype(FLOAT)
        except np.linalg.LinAlgError as e:
            raise PeriodicBoxError("box matrix inverse failed") from e
        self.matrix = m
        self.inv = inv
        self.corrections = build_tric_corrections(m)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_vectors_angles(
        a: float, b: float, c: float, alpha: float, beta: float, gamma: float
    ) -> "PeriodicBox":
        """Box from lengths (nm) and angles (degrees): alpha=angle(b,c),
        beta=angle(a,c), gamma=angle(a,b). Rejects zero lengths and angles < 60
        (periodic_box.rs:188-203)."""
        if a == 0.0 or b == 0.0 or c == 0.0:
            raise PeriodicBoxError("zero length box vector")
        if alpha < 60.0 or beta < 60.0 or gamma < 60.0:
            raise PeriodicBoxError("box angle is < 60 deg")
        m = np.zeros((3, 3), dtype=np.float64)
        m[0, 0] = a
        if alpha != 90.0 or beta != 90.0 or gamma != 90.0:
            cosa = np.cos(np.radians(alpha)) if alpha != 90.0 else 0.0
            cosb = np.cos(np.radians(beta)) if beta != 90.0 else 0.0
            if gamma != 90.0:
                sing = np.sin(np.radians(gamma))
                cosg = np.cos(np.radians(gamma))
            else:
                sing, cosg = 1.0, 0.0
            m[0, 1] = b * cosg
            m[1, 1] = b * sing
            m[0, 2] = c * cosb
            m[1, 2] = c * (cosa - cosb * cosg) / sing
            m[2, 2] = np.sqrt(c * c - m[0, 2] ** 2 - m[1, 2] ** 2)
        else:
            m[1, 1] = b
            m[2, 2] = c
        return PeriodicBox(m)

    def to_vectors_angles(self) -> tuple[np.ndarray, np.ndarray]:
        """(lengths, angles_deg); 90 deg for any degenerate pair."""
        m = self.matrix
        lengths = np.linalg.norm(m, axis=0)
        angles = np.full(3, 90.0)
        pairs = ((1, 2), (0, 2), (0, 1))
        for k, (i, j) in enumerate(pairs):
            ni, nj = lengths[i], lengths[j]
            if ni * nj != 0.0:
                cosang = float(m[:, i] @ m[:, j]) / float(ni * nj)
                angles[k] = np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0)))
        return lengths.astype(FLOAT), angles.astype(FLOAT)

    # -- geometry ------------------------------------------------------------

    def shortest_vector(self, vec, pbc: PbcDims = PBC_FULL) -> np.ndarray:
        v = np.asarray(vec, dtype=FLOAT)
        return shortest_vector(v, self.matrix, self.inv, self.corrections, pbc.as_tuple())

    def distance_squared(self, p1, p2, pbc: PbcDims = PBC_FULL):
        d = self.shortest_vector(np.asarray(p2, FLOAT) - np.asarray(p1, FLOAT), pbc)
        return np.sum(d * d, axis=-1)

    def distance(self, p1, p2, pbc: PbcDims = PBC_FULL):
        return np.sqrt(self.distance_squared(p1, p2, pbc))

    def closest_image(self, point, target, pbc: PbcDims = PBC_FULL) -> np.ndarray:
        t = np.asarray(target, dtype=FLOAT)
        return t + self.shortest_vector(np.asarray(point, FLOAT) - t, pbc)

    def wrap_point(self, p) -> np.ndarray:
        """Reference-compatible wrap, including its negative-fraction quirk
        (``1.0 - fract`` for fract < 0; periodic_box.rs:409-434)."""
        frac = np.asarray(p, dtype=FLOAT) @ self.inv.T
        f = np.trunc(frac)
        frac = frac - f  # Rust fract(): keeps the sign
        frac = np.where(frac < 0.0, 1.0 - frac, frac)
        return (frac @ self.matrix.T).astype(FLOAT)

    def wrap_conventional(self, coords) -> np.ndarray:
        """Wrap into [0,1)^3 fractional (the grid-population wrap)."""
        return wrap_coords(np.asarray(coords, dtype=FLOAT), self.matrix, self.inv)

    def to_box_coords(self, vec) -> np.ndarray:
        return np.asarray(vec, dtype=FLOAT) @ self.inv.T

    def to_lab_coords(self, vec) -> np.ndarray:
        return np.asarray(vec, dtype=FLOAT) @ self.matrix.T

    def is_inside(self, point) -> np.ndarray:
        f = self.to_box_coords(point)
        return np.all((f >= 0.0) & (f < 1.0), axis=-1)

    @property
    def is_triclinic(self) -> bool:
        off = self.matrix - np.diag(np.diag(self.matrix))
        return bool(off.any())

    def box_extents(self) -> np.ndarray:
        """Lengths of the three box vectors."""
        return np.linalg.norm(self.matrix, axis=0).astype(FLOAT)

    def lab_extents(self) -> np.ndarray:
        """Per-axis lab-frame extent: row sums of the matrix."""
        return self.matrix.sum(axis=1).astype(FLOAT)

    def scale_vectors(self, factors: Sequence[float]) -> "PeriodicBox":
        """A new box with each box vector scaled (functional, unlike the
        reference's in-place periodic_box.rs:393-403)."""
        return PeriodicBox(self.matrix * np.asarray(factors, dtype=FLOAT)[None, :])

    # -- pymolar-compat getter aliases (molar.pyi:66-70) ---------------------

    def get_matrix(self) -> np.ndarray:
        return self.matrix

    def get_box_extents(self) -> np.ndarray:
        return self.box_extents()

    def get_lab_extents(self) -> np.ndarray:
        return self.lab_extents()

    # -- plumbing ------------------------------------------------------------

    def padded_corrections(self) -> np.ndarray:
        """(26,3) corrections (zero-padded) regardless of box kind — the static
        shape handed to jitted kernels that must handle triclinic frames."""
        out = np.zeros((N_TRIC_CANDIDATES, 3), dtype=FLOAT)
        k = self.corrections.shape[0]
        if k:
            out[:k] = self.corrections
        return out

    def __eq__(self, other) -> bool:
        return isinstance(other, PeriodicBox) and np.array_equal(self.matrix, other.matrix)

    def __repr__(self) -> str:
        v, a = self.to_vectors_angles()
        return f"PeriodicBox(lengths={v.tolist()}, angles={a.tolist()})"
