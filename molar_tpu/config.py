"""Global precision configuration.

The reference workspace compiles with ``Float = f32`` by default and flips the whole
workspace to ``f64`` behind a cargo feature (reference: molar/src/aliases.rs:6-13).
Here the switch is the ``MOLAR_TPU_F64`` environment variable, read once at import.
It turns on ``jax_enable_x64``: jitted code then runs in f64 on whatever backend
JAX uses — there is no fallback to the CPU — and on a GPU f64 arithmetic is far
slower than f32.
"""

from __future__ import annotations

import os

import numpy as np

_TRUTHY = {"1", "true", "True", "yes", "on"}

#: Whether the library runs in double precision.
F64: bool = os.environ.get("MOLAR_TPU_F64", "0") in _TRUTHY

#: NumPy scalar dtype used for all geometric data (coords, boxes, masses...).
FLOAT = np.float64 if F64 else np.float32

#: Integer dtype for atom indices. int32 covers 2.1e9 atoms and is the
#: accelerators' native index width.
INDEX = np.int32

if F64:  # pragma: no cover - exercised only in f64 CI runs
    import jax

    jax.config.update("jax_enable_x64", True)


def float_eps() -> float:
    """Machine epsilon of the active float type."""
    return float(np.finfo(FLOAT).eps)
