"""Selection language: parser + evaluator + the ``SelectionExpr`` handle.

A ``SelectionExpr`` is parsed once and can be applied per frame; coordinate-
independent subtrees are cached across applications (the reference's
``Precomputed`` mechanism, ast.rs:505-530), so per-frame re-evaluation only
recomputes state-dependent nodes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import nodes
from .evaluator import EvalContext, SelectionEvalError
from .parser import SelectionSyntaxError, parse

__all__ = [
    "SelectionExpr",
    "FrameSelection",
    "SelectionSyntaxError",
    "SelectionEvalError",
    "parse",
    "nodes",
]


class SelectionExpr:
    """A compiled selection expression, reusable across frames of one system."""

    def __init__(self, text: str):
        self.text = text
        self.ast = parse(text)
        self._cache: dict[int, np.ndarray] = {}
        self._cache_top_id: Optional[int] = None

    @property
    def is_state_dependent(self) -> bool:
        return nodes.is_state_dependent(self.ast)

    def _context(self, topology, state, subset) -> EvalContext:
        ctx = EvalContext(topology, state, subset)
        if self._cache_top_id == id(topology):
            ctx._static_cache = self._cache
        else:
            self._cache = ctx._static_cache = {}
            self._cache_top_id = id(topology)
        return ctx

    def apply(self, topology, state, subset: Optional[np.ndarray] = None) -> np.ndarray:
        """Evaluate -> sorted global index array. ``subset`` restricts both the
        search domain and the 'global' context (sub-selection semantics,
        selection_expr.rs apply_subset)."""
        return self._context(topology, state, subset).evaluate(self.ast)

    def compile_device(self, topology, state, cutoff_params=None):
        """Compile to a jitted per-frame mask function
        ``(coords, box, inv) -> bool[N]`` (see selection.compiled)."""
        from .compiled import compile_selection

        return compile_selection(self.ast, topology, state, cutoff_params)

    def __repr__(self) -> str:
        return f"SelectionExpr({self.text!r})"


class FrameSelection:
    """Uniform per-frame selection evaluator for trajectory tasks.

    Routes through the best available engine, in order:

    1. state-independent expressions evaluate once (index array cached);
    2. state-dependent expressions the device compiler accepts become a
       jitted ``(coords, box, inv) -> mask`` function (``.compiled``), usable
       inside a window program and vmappable over a frame window;
    3. everything else (dynamic ``same``, ``com of`` vectors,
       velocities/forces — see :class:`selection.compiled.CompileUnsupported`)
       transparently falls back to host re-evaluation per frame, so a
       streaming task keeps working at host speed instead of failing.

    The reference re-evaluates state-dependent selections per frame on the
    host unconditionally (selection_expr.rs ``Precomputed`` caches only
    coord-independent subtrees); this class keeps that contract with the
    device path as the fast tier.
    """

    def __init__(self, expr, topology, state0, cutoff_params=None):
        if isinstance(expr, str):
            expr = SelectionExpr(expr)
        self.expr = expr
        self.topology = topology
        self.static_idx: Optional[np.ndarray] = None
        self.compiled = None
        if not expr.is_state_dependent:
            self.static_idx = expr.apply(topology, state0)
        else:
            from .compiled import CompileUnsupported

            try:
                self.compiled = expr.compile_device(
                    topology, state0, cutoff_params
                )
            except CompileUnsupported:
                self.compiled = None  # host fallback per frame
        if self.compiled is not None:
            # Jit once: re-tracing vmap per window (or dispatching the mask
            # graph op-by-op per frame) costs a dispatch per primitive.
            import jax

            self._jit_frame = jax.jit(self.compiled)
            self._jit_window = jax.jit(jax.vmap(self.compiled))

    @property
    def tier(self) -> str:
        if self.static_idx is not None:
            return "static"
        return "device" if self.compiled is not None else "host"

    def eval_frame(self, state) -> np.ndarray:
        """Sorted global indices selected in ``state`` (host-side answer)."""
        if self.static_idx is not None:
            return self.static_idx
        if self.compiled is not None:
            import jax.numpy as jnp

            from ..config import FLOAT

            box = state.box
            b = jnp.asarray(box.matrix, FLOAT) if box is not None else None
            i = jnp.asarray(box.inv, FLOAT) if box is not None else None
            # Cast to the build float so device membership matches the host
            # evaluator's precision (XTC windows are f32 even in f64 builds).
            mask = self._jit_frame(jnp.asarray(state.coords, FLOAT), b, i)
            return np.nonzero(np.asarray(mask))[0]
        return self.expr.apply(self.topology, state)

    def eval_window(self, coords, boxes, invs) -> np.ndarray:
        """(B, n_atoms) boolean masks for a window of frames.

        Device tier: one vmapped jitted call over the window. Host tier:
        per-frame re-evaluation (the documented fallback; throughput is the
        host evaluator's). Static tier: the constant mask broadcast.
        """
        n = self.topology.n_atoms
        coords_np = np.asarray(coords)
        B = coords_np.shape[0]
        if self.static_idx is not None:
            m = np.zeros(n, dtype=bool)
            m[self.static_idx] = True
            return np.broadcast_to(m, (B, n)).copy()
        if self.compiled is not None:
            import jax
            import jax.numpy as jnp

            from ..config import FLOAT

            masks = self._jit_window(
                jnp.asarray(coords, FLOAT),
                jnp.asarray(boxes, FLOAT),
                jnp.asarray(invs, FLOAT),
            )
            return np.asarray(masks)
        from ..core.pbc import PeriodicBox
        from ..core.state import State

        out = np.zeros((B, n), dtype=bool)
        for k in range(B):
            st = State(
                coords=coords_np[k],
                box=PeriodicBox(np.asarray(boxes[k])),
            )
            out[k, self.expr.apply(self.topology, st)] = True
        return out
