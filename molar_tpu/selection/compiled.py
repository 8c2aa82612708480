"""Device-compiled selections: state-dependent expressions as jitted mask fns.

The device half of the selection design (SURVEY §7 / BASELINE north star):
topology-only subtrees collapse to host-precomputed constant masks (the
``Precomputed`` analog), while coordinate-dependent nodes compile to a pure
jax function ``(coords, box, inv) -> bool[N]`` that re-evaluates per frame
inside a jitted trajectory window — vmappable over frames, fusable with
downstream analysis.

Supported dynamic nodes: coordinate math comparisons (x/y/z with the full
math grammar over static attributes), ``within CUTOFF [pbc] [self] of
<static inner>``, ``within ... of <const point>``, and any and/or/not
combination with static subtrees. Unsupported nodes (dynamic ``same``/
``com of`` vectors, velocities/forces) raise ``CompileUnsupported`` — fall
back to host evaluation for those.

Error-semantics divergence: on device, division by zero and sqrt of a
negative yield NaN (comparisons with NaN are False) instead of the host
evaluator's runtime errors — data-dependent errors can't raise under jit.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..core.pbc import PBC_NONE
from ..core.periodic_table import ELEMENT_VDW_NM, NUM_ELEMENTS
from ..ops import neighbor
from . import nodes as N
from .evaluator import EvalContext


class CompileUnsupported(NotImplementedError):
    pass


class CompiledSelection:
    """Holds the compiled mask function + its static metadata."""

    def __init__(self, fn: Callable, n_atoms: int, uses_box: bool):
        self._fn = fn
        self.n_atoms = n_atoms
        self.uses_box = uses_box

    def __call__(self, coords, box=None, inv=None):
        """coords (N,3) -> bool (N,) mask. box/inv required when the
        expression uses periodic search."""
        return self._fn(coords, box, inv)


def compile_selection(
    ast: N.Logical,
    topology,
    state,
    cutoff_params: Optional[dict] = None,
) -> CompiledSelection:
    """Compile an AST against a topology (and a representative state, used to
    size the cell grid for `within` nodes).

    ``cutoff_params``: optional overrides {"cap": int, "tgt_cap": int,
    "max_tgt_cells": int} for the within kernels.
    """
    n = topology.n_atoms
    host_ctx = EvalContext(topology, state)
    params = {"cap": None, "tgt_cap": None, "max_tgt_cells": None}
    params.update(cutoff_params or {})
    uses_box = [False]

    def static_mask(node) -> jnp.ndarray:
        m = host_ctx.eval_mask(node, host_ctx.global_mask)
        return jnp.asarray(m)

    def build(node) -> Callable:
        if not N.is_state_dependent(node):
            const = static_mask(node)
            return lambda c, b, i: const
        if isinstance(node, N.LAnd):
            fa, fb = build(node.left), build(node.right)
            return lambda c, b, i: fa(c, b, i) & fb(c, b, i)
        if isinstance(node, N.LOr):
            fa, fb = build(node.left), build(node.right)
            return lambda c, b, i: fa(c, b, i) | fb(c, b, i)
        if isinstance(node, N.LNot):
            f = build(node.operand)
            return lambda c, b, i: ~f(c, b, i)
        if isinstance(node, N.LComparison):
            return build_comparison(node.comparison)
        if isinstance(node, N.LWithin):
            if N.is_state_dependent(node.inner):
                raise CompileUnsupported(
                    "within over a state-dependent inner selection"
                )
            inner_idx = np.nonzero(np.asarray(static_mask(node.inner)))[0]
            return build_within(node.params, jnp.asarray(inner_idx),
                                static_mask(node.inner))
        if isinstance(node, N.LWithinPoint):
            if not isinstance(node.point, N.VecConst):
                raise CompileUnsupported("within of a dynamic point")
            pt = jnp.asarray(node.point.value, jnp.float32).reshape(1, 3)
            return build_within(node.params, pt, None, is_point=True)
        raise CompileUnsupported(type(node).__name__)

    def build_math(e) -> Callable:
        if isinstance(e, N.MathConst):
            v = jnp.float32(e.value)
            return lambda c: v
        if isinstance(e, N.MathAttr):
            V = N.MathVar
            if e.var in (V.X, V.Y, V.Z):
                ax = (V.X, V.Y, V.Z).index(e.var)
                return lambda c: c[:, ax]
            if e.var in (V.VX, V.VY, V.VZ, V.FX, V.FY, V.FZ):
                raise CompileUnsupported("velocities/forces on device")
            col = {
                V.MASS: topology.mass,
                V.CHARGE: topology.charge,
                V.OCCUPANCY: topology.occupancy,
                V.BFACTOR: topology.bfactor,
                V.RESID: topology.resid,
                V.RESINDEX: topology.resindex,
                V.INDEX: np.arange(topology.n_atoms),
            }.get(e.var)
            if col is None and e.var is V.VDW:
                z = np.clip(topology.atomic_number, 0, NUM_ELEMENTS - 1)
                col = ELEMENT_VDW_NM[z]
            const = jnp.asarray(col, jnp.float32)
            return lambda c: const
        if isinstance(e, N.MathBinary):
            fa, fb = build_math(e.left), build_math(e.right)
            op = {
                "+": jnp.add, "-": jnp.subtract, "*": jnp.multiply,
                "/": jnp.divide, "^": jnp.power,
            }[e.op]
            return lambda c: op(fa(c), fb(c))
        if isinstance(e, N.MathNeg):
            f = build_math(e.operand)
            return lambda c: -f(c)
        if isinstance(e, N.MathFunc):
            f = build_math(e.operand)
            g = {"abs": jnp.abs, "sqrt": jnp.sqrt, "sin": jnp.sin,
                 "cos": jnp.cos}[e.name]
            return lambda c: g(f(c))
        raise CompileUnsupported(type(e).__name__)

    def build_comparison(cmp_) -> Callable:
        fns = [build_math(t) for t in cmp_.terms]
        ops = {
            "<": jnp.less, "<=": jnp.less_equal, ">": jnp.greater,
            ">=": jnp.greater_equal, "==": jnp.equal, "!=": jnp.not_equal,
        }
        o1 = ops[cmp_.ops[0]]
        if len(cmp_.ops) == 1:
            return lambda c, b, i: o1(fns[0](c), fns[1](c))
        o2 = ops[cmp_.ops[1]]

        def f(c, b, i):
            mid = fns[1](c)
            return o1(fns[0](c), mid) & o2(mid, fns[2](c))

        return f

    def auto_cap(dims, idx) -> int:
        """Max per-cell occupancy on the representative frame + 50% headroom
        (a clobbered fixed-capacity table corrupts results in BOTH
        directions, so caps must be sized from the data)."""
        box = state.box
        if box is not None:
            frac = state.coords[idx] @ box.inv.T
            frac -= np.floor(frac)
        else:
            lo = state.coords.min(axis=0)
            span = state.coords.max(axis=0) - lo + 1e-3
            frac = (state.coords[idx] - lo) / span
        cell = np.minimum((frac * dims).astype(np.int64), np.asarray(dims) - 1)
        flat = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
        peak = int(np.bincount(flat).max()) if len(flat) else 1
        return max(int(peak * 1.5) + 4, 8)

    def build_within(p: N.WithinParams, target, inner_mask, is_point=False):
        if p.pbc.any:
            uses_box[0] = True
            if state.box is None:
                raise CompileUnsupported("pbc within without a box")
            dims = neighbor.grid_dims(state.box.box_extents(), p.cutoff)
            pbc = p.pbc.as_tuple()
        else:
            # Non-periodic: grid over the box anyway (points assumed in-box);
            # host path remains the oracle for far-out-of-box systems.
            dims = neighbor.grid_dims(
                state.coords.max(axis=0) - state.coords.min(axis=0) + 1e-3,
                p.cutoff,
            )
            pbc = (False, False, False)
            uses_box[0] = True  # still needs box arrays for wrapping math
        aidx = jnp.arange(n)
        # Skewed boxes need the correction-candidate min-image path; the
        # shift fast path (corrections=None) assumes orthorhombic (see
        # within_mask contract notes). The skew CLASS is decided at compile
        # time, but the candidate VECTORS are computed per frame from that
        # frame's box (all 26 ±1-lattice combinations, unpruned — the
        # host's pruning is only an optimization; zero rows are no-ops), so
        # NPT box rescaling stays exact.
        tric = bool(
            p.pbc.any
            and state.box is not None
            and state.box.corrections.shape[0]
        )
        ijk = None
        if tric:
            ijk = jnp.asarray(
                np.array(
                    [
                        (i_, j_, k_)
                        for i_ in (-1, 0, 1)
                        for j_ in (-1, 0, 1)
                        for k_ in (-1, 0, 1)
                        if (i_, j_, k_) != (0, 0, 0)
                    ],
                    dtype=np.float32,
                )
            )

        def frame_corr(b):
            if not tric:
                return None
            # candidate = i*col0 + j*col1 + k*col2, elementwise (no matmul).
            return (
                ijk[:, 0:1] * b[:, 0][None, :]
                + ijk[:, 1:2] * b[:, 1][None, :]
                + ijk[:, 2:3] * b[:, 2][None, :]
            )
        cap = params["cap"] or auto_cap(dims, np.arange(n))
        if not is_point:
            tcap = params["tgt_cap"] or auto_cap(dims, np.asarray(target))
        else:
            tcap = 8
        mtc = params["max_tgt_cells"]
        include = p.include_inner and inner_mask is not None

        if is_point:
            def f(c, b, i):
                tgt = jnp.asarray(target)
                allc = jnp.concatenate([c, tgt])
                mask, _ = neighbor.within_mask(
                    allc, aidx, jnp.asarray([n]), cutoff=p.cutoff,
                    box=b, inv=i, corrections=frame_corr(b), dims=dims,
                    cap=cap, tgt_cap=8, pbc=pbc,
                )
                return mask
            return f

        tidx = target

        def f(c, b, i):
            mask, _ = neighbor.within_mask(
                c, aidx, tidx, cutoff=p.cutoff, box=b, inv=i,
                corrections=frame_corr(b), dims=dims, cap=cap, tgt_cap=tcap,
                max_tgt_cells=mtc, pbc=pbc,
            )
            if include:
                mask = mask | inner_mask
            return mask
        return f

    fn = build(ast)
    if not uses_box[0]:
        eye = jnp.eye(3, dtype=jnp.float32)
        raw = fn
        fn = lambda c, b, i: raw(
            c, b if b is not None else eye, i if i is not None else eye
        )
    return CompiledSelection(fn, n, uses_box[0])
