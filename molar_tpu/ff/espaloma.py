"""espaloma-charge partial charges via the bundled ONNX GNN.

Parity with the reference (molar_ff/src/charge.rs): per-atom features
``[n, 116]`` (element one-hot, degree/valence, RDKit-style Hueckel
aromaticity over individual + fused ring systems, mass, ring-size bits 3..8,
hybridization one-hot with neighbor-conjugation SP2 promotion) and a
row-mean-normalized adjacency feed a small GNN producing electronegativity/
hardness, followed by the closed-form equilibration
``q_i = -e_i/s_i + (1/s_i) (sum e_j/s_j)/(sum 1/s_j)`` (total charge 0).

The ONNX graph (MatMul/Add/Relu/Tanh/Gather only) is executed by a ~40-line
interpreter over the parsed graph (:mod:`molar_tpu.ff.onnx_mini`). Two
backends share that interpreter:

- numpy (:func:`run_gnn`) — always available, the ground truth;
- jitted jax (:func:`run_gnn_jax`) — the same node walk traced into ONE
  XLA program per padded molecule size (atoms padded to a 16-multiple
  bucket so 60-atom drug-likes hit a handful of cached compiles). MatMuls
  run at ``Precision.HIGHEST`` so a reduced-precision matmul default (TF32
  on a GPU) cannot move charges (parity ≤1e-5 vs numpy; reference runs tract on the CPU,
  molar_ff/src/charge.rs:27,290-307).

Dispatch (:func:`espaloma_charges`): the jax path is used when the process
is already a jax process (``"jax" in sys.modules``) or
``MOLAR_ESPALOMA_BACKEND=jax``; pure-host CLI paths keep the numpy walk —
importing jax (and initialising an accelerator backend) to charge one
small molecule would cost more than it saves. ``MOLAR_ESPALOMA_BACKEND=
numpy`` forces the host walk.
"""

from __future__ import annotations

import os
import sys
from functools import lru_cache

import numpy as np

from ..ops.perception import sssr_rings
from .onnx_mini import Graph, load_model

MODEL_PATH_CANDIDATES = [
    os.path.join(os.path.dirname(__file__), "espaloma_charge.onnx"),
    "/root/reference/molar_ff/assets/espaloma_charge.onnx",
]

_MASS = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999, 9: 18.998,
         15: 30.974, 16: 32.06, 17: 35.45, 35: 79.904, 53: 126.904}
_OUTER = {1: 1, 6: 4, 7: 5, 8: 6, 9: 7, 15: 5, 16: 6, 17: 7, 35: 7, 53: 7}
_EN = {1: 2.20, 6: 2.55, 7: 3.04, 8: 3.44, 9: 3.98, 15: 2.19, 16: 2.58,
       17: 3.16, 35: 2.96, 53: 2.66}


class EspalomaError(RuntimeError):
    pass


@lru_cache(maxsize=1)
def _graph() -> Graph:
    for p in MODEL_PATH_CANDIDATES:
        if os.path.exists(p):
            return load_model(p)
    raise EspalomaError(
        "espaloma_charge.onnx not found; place it next to molar_tpu/ff/ or "
        "set MOLAR_ESPALOMA_MODEL"
    )


def _walk_graph(g: Graph, env: dict, matmul, relu, tanh, take):
    """Interpret the node list with the given primitive set.

    One walk serves both backends: with numpy primitives it executes
    eagerly; with jnp primitives inside ``jax.jit`` it *traces*, so the
    whole GNN becomes a single fused XLA program."""
    for node in g.nodes:
        ins = [env[i] for i in node.inputs]
        op = node.op_type
        if op == "MatMul":
            out = matmul(ins[0], ins[1])
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Relu":
            out = relu(ins[0])
        elif op == "Tanh":
            out = tanh(ins[0])
        elif op == "Gather":
            axis = node.attrs.get("axis")
            ax = axis.i if axis is not None and axis.i is not None else 0
            out = take(ins[0], ins[1], ax)
        else:
            raise EspalomaError(f"unsupported op {op}")
        env[node.outputs[0]] = out
    return env[g.outputs[0]], env[g.outputs[1]]


def run_gnn(features: np.ndarray, adj_mean: np.ndarray):
    """Execute the parsed graph -> (e, s) per atom (numpy ground truth)."""
    g = _graph()
    env: dict[str, np.ndarray] = dict(g.initializers)
    env["features"] = features.astype(np.float32)
    env["adjacency_mean"] = adj_mean.astype(np.float32)
    e, s = _walk_graph(
        g, env,
        matmul=lambda a, b: a @ b,
        relu=lambda a: np.maximum(a, 0),
        tanh=np.tanh,
        take=lambda a, i, ax: np.take(a, i, axis=ax),
    )
    return np.asarray(e).reshape(-1), np.asarray(s).reshape(-1)


@lru_cache(maxsize=None)
def _jax_forward(n_pad: int):
    """Jitted (features, adj) -> (e, s) for one padded atom count.

    Cached per bucket: molecules are padded up to 16-multiples, so a
    typical small-molecule corpus compiles a handful of programs total.
    HIGHEST matmul precision keeps a reduced-precision default (TF32 on a
    GPU) from perturbing charges (the geometry precision rule; parity test
    ≤1e-5)."""
    import jax
    import jax.numpy as jnp

    g = _graph()
    consts = {k: jnp.asarray(v) for k, v in g.initializers.items()}

    def fwd(features, adj_mean):
        env = dict(consts)
        env["features"] = features
        env["adjacency_mean"] = adj_mean
        e, s = _walk_graph(
            g, env,
            matmul=lambda a, b: jnp.matmul(
                a, b, precision=jax.lax.Precision.HIGHEST
            ),
            relu=lambda a: jnp.maximum(a, 0),
            tanh=jnp.tanh,
            take=lambda a, i, ax: jnp.take(a, jnp.asarray(i), axis=ax),
        )
        return e.reshape(-1), s.reshape(-1)

    return jax.jit(fwd)


def run_gnn_jax(features: np.ndarray, adj_mean: np.ndarray):
    """Jitted-jax twin of :func:`run_gnn` (same graph walk, XLA-fused).

    Atoms are padded to the next 16-multiple; pad rows carry zero features
    and zero adjacency in BOTH directions, so real-row message passing
    (``adj @ h`` never mixes a pad column into a real row) and the sliced
    (e, s) are unchanged. The two Gathers select columns (axis 1) with
    constant indices, untouched by row padding."""
    n = features.shape[0]
    n_pad = max(16, -(-n // 16) * 16)
    f = np.zeros((n_pad, features.shape[1]), np.float32)
    f[:n] = features
    a = np.zeros((n_pad, n_pad), np.float32)
    a[:n, :n] = adj_mean
    e, s = _jax_forward(n_pad)(f, a)
    return np.asarray(e)[:n], np.asarray(s)[:n]


# ---------------------------------------------------------------------------
# Featurization
# ---------------------------------------------------------------------------


def _hybridization(z, degree, n_double, n_triple, aromatic, neighbor_conj):
    if z == 1:
        return None
    if aromatic:
        return 1
    if degree >= 6:
        return 4
    if degree == 5:
        return 3
    if degree == 4:
        return 2
    if n_triple >= 1 or n_double >= 2:
        return 0
    if n_double == 1:
        return 1
    if neighbor_conj and ((z == 7 and degree == 3) or (z == 8 and degree <= 2)):
        return 1
    return 2


def _aromatic_atoms(z, fc, bonds, rings):
    n = len(z)
    inc: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for i, j, o in bonds:
        inc[i].append((j, o))
        inc[j].append((i, o))
    in_ring = np.zeros(n, dtype=bool)
    for r in rings:
        in_ring[r] = True

    contrib: list = []
    for a in range(n):
        sigma = len(inc[a])
        if sigma >= 4 or any(o == 3 and in_ring[j] for j, o in inc[a]):
            contrib.append(None)
            continue
        exocyclic_zero = False
        broken = False
        for j, o in inc[a]:
            if o >= 2 and not in_ring[j]:
                if _EN.get(int(z[j]), 0.0) > _EN.get(int(z[a]), 0.0):
                    exocyclic_zero = True
                else:
                    broken = True
                    break
        if broken:
            contrib.append(None)
            continue
        if exocyclic_zero:
            contrib.append(0)
            continue
        avail = _OUTER.get(int(z[a]), 0) - int(fc[a]) - sigma
        contrib.append(0 if avail <= 0 else (1 if avail % 2 == 1 else 2))

    def huckel(atoms):
        pi = 0
        for a in atoms:
            if contrib[a] is None:
                return False
            pi += contrib[a]
        return pi % 4 == 2

    arom = np.zeros(n, dtype=bool)
    for ring in rings:
        if huckel(ring):
            arom[ring] = True
    # Maximal fused systems (rings sharing >= 2 atoms), union-find.
    parent = list(range(len(rings)))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(len(rings)):
        for j in range(i + 1, len(rings)):
            if len(set(rings[i]) & set(rings[j])) >= 2:
                parent[find(i)] = find(j)
    systems: dict[int, set] = {}
    for i in range(len(rings)):
        systems.setdefault(find(i), set()).update(rings[i])
    for atoms in systems.values():
        atoms = sorted(atoms)
        if huckel(atoms):
            arom[atoms] = True
    return arom


def featurize(z, fc, bonds):
    """(features [n,116], adjacency_mean [n,n]) per charge.rs:213-290."""
    n = len(z)
    rings = sssr_rings(n, np.asarray([(i, j) for i, j, _ in bonds]).reshape(-1, 2))
    rg = np.zeros((n, 11), dtype=bool)
    for r in rings:
        sz = min(len(r), 10)
        rg[r, sz] = True
    nd = np.zeros(n, np.int64)
    nt = np.zeros(n, np.int64)
    val = np.zeros(n, np.int64)
    deg = np.zeros(n, np.int64)
    for i, j, o in bonds:
        val[i] += o
        val[j] += o
        deg[i] += 1
        deg[j] += 1
        if o == 2:
            nd[i] += 1
            nd[j] += 1
        elif o == 3:
            nt[i] += 1
            nt[j] += 1
    aromatic = _aromatic_atoms(z, fc, bonds, rings)
    adjlist: list[list[int]] = [[] for _ in range(n)]
    for i, j, _ in bonds:
        adjlist[i].append(j)
        adjlist[j].append(i)
    neighbor_conj = np.array(
        [
            any(
                aromatic[j] or ((nd[j] > 0 or nt[j] > 0) and int(z[j]) in (6, 7))
                for j in adjlist[i]
            )
            for i in range(n)
        ]
    )
    feat = np.zeros((n, 116), dtype=np.float32)
    for i in range(n):
        zi = int(z[i])
        if zi < 100:
            feat[i, zi] = 1.0
        feat[i, 100] = deg[i]
        feat[i, 101] = val[i]
        feat[i, 102] = val[i]
        feat[i, 103] = 1.0 if aromatic[i] else 0.0
        feat[i, 104] = _MASS.get(zi, 0.0)
        for k, sz in enumerate(range(3, 9)):
            feat[i, 105 + k] = 1.0 if rg[i, sz] else 0.0
        h = _hybridization(zi, int(deg[i]), int(nd[i]), int(nt[i]),
                           bool(aromatic[i]), bool(neighbor_conj[i]))
        if h is not None:
            feat[i, 111 + h] = 1.0
    adj = np.zeros((n, n), dtype=np.float32)
    for i, j, _ in bonds:
        adj[i, j] = 1.0
        adj[j, i] = 1.0
    rowsum = adj.sum(axis=1, keepdims=True)
    adj = np.divide(adj, rowsum, out=adj, where=rowsum > 0)
    return feat, adj


def equilibrate(e: np.ndarray, s: np.ndarray) -> np.ndarray:
    """q_i = -e_i/s_i + (1/s_i) (sum e/s)/(sum 1/s); total charge 0."""
    inv = 1.0 / s
    lam = float((e * inv).sum() / inv.sum())
    return -e * inv + inv * lam


def _use_jax() -> bool:
    mode = os.environ.get("MOLAR_ESPALOMA_BACKEND", "auto")
    if mode == "jax":
        return True
    if mode == "numpy":
        return False
    # auto: ride along when the process is already a jax process (backend
    # warm or about to be); never start an accelerator just for charges.
    return "jax" in sys.modules


def espaloma_charges(z, fc, bonds) -> np.ndarray:
    feat, adj = featurize(z, fc, bonds)
    if _use_jax():
        e, s = run_gnn_jax(feat, adj)
    else:
        e, s = run_gnn(feat, adj)
    return equilibrate(e, s)


def apply_charges(sel_or_system) -> np.ndarray:
    """Compute espaloma charges for a Sel/System and write the charge column
    (reference SystemPy.apply_charges)."""
    from ..core.system import Sel, System

    if isinstance(sel_or_system, System):
        sel = sel_or_system.select_all()
    else:
        sel = sel_or_system
    top = sel.topology
    idx = sel.indices
    local = {int(g): k for k, g in enumerate(idx)}
    z = top.atomic_number[idx]
    fc = (
        top.formal_charge[idx]
        if top.formal_charge is not None
        else np.zeros(len(idx), np.int64)
    )
    bonds = []
    orders = top.bond_orders
    in_sel = np.zeros(top.n_atoms, dtype=bool)
    in_sel[idx] = True
    for bi in range(top.n_bonds):
        a, b = int(top.bonds[bi, 0]), int(top.bonds[bi, 1])
        if not (in_sel[a] and in_sel[b]):
            continue
        o = int(orders[bi]) if orders is not None else 1
        bonds.append((local[a], local[b], max(o, 1)))
    q = espaloma_charges(z, fc, bonds)
    top.charge[idx] = q.astype(top.charge.dtype)
    return q
