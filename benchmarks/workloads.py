#!/usr/bin/env python
"""The five BASELINE.json config workloads, runnable end-to-end.

    python benchmarks/workloads.py [--frames 64] [--atoms 50000] [--which all]

1. ca_rmsd    — CA-RMSD Kabsch fit over a GRO+XTC stream (device window scan)
2. com_splits — per-residue COM + gyration with PBC via segment reductions
3. contacts   — protein-ligand contact lists per frame (fixed-capacity)
4. sasa       — per-residue EXACT Lee-Richards SASA time series (sasa_lr)
5. membrane   — leaflet split + order parameters (batched per frame)
6. trjconv    — XTC stream -> selection -> DCD write (reference workload #3)

Each prints a JSON line with frames/sec and the device it ran on
(platform, device_kind, count). The rows need a GPU and fail at once without
one; ``--cpu`` rehearses them on the CPU backend, and then every line says
``"platform": "cpu"``. Synthetic inputs by default; real systems via
-f STRUCTURE XTC.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _synth_system(n_atoms, n_protein, box_side=8.0, seed=0):
    from molar_tpu import PeriodicBox, System
    from molar_tpu.core.atom import Atom
    from molar_tpu.core.state import State
    from molar_tpu.core.topology import Topology

    rng = np.random.default_rng(seed)
    atoms = []
    res = 0
    # "protein": 4-atom residues with a CA each; ligand: last residue
    for i in range(n_protein):
        if i % 4 == 0:
            res += 1
        name = ["N", "CA", "C", "O"][i % 4]
        atoms.append(Atom(name=name, resname="ALA", resid=res, atomic_number=6,
                          mass=12.0))
    for i in range(n_atoms - n_protein):
        if i % 3 == 0:
            res += 1
        name = ["OW", "HW1", "HW2"][i % 3]
        atoms.append(Atom(name=name, resname="SOL", resid=res,
                          atomic_number=8 if name == "OW" else 1,
                          mass=16.0 if name == "OW" else 1.0))
    top = Topology.from_atoms(atoms)
    top.assign_resindex()
    density = n_atoms / box_side**3
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    protein = (box_side / 2 + d * r).astype(np.float32)
    water = rng.uniform(0, box_side, (n_atoms - n_protein, 3)).astype(np.float32)
    st = State(coords=np.concatenate([protein, water]),
               box=PeriodicBox(np.diag([box_side] * 3).astype(np.float32)))
    return System(top, st)


def _write_xtc(system, path, n_frames, sigma=0.01, seed=1):
    from molar_tpu.io.xtc import XtcHandler

    rng = np.random.default_rng(seed)
    w = XtcHandler(path, "w")
    c = system.state.coords.copy()
    for k in range(n_frames):
        c = c + rng.normal(0, sigma, c.shape).astype(np.float32)
        w.write_raw(c, system.state.box.matrix, step=k, time=float(k))
    w.close()


def _windows(xtc, window, subset=None):
    from molar_tpu.tasks.trajectory import TrajectoryReader

    # i8-delta transport: ~quarter the host-to-device bytes, bit-exact
    # reconstruction on device. Selection workloads additionally ship only
    # their subset's rows (another n_atoms/len(subset) wire cut;
    # bit-identical results).
    return TrajectoryReader([xtc]).iter_windows(
        window, quantized="delta", subset=subset
    )


def decode_window_coords(coords):
    from molar_tpu.tasks.trajectory import decode_window_coords as _d

    return _d(coords)


def _timed_stream(fn, xtc, window, runner=None, subset=None):
    """Warm up (compile) every distinct window shape, then time a full pass.

    Compilation is set-up, not throughput. A trajectory whose frame count is
    not a multiple of ``window`` has a shorter trailing window — a second
    shape that must be warmed too, or its compile lands inside the clock.

    ``window=0`` sizes the window automatically from the subset's wire
    bytes (:func:`_auto_window`).

    ``runner``: a parallel.mesh.MeshWindowRunner shards each window's frame
    axis over the mesh (the --mesh flag; the workload fns' outputs are all
    per-frame, as mesh mode requires)."""
    import jax

    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        WindowPipeline,
        auto_window,
    )

    if not window:
        window = auto_window(xtc, subset)
        print(f"# auto window={window}", file=sys.stderr)

    def call(coords, boxes, invs, times):
        if runner is not None:
            return runner.call(fn, coords, boxes, invs, times)
        return fn(jax.device_put(coords), boxes, invs, times)

    warmed = set()
    for coords, boxes, invs, times, ids in _windows(xtc, window, subset):
        b = len(ids)
        if b not in warmed:
            warmed.add(b)
            jax.block_until_ready(call(coords, boxes, invs, times))
    # Timed pass through the overlapped pipeline (decode thread + one put
    # per window + async dispatch — bench.py's machinery): the plain loop
    # kept the host decode on the critical path, which bounds the small
    # subset workloads once dispatch is amortized. Passing ``runner``
    # (not a Mesh) keeps the warmed per-form jit cache. Best of 3 passes.
    best = None
    for _ in range(3):
        pipe = WindowPipeline(
            TrajectoryReader([xtc]), window, fn, quantized="delta",
            subset=subset, mesh=runner,
        )
        n = 0
        outs = []
        t0 = time.perf_counter()
        for ids, res in pipe.run():
            outs.append(res)
            n += len(ids)
        jax.block_until_ready(outs)
        el = time.perf_counter() - t0
        best = el if best is None else min(best, el)
    return n, best, outs


def wl_ca_rmsd(system, xtc, window, runner=None):
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import measure

    sel = system("name CA")
    ref = jnp.asarray(sel.coords)
    masses = jnp.asarray(sel.masses)

    # Windows ship only the CA rows (subset transport): the gather moves to
    # the host slice, the wire shrinks by n_atoms/n_ca, results unchanged.
    @jax.jit
    def fn(coords, boxes, invs, times):
        coords = decode_window_coords(coords)
        def per_frame(carry, s):
            rmsd, _r, _s = measure.fit_rmsd(s, ref, masses)
            return carry, rmsd
        return jax.lax.scan(per_frame, 0, coords)[1]

    n, el, outs = _timed_stream(fn, xtc, window, runner, subset=sel.indices)
    # Self-check: mean per-frame RMSD, the exact scalar
    # native_workloads.cpp wl_ca_rmsd emits as "check".
    vals = np.concatenate([np.asarray(o).ravel() for o in outs])
    return n, el, {"check": float(vals.mean())}


def wl_com_splits(system, xtc, window, runner=None):
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import measure

    sel = system("resname ALA")

    # Scatter-free dense-segment layout (ops/measure.py): contiguous runs
    # padded to the longest run, segment axis last. Chosen over a one-hot
    # einsum, per-frame segment_sums and one flat whole-window segment_sum
    # on the previous accelerator; not yet compared on a GPU.
    idx_np, w_np, _ = measure.contiguous_segments_dense(
        sel.segment_ids(), sel.masses
    )
    idx = jnp.asarray(idx_np)
    w = jnp.asarray(w_np)

    # Subset transport: windows carry only the selection's rows.
    @jax.jit
    def fn(coords, boxes, invs, times):
        x = decode_window_coords(coords)  # (B, n, 3)
        return measure.dense_segment_com_gyration(x, idx, w)

    n, el, outs = _timed_stream(fn, xtc, window, runner, subset=sel.indices)
    # Self-check: mean over frames of the mean per-segment gyration radius
    # (native wl_com_gyr's "check").
    gyr = np.concatenate([np.asarray(o[1]) for o in outs])  # (N, nseg)
    return n, el, {"check": float(gyr.mean(axis=1).mean())}


def wl_contacts(system, xtc, window, runner=None, cutoff=0.4):
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import neighbor

    prot_g = system("resname ALA").indices
    lig_g = system("name OW").indices[:50]  # stand-in ligand
    # Subset transport: ship only prot+lig rows; the search uses local
    # row numbers within the subset (same coordinates, same pairs).
    subset = np.concatenate([prot_g, lig_g])
    prot = jnp.arange(len(prot_g))
    lig = len(prot_g) + jnp.arange(len(lig_g))
    box = jnp.asarray(system.state.box.matrix)
    inv = jnp.asarray(system.state.box.inv)
    dims = neighbor.grid_dims(system.state.box.box_extents(), cutoff)

    # 4000 x 50 candidates: the dense matrix wins over the cell grid by an
    # order of magnitude at this scale (the grid carries (n, 27, cap) hit
    # tables + a 7M-slot nonzero per frame; ops/neighbor.py docstring)
    dense = len(prot_g) * len(lig_g) <= 1 << 21

    @jax.jit
    def fn(coords, boxes, invs, times):
        coords = decode_window_coords(coords)
        def per_frame(carry, fr):
            c, b, i = fr
            if dense:
                pairs, dist, cnt, ofl = neighbor.contact_pairs_dense(
                    c, prot, lig, cutoff=cutoff, box=b, inv=i,
                    max_pairs=1 << 14,
                )
            else:
                pairs, dist, cnt, ofl = neighbor.contact_pairs(
                    c, prot, lig, cutoff=cutoff, box=b, inv=i, dims=dims,
                    cap=64, max_pairs=1 << 14,
                )
            return carry, (cnt, ofl)
        return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

    n, el, outs = _timed_stream(fn, xtc, window, runner, subset=subset)
    cnt = np.concatenate([np.asarray(o[0]).ravel() for o in outs])
    ofl = np.concatenate([np.asarray(o[1]).ravel() for o in outs])
    if ofl.any():
        raise RuntimeError("contacts workload overflowed its pair capacity — "
                           "the fps would be measuring truncated output")
    if cnt.sum() == 0:
        raise RuntimeError("contacts workload found ZERO contacts across the "
                           "whole stream — trivially empty accumulation "
                           "(broken search or broken inputs)")
    # Self-check: mean contact count per frame (native wl_contacts' "check").
    return n, el, {"check": float(cnt.mean())}


def wl_fused(system, xtc, window, runner=None, cutoff=0.4):
    """ca_rmsd + com_splits + contacts in ONE window program.

    The three selection workloads are dispatch-bound (3.75-12 KB/frame
    wires); fusing their per-frame bodies into a single scanned program
    ships ONE union-subset stream and pays ONE dispatch per window for all
    three observables — the whole-analysis-program ethos
    (docs/architecture.md). The native twin (native_workloads.cpp wl_fused)
    decodes each frame once and runs the same three per-frame bodies, so
    the comparison stays like-for-like.
    """
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import measure, neighbor

    ca = system("name CA")
    ala = system("resname ALA")
    lig_g = system("name OW").indices[:50]
    subset = np.unique(np.concatenate([ca.indices, ala.indices, lig_g]))
    loc = lambda g: jnp.asarray(np.searchsorted(subset, g))  # noqa: E731
    ca_l, ala_l, lig_l = loc(ca.indices), loc(ala.indices), loc(lig_g)

    ref = jnp.asarray(ca.coords)
    ca_mass = jnp.asarray(ca.masses)
    seg = jnp.asarray(ala.segment_ids())
    nseg = int(seg[-1]) + 1
    ala_mass = jnp.asarray(ala.masses)
    # scan-serialized segment reductions (chosen over a one-hot einsum on
    # the previous accelerator; not yet compared on a GPU)
    msum = jax.ops.segment_sum(ala_mass, seg, num_segments=nseg)

    @jax.jit
    def fn(coords, boxes, invs, times):
        coords = decode_window_coords(coords)

        def per_frame(carry, fr):
            c, b, i = fr
            rmsd, _r, _s = measure.fit_rmsd(c[ca_l], ref, ca_mass)
            x = c[ala_l]
            com = (
                jax.ops.segment_sum(x * ala_mass[:, None], seg,
                                    num_segments=nseg)
                / msum[:, None]
            )
            d = x - com[seg]
            g2 = jax.ops.segment_sum(
                jnp.sum(d * d, -1) * ala_mass, seg, num_segments=nseg
            ) / msum
            pairs, dist, cnt, ofl = neighbor.contact_pairs_dense(
                c, ala_l, lig_l, cutoff=cutoff, box=b, inv=i,
                max_pairs=1 << 14,
            )
            return carry, (rmsd, jnp.sqrt(g2), cnt, ofl)

        return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

    n, el, outs = _timed_stream(fn, xtc, window, runner, subset=subset)
    rmsd = np.concatenate([np.asarray(o[0]).ravel() for o in outs])
    gyr = np.concatenate([np.asarray(o[1]) for o in outs])
    cnt = np.concatenate([np.asarray(o[2]).ravel() for o in outs])
    ofl = np.concatenate([np.asarray(o[3]).ravel() for o in outs])
    if ofl.any():
        raise RuntimeError("fused workload overflowed its pair capacity")
    if cnt.sum() == 0:
        raise RuntimeError("fused workload found ZERO contacts — trivially "
                           "empty accumulation")
    return n, el, {
        "check": float(rmsd.mean()),
        "check_com": float(gyr.mean(axis=1).mean()),
        "check_contacts": float(cnt.mean()),
    }


def wl_sasa(system, xtc, window):
    """Per-residue SASA time series — EXACT device Lee-Richards, neighbor
    lists rebuilt ON DEVICE every frame (sasa_lr.neighbor_lists_device).

    Round-2 ran host Verlet lists (skin 0.3): the host rebuild cost seconds
    and fired on ~7/8 windows, and the fat skin tripled K (the union-sort
    width). The round-3 form builds skin=0 lists inside the scanned window
    program — no host syncs, no drift checks, ~3x smaller K.
    """
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import neighbor, sasa_lr

    sel = system("resname ALA")
    radii_np = sel.topology.vdw()[sel.indices].astype(np.float64) + 0.14
    radii = jnp.asarray(radii_np, jnp.float32)
    seg = jnp.asarray(sel.segment_ids())
    nseg = int(seg[-1]) + 1
    idx = jnp.asarray(sel.indices)

    extents = system.state.box.box_extents()
    cut = 2 * float(radii_np.max())
    dims = neighbor.grid_dims(extents, cut)
    inv = np.diag(1.0 / np.asarray(extents, np.float64))

    # Frame-0 exact counts size the static caps; overflow escalates tiers.
    c0 = system.state.coords[np.asarray(idx)].astype(np.float64)
    nb0, _ = sasa_lr.neighbor_lists(c0, radii_np, cap=1024, skin=0.0)
    k0 = int((nb0 >= 0).sum(1).max())
    cell0, _, _ = neighbor.estimate_caps(c0, inv, dims, margin=1.0, round_to=1)
    total0 = int((nb0 >= 0).sum())

    def build_fn(tier):
        gr = 1.5**tier
        k_cap = (int(k0 * 1.25 * gr) + 15) // 16 * 16
        cell_cap = (int(cell0 * 1.25 * gr) + 7) // 8 * 8
        max_pairs = 1 << max(int(np.ceil(np.log2(total0 * 1.5 * gr))), 12)

        @jax.jit
        def fn(coords, boxes, invs, times):
            coords = decode_window_coords(coords)
            def per_frame(carry, x):
                # Subset transport: x is already the selection's rows.
                nbr, ofl = sasa_lr.neighbor_lists_device(
                    x, radii, extents, dims, cell_cap, k_cap, max_pairs
                )
                areas = sasa_lr.sasa(x, radii, nbr, n_slices=32, block=1024)
                return carry, (
                    jax.ops.segment_sum(areas, seg, num_segments=nseg),
                    ofl,
                )
            return jax.lax.scan(per_frame, 0, coords)[1]

        return fn

    fns = {0: build_fn(0)}
    for tier in range(3):
        fn = fns.setdefault(tier, build_fn(tier))
        sub = np.asarray(idx)
        warmed = set()
        for coords, *_ in _windows(xtc, window, sub):
            if len(coords) not in warmed:
                warmed.add(len(coords))
                jax.block_until_ready(fn(jax.device_put(coords), None, None, None))
        n = 0
        outs = []
        t0 = time.perf_counter()
        for coords, boxes, invs, times, ids in _windows(xtc, window, sub):
            outs.append(fn(jax.device_put(coords), None, None, None))
            n += len(ids)
        jax.block_until_ready(outs)
        el = time.perf_counter() - t0
        if not any(bool(np.any(np.asarray(o[1]))) for o in outs):
            # Self-check: mean per-frame TOTAL area (native wl_sasa's
            # "check"); a ~zero total means the neighbor lists or slicing
            # silently collapsed — fail loudly instead of benchmarking it.
            tot = np.concatenate([np.asarray(o[0]) for o in outs]).sum(axis=1)
            if not np.all(tot > 0):
                raise RuntimeError("sasa workload produced a zero-area frame "
                                   "— trivially empty accumulation")
            return n, el, {"check": float(tot.mean())}
        print(f"#   sasa: capacity overflow at tier {tier}, escalating",
              file=sys.stderr)
    raise RuntimeError("sasa workload still overflows at the largest tier")


def wl_trjconv(system, xtc):
    """The reference's trjconv workload (comparison_small.rs:44-57): stream
    the XTC, write the protein selection to DCD per frame. Host-IO-bound by
    design — it measures the decode/write path, not the device. Uses the
    io.trjconv prefix-decode fast path (protein-first topology: only
    max(sel)+1 of the atoms are ever decoded)."""
    from molar_tpu.io.trjconv import trjconv

    sel = system("resname ALA")
    out_path = os.path.join(tempfile.mkdtemp(prefix="molar_trjconv_"), "out.dcd")
    # Best of 3: this row runs right after the device workloads, whose
    # runtime threads can still share the host cores with the first rep.
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        n = trjconv(xtc, out_path, sel.indices)
        el = time.perf_counter() - t0
        best = el if best is None else min(best, el)
    # Self-check: the written artifact itself — main() reads this DCD back
    # and compares coordinates against the native denominator's DCD.
    return n, best, {"dcd_path": out_path}


def wl_membrane(n_frames=8, shards=0, device=False, window=8, nx=6, ny=6,
                stash_key=None, engine="device"):
    # tiny flat bilayer, host pipeline (frames shard across chips via the
    # frame mesh in multi-chip deployments; single-process here).
    # ``shards > 1`` runs the multi-chip execution shape in-process: the
    # frame stream splits into contiguous slices, one Membrane replica per
    # shard consumes its slice, and the per-group Welford statistics fold
    # together exactly via Membrane.merge_stats_from (SURVEY §2.7 row
    # "multi-chip"; the wall-clock here is serial — one host — but the
    # numbers prove the sharded execution path end-to-end).
    from molar_tpu import PeriodicBox, System
    from molar_tpu.core.atom import Atom
    from molar_tpu.core.state import State
    from molar_tpu.core.topology import Topology
    from molar_tpu.membrane import Membrane

    spacing, z_mid = 0.8, 3.0
    atoms, coords = [], []
    rid = 0
    for leaflet, zdir in ((0, 1.0), (1, -1.0)):
        for i in range(nx):
            for j in range(ny):
                rid += 1
                x, y = i * spacing, j * spacing
                for k, nm in enumerate(["P", "G", "C1", "C2", "C3", "C4"]):
                    atoms.append(Atom(name=nm, resname="LIP", resid=rid,
                                      atomic_number=6, mass=12.0))
                    # head planes 3.0 nm apart: the 2.0 nm patch cutoff must
                    # stay in-leaflet, else the |f|>0.5 fit check invalidates
                    # every lipid and the stats are empty (round-3 geometry
                    # had the leaflets 1.8 nm apart — a silent workload bug)
                    coords.append([x, y, z_mid + zdir * (1.5 - 0.3 * k)])
    top = Topology.from_atoms(atoms)
    top.assign_resindex()
    st = State(coords=np.asarray(coords, np.float32),
               box=PeriodicBox(np.diag([nx * spacing, ny * spacing, 6.0]).astype(np.float32)))
    system = System(top, st)
    outdir = tempfile.mkdtemp(prefix="membr_")
    toml = f"""
sel = "all"
cutoff = 2.0
order_type = "scdcorr"
output_dir = "{outdir}"
groups = ["all"]

[lipids.LIP]
whole = "resname LIP"
head = "name P"
mid = "name G"
tails = ["C1-C2-C3-C4"]
"""
    rng = np.random.default_rng(0)
    base = system.state.coords.copy()
    frames = [
        base + rng.normal(0, 0.01, base.shape).astype(np.float32)
        for _ in range(n_frames)
    ]
    if device:
        # Window-batched jitted pipeline (membrane/device.py): one device
        # dispatch per `window` frames; host does only the Welford update.
        import jax

        from molar_tpu.membrane.device import MembraneDevice

        memb = Membrane(system, toml)
        memb.add_ids_to_group("all", range(len(memb.lipids)))
        dev = MembraneDevice(memb, engine=engine)
        _MEMBRANE_RUNS[stash_key or "membrane_dev"] = (dev, frames)
        wins = [
            np.stack([c[dev.subset] for c in frames[s : s + window]])
            for s in range(0, n_frames, window)
        ]
        for w in {w.shape[0] for w in wins}:  # compile every window shape
            if engine == "device":
                jax.block_until_ready(
                    dev._window_fn(wins[0][:w], np.ones((w, 3), np.float32))
                )
            else:
                # cpu/auto engines place inputs inside compute_window —
                # warming _window_fn directly would compile the WRONG
                # backend's executable
                dev.compute_window(wins[0][:w])
        if engine != "device":
            print(f"# membrane engine={dev.engine_resolved}", file=sys.stderr)
        t0 = time.perf_counter()
        outs = [dev.compute_window(w) for w in wins]
        for o in outs:
            dev.accumulate(o)
        memb.finalize()
        return n_frames, time.perf_counter() - t0, _membrane_device_checks(dev, outs)
    # Host paths stash a MembraneDevice too — it carries the serialized
    # problem (_write_membrane_native) so the native denominator runs on
    # the exact same frames this row processed.
    from molar_tpu.membrane.device import MembraneDevice

    if shards > 1:
        membs = []
        for s in range(shards):
            m = Membrane(system, toml)
            m.add_ids_to_group("all", range(len(m.lipids)))
            membs.append(m)
        _MEMBRANE_RUNS[stash_key or "membrane"] = (MembraneDevice(membs[0]), frames)
        t0 = time.perf_counter()
        per = (n_frames + shards - 1) // shards
        for s, m in enumerate(membs):
            for c in frames[s * per : (s + 1) * per]:
                system.state.coords = c
                m.compute()
        root = membs[0]
        for m in membs[1:]:
            root.merge_stats_from(m)
        root.finalize()
        return n_frames, time.perf_counter() - t0, _membrane_host_checks(root)
    memb = Membrane(system, toml)
    memb.add_ids_to_group("all", range(len(memb.lipids)))
    _MEMBRANE_RUNS[stash_key or "membrane"] = (MembraneDevice(memb), frames)
    t0 = time.perf_counter()
    for c in frames:
        system.state.coords = c
        memb.compute()
    memb.finalize()
    return n_frames, time.perf_counter() - t0, _membrane_host_checks(memb)


_MEMBRANE_RUNS = {}  # row name -> (MembraneDevice, frames) of device runs

# Device-vs-native check tolerances. The streams are bit-identical f32 XTC
# decodes on both sides; differences are accumulation order + f32-vs-f64
# arithmetic. Calibrated on CPU-backend runs (see tests/test_workload_checks
# .py); accelerator kernels hold the same bounds because the hot paths use
# elementwise or HIGHEST-precision math (no TF32 matmuls).
CHECK_RTOL = {"ca_rmsd": 2e-3, "com_splits": 2e-3, "contacts": 2e-3,
              "sasa": 2e-3}
MEMBRANE_TOL = {  # label -> (rtol, atol); curvature is ~0 on flat bilayers,
    "check_area": (1e-2, 0.0),  # so those bounds are atol-led
    "check_mean": (5e-2, 5e-4),
    "check_order": (5e-2, 2e-3),
}


def _membrane_device_checks(dev, outs_list):
    """Reduce a device run's window outputs to the scalars
    benchmarks/native_membrane.cpp emits (check_area / check_mean /
    check_order: means over frames x VALID lipids), failing loudly on an
    empty accumulation — the rounds-1-3 silent-empty-stats failure mode."""
    n_valid = 0
    a_sum = m_sum = o_sum = 0.0
    o_n = 0
    for o in outs_list:
        v = np.asarray(o["valid"], bool)  # (B, L)
        n_valid += int(v.sum())
        a_sum += float(np.asarray(o["area"])[v].sum())
        m_sum += float(np.asarray(o["mean_curv"])[v].sum())
        for sp in dev.species_names:
            vsp = v[:, dev._sp_lipids[sp]]  # (B, n_sp)
            for t in o["order"][sp]:
                t = np.asarray(t)
                o_sum += float(np.where(vsp[..., None], t, 0.0).sum())
                o_n += int(vsp.sum()) * t.shape[-1]
    if n_valid == 0:
        raise RuntimeError(
            "membrane workload: ZERO valid lipids across the whole stream — "
            "trivially empty accumulation; the fps would measure nothing"
        )
    return {"check_area": a_sum / n_valid, "check_mean": m_sum / n_valid,
            "check_order": (o_sum / o_n) if o_n else 0.0}


def _membrane_host_checks(memb):
    """The host pipeline's equivalents of the native check scalars, from the
    group Welford statistics (per-frame means of per-lipid means; equal to
    the native global means when the valid-lipid count is constant, which
    the flat synthetic bilayer guarantees)."""
    gr = memb.groups["all"]
    assert len(gr.per_species) == 1, "workload bilayers are single-species"
    st = next(iter(gr.per_species.values()))
    if st["count"].n == 0 or float(st["count"].mean) == 0.0:
        raise RuntimeError(
            "membrane workload: ZERO valid lipids across the whole stream — "
            "trivially empty accumulation; the fps would measure nothing"
        )
    order = 0.0
    if st["order"]:
        order = float(np.mean([np.mean(s.mean) for s in st["order"]]))
    return {"check_area": float(np.mean(st["area"].mean)),
            "check_mean": float(np.mean(st["mean_curv"].mean)),
            "check_order": order}


def _compare_dcd(dev_path, nat_path):
    """Max abs coordinate difference (nm) between two written DCDs — the
    trjconv rows are verified on the artifact itself, not a side scalar."""
    from molar_tpu.io.dcd import DcdHandler

    a, b = DcdHandler(dev_path), DcdHandler(nat_path)
    try:
        if a.n_frames != b.n_frames or a.n_atoms != b.n_atoms:
            return float("inf")
        md = 0.0
        for k in range(a.n_frames):
            ca = a.read_frame(k).coords
            cb = b.read_frame(k).coords
            md = max(md, float(np.abs(ca - cb).max()))
        return md
    finally:
        a.close()
        b.close()


def _write_membrane_native(dev, frames, path):
    """Sidecar for benchmarks/native_membrane.cpp: the device pipeline's
    static structure (single-species membranes) + the exact frames."""
    import struct

    sp = dev.species_names[0]
    tails = dev._sp_tails[sp]
    tl, orders = tails[0]
    with open(path, "wb") as f:
        def i32(v):
            f.write(struct.pack("<i", int(v)))

        def ivec(a):
            a = np.ascontiguousarray(a, np.int32)
            i32(a.size)
            f.write(a.tobytes())

        i32(0x4D454D42)
        n_atoms = len(dev.subset)
        i32(n_atoms)
        i32(dev.n_lipids)
        i32(len(frames))
        ivec(dev._first)
        ivec(dev._atom_first)
        f.write(np.ascontiguousarray(dev._masses, np.float32).tobytes())
        for idx, seg in (dev._head, dev._mid, dev._tail):
            ivec(idx)
            ivec(seg)
        i32(tl.shape[1])
        ivec(tl)
        ivec(np.asarray(orders))
        opt = dev.options
        box = np.diag(
            np.asarray(dev.membrane.system.state.require_box().matrix)
        )
        code = {"sz": 0, "scd": 1, "scdcorr": 2}[opt.order_type]
        f.write(
            np.asarray(
                [opt.cutoff, box[0], box[1], box[2],
                 opt.max_smooth_iter, opt.n_shells_smoothing, code],
                np.float32,
            ).tobytes()
        )
        w = np.stack([c[dev.subset] for c in frames]).astype(np.float32)
        f.write(np.ascontiguousarray(w).tobytes())


def run_native_membrane(dev, frames):
    """Build + run the single-core native membrane denominator on the same
    frames; returns the parsed JSON result dict (or None without g++)."""
    import subprocess

    from molar_tpu.native import NativeBuildError, build_executable

    here = os.path.dirname(os.path.abspath(__file__))
    try:
        exe = str(build_executable(
            "native_membrane", [os.path.join(here, "native_membrane.cpp")]
        ))
    except NativeBuildError:
        return None
    path = os.path.join(tempfile.mkdtemp(prefix="memb_nat_"), "memb.bin")
    _write_membrane_native(dev, frames, path)
    out = subprocess.run([exe, path], check=True, capture_output=True,
                         text=True)
    return json.loads(out.stdout)


def _write_native_meta(system, path):
    """Sidecar consumed by benchmarks/native_workloads.cpp: the exact same
    selections/masses/radii/segments the device workloads use, so the
    single-core native denominator measures the identical problem."""
    import struct

    ca = system("name CA")
    sel = system("resname ALA")
    lig = system("name OW")
    lig_idx = lig.indices[:50]
    seg = sel.segment_ids()
    radii = sel.topology.vdw()[sel.indices].astype(np.float32) + 0.14
    box = np.diag(np.asarray(system.state.box.matrix)).astype(np.float32)
    with open(path, "wb") as f:
        def i32(v):
            f.write(struct.pack("<i", int(v)))

        def arr(a, dt):
            f.write(np.ascontiguousarray(a, dt).tobytes())

        i32(0x4D4F4C41)
        i32(system.n_atoms)
        i32(len(ca))
        arr(ca.indices, np.int32)
        arr(ca.coords, np.float32)
        arr(ca.masses, np.float32)
        i32(len(sel))
        arr(sel.indices, np.int32)
        arr(seg, np.int32)
        i32(int(seg[-1]) + 1)
        arr(sel.masses, np.float32)
        arr(radii, np.float32)
        i32(len(lig_idx))
        arr(lig_idx, np.int32)
        arr(box, np.float32)
        arr(np.float32(0.4), np.float32)
        i32(32)


def _native_exe():
    from molar_tpu.native import NativeBuildError, build_executable

    here = os.path.dirname(os.path.abspath(__file__))
    try:
        return str(build_executable(
            "native_workloads",
            [os.path.join(here, "native_workloads.cpp"),
             os.path.join(here, "..", "molar_tpu", "native", "xtc_codec.cpp")],
        ))
    except NativeBuildError:
        return None


def run_native(system, xtc, which="all", dcd_out=None):
    """Single-core native denominators (run strictly AFTER device timing,
    so they never compete with the pipeline's host threads). Returns
    {workload: result dict}."""
    import subprocess

    exe = _native_exe()
    if exe is None:
        return {}
    meta = xtc + ".meta"
    if not os.path.exists(meta):
        _write_native_meta(system, meta)
    cmd = [exe, which, xtc, meta, "0", dcd_out or xtc + ".native.dcd"]
    out = subprocess.run(cmd, check=True, capture_output=True, text=True)
    res = {}
    for line in out.stdout.splitlines():
        r = json.loads(line)
        res[r["workload"]] = r
    return res


ROWS = ["ca_rmsd", "com_splits", "contacts", "fused", "sasa", "membrane",
        "membrane_dev", "membrane_auto", "membrane_large", "trjconv"]


def _parse_which(text):
    rows = ROWS if text == "all" else text.split(",")
    unknown = [r for r in rows if r not in ROWS]
    if unknown:
        raise argparse.ArgumentTypeError(
            f"unknown workload(s) {unknown}; choose from all,{','.join(ROWS)}"
        )
    return rows


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--files", nargs=2, metavar=("STRUCTURE", "XTC"))
    ap.add_argument("--atoms", type=int, default=50_000)
    ap.add_argument("--protein", type=int, default=4_000)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--window", type=int, default=0,
                    help="execute window (frames) for the streamed "
                    "workloads; 0 = auto-size per workload from its subset "
                    "wire bytes (dispatch-bound tiny selections get big "
                    "windows, full-frame streams get 16)")
    ap.add_argument("--which", default=list(ROWS), type=_parse_which,
                    help="'all' or a comma-separated list of: "
                    + ",".join(ROWS))
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend; every line is "
                    "labelled cpu and carries no device metric")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard each window's frame axis over N devices "
                    "(ca_rmsd/com_splits/contacts stream sharded; membrane "
                    "runs N replicas merged via merge_stats_from); fails if "
                    "fewer devices exist")
    ap.add_argument("--no-native", action="store_true", dest="no_native",
                    help="skip the single-core native denominators "
                    "(benchmarks/native_workloads.cpp; they run strictly "
                    "after the device loop) and with them the checks")
    return ap


def run(argv=None):
    """Run the selected rows; returns (rows dict, check failure list).

    Each row's entry holds frames, seconds, the rate and, unless
    ``--no-native``, the ``*_ok`` verdicts of its checks against the
    native twin."""
    args = build_parser().parse_args(argv)

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from molar_tpu.utils.runtime import (
        device_label,
        enable_compile_cache,
        require_gpu,
    )

    enable_compile_cache()
    if not args.cpu:
        require_gpu()
    device = device_label()
    # A CPU rehearsal never reports under the device metric's name.
    rate_key = "cpu_rehearsal_fps" if args.cpu else "fps"

    runner = None
    if args.mesh:
        from molar_tpu.parallel.mesh import MeshWindowRunner, frame_mesh

        runner = MeshWindowRunner(frame_mesh(args.mesh))
        print(f"# mesh: {runner.n} device(s)", file=sys.stderr)

    from molar_tpu import System

    if args.files:
        system = System.from_file(args.files[0])
        xtc = args.files[1]
    else:
        system = _synth_system(args.atoms, args.protein)
        xtc = os.path.join(tempfile.mkdtemp(prefix="molar_wl_"), "traj.xtc")
        _write_xtc(system, xtc, args.frames)

    jobs = {
        "ca_rmsd": lambda: wl_ca_rmsd(system, xtc, args.window, runner),
        "com_splits": lambda: wl_com_splits(system, xtc, args.window, runner),
        "contacts": lambda: wl_contacts(system, xtc, args.window, runner),
        # the three rows above in ONE window program / one dispatch —
        # against a native twin that also decodes each frame exactly once
        "fused": lambda: wl_fused(system, xtc, args.window, runner),
        # sasa is compute-bound — dispatch overhead is noise there; keep the
        # 16-frame window (auto-sizing would only grow the compile)
        "sasa": lambda: wl_sasa(system, xtc, args.window or 16),
        "membrane": lambda: wl_membrane(shards=args.mesh),
        "membrane_dev": lambda: wl_membrane(
            n_frames=64, device=True, window=16, stash_key="membrane_dev"
        ),
        # Same 72-lipid problem, engine picked by tasks.engine.pick_engine:
        # "the best engine by default" row.
        "membrane_auto": lambda: wl_membrane(
            n_frames=64, device=True, window=16, stash_key="membrane_auto",
            engine="auto",
        ),
        # scale row: 4608 lipids — where the batched device pipeline
        # separates from scalar per-lipid loops (72 lipids are host-scale,
        # like the 265-atom align workload)
        "membrane_large": lambda: wl_membrane(
            n_frames=32, device=True, window=8, nx=48, ny=48,
            stash_key="membrane_large",
        ),
        "trjconv": lambda: wl_trjconv(system, xtc),
    }
    out = {}
    checks = {}
    for name in args.which:
        n, el, chk = jobs[name]()
        checks[name] = chk
        out[name] = {"device": device, "frames": n, "sec": el,
                     rate_key: n / el if el > 0 else None}
        print(json.dumps({name: out[name]}), flush=True)

    # Native single-core denominators, strictly after all device work.
    failures = []
    if not args.no_native and not args.files:
        native_map = {"ca_rmsd": "ca_rmsd", "com_splits": "com_gyr",
                      "contacts": "contacts", "fused": "fused",
                      "sasa": "sasa", "trjconv": "trjconv"}
        # membrane rows have their own denominator binary; don't run the
        # scalar natives for them
        wanted = [native_map[r] for r in args.which if r in native_map]
        which = (wanted[0] if len(wanted) == 1
                 else "all" if wanted else "none")
        nat_dcd = xtc + ".native.dcd"
        try:
            nat = run_native(system, xtc, which, dcd_out=nat_dcd)
        except Exception as e:  # denominator failure must not kill the run
            print(f"# native denominators failed: {e}", file=sys.stderr)
            nat = {}

        def verify(row, dev_val, nat_val, rtol, atol, label="check"):
            ok = abs(dev_val - nat_val) <= atol + rtol * abs(nat_val)
            out[row][f"{label}_dev"] = float(f"{dev_val:.6g}")
            out[row][f"{label}_native"] = float(f"{nat_val:.6g}")
            out[row][f"{label}_ok"] = bool(ok)
            if not ok:
                failures.append(
                    f"{row}/{label}: device {dev_val:.6g} vs native "
                    f"{nat_val:.6g} (rtol {rtol:g} atol {atol:g})"
                )

        def vs_native(row, native_fps):
            out[row]["native_fps"] = native_fps
            if out[row][rate_key]:
                out[row]["vs_native"] = out[row][rate_key] / native_fps
                if args.cpu:
                    out[row]["cpu_rehearsal_vs_native"] = out[row].pop(
                        "vs_native")

        for dev_name, nat_name in native_map.items():
            if nat_name in nat and dev_name in out:
                r = nat[nat_name]
                vs_native(dev_name, r["fps"])
                # Float-precision output verification against the native
                # denominator's check scalar — a row that cannot match is a
                # row whose fps measures the wrong (or empty) computation.
                if dev_name == "trjconv":
                    md = _compare_dcd(checks[dev_name]["dcd_path"], nat_dcd)
                    verify(dev_name, md, 0.0, 0.0, 1e-6, label="dcd_maxdiff")
                elif dev_name == "fused":
                    verify(dev_name, checks[dev_name]["check"], r["check"],
                           CHECK_RTOL["ca_rmsd"], 0.0)
                    verify(dev_name, checks[dev_name]["check_com"],
                           r["check_com"], CHECK_RTOL["com_splits"], 0.0,
                           label="check_com")
                    verify(dev_name, checks[dev_name]["check_contacts"],
                           r["check_contacts"], CHECK_RTOL["contacts"], 0.0,
                           label="check_contacts")
                else:
                    rtol = CHECK_RTOL[dev_name]
                    verify(dev_name, checks[dev_name]["check"], r["check"],
                           rtol, 0.0)
        # Membrane denominators run on the exact frames each row saw.
        for key, stash in _MEMBRANE_RUNS.items():
            if key not in out:
                continue
            try:
                r = run_native_membrane(*stash)
            except Exception as e:
                print(f"# native membrane failed: {e}", file=sys.stderr)
                continue
            if not r:
                continue
            nat["native_" + key] = r
            vs_native(key, r["fps"])
            for lbl, (rtol, atol) in MEMBRANE_TOL.items():
                verify(key, checks[key][lbl], r[lbl], rtol, atol, label=lbl)
        if nat:
            print(json.dumps({"device": device, "native_1core": {
                k: v["fps"] for k, v in nat.items()}}), flush=True)
            print(json.dumps({"device": device, "checks": {
                k: {c: v[c] for c in v if "check" in c or "maxdiff" in c}
                for k, v in out.items()}}), flush=True)
    return out, failures


def main(argv=None) -> int:
    out, failures = run(argv)
    if failures:
        device = next(iter(out.values()))["device"]
        print(json.dumps({"device": device, "check_failures": failures}),
              flush=True)
        print("CHECK FAILURES — the rates above measure the WRONG "
              "computation:", file=sys.stderr)
        for f in failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
