#!/usr/bin/env python
"""Headline benchmark: RMSD fit + 0.5 nm PBC distance search, 100k atoms.

Reproduces the BASELINE.json metric — per-frame Kabsch fit of a protein-like
selection plus a 0.5 nm within-cutoff PBC cell-grid search of all atoms
against that selection, streamed from an XTC file — and prints ONE json line:

    {"metric": ..., "value": N, "unit": "frames/sec/chip", "vs_baseline": N,
     "device": {"platform": ..., "kind": ..., "count": N}, ...}

``vs_baseline`` is measured against a single-core C++ reimplementation of the
same per-frame work (benchmarks/native_baseline.cpp, this build's stand-in
for single-core MolAR; the BASELINE target is 50x that throughput).

The run needs a GPU and fails at once without one. ``--cpu`` rehearses the
same path on the CPU backend; its output says ``"platform": "cpu"`` and its
rate is reported under ``cpu_rehearsal_fps``, never under the device metric.

Usage: python bench.py [--atoms N] [--frames N] [--window B] [--quick] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def make_system(n_atoms: int, n_protein: int, box_side: float, seed: int = 0):
    """Synthetic solvated-protein-like system at realistic uniform density
    (~100 atoms/nm^3): a compact uniform-density ball of 'protein' atoms in
    the middle of a water box."""
    rng = np.random.default_rng(seed)
    n_water = n_atoms - n_protein
    water = rng.uniform(0, box_side, (n_water, 3)).astype(np.float32)
    density = n_atoms / box_side**3
    radius = (3 * n_protein / (4 * np.pi * density)) ** (1 / 3)
    d = rng.normal(size=(n_protein, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = radius * rng.uniform(0, 1, (n_protein, 1)) ** (1 / 3)
    protein = (box_side / 2 + d * r).astype(np.float32)
    coords = np.concatenate([protein, water])
    masses = rng.uniform(1.0, 16.0, n_atoms).astype(np.float32)
    return coords, masses


def make_trajectory(path: str, coords0: np.ndarray, box: np.ndarray, n_frames: int,
                    sigma: float = 0.02, seed: int = 1) -> None:
    from molar_tpu.io.xtc import XtcHandler

    rng = np.random.default_rng(seed)
    w = XtcHandler(path, "w")
    c = coords0.copy()
    for k in range(n_frames):
        c = c + rng.normal(0, sigma, c.shape).astype(np.float32)
        w.write_raw(c, box, step=k, time=float(k))
    w.close()


def caps_schedule(xtc_path, box, tgt_idx, dims):
    """Capacity tiers from a frame-0 cell-occupancy estimate.

    NOT a trajectory pre-pass: streaming workloads can't afford one — drift
    beyond the safety margin is absorbed by the overflow-retry loop
    (tasks.trajectory.run_with_overflow_retry). Tier 0 is frame-0 occupancy
    plus a ~20% diffusion margin; each tier grows it x1.5. Rounding to
    multiples of 8 keeps the static shapes (and the compile-cache key)
    stable run to run. Returns ``caps_for(tier) -> (cap, tcap, cells)``."""
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.ops.neighbor import estimate_caps

    h = XtcHandler(xtc_path, "r")
    c0 = h.read_frame(0).coords
    h.close()
    cap0, tcap0, need_cells0 = estimate_caps(
        c0, box.inv, dims, tgt_idx, margin=1.0, round_to=1
    )

    def caps_for(tier: int):
        g = 1.5**tier
        cap = (int(cap0 * 1.2 * g) + 2 + 7) // 8 * 8
        tcap = (int(tcap0 * 1.2 * g) + 2 + 7) // 8 * 8
        cells = max(512, (int(need_cells0 * 1.25 * g) + 255) // 256 * 256)
        return cap, tcap, cells

    return caps_for


def make_build_fn(ref_coords, pmasses, protein_idx, n_atoms, cutoff, dims,
                  caps_for, log=None):
    """``build_fn(tier)`` -> the jitted headline window program.

    Per frame: Kabsch fit + RMSD of the protein selection (scope
    ``fit_rmsd``) and the within-cutoff search of all atoms against it
    (scope ``within_mask``), plus a uint32 identity checksum of the matched
    set. Returns ``(rmsd, count, checksum, overflow)`` per frame."""
    import jax
    import jax.numpy as jnp

    from molar_tpu.ops import measure, neighbor
    from molar_tpu.tasks.trajectory import decode_window_coords

    ref_j = jnp.asarray(ref_coords)
    pm_j = jnp.asarray(pmasses)
    pidx_j = jnp.asarray(protein_idx)
    aidx_j = jnp.arange(n_atoms)

    def build_fn(tier: int):
        cap, tcap, max_tgt_cells = caps_for(tier)
        if log:
            log(f"caps tier{tier}: cap={cap} tcap={tcap} tgt_cells={max_tgt_cells}")

        @jax.jit
        def window_fn(coords, boxes, invs, times):
            # Quantized/delta transport: exact int reconstruction x scale is
            # bit-identical to the f32 decode at a half / quarter of the
            # host-to-device bytes.
            coords = decode_window_coords(coords)

            def per_frame(carry, frame):
                c, b, i = frame
                with jax.named_scope("fit_rmsd"):
                    # Three 1-D gathers instead of one (n, 3) row gather.
                    sel = jnp.stack(
                        [c[:, 0][pidx_j], c[:, 1][pidx_j], c[:, 2][pidx_j]],
                        axis=-1,
                    )
                    rmsd, _, _ = measure.fit_rmsd(sel, ref_j, pm_j)
                with jax.named_scope("within_mask"):
                    # src_idx=None: the source set is ALL atoms, so the three
                    # (n,) identity source gathers are elided.
                    mask, overflow = neighbor.within_mask(
                        c, None, pidx_j, cutoff=cutoff, box=b, inv=i,
                        dims=dims, cap=cap, tgt_cap=tcap,
                        max_tgt_cells=max_tgt_cells,
                    )
                # Identity checksum (uint32 wraparound weighted sum): catches
                # any per-frame membership difference, not just the count.
                chk = jnp.sum(
                    jnp.where(mask, (aidx_j + 1).astype(jnp.uint32), 0),
                    dtype=jnp.uint32,
                )
                return carry, (rmsd, jnp.sum(mask), chk, overflow)

            # lax.scan over the window: one compiled frame body instead of a
            # B-wide vmapped graph (compile cost = one body).
            _, (rmsd, cnt, chk, ofl) = jax.lax.scan(
                per_frame, 0, (coords, boxes, invs)
            )
            return rmsd, cnt, chk, ofl

        return window_fn

    return build_fn


def check_frames(xtc_path, cutoff, protein_idx, ref_coords, pmasses,
                 rmsds, counts, checksums, rmsd_rtol=1e-5):
    """Compare device results with the host ground truth on the first,
    middle and last frames.

    Within membership must match exactly (count and uint32 identity
    checksum: counts alone could mask compensating errors); RMSD must hold
    ``rmsd_rtol`` against the f64 numpy Kabsch. Returns (checked frame
    indices, list of mismatch descriptions)."""
    from molar_tpu.core.pbc import PBC_FULL
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.ops import measure_host, neighbor_host

    h = XtcHandler(xtc_path)
    frames = sorted({0, h.n_frames // 2, h.n_frames - 1})
    bad = []
    for k in frames:
        st = h.read_frame(k)
        hostk = neighbor_host.search_within(
            cutoff, st.coords, np.arange(len(st.coords)), protein_idx,
            st.box, PBC_FULL,
        )
        chk_host = np.sum(hostk.astype(np.uint32) + np.uint32(1),
                          dtype=np.uint32)
        if int(counts[k]) != len(hostk):
            bad.append(f"frame {k}: within count {int(counts[k])} vs host "
                       f"{len(hostk)}")
        if np.uint32(checksums[k]) != chk_host:
            bad.append(f"frame {k}: within checksum differs from host")
        mob = st.coords[protein_idx]
        r, t = measure_host.fit_transform(mob, ref_coords, pmasses)
        want = measure_host.rmsd_mw(
            measure_host.apply_transform(mob, r, t), ref_coords, pmasses
        )
        if not np.isclose(float(rmsds[k]), want, rtol=rmsd_rtol, atol=0.0):
            bad.append(f"frame {k}: rmsd {float(rmsds[k]):.8g} vs host "
                       f"{want:.8g} (rtol {rmsd_rtol:g})")
    h.close()
    return frames, bad


def _native_baseline_fps(xtc_path, n_sel, cutoff, max_frames=None):
    """Build (once per source content) and run the single-core C++
    reimplementation of the reference workload
    (benchmarks/native_baseline.cpp). Returns (fps, within0), or
    (None, None) if g++ is unavailable."""
    import subprocess

    from molar_tpu.native import NativeBuildError, build_executable

    try:
        exe = build_executable(
            "native_baseline",
            [os.path.join(HERE, "benchmarks", "native_baseline.cpp"),
             os.path.join(HERE, "molar_tpu", "native", "xtc_codec.cpp")],
        )
    except NativeBuildError:
        return None, None
    cmd = [str(exe), xtc_path, str(n_sel), str(cutoff)]
    if max_frames:
        cmd.append(str(max_frames))
    out = subprocess.run(cmd, check=True, capture_output=True, text=True)
    r = json.loads(out.stdout)
    return float(r["fps"]), int(r["within0"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--atoms", type=int, default=100_000)
    ap.add_argument("--protein", type=int, default=5_000)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--window", type=int, default=0,
                    help="frames per execute window; 0 = auto_window's "
                    "byte-target default (not tuned on a GPU yet)")
    ap.add_argument("--cutoff", type=float, default=0.5)
    ap.add_argument("--box", type=float, default=10.0)
    ap.add_argument("--quick", action="store_true", help="tiny sizes for smoke test")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU backend; the output is "
                    "labelled cpu and carries no device metric")
    ap.add_argument("--transport", choices=["f32", "i16", "delta"],
                    default="delta",
                    help="window transport: plain f32; raw i16 quantized ints "
                    "(half the bytes, bit-exact); or i8 frame-to-frame deltas "
                    "of those ints (roughly quarter the bytes, still "
                    "bit-exact; falls back to i16 when deltas exceed int8)")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed passes over the trajectory; the median and "
                    "the best are both reported")
    ap.add_argument("--ordered", action="store_true",
                    help="stage ALL window transfers before the first "
                    "execute (no put/execute interleaving on the device "
                    "stream; whole pass resident)")
    ap.add_argument("--no-put", action="store_true", dest="no_put",
                    help="skip the explicit per-window device_put; host "
                    "arrays are transferred by the execute call itself")
    ap.add_argument("--put-chunks", type=int, default=1, dest="put_chunks",
                    help="ship each window's bulk coords as N separate "
                    "device_put calls (frame-axis chunks, reassembled "
                    "in-graph), decoupling the transfer size from the "
                    "execute window size")
    ap.add_argument("--queue-depth", type=int, default=2, dest="queue_depth",
                    help="windows in flight (decode+put runs this many "
                    "windows ahead of compute)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard each window's frame axis over N devices "
                    "(shard_map window programs over a 1-D frame mesh; "
                    "0 = single-device); fails if fewer devices exist")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a jax.profiler trace of the first timed "
                    "pass into DIR (inspect with tensorboard or perfetto)")
    ap.add_argument("--host-frames", type=int, default=2,
                    help="frames used to time the single-core numpy baseline")
    args = ap.parse_args()
    if args.quick:
        args.atoms, args.protein, args.frames, args.window = 5000, 500, 32, 8

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

    from molar_tpu.core.pbc import PBC_FULL, PeriodicBox
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.ops import measure_host, neighbor, neighbor_host
    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        _chunk_coords,
        auto_window,
        run_with_overflow_retry,
    )

    def log(msg):
        print(f"# {msg}", file=sys.stderr)

    quant_mode = {"f32": False, "i16": True, "delta": "delta"}[args.transport]

    box = PeriodicBox(np.diag([args.box] * 3).astype(np.float32))
    coords0, masses = make_system(args.atoms, args.protein, args.box)
    protein_idx = np.arange(args.protein)
    all_idx = np.arange(args.atoms)
    ref_coords = coords0[protein_idx]
    pmasses = masses[protein_idx]

    tmpdir = tempfile.mkdtemp(prefix="molar_bench_")
    xtc_path = os.path.join(tmpdir, "traj.xtc")
    t0 = time.perf_counter()
    make_trajectory(xtc_path, coords0, box.matrix, args.frames)
    t_write = time.perf_counter() - t0
    size_mb = os.path.getsize(xtc_path) / 1e6
    log(f"wrote {args.frames} frames ({size_mb:.1f} MB) in {t_write:.1f}s")
    if not args.window:
        args.window = auto_window(xtc_path)
        log(f"auto window={args.window}")

    dims = neighbor.grid_dims(box.box_extents(), args.cutoff)
    caps_for = caps_schedule(xtc_path, box, protein_idx, dims)
    build_fn = make_build_fn(ref_coords, pmasses, protein_idx, args.atoms,
                             args.cutoff, dims, caps_for, log=log)

    reader = TrajectoryReader([xtc_path])

    runner = None
    if args.mesh:
        from molar_tpu.parallel.mesh import MeshWindowRunner, frame_mesh

        runner = MeshWindowRunner(frame_mesh(args.mesh))
        if args.no_put:
            log("--no-put is ignored in mesh mode (sharded windows are "
                "always device_put with frame shardings)")
        log(f"mesh: {runner.n} device(s), frame-sharded windows")

    # Warmup: compile tier 0 with the SAME transport form the timed passes
    # stream (the quantized/delta tuples are a different pytree than plain
    # f32 windows).
    window_fn0 = build_fn(0)
    first = next(iter(reader.iter_windows(args.window, quantized=quant_mode)))
    t0 = time.perf_counter()
    if runner is not None:
        _ = jax.block_until_ready(runner.call(window_fn0, *first[:4]))
    else:
        warm = first[:4]
        if args.put_chunks > 1:
            warm = (_chunk_coords(warm[0], args.put_chunks), *warm[1:])
        _ = jax.block_until_ready(window_fn0(*jax.device_put(warm)))
    compile_s = time.perf_counter() - t0
    log(f"compiled in {compile_s:.1f}s")

    # Timed passes. Each streams at tier 0 and re-runs any overflowed window
    # at escalated capacity tiers (retry time is inside the pass's clock —
    # it is real work).
    built = {0: window_fn0}

    def cached_build(tier):
        if tier not in built:
            built[tier] = build_fn(tier)
        return built[tier]

    import contextlib

    rep_fps = []
    for rep in range(max(args.repeats, 1)):
        prof = (
            jax.profiler.trace(args.profile)
            if args.profile and rep == 0
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with prof:
            results, retried = run_with_overflow_retry(
                reader, args.window, cached_build, n_tiers=4,
                overflow_of=lambda r: r[3], quantized=quant_mode,
                mesh=runner, queue_depth=args.queue_depth,
                device_put=not args.no_put, ordered=args.ordered,
                put_chunks=args.put_chunks,
            )
        elapsed = time.perf_counter() - t0
        n_done = sum(len(ids) for ids, _ in results)
        rep_fps.append(n_done / elapsed)
        log(f"device loop {rep}: {n_done} frames in {elapsed:.3f}s "
            f"({retried} windows retried)")
    rmsds = np.concatenate([np.asarray(r[0]) for _, r in results])
    counts = np.concatenate([np.asarray(r[1]) for _, r in results])
    checksums = np.concatenate([np.asarray(r[2]) for _, r in results])

    # Compute-only rate: the same window program on resident data (no
    # decode, no host-to-device transfer).
    res_win = first[:4]
    if runner is None and args.put_chunks > 1:
        res_win = (_chunk_coords(res_win[0], args.put_chunks), *res_win[1:])
    res_args = jax.device_put(res_win)
    _ = jax.block_until_ready(window_fn0(*res_args))
    t0 = time.perf_counter()
    reps_c = 3
    for _ in range(reps_c):
        jax.block_until_ready(window_fn0(*res_args))
    # Frame count from the times array — first[0] is a transport pytree.
    compute_fps = reps_c * len(first[3]) / (time.perf_counter() - t0)
    log(f"compute-only fps={compute_fps:.2f}")

    # Single-core native baseline: C++ reimplementation of the reference's
    # per-frame algorithm (decode + Kabsch + half-stencil cell search), the
    # measured denominator for the 50x north star. Runs strictly after the
    # device loop so it does not compete with the feeder threads.
    native_fps, native_within0 = _native_baseline_fps(
        xtc_path, args.protein, args.cutoff
    )

    # Secondary: single-core numpy host baseline on a few frames.
    h = XtcHandler(xtc_path)
    n_host = min(args.host_frames, h.n_frames)
    t0 = time.perf_counter()
    for k in range(n_host):
        st = h.read_frame(k)
        r, t = measure_host.fit_transform(st.coords[protein_idx], ref_coords, pmasses)
        fitted = measure_host.apply_transform(st.coords[protein_idx], r, t)
        _ = measure_host.rmsd_mw(fitted, ref_coords, pmasses)
        _ = neighbor_host.search_within(
            args.cutoff, st.coords, all_idx, protein_idx, st.box, PBC_FULL
        )
    host_fps = n_host / (time.perf_counter() - t0)
    h.close()

    check_idx, mismatches = check_frames(
        xtc_path, args.cutoff, protein_idx, ref_coords, pmasses,
        rmsds, counts, checksums,
    )
    native_parity = (
        abs((native_within0 or 0) - int(counts[0])) if native_fps else None
    )
    for m in mismatches:
        log(f"PARITY: {m}")
    log(f"native(1-core C++) fps={native_fps} numpy(1-core) fps={host_fps:.2f} "
        f"mean_rmsd={rmsds.mean():.4f} within0={int(counts[0])} "
        f"native_parity_diff={native_parity}")

    best = max(rep_fps)
    median = float(np.median(rep_fps))
    denom = native_fps if native_fps else host_fps
    rate_key = "cpu_rehearsal_fps" if args.cpu else "value"
    result = {
        "metric": "frames/sec/chip: RMSD fit + 0.5 nm PBC distance search, "
        f"{args.atoms // 1000}k-atom system",
        "device": device,
        rate_key: median,
        "unit": "frames/sec/chip",
        "best_fps": best,
        "repeat_fps": rep_fps,
        "vs_baseline": median / denom,
        "compute_only_fps": compute_fps,
        "compile_s": compile_s,
        "window": args.window,
        "baseline_native_1core_fps": native_fps,
        "baseline_numpy_1core_fps": host_fps,
        "windows_retried": retried,
        "parity_frames_checked": check_idx,
        "parity_mismatches": mismatches,
    }
    if args.cpu:
        result["value"] = result["vs_baseline"] = None
    print(json.dumps(result))
    ok = not mismatches and (native_parity in (0, None))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
