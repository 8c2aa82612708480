#!/usr/bin/env python
"""Smoke run of the windowed trajectory pipeline on one GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the frame-mesh phase only

Everything runs in ONE process, which opens the card once (a second JAX
process would fail for want of device memory). Each phase prints one JSON
line; any failure raises, exits non-zero and never prints the ``"ok"`` line.

* device    — JAX must report platform ``gpu`` (no CPU fallback); prints the
  device kind and count, the JAX version, ``XLA_FLAGS`` and the card's name
  and power limit from ``nvidia-smi``.
* parity    — tests/test_device_parity.py, in this process, all passing.
* headline  — the bench.py path at 100k atoms (5k protein, 10 nm cubic box,
  0.5 nm cutoff, 64 XTC frames from a seed): ``run_with_overflow_retry``
  with delta transport, checked against the host on the first, middle and
  last frames (within membership exact, RMSD to 1e-5); then
  examples/rmsd_trajectory.py on the same files through ``main()``. Prints
  compile and steady seconds, peak device memory and the ``within_mask``
  stage's device time from one profiler trace.
* workloads — one pass of each benchmarks/workloads.py row at its default
  sizes, each passing its own check against its native twin; then the
  membrane window at 72 and 4608 lipids on the device and the CPU engine.
* multi (``--multi`` only) — the headline stream over a 4-device frame mesh
  against the single-device run (within bit-identical, RMSD to 1e-5), and
  ``com_gyration_sharded`` on a 2x2 frames x atoms mesh against numpy.

The last line is ``{"ok": true, "device": {...}}``. These are smoke
observations, not the benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

HEADLINE = dict(atoms=100_000, protein=5_000, box=10.0, cutoff=0.5, frames=64)
WORKLOAD_ROWS = ["ca_rmsd", "com_splits", "contacts", "fused", "sasa",
                 "trjconv", "membrane_dev"]
# (nx, frames, window) of the membrane engine timing: 2*nx*nx lipids
ENGINE_SIZES = ((6, 32, 16), (48, 16, 8))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -- device -----------------------------------------------------------------


def phase_device() -> dict:
    import jax

    from molar_tpu.utils.runtime import (
        device_label,
        nvidia_smi,
        parse_nvidia_smi,
        require_gpu,
    )

    devices = require_gpu()
    label = device_label(devices)
    smi = nvidia_smi()
    emit("device", device_kind=label["kind"], count=label["count"],
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
         jax_platforms=os.environ.get("JAX_PLATFORMS", ""),
         cards=parse_nvidia_smi(smi))
    print(smi, flush=True)
    return label


# -- parity -----------------------------------------------------------------


class _Tally:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.passed, self.failed, self.skipped = [], [], []

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed.append(report.nodeid)
        elif report.skipped:
            self.skipped.append(report.nodeid)
        elif report.when == "call":
            self.passed.append(report.nodeid)


def phase_parity() -> None:
    import pytest

    os.environ["MOLAR_DEVICE_TESTS"] = "1"
    tally = _Tally()
    rc = pytest.main(
        ["-q", "-p", "no:cacheprovider", "--rootdir", REPO,
         os.path.join(REPO, "tests", "test_device_parity.py")],
        plugins=[tally],
    )
    n = len(tally.passed) + len(tally.failed) + len(tally.skipped)
    emit("parity", passed=len(tally.passed), total=n, failed=tally.failed,
         skipped=tally.skipped, rc=int(rc))
    if rc != 0 or tally.failed or tally.skipped or not tally.passed:
        raise RuntimeError(f"device parity suite failed (rc={int(rc)})")


# -- headline ---------------------------------------------------------------


def write_inputs(tmp, atoms, protein, box, frames):
    """Seeded 100k-class system: XTC via the codec, GRO and PDB via the
    library's writers (ALA residues N/CA/C/O for the protein, SOL waters)."""
    import bench
    from molar_tpu import PeriodicBox, System
    from molar_tpu.core.atom import Atom
    from molar_tpu.core.state import State
    from molar_tpu.core.topology import Topology

    coords0, masses = bench.make_system(atoms, protein, box)
    pbox = PeriodicBox(np.diag([box] * 3).astype(np.float32))
    xtc = os.path.join(tmp, "traj.xtc")
    bench.make_trajectory(xtc, coords0, pbox.matrix, frames)
    atom_list = []
    for i in range(protein):
        name = ("N", "CA", "C", "O")[i % 4]
        atom_list.append(Atom(name=name, resname="ALA", resid=i // 4 + 1,
                              atomic_number=8 if name == "O" else 6,
                              mass=16.0 if name == "O" else 12.0))
    r0 = protein // 4 + 1
    for i in range(atoms - protein):
        name = ("OW", "HW1", "HW2")[i % 3]
        atom_list.append(Atom(name=name, resname="SOL", resid=r0 + i // 3,
                              atomic_number=8 if name == "OW" else 1,
                              mass=16.0 if name == "OW" else 1.0))
    top = Topology.from_atoms(atom_list)
    top.assign_resindex()
    system = System(top, State(coords=coords0.copy(), box=pbox))
    gro = os.path.join(tmp, "conf.gro")
    system.save(gro)
    system.save(os.path.join(tmp, "conf.pdb"))
    return coords0, masses, pbox, xtc, gro


def _collect(results):
    cat = lambda k: np.concatenate([np.asarray(r[k]) for _, r in results])  # noqa: E731
    return cat(0), cat(1), cat(2), cat(3)


def _hlo_scope_names(hlo_text: str, scope: str) -> set:
    """Instruction names (``.`` and ``-`` folded to ``_``) whose metadata
    op_name lies under ``scope``."""
    names = set()
    pat = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"")
    for line in hlo_text.splitlines():
        m = pat.match(line)
        if m and f"/{scope}/" in f"/{m.group(2)}/":
            names.add(re.sub(r"[.\-]", "_", m.group(1)))
    return names


def stage_device_ns(trace_dir: str, scope: str, hlo_text: str, dump=None):
    """Sum of device-event durations attributed to ``scope`` in the newest
    profiler trace under ``trace_dir``.

    An event counts when its name, its ``hlo_op`` stat or any string stat
    lies under the scope, either directly (the scope path appears) or via
    the compiled HLO instruction of that name. Returns (scope ns, all
    device-event ns, number of device events)."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    pd = ProfileData.from_file(paths[-1])
    scoped = _hlo_scope_names(hlo_text, scope)
    hit_ns = all_ns = n_events = 0
    sample = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for j, ev in enumerate(line.events):
                stats = {k: v for k, v in ev.stats}
                n_events += 1
                all_ns += ev.duration_ns
                keys = [ev.name] + [str(v) for v in stats.values()]
                direct = any(scope in k for k in keys)
                via_hlo = any(re.sub(r"[.\-]", "_", k) in scoped for k in keys)
                if direct or via_hlo:
                    hit_ns += ev.duration_ns
                if dump is not None and j < 15:
                    sample.append({"plane": plane.name, "line": line.name,
                                   "name": ev.name, "ns": ev.duration_ns,
                                   "hit": bool(direct or via_hlo),
                                   "stats": {k: str(v)[:200]
                                             for k, v in stats.items()}})
    if dump is not None:
        with open(dump, "w") as f:
            json.dump({"trace": paths[-1], "scoped_hlo": sorted(scoped)[:500],
                       "events": sample}, f, indent=1)
    return hit_ns, all_ns, n_events


def phase_headline(atoms, protein, box, cutoff, frames, out_dir=None) -> dict:
    import jax

    import bench
    from molar_tpu.ops import neighbor
    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        auto_window,
        run_with_overflow_retry,
    )

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.perf_counter()
    coords0, masses, pbox, xtc, gro = write_inputs(tmp, atoms, protein, box,
                                                   frames)
    write_s = time.perf_counter() - t0
    window = auto_window(xtc)
    protein_idx = np.arange(protein)
    ref, pm = coords0[protein_idx], masses[protein_idx]
    dims = neighbor.grid_dims(pbox.box_extents(), cutoff)
    caps_for = bench.caps_schedule(xtc, pbox, protein_idx, dims)
    build_fn = bench.make_build_fn(ref, pm, protein_idx, atoms, cutoff, dims,
                                   caps_for)
    built = {}

    def cached(tier):
        if tier not in built:
            built[tier] = build_fn(tier)
        return built[tier]

    reader = TrajectoryReader([xtc])
    first = next(iter(reader.iter_windows(window, quantized="delta")))
    dev_first = jax.device_put(first[:4])
    t0 = time.perf_counter()
    jax.block_until_ready(cached(0)(*dev_first))
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    results, retried = run_with_overflow_retry(
        reader, window, cached, n_tiers=4, overflow_of=lambda r: r[3],
        quantized="delta",
    )
    jax.block_until_ready([r for _, r in results])
    steady_s = time.perf_counter() - t0
    rmsd, cnt, chk, _ = _collect(results)
    if len(rmsd) != frames:
        raise RuntimeError(f"headline processed {len(rmsd)} of {frames} frames")
    if not np.all(np.isfinite(rmsd)):
        raise RuntimeError("headline produced non-finite RMSD")
    checked, bad = bench.check_frames(xtc, cutoff, protein_idx, ref, pm,
                                      rmsd, cnt, chk)
    if bad:
        raise RuntimeError("headline parity: " + "; ".join(bad))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")

    # One short trace of the resident first window for the stage time.
    fn0 = cached(0)
    hlo = fn0.lower(*dev_first).compile().as_text()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn0(*dev_first))
    dump = os.path.join(out_dir, "trace_events.json") if out_dir else None
    within_ns, device_ns, n_ev = stage_device_ns(trace_dir, "within_mask",
                                                 hlo, dump=dump)
    fit_ns, _, _ = stage_device_ns(trace_dir, "fit_rmsd", hlo)
    b = len(first[3])
    res = dict(atoms=atoms, frames=len(rmsd), window=window,
               windows_retried=retried, write_s=write_s, compile_s=compile_s,
               steady_wall_s=steady_s, frames_per_s=len(rmsd) / steady_s,
               peak_bytes_in_use=peak, checked_frames=checked,
               within_count_frame0=int(cnt[0]), mean_rmsd=float(rmsd.mean()),
               traced_window_frames=b, trace_device_events=n_ev,
               trace_device_ms_per_frame=device_ns / b / 1e6,
               within_mask_ms_per_frame=within_ns / b / 1e6,
               fit_rmsd_ms_per_frame=fit_ns / b / 1e6)
    emit("headline", **res)
    if within_ns == 0:
        raise RuntimeError("no device time attributed to within_mask in the "
                           "trace")
    phase_example(gro, xtc, window)
    return res


def phase_example(gro, xtc, window) -> None:
    """examples/rmsd_trajectory.py through its main(), checked against the
    host Kabsch on the first, middle and last frames."""
    import importlib.util

    from molar_tpu import System
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.ops import measure_host

    path = os.path.join(REPO, "examples", "rmsd_trajectory.py")
    spec = importlib.util.spec_from_file_location("rmsd_trajectory", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    argv = sys.argv
    sys.argv = ["rmsd_trajectory.py", "-f", gro, xtc, "--sel", "protein",
                "--window", str(window)]
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = argv
    wall = time.perf_counter() - t0
    got = [float(l.split("\t")[1]) for l in buf.getvalue().splitlines()
           if "\t" in l]
    system = System.from_file(gro)
    sel = system("protein")
    h = XtcHandler(xtc)
    n = h.n_frames
    frames = sorted({0, n // 2, n - 1})
    worst = 0.0
    for k in frames:
        mob = h.read_frame(k).coords[sel.indices]
        r, t = measure_host.fit_transform(mob, sel.coords, sel.masses)
        want = measure_host.rmsd_mw(measure_host.apply_transform(mob, r, t),
                                    sel.coords, sel.masses)
        # printed with 6 decimals: 5e-7 rounding on top of the 1e-5 contract
        err = abs(got[k] - want)
        worst = max(worst, err / (1e-5 * abs(want) + 5e-7))
    h.close()
    emit("example", script="examples/rmsd_trajectory.py", rc=rc,
         frames=len(got), selected_atoms=len(sel), wall_s=wall,
         checked_frames=frames, worst_error_over_tolerance=worst)
    if rc != 0 or len(got) != n or worst > 1.0:
        raise RuntimeError("rmsd_trajectory example failed its check")


# -- workloads --------------------------------------------------------------


def _workloads():
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import workloads

    return workloads


def phase_workloads() -> None:
    wl = _workloads()
    out, failures = wl.run(["--which", ",".join(WORKLOAD_ROWS)])
    for name in WORKLOAD_ROWS:
        r = out[name]
        oks = {k: v for k, v in r.items() if k.endswith("_ok")}
        emit("workload", row=name, frames=r["frames"], sec=r["sec"],
             checks=oks, native_fps=r.get("native_fps"))
        if not oks or not all(oks.values()):
            raise RuntimeError(f"workload {name} did not pass its check: {r}")
    if failures:
        raise RuntimeError("workload check failures: " + "; ".join(failures))


def phase_engine() -> dict:
    """Membrane window at 72 and 4608 lipids, on the device engine and on
    the CPU engine (the timing that sets tasks.engine's verdict)."""
    import jax

    wl = _workloads()
    try:
        jax.devices("cpu")
        engines = ("device", "cpu")
    except RuntimeError:
        engines = ("device",)
    res = {}
    for nx, n_frames, window in ENGINE_SIZES:
        lipids = 2 * nx * nx
        for eng in engines:
            n, el, _ = wl.wl_membrane(n_frames=n_frames, device=True,
                                      window=window, nx=nx, ny=nx,
                                      engine=eng,
                                      stash_key=f"engine_{eng}_{lipids}")
            res[f"{lipids}/{eng}"] = n / el
            emit("engine", lipids=lipids, engine=eng, frames=n, sec=el,
                 frames_per_s=n / el)
    return res


# -- multi ------------------------------------------------------------------


def phase_multi(atoms, protein, box, cutoff, frames, n_devices=4) -> None:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from molar_tpu.ops import neighbor
    from molar_tpu.parallel import com_gyration_sharded, frame_atom_mesh
    from molar_tpu.parallel.mesh import MeshWindowRunner, frame_mesh
    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        auto_window,
        run_with_overflow_retry,
    )

    have = len(jax.devices())
    if have != n_devices:
        raise RuntimeError(f"--multi needs exactly {n_devices} devices, "
                           f"JAX reports {have}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    coords0, masses, pbox, xtc, _ = write_inputs(tmp, atoms, protein, box,
                                                 frames)
    window = auto_window(xtc)
    protein_idx = np.arange(protein)
    dims = neighbor.grid_dims(pbox.box_extents(), cutoff)
    caps_for = bench.caps_schedule(xtc, pbox, protein_idx, dims)
    build_fn = bench.make_build_fn(coords0[protein_idx], masses[protein_idx],
                                   protein_idx, atoms, cutoff, dims, caps_for)
    built = {}

    def cached(tier):
        if tier not in built:
            built[tier] = build_fn(tier)
        return built[tier]

    def stream(mesh):
        run = lambda: run_with_overflow_retry(  # noqa: E731
            TrajectoryReader([xtc]), window, cached, n_tiers=4,
            overflow_of=lambda r: r[3], quantized="delta", mesh=mesh,
        )
        run()  # compile
        t0 = time.perf_counter()
        results, _ = run()
        jax.block_until_ready([r for _, r in results])
        return _collect(results), time.perf_counter() - t0

    (r1, c1, k1, _), wall_1 = stream(None)
    (rm, cm, km, _), wall_m = stream(MeshWindowRunner(frame_mesh(n_devices)))
    np.testing.assert_allclose(rm, r1, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(cm, c1)
    np.testing.assert_array_equal(km, k1)
    emit("multi_stream", devices=n_devices, frames=len(rm), window=window,
         single_wall_s=wall_1, mesh_wall_s=wall_m,
         rmsd_max_rel_diff=float(np.max(np.abs(rm - r1) / np.abs(r1))),
         within_identical=True)

    # 2x2 frames x atoms mesh: atom-axis psum reductions.
    mesh2 = frame_atom_mesh(n_devices // 2, 2)
    fn2 = com_gyration_sharded(mesh2)
    from molar_tpu.io.xtc import XtcHandler

    h = XtcHandler(xtc)
    nf = 2 * (n_devices // 2)
    x = np.stack([h.read_frame(k).coords for k in range(nf)])
    h.close()
    com, gyr = jax.block_until_ready(fn2(
        jax.device_put(x, NamedSharding(mesh2, P("frames", "atoms"))),
        jax.device_put(masses, NamedSharding(mesh2, P("atoms"))),
    ))
    x64, m64 = x.astype(np.float64), masses.astype(np.float64)
    want_com = (x64 * m64[None, :, None]).sum(1) / m64.sum()
    d = x64 - want_com[:, None, :]
    want_gyr = np.sqrt((np.sum(d * d, -1) * m64).sum(1) / m64.sum())
    # f32 sums over 50k atoms per shard against f64 numpy
    np.testing.assert_allclose(np.asarray(com), want_com, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gyr), want_gyr, rtol=1e-5)
    emit("multi_com_gyration", mesh="2x2", frames=nf, atoms=atoms,
         com_max_abs_diff=float(np.abs(np.asarray(com) - want_com).max()))


# -- main -------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-device frame-mesh phase")
    ap.add_argument("--out", default=None,
                    help="directory for the trace-event sample")
    args = ap.parse_args(argv)

    import jax

    from molar_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()
    label = phase_device()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.multi:
        phase_multi(**HEADLINE)
    else:
        phase_parity()
        phase_headline(**HEADLINE, out_dir=args.out)
        phase_workloads()
        phase_engine()
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": label["kind"],
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
