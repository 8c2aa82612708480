#!/usr/bin/env python
"""Reference benchmark workloads (molar/benches/comparison_small.rs):

* ``align``   — per-frame Kabsch fit + RMSD of a selection over a whole XTC;
* ``within``  — per-frame re-evaluation of `within 1.0 of <target>` + COM;
* ``trjconv`` — read XTC, write the selection to DCD per frame.

Usage:
    python benchmarks/comparison.py -f structure.pdb traj.xtc \
        [--sel "name CA"] [--target "resid 560"] [--workload align|within|trjconv|all]

Runs each workload on the device window pipeline and on the single-core host
path, printing frames/sec for both (the reference's criterion numbers are the
host-equivalents of the same loops).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-f", "--files", nargs=2, required=True,
                    metavar=("STRUCTURE", "XTC"))
    ap.add_argument("--sel", default="name CA")
    ap.add_argument("--target", default=None,
                    help="within target selection (default: first residue)")
    ap.add_argument("--cutoff", type=float, default=1.0)
    ap.add_argument("--workload", default="all",
                    choices=["align", "within", "trjconv", "all"])
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU jax backend")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from molar_tpu import PBC_FULL, System
    from molar_tpu.io.dcd import DcdHandler
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.ops import measure, measure_host, neighbor, neighbor_host
    from molar_tpu.tasks import TrajectoryReader, WindowPipeline

    system = System.from_file(args.files[0])
    sel = system(args.sel)
    target = (
        system(args.target)
        if args.target
        else system(f"resid {int(system.topology.resid[0])}")
    )
    h = XtcHandler(args.files[1])
    print(f"# {h.n_frames} frames, {h.n_atoms} atoms; sel={len(sel)}, "
          f"target={len(target)}", file=sys.stderr)
    results = {}

    def bench_device(window_fn, label):
        reader = TrajectoryReader([args.files[1]])
        pipe = WindowPipeline(reader, args.window, window_fn)
        first = next(iter(reader.iter_windows(args.window)))
        jax.block_until_ready(window_fn(*(jnp.asarray(x) for x in first[:4])))
        t0 = time.perf_counter()
        outs = []
        n = 0
        for ids, r in pipe.run():
            outs.append(r)
            n += len(ids)
        jax.block_until_ready(outs[-1])
        fps = n / (time.perf_counter() - t0)
        results[label] = round(fps, 2)
        return fps

    if args.workload in ("align", "all"):
        ref = jnp.asarray(sel.coords)
        masses = jnp.asarray(sel.masses)
        sidx = jnp.asarray(sel.indices)

        @jax.jit
        def align_fn(coords, boxes, invs, times):
            def f(carry, c):
                s = jnp.stack([c[:, 0][sidx], c[:, 1][sidx], c[:, 2][sidx]], -1)
                rmsd, _, _ = measure.fit_rmsd(s, ref, masses)
                return carry, rmsd

            return jax.lax.scan(f, 0, coords)[1]

        fps = bench_device(align_fn, "align_device_fps")
        # host single-core
        t0 = time.perf_counter()
        nh = min(20, h.n_frames)
        for k in range(nh):
            st = h.read_frame(k)
            c = st.coords[sel.indices]
            r, t = measure_host.fit_transform(c, sel.coords, sel.masses)
            measure_host.rmsd_mw(
                measure_host.apply_transform(c, r, t), sel.coords, sel.masses
            )
        results["align_host_fps"] = round(nh / (time.perf_counter() - t0), 2)

    if args.workload in ("within", "all"):
        box0 = h.read_frame(0).box
        dims = neighbor.grid_dims(box0.box_extents(), args.cutoff)
        tidx = jnp.asarray(target.indices)
        aidx = jnp.asarray(np.arange(h.n_atoms))

        @jax.jit
        def within_fn(coords, boxes, invs, times):
            def f(carry, frame):
                c, b, i = frame
                mask, _ = neighbor.within_mask(
                    c, aidx, tidx, cutoff=args.cutoff, box=b, inv=i,
                    dims=dims, cap=64, tgt_cap=32, max_tgt_cells=256,
                )
                w = mask.astype(jnp.float32)
                com = (c * w[:, None]).sum(0) / w.sum()
                return carry, (jnp.sum(mask), com)

            return jax.lax.scan(f, 0, (coords, boxes, invs))[1]

        bench_device(within_fn, "within_device_fps")
        t0 = time.perf_counter()
        nh = min(10, h.n_frames)
        for k in range(nh):
            st = h.read_frame(k)
            found = neighbor_host.search_within(
                args.cutoff, st.coords, np.arange(st.n_atoms), target.indices,
                st.box, PBC_FULL,
            )
            measure_host.center(st.coords[found])
        results["within_host_fps"] = round(nh / (time.perf_counter() - t0), 2)

    if args.workload in ("trjconv", "all"):
        out = tempfile.mktemp(suffix=".dcd")
        w = DcdHandler(out, "w")
        t0 = time.perf_counter()
        n = 0
        for k in range(h.n_frames):
            st = h.read_frame(k)
            w.write(system.topology, st, indices=sel.indices)
            n += 1
        w.close()
        results["trjconv_fps"] = round(n / (time.perf_counter() - t0), 2)

    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
