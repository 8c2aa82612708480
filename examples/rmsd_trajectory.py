#!/usr/bin/env python
"""Per-frame RMSD of a selection after mass-weighted Kabsch fit.

The device-batched shape of the reference's RMSD example: frames stream into
(B, N, 3) windows and ONE jitted program computes fit+RMSD for the whole
window. Run:

    python examples/rmsd_trajectory.py -f structure.pdb traj.xtc --sel "protein"
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from molar_tpu.ops import measure
from molar_tpu.tasks.trajectory import (
    FrameSpec,
    TrajectoryReader,
    WindowPipeline,
    build_arg_parser,
)
from molar_tpu import System
from molar_tpu.utils import greeting


def main() -> int:
    parser = build_arg_parser("windowed RMSD")
    parser.add_argument("--sel", default="protein")
    args = parser.parse_args()
    greeting("rmsd_trajectory")

    structure, *trajs = args.files
    system = System.from_file(structure)
    sel = system(args.sel)
    idx = jnp.asarray(sel.indices)
    ref = jnp.asarray(sel.coords)
    masses = jnp.asarray(sel.masses)

    @jax.jit
    def window_fn(coords, boxes, invs, times):
        def per_frame(carry, c):
            s = jnp.stack([c[:, 0][idx], c[:, 1][idx], c[:, 2][idx]], axis=-1)
            rmsd, _rot, _shift = measure.fit_rmsd(s, ref, masses)
            return carry, rmsd

        _, rmsd = jax.lax.scan(per_frame, 0, coords)
        return rmsd

    reader = TrajectoryReader(
        trajs or [structure],
        begin=FrameSpec.parse(args.begin),
        end=FrameSpec.parse(args.end),
        skip=args.skip,
    )
    out = []
    for ids, rmsd in WindowPipeline(reader, args.window, window_fn).run():
        out.append(np.asarray(rmsd))
    rmsd = np.concatenate(out) if out else np.zeros(0)
    for i, r in enumerate(rmsd):
        print(f"{i}\t{r:.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
