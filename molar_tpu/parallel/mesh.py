"""Multi-chip execution: frames sharded over a device mesh.

The reference is single-node Rayon; its re-expression here (SURVEY §2.7)
shards the **frame axis** — trajectory analysis is embarrassingly parallel
over frames, so a window ``(B, N, 3)`` splits B/n_devices per device,
topology index arrays replicate, and the only cross-device communication is
the reduction of time-averaged observables (mean RMSD, histograms, order
parameters), which XLA lowers to a `psum` collective.

Meshes are flat lists of devices: nothing here assumes a physical topology.

Two wrappers, two body styles:

* :func:`sharded_window_fn` — ``jit`` with in/out shardings. The body sees
  the FULL window; XLA's SPMD partitioner splits vmapped per-frame work and
  inserts collectives for cross-frame reductions (a ``jnp.mean`` over the
  sharded axis is a real global mean). Right for vmap-style bodies.
* :class:`MeshWindowRunner` — ``jax.shard_map``: the body runs once per
  device on its LOCAL frame shard, so ``lax.scan``-over-frames bodies (the
  production window programs, whose scan would otherwise serialize or
  gather under SPMD) parallelize cleanly. Outputs must be per-frame; the
  runner pads ragged windows, shards the transport pytree, and trims the
  outputs back. This is the production path used by
  ``tasks.trajectory.WindowPipeline(mesh=...)``.

Usage (ad-hoc):

    mesh = frame_mesh()                        # all local devices
    fn = sharded_window_fn(window_fn, mesh)    # jit with frame shardings
    out = fn(*shard_window(mesh, coords, boxes, invs, times))
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

FRAMES = "frames"


def frame_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D frame mesh over the first ``n_devices`` devices (default: all).
    Asking for more devices than exist is an error, never a smaller mesh."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), axis_names=(FRAMES,))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(FRAMES))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_window(mesh: Mesh, *arrays):
    """device_put window arrays with the leading (frame) axis sharded.

    The frame count must divide the mesh size; the trajectory pipeline pads
    ragged tails (:func:`pad_to_multiple`) before sharding.
    """
    fs = frame_sharding(mesh)
    return tuple(jax.device_put(a, fs) for a in arrays)


def sharded_window_fn(
    window_fn: Callable,
    mesh: Mesh,
    n_frame_args: int = 4,
    replicated_outs: tuple = (),
    n_outs: Optional[int] = None,
) -> Callable:
    """jit ``window_fn`` with its first ``n_frame_args`` args sharded over the
    frame axis. Outputs stay frame-sharded unless listed (by index) in
    ``replicated_outs`` (window-level scalar reductions — a global mean over
    the sharded axis is still a true mean here; XLA inserts the psum).
    ``replicated_outs`` requires ``n_outs`` (the length of the output tuple)
    so the out-sharding pytree can be built without tracing."""
    fs = frame_sharding(mesh)
    if not replicated_outs:
        return jax.jit(window_fn, in_shardings=(fs,) * n_frame_args)
    if n_outs is None:
        raise ValueError("replicated_outs requires n_outs (output tuple length)")
    rep = replicated_sharding(mesh)
    outs = tuple(rep if i in replicated_outs else fs for i in range(n_outs))
    return jax.jit(
        window_fn, in_shardings=(fs,) * n_frame_args, out_shardings=outs
    )


def pad_to_multiple(arrays, multiple: int):
    """Pad every array's leading (frame) axis to a device-count multiple;
    returns (padded arrays, valid mask). Padding repeats the last frame,
    and the mask excludes it from reductions."""
    b = arrays[0].shape[0]
    rem = (-b) % multiple
    valid = np.ones(b + rem, dtype=bool)
    if rem == 0:
        return arrays, valid
    valid[b:] = False
    out = []
    for a in arrays:
        pad = np.repeat(a[-1:], rem, axis=0)
        out.append(np.concatenate([a, pad], axis=0))
    return tuple(out), valid


class MeshWindowRunner:
    """Production frame-sharded execution of a per-window program.

    Wraps a window function ``fn(coords, boxes, invs, times) -> pytree of
    per-frame results`` (every output leaf must have the frame axis leading —
    the ``lax.scan`` window programs all do) in ``jax.shard_map`` over a
    1-D frame mesh, handling the parts shard_map cannot:

    * **transport forms** — plain f32 windows shard directly; i16 quantized
      pairs shard the ints and replicate the scale; i8-delta triples are
      reconstructed to the i16 pair on the host first (the frame-axis prefix
      sum cannot be split across devices without a cross-chip scan, and the
      host cumsum of small ints is cheap);
    * **ragged tails** — windows are padded to a device-count multiple by
      repeating the last frame (identical results, so padded rows carry no
      new overflow risk) and outputs are trimmed back;
    * **per-form caching** — each transport pytree shape wraps + jits once.

    ``window_fn`` may itself be jitted (nested jit inlines under shard_map).
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = int(mesh.devices.size)
        self._wrapped: dict = {}
        self._fs = frame_sharding(mesh)
        self._rep = replicated_sharding(mesh)

    # -- host-side window preparation ------------------------------------

    @staticmethod
    def _delta_to_i16(coords):
        """(frame0 i16, deltas i8, scale) -> (ints (B,N,3) i16, scale).
        Exact: the deltas were built from the i16 ints, so every prefix sum
        is again a representable i16 int."""
        f0, d8, scale = coords
        ints = np.concatenate(
            [
                f0[None].astype(np.int32),
                f0[None].astype(np.int32)
                + np.cumsum(d8.astype(np.int32), axis=0),
            ],
            axis=0,
        )
        return ints.astype(np.int16), scale

    def prepare(self, coords, boxes, invs, times):
        """Pad + device_put one window with frame shardings.

        Returns (dev_args, n_valid_frames, form_key).
        """
        if isinstance(coords, tuple) and len(coords) == 3:
            coords = self._delta_to_i16(coords)
        if isinstance(coords, tuple):
            lead, scale = coords
            form = "i16"
        else:
            lead, scale = coords, None
            form = "f32"
        b = lead.shape[0]
        arrs = [lead, boxes] + ([] if invs is None else [invs]) + [times]
        padded, _ = pad_to_multiple(tuple(arrs), self.n)
        lead_p, boxes_p, *rest = padded
        invs_p = rest[0] if invs is not None else None
        times_p = rest[-1]
        if form == "i16":
            dev_coords = (
                jax.device_put(lead_p, self._fs),
                jax.device_put(scale, self._rep),
            )
        else:
            dev_coords = jax.device_put(lead_p, self._fs)
        dev = (
            dev_coords,
            jax.device_put(boxes_p, self._fs),
            None if invs_p is None else jax.device_put(invs_p, self._fs),
            jax.device_put(times_p, self._fs),
        )
        return dev, b, form

    # -- wrapped function cache ------------------------------------------

    def wrap(self, window_fn: Callable, form: str) -> Callable:
        key = (id(window_fn), form)
        f = self._wrapped.get(key)
        if f is None:
            coords_spec = (P(FRAMES), P()) if form == "i16" else P(FRAMES)
            in_specs = (coords_spec, P(FRAMES), P(FRAMES), P(FRAMES))
            # check_vma=False: window programs are ordinary single-device
            # code (constant scan carries, closed-over reference frames) that
            # the varying-manual-axes type discipline would reject; with
            # per-frame in/out specs and no collectives in the body, the
            # replication analysis has nothing to protect here.
            f = jax.jit(
                jax.shard_map(
                    window_fn,
                    mesh=self.mesh,
                    in_specs=in_specs,
                    out_specs=P(FRAMES),
                    check_vma=False,
                )
            )
            self._wrapped[key] = f
        return f

    # -- one-shot convenience --------------------------------------------

    def call(self, window_fn: Callable, coords, boxes, invs, times):
        """Prepare + run + trim one window (host-array inputs)."""
        dev, b, form = self.prepare(coords, boxes, invs, times)
        out = self.wrap(window_fn, form)(*dev)
        return self.trim(out, b)

    @staticmethod
    def trim(result, n_valid: int):
        """Cut padded frames off every per-frame output leaf."""
        return jax.tree.map(lambda a: a[:n_valid], result)


# ---------------------------------------------------------------------------
# 2-D (frames x atoms) sharding: systems too large for one device's memory
# ---------------------------------------------------------------------------

ATOMS = "atoms"


def frame_atom_mesh(n_frame_devices: int, n_atom_devices: int) -> Mesh:
    """2-D mesh: the frame axis is the embarrassingly parallel one; the atom
    axis splits a single frame's coordinates across devices (for systems
    whose (B, N, 3) window exceeds one device's memory) with `psum`
    reductions for per-frame observables."""
    devs = jax.devices()
    n = n_frame_devices * n_atom_devices
    if n > len(devs):
        raise ValueError(f"need {n} devices, have {len(devs)}")
    grid = np.array(devs[:n]).reshape(n_frame_devices, n_atom_devices)
    return Mesh(grid, axis_names=(FRAMES, ATOMS))


def com_gyration_sharded(mesh: Mesh) -> Callable:
    """Per-frame COM + radius of gyration over a (frames, atoms)-sharded
    window: each chip reduces its local atom shard, `psum` over the atom
    axis completes the moments (non-PBC variant; measure.rs:120-168).

    Returns a jitted ``fn(coords (B, N, 3), masses (N,)) -> (com (B, 3),
    gyration (B,))`` whose outputs are frame-sharded.
    """
    from functools import partial

    import jax.numpy as jnp

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(FRAMES, ATOMS, None), P(ATOMS)),
        out_specs=(P(FRAMES), P(FRAMES)),
    )
    def kernel(coords, masses):
        # local shard: coords (B/nf, N/na, 3), masses (N/na,)
        msum = jax.lax.psum(jnp.sum(masses), ATOMS)
        # weighted coordinate sums, accumulated elementwise (no matmul, so
        # no reduced-precision matmul default can touch them)
        wsum = jax.lax.psum(
            jnp.sum(coords * masses[None, :, None], axis=1), ATOMS
        )
        com = wsum / msum  # (B_local, 3), identical on every atom shard
        d = coords - com[:, None, :]
        g2 = jax.lax.psum(
            jnp.sum(jnp.sum(d * d, axis=-1) * masses[None, :], axis=1), ATOMS
        )
        return com, jnp.sqrt(g2 / msum)

    return jax.jit(kernel)
