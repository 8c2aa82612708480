"""Trajectory analysis driver: streaming, windowing, prefetch, CLI.

The reference's per-frame loop (molar/src/analysis_task.rs:124-280: clap args,
-b/-e suffixes, multi-trajectory concatenation, --skip decimation, background
reader thread + bounded channel) becomes, on an accelerator:

    host decode threads -> window (B, N, 3) numpy -> device_put (async)
        -> ONE jitted vmapped program per window -> host accumulate

Two execution styles are offered:

* :class:`AnalysisTask` — reference-compatible per-frame hooks
  (``process_frame`` sees a ``System`` with the frame swapped in); good for
  porting reference-style analyses, runs host-side.
* window hooks (``process_window``) — the device path: the hook receives
  the batched device arrays and returns per-frame results; the driver overlaps
  the next window's decode + H2D with the current window's compute.

-b/-e suffix grammar (analysis_task.rs:82-110): bare number = frame index,
``fr`` = frames, ``ps``/``ns``/``us`` = time.
"""

from __future__ import annotations

import argparse
import logging
import queue
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..config import FLOAT
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from ..core.system import System
from ..io import FileHandler
from ..utils.greeting import greeting

log = logging.getLogger("molar_tpu.analysis")


class AnalysisError(RuntimeError):
    pass


@dataclass
class FrameSpec:
    """Parsed -b/-e value: frame index, frame count, or time (ps)."""

    frame: Optional[int] = None
    time: Optional[float] = None

    @staticmethod
    def parse(text: Optional[str]) -> "FrameSpec":
        if text is None:
            return FrameSpec()
        s = text.strip()
        if s.endswith("fr"):
            return FrameSpec(frame=int(s[:-2]))
        for suffix, mult in (("ps", 1.0), ("ns", 1e3), ("us", 1e6)):
            if s.endswith(suffix):
                return FrameSpec(time=float(s[: -len(suffix)]) * mult)
        # bare value = frame number (analysis_task.rs:82-110)
        return FrameSpec(frame=int(s))


def build_arg_parser(description: str = "trajectory analysis") -> argparse.ArgumentParser:
    """The reference TrajAnalysisArgs flag set (-f/-b/-e/--skip/--log)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument(
        "-f",
        "--files",
        nargs="+",
        required=True,
        help="structure file followed by trajectory file(s)",
    )
    p.add_argument("-b", "--begin", default=None, help="first frame (N, Nfr, Nps, Nns, Nus)")
    p.add_argument("-e", "--end", default=None, help="last frame (same suffixes)")
    p.add_argument("--skip", type=int, default=1, help="take every skip-th frame")
    p.add_argument("--log", type=int, default=100, dest="log_every", help="progress period")
    p.add_argument(
        "--window", type=int, default=0,
        help="frames per device window (0 = auto-size from the stream's "
        "wire bytes; dispatch-bound small streams get big windows)",
    )
    p.add_argument(
        "--mesh",
        type=int,
        default=0,
        help="shard each window's frame axis over this many devices "
        "(0 = single-device; window tasks only)",
    )
    p.add_argument(
        "--add-time",
        action="store_true",
        dest="add_time",
        help="offset times so they keep increasing across concatenated "
        "trajectories (pymolar AnalysisTask parity)",
    )
    return p


class TrajectoryReader:
    """Concatenated multi-trajectory frame stream with window + skip logic.

    Frames are numbered globally across files (analysis_task.rs:184-234);
    ``skip`` phase carries across file boundaries.
    """

    def __init__(
        self,
        paths: Sequence[str],
        begin: FrameSpec = FrameSpec(),
        end: FrameSpec = FrameSpec(),
        skip: int = 1,
    ):
        self.paths = list(paths)
        self.begin = begin
        self.end = end
        self.skip = max(skip, 1)

    def _want(self, global_frame: int, t: float) -> bool:
        if self.begin.frame is not None and global_frame < self.begin.frame:
            return False
        if self.begin.time is not None and t < self.begin.time:
            return False
        return True

    def _past_end(self, global_frame: int, t: float) -> bool:
        if self.end.frame is not None and global_frame > self.end.frame:
            return True
        if self.end.time is not None and t > self.end.time:
            return True
        return False

    def iter_states(self):
        """Yield (global_frame_index, State). ``skip`` decimates the frames
        inside the begin/end window, with its phase carried across file
        boundaries (analysis_task.rs:205-234)."""
        fr = -1
        in_window = 0
        for path in self.paths:
            with FileHandler(path) as fh:
                for st in fh.iter_states():
                    fr += 1
                    if self._past_end(fr, st.time):
                        return
                    if not self._want(fr, st.time):
                        continue
                    if in_window % self.skip == 0:
                        yield fr, st
                    in_window += 1

    def iter_windows(
        self,
        window: int,
        n_threads: Optional[int] = None,
        invert_boxes: bool = True,
        quantized: bool = False,
        subset: Optional[np.ndarray] = None,
    ):
        """Yield (coords, boxes (B,3,3), invs, times, frame_ids).

        Uses each handler's parallel window decode when available (XTC),
        falling back to serial state reads; applies begin/end/skip on the
        frame index level. ``invert_boxes=False`` skips the host-side box
        inversion (yielding None) for consumers that invert on device.

        ``quantized=True`` ships XTC windows as their raw quantized ints:
        coords becomes the pair ``(icoords (B,N,3) int16, scale f32 scalar)``
        — HALF the host->device bytes, and ``icoords * scale`` on device is
        bit-identical to the float decode. ``quantized="delta"`` goes
        further: frames 1..B-1 ship as int8 frame-to-frame deltas of those
        ints (coords becomes ``(frame0 (N,3) i16, deltas (B-1,N,3) i8,
        scale)``), roughly HALVING the bytes again for smoothly-moving
        trajectories; the device reconstructs the exact ints by prefix sum,
        so the result stays bit-identical. Windows whose deltas exceed the
        int8 range fall back to the i16 pair, and non-representable windows
        (non-XTC source, huge boxes, tiny frames) fall back to plain f32 —
        consumers must handle all three forms (see
        :func:`decode_window_coords`).

        ``subset``: an int index array — windows carry only those atom rows
        (in the given order). When the analysis reads a selection, shipping
        the subset cuts the host->device wire by n_atoms/len(subset)
        (decode still covers the full frame on the host; the slice is a
        cheap gather). The reference's analogue is per-selection state
        copies (Sel::clone semantics); here it is a transport-level choice.
        """
        from ..io.xtc import XtcHandler

        sub = None if subset is None else np.asarray(subset, dtype=np.intp)

        fr_base = 0
        # The skip phase counts ELIGIBLE (begin/end-passing) frames globally
        # across concatenated files (analysis_task.rs:205-234; iter_states
        # semantics) — it must NOT restart at each file boundary.
        n_eligible = 0
        for path in self.paths:
            fh = FileHandler(path)
            h = fh.handler
            if isinstance(h, XtcHandler):
                n = h.n_frames
                ids = np.arange(fr_base, fr_base + n)
                times = h.times
                keep = np.ones(n, dtype=bool)
                if self.begin.frame is not None:
                    keep &= ids >= self.begin.frame
                if self.begin.time is not None:
                    keep &= times >= self.begin.time
                if self.end.frame is not None:
                    keep &= ids <= self.end.frame
                if self.end.time is not None:
                    keep &= times <= self.end.time
                kept = np.nonzero(keep)[0]
                phase = (-n_eligible) % self.skip
                n_eligible += len(kept)
                kept = kept[phase :: self.skip]
                if len(kept) == 0:
                    fr_base += n
                    fh.close()
                    continue
                # Subsets confined to low atom indices (protein-first
                # GROMACS layouts) decode only their prefix: XDR3DFR is
                # sequential per atom, so stopping at max(subset)+1 cuts
                # the host decode cost by the prefix fraction — the same
                # lever the trjconv fast path uses (io/trjconv.py), here
                # feeding the device window stream.
                n_prefix = None
                if sub is not None and len(sub):
                    pmax = int(sub.max()) + 1
                    if 2 * pmax <= h.n_atoms:
                        n_prefix = pmax
                for s in range(0, len(kept), window):
                    chunk = kept[s : s + window]
                    if np.array_equal(chunk, np.arange(chunk[0], chunk[0] + len(chunk))):
                        coords = None
                        if quantized:
                            try:
                                ic, scale, boxes, times_w = h.read_frames_i16(
                                    int(chunk[0]), len(chunk), n_threads,
                                    n_prefix=n_prefix,
                                )
                                if sub is not None:
                                    ic = np.ascontiguousarray(ic[:, sub])
                                coords = (ic, scale)
                                if quantized == "delta" and len(ic) > 1:
                                    d = np.diff(ic.astype(np.int32), axis=0)
                                    if (
                                        np.abs(d).max(initial=0) <= 127
                                    ):
                                        coords = (
                                            ic[0],
                                            d.astype(np.int8),
                                            scale,
                                        )
                            except ValueError:
                                coords = None
                        if coords is None:
                            coords, boxes, times_w = h.read_frames(
                                int(chunk[0]), len(chunk), n_threads
                            )
                            if sub is not None:
                                coords = np.ascontiguousarray(coords[:, sub])
                    else:
                        # decimated: decode frame-by-frame (still random access)
                        n_rows = h.n_atoms if sub is None else len(sub)
                        coords = np.empty((len(chunk), n_rows, 3), np.float32)
                        boxes = np.empty((len(chunk), 3, 3), np.float32)
                        times_w = np.empty(len(chunk), np.float32)
                        for k, fi in enumerate(chunk):
                            st = h.read_frame(int(fi))
                            coords[k] = st.coords if sub is None else st.coords[sub]
                            boxes[k] = (
                                st.box.matrix if st.box is not None else np.eye(3)
                            )
                            times_w[k] = st.time
                    yield coords, boxes, _invert_boxes(boxes) if invert_boxes else None, times_w, ids[chunk]
                fr_base += n
                fh.close()
            else:
                buf_c, buf_b, buf_t, buf_i = [], [], [], []
                fr = fr_base - 1
                for st in fh.iter_states():
                    fr += 1
                    if self._past_end(fr, st.time):
                        break
                    if not self._want(fr, st.time):
                        continue
                    if n_eligible % self.skip:
                        n_eligible += 1
                        continue
                    n_eligible += 1
                    buf_c.append(
                        st.coords.astype(np.float32)
                        if sub is None
                        else st.coords[sub].astype(np.float32)
                    )
                    buf_b.append(
                        st.box.matrix if st.box is not None else np.eye(3, dtype=np.float32)
                    )
                    buf_t.append(st.time)
                    buf_i.append(fr)
                    if len(buf_c) == window:
                        boxes = np.stack(buf_b)
                        yield (
                            np.stack(buf_c),
                            boxes,
                            _invert_boxes(boxes) if invert_boxes else None,
                            np.asarray(buf_t, np.float32),
                            np.asarray(buf_i),
                        )
                        buf_c, buf_b, buf_t, buf_i = [], [], [], []
                fr_base = fr + 1
                if buf_c:
                    boxes = np.stack(buf_b)
                    yield (
                        np.stack(buf_c),
                        boxes,
                        _invert_boxes(boxes) if invert_boxes else None,
                        np.asarray(buf_t, np.float32),
                        np.asarray(buf_i),
                    )
                fh.close()


def _invert_boxes(boxes: np.ndarray) -> np.ndarray:
    return np.linalg.inv(boxes.astype(np.float64)).astype(np.float32)


def decode_window_coords(coords):
    """Device-side decode of a window's coords in any transport form.

    Handles the three forms yielded by :meth:`TrajectoryReader.iter_windows`:
    plain f32 (B,N,3); quantized ``(i16 ints, scale)``; delta-quantized
    ``(frame0 i16, deltas i8, scale)``. Returns f32 (B,N,3), bit-identical
    to the plain decode in all three cases (prefix sums of the deltas
    reconstruct the exact ints; every partial sum is a true coordinate
    difference, which fits i32 trivially).

    Each form's bulk frame-axis array may also arrive as a TUPLE of
    frame-axis chunks (``WindowPipeline(put_chunks=K)`` ships a window as K
    separate host->device transfers); the chunks are concatenated in-graph,
    so the compiled program fuses the reassembly with the decode.
    """
    import jax.numpy as jnp

    def _cat(x):
        return jnp.concatenate(x, axis=0) if isinstance(x, tuple) else x

    if not isinstance(coords, tuple):
        return coords
    # Chunked plain-f32 form: a tuple of (b,N,3) arrays (quantized forms
    # always end in a rank-0 scale, so rank-3 last element is unambiguous).
    if getattr(coords[-1], "ndim", None) == 3 and not isinstance(
        coords[-1], tuple
    ):
        return _cat(coords)
    if len(coords) == 2:
        ic, scale = coords
        return _cat(ic).astype(jnp.float32) * scale
    f0, d8, scale = coords
    ints = jnp.concatenate(
        [
            f0[None].astype(jnp.int32),
            f0[None].astype(jnp.int32)
            + jnp.cumsum(_cat(d8).astype(jnp.int32), axis=0),
        ],
        axis=0,
    )
    return ints.astype(jnp.float32) * scale


def transport_frames(coords) -> int:
    """Frame count of a window transport WITHOUT decoding it.

    Mirrors :func:`decode_window_coords`'s form dispatch (plain / chunked /
    quantized / delta-quantized); engine selection needs B before deciding
    which backend the decode itself should run on.
    """

    def lead(x):
        return (
            sum(c.shape[0] for c in x) if isinstance(x, tuple) else x.shape[0]
        )

    if not isinstance(coords, tuple):
        return coords.shape[0]
    if getattr(coords[-1], "ndim", None) == 3 and not isinstance(
        coords[-1], tuple
    ):
        return lead(coords)
    if len(coords) == 2:
        return lead(coords[0])
    return 1 + lead(coords[1])


def auto_window(
    path: str,
    subset=None,
    requested: int = 0,
    target_bytes: int = 6_000_000,
    max_window: int = 128,
) -> int:
    """Pick an execute-window size for a delta-transport stream.

    ``requested`` > 0 wins unchanged. Otherwise the window grows until one
    window's i8-delta wire (~3 bytes x rows x frames) reaches
    ``target_bytes``: small-selection streams are dispatch-bound at small
    windows, and full-frame streams keep each transfer bounded. At 16
    frames and above the window is rounded down to a multiple of 16 and
    clamped to ``max_window`` (compile-cache-stable shapes); below 16 —
    huge frames — it falls in powers of two down to 1. Files that are not
    XTC (no cheap frame/atom count probe) fall back to 16.

    The default ``target_bytes`` was tuned on the previous accelerator's
    transport and has not been measured on a GPU.
    """
    if requested:
        return requested
    from ..io.base import FileIoError
    from ..io.xtc import XtcHandler

    try:
        h = XtcHandler(path)
    except (OSError, FileIoError):
        return 16
    n_frames, n_atoms = h.n_frames, h.n_atoms
    h.close()
    rows = n_atoms if subset is None else len(subset)
    w = target_bytes // max(1, 3 * rows)
    if w < 16:
        p2 = 1
        while p2 * 2 <= max(1, w):
            p2 *= 2
        return int(min(n_frames, p2))
    return int(min(n_frames, min(max_window, w // 16 * 16)))


def _chunk_coords(coords, k: int):
    """Split a window transport's bulk frame-axis array into ``k`` chunks.

    Returns the chunked transport form understood by
    :func:`decode_window_coords`, with the big array replaced by a tuple of
    contiguous frame-axis slices. Small leaves (frame0, scale) are left
    whole. ``k`` is clamped to the frame-axis length.
    """

    def _split(a):
        kk = max(1, min(k, a.shape[0]))
        return tuple(np.array_split(a, kk, axis=0))

    if not isinstance(coords, tuple):
        return _split(coords)
    if len(coords) == 2:
        ic, scale = coords
        return (_split(ic), scale)
    f0, d8, scale = coords
    return (f0, _split(d8), scale)


class WindowPipeline:
    """Double-buffered window pump: decode thread + H2D + device compute.

    ``window_fn(coords, boxes, invs, times) -> pytree of per-frame results``
    is called once per window; decode of window k+1 overlaps compute of k
    (the replacement of the reference's IoStateIterator reader thread
    + sync_channel(10), io.rs:198-271).

    ``mesh``: a 1-D frame :class:`jax.sharding.Mesh` turns on multi-chip
    execution — each window is padded to a device-count multiple, device_put
    with the frame axis sharded, and ``window_fn`` runs under ``shard_map``
    so its ``lax.scan`` covers only the local frame shard
    (parallel.mesh.MeshWindowRunner). Requires every ``window_fn`` output
    leaf to be per-frame (leading frame axis); outputs are trimmed back to
    the real frame count. This is SURVEY §2.7's multi-chip row: the rayon
    frame pool becomes frames sharded over devices.
    """

    def __init__(
        self,
        reader: TrajectoryReader,
        window: int,
        window_fn: Callable,
        device_put: bool = True,
        queue_depth: int = 2,
        n_threads: Optional[int] = None,
        invert_boxes: bool = True,
        quantized: bool = False,
        mesh=None,
        ordered: bool = False,
        subset: Optional[np.ndarray] = None,
        put_chunks: int = 1,
    ):
        self.reader = reader
        self.window = window
        self.window_fn = window_fn
        self.device_put = device_put
        self.queue_depth = queue_depth
        self.n_threads = n_threads
        self.invert_boxes = invert_boxes
        self.quantized = quantized
        self.ordered = ordered
        self.subset = subset
        # put_chunks > 1 ships each window's bulk coords as that many
        # SEPARATE device_put calls (frame-axis chunks), so the transfer
        # size is decoupled from the execute window size. The jitted
        # window_fn sees the chunked transport form and reassembles in-graph
        # (decode_window_coords). Ignored in mesh mode (sharded windows are
        # placed per-device by MeshWindowRunner). Whether it pays on a GPU
        # is not measured yet.
        self.put_chunks = put_chunks
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import MeshWindowRunner

            # Accept a pre-built MeshWindowRunner so callers that warmed
            # their window_fn through one keep its per-form jit cache
            # (a fresh runner would re-wrap and recompile the same HLO).
            self._runner = (
                mesh
                if isinstance(mesh, MeshWindowRunner)
                else MeshWindowRunner(mesh)
            )
        else:
            self._runner = None

    def run(self):
        """Yield (frame_ids, result_pytree) per window."""
        import jax

        # Ordered mode drains the whole stream before dispatching, so the
        # queue must be unbounded or the feeder deadlocks against it.
        q: queue.Queue = queue.Queue(
            maxsize=0 if self.ordered else self.queue_depth
        )
        stop = object()
        runner = self._runner

        def feeder():
            try:
                for item in self.reader.iter_windows(
                    self.window, self.n_threads, self.invert_boxes,
                    quantized=self.quantized, subset=self.subset,
                ):
                    coords, boxes, invs, times, ids = item
                    if runner is not None:
                        # Mesh mode: pad + shard the window over the frame
                        # axis (delta transport reconstructs to i16 first).
                        dev, b, form = runner.prepare(coords, boxes, invs, times)
                        q.put((dev, ids, (b, form)))
                        continue
                    if self.put_chunks > 1:
                        coords = _chunk_coords(coords, self.put_chunks)
                    if self.device_put:
                        if self.put_chunks > 1:
                            # Separate put per bulk chunk (the whole point:
                            # K small transfers instead of one big one);
                            # the small leaves ride one extra put.
                            dev = (
                                jax.tree_util.tree_map(
                                    jax.device_put, coords
                                ),
                                *jax.device_put((boxes, invs, times)),
                            )
                        else:
                            # One device_put for the whole window: one
                            # dispatch instead of four.
                            dev = jax.device_put(
                                (coords, boxes, invs, times)
                            )
                    else:
                        dev = (coords, boxes, invs, times)
                    q.put((dev, ids, None))
            except BaseException as e:  # surface decode errors to consumer
                q.put(e)
                return
            q.put(stop)

        t = threading.Thread(target=feeder, daemon=True)
        t.start()

        def dispatch(item):
            (coords, boxes, invs, times), ids, meta = item
            if runner is not None:
                b, form = meta
                out = runner.wrap(self.window_fn, form)(
                    coords, boxes, invs, times
                )
                return ids, runner.trim(out, b)
            return ids, self.window_fn(coords, boxes, invs, times)

        if self.ordered:
            # Strict put-phase / execute-phase split: enqueue EVERY window's
            # transfer before the first dispatch, so the device stream never
            # interleaves puts between executes. All windows stay resident
            # at once: use for passes whose total transport fits device
            # memory comfortably.
            staged = []
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                staged.append(item)
            t.join()
            for item in staged:
                yield dispatch(item)
            return

        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield dispatch(item)
        t.join()


def _read_frames_by_ids(paths: Sequence[str], ids):
    """Random-access re-read of specific GLOBAL frame indices across files.

    The overflow-retry fallback for flagged windows whose by-range window
    re-read cannot reproduce the original frame set (skip phase crossing a
    file boundary, windows spanning files). Uses XTC random access where
    available, serial iteration otherwise. Returns (coords f32 (B, N, 3),
    boxes, invs, times) in ``ids`` order.
    """
    from ..io.xtc import XtcHandler

    want = {int(i) for i in ids}
    found: dict = {}
    fr_base = 0
    for path in paths:
        if len(found) == len(want):
            break
        fh = FileHandler(path)
        h = fh.handler
        if isinstance(h, XtcHandler):
            n = h.n_frames
            for fi in sorted(want - found.keys()):
                if fr_base <= fi < fr_base + n:
                    found[fi] = h.read_frame(fi - fr_base)
            fr_base += n
        else:
            fr = fr_base - 1
            for st in fh.iter_states():
                fr += 1
                if fr in want:
                    found[fr] = st
            fr_base = fr + 1
        fh.close()
    missing = want - found.keys()
    if missing:
        raise AnalysisError(
            f"re-read could not locate frames {sorted(missing)}"
        )
    sts = [found[int(i)] for i in ids]
    coords = np.stack([s.coords.astype(np.float32) for s in sts])
    boxes = np.stack(
        [
            s.box.matrix if s.box is not None else np.eye(3, dtype=np.float32)
            for s in sts
        ]
    )
    times = np.asarray([s.time for s in sts], np.float32)
    return coords, boxes, _invert_boxes(boxes), times


def run_with_overflow_retry(
    reader: TrajectoryReader,
    window: int,
    build_fn: Callable[[int], Callable],
    n_tiers: int = 3,
    overflow_of: Callable = None,
    quantized: bool = False,
    n_threads: Optional[int] = None,
    mesh=None,
    queue_depth: int = 2,
    device_put: bool = True,
    ordered: bool = False,
    put_chunks: int = 1,
):
    """Stream windows through tier-0's window_fn; re-run overflowed windows
    at higher capacity tiers (the fixed-capacity + retry contract,
    ops/neighbor.py static-shape notes).

    ``build_fn(tier)`` returns the jitted window function for capacity tier
    ``tier`` (0-based; each tier must enlarge whatever static capacities the
    search uses). ``overflow_of(result)`` extracts the window's overflow
    flag(s) (anything ``np.any``-able) from a result pytree.

    The first pass never blocks per window (a per-window sync would
    serialize the pipeline): overflow flags stay on device and are checked
    once after the pass, then only the flagged windows are re-read (by frame range, skip
    phase preserved) and re-executed at the next tier, escalating until
    clean. Raises AnalysisError if the last tier still overflows.

    Returns (results, retried_window_count) with ``results`` a list of
    (frame_ids, result) in stream order, overflowed windows replaced by
    their clean re-runs.
    """
    import jax

    if overflow_of is None:
        raise ValueError("overflow_of extractor is required")

    runner = None
    if mesh is not None:
        from ..parallel.mesh import MeshWindowRunner

        # A pre-built runner keeps its per-form jit cache across calls.
        runner = (
            mesh if isinstance(mesh, MeshWindowRunner) else MeshWindowRunner(mesh)
        )

    fn0 = build_fn(0)
    results: list = []
    pipeline = WindowPipeline(
        reader, window, fn0, quantized=quantized, n_threads=n_threads,
        mesh=runner, queue_depth=queue_depth, device_put=device_put,
        ordered=ordered, put_chunks=put_chunks,
    )
    for ids, res in pipeline.run():
        results.append((ids, res))
    if results:
        jax.block_until_ready(results[-1][1])

    def call(fn, coords, boxes, invs, times):
        if runner is not None:
            return runner.call(fn, coords, boxes, invs, times)
        return fn(coords, boxes, invs, times)

    retried = 0
    fns = {0: fn0}
    for w, (ids, res) in enumerate(results):
        if not bool(np.any(np.asarray(overflow_of(res)))):
            continue
        retried += 1
        for tier in range(1, n_tiers):
            if tier not in fns:
                fns[tier] = build_fn(tier)
            sub = TrajectoryReader(
                reader.paths,
                begin=FrameSpec(frame=int(ids[0])),
                end=FrameSpec(frame=int(ids[-1])),
                skip=reader.skip,
            )
            redo_in = list(
                sub.iter_windows(window, n_threads, quantized=quantized)
            )
            if len(redo_in) == 1 and np.array_equal(redo_in[0][4], ids):
                coords, boxes, invs, times, rids = redo_in[0]
            else:
                # The by-range re-read did not reproduce the frame set (skip
                # phase crossing a file boundary, window spanning files):
                # fall back to per-frame random access on the exact ids.
                coords, boxes, invs, times = _read_frames_by_ids(
                    reader.paths, ids
                )
                rids = ids
            if put_chunks > 1 and runner is None:
                coords = _chunk_coords(coords, put_chunks)
            redo = (rids, call(fns[tier], coords, boxes, invs, times))
            if not bool(np.any(np.asarray(overflow_of(redo[1])))):
                results[w] = redo
                break
        else:
            raise AnalysisError(
                f"window {w} (frames {ids[0]}..{ids[-1]}) still overflows at "
                f"the largest capacity tier {n_tiers - 1}"
            )
    return results, retried


@dataclass
class AnalysisContext:
    """Mirrors the reference AnalysisContext {sys, consumed_frames, args}
    (analysis_task.rs:309-313)."""

    system: System
    consumed_frames: int
    args: argparse.Namespace


class WindowAnalysisTask:
    """Device-batched analysis harness.

    Subclass and implement:

    * ``build(system) -> window_fn`` — return the jitted function
      ``(coords, boxes, invs, times) -> pytree of per-frame results``;
    * ``accumulate(frame_ids, results)`` — host-side consumption per window;
    * optional ``post_process()``.

    ``run()`` parses the standard flags and drives the double-buffered
    window pipeline. This is the idiomatic form of the reference's
    AnalysisTask on the device: one fused XLA program per frame window.

    ``--mesh N`` (or ``mesh`` passed to ``run``) shards each window's frame
    axis over N devices (SURVEY §2.7): ``build``'s window
    function then runs under shard_map on its local frame shard, so all its
    outputs must be per-frame. ``accumulate`` sees full trimmed windows
    either way.
    """

    task_name = "window analysis"

    def add_args(self, parser: argparse.ArgumentParser) -> None:
        pass

    def build(self, system: System):
        raise NotImplementedError

    def accumulate(self, frame_ids, results) -> None:
        raise NotImplementedError

    def post_process(self) -> None:
        pass

    def run(self, argv: Optional[Sequence[str]] = None, mesh=None):
        parser = build_arg_parser(self.task_name)
        self.add_args(parser)
        args = parser.parse_args(argv)
        greeting(self.task_name)
        structure, *trajectories = args.files
        system = System.from_file(structure)
        self.args = args
        window_fn = self.build(system)
        reader = TrajectoryReader(
            trajectories or [structure],
            begin=FrameSpec.parse(args.begin),
            end=FrameSpec.parse(args.end),
            skip=args.skip,
        )
        if mesh is None and getattr(args, "mesh", 0):
            from ..parallel.mesh import frame_mesh

            mesh = frame_mesh(args.mesh)
        window = args.window or auto_window(
            (trajectories or [structure])[0]
        )
        if not args.window:
            log.info("auto window: %d frames", window)
        pipeline = WindowPipeline(reader, window, window_fn, mesh=mesh)
        n = 0
        t0 = _time.perf_counter()
        for ids, results in pipeline.run():
            self.accumulate(ids, results)
            n += len(ids)
            if args.log_every and n % args.log_every < len(ids):
                log.info(
                    "%d frames, %.1f frames/s", n, n / (_time.perf_counter() - t0)
                )
        self.post_process()
        return n


class AnalysisTask:
    """Reference-compatible per-frame analysis harness.

    Subclass and implement ``pre_process`` / ``process_frame`` /
    ``post_process`` (the Python-binding hook names,
    molar_python/python/pymolar/__init__.py:26-146). ``run()`` parses the
    standard flags, streams frames, swaps each into the system, and calls the
    hooks with progress logging every ``--log`` frames.

    Hooks may take either zero arguments (verbatim pymolar tasks, e.g.
    ``def pre_process(self):``) or an ``AnalysisContext``; the signature is
    inspected per hook. Matching pymolar, ``pre_process`` fires when the
    FIRST trajectory frame arrives — with ``self.state`` set and ``self.src``
    already holding frame-1 coordinates — not before streaming, so hooks
    reading frame-1 geometry see the right state.
    """

    task_name = "analysis"

    def add_args(self, parser: argparse.ArgumentParser) -> None:
        # reference python-binding hook name is register_args; honor both
        if hasattr(self, "register_args"):
            self.register_args(parser)

    def pre_process(self, ctx: AnalysisContext) -> None:
        pass

    def process_frame(self, ctx: AnalysisContext) -> None:
        pass

    def post_process(self, ctx: AnalysisContext) -> None:
        pass

    def _call_hook(self, name: str, ctx: AnalysisContext) -> None:
        """Invoke a user hook with ctx, or zero-arg pymolar-style.

        Reference pymolar tasks define ``def pre_process(self):`` etc.
        (molar_python/python/pymolar/__init__.py:133-146); the native harness
        passes an AnalysisContext. Both spellings are accepted by inspecting
        the bound hook's positional arity — ONCE per hook name, not per frame
        (``process_frame`` runs in the per-frame hot loop).
        """
        cache = self.__dict__.setdefault("_hook_arity", {})
        fn = getattr(self, name)
        takes_ctx = cache.get(name)
        if takes_ctx is None:
            import inspect

            try:
                takes_ctx = bool(
                    [
                        p
                        for p in inspect.signature(fn).parameters.values()
                        if p.kind
                        in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                            p.VAR_POSITIONAL)
                    ]
                )
            except (TypeError, ValueError):
                takes_ctx = True
            cache[name] = takes_ctx
        if takes_ctx:
            fn(ctx)
        else:
            fn()

    def run(self, argv: Optional[Sequence[str]] = None) -> AnalysisContext:
        parser = build_arg_parser(self.task_name)
        self.add_args(parser)
        args = parser.parse_args(argv)
        greeting(self.task_name)
        if len(args.files) < 1:
            raise AnalysisError("need a structure file")
        structure, *trajectories = args.files
        system = System.from_file(structure)
        # pymolar-compatible attributes: self.src (system), self.args, and
        # self.state updated per frame (molar_python/python/pymolar).
        self.src = system
        self.args = args
        reader = TrajectoryReader(
            trajectories or [structure],
            begin=FrameSpec.parse(args.begin),
            end=FrameSpec.parse(args.end),
            skip=args.skip,
        )
        ctx = AnalysisContext(system=system, consumed_frames=0, args=args)
        t0 = _time.perf_counter()
        time_offset = 0.0
        last_time = None
        for fr, st in reader.iter_states():
            if getattr(args, "add_time", False):
                if last_time is not None and st.time + time_offset <= last_time:
                    time_offset = last_time  # new file restarted its clock
                st.time += time_offset
                last_time = st.time
            if st.n_atoms != system.n_atoms:
                raise AnalysisError(
                    f"frame has {st.n_atoms} atoms, system has {system.n_atoms}"
                )
            system.set_state(st)
            self.state = st
            if ctx.consumed_frames == 0:
                # pymolar semantics: pre_process fires with the first frame
                # already swapped in (self.src holds frame-1 coordinates).
                self._call_hook("pre_process", ctx)
            self._call_hook("process_frame", ctx)
            ctx.consumed_frames += 1
            if args.log_every and ctx.consumed_frames % args.log_every == 0:
                el = _time.perf_counter() - t0
                log.info(
                    "frame %d (t=%.1f ps), %.1f frames/s",
                    fr,
                    st.time,
                    ctx.consumed_frames / el,
                )
        self._call_hook("post_process", ctx)
        return ctx
