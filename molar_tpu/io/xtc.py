"""XTC trajectory handler over the native C++ codec.

Replaces the reference's molly-crate path (molar/src/io/xtc_handler.rs) with a
device-feeding design: the file is memory-mapped and *indexed up front* (one cheap
header scan), which buys exact random access (seek by frame/time/last — the
reference does a backward header scan instead, xtc_handler.rs:245-257) and
frame-level parallel decode: every frame is independent, so a thread pool
decodes a whole window of frames concurrently into one pinned (B, N, 3)
numpy block ready for jax.device_put (ctypes releases the GIL inside the
codec).

Coordinates are nm on disk (f32), box rows are vectors (transposed into the
column convention). A corrupt tail truncates the index rather than erroring
(io.rs:254-269 tolerance).
"""

from __future__ import annotations

import ctypes
import mmap
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..config import FLOAT
from ..core.pbc import PeriodicBox, PeriodicBoxError
from ..core.state import State
from ..native import load as load_native
from .base import (
    EmptyFileError,
    FormatHandler,
    MalformedFileError,
    NotWritableError,
    SeekError,
)

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _box_from_rows(box9: np.ndarray) -> Optional[PeriodicBox]:
    m = box9.reshape(3, 3).T  # file rows are vectors -> our columns
    if not m.any():
        return None
    try:
        return PeriodicBox(m)
    except PeriodicBoxError:
        return None


class XtcHandler(FormatHandler):
    can_read_state = True
    can_write = True
    can_seek = True

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._lib = load_native()
        self._pos = 0  # next frame to read
        self._mm: Optional[mmap.mmap] = None
        self._natoms: Optional[int] = None
        if mode == "r":
            self._fh = open(path, "rb")
            size = os.fstat(self._fh.fileno()).st_size
            if size == 0:
                raise EmptyFileError(f"xtc file is empty: {path}")
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
            # Zero-copy byte view over the mapping; slices keep the base
            # pointer, so `self._data[off:].ctypes.data` addresses into the map.
            self._data = np.frombuffer(self._mm, dtype=np.uint8)
            self._index()
        elif mode in ("w", "a"):
            self._fh = open(path, mode + "b")
        else:
            raise ValueError(f"bad mode {mode!r}")

    # -- index ---------------------------------------------------------------

    def _index(self) -> None:
        size = len(self._mm)
        max_frames = max(size // 56, 1)
        offsets = np.empty(max_frames, dtype=np.int64)
        steps = np.empty(max_frames, dtype=np.int32)
        times = np.empty(max_frames, dtype=np.float32)
        natoms = ctypes.c_int32(-1)
        addr = self._data.ctypes.data_as(_u8p)
        n = self._lib.xtc_index(
            addr,
            size,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            steps.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_frames,
            ctypes.byref(natoms),
        )
        if n <= 0:
            raise MalformedFileError(f"no valid xtc frames in {self.path}")
        self._offsets = offsets[:n].copy()
        self._steps = steps[:n].copy()
        self._times = times[:n].copy()
        self._natoms = int(natoms.value)
        size_tail = (
            int(self._offsets[-1])
            + self._frame_len(int(self._offsets[-1]))
        )
        self._end = size_tail

    def _frame_len(self, off: int) -> int:
        natoms = ctypes.c_int32()
        step = ctypes.c_int32()
        time = ctypes.c_float()
        box9 = (ctypes.c_float * 9)()
        fbytes = ctypes.c_long()
        size = len(self._mm)
        addr = self._data[off:].ctypes.data_as(_u8p)
        ok = self._lib.xtc_parse_header(
            addr, size - off, ctypes.byref(natoms), ctypes.byref(step),
            ctypes.byref(time), box9, ctypes.byref(fbytes),
        )
        if not ok:
            raise MalformedFileError("bad xtc frame header")
        return int(fbytes.value)

    # -- properties -----------------------------------------------------------

    @property
    def n_frames(self) -> int:
        return len(self._offsets)

    @property
    def n_atoms(self) -> int:
        return self._natoms

    @property
    def times(self) -> np.ndarray:
        return self._times

    # -- decode ----------------------------------------------------------------

    def _decode_at(self, offset: int, coords_out: np.ndarray) -> tuple[int, float]:
        size = len(self._mm)
        addr = self._data[offset:].ctypes.data_as(_u8p)
        box9 = np.empty(9, dtype=np.float32)
        step = ctypes.c_int32()
        time = ctypes.c_float()
        prec = ctypes.c_float()
        n = self._lib.xtc_decode_frame_buf(
            addr,
            size - offset,
            coords_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(step),
            ctypes.byref(time),
            ctypes.byref(prec),
        )
        if n != self._natoms:
            raise MalformedFileError(
                f"xtc decode failed at offset {offset} in {self.path}"
            )
        return int(step.value), float(time.value), box9

    # Run-flag dialect of this file (0 canonical, 1 sticky/molly), detected
    # lazily by one strict full decode — prefix decodes cannot re-validate
    # the dialect themselves, so they reuse this.
    _sticky: Optional[int] = None

    def _dialect(self) -> int:
        if self._sticky is None:
            coords = np.empty((self._natoms, 3), dtype=np.float32)
            box9 = np.empty(9, dtype=np.float32)
            step = ctypes.c_int32()
            time = ctypes.c_float()
            prec = ctypes.c_float()
            sticky = ctypes.c_int32()
            off = int(self._offsets[0])
            n = self._lib.xtc_decode_frame_detect(
                self._data[off:].ctypes.data_as(_u8p),
                len(self._mm) - off,
                coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(step), ctypes.byref(time),
                ctypes.byref(prec), ctypes.byref(sticky),
            )
            if n != self._natoms:
                raise MalformedFileError(
                    f"xtc dialect detection failed in {self.path}"
                )
            self._sticky = sticky.value
        return self._sticky

    PREFIX_SLACK = 10  # run-group overshoot slack rows (xtc_codec.cpp)

    def decode_prefix(
        self, i: int, n_atoms: int, coords_out: Optional[np.ndarray] = None
    ) -> tuple[np.ndarray, int, float, np.ndarray]:
        """Decode only the FIRST ``n_atoms`` atoms of frame ``i``.

        XDR3DFR is a sequential per-atom stream, so a selection confined to
        low atom indices (protein-first GROMACS topologies) can skip
        decoding the solvent tail entirely — the big win for trjconv-style
        streaming (the reference's molly codec has no such entry point,
        molar/src/io/xtc_handler.rs full-frame decode only).

        ``coords_out``: optional reusable ``(n_atoms + PREFIX_SLACK, 3)``
        f32 buffer. Returns ``(coords_view (n_atoms, 3), step, time,
        box9)`` — the view aliases the buffer; copy it to retain across
        calls.
        """
        if not 0 <= i < self.n_frames:
            raise SeekError(f"frame {i} out of range (0..{self.n_frames - 1})")
        n_atoms = min(n_atoms, self._natoms)
        if coords_out is None:
            coords_out = np.empty((n_atoms + self.PREFIX_SLACK, 3), np.float32)
        sticky = self._dialect()
        off = int(self._offsets[i])
        box9 = np.empty(9, dtype=np.float32)
        step = ctypes.c_int32()
        time = ctypes.c_float()
        n = self._lib.xtc_decode_frame_prefix(
            self._data[off:].ctypes.data_as(_u8p),
            len(self._mm) - off,
            coords_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_atoms,
            box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(step), ctypes.byref(time),
            sticky,
        )
        if n != self._natoms:
            raise MalformedFileError(
                f"xtc prefix decode failed at frame {i} in {self.path}"
            )
        return coords_out[:n_atoms], int(step.value), float(time.value), box9

    def read_frame(self, i: int) -> State:
        """Random-access decode of frame i."""
        if not 0 <= i < self.n_frames:
            raise SeekError(f"frame {i} out of range (0..{self.n_frames - 1})")
        coords = np.empty((self._natoms, 3), dtype=np.float32)
        step, time, box9 = self._decode_at(int(self._offsets[i]), coords)
        return State(
            coords=coords.astype(FLOAT, copy=False),
            time=time,
            step=step,
            box=_box_from_rows(box9),
        )

    def read_frames(
        self, start: int, count: int, n_threads: Optional[int] = None
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Parallel decode of a frame window -> (coords (B,N,3), boxes (B,3,3)
        column-convention, times (B,)). The window feeder for device batches."""
        count = min(count, self.n_frames - start)
        if count <= 0:
            return (
                np.empty((0, self._natoms, 3), np.float32),
                np.empty((0, 3, 3), np.float32),
                np.empty(0, np.float32),
            )
        coords = np.empty((count, self._natoms, 3), dtype=np.float32)
        boxes = np.empty((count, 3, 3), dtype=np.float32)
        times = np.empty(count, dtype=np.float32)

        def work(k: int):
            step, t, box9 = self._decode_at(int(self._offsets[start + k]), coords[k])
            boxes[k] = box9.reshape(3, 3).T
            times[k] = t

        workers = n_threads or min(os.cpu_count() or 1, 8)
        if workers > 1 and count > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(work, range(count)))
        else:
            for k in range(count):
                work(k)
        return coords, boxes, times

    def read_frames_i16(
        self,
        start: int,
        count: int,
        n_threads: Optional[int] = None,
        n_prefix: Optional[int] = None,
    ) -> tuple[np.ndarray, np.float32, np.ndarray, np.ndarray]:
        """Decode a window to the stream's raw quantized ints as int16:
        -> (icoords (B,N,3) i16, scale f32, boxes, times).

        XTC coordinates *are* ints times 1/precision; shipping the ints and
        multiplying on device reproduces the float decode bit-exactly at half
        the host->device bytes. Raises ValueError when the window can't be represented
        (coordinate beyond +-32767 quantized units, uncompressed tiny frame,
        or mixed precisions) — callers fall back to :meth:`read_frames`.

        ``n_prefix``: decode only the FIRST n_prefix atoms of every frame
        (XDR3DFR is sequential — see :meth:`decode_prefix`); icoords comes
        back (B, n_prefix, 3), bit-identical to the full decode's prefix.
        The window feeder uses this when a subset's max index is small
        (protein-first topologies): the decode cost drops with the prefix
        fraction, not just the wire.
        """
        count = min(count, self.n_frames - start)
        n_rows = self._natoms if n_prefix is None else min(n_prefix, self._natoms)
        if count <= 0:
            return (
                np.empty((0, n_rows, 3), np.int16),
                np.float32(1.0),
                np.empty((0, 3, 3), np.float32),
                np.empty(0, np.float32),
            )
        prefix = n_prefix is not None and n_rows < self._natoms
        sticky = self._dialect() if prefix else 0
        slack = self.PREFIX_SLACK if prefix else 0
        icoords = np.empty((count, n_rows + slack, 3), dtype=np.int16)
        boxes = np.empty((count, 3, 3), dtype=np.float32)
        times = np.empty(count, dtype=np.float32)
        precs = np.empty(count, dtype=np.float32)
        size = len(self._mm)
        i16p = ctypes.POINTER(ctypes.c_int16)

        def work(k: int):
            offset = int(self._offsets[start + k])
            addr = self._data[offset:].ctypes.data_as(_u8p)
            box9 = np.empty(9, dtype=np.float32)
            step = ctypes.c_int32()
            time = ctypes.c_float()
            prec = ctypes.c_float()
            if prefix:
                n = self._lib.xtc_decode_frame_prefix_i16(
                    addr,
                    size - offset,
                    icoords[k].ctypes.data_as(i16p),
                    n_rows,
                    box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ctypes.byref(step),
                    ctypes.byref(time),
                    ctypes.byref(prec),
                    sticky,
                )
            else:
                n = self._lib.xtc_decode_frame_buf_i16(
                    addr,
                    size - offset,
                    icoords[k].ctypes.data_as(i16p),
                    box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    ctypes.byref(step),
                    ctypes.byref(time),
                    ctypes.byref(prec),
                )
            if n == -2:
                raise ValueError(
                    "frame not representable as i16 quantized coordinates"
                )
            if n != self._natoms:
                raise MalformedFileError(
                    f"xtc decode failed at offset {offset} in {self.path}"
                )
            boxes[k] = box9.reshape(3, 3).T
            times[k] = time.value
            precs[k] = prec.value

        workers = n_threads or min(os.cpu_count() or 1, 8)
        if workers > 1 and count > 1:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                list(ex.map(work, range(count)))
        else:
            for k in range(count):
                work(k)
        if not (precs == precs[0]).all() or precs[0] <= 0:
            raise ValueError("mixed or invalid precisions in window")
        # Same f32 arithmetic as the C decoder: inv = 1.0f / precision.
        scale = np.float32(1.0) / np.float32(precs[0])
        if slack:
            icoords = icoords[:, :n_rows]
        return icoords, scale, boxes, times

    # -- FormatHandler interface ------------------------------------------------

    def read_state(self) -> Optional[State]:
        if self._pos >= self.n_frames:
            return None
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    def seek_frame(self, fr: int) -> None:
        if not 0 <= fr < self.n_frames:
            raise SeekError(f"frame {fr} out of range")
        self._pos = fr

    def seek_time(self, t: float) -> None:
        i = int(np.searchsorted(self._times, t))
        if i >= self.n_frames:
            raise SeekError(f"time {t} beyond end of trajectory")
        self._pos = i

    def seek_last(self) -> State:
        self._pos = self.n_frames - 1
        st = self.read_frame(self._pos)
        self._pos += 1
        return st

    def tell_first(self) -> tuple[int, float]:
        return int(self._steps[0]), float(self._times[0])

    def write(self, topology, state: State, indices=None) -> None:
        if self.mode == "r":
            raise NotWritableError("xtc handler opened read-only")
        coords = state.coords if indices is None else state.coords[indices]
        self.write_raw(
            np.ascontiguousarray(coords, dtype=np.float32),
            None if state.box is None else state.box.matrix,
            state.step,
            state.time,
        )

    def write_raw(
        self,
        coords: np.ndarray,
        box_matrix: Optional[np.ndarray],
        step: int = 0,
        time: float = 0.0,
        precision: float = 1000.0,
    ) -> None:
        box9 = (
            np.zeros((3, 3), np.float32)
            if box_matrix is None
            else np.ascontiguousarray(box_matrix.T, dtype=np.float32)
        )
        # The encoder reads raw f32: a f64 (or strided) array passed through
        # ctypes writes garbage bytes (caught by the f64-build suite).
        coords = np.ascontiguousarray(coords, dtype=np.float32)
        out = _u8p()
        n = self._lib.xtc_encode_frame(
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            coords.shape[0],
            box9.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            step,
            time,
            precision,
            ctypes.byref(out),
        )
        if n < 0:
            raise MalformedFileError("xtc encode failed")
        try:
            self._fh.write(ctypes.string_at(out, n))
        finally:
            self._lib.xtc_free(out)

    def close(self) -> None:
        if self._mm is not None:
            # ctypes from_buffer holds exported pointers; drop before close.
            try:
                self._mm.close()
            except BufferError:
                pass
        self._fh.close()
