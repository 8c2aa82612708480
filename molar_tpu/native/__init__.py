"""Native (C++) codec loading: compile-on-demand + ctypes bindings.

The trajectory bit-codecs (XTC today; the GROMACS TPR/CPT plugin interface
later) are serial host work and live in C++ (SURVEY §2.2 plan). The shared
library is built from the bundled sources with g++ on first use. Every build
product is keyed on a hash of its sources' content and its compiler flags
(:func:`build_cached`), so what is loaded is always built from the files on
disk, never a stale binary whose timestamp happens to be newer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent
_SOURCES = ["xtc_codec.cpp"]
_LIB_NAME = "libmolar_native"
#: Build products of the benchmark denominators (the package's own library
#: is built next to its source).
BUILD_DIR = _DIR.parents[1] / "build" / "native"


class NativeBuildError(RuntimeError):
    pass


def source_key(sources, flags) -> str:
    """Hex digest of the sources' bytes, their names and the compiler flags."""
    h = hashlib.sha256()
    for f in flags:
        h.update(f.encode() + b"\0")
    for s in sources:
        p = pathlib.Path(s)
        h.update(p.name.encode() + b"\0")
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_cached(name: str, sources, flags, out_dir, suffix: str = "") -> pathlib.Path:
    """Build ``sources`` with ``g++ flags`` into ``out_dir/name-<key><suffix>``
    unless that exact product exists. The key hashes the sources' content
    (:func:`source_key`). Builds go to a temporary file renamed into place,
    so concurrent builders never load a half-written binary."""
    if shutil.which("g++") is None:
        raise NativeBuildError("g++ not found")
    out_dir = pathlib.Path(out_dir)
    out = out_dir / f"{name}-{source_key(sources, flags)}{suffix}"
    if out.exists():
        return out
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", dir=out_dir)
    os.close(fd)
    try:
        cmd = ["g++", *flags, *map(str, sources), "-o", tmp]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(f"native build failed:\n{proc.stderr}")
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_executable(name: str, sources) -> pathlib.Path:
    """A benchmark denominator binary under :data:`BUILD_DIR`."""
    return build_cached(name, sources, ["-O3", "-std=c++17"], BUILD_DIR)


def _lib_path() -> pathlib.Path:
    srcs = [_DIR / s for s in _SOURCES]
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"]
    try:
        return build_cached(_LIB_NAME, srcs, flags, _DIR, ".so")
    except OSError:
        # read-only package directory (installed wheel)
        out = pathlib.Path(tempfile.gettempdir()) / "molar_tpu_native"
        return build_cached(_LIB_NAME, srcs, flags, out, ".so")


_lib = None


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_lib_path()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        longp = ctypes.POINTER(ctypes.c_long)

        lib.xtc_parse_header.restype = ctypes.c_int
        lib.xtc_parse_header.argtypes = [
            u8p, ctypes.c_long, i32p, i32p, f32p, f32p, longp,
        ]
        lib.xtc_decode_frame_buf.restype = ctypes.c_int
        lib.xtc_decode_frame_buf.argtypes = [
            u8p, ctypes.c_long, f32p, f32p, i32p, f32p, f32p,
        ]
        lib.xtc_decode_frame_detect.restype = ctypes.c_int
        lib.xtc_decode_frame_detect.argtypes = [
            u8p, ctypes.c_long, f32p, f32p, i32p, f32p, f32p, i32p,
        ]
        lib.xtc_decode_frame_prefix.restype = ctypes.c_int
        lib.xtc_decode_frame_prefix.argtypes = [
            u8p, ctypes.c_long, f32p, ctypes.c_int32, f32p, i32p, f32p,
            ctypes.c_int32,
        ]
        i16p = ctypes.POINTER(ctypes.c_int16)
        lib.xtc_decode_frame_buf_i16.restype = ctypes.c_int
        lib.xtc_decode_frame_buf_i16.argtypes = [
            u8p, ctypes.c_long, i16p, f32p, i32p, f32p, f32p,
        ]
        lib.xtc_decode_frame_prefix_i16.restype = ctypes.c_int
        lib.xtc_decode_frame_prefix_i16.argtypes = [
            u8p, ctypes.c_long, i16p, ctypes.c_int32, f32p, i32p, f32p,
            f32p, ctypes.c_int32,
        ]
        lib.xtc_encode_frame.restype = ctypes.c_long
        lib.xtc_encode_frame.argtypes = [
            f32p, ctypes.c_int, f32p, ctypes.c_int32, ctypes.c_float,
            ctypes.c_float, ctypes.POINTER(u8p),
        ]
        lib.xtc_free.restype = None
        lib.xtc_free.argtypes = [u8p]
        lib.xtc_index.restype = ctypes.c_long
        lib.xtc_index.argtypes = [
            u8p, ctypes.c_long, longp, i32p, f32p, ctypes.c_long, i32p,
        ]
        _lib = lib
    return _lib
