"""Process set-up shared by the entry points: compile cache, GPU check,
nvidia-smi parsing, the content-keyed native builds, and chip_smoke.py's
refusal to run without a GPU."""

import io
import os
import pathlib
import shutil
import sys
import time
from contextlib import redirect_stdout

import pytest

import jax

from molar_tpu.native import build_cached, source_key
from molar_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_compile_cache_env_set_is_left_alone(monkeypatch, tmp_path,
                                             restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_repo_dot_jax_cache(monkeypatch,
                                                     restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = runtime.enable_compile_cache()
    assert pathlib.Path(got) == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == got
    assert pathlib.Path(got).is_dir()


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform, self.device_kind = platform, kind


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(runtime.NoGpuError, match="'cpu'"):
        runtime.require_gpu()
    gpus = [_FakeDevice("gpu", "NVIDIA H100 80GB HBM3")] * 4
    assert runtime.require_gpu(gpus) is gpus
    assert runtime.device_label(gpus) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_chip_smoke_refuses_cpu_and_prints_no_result(restore_cache_config):
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    out = io.StringIO()
    with redirect_stdout(out), pytest.raises(runtime.NoGpuError):
        chip_smoke.main([])
    assert '"ok"' not in out.getvalue()


@pytest.mark.parametrize("text,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}]),
    ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
     [{"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 500.0},
      {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}]),
    ("Some, Card, [N/A]", [{"name": "Some, Card", "power_limit_w": None}]),
])
def test_parse_nvidia_smi(text, want):
    assert runtime.parse_nvidia_smi(text) == want


def test_parse_nvidia_smi_rejects_garbage():
    with pytest.raises(ValueError):
        runtime.parse_nvidia_smi("no comma here")


def test_native_build_is_content_keyed(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    src = tmp_path / "prog.cpp"
    src.write_text("int main() { return 0; }\n")
    flags = ["-O0"]
    a = build_cached("prog", [src], flags, tmp_path / "out")
    assert a.name == f"prog-{source_key([src], flags)}"
    mtime = a.stat().st_mtime_ns
    # a newer timestamp with the same content reuses the build
    time.sleep(0.01)
    os.utime(src)
    assert build_cached("prog", [src], flags, tmp_path / "out") == a
    assert a.stat().st_mtime_ns == mtime
    # new content -> a new product; the old one is never picked up
    src.write_text("int main() { return 1; }\n")
    b = build_cached("prog", [src], flags, tmp_path / "out")
    assert b != a and b.exists()
    assert source_key([src], ["-O1"]) != source_key([src], flags)


def test_codec_library_name_carries_source_key():
    from molar_tpu import native

    lib = native._lib_path()
    srcs = [native._DIR / s for s in native._SOURCES]
    key = source_key(srcs, ["-O3", "-shared", "-fPIC", "-std=c++17"])
    assert lib.name == f"libmolar_native-{key}.so"
    assert native.load() is not None
