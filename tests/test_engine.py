"""tasks.engine: engine selection.

With an accelerator present every body runs there (measured on the GPU at
both ends of the membrane workload; see the module docstring). Without one,
tiny per-dispatch work -> host numpy, the rest -> CPU-jit. On the
CPU-forced test backend there is no accelerator, so the degrade path is
what runs — itself part of the contract (reference analog:
molar/src/par.rs wasm serial shim).
"""

import numpy as np
import pytest

from molar_tpu.tasks import engine
from molar_tpu.tasks.engine import (
    JIT_FLOPS_FLOOR,
    accelerator_device,
    engine_device,
    pick_engine,
)
from molar_tpu.tasks.trajectory import transport_frames


def test_pick_engine_thresholds():
    assert pick_engine(JIT_FLOPS_FLOOR / 10) == "host"
    assert pick_engine(JIT_FLOPS_FLOOR * 10) == "cpu"
    # tests force the CPU platform: accelerator-class work degrades to cpu
    assert accelerator_device() is None
    assert pick_engine(JIT_FLOPS_FLOOR * 1e4) == "cpu"


def test_pick_engine_prefers_present_accelerator(monkeypatch):
    monkeypatch.setattr(engine, "accelerator_device", lambda: object())
    assert pick_engine(JIT_FLOPS_FLOOR / 10) == "device"
    assert pick_engine(JIT_FLOPS_FLOOR * 1e4, 64) == "device"


def test_pick_engine_window_amortization():
    # per-frame work below the jit floor, but a 64-frame window amortizes
    # the dispatch — exactly why auto_window flipped the streamed workloads
    f = JIT_FLOPS_FLOOR / 2
    assert pick_engine(f, 1) == "host"
    assert pick_engine(f, 64) == "cpu"


def test_engine_device_mapping():
    assert engine_device("host") is None
    assert engine_device("device") is None
    # CPU-only build: committing to the (default) cpu device is pointless,
    # keep arrays uncommitted
    assert engine_device("cpu") is None
    with pytest.raises(ValueError):
        engine_device("gpu")


def test_transport_frames_all_forms():
    f32 = np.zeros((8, 5, 3), np.float32)
    assert transport_frames(f32) == 8
    # chunked plain form
    assert transport_frames((f32[:3], f32[3:])) == 8
    # quantized (ints, scale)
    ints = np.zeros((6, 5, 3), np.int16)
    assert transport_frames((ints, np.float32(0.001))) == 6
    assert transport_frames(((ints[:2], ints[2:]), np.float32(0.001))) == 6
    # delta form: frame0 + B-1 deltas
    f0 = np.zeros((5, 3), np.int16)
    d8 = np.zeros((7, 5, 3), np.int8)
    assert transport_frames((f0, d8, np.float32(0.001))) == 8
    assert transport_frames((f0, (d8[:4], d8[4:]), np.float32(0.001))) == 8


def test_membrane_auto_engine_matches_device(tmp_path):
    from molar_tpu.membrane import Membrane
    from molar_tpu.membrane.device import MembraneDevice
    from test_membrane_device import TOML, make_bilayer

    outs = {}
    for engine in ("device", "auto"):
        system = make_bilayer()
        memb = Membrane(
            system, TOML.format(out=str(tmp_path / engine), extra="")
        )
        memb.add_ids_to_group("all", range(len(memb.lipids)))
        dev = MembraneDevice(memb, engine=engine)
        rng = np.random.default_rng(3)
        base = system.state.coords.copy()
        window = np.stack(
            [base + rng.normal(0, 0.01, base.shape).astype(np.float32)
             for _ in range(4)]
        )[:, dev.subset]
        outs[engine] = dev.compute_window(window.astype(np.float32))
        if engine == "auto":
            # 50-lipid bilayer x 4 frames is far below the accelerator
            # floor: the heuristic must land on cpu
            assert dev.engine_resolved == "cpu"
    import jax

    ld, td = jax.tree_util.tree_flatten(outs["device"])
    la, ta = jax.tree_util.tree_flatten(outs["auto"])
    assert td == ta
    for x, y in zip(ld, la):
        np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y),
            err_msg="engine=auto diverged from engine=device",
        )


def test_membrane_engine_rejects_unknown(tmp_path):
    from molar_tpu.membrane import Membrane, MembraneError
    from molar_tpu.membrane.device import MembraneDevice
    from test_membrane_device import TOML, make_bilayer

    system = make_bilayer()
    memb = Membrane(system, TOML.format(out=str(tmp_path), extra=""))
    memb.add_ids_to_group("all", range(len(memb.lipids)))
    with pytest.raises(MembraneError):
        MembraneDevice(memb, engine="fastest")


def test_membrane_host_verdict_runs_on_cpu_backend(tmp_path, monkeypatch):
    # A "host" verdict has no numpy twin in MembraneDevice: it must resolve
    # to the CPU backend, never fall through to the accelerator.
    from molar_tpu.membrane import Membrane
    from molar_tpu.membrane.device import MembraneDevice
    from test_membrane_device import TOML, make_bilayer

    monkeypatch.setattr(engine, "pick_engine", lambda *a, **k: "host")
    system = make_bilayer()
    memb = Membrane(system, TOML.format(out=str(tmp_path), extra=""))
    memb.add_ids_to_group("all", range(len(memb.lipids)))
    dev = MembraneDevice(memb, engine="auto")
    window = np.stack([system.state.coords[dev.subset]] * 2)
    out = dev.compute_window(window.astype(np.float32))
    assert dev.engine_resolved == "cpu"
    assert out["valid"].shape[0] == 2
