"""Engine selection: host numpy vs CPU-jit vs accelerator.

The same analysis body can run as host numpy, jitted on the CPU backend, or
jitted on the accelerator. On an attached GPU the accelerator wins at both
ends of the membrane workload's range (chip_smoke.py's engine phase, on one
NVIDIA H100 80GB HBM3 at a 400 W power limit):

- 72-lipid membrane window: device 1758 frames/s vs CPU-jit 235;
- 4608-lipid membrane window: device 154 frames/s vs CPU-jit 4.0.

So when a GPU (any non-CPU backend) is present, :func:`pick_engine` returns
``"device"`` whatever the work. Without one, the choice is between the two
host engines, split by :data:`JIT_FLOPS_FLOOR`.

Reference analog: the serial fallback shim the reference keeps for wasm
builds (molar/src/par.rs:17-82) — degrade to the engine that wins, not the
engine that's fancy.
"""

from __future__ import annotations

__all__ = [
    "accelerator_device",
    "cpu_device",
    "pick_engine",
    "engine_device",
    "JIT_FLOPS_FLOOR",
]

# Without an accelerator: below this much work per dispatch, jit dispatch
# itself loses to plain numpy on the host (one ~2e5-flop Kabsch per call on
# a 4.3k-atom align). An order-of-magnitude host figure, not re-measured on
# the current host.
JIT_FLOPS_FLOOR = 1e6


def cpu_device():
    """The first CPU backend device (present beside an accelerator unless
    ``JAX_PLATFORMS`` leaves it out)."""
    import jax

    return jax.devices("cpu")[0]


def accelerator_device():
    """The first non-CPU jax device, or None if the build is CPU-only."""
    import jax

    try:
        d = jax.devices()[0]
    except RuntimeError:
        return None
    return None if d.platform == "cpu" else d


def pick_engine(per_frame_flops: float, frames_per_call: int = 1) -> str:
    """Return ``"host"`` | ``"cpu"`` | ``"device"`` for an analysis body.

    ``"device"`` whenever an accelerator is present (see the module
    docstring for the measurement). Otherwise ``per_frame_flops`` (a rough
    estimate of one frame's work; order of magnitude is enough) times
    ``frames_per_call`` (frames batched per dispatch, over which dispatch
    cost amortizes) picks between host numpy and CPU-jit.
    """
    if accelerator_device() is not None:
        return "device"
    work = float(per_frame_flops) * max(1, int(frames_per_call))
    return "host" if work < JIT_FLOPS_FLOOR else "cpu"


def engine_device(engine: str):
    """Map an engine name to the jax device to commit inputs to.

    Returns None for ``"host"`` (caller should use its numpy path) and for
    ``"device"`` (uncommitted arrays already land on the default backend);
    returns the CPU device for ``"cpu"`` so ``jax.device_put(x, dev)``
    commits inputs there and every jit tracing them runs on the CPU backend
    — per-call engine mixing inside one process, no global platform switch.
    """
    if engine == "cpu":
        dev = cpu_device()
        acc = accelerator_device()
        # On a CPU-only build the default backend IS the cpu device;
        # committing is harmless but pointless — keep arrays uncommitted so
        # donation/sharding behave as default.
        return dev if acc is not None else None
    if engine in ("host", "device", "auto"):
        return None
    raise ValueError(f"unknown engine {engine!r} (host/cpu/device)")
