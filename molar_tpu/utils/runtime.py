"""Process set-up shared by every entry point that drives an accelerator.

* :func:`enable_compile_cache` — JAX's persistent compilation cache. When
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
  overrides it; otherwise the cache lives at ``<repo>/.jax_cache`` (a fixed
  path, since the path is part of the cache key).
* :func:`require_gpu` — the measurement paths refuse to run anywhere but a
  GPU: a number taken on the CPU backend must never be reported under a
  device metric's name.
* :func:`device_label` — platform, ``device_kind`` and device count, for
  every line a benchmark prints.
* :func:`nvidia_smi` / :func:`parse_nvidia_smi` — the card's name and power
  limit, read by ``nvidia-smi`` in a child process that never imports JAX.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"

NVIDIA_SMI_QUERY = [
    "nvidia-smi",
    "--query-gpu=name,power.limit",
    "--format=csv,noheader",
]


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)


class NoGpuError(RuntimeError):
    pass


def require_gpu(devices=None):
    """Return the default backend's devices; raise unless they are GPUs."""
    if devices is None:
        import jax

        devices = jax.devices()
    platform = devices[0].platform if devices else "none"
    if platform != "gpu":
        raise NoGpuError(
            f"no GPU: JAX's default backend is {platform!r}; this path "
            "measures the accelerator and has no CPU fallback"
        )
    return devices


def device_label(devices=None) -> dict:
    """``{"platform", "kind", "count"}`` of the default backend."""
    if devices is None:
        import jax

        devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi() -> str:
    """Raw ``name, power.limit`` line(s) from ``nvidia-smi``."""
    out = subprocess.run(
        NVIDIA_SMI_QUERY, capture_output=True, text=True, check=True,
        timeout=60,
    )
    return out.stdout.strip()


def parse_nvidia_smi(text: str) -> list[dict]:
    """Parse ``nvidia-smi --query-gpu=name,power.limit`` CSV output.

    One dict per card: ``{"name": str, "power_limit_w": float | None}``
    (None when the driver reports ``[N/A]``)."""
    cards = []
    for line in text.strip().splitlines():
        if not line.strip():
            continue
        name, _, limit = line.rpartition(",")
        if not name:
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        limit = limit.strip()
        watts = None
        if limit and not limit.startswith("["):
            watts = float(limit.split()[0])
        cards.append({"name": name.strip(), "power_limit_w": watts})
    return cards
