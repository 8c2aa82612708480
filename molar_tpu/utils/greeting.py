"""Startup banner (reference: molar lib.rs:63-88 `greeting`).

The reference prints a boxed banner with the library version and the tool
name when an analysis tool starts. Same idea, own layout: version, tool name,
and the JAX backend actually in use (the platform is easy to get wrong).
"""

from __future__ import annotations

import sys


def _backend() -> str:
    # Cheap and lazy: only report the backend if jax was already imported so
    # the banner never triggers device initialization by itself.
    j = sys.modules.get("jax")
    if j is None:
        return "jax not initialized"
    try:
        return j.default_backend()
    except Exception:  # pragma: no cover - backend probing is best-effort
        return "unknown backend"


def greeting(tool: str | None = None, *, file=None) -> str:
    """Format (and print) the startup banner; returns the banner string."""
    from molar_tpu import __version__

    lines = [
        f"molar_tpu v{__version__} - molecular trajectory analysis",
        f"backend: {_backend()}",
    ]
    if tool:
        lines.append(f"tool: {tool}")
    width = max(len(s) for s in lines)
    bar = "+" + "-" * (width + 2) + "+"
    body = "\n".join(f"| {s.ljust(width)} |" for s in lines)
    banner = f"{bar}\n{body}\n{bar}"
    print(banner, file=file if file is not None else sys.stderr)
    return banner
