"""Test harness configuration.

Tests run on the CPU backend with 8 virtual devices so multi-device sharding
paths (mesh/shard_map) are exercised without accelerator hardware. The
platform is pinned both through ``JAX_PLATFORMS`` and ``jax.config`` before
any backend initializes.

``MOLAR_DEVICE_TESTS`` (read here and by the on-device parity suite,
tests/test_device_parity.py) selects what that suite runs on:

* unset or empty — the CPU setup above; the parity suite skips;
* ``cpu`` — the same CPU setup, and the parity suite runs on it (a
  rehearsal of the suite itself, not a check of any accelerator);
* any other value (``1``, ``gpu``) — the backend is left alone and the
  parity suite requires an accelerator. Run it alone, one process per card:

    MOLAR_DEVICE_TESTS=1 python -m pytest tests/test_device_parity.py -q
"""

import os

DEVICE_TESTS = os.environ.get("MOLAR_DEVICE_TESTS", "")
ON_ACCELERATOR = DEVICE_TESTS not in ("", "cpu")

if not ON_ACCELERATOR:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_ACCELERATOR:
    jax.config.update("jax_platforms", "cpu")

import pathlib

import pytest

REFERENCE_TESTS = pathlib.Path("/root/reference/molar/tests")


@pytest.fixture()
def restore_cache_config():
    """Undo the global compile-cache settings an entry point makes."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.fixture(scope="session")
def ref_data():
    """Path to the reference repo's test fixtures; skips when not mounted."""
    if not REFERENCE_TESTS.is_dir():
        pytest.skip("reference fixtures not available")
    return REFERENCE_TESTS
