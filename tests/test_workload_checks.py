"""The workload benchmarks are self-verifying (round-4 review item 2): every
row reduces its device outputs to the scalar its native denominator
(benchmarks/native_workloads.cpp, native_membrane.cpp) emits, and main()
aborts with rc=1 on mismatch or trivially-empty accumulations. These tests
prove a correct run passes AND a deliberately-broken run fails — the
rounds-1-3 empty-membrane-stats bug is the reason this exists."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

import workloads  # noqa: E402


@pytest.fixture()
def argv(monkeypatch, restore_cache_config):
    # (main() turns on the persistent compile cache)
    def set_argv(*extra):
        monkeypatch.setattr(
            sys, "argv",
            ["workloads.py", "--cpu", "--atoms", "3000", "--protein", "600",
             "--frames", "8", *extra],
        )
    return set_argv


@pytest.mark.skipif(os.environ.get("MOLAR_TPU_F64") == "1",
                    reason="native denominators are f32; checks are "
                    "calibrated for the f32 build")
def test_correct_run_passes(argv):
    argv("--which", "ca_rmsd")
    assert workloads.main() == 0


@pytest.mark.skipif(os.environ.get("MOLAR_TPU_F64") == "1",
                    reason="native denominators are f32")
def test_broken_run_fails(argv, monkeypatch, capsys):
    # Corrupt the device check the way a silent kernel bug would: the fps
    # still computes, but the value no longer matches the native check.
    orig = workloads.wl_ca_rmsd

    def broken(*a, **kw):
        n, el, chk = orig(*a, **kw)
        return n, el, {"check": chk["check"] * 1.5}

    monkeypatch.setattr(workloads, "wl_ca_rmsd", broken)
    argv("--which", "ca_rmsd")
    assert workloads.main() == 1
    assert "check_failures" in capsys.readouterr().out


def test_membrane_empty_accumulation_raises():
    class FakeDev:
        species_names = ["LIP"]
        _sp_lipids = {"LIP": np.arange(4)}

    outs = [{
        "valid": np.zeros((2, 4), bool),  # every lipid failed the fit check
        "area": np.ones((2, 4), np.float32),
        "mean_curv": np.zeros((2, 4), np.float32),
        "order": {"LIP": [np.zeros((2, 4, 3), np.float32)]},
    }]
    with pytest.raises(RuntimeError, match="ZERO valid lipids"):
        workloads._membrane_device_checks(FakeDev(), outs)


def test_membrane_device_checks_values():
    class FakeDev:
        species_names = ["LIP"]
        _sp_lipids = {"LIP": np.arange(2)}

    valid = np.array([[True, False]])
    outs = [{
        "valid": valid,
        "area": np.array([[2.0, 99.0]], np.float32),
        "mean_curv": np.array([[0.5, 99.0]], np.float32),
        "order": {"LIP": [np.array([[[0.1, 0.3], [9.0, 9.0]]], np.float32)]},
    }]
    chk = workloads._membrane_device_checks(FakeDev(), outs)
    assert chk["check_area"] == pytest.approx(2.0)
    assert chk["check_mean"] == pytest.approx(0.5)
    assert chk["check_order"] == pytest.approx(0.2)


def test_contacts_empty_guard(monkeypatch):
    # All-zero contact counts must raise, not silently benchmark nothing.
    monkeypatch.setattr(
        workloads, "_timed_stream",
        lambda *a, **k: (8, 1.0, [(np.zeros(8, np.int32), np.zeros(8, bool))]),
    )
    sys_ = workloads._synth_system(2000, 400)
    with pytest.raises(RuntimeError, match="ZERO contacts"):
        workloads.wl_contacts(sys_, xtc=None, window=4)
