"""FrameSelection: the task-facing selection wiring across all three tiers.

Verifies the documented contract (round-1 review weak item: the fallback
wiring from a trajectory task was untested): static selections evaluate once,
compiler-supported state-dependent selections run on device per window, and
compiler-rejected expressions transparently fall back to per-frame host
re-evaluation — all three producing identical per-frame results while
streaming windows from a real trajectory file.
"""

import numpy as np
import pytest

from molar_tpu import System
from molar_tpu.core.state import State
from molar_tpu.selection import FrameSelection, SelectionExpr
from molar_tpu.tasks.trajectory import TrajectoryReader


@pytest.fixture(scope="module")
def scene(ref_data, tmp_path_factory):
    sys_ = System.from_file(str(ref_data / "protein.pdb"))
    assert sys_.state.box is not None
    rng = np.random.default_rng(5)
    path = tmp_path_factory.mktemp("fs") / "traj.xtc"
    from molar_tpu.io.xtc import XtcHandler

    w = XtcHandler(str(path), "w")
    c = sys_.state.coords.copy()
    for k in range(6):
        c = c + rng.normal(0, 0.01, c.shape).astype(np.float32)
        w.write_raw(c, sys_.state.box.matrix, step=k, time=float(k))
    w.close()
    return sys_, str(path)


def _texts(sys_):
    r0 = int(sys_.topology.resid[0])
    return {
        "static": "name CA",
        "device": f"within 0.7 pbc of resid {r0}",
        # within over a state-dependent inner is CompileUnsupported ->
        # host fallback tier.
        "host": f"within 0.7 pbc of (within 0.5 pbc of resid {r0})",
    }


def test_tiers_resolved_as_documented(scene):
    sys_, _ = scene
    for tier, text in _texts(sys_).items():
        fs = FrameSelection(text, sys_.topology, sys_.state)
        assert fs.tier == tier, (text, fs.tier)


def test_streaming_windows_all_tiers_match_host(scene):
    sys_, path = scene
    reader = TrajectoryReader([path])
    sels = {
        tier: FrameSelection(text, sys_.topology, sys_.state)
        for tier, text in _texts(sys_).items()
    }
    exprs = {tier: SelectionExpr(text) for tier, text in _texts(sys_).items()}
    n_frames = 0
    for coords, boxes, invs, times, ids in reader.iter_windows(3):
        for tier, fs in sels.items():
            masks = fs.eval_window(coords, boxes, invs)
            assert masks.shape == (len(ids), sys_.topology.n_atoms)
            for k in range(len(ids)):
                st = State(coords=np.asarray(coords[k]), box=sys_.state.box)
                want = exprs[tier].apply(sys_.topology, st)
                got = np.nonzero(masks[k])[0]
                assert np.array_equal(got, want), (tier, ids[k])
        n_frames += len(ids)
    assert n_frames == 6


def test_eval_frame_matches_eval_window(scene):
    sys_, path = scene
    reader = TrajectoryReader([path])
    fs = FrameSelection(_texts(sys_)["host"], sys_.topology, sys_.state)
    for coords, boxes, invs, times, ids in reader.iter_windows(6):
        masks = fs.eval_window(coords, boxes, invs)
        st = State(coords=np.asarray(coords[0]), box=sys_.state.box)
        idx = fs.eval_frame(st)
        assert np.array_equal(np.nonzero(masks[0])[0], idx)
