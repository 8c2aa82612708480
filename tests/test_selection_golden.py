"""Pinned selection golden battery (round-1 review item 6 substitute).

The reference's cross-tool parity corpus (VMD/Pteros fixtures,
molar/tests/generated_{vmd,pteros}_tests.in) targets albumin.pdb, which is
not in the snapshot. This battery covers the same grammar productions on
protein.pdb with expected index lists computed by an INDEPENDENT naive
evaluator (tests/tools/gen_selection_golden.py: plain numpy column
predicates + O(N*M) brute-force distances) and pinned in-tree, so the full
parser->AST->evaluator pipeline is cross-checked against a second
implementation on every run.
"""

import json
import pathlib

import pytest

from molar_tpu import System

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "selection_golden.json"

_golden = json.loads(FIXTURE.read_text())


@pytest.fixture(scope="module")
def protein(ref_data):
    return System.from_file(str(ref_data / _golden["file"]))


@pytest.mark.parametrize("sel", sorted(_golden["cases"]))
def test_golden_selection(protein, sel):
    assert protein.n_atoms == _golden["n_atoms"]
    got = protein.select(sel).indices.tolist()
    want = _golden["cases"][sel]
    assert got == want, (
        f"{sel!r}: {len(got)} atoms vs {len(want)} expected; "
        f"first diff at {next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))}"
    )


# ---------------------------------------------------------------------------
# Multi-model battery (benzene.pdb 5 MODELs / multi.gro 2 frames): every case
# evaluated per swapped-in frame, pinned per frame by the independent naive
# evaluator. Covers the multi-model shape the albumin corpus cannot.
# ---------------------------------------------------------------------------

FIXTURE_MULTI = (
    pathlib.Path(__file__).parent / "fixtures" / "selection_golden_multi.json"
)

_multi = json.loads(FIXTURE_MULTI.read_text())


@pytest.mark.parametrize(
    "fname,sel",
    [
        (f, s)
        for f, entry in sorted(_multi["files"].items())
        for s in sorted(entry["cases"])
    ],
)
def test_golden_selection_multimodel(ref_data, fname, sel):
    from molar_tpu.io import FileHandler

    entry = _multi["files"][fname]
    system = System.from_file(str(ref_data / fname))
    assert system.n_atoms == entry["n_atoms"]
    fh = FileHandler(str(ref_data / fname))
    wants = entry["cases"][sel]
    n = 0
    for k, st in enumerate(fh.iter_states()):
        system.set_state(st)
        got = system.select(sel).indices.tolist()
        assert got == wants[k], f"{fname} frame {k}: {sel!r}"
        n += 1
    fh.close()
    assert n == entry["n_frames"]
