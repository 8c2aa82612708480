"""Generate the pinned selection golden battery (round-1 review item 6).

The reference validates its selection engine against VMD/Pteros on
``albumin.pdb`` (molar/tests/generated_{vmd,pteros}_tests.in) — a fixture not
in the snapshot. This script substitutes a committed golden battery on the
available fixtures: every grammar production evaluated on ``protein.pdb``
(and ``benzene.pdb`` for multi-model data), with the expected index lists
computed by an INDEPENDENT naive numpy evaluator (plain column predicates and
O(N*M) brute-force distances — no selection engine, no cell grid), then
pinned to ``tests/fixtures/selection_golden.json``.

Run:  python tests/tools/gen_selection_golden.py
Test: tests/test_selection_golden.py compares the full engine to the pinned
lists, so any engine regression (or fixture drift) fails loudly.

Selection forms mirror the albumin fixtures' shapes (name CA / resid N /
same residue as … / within X of resid N / compound keywords) plus the rest
of the grammar (math, chained comparisons, dist, com/cog of, pos N of,
regex, pbc flags).
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_platforms", "cpu")

from molar_tpu import System  # noqa: E402

REF_TESTS = pathlib.Path("/root/reference/molar/tests")
OUT = REPO / "tests" / "fixtures" / "selection_golden.json"

PROTEIN_RESNAMES = set(
    """GLY ALA VAL PHE PRO MET ILE LEU ASP GLU LYS ARG SER THR TYR
       HIS CYS ASN GLN TRP HSE HSD HSP CYX""".split()
)
BACKBONE_NAMES = {"C", "N", "O", "CA"}
WATER_RESNAMES = {"SOL", "HOH", "TIP3", "TIP4", "TIP5", "OPC"}


class Naive:
    """Independent naive evaluator over topology columns + brute force."""

    def __init__(self, sys_: System):
        t = sys_.topology
        self.names = np.asarray(t.names())
        self.resnames = np.asarray(t.resnames())
        self.resid = t.resid.copy()
        self.resindex = t.resindex.copy()
        self.chains = t.chain.copy()
        self.mass = t.mass.copy()
        self.occupancy = t.occupancy.copy()
        self.beta = t.bfactor.copy()
        self.coords = sys_.state.coords.astype(np.float64)
        self.box = sys_.state.box
        self.n = t.n_atoms
        self.x, self.y, self.z = (self.coords[:, i] for i in range(3))

    # -- brute force distances -------------------------------------------------
    def _delta(self, a, b, pbc: bool):
        d = a[:, None, :] - b[None, :, :]
        if pbc:
            m = np.asarray(self.box.matrix, np.float64)
            assert np.allclose(m, np.diag(np.diag(m))), "naive pbc assumes ortho"
            L = np.diag(m)
            d -= L * np.round(d / L)
        return d

    def within(self, cutoff, target_mask, pbc=False, include_self_flag=False):
        """Atoms with >=1 partner in target within cutoff (inclusive).

        Atoms that are both source and target self-match at d=0, so the
        target atoms are included by construction (reference within
        semantics; `self` flag is only additive for subsetted sources).
        """
        tgt = self.coords[target_mask]
        d = np.sqrt((self._delta(self.coords, tgt, pbc) ** 2).sum(-1))
        mask = (d <= cutoff + 0.0).any(axis=1)
        if include_self_flag:
            mask |= target_mask
        return mask

    def com(self, mask, weights=None):
        w = (self.mass if weights is None else weights)[mask]
        return (self.coords[mask] * w[:, None]).sum(0) / w.sum()

    def cog(self, mask):
        return self.coords[mask].mean(0)

    def same_residue(self, mask):
        return np.isin(self.resindex, np.unique(self.resindex[mask]))

    def same_chain(self, mask):
        return np.isin(self.chains, np.unique(self.chains[mask]))

    def first_alpha_is_h(self):
        out = np.zeros(self.n, bool)
        for i, nm in enumerate(self.names):
            for c in nm:
                if c.isalpha():
                    out[i] = c == "H"
                    break
        return out


def battery_protein(nv: Naive):
    """(selection string, naive boolean mask) pairs for protein.pdb."""
    import re as _re

    protein = np.isin(nv.resnames, list(PROTEIN_RESNAMES))
    bb = protein & np.isin(nv.names, list(BACKBONE_NAMES))
    ca = nv.names == "CA"
    water = np.isin(nv.resnames, list(WATER_RESNAMES))
    hyd = nv.first_alpha_is_h()
    r10 = nv.resid == 560
    r20 = nv.resid == 570
    com_ca = nv.com(ca)
    cog_ca = nv.cog(ca)

    cases = [
        ("all", np.ones(nv.n, bool)),
        ("name CA", ca),
        ("name CA CB N", np.isin(nv.names, ["CA", "CB", "N"])),
        ("name /C.*/", np.array([bool(_re.fullmatch("C.*", s)) for s in nv.names])),
        ("resname LEU", nv.resnames == "LEU"),
        ("resname LEU ALA", np.isin(nv.resnames, ["LEU", "ALA"])),
        ("resid 560", r10),
        ("resid 560 570 580", np.isin(nv.resid, [560, 570, 580])),
        ("resid 560:570", (nv.resid >= 560) & (nv.resid <= 570)),
        ("resindex 5", nv.resindex == 5),
        ("resindex 5:9", (nv.resindex >= 5) & (nv.resindex <= 9)),
        ("index 100", np.arange(nv.n) == 100),
        ("index 100:200", (np.arange(nv.n) >= 100) & (np.arange(nv.n) <= 200)),
        ("chain A", nv.chains == "A"),
        ("protein", protein),
        ("backbone", bb),
        ("sidechain", protein & ~bb),
        ("water", water),
        ("now", ~water),
        ("hydrogen", hyd),
        ("noh", ~hyd),
        ("not name CA", ~ca),
        ("name CA and resid 560", ca & r10),
        ("name CA or resid 560", ca | r10),
        ("name CA and not resid 560:700", ca & ~((nv.resid >= 560) & (nv.resid <= 700))),
        ("(name CA or name CB) and resname LEU",
         np.isin(nv.names, ["CA", "CB"]) & (nv.resnames == "LEU")),
        ("same residue as name SG", nv.same_residue(nv.names == "SG")),
        ("same residue as (name CA and resid 560)", nv.same_residue(ca & r10)),
        ("same chain as index 0", nv.same_chain(np.arange(nv.n) == 0)),
        # math / comparisons
        ("x > 4.0", nv.x > 4.0),
        ("x < 2.0 and y > 3.0", (nv.x < 2.0) & (nv.y > 3.0)),
        ("x + y > 8.0", nv.x + nv.y > 8.0),
        ("x * 2 >= y", nv.x * 2 >= nv.y),
        ("x - y <= 0.5", nv.x - nv.y <= 0.5),
        ("x / 2 < 2.0", nv.x / 2 < 2.0),
        ("x ^ 2 > 20.0", nv.x**2 > 20.0),
        ("abs(x - 4.0) < 1.0", np.abs(nv.x - 4.0) < 1.0),
        ("sqrt(x) > 2.0", np.sqrt(np.maximum(nv.x, 0)) > 2.0),
        ("2.0 < x < 4.0", (2.0 < nv.x) & (nv.x < 4.0)),
        ("2.0 <= x <= 4.0", (2.0 <= nv.x) & (nv.x <= 4.0)),
        ("6.0 > y > 3.0", (6.0 > nv.y) & (nv.y > 3.0)),
        ("mass > 13.0", nv.mass > 13.0),
        ("occupancy == 1.0", nv.occupancy == 1.0),
        ("beta < 0.5", nv.beta < 0.5),
        ("resid 560 and x > 4.5", r10 & (nv.x > 4.5)),
        # within family (mirrors the albumin fixture shapes)
        ("within 0.5 of resid 560", nv.within(0.5, r10)),
        ("within 0.3 of resid 570", nv.within(0.3, r20)),
        ("name CA and within 0.3 of resid 570", ca & nv.within(0.3, r20)),
        ("within 0.5 pbc of resid 560", nv.within(0.5, r10, pbc=True)),
        ("within 0.5 pbc yyy of resid 560", nv.within(0.5, r10, pbc=True)),
        ("within 0.7 self of resid 560",
         nv.within(0.7, r10, include_self_flag=True)),
        ("protein and within 0.35 of water", protein & nv.within(0.35, water)),
        # dist family
        ("dist point 4.0 4.0 4.0 < 1.5",
         np.linalg.norm(nv.coords - [4.0, 4.0, 4.0], axis=1) < 1.5),
        # com / cog vectors
        ("x > x of com of name CA", nv.x > com_ca[0]),
        ("y < y of cog of name CA", nv.y < cog_ca[1]),
        # pos N is 0-based into the inner result (documented divergence,
        # nodes.py VecNthAtom: reference ast.rs:404-411 reads the eval
        # context instead — an apparent bug)
        ("x > x of pos 3 of name CA", nv.x > nv.coords[np.nonzero(ca)[0][3], 0]),
    ]
    # dist line/plane (through the CA COM along/normal to z); the point is
    # rounded to 3 decimals BEFORE computing the naive mask so it matches the
    # literal in the selection string exactly
    p0 = np.round(com_ca, 3)
    w = nv.coords - p0
    line_d = np.linalg.norm(w - np.outer(w @ [0, 0, 1.0], [0, 0, 1.0]), axis=1)
    plane_d = np.abs(w @ [0, 0, 1.0])
    cases.append(
        (f"dist line {p0[0]:.3f} {p0[1]:.3f} {p0[2]:.3f} dir 0.0 0.0 1.0 < 1.0",
         line_d < 1.0)
    )
    cases.append(
        (f"dist plane {p0[0]:.3f} {p0[1]:.3f} {p0[2]:.3f} normal 0.0 0.0 1.0 < 0.5",
         plane_d < 0.5)
    )
    return cases


OUT_MULTI = REPO / "tests" / "fixtures" / "selection_golden_multi.json"


def battery_benzene(nv: Naive):
    """Per-model cases for benzene.pdb (5 MODELs, 12 atoms): the multi-model
    shape the albumin corpus cannot cover — state-dependent selections must
    track the swapped-in model."""
    c1 = nv.names == "C1"
    carbons = np.char.startswith(nv.names.astype(str), "C")
    return [
        ("name C1", c1),
        ("name /C.*/", carbons),
        ("within 0.2 of name C1", nv.within(0.2, c1)),
        ("within 0.15 pbc of name C1", nv.within(0.15, c1, pbc=True)),
        ("x > 1.7", nv.x > 1.7),
        ("x > x of com of name /C.*/", nv.x > nv.com(carbons)[0]),
        ("dist point 1.66 1.77 1.67 < 0.2",
         np.linalg.norm(nv.coords - [1.66, 1.77, 1.67], axis=1) < 0.2),
    ]


def battery_multigro(nv: Naive):
    """Per-frame cases for multi.gro (2 frames of the 4295-atom protein)."""
    protein = np.isin(nv.resnames, list(PROTEIN_RESNAMES))
    ca = nv.names == "CA"
    r560 = nv.resid == 560
    return [
        ("protein", protein),
        ("name CA and x > 4.0", ca & (nv.x > 4.0)),
        ("within 0.4 of resid 560", nv.within(0.4, r560)),
        ("within 0.5 pbc of resid 560", nv.within(0.5, r560, pbc=True)),
        ("x > x of com of name CA", nv.x > nv.com(ca)[0]),
        ("same residue as within 0.35 of resid 560",
         nv.same_residue(nv.within(0.35, r560))),
    ]


def main():
    sys_ = System.from_file(str(REF_TESTS / "protein.pdb"))
    nv = Naive(sys_)
    golden = {"file": "protein.pdb", "n_atoms": int(nv.n), "cases": {}}
    n_empty = 0
    for sel, mask in battery_protein(nv):
        idx = np.nonzero(mask)[0].tolist()
        if not idx:
            n_empty += 1
            print(f"  EMPTY (skipped): {sel}")
            continue
        golden["cases"][sel] = idx
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(golden))
    print(f"wrote {len(golden['cases'])} cases ({n_empty} empty skipped) to {OUT}")

    # Multi-model battery: every case evaluated against EVERY model/frame of
    # the file, so state-dependent selections are pinned per frame.
    from molar_tpu.io import FileHandler

    multi = {"files": {}}
    for fname, battery in (
        ("benzene.pdb", battery_benzene),
        ("multi.gro", battery_multigro),
    ):
        s = System.from_file(str(REF_TESTS / fname))
        fh = FileHandler(str(REF_TESTS / fname))
        per_sel: dict = {}
        n_frames = 0
        for st in fh.iter_states():
            n_frames += 1
            s.set_state(st)
            nv = Naive(s)
            for sel, mask in battery(nv):
                per_sel.setdefault(sel, []).append(np.nonzero(mask)[0].tolist())
        fh.close()
        multi["files"][fname] = {
            "n_atoms": int(s.n_atoms),
            "n_frames": n_frames,
            "cases": per_sel,
        }
        print(f"{fname}: {len(per_sel)} cases x {n_frames} frames")
    OUT_MULTI.write_text(json.dumps(multi))
    print(f"wrote multi-model battery to {OUT_MULTI}")


if __name__ == "__main__":
    main()
