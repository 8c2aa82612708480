"""molar_tpu — an accelerator-native molecular trajectory analysis framework.

A ground-up JAX/XLA rebuild of the capabilities of MolAR
(yesint/molar): structure/trajectory IO, a VMD-like selection language,
per-frame geometric analysis (RMSD/Kabsch fitting, COM/gyration/inertia,
PBC-aware cell-grid distance search, SASA, secondary structure, membrane
properties) and system editing — designed device-first: structure-of-arrays
device buffers, selections compiled to static index/mask arrays, analysis
windows executed as one jitted/vmapped XLA program with frames sharded over
the device mesh.

Units: nm (length), ps (time), amu (mass), e (charge).
"""

from . import config
from .core import (
    Atom,
    BondOrder,
    FrameBatch,
    PBC_FULL,
    PBC_NONE,
    PbcDims,
    PeriodicBox,
    PeriodicBoxError,
    State,
    Topology,
)
from .core.system import Particle, Sel, SelectionError, System, distance_search
from .selection import SelectionExpr, SelectionSyntaxError

__version__ = "0.5.0"


# -- pymolar-compat module-level entry points (molar.pyi:203-208) -------------
# The reference bindings expose these as free functions over two selections;
# natively they are Sel methods.


def greeting(task: str = "molar_tpu") -> None:
    from .utils.greeting import greeting as _g

    _g(task)


def fit_transform(sel1: Sel, sel2: Sel):
    """(rotation, translation) fitting ``sel1`` onto ``sel2``
    (pymolar free function; natively ``sel1.fit_transform(sel2)``)."""
    return sel1.fit_transform(sel2)


def fit_transform_matching(sel1: Sel, sel2: Sel):
    return sel1.fit_transform_matching(sel2)


def rmsd_py(sel1: Sel, sel2: Sel) -> float:
    """Unweighted RMSD (pymolar naming; natively ``sel1.rmsd(sel2)``)."""
    return sel1.rmsd(sel2)


def rmsd_mw(sel1: Sel, sel2: Sel) -> float:
    return sel1.rmsd_mw(sel2)
