"""On-device parity suite: jitted kernels on the accelerator vs host numpy.

Every other test file runs on the CPU backend (conftest forces it), which
cannot see accelerator-only numeric behavior — above all a float32 matmul
silently running in TF32 on a GPU, and scatter-adds whose order changes
from run to run. This suite runs the production device paths on whatever
JAX's default backend is and compares them against the host ground truth.
Each tolerance states its reason beside it.

Run alone, one process per card (``chip_smoke.py`` runs it in-process):

    MOLAR_DEVICE_TESTS=1 python -m pytest tests/test_device_parity.py -q

Without ``MOLAR_DEVICE_TESTS`` every test here skips; ``MOLAR_DEVICE_TESTS=cpu``
rehearses the suite on the CPU backend (see tests/conftest.py). Whether to
run is decided in a fixture, never at import time, so every pytest-xdist
worker collects the same tests.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.device


@pytest.fixture(autouse=True)
def device_backend():
    """Skip unless MOLAR_DEVICE_TESTS asks for the suite; return the
    platform it runs on."""
    mode = os.environ.get("MOLAR_DEVICE_TESTS", "")
    if not mode:
        pytest.skip("device parity suite: set MOLAR_DEVICE_TESTS=1 to run it "
                    "on the accelerator (or =cpu to rehearse it)")
    return jax.devices()[0].platform


N_ATOMS = 3000
N_SEL = 400
BOX = 5.0
CUTOFF = 0.5


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    coords = rng.uniform(0, BOX, (N_ATOMS, 3)).astype(np.float32)
    masses = rng.uniform(1.0, 16.0, N_ATOMS).astype(np.float32)
    sel = np.sort(rng.choice(N_ATOMS, N_SEL, replace=False)).astype(np.int64)
    box = np.diag([BOX] * 3).astype(np.float32)
    return coords, masses, sel, box


def _pbc(box):
    from molar_tpu import PeriodicBox

    return PeriodicBox(box)


def test_backend_is_accelerator(device_backend):
    # The suite only means something on the accelerator; =cpu is the
    # explicit rehearsal mode.
    print(f"backend: {device_backend}")
    assert device_backend != "cpu" or (
        os.environ.get("MOLAR_DEVICE_TESTS") == "cpu"
    ), "device parity suite ran on the CPU backend; set =cpu to rehearse"


def test_within_mask_matches_host(frame):
    from molar_tpu.core.pbc import PBC_FULL
    from molar_tpu.ops import neighbor, neighbor_host

    coords, masses, sel, box = frame
    pb = _pbc(box)
    dims = neighbor.grid_dims(pb.box_extents(), CUTOFF)
    cell_cap, tgt_cap, _ = neighbor.estimate_caps(
        coords.astype(np.float64), np.diag(1.0 / np.diag(box)), dims, sel
    )
    fn = jax.jit(
        lambda c: neighbor.within_mask(
            c, None, jnp.asarray(sel), CUTOFF,
            jnp.asarray(box), jnp.asarray(pb.inv),
            dims=dims, cap=cell_cap, tgt_cap=tgt_cap,
        )
    )
    mask, ofl = fn(jnp.asarray(coords))
    assert not bool(ofl)
    got = np.nonzero(np.asarray(mask))[0]
    want = neighbor_host.search_within(
        CUTOFF, coords, np.arange(N_ATOMS), sel, pb, PBC_FULL
    )
    np.testing.assert_array_equal(got, np.sort(want))


def test_contact_pairs_match_host(frame):
    from molar_tpu.ops import neighbor

    coords, masses, sel, box = frame
    pb = _pbc(box)
    lig = np.arange(40, dtype=np.int64) * 7  # scattered "ligand"
    dims = neighbor.grid_dims(pb.box_extents(), CUTOFF)
    pairs, dist, cnt, ofl = jax.jit(
        lambda c: neighbor.contact_pairs(
            c, jnp.asarray(sel), jnp.asarray(lig), CUTOFF,
            jnp.asarray(box), jnp.asarray(pb.inv),
            dims=dims, cap=64, max_pairs=1 << 13,
        )
    )(jnp.asarray(coords))
    assert not bool(ofl)
    got = {
        (int(a), int(b))
        for a, b in np.asarray(pairs)[: int(cnt)]
    }
    # brute-force host ground truth
    d = coords[sel][:, None, :] - coords[lig][None, :, :]
    d -= BOX * np.rint(d / BOX)
    hits = np.nonzero((d**2).sum(-1) < CUTOFF**2)
    want = {(int(sel[i]), int(lig[j])) for i, j in zip(*hits)}
    assert got == want


def test_fit_rmsd_matches_host_1e5(frame):
    """The reduced-precision-matmul canary: Kabsch + RMSD must hold 1e-5 on
    device (a TF32 or bf16 product anywhere in the fit breaks it)."""
    from molar_tpu.ops import measure, measure_host

    coords, masses, sel, box = frame
    rng = np.random.default_rng(7)
    mob = (coords[sel] + rng.normal(0, 0.05, (N_SEL, 3))).astype(np.float32)
    ref = coords[sel]
    m = masses[sel]
    rmsd_d, r, t = jax.jit(measure.fit_rmsd)(
        jnp.asarray(mob), jnp.asarray(ref), jnp.asarray(m)
    )
    rh, th = measure_host.fit_transform(mob, ref, m)
    fitted = measure_host.apply_transform(mob, rh, th)
    rmsd_h = measure_host.rmsd_mw(fitted, ref, m)
    np.testing.assert_allclose(float(rmsd_d), rmsd_h, rtol=1e-5, atol=1e-7)


def test_segment_com_gyration_match_host(frame):
    from molar_tpu.ops import measure_host

    coords, masses, sel, box = frame
    seg = np.repeat(np.arange(N_SEL // 20), 20)
    nseg = N_SEL // 20

    @jax.jit
    def dev(c, m):
        msum = jax.ops.segment_sum(m, seg, num_segments=nseg)
        com = jax.ops.segment_sum(c * m[:, None], seg, num_segments=nseg) / msum[:, None]
        d = c - com[seg]
        g2 = jax.ops.segment_sum(jnp.sum(d * d, -1) * m, seg, num_segments=nseg) / msum
        return com, jnp.sqrt(g2)

    com_d, gyr_d = dev(jnp.asarray(coords[sel]), jnp.asarray(masses[sel]))
    # COM 2e-6 and gyration 2e-5: f32 sums against the f64 host, in an order
    # that segment_sum's scatter-add (atomics on a GPU) changes run to run.
    for s in range(nseg):
        rows = seg == s
        np.testing.assert_allclose(
            np.asarray(com_d)[s],
            measure_host.center(coords[sel][rows], masses[sel][rows]),
            rtol=2e-6, atol=2e-6,
        )
        np.testing.assert_allclose(
            float(np.asarray(gyr_d)[s]),
            measure_host.gyration(coords[sel][rows], masses[sel][rows]),
            rtol=2e-5,
        )


def test_compiled_selection_triclinic(frame):
    from molar_tpu import PeriodicBox, SelectionExpr, System
    from molar_tpu.core.atom import Atom
    from molar_tpu.core.state import State
    from molar_tpu.core.topology import Topology

    coords, masses, sel, _ = frame
    tric = np.array(
        [[BOX, 0, 0], [0.8, BOX, 0], [0.4, 0.6, BOX]], np.float32
    ).T  # columns = box vectors
    atoms = [
        Atom(name="CA" if i % 5 == 0 else "C", resname="ALA",
             resid=i // 5 + 1, atomic_number=6, mass=12.0)
        for i in range(N_ATOMS)
    ]
    top = Topology.from_atoms(atoms)
    top.assign_resindex()
    sysm = System(top, State(coords=coords, box=PeriodicBox(tric)))
    expr = SelectionExpr("name CA and within 0.6 pbc of resid 3")
    want = expr.apply(sysm.topology, sysm.state)
    comp = expr.compile_device(sysm.topology, sysm.state)
    mask = jax.jit(comp)(
        jnp.asarray(coords),
        jnp.asarray(sysm.state.box.matrix),
        jnp.asarray(sysm.state.box.inv),
    )
    got = np.nonzero(np.asarray(mask))[0]
    np.testing.assert_array_equal(got, want)


def test_sasa_matches_host(frame):
    from molar_tpu.ops import sasa_host, sasa_lr

    coords, masses, sel, box = frame
    rng = np.random.default_rng(5)
    pts = coords[sel][:100].astype(np.float64)
    radii = rng.uniform(0.15, 0.25, 100) + 0.14
    nbr, _ = sasa_lr.neighbor_lists(pts, radii, cap=128, skin=0.0)
    areas_d = jax.jit(
        lambda c, r: sasa_lr.sasa(c, r, jnp.asarray(nbr), n_slices=32,
                                  block=128)
    )(jnp.asarray(pts, jnp.float32), jnp.asarray(radii, jnp.float32))
    areas_h = sasa_host.sasa(
        pts, radii - 0.14, probe=0.14, n_slices=32
    )
    if isinstance(areas_h, tuple):
        areas_h = areas_h[0]
    # Same 32-slice discretisation on both sides; 5e-4 covers f32 arc
    # arithmetic against the f64 host.
    np.testing.assert_allclose(
        np.asarray(areas_d), areas_h, rtol=5e-4, atol=5e-5
    )


def test_delta_transport_bit_exact_on_device(frame):
    from molar_tpu.tasks.trajectory import decode_window_coords

    coords, *_ = frame
    ints0 = np.round(coords * 1000).astype(np.int16)
    rng = np.random.default_rng(3)
    deltas = rng.integers(-90, 90, (7, N_ATOMS, 3), dtype=np.int8)
    scale = np.float32(1.0 / 1000.0)
    dev = jax.jit(decode_window_coords)((
        jnp.asarray(ints0), jnp.asarray(deltas), scale
    ))
    ints = np.concatenate(
        [ints0[None].astype(np.int32),
         ints0[None].astype(np.int32) + np.cumsum(deltas.astype(np.int32), 0)]
    )
    np.testing.assert_array_equal(
        np.asarray(dev), (ints.astype(np.float32) * scale)
    )


def test_chunked_delta_transport_bit_exact_on_device(frame):
    """put_chunks form: chunked deltas reassembled in-graph must be
    bit-identical to the single-array decode on the device."""
    from molar_tpu.tasks.trajectory import _chunk_coords, decode_window_coords

    coords, *_ = frame
    ints0 = np.round(coords * 1000).astype(np.int16)
    rng = np.random.default_rng(5)
    deltas = rng.integers(-90, 90, (7, N_ATOMS, 3), dtype=np.int8)
    scale = np.float32(1.0 / 1000.0)
    whole = jax.jit(decode_window_coords)(
        (jnp.asarray(ints0), jnp.asarray(deltas), scale)
    )
    chunked = _chunk_coords((ints0, deltas, scale), 3)
    dev = jax.jit(decode_window_coords)(
        jax.tree_util.tree_map(jnp.asarray, chunked)
    )
    np.testing.assert_array_equal(np.asarray(dev), np.asarray(whole))


def test_subset_window_stream_matches_full_on_device(frame, tmp_path):
    """Subset transport: a subset-sliced delta window decoded on device
    equals the sliced full-frame decode (the workload wire path)."""
    from molar_tpu.io.xtc import XtcHandler
    from molar_tpu.tasks.trajectory import TrajectoryReader, decode_window_coords

    coords, masses, sel, box = frame
    p = str(tmp_path / "sub.xtc")
    w = XtcHandler(p, "w")
    rng = np.random.default_rng(7)
    c = coords.copy()
    for k in range(6):
        c = c + rng.normal(0, 0.01, c.shape).astype(np.float32)
        w.write_raw(c, box, step=k, time=float(k))
    w.close()
    fn = jax.jit(decode_window_coords)
    full = [
        np.asarray(fn(jax.device_put(cw)))
        for cw, *_ in TrajectoryReader([p]).iter_windows(3, quantized="delta")
    ]
    sub = [
        np.asarray(fn(jax.device_put(cw)))
        for cw, *_ in TrajectoryReader([p]).iter_windows(
            3, quantized="delta", subset=sel
        )
    ]
    for f, s in zip(full, sub):
        np.testing.assert_array_equal(s, f[:, sel])


def test_membrane_window_matches_host(tmp_path):
    from molar_tpu.membrane import Membrane, MembraneDevice

    # tests/ is on sys.path under pytest (a top-level ``tests`` package
    # installed elsewhere would shadow ``tests.``-qualified imports)
    import test_membrane_device as T

    sysm = T.make_bilayer(5, 5)
    memb = Membrane(sysm, T.TOML.format(out=str(tmp_path), extra=""))
    memb.add_ids_to_group("all", range(len(memb.lipids)))
    dev = MembraneDevice(memb)
    rng = np.random.default_rng(3)
    c = (sysm.state.coords + rng.normal(0, 0.01, sysm.state.coords.shape)).astype(np.float32)
    outs = dev.compute_window(np.stack([c[dev.subset]]))
    sysm.state.coords = c.copy()
    memb.compute()
    hv = np.array([l.valid for l in memb.lipids])
    np.testing.assert_array_equal(outs["valid"][0], hv)
    # 2e-3: f32 quadric fit + Voronoi vertices against the f64 host pipeline.
    np.testing.assert_allclose(
        outs["area"][0][hv],
        np.array([l.area for l in memb.lipids])[hv],
        rtol=2e-3,
    )


def test_lipid_order_matches_host(frame):
    from molar_tpu.membrane.device import _order_batch
    from molar_tpu.ops import measure_host

    rng = np.random.default_rng(9)
    tc = rng.normal(0, 1, (24, 6, 3)).astype(np.float32)
    normals = rng.normal(0, 1, (24, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    orders = (1, 1, 1, 1, 1)
    dev = jax.jit(lambda c, n: _order_batch("scdcorr", c, n, orders))(
        jnp.asarray(tc), jnp.asarray(normals)
    )
    host = measure_host.lipid_tail_order_batch(
        "scdcorr", tc.astype(np.float64), normals.astype(np.float64),
        np.asarray(orders),
    )
    # f32 bond vectors and normals against f64 host math.
    np.testing.assert_allclose(np.asarray(dev), host, rtol=2e-4, atol=2e-5)


def test_shortest_vector_triclinic(frame):
    from molar_tpu import PeriodicBox
    from molar_tpu.core import pbc as P

    rng = np.random.default_rng(2)
    tric = np.array([[4.0, 0, 0], [1.2, 4.0, 0], [0.7, 0.9, 4.0]], np.float32).T
    pb = PeriodicBox(tric)
    v = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    dev = jax.jit(
        lambda x: P.shortest_vector(
            x, jnp.asarray(pb.matrix), jnp.asarray(pb.inv),
            jnp.asarray(pb.corrections),
        )
    )(jnp.asarray(v))
    host = pb.shortest_vector(v.astype(np.float64))
    # f32 wrap of |v| up to 6 nm against the f64 host.
    np.testing.assert_allclose(np.asarray(dev), host, rtol=2e-5, atol=2e-5)
