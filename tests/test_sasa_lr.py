"""Exact device Lee-Richards SASA vs the host ground truth (round-1 review #8).

Contract: same slicing formulation on both sides => parity is pure float
error, ≤ 1e-4 relative per atom (reference exactness bar: sasa.rs PowerSasa
is exact; our host LR is exact-in-the-limit and the device must match it).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from molar_tpu import System
from molar_tpu.ops import sasa_host
from molar_tpu.ops.sasa_lr import max_displacement, neighbor_lists, sasa


def _rel_err(dev, host):
    scale = np.maximum(np.abs(host), 1e-3)
    return np.max(np.abs(dev - host) / scale)


def test_two_spheres_analytic():
    # Two equal spheres: exposed area = 4 pi r^2 - 2 pi r h (spherical cap)
    r = 0.3
    d = 0.4
    coords = np.array([[0, 0, 0], [d, 0, 0]], np.float64)
    radii = np.full(2, r)
    nbr, ofl = neighbor_lists(coords, radii, cap=4)
    assert not ofl
    dev = np.asarray(sasa(coords, radii, jnp.asarray(nbr), n_slices=256, block=2))
    h = r - d / 2
    want = 4 * np.pi * r * r - 2 * np.pi * r * h
    np.testing.assert_allclose(dev, want, rtol=2e-3)


def test_random_cluster_matches_host():
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 1.2, (60, 3))
    radii = rng.uniform(0.15, 0.3, 60)
    host = sasa_host.sasa(coords, radii - 0.0, probe=0.0, n_slices=48)
    nbr, ofl = neighbor_lists(coords, radii, cap=64)
    assert not ofl
    dev = np.asarray(
        sasa(coords, radii, jnp.asarray(nbr), n_slices=48, block=64)
    )
    assert _rel_err(dev, host) < 1e-4


def test_protein_matches_host(ref_data):
    sys_ = System.from_file(str(ref_data / "protein.pdb"))
    coords = sys_.state.coords.astype(np.float64)
    radii = sys_.topology.vdw().astype(np.float64) + 0.14
    host = sasa_host.sasa(coords, sys_.topology.vdw(), probe=0.14, n_slices=32)
    nbr, ofl = neighbor_lists(coords, radii, cap=128)
    assert not ofl
    dev = np.asarray(
        sasa(coords, radii, jnp.asarray(nbr), n_slices=32, block=512)
    )
    assert _rel_err(dev, host) < 1e-4
    # sanity: buried atoms ~0, surface atoms > 0
    assert (host > 0.01).sum() > 500


def test_verlet_skin_reuse():
    rng = np.random.default_rng(6)
    coords0 = rng.uniform(0, 2.0, (80, 3))
    radii = np.full(80, 0.25)
    skin = 0.2
    nbr, _ = neighbor_lists(coords0, radii, cap=96, skin=skin)
    # displace atoms by < skin/2: the list is still a superset, same result
    coords1 = coords0 + rng.uniform(-1, 1, coords0.shape) * (
        skin / (2 * np.sqrt(3)) * 0.99
    )
    assert float(max_displacement(jnp.asarray(coords1), jnp.asarray(coords0))) < skin / 2
    fresh, _ = neighbor_lists(coords1, radii, cap=96)
    a = np.asarray(sasa(coords1, radii, jnp.asarray(nbr), n_slices=32, block=80))
    b = np.asarray(sasa(coords1, radii, jnp.asarray(fresh), n_slices=32, block=80))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_neighbor_overflow_flag():
    coords = np.zeros((10, 3))
    radii = np.full(10, 0.3)
    _, ofl = neighbor_lists(coords, radii, cap=4)
    assert ofl


def test_sasa_series_update_reuse():
    """SasaSeries mirrors PowerSasa's update-reuse contract (sasa.rs:52-121):
    repeated updates stay exact across drift-triggered rebuilds."""
    from molar_tpu.ops.sasa_lr import SasaSeries

    rng = np.random.default_rng(11)
    c = rng.uniform(0, 1.5, (50, 3))
    vdw = np.full(50, 0.15)
    ss = SasaSeries(c, vdw, probe=0.14, skin=0.1, n_slices=32, cap=96, block=50)
    for k in range(6):
        c = c + rng.normal(0, 0.04, c.shape)  # guaranteed to exceed skin/2 soon
        got = np.asarray(ss.update(c))
        want = sasa_host.sasa(c, vdw, probe=0.14, n_slices=32)
        assert _rel_err(got, want) < 1e-4, k
    assert ss.rebuilds >= 1


def test_device_neighbor_lists_match_host_areas():
    """neighbor_lists_device (cell-grid, on-device, skin=0) must yield the
    SAME SASA as host-built skin=0 lists — membership may jitter only at
    exact-touching distances, which clip measure-zero arcs."""
    import jax.numpy as jnp

    from molar_tpu.ops import neighbor, sasa_lr

    rng = np.random.default_rng(19)
    n = 300
    coords = rng.uniform(0.8, 3.2, (n, 3)).astype(np.float64)
    radii = rng.uniform(0.25, 0.35, n)
    nb_host, ofl = sasa_lr.neighbor_lists(coords, radii, cap=256, skin=0.0)
    assert not ofl
    extents = (4.0, 4.0, 4.0)
    dims = neighbor.grid_dims(extents, 2 * radii.max())
    nb_dev, ofl_d = sasa_lr.neighbor_lists_device(
        jnp.asarray(coords, jnp.float32), jnp.asarray(radii, jnp.float32),
        extents, dims, cell_cap=64, k_cap=256, max_pairs=1 << 16,
    )
    assert not bool(ofl_d)
    cj = jnp.asarray(coords, jnp.float32)
    rj = jnp.asarray(radii, jnp.float32)
    a_host = np.asarray(sasa_lr.sasa(cj, rj, jnp.asarray(nb_host), n_slices=32))
    a_dev = np.asarray(sasa_lr.sasa(cj, rj, nb_dev, n_slices=32))
    np.testing.assert_allclose(a_dev, a_host, atol=1e-5)
    # and the list membership itself agrees away from the touching boundary
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    rr = radii[:, None] + radii[None, :]
    for i in range(0, n, 37):
        host_set = set(nb_host[i][nb_host[i] >= 0].tolist())
        dev_set = set(np.asarray(nb_dev[i])[np.asarray(nb_dev[i]) >= 0].tolist())
        diff = host_set ^ dev_set
        for j in diff:
            assert abs(d[i, j] - rr[i, j]) < 1e-5, (i, j)


def test_sasa_window_scan_matches_per_frame():
    import jax.numpy as jnp

    from molar_tpu.ops import neighbor, sasa_lr

    rng = np.random.default_rng(23)
    n, b = 150, 3
    base = rng.uniform(1.0, 3.0, (n, 3)).astype(np.float32)
    frames = np.stack([base + rng.normal(0, 0.01, (n, 3)).astype(np.float32)
                       for _ in range(b)])
    radii = jnp.asarray(rng.uniform(0.25, 0.35, n), jnp.float32)
    extents = (4.0, 4.0, 4.0)
    dims = neighbor.grid_dims(extents, 2 * float(np.asarray(radii).max()))
    areas, ofl = sasa_lr.sasa_window(
        jnp.asarray(frames), radii, extents, dims,
        cell_cap=64, k_cap=128, max_pairs=1 << 15, n_slices=32,
    )
    assert not np.any(np.asarray(ofl))
    for k in range(b):
        nbr, o = sasa_lr.neighbor_lists_device(
            jnp.asarray(frames[k]), radii, extents, dims, 64, 128, 1 << 15
        )
        want = sasa_lr.sasa(jnp.asarray(frames[k]), radii, nbr, n_slices=32)
        np.testing.assert_allclose(np.asarray(areas[k]), np.asarray(want),
                                   atol=1e-6)


def test_sasa_series_device_mode_matches_host_mode():
    import jax.numpy as jnp

    from molar_tpu.ops import sasa_lr

    rng = np.random.default_rng(31)
    n = 200
    base = rng.uniform(0.8, 3.2, (n, 3))
    vdw = rng.uniform(0.11, 0.21, n)
    host = sasa_lr.SasaSeries(base, vdw, skin=0.3, n_slices=32)
    dev = sasa_lr.SasaSeries(base, vdw, n_slices=32, extents=(4.0, 4.0, 4.0))
    c = base.copy()
    for k in range(3):
        c = c + rng.normal(0, 0.01, c.shape)
        a = np.asarray(host.update(c))
        b = np.asarray(dev.update(c))
        np.testing.assert_allclose(b, a, atol=2e-5)

def test_sasa_series_box_selects_device_mode():
    # box= with an orthorhombic box derives extents -> device mode engages
    # by default; triclinic falls back to host-Verlet mode.
    from molar_tpu.core.pbc import PeriodicBox
    from molar_tpu.ops import sasa_lr

    rng = np.random.default_rng(32)
    n = 64
    base = rng.uniform(0.8, 3.2, (n, 3))
    vdw = rng.uniform(0.11, 0.21, n)
    box = PeriodicBox(np.diag([4.0, 4.0, 4.0]).astype(np.float32))
    dev = sasa_lr.SasaSeries(base, vdw, n_slices=32, box=box)
    assert dev.extents is not None
    ref = sasa_lr.SasaSeries(base, vdw, n_slices=32, extents=(4.0, 4.0, 4.0))
    np.testing.assert_allclose(
        np.asarray(dev.update(base)), np.asarray(ref.update(base)), atol=1e-6
    )
    tri = np.array([[4.0, 0.5, 0.0], [0.0, 4.0, 0.0], [0.0, 0.0, 4.0]], np.float32)
    host = sasa_lr.SasaSeries(base, vdw, n_slices=32, box=tri)
    assert host.extents is None
