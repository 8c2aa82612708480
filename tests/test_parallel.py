"""Frame-sharded multi-chip execution on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from molar_tpu.ops import measure
from molar_tpu.parallel import (
    frame_mesh,
    shard_window,
    sharded_window_fn,
)
from molar_tpu.parallel.mesh import pad_to_multiple


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    return frame_mesh()


def test_sharded_fit_rmsd_matches_single_device(mesh):
    rng = np.random.default_rng(0)
    b, n = 16, 64
    frames = rng.uniform(0, 5, (b, n, 3)).astype(np.float32)
    boxes = np.repeat(np.diag([5.0] * 3).astype(np.float32)[None], b, 0)
    invs = np.repeat(np.diag([0.2] * 3).astype(np.float32)[None], b, 0)
    times = np.arange(b, dtype=np.float32)
    ref = jnp.asarray(frames[0])
    masses = jnp.asarray(rng.uniform(1, 16, n).astype(np.float32))

    def window_fn(coords, boxes, invs, times):
        rmsd, _, _ = measure.fit_rmsd(coords, ref, masses)
        return jnp.mean(rmsd), rmsd

    fn = sharded_window_fn(window_fn, mesh)
    mean_s, rmsd_s = fn(*shard_window(mesh, frames, boxes, invs, times))
    mean_1, rmsd_1 = jax.jit(window_fn)(frames, boxes, invs, times)
    np.testing.assert_allclose(np.asarray(rmsd_s), np.asarray(rmsd_1), atol=1e-6)
    assert abs(float(mean_s) - float(mean_1)) < 1e-6
    # per-frame output really is frame-sharded
    assert len(rmsd_s.sharding.device_set) == len(mesh.devices)


def test_pad_to_multiple():
    a = np.arange(10 * 3).reshape(10, 3).astype(np.float32)
    (a2,), valid = pad_to_multiple((a,), 8)
    assert a2.shape[0] == 16
    assert valid.sum() == 10
    np.testing.assert_array_equal(a2[10:], np.repeat(a[-1:], 6, axis=0))
    (a3,), valid3 = pad_to_multiple((a[:8],), 8)
    assert a3.shape[0] == 8 and valid3.all()


def test_frame_atom_mesh_com_gyration(mesh):
    """2-D (frames x atoms) sharding: psum over the atom axis (SURVEY §2.7
    'multi-chip' row; for frames too large for one device's memory)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from molar_tpu.parallel import com_gyration_sharded, frame_atom_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    m2 = frame_atom_mesh(4, 2)
    fn = com_gyration_sharded(m2)
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 5, (8, 64, 3)).astype(np.float32)
    masses = rng.uniform(1, 16, 64).astype(np.float32)
    cj = jax.device_put(coords, NamedSharding(m2, P("frames", "atoms")))
    mj = jax.device_put(masses, NamedSharding(m2, P("atoms")))
    com, gyr = jax.block_until_ready(fn(cj, mj))
    want_com = (coords * masses[None, :, None]).sum(1) / masses.sum()
    d = coords - want_com[:, None, :]
    want_g = np.sqrt(((d * d).sum(-1) * masses).sum(1) / masses.sum())
    np.testing.assert_allclose(np.asarray(com), want_com, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gyr), want_g, atol=1e-5)
    assert len(com.sharding.device_set) == 8


# ---------------------------------------------------------------------------
# Production path: WindowPipeline(mesh=...) — frames over devices via shard_map
# ---------------------------------------------------------------------------


def _write_xtc(path, frames, box):
    from molar_tpu.io.xtc import XtcHandler

    w = XtcHandler(path, "w")
    for k, c in enumerate(frames):
        w.write_raw(c, box, step=k, time=float(k))
    w.close()


def _jittered_frames(rng, n, n_frames, box_side, sigma=0.01):
    frames = [rng.uniform(0, box_side, (n, 3)).astype(np.float32)]
    for _ in range(n_frames - 1):
        frames.append(
            frames[-1] + rng.normal(0, sigma, (n, 3)).astype(np.float32)
        )
    return frames


@pytest.mark.parametrize("transport", [False, True, "delta"])
def test_mesh_pipeline_matches_single_device(tmp_path, mesh, transport):
    """The PRODUCTION multi-chip path: a real XTC stream through
    WindowPipeline(mesh=...) must reproduce the single-device run
    bit-identically, across all three transport forms and a ragged tail."""
    from molar_tpu.ops import measure, neighbor
    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        WindowPipeline,
        decode_window_coords,
    )

    rng = np.random.default_rng(3)
    n, n_frames, box_side = 256, 19, 4.0  # 19 = 2 full windows + tail of 3
    frames = _jittered_frames(rng, n, n_frames, box_side)
    box = np.diag([box_side] * 3).astype(np.float32)
    path = str(tmp_path / "t.xtc")
    _write_xtc(path, frames, box)

    sel = jnp.arange(32)
    allidx = jnp.arange(n)
    ref = jnp.asarray(frames[0][:32])
    masses = jnp.asarray(rng.uniform(1, 16, 32).astype(np.float32))
    dims = neighbor.grid_dims([box_side] * 3, 0.5)

    @jax.jit
    def window_fn(coords, boxes, invs, times):
        coords = decode_window_coords(coords)

        def per_frame(carry, fr):
            c, b, i = fr
            s = jnp.stack([c[:, 0][sel], c[:, 1][sel], c[:, 2][sel]], -1)
            rmsd, _, _ = measure.fit_rmsd(s, ref, masses)
            mask, ofl = neighbor.within_mask(
                c, allidx, sel, cutoff=0.5, box=b, inv=i, dims=dims, cap=48
            )
            return carry, (rmsd, jnp.sum(mask), ofl)

        return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

    def collect(mesh_arg):
        reader = TrajectoryReader([path])
        pipe = WindowPipeline(
            reader, 8, window_fn, quantized=transport, mesh=mesh_arg
        )
        return [(ids, jax.tree.map(np.asarray, res)) for ids, res in pipe.run()]

    single = collect(None)
    sharded = collect(mesh)
    assert len(single) == len(sharded) == 3
    assert len(sharded[-1][0]) == 3  # ragged tail trimmed back
    for (i1, r1), (i2, r2) in zip(single, sharded):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(r1[0], r2[0])  # rmsd, bit-identical
        np.testing.assert_array_equal(r1[1], r2[1])  # within counts
        assert not np.any(r2[2])


def test_mesh_runner_delta_to_i16_exact():
    from molar_tpu.parallel.mesh import MeshWindowRunner

    rng = np.random.default_rng(5)
    ints = rng.integers(-3000, 3000, (1, 40, 3)).astype(np.int32)
    deltas = rng.integers(-127, 128, (6, 40, 3)).astype(np.int8)
    full = np.concatenate(
        [ints, ints + np.cumsum(deltas.astype(np.int32), axis=0)], axis=0
    )
    ic, scale = MeshWindowRunner._delta_to_i16(
        (full[0].astype(np.int16), deltas, np.float32(0.001))
    )
    assert ic.dtype == np.int16
    np.testing.assert_array_equal(ic.astype(np.int32), full)


def test_overflow_retry_mesh_mode(tmp_path, mesh):
    """run_with_overflow_retry(mesh=...): tier-0 overflows, the re-read +
    escalated tier runs through the SAME mesh runner, results match the
    single-device retry run exactly."""
    from molar_tpu.ops import neighbor
    from molar_tpu.tasks.trajectory import (
        TrajectoryReader,
        decode_window_coords,
        run_with_overflow_retry,
    )

    rng = np.random.default_rng(9)
    n, n_frames, box_side = 400, 16, 2.0
    frames = _jittered_frames(rng, n, n_frames, box_side)
    box = np.diag([box_side] * 3).astype(np.float32)
    path = str(tmp_path / "t.xtc")
    _write_xtc(path, frames, box)
    sel = jnp.arange(24)
    allidx = jnp.arange(n)
    dims = neighbor.grid_dims([box_side] * 3, 0.5)

    def build_fn(tier):
        cap = (4, 64)[min(tier, 1)]  # tier 0 overflows on purpose

        @jax.jit
        def window_fn(coords, boxes, invs, times):
            coords = decode_window_coords(coords)

            def per_frame(carry, fr):
                c, b, i = fr
                mask, ofl = neighbor.within_mask(
                    c, allidx, sel, cutoff=0.5, box=b, inv=i, dims=dims,
                    cap=cap,
                )
                return carry, (jnp.sum(mask), ofl)

            return jax.lax.scan(per_frame, 0, (coords, boxes, invs))[1]

        return window_fn

    def run(mesh_arg):
        reader = TrajectoryReader([path])
        res, retried = run_with_overflow_retry(
            reader, 8, build_fn, n_tiers=2, overflow_of=lambda r: r[1],
            mesh=mesh_arg,
        )
        assert retried == 2
        return [np.asarray(r[0]) for _, r in res]

    counts_1 = run(None)
    counts_m = run(mesh)
    for a, b in zip(counts_1, counts_m):
        np.testing.assert_array_equal(a, b)


def test_frame_mesh_refuses_more_devices_than_exist():
    import jax

    n = len(jax.devices())
    assert frame_mesh(n).devices.size == n
    with pytest.raises(ValueError, match="need"):
        frame_mesh(n + 1)
