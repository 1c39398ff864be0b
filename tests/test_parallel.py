"""Multi-chip sharding on the 8-virtual-device CPU mesh: data-parallel GOP
and spatially-sharded frames with ppermute halo exchange must match the
single-chip encode bit-exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode.loop import encode_inter_frame
from hevcasm_tpu.parallel import (
    make_mesh,
    encode_gop_data_parallel,
    encode_inter_frame_spatial,
)


@pytest.fixture(autouse=True)
def _need_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _clip(rng, t, h, w):
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t), dtype=np.uint8)
    return np.stack([base[2 * i : 2 * i + h, 3 * i : 3 * i + w] for i in range(t)])


def test_gop_data_parallel_matches_single_chip(rng):
    frames = _clip(rng, 5, 128, 128)  # 4 P-frames over 4-device axis
    cfg = EncodeConfig(search_range=4, qp=32)
    mesh = make_mesh(frames=4, rows=2)
    out = encode_gop_data_parallel(jnp.asarray(frames), mesh, cfg)
    single = [
        encode_inter_frame(jnp.asarray(frames[t]), jnp.asarray(frames[t - 1]), cfg)
        for t in range(1, 5)
    ]
    got = np.asarray(out["recon"])
    for t in range(4):
        np.testing.assert_array_equal(got[t], np.asarray(single[t]["recon"]))


@pytest.mark.parametrize("rows", [2])
def test_spatial_sharding_bit_exact(rng, rows):
    """CTU-row band sharding + ppermute halo == single chip, including CTUs
    whose best MV crosses the shard boundary."""
    h, w = 64 * rows * 2, 128
    frames = _clip(rng, 2, h, w)
    cfg = EncodeConfig(search_range=8, qp=32)
    single = encode_inter_frame(jnp.asarray(frames[1]), jnp.asarray(frames[0]), cfg)

    mesh = make_mesh(frames=8 // rows, rows=rows)
    sh = NamedSharding(mesh, P("rows", None))
    out = encode_inter_frame_spatial(
        jax.device_put(jnp.asarray(frames[1]), sh),
        jax.device_put(jnp.asarray(frames[0]), sh),
        mesh,
        cfg,
    )
    np.testing.assert_array_equal(np.asarray(out["recon"]), np.asarray(single["recon"]))
    assert abs(float(out["psnr_db"]) - float(single["psnr_db"])) < 1e-3
    assert int(out["nnz"]) == int(single["nnz"])


def test_vertical_motion_crosses_shard_boundary(rng):
    """Plant vertical motion larger than a CTU so windows genuinely need the
    neighbour's halo rows."""
    rows, h, w, r = 2, 256, 128, 8
    base = rng.integers(0, 256, (h + 2 * r, w + 2 * r), dtype=np.uint8)
    ref = base[r : r + h, r : r + w]
    cur = base[r + 6 : r + 6 + h, r : r + w]  # dy = +6
    cfg = EncodeConfig(search_range=8, qp=32)
    single = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)

    mesh = make_mesh(frames=4, rows=rows)
    sh = NamedSharding(mesh, P("rows", None))
    out = encode_inter_frame_spatial(
        jax.device_put(jnp.asarray(cur), sh),
        jax.device_put(jnp.asarray(ref), sh),
        mesh,
        cfg,
    )
    np.testing.assert_array_equal(np.asarray(out["recon"]), np.asarray(single["recon"]))


def test_closed_loop_gop_spatial_bit_exact(rng):
    """Closed-loop GOP (P frames reference reconstructions) with spatial
    row sharding == the single-chip closed-loop GOP, frame by frame."""
    from hevcasm_tpu.encode.video import encode_gop_closed_loop
    from hevcasm_tpu.parallel import encode_gop_closed_loop_spatial

    t, h, w = 4, 256, 128
    frames = _clip(rng, t, h, w)
    cfg = EncodeConfig(search_range=8, qp=32)

    single = encode_gop_closed_loop(jnp.asarray(frames), cfg, num_frames=t)
    mesh = make_mesh(frames=4, rows=2)
    out = encode_gop_closed_loop_spatial(jnp.asarray(frames), mesh, cfg)

    np.testing.assert_array_equal(
        np.asarray(out["recon"]), np.asarray(single["recon"])
    )
    np.testing.assert_allclose(
        np.asarray(out["psnr_db"]), np.asarray(single["psnr_db"]), atol=1e-3
    )


def test_multihost_mesh_layout():
    """make_global_mesh: axis order puts 'rows' innermost (ICI-adjacent) and
    covers every device exactly once."""
    from hevcasm_tpu.parallel.multihost import make_global_mesh

    mesh = make_global_mesh(frames=4, rows=2)
    assert mesh.axis_names == ("frames", "rows")
    assert mesh.devices.shape == (4, 2)
    devs = jax.devices()
    # row-major: device i lands at (i // rows, i % rows) -> 'rows' innermost
    for i, d in enumerate(mesh.devices.reshape(-1)):
        assert d == devs[i]
    import pytest as _pytest
    with _pytest.raises(AssertionError):
        make_global_mesh(frames=3, rows=2)


def test_multihost_initialize_idempotent():
    """initialize() must be safe single-process and safe to call twice."""
    from hevcasm_tpu.parallel.multihost import initialize

    initialize()
    initialize()  # second call must not raise
