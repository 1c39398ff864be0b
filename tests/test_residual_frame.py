"""residual_pipeline_frame (whole-frame block-diagonal matmul formulation) must
be bit-identical to the per-TU REF composition for every TU size and the
DST-VII intra case."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode.loop import EncodeConfig, _residual_pipeline
from hevcasm_tpu.kernels.xla_opt import residual_pipeline_frame


@pytest.mark.parametrize("tu", [4, 8, 16, 32])
def test_frame_pipeline_matches_ref(rng, tu):
    cfg = EncodeConfig(tu=tu, qp=30, residual_impl="ref")
    n, b = 5, 64
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    pred = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    want_rec, want_nnz, want_cbf = _residual_pipeline(
        jnp.asarray(src), jnp.asarray(pred), cfg, intra=False
    )
    qs, qh, qo = cfg.quant_params(False)
    ds, dh = cfg.dequant_params()
    got_rec, got_nnz, got_cbf, _ = residual_pipeline_frame(
        jnp.asarray(src), jnp.asarray(pred), qs, qh, qo, ds, dh, tu=tu, tr_type=0
    )
    np.testing.assert_array_equal(np.asarray(got_rec), np.asarray(want_rec))
    assert int(got_nnz) == int(want_nnz)
    np.testing.assert_array_equal(
        np.asarray(got_cbf).reshape(-1), np.asarray(want_cbf).reshape(-1)
    )


def test_frame_pipeline_dst(rng):
    # 4x4 intra luma TUs use the DST-VII (residual_decode.c:914).
    cfg = EncodeConfig(tu=4, qp=26, residual_impl="ref")
    n, b = 4, 32
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    pred = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    want_rec, want_nnz, _ = _residual_pipeline(
        jnp.asarray(src), jnp.asarray(pred), cfg, intra=True
    )
    qs, qh, qo = cfg.quant_params(True)
    ds, dh = cfg.dequant_params()
    got_rec, got_nnz, _, _ = residual_pipeline_frame(
        jnp.asarray(src), jnp.asarray(pred), qs, qh, qo, ds, dh, tu=4, tr_type=1
    )
    np.testing.assert_array_equal(np.asarray(got_rec), np.asarray(want_rec))
    assert int(got_nnz) == int(want_nnz)


def test_loop_default_is_mxu_and_bit_identical(rng):
    """encode_inter_frame default (XLA residual + XLA refine) must equal the
    all-REF configuration bit for bit."""
    from hevcasm_tpu.encode.loop import encode_inter_frame

    h = w = 192
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = np.roll(cur, (2, -3), axis=(0, 1)).astype(np.uint8)
    fast = encode_inter_frame(
        jnp.asarray(cur), jnp.asarray(ref), EncodeConfig(search_range=8, qp=30)
    )
    slow = encode_inter_frame(
        jnp.asarray(cur),
        jnp.asarray(ref),
        EncodeConfig(search_range=8, qp=30, residual_impl="ref", refine_impl="ref"),
    )
    np.testing.assert_array_equal(np.asarray(fast["recon"]), np.asarray(slow["recon"]))
    np.testing.assert_array_equal(np.asarray(fast["mvs"]), np.asarray(slow["mvs"]))
    assert int(fast["nnz"]) == int(slow["nnz"])
