"""The banded-matmul refinement must be bit-identical to the jnp FIR
path (motion.refine_quarter_pel), including argmin tie-breaking."""

import numpy as np
import jax.numpy as jnp

from hevcasm_tpu.encode import motion
from hevcasm_tpu.kernels.interp_xla import refine_quarter_pel_mxu


def test_refine_mxu_matches(rng):
    n, b, r = 7, 64, 8
    h = w = b + 2 * r + motion.TAPS - 1
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    plane = rng.integers(0, 256, (3 * b, 3 * b), dtype=np.uint8)
    pos = np.stack(
        [rng.integers(0, b, n), rng.integers(0, b, n)], axis=-1
    ).astype(np.int32)
    mv = rng.integers(-r, r + 1, (n, 2)).astype(np.int32)
    pad = np.pad(plane, ((r + motion.PAD_L, r + motion.PAD_R),) * 2, mode="edge")

    want_pred, want_mv, _ = motion.refine_quarter_pel(
        jnp.asarray(src), jnp.asarray(pad), jnp.asarray(pos), jnp.asarray(mv), r
    )
    start = jnp.asarray(pos + mv + r)
    win = motion.extract_windows(jnp.asarray(pad), start, b + motion.TAPS - 1)
    got_pred, frac, _ = refine_quarter_pel_mxu(jnp.asarray(src), win)
    got_mv = jnp.asarray(mv) * 4 + jnp.stack([frac // 4, frac % 4], axis=-1)

    np.testing.assert_array_equal(np.asarray(got_mv), np.asarray(want_mv))
    np.testing.assert_array_equal(np.asarray(got_pred), np.asarray(want_pred))


def test_refine_tie_break_flat_input(rng):
    # Flat windows make many fracs tie; first minimum (frac 0) must win in
    # both implementations.
    n, b = 3, 64
    src = np.full((n, b, b), 77, np.uint8)
    win = np.full((n, b + 7, b + 7), 77, np.uint8)
    pred, frac, cost = refine_quarter_pel_mxu(jnp.asarray(src), jnp.asarray(win))
    assert np.asarray(frac).tolist() == [0, 0, 0]
    assert np.asarray(cost).tolist() == [0, 0, 0]
    np.testing.assert_array_equal(np.asarray(pred), src)
