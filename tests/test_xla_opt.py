"""The optimized XLA tier (kernels/xla_opt) must be bit-exact with the REF
tier — the same contract the reference enforces between its asm tiers and the
C reference (hevcasm_test.c:96-104)."""

import numpy as np
import pytest

from hevcasm_tpu import ops
from hevcasm_tpu.kernels import xla_opt
import oracles


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_forward_transform_matches_ref(rng, n):
    src = (rng.integers(-32768, 32768, (3, n, n))).astype(np.int16)
    got = np.asarray(xla_opt.forward_transform(src))
    want = np.asarray(ops.forward_transform(src))
    np.testing.assert_array_equal(got, want)


def test_forward_dst_matches_ref(rng):
    src = (rng.integers(-32768, 32768, (3, 4, 4))).astype(np.int16)
    np.testing.assert_array_equal(
        np.asarray(xla_opt.forward_transform(src, tr_type=1)),
        np.asarray(ops.forward_transform(src, tr_type=1)),
    )


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_inverse_transform_add_matches_ref(rng, n):
    coeffs = rng.integers(0, 0x10000, (3, n, n)).astype(np.uint16).astype(np.int16)
    pred = rng.integers(0, 256, (3, n, n), dtype=np.uint8)
    got = np.asarray(xla_opt.inverse_transform_add(coeffs, pred))
    want = np.asarray(ops.inverse_transform_add(coeffs, pred))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_satd_matches_ref(rng, n):
    a = rng.integers(0, 256, (5, n, n), dtype=np.uint8)
    b = rng.integers(0, 256, (5, n, n), dtype=np.uint8)
    got = np.asarray(xla_opt.satd(a, b))
    want = np.asarray(ops.satd(a, b))
    np.testing.assert_array_equal(got, want)


def test_ssd_grid_matches_scalar(rng):
    """XLA ssd_grid == REF scan formulation == scalar oracle."""
    n, h, w, dys, dxs = 3, 16, 16, 7, 9
    src = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    win = rng.integers(0, 256, (n, h + dys - 1, w + dxs - 1), dtype=np.uint8)
    got = np.asarray(xla_opt.ssd_grid(src, win, dys, dxs))
    ref = np.asarray(xla_opt.ssd_grid_ref(src, win, dys, dxs))
    np.testing.assert_array_equal(got, ref)
    for i in range(n):
        for dy in range(dys):
            for dx in range(0, dxs, 3):
                want = oracles.ssd(src[i], win[i, dy : dy + h, dx : dx + w])
                assert got[i, dy, dx] == want


def test_ssd_grid_ctu_sized(rng):
    """Full CTU geometry (64x64 block, +-8 window) stays exact."""
    n, h, r = 2, 64, 8
    src = rng.integers(0, 256, (n, h, h), dtype=np.uint8)
    win = rng.integers(0, 256, (n, h + 2 * r, h + 2 * r), dtype=np.uint8)
    got = np.asarray(xla_opt.ssd_grid(src, win, 2 * r + 1, 2 * r + 1))
    ref = np.asarray(xla_opt.ssd_grid_ref(src, win, 2 * r + 1, 2 * r + 1))
    np.testing.assert_array_equal(got, ref)
