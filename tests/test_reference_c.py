"""Differential tests against the GENUINE kupix/hevcasm C reference.

Every other test in this repo compares our tiers against self-written
transcriptions (tests/oracles.py, native/hevcref.cpp); a shared misreading
of the C would pass all of them.  This module closes that hole: the actual
upstream C files are compiled unmodified (Makefile `cref` target, reference
tree consumed in place at /root/reference) and every kernel family's REF
tier is swept against them over the reference's own shape matrices:

  SAD: the 23-partition sweep incl. AMP widths (sad.c:231-240)
  MC:  24 partitions x frac cases scaled by taps (pred_inter.c:436-458)
  quant/transform: log2 sizes 2..5 (quantize.c:281, residual_decode.c:1006)
  SSD: log2 2..6 (ssd.c:157); SATD 2/4/8 (hadamard.c)

The optimized tiers are separately proven bit-equal to the REF tier
(tests/test_xla_opt.py, test_xla_paths.py, ...), so transitivity covers them.

Skips when the reference tree is not mounted.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu import cref
from hevcasm_tpu import ops

pytestmark = pytest.mark.skipif(
    not cref.available(), reason="reference tree not mounted"
)

PARTITIONS = [  # sad.c:231-240
    (64, 64), (64, 48), (64, 32), (64, 16), (48, 64),
    (32, 64), (32, 32), (32, 24), (32, 16), (32, 8), (24, 32),
    (16, 64), (16, 32), (16, 16), (16, 12), (16, 8), (16, 4), (12, 16),
    (8, 32), (8, 16), (8, 8), (8, 4), (4, 8),
]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0xC0DEC)


def test_sad_all_partitions(rng):
    src = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    ref = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    for (w, h) in PARTITIONS:
        want = cref.sad(src[:h, :w], ref[1 : 1 + h, 1 : 1 + w])
        got = int(ops.sad(jnp.asarray(src[:h, :w]), jnp.asarray(ref[1 : 1 + h, 1 : 1 + w])))
        assert got == want, (w, h)


def test_sad_multiref(rng):
    src = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    refs = rng.integers(0, 256, (4, 64, 64), dtype=np.uint8)
    for (w, h) in [(64, 64), (32, 16), (16, 16), (8, 8), (12, 16), (48, 64)]:
        want = cref.sad_multiref(src[:h, :w], refs[:, :h, :w].copy())
        got = np.asarray(ops.sad_multiref(jnp.asarray(src[:h, :w]), jnp.asarray(refs[:, :h, :w])))
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h}")


def test_ssd_sizes(rng):
    a = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    for log2 in (2, 3, 4, 5, 6):
        n = min(1 << log2, 64)
        if (1 << log2) > 64:
            break
        want = cref.ssd(a[:n, :n], b[:n, :n])
        got = int(ops.ssd(jnp.asarray(a[:n, :n]), jnp.asarray(b[:n, :n])))
        assert got == want, n


def test_ssd_linear(rng):
    a = rng.integers(0, 256, (0x200,), dtype=np.uint8)
    b = rng.integers(0, 256, (0x200,), dtype=np.uint8)
    assert int(ops.ssd_linear(jnp.asarray(a), jnp.asarray(b))) == cref.ssd_linear(a, b)


def test_satd_sizes(rng):
    for n in (2, 4, 8):
        a = rng.integers(0, 256, (n, n), dtype=np.uint8)
        b = rng.integers(0, 256, (n, n), dtype=np.uint8)
        want = cref.satd(a, b)
        got = int(ops.satd(jnp.asarray(a), jnp.asarray(b)))
        assert got == want, n


def test_quantize(rng):
    # rand()-rand() full-range input (quantize.c:271); asserted param ranges
    # scale < 0x8000, 16 <= shift <= 27 (quantize.c:162-165).
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        src = (rng.integers(0, 32768, (n, n)) - rng.integers(0, 32768, (n, n))).astype(np.int16)
        # asserted ranges: scale < 0x8000, offset < 0x8000, 16 <= shift <= 27
        # (quantize.c:162-165); offset is pre-shift (<< (shift-16) inside).
        for (scale, shift, offset) in [(20560, 23, 10880), (26214, 16, 0), (14564, 27, 21888)]:
            want, want_cbf = cref.quantize(src, scale, shift, offset)
            got, got_cbf = ops.quantize(jnp.asarray(src), scale, shift, offset)
            np.testing.assert_array_equal(np.asarray(got).reshape(-1), want.reshape(-1))
            assert bool(got_cbf) == want_cbf


def test_quantize_inverse(rng):
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        src = (rng.integers(0, 256, (n, n)) - 0x100).astype(np.int16)
        for (scale, shift) in [(1632, 2), (51, 14), (72 << 7, 1)]:
            want = cref.quantize_inverse(src, scale, shift)
            got = ops.quantize_inverse(jnp.asarray(src), scale, shift)
            np.testing.assert_array_equal(np.asarray(got).reshape(-1), want.reshape(-1))


def test_reconstruct(rng):
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        pred = rng.integers(0, 256, (n, n), dtype=np.uint8)
        res = (rng.integers(0, 0x200, (n, n)) - 0x100).astype(np.int16)
        want = cref.reconstruct(pred, res)
        got = ops.reconstruct(jnp.asarray(pred), jnp.asarray(res))
        np.testing.assert_array_equal(np.asarray(got), want)


def test_forward_transform(rng):
    # extreme coefficients fixture (residual_decode.c:1000): 9-bit residuals
    for (n, tr_type) in [(4, 1), (4, 0), (8, 0), (16, 0), (32, 0)]:
        src = (rng.integers(0, 0x200, (n, n)) - 0x100).astype(np.int16)
        want = cref.forward_transform(src, tr_type)
        got = ops.forward_transform(jnp.asarray(src), tr_type)
        np.testing.assert_array_equal(np.asarray(got).reshape(-1), want.reshape(-1),
                                      err_msg=f"{n} tr{tr_type}")


def test_inverse_transform_add(rng):
    # ((rand()<<1)^rand()) & 0xffff extreme coefficients (residual_decode.c:574)
    for (n, tr_type) in [(4, 1), (4, 0), (8, 0), (16, 0), (32, 0)]:
        coeffs = rng.integers(0, 0x10000, (n, n)).astype(np.uint16).astype(np.int16)
        pred = rng.integers(0, 256, (n, n), dtype=np.uint8)
        want = cref.inverse_transform_add(coeffs, pred, tr_type)
        got = ops.inverse_transform_add(jnp.asarray(coeffs), jnp.asarray(pred), tr_type)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=f"{n} tr{tr_type}")


MC_PARTITIONS = [  # pred_inter.c:436-458 (luma sizes; chroma = scaled by taps/8)
    (64, 64), (64, 48), (64, 32), (64, 16), (48, 64), (32, 64), (32, 32),
    (32, 24), (32, 16), (32, 8), (24, 32), (16, 64), (16, 32), (16, 16),
    (16, 12), (16, 8), (16, 4), (12, 16), (8, 32), (8, 16), (8, 8), (8, 4),
]


def test_pred_uni(rng):
    for taps in (8, 4):
        for (w0, h0) in MC_PARTITIONS[::3]:
            w, h = w0 * taps // 8, h0 * taps // 8
            win = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
            for (xf, yf) in [(0, 0), (2, 0), (0, 3), (1, 2)]:
                want = cref.pred_uni(win, w, h, xf, yf, taps)
                got = ops.pred_uni(jnp.asarray(win), xf, yf, taps)
                np.testing.assert_array_equal(
                    np.asarray(got), want, err_msg=f"{taps}tap {w}x{h} ({xf},{yf})"
                )


def test_pred_bi(rng):
    for taps in (8, 4):
        w = h = 32 * taps // 8
        win0 = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
        win1 = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
        for fr in [(0, 0, 0, 0), (1, 2, 3, 1), (0, 2, 2, 0)]:
            want = cref.pred_bi(win0, win1, w, h, *fr, taps)
            got = ops.pred_bi(jnp.asarray(win0), jnp.asarray(win1), *fr, taps)
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"{taps}tap {fr}")


def test_pred_intra_dc(rng):
    # Mode 1 is the only mode the reference wires up (pred_intra.c:218-226).
    for n in (4, 8, 16, 32):
        left = rng.integers(0, 256, (2 * n,), dtype=np.uint8)
        above = rng.integers(0, 256, (2 * n,), dtype=np.uint8)
        for edge in (False, True):
            if edge and n == 32:
                continue  # edge filter only for log2 < 5 (pred_intra.h:61)
            want = cref.pred_intra_dc(left, above, n, edge)
            got = ops.pred_intra_dc(jnp.asarray(left), jnp.asarray(above), n, edge)
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"dc {n} edge={edge}")
