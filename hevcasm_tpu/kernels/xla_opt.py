"""Optimized XLA formulations (Tier.JIT, the C_OPT analogue): the same
bit-exact integer semantics as the REF tier, re-expressed so the heavy
arithmetic runs as bf16 matmuls with f32 accumulation (tensor-core work on
the GPU).

Exactness arguments (why bf16/f32 matmuls give bit-exact integer results):

* transforms — an N-point butterfly pass is y = T @ x with |T| <= 90 (7 bits)
  and x int16.  Split x = hi*256 + lo (lo unsigned 8-bit, hi signed 8-bit):
  every bf16 input is an exactly-representable integer (<= 8 significant
  bits), every product <= 90*255 < 2^15, and every K<=32 accumulation
  <= 32*90*255 < 2^20 < 2^24, so the f32 accumulator is exact.  Recombine
  y = 256*(T@hi) + (T@lo) in int32.

* SATD — H has entries +-1 and the diff is 9-bit, so stage-1 sums are <= 2^11
  and stage-2 sums <= 2^15: both far inside f32's exact-integer range; f32
  matmuls are exact here on any backend.

* ssd_grid — the full-search scoring grid.  SSD(dy,dx) = sum(src^2)
  + slide(win^2) - 2*corr; corr is computed per x-offset (dx) as a batched
  (h+num_dy-1, w) @ (w, h) bf16 matmul G = win_dx @ src^T whose K=w<=128
  accumulations of 16-bit products stay < 2^24 (exact), followed by an exact
  int32 diagonal reduction corr[dy] = sum_y G[dy+y, y] done with the
  pad-and-reshape diagonal-extraction trick (pure data movement).  The
  sliding window-energy term uses an int32 integral image.  The result is
  bit-exact integer SSD, produced by matrix products instead of |a-b|
  reductions — the matrix-unit answer to the reference's psadbw-based
  search (sad_a.asm:56-194): on x86 SAD is the cheap metric, with matrix
  units the matmul-friendly SSD is.

Every bf16 matmul here keeps its exactness argument on any backend: the
operands are integers of at most 8 significant bits and every partial sum
stays below 2^24, so the f32 accumulation is exact in whatever order the
backend sums.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import registry
from ..config import Tier
from ..ops import transform as tr
from ..ops.satd import hadamard_matrix

__all__ = ["forward_transform", "inverse_transform", "inverse_transform_add", "satd", "ssd_grid"]


def _split16(x):
    """int -> (hi, lo) with x == hi*256 + lo, hi signed, lo in [0, 256)."""
    x = x.astype(jnp.int32)
    lo = jnp.bitwise_and(x, 255)
    hi = x >> 8  # arithmetic shift: hi*256 + lo == x for negatives too
    return hi, lo


def _mm_exact(t_bf16, x, contract):
    """Exact integer y = contract(T, x) via hi/lo split bf16 matmuls.

    contract(a, b) must be a bilinear einsum-like callable operating on
    bf16 arrays and returning f32.
    """
    hi, lo = _split16(x)
    yh = contract(t_bf16, hi.astype(jnp.bfloat16))
    yl = contract(t_bf16, lo.astype(jnp.bfloat16))
    return 256 * yh.astype(jnp.int32) + yl.astype(jnp.int32)


def _fwd_stage(x, t_bf16, shift):
    add = 1 << (shift - 1)
    y = _mm_exact(
        t_bf16,
        x,
        lambda t, v: jnp.einsum("kj,...ij->...ki", t, v, preferred_element_type=jnp.float32),
    )
    return ((y + add) >> shift).astype(jnp.int16).astype(jnp.int32)


def _inv_stage(x, t_bf16, shift):
    add = 1 << (shift - 1)
    y = _mm_exact(
        t_bf16,
        x,
        lambda t, v: jnp.einsum("jk,...ji->...ik", t, v, preferred_element_type=jnp.float32),
    )
    return jnp.clip((y + add) >> shift, -32768, 32767)


@functools.partial(jax.jit, static_argnames=("tr_type",))
def forward_transform(res, tr_type: int = 0):
    """Matmul forward transform; bit-exact with ops.transform.forward_transform."""
    n = res.shape[-1]
    t = jnp.asarray(tr.DST4 if tr_type else tr.dct_matrix(n)).astype(jnp.bfloat16)
    s1, s2 = tr.forward_shifts(n.bit_length() - 1)
    return _fwd_stage(_fwd_stage(res, t, s1), t, s2).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("tr_type",))
def inverse_transform(coeffs, tr_type: int = 0):
    n = coeffs.shape[-1]
    t = jnp.asarray(tr.DST4 if tr_type else tr.dct_matrix(n)).astype(jnp.bfloat16)
    s1, s2 = tr.INVERSE_SHIFTS
    return _inv_stage(_inv_stage(coeffs, t, s1), t, s2).astype(jnp.int16)


@functools.partial(jax.jit, static_argnames=("tr_type", "bit_depth"))
def inverse_transform_add(coeffs, pred, tr_type: int = 0, bit_depth: int = 8):
    res = inverse_transform(coeffs, tr_type)
    rec = pred.astype(jnp.int32) + res.astype(jnp.int32)
    return jnp.clip(rec, 0, (1 << bit_depth) - 1).astype(jnp.uint8)


@jax.jit
def satd(a, b):
    """SATD via two f32 matmuls; bit-exact with ops.satd.satd."""
    n = a.shape[-1]
    h = jnp.asarray(hadamard_matrix(n)).astype(jnp.float32)
    d = (a.astype(jnp.int32) - b.astype(jnp.int32)).astype(jnp.float32)
    # HIGHEST precision keeps the f32 passes exact for these integer
    # magnitudes; the default precision may round matmul inputs (TF32 on
    # the GPU keeps 11 significant bits), which breaks bit-exactness.
    m = jnp.einsum("ky,...yx->...kx", h, d, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    t = jnp.einsum("...kx,xj->...kj", m, h, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    s = jnp.sum(jnp.abs(t).astype(jnp.int32), axis=(-2, -1)) + n // 4
    return s // (n // 2)


def _sliding_sum(sq: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    """Integral-image sliding (h, w) window sums over the trailing two axes.

    sq: (..., H, W) int32.  Returns (..., H-h+1, W-w+1).  Exact while the
    total plane sum stays inside int32 (window planes here are <= 2^31/255^2).
    """
    ii = jnp.cumsum(jnp.cumsum(sq, axis=-2), axis=-1)
    ii = jnp.pad(ii, [(0, 0)] * (sq.ndim - 2) + [(1, 0), (1, 0)])
    a = ii[..., h:, w:]
    b = ii[..., :-h, w:]
    c = ii[..., h:, :-w]
    d = ii[..., :-h, :-w]
    return a - b - c + d


def _diag_colsum(g: jnp.ndarray, num_dy: int) -> jnp.ndarray:
    """corr[.., dy] = sum_y g[.., y, dy + y] for dy in [0, num_dy).

    Uses the flatten/pad/reshape diagonal-extraction identity:
    flat[y*(cols+1) + dy] == g[y, y + dy].
    """
    *lead, rows, cols = g.shape
    flat = g.reshape(*lead, rows * cols)
    flat = jnp.pad(flat, [(0, 0)] * len(lead) + [(0, rows)])
    m = flat.reshape(*lead, rows, cols + 1)  # m[.., y, dy] = g[.., y, y+dy]
    return jnp.sum(m[..., :num_dy], axis=-2)


@functools.partial(jax.jit, static_argnames=("num_dy", "num_dx"))
def ssd_grid(src: jnp.ndarray, window: jnp.ndarray, num_dy: int, num_dx: int) -> jnp.ndarray:
    """Exact integer SSD over a full candidate grid, correlation-matmul
    formulation.

    src:    (n, h, w) uint8;  window: (n, >=h+num_dy-1, >=w+num_dx-1) uint8.
    Returns (n, num_dy, num_dx) int32 == ops.ssd.ssd_grid (bit-exact).
    """
    n, h, w = src.shape
    wh, ww = h + num_dy - 1, w + num_dx - 1
    window = window[:, :wh, :ww]
    s32 = src.astype(jnp.int32)
    w32 = window.astype(jnp.int32)

    srcsq = jnp.sum(s32 * s32, axis=(-2, -1))                     # (n,)
    winsq = _sliding_sum(w32 * w32, h, w)                          # (n, dy, dx)

    src_bf = src.astype(jnp.bfloat16)
    win_bf = window.astype(jnp.bfloat16)

    def corr_at_dx(dx):
        # g[i, y, yy] = sum_x src[i, y, x] * win[i, yy, dx+x]: a batched
        # (h, w) @ (w, wh) matmul; K = w <= 128 keeps f32 accumulation exact.
        win_dx = jax.lax.dynamic_slice_in_dim(win_bf, dx, w, axis=-1)
        g = jnp.einsum(
            "nhx,nyx->nhy", src_bf, win_dx, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
        # corr[dy] = sum_y g[y, y+dy]; y+dy <= wh-1 so no reshape spill.
        return _diag_colsum(g, num_dy)                             # (n, dy)

    _, corr = jax.lax.scan(
        lambda c, dx: (c, corr_at_dx(dx)), None, jnp.arange(num_dx)
    )  # (dx, n, dy)
    corr = jnp.moveaxis(corr, 0, -1)                               # (n, dy, dx)
    return srcsq[:, None, None] + winsq - 2 * corr


def _mm_right_exact(x, m_bf):
    """Exact integer x @ m for 16-bit x via the hi/lo split (einsum form)."""
    hi, lo = _split16(x)
    yh = jnp.einsum("...ij,jk->...ik", hi.astype(jnp.bfloat16), m_bf,
                    preferred_element_type=jnp.float32)
    yl = jnp.einsum("...ij,jk->...ik", lo.astype(jnp.bfloat16), m_bf,
                    preferred_element_type=jnp.float32)
    return 256 * yh.astype(jnp.int32) + yl.astype(jnp.int32)


def _mm_left_exact(m_bf, x):
    """Exact integer m @ x for 16-bit x via the hi/lo split (einsum form)."""
    hi, lo = _split16(x)
    yh = jnp.einsum("ij,...jk->...ik", m_bf, hi.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    yl = jnp.einsum("ij,...jk->...ik", m_bf, lo.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32)
    return 256 * yh.astype(jnp.int32) + yl.astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("qscale", "qshift", "qoffset", "dscale", "dshift", "tu", "tr_type"),
)
def residual_pipeline_frame(
    src_blocks: jnp.ndarray,
    pred_blocks: jnp.ndarray,
    qscale: int,
    qshift: int,
    qoffset: int,
    dscale: int,
    dshift: int,
    tu: int = 8,
    tr_type: int = 0,
):
    """Whole-frame fused residual pipeline as frame-batched matmuls.

    src/pred: (n, B, B) uint8 CTU stacks.  Applies per-TU transform -> quant
    -> dequant -> inverse transform -> add -> clip with the block-diagonal
    identity kron(I_{B/tu}, T_tu): every pass over all n CTUs is ONE
    (n*B, B) @ (B, B) matmul instead of n*(B/tu)^2 tiny tu x tu products
    (the per-TU einsum is latency-bound at production frame sizes).

    Bit-exact with ops.transform/ops.quantize composed per TU
    (residual_decode.c:592-852 forward, :69-368 inverse+add,
    quantize.c:53-186); exactness of the bf16/f32 path per the module
    docstring (pass-1 inputs are 9-bit residuals, all later passes use the
    hi/lo split; every accumulation stays below 2^24).

    Returns (recon (n, B, B) uint8, nnz () int32, cbf (n, B/tu, B/tu)
    bool, bits (n,) int32 per-CTU Exp-Golomb bit-cost sums of the
    quantized levels — the rate model of encode/rate.bits_estimate, so RD
    decisions (TU selection) can price real bits instead of proxies).
    """
    import numpy as np

    b = src_blocks.shape[-1]
    k = b // tu
    assert k * tu == b
    t = np.asarray(tr.DST4 if tr_type else tr.dct_matrix(tu))
    bd = jnp.asarray(np.kron(np.eye(k, dtype=np.int64), t)).astype(jnp.bfloat16)
    s1, s2 = tr.forward_shifts(tu.bit_length() - 1)
    i1, i2 = tr.INVERSE_SHIFTS

    def wrap16(x):
        return x.astype(jnp.int16).astype(jnp.int32)

    res = src_blocks.astype(jnp.int32) - pred_blocks.astype(jnp.int32)
    # Forward pass 1 (row transform, contracts each TU's column index):
    # |res| <= 255 is exactly representable in bf16, no split needed.
    a1 = jnp.einsum("nij,kj->nik", res.astype(jnp.bfloat16), bd,
                    preferred_element_type=jnp.float32).astype(jnp.int32)
    st1 = wrap16((a1 + (1 << (s1 - 1))) >> s1)
    coeffs = wrap16((_mm_left_exact(bd, st1) + (1 << (s2 - 1))) >> s2)

    # Quantize (quantize.c:160-186) + per-TU coded-block flags.
    sign = jnp.where(coeffs < 0, -1, 1)
    q = ((jnp.abs(coeffs) * qscale + (qoffset << (qshift - 16))) >> qshift) * sign
    q = jnp.clip(q, -32768, 32767)
    nnz = jnp.sum((q != 0).astype(jnp.int32))
    cbf = jnp.any(
        (q != 0).reshape(q.shape[0], k, tu, k, tu), axis=(-3, -1)
    )
    aq = jnp.abs(q)
    fl = (jax.lax.bitcast_convert_type(
        jnp.maximum(aq, 1).astype(jnp.float32), jnp.int32) >> 23) - 127
    bits = jnp.sum(jnp.where(aq > 0, 2 * fl + 3, 0), axis=(-2, -1))

    # Dequantize (quantize.c:53-62).
    dq = jnp.clip((q * dscale + (1 << (dshift - 1))) >> dshift, -32768, 32767)

    # Inverse transform with clipped passes (residual_decode.c:69-347).
    r1 = jnp.clip((_mm_left_exact(bd.T, dq) + (1 << (i1 - 1))) >> i1, -32768, 32767)
    r2 = jnp.clip((_mm_right_exact(r1, bd) + (1 << (i2 - 1))) >> i2, -32768, 32767)

    rec = jnp.clip(pred_blocks.astype(jnp.int32) + r2, 0, 255).astype(jnp.uint8)
    return rec, nnz, cbf, bits


# REF-tier exact-SSD grid for the same op family (scan formulation mirroring
# ops.sad.sad_grid), so the harness has a golden to compare against.
def ssd_grid_ref(src, window, num_dy, num_dx):
    h, w = src.shape[-2], src.shape[-1]
    src32 = src.astype(jnp.int32)[..., :, None, :]
    idx = jnp.arange(num_dx)[:, None] + jnp.arange(w)[None, :]

    def step(_, dy):
        rows = jax.lax.dynamic_slice_in_dim(window, dy, h, axis=-2)
        cand = jnp.take(rows, idx, axis=-1)
        d = cand.astype(jnp.int32) - src32
        return None, jnp.sum(d * d, axis=(-3, -1))

    _, out = jax.lax.scan(step, None, jnp.arange(num_dy))
    return jnp.moveaxis(out, 0, -2)


def _diag_colsum_check():  # pragma: no cover - debugging helper
    import numpy as np

    g = np.arange(12).reshape(3, 4)
    want = [sum(g[y, y + dy] for y in range(3) if y + dy < 4) for dy in range(2)]
    got = _diag_colsum(jnp.asarray(g), 2)
    assert np.array_equal(np.asarray(got), want)


def _residual_pipeline_jit(src, pred, qscale, qshift, qoffset, dscale, dshift,
                           tu=8, tr_type=0):
    """JIT tier of ops.residual.residual_pipeline (normalized cbf shape)."""
    rec, nnz, cbf, _ = residual_pipeline_frame(
        src, pred, qscale, qshift, qoffset, dscale, dshift, tu=tu, tr_type=tr_type
    )
    return rec, nnz, cbf.reshape(-1)


registry.register("forward_transform", Tier.JIT, forward_transform)
registry.register("inverse_transform", Tier.JIT, inverse_transform)
registry.register("inverse_transform_add", Tier.JIT, inverse_transform_add)
registry.register("satd", Tier.JIT, satd)
registry.register("ssd_grid", Tier.REF, ssd_grid_ref)
registry.register("ssd_grid", Tier.JIT, ssd_grid)
registry.register("residual_pipeline", Tier.JIT, _residual_pipeline_jit)
