"""Inter prediction: HEVC motion-compensation interpolation.

Reference: /root/reference/src/lib/pred_inter.c.  The reference dispatches
each block to one of four code paths (copy / H / V / HV, pred_inter.c:231-291)
through a table keyed on [taps][w][xFrac!=0][yFrac!=0] (pred_inter.h:58-67),
because x86 SIMD wants width- and case-specialised code.

Batched design: a single, always-separable two-pass path.  When a
fractional offset is zero the corresponding filter row is the unit kernel
(64 at the centre tap, pred_inter.c:57-79), and the arithmetic below then
reduces *bit-exactly* to the reference's copy/H-only/V-only paths:

  pass1 (H, shift 0)  : p  = sum_k cx[k] * ref[y, x+k-pad]         (int16)
  pass2 (V, shift 12) : out= Clip3(0,255, (sum_k cy[k]*p + 2048) >> 12)

  with cy = unit:  (64*p + 2048) >> 12 == (p + 32) >> 6   == H-only path
  with cx = unit:  p = 64*ref;  pass2 == (sum cy*ref + 32) >> 6 == V-only
  with both unit:  out == ref                              == copy

so there is no data-dependent control flow under jit, and fractional motion
vectors can be *traced values* selecting kernel rows via a gather.  Bi-pred
fuses the two vertical passes with the combining mean (r0+r1+64)>>7
(pred_inter.c:490-530), mirroring the reference's fused SSE4 bi pass
(pred_inter_a.asm:447-576).

Window convention: every function takes an extended reference window of shape
(..., h + taps - 1, w + taps - 1) whose integer-pel block origin sits at
offset (pad, pad) with pad = taps//2 - 1, matching the taps' support
x + k - (taps/2 - 1), k in [0, taps) (pred_inter.c:109-117).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "KERNEL8",
    "KERNEL4",
    "pred_uni",
    "pred_uni_16",
    "pred_bi",
    "pad_for",
    "qpel_score",
    "refine_qpel",
]

# Luma 8-tap quarter-pel filters (pred_inter.c:57-63).
KERNEL8 = np.array(
    [
        [0, 0, 0, 64, 0, 0, 0, 0],
        [-1, 4, -10, 58, 17, -5, 1, 0],
        [-1, 4, -11, 40, 40, -11, 4, -1],
        [0, 1, -5, 17, 58, -10, 4, -1],
    ],
    dtype=np.int32,
)

# Chroma 4-tap eighth-pel filters (pred_inter.c:69-79).
KERNEL4 = np.array(
    [
        [0, 64, 0, 0],
        [-2, 58, 10, -2],
        [-4, 54, 16, -2],
        [-6, 46, 28, -4],
        [-4, 36, 36, -4],
        [-4, 28, 46, -6],
        [-2, 16, 54, -4],
        [-2, 10, 58, -2],
    ],
    dtype=np.int32,
)


def pad_for(taps: int) -> int:
    """Left/top padding of the extended window (3 luma, 1 chroma)."""
    return taps // 2 - 1


def _coef(frac, taps: int) -> jnp.ndarray:
    """Kernel row(s) for a (possibly traced, possibly batched) frac."""
    kern = jnp.asarray(KERNEL8 if taps == 8 else KERNEL4)
    return jnp.take(kern, jnp.asarray(frac), axis=0)  # (..., taps)


def _fir(x: jnp.ndarray, coef: jnp.ndarray, axis: int, out_len: int) -> jnp.ndarray:
    """Valid FIR along ``axis`` (which must be -1 or -2): unshifted
    accumulation sum_k coef[..., k] * x[shifted k], int32.

    coef is (taps,) for a shared filter or (..., taps) for per-block filters
    broadcast over the trailing (h, w) axes.
    """
    taps = coef.shape[-1]
    acc = None
    for k in range(taps):
        sl = jax.lax.slice_in_dim(x, k, k + out_len, axis=axis)
        c = coef[..., k]
        if c.ndim:
            c = c[..., None, None]
        term = sl * c
        acc = term if acc is None else acc + term
    return acc


def _wrap16(x: jnp.ndarray) -> jnp.ndarray:
    """Emulate the C int16_t intermediate store (pred_inter.c:124)."""
    return x.astype(jnp.int16).astype(jnp.int32)


def _hv(window: jnp.ndarray, xfrac, yfrac, taps: int) -> jnp.ndarray:
    """Common two-pass core: returns the pre-final vertical accumulation
    (int32, unshifted) of shape (..., h, w)."""
    t = taps
    h = window.shape[-2] - t + 1
    w = window.shape[-1] - t + 1
    cx = _coef(xfrac, t)
    cy = _coef(yfrac, t)
    x = window.astype(jnp.int32)
    inter = _wrap16(_fir(x, cx, axis=-1, out_len=w))  # (..., h+t-1, w)
    return _fir(inter, cy, axis=-2, out_len=h)


def pred_uni(window: jnp.ndarray, xfrac, yfrac, taps: int = 8) -> jnp.ndarray:
    """Uni-prediction 8to8: (..., h+t-1, w+t-1) uint8 -> (..., h, w) uint8.

    Bit-exact with every branch of get_pred_uni_8to8 (pred_inter.c:231-291):
    copy, H (shift 6), V (shift 6) and HV (8to16 H then 16to8 V shift 12).
    xfrac/yfrac may be ints or traced arrays broadcastable over the batch.
    """
    acc = _hv(window, xfrac, yfrac, taps)
    out = (acc + 2048) >> 12
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def pred_uni_16(window: jnp.ndarray, xfrac, yfrac, taps: int = 8) -> jnp.ndarray:
    """Uni-prediction 8to16, the bi-pred intermediate: H shift 0 then V
    shift 6, stored to int16 without clipping (pred_inter.c:514-523)."""
    acc = _hv(window, xfrac, yfrac, taps)
    return (acc >> 6).astype(jnp.int16)


def pred_bi(
    window0: jnp.ndarray,
    window1: jnp.ndarray,
    xfrac0,
    yfrac0,
    xfrac1,
    yfrac1,
    taps: int = 8,
) -> jnp.ndarray:
    """Bi-prediction 8to8 with fused combining mean.

    Bit-exact with hevcasm_pred_bi_8tap_8to8_c_ref / _4tap_
    (pred_inter.c:504-530): two 8to16 uni paths then
    dst = Clip3(0, 255, (r0 + r1 + 64) >> 7).
    """
    r0 = pred_uni_16(window0, xfrac0, yfrac0, taps).astype(jnp.int32)
    r1 = pred_uni_16(window1, xfrac1, yfrac1, taps).astype(jnp.int32)
    v = (r0 + r1 + 64) >> 7
    return jnp.clip(v, 0, 255).astype(jnp.uint8)


def qpel_score(acc: jnp.ndarray, src: jnp.ndarray) -> jnp.ndarray:
    """THE quarter-pel candidate metric, shared by every refinement tier:

        score = sum_px  |acc - (src << 12)|  >>  4

    where ``acc`` is the pre-shift vertical accumulation (the value whose
    ``clip((acc + 2048) >> 12)`` is the HEVC prediction); an exact
    integer-pel match scores 0.  Scoring the raw
    accumulator instead of the clipped pixels keeps 12 fractional bits of
    distortion (a strictly finer measure; near-ties may resolve to a
    different fraction than a post-clip SAD would) and, in the fused
    kernels, removes the add/shift/clip materialization of all 16
    candidate planes — only the winner is ever clipped.  The >> 4
    coarsening bounds the per-CTU sum: |d| < 2^22 for any int16-wrapped
    intermediate, so 4096 px * 2^18 < 2^30 fits int32 for every input.

    acc (..., b, b) int32; src (..., b, b) uint8/int32.  Returns (...,)
    int32.  All tiers implement this formula (tests assert bit-equality).
    """
    d = jnp.abs(acc - (src.astype(jnp.int32) << 12)) >> 4
    return jnp.sum(d, axis=(-2, -1))


def refine_qpel(src_ctus: jnp.ndarray, windows: jnp.ndarray):
    """Quarter-pel candidate sweep: interpolate all 16 (yf, xf) luma
    fractions from the extended windows, score each by qpel_score on the
    raw accumulator, and return the best.

    src_ctus (n, b, b) uint8; windows (n, b+7, b+7) uint8 anchored at the
    integer MV.  Returns (pred (n, b, b) uint8, frac (n,) int32 = yf*4+xf,
    cost (n,) int32).  This is the REF tier of the refinement op family
    (JIT: kernels/interp_xla.py) —
    the encoder-side composition the reference's pred_uni tables exist to
    serve (pred_inter.h:64-67).
    """
    b = src_ctus.shape[-1]
    win32 = windows.astype(jnp.int32)
    # Share the horizontal FIR across the four vertical fractions:
    # 4 H passes + 16 V passes instead of 16 of each.
    h_pass = [
        _wrap16(_fir(win32, jnp.asarray(KERNEL8[xf]), axis=-1, out_len=b))
        for xf in range(4)
    ]  # each (n, b+7, b)
    preds, costs = [], []
    for yf in range(4):
        cy = jnp.asarray(KERNEL8[yf])
        for xf in range(4):
            acc = _fir(h_pass[xf], cy, axis=-2, out_len=b)
            p = jnp.clip((acc + 2048) >> 12, 0, 255).astype(jnp.uint8)
            preds.append(p)
            costs.append(qpel_score(acc, src_ctus))
    preds = jnp.stack(preds, axis=1)  # (n, 16, b, b)
    costs = jnp.stack(costs, axis=1)  # (n, 16)
    frac = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    pred = jnp.take_along_axis(preds, frac[:, None, None, None], axis=1)[:, 0]
    cost = jnp.take_along_axis(costs, frac[:, None], axis=1)[:, 0]
    return pred, frac, cost
