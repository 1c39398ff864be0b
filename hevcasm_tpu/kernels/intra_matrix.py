"""All 35 intra modes as ONE constant int8 matmul (n = 32).

At nTbS = 32 HEVC applies no DC/H/V edge filtering (8.4.4.2.6 applies it
only for nTbS < 32), so EVERY mode's prediction is an exact affine map of
the reference-sample vector followed by one arithmetic shift:

    pred_m = (A_m @ refs + b_m) >> s_m

with A_m integer, entries in [0, 63], per-row weight sums <= 2n, and the
accumulator < 2^15 — so the whole 35-mode sweep rides a single s8 x s8 ->
s32 matmul over the centered references (the 128-centering folds into
the bias because every row's weight sum is known).  The per-mode weight
matrices are EXTRACTED NUMERICALLY from a vectorized mirror of
ops/pred_intra's formulas (each reference sample carried as a basis
vector, so gathers/swaps/outer-products stay exact); bit-equality with
ops.pred_intra.pred_intra is asserted per mode in
tests/test_pred_intra.py.

This replaces the 35-iteration gather-heavy mode loop (the angular modes'
jnp.take reference gathers, per WPP wave) with one (258, 35n^2) int8
constant matmul.

Reference analogue: pred_intra.c wires only DC (pred_intra.c:66-103); the
f265 asm it vendors ships per-mode specialised kernels (intra.asm:135-
1326).  Here specialisation is by CONSTANT MATRIX.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.pred_intra import ANGLES, INV_ANGLES, filter_flag

__all__ = ["pred_intra_all_modes_mm", "mode_matrices"]


def _basis(n):
    """Reference samples as basis vectors: component layout
    [left(2n), above(2n), corner, bias] (R = 4n + 2)."""
    r = 4 * n + 2
    eye = np.eye(r, dtype=np.int64)
    left = eye[: 2 * n]
    above = eye[2 * n : 4 * n]
    corner = eye[4 * n]
    bias = eye[4 * n + 1]
    return left, above, corner, bias


def _planar_matrix(n):
    left, above, corner, bias = _basis(n)
    r = left.shape[-1]
    w = np.zeros((n, n, r), np.int64)
    for y in range(n):
        for x in range(n):
            w[y, x] += (n - 1 - x) * left[y] + (x + 1) * above[n]
            w[y, x] += (n - 1 - y) * above[x] + (y + 1) * left[n]
            w[y, x] += n * bias
    return w, n.bit_length()  # shift = log2(n) + 1


def _dc_matrix(n):
    left, above, corner, bias = _basis(n)
    r = left.shape[-1]
    acc = n * bias + above[:n].sum(0) + left[:n].sum(0)
    w = np.broadcast_to(acc, (n, n, r)).copy()
    return w, n.bit_length()  # shift = log2(n) + 1


def _angular_matrix(n, mode):
    """Vectorized mirror of ops.pred_intra.pred_intra_angular (no edge
    filtering: n == 32)."""
    left, above, corner, bias = _basis(n)
    r = left.shape[-1]
    angle = ANGLES[mode]
    vertical = mode >= 18
    if not vertical:
        left, above = above, left
    # ref[0..2n] = [corner, above...]; negative part by inverse projection
    pos = np.concatenate([corner[None], above], axis=0)
    if angle >= 0:
        ref = pos
        off = 0
    else:
        inv = INV_ANGLES[angle]
        neg_len = -((n * angle) >> 5)
        neg = []
        for x in range(-1, -neg_len - 1, -1):
            y0 = -1 + ((x * inv + 128) >> 8)
            neg.append(corner if y0 < 0 else left[y0])
        ref = np.concatenate([np.stack(neg[::-1]), pos], axis=0)
        off = neg_len
    w = np.zeros((n, n, r), np.int64)
    for y in range(n):
        idx = ((y + 1) * angle) >> 5
        fact = ((y + 1) * angle) & 31
        for x in range(n):
            g = off + x + idx + 1
            # jnp.take clamps out-of-range indices; the clamped r1 sample
            # only ever occurs with fact == 0 (weight 0), so it is inert.
            g1 = min(g + 1, len(ref) - 1)
            w[y, x] = (32 - fact) * ref[g] + fact * ref[g1] + 16 * bias
    if not vertical:
        w = np.swapaxes(w, 0, 1)
    return w, 5


@functools.lru_cache
def mode_matrices(n: int):
    """(w8 (258, 35*n*n) int8, bias (35*n*n,) int32, shifts (35*n*n,) int32).

    Column m*n*n + y*n + x maps the CENTERED reference vector
    [plain(129) - 128 || filtered(129) - 128] (layout per _basis, bias
    component dropped) to mode m's pre-shift accumulator at (y, x): the
    128-centering compensation (128 * weight-sum) and the rounding bias
    are folded into `bias`.  Each mode's weights sit in the plain or the
    filtered half per filter_flag(mode, n)."""
    assert n == 32, "the matrix formulation covers n == 32 (no edge filter)"
    r1 = 4 * n + 1  # refs per set (no bias component)
    cols = []
    biases = []
    shifts = []
    for mode in range(35):
        if mode == 0:
            w, s = _planar_matrix(n)
        elif mode == 1:
            w, s = _dc_matrix(n)
        else:
            w, s = _angular_matrix(n, mode)
        w = w.reshape(n * n, r1 + 1)
        weights, b = w[:, :r1], w[:, r1]
        assert weights.min() >= 0 and weights.max() < 128
        b = b + 128 * weights.sum(-1)  # centering compensation
        full = np.zeros((n * n, 2 * r1), np.int64)
        half = r1 if filter_flag(mode, n) else 0
        full[:, half : half + r1] = weights
        cols.append(full)
        biases.append(b)
        shifts.append(np.full(n * n, s, np.int64))
    w8 = np.concatenate(cols, axis=0).T.astype(np.int8)       # (258, 35n^2)
    bias = np.concatenate(biases).astype(np.int32)
    shift = np.concatenate(shifts).astype(np.int32)
    return w8, bias, shift


def _mode_affine(mode, n):
    """(w (n, n, 4n+2) int64 incl. bias component, shift) for one mode."""
    if mode == 0:
        return _planar_matrix(n)
    if mode == 1:
        return _dc_matrix(n)
    return _angular_matrix(n, mode)


@functools.lru_cache
def mode_matrices_t(n: int):
    """Hadamard-domain mode matrices for the raw-accumulator mode decision.

    The classic intra mode cost is SATD of the SHIFTED prediction, which
    forces materializing all 35 candidate planes and re-tiling them into
    8x8 blocks (the transposes dominated the wavefront at ~0.5 ms/wave).
    SATD's transform is linear, so it FOLDS INTO the constant matrix:
    with T(X)[tile] = H8 @ X[tile] @ H8, the transformed candidate is

        T(A_m @ refs + b_m)  =  W_T_m @ refs + b_T_m

    and the mode score is evaluated directly in the transformed domain
    against the block's own T(src):

        score_m = sum_t ( |accT_m[t] - (srcT[t] << s_m)|  >>  (s_m + 2) )

    — the raw-accumulator analogue of sum-of-8x8-SATDs (>> 2 mirrors the
    butterfly's /4 normalization; s_m rescales each mode's accumulator;
    an exact integer-pel match scores ~0).  This is a FINER metric than
    SATD-of-shifted-pixels (12 extra fractional bits) and near-ties may
    resolve differently; the winning mode's spatial prediction is then
    recovered EXACTLY by the inverse transform (H(HXH)H == 64X), so the
    prediction for a given chosen mode is bit-identical to
    ops.pred_intra.pred_intra.

    Returns (wt8 (258, 35*n*n) int8, bias_t (35*n*n,) int32 — centering
    folded, shift_lane (35*n*n,) int32 per-lane total score shifts,
    src_scale_lane (35*n*n,) int32 = 1 << s_m, shifts (35,) ndarray).
    Column order per mode: (tile_y, tile_x, u, v)."""
    assert n == 32
    from ..ops.satd import hadamard_matrix

    h8 = hadamard_matrix(8).astype(np.int64)
    r1 = 4 * n + 1
    cols, biases, shifts = [], [], []
    for mode in range(35):
        w, s = _mode_affine(mode, n)
        # (y, x, R) -> (ty, u, tx, v, R) -> T over (u, v)
        w4 = w.reshape(4, 8, 4, 8, w.shape[-1])
        t = np.einsum("au,cv,TuXvr->TXacr", h8, h8, w4)
        t = t.reshape(n * n, w.shape[-1])
        weights, b = t[:, :r1], t[:, r1]
        full = np.zeros((n * n, 2 * r1), np.int64)
        half = r1 if filter_flag(mode, n) else 0
        full[:, half : half + r1] = weights
        cols.append(full)
        biases.append(b + 128 * weights.sum(-1))
        shifts.append(s)
    wt = np.concatenate(cols, axis=0)                     # (35n^2, 258)
    # Hadamard-combined weights reach ~2^11: signed hi/lo byte split, two
    # exact s8 matmuls (wt == hi * 256 + lo).
    lo = ((wt + 128) & 255) - 128
    hi = (wt - lo) >> 8
    assert np.abs(hi).max() < 128 and (hi * 256 + lo == wt).all()
    bias_t = np.concatenate(biases).astype(np.int32)
    shifts = np.asarray(shifts, np.int64)
    shift_lane = np.repeat(shifts + 2, n * n).astype(np.int32)
    src_scale_lane = np.repeat(1 << shifts, n * n).astype(np.int32)
    return (hi.T.astype(np.int8), lo.T.astype(np.int8), bias_t, shift_lane,
            src_scale_lane, shifts)


@functools.partial(jax.jit, static_argnames=("n",))
def intra_mode_decision_t(blocks, left, above, corner, left_f, above_f,
                          corner_f, n: int = 32):
    """Mode decision + winning prediction via the Hadamard-domain matmul.

    blocks (m, n, n) uint8 source; reference sets as
    pred_intra_all_modes_mm.  Returns (pred (m, n, n) uint8 — bit-exact
    pred_intra output for the chosen mode, best (m,) int32, score (m, 35)
    int32).  No candidate plane is ever materialized."""
    from ..ops.satd import hadamard_matrix

    wt_hi, wt_lo, bias_t, shift_lane, src_scale, shifts = mode_matrices_t(n)
    m = blocks.shape[0]
    refs = jnp.concatenate(
        [left.astype(jnp.int32), above.astype(jnp.int32),
         corner.astype(jnp.int32)[..., None],
         left_f.astype(jnp.int32), above_f.astype(jnp.int32),
         corner_f.astype(jnp.int32)[..., None]],
        axis=-1,
    )
    refs8 = (refs - 128).astype(jnp.int8)
    dn = (((1,), (0,)), ((), ()))
    a_hi = jax.lax.dot_general(refs8, jnp.asarray(wt_hi), dn,
                               preferred_element_type=jnp.int32)
    a_lo = jax.lax.dot_general(refs8, jnp.asarray(wt_lo), dn,
                               preferred_element_type=jnp.int32)
    acc_t = (a_hi << 8) + a_lo + jnp.asarray(bias_t)      # (m, 35n^2)

    # T(src) in the same (ty, tx, u, v) order — an int32 einsum, exact on
    # every backend (the 16K-MAC-per-block contraction is small).
    h32 = jnp.asarray(hadamard_matrix(8))
    s4 = blocks.astype(jnp.int32).reshape(m, 4, 8, 4, 8)
    src_t = jnp.einsum("au,cv,mTuXv->mTXac", h32, h32, s4)
    src_t = src_t.reshape(m, n * n)

    diff = jnp.abs(acc_t - jnp.tile(src_t, (1, 35)) * jnp.asarray(src_scale))
    score = (diff >> jnp.asarray(shift_lane)).reshape(m, 35, n * n).sum(-1)
    best = jnp.argmin(score, axis=-1).astype(jnp.int32)

    # Winner: inverse-transform the chosen mode's T-domain accumulator.
    # Selected by a one-hot weighted reduction instead of a (m, 35840)
    # gather: the masked sum is a fused elementwise pass.
    onehot = (jnp.arange(35, dtype=jnp.int32)[None] == best[:, None])
    t_win = jnp.sum(jnp.where(onehot[:, :, None],
                              acc_t.reshape(m, 35, n * n), 0), axis=1)
    t4 = t_win.reshape(m, 4, 4, 8, 8)                     # (ty, tx, u, v)
    hi = jnp.asarray(hadamard_matrix(8))
    inv = jnp.einsum("ua,vc,mTXac->mTuXv", hi, hi, t4) >> 6
    acc_win = inv.reshape(m, n, n)                        # == A@refs + b
    s_win = jnp.take(jnp.asarray(shifts.astype(np.int32)), best)
    pred = acc_win >> s_win[:, None, None]
    return jnp.clip(pred, 0, 255).astype(jnp.uint8), best, score


@functools.partial(jax.jit, static_argnames=("n",))
def pred_intra_all_modes_mm(left, above, corner, left_f, above_f, corner_f,
                            n: int = 32):
    """All 35 modes for a batch of blocks via the constant matmul.

    left/above (m, 2n) uint8, corner (m,) — the substituted PLAIN
    reference set; *_f the FILTERED set (ops.pred_intra.filter_references).
    Returns (m, 35, n, n) uint8, bit-exact with per-mode
    ops.pred_intra.pred_intra with filter_edge=False."""
    w8, bias, shift = mode_matrices(n)
    refs = jnp.concatenate(
        [left.astype(jnp.int32), above.astype(jnp.int32),
         corner.astype(jnp.int32)[..., None],
         left_f.astype(jnp.int32), above_f.astype(jnp.int32),
         corner_f.astype(jnp.int32)[..., None]],
        axis=-1,
    )                                                   # (m, 258)
    refs8 = (refs - 128).astype(jnp.int8)
    acc = jax.lax.dot_general(
        refs8, jnp.asarray(w8), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )                                                   # (m, 35n^2)
    pred = (acc + jnp.asarray(bias)) >> jnp.asarray(shift)
    return pred.reshape(pred.shape[0], 35, n, n).astype(jnp.uint8)
