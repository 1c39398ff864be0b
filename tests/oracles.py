"""Scalar numpy oracles transcribing the *semantics* of the reference C
kernels (cited per function), used to check the jnp/XLA tiers bit-exactly.

These are deliberately written as plain loops / direct formulas, structured
differently from the batched matmul formulations in hevcasm_tpu, so that the
two agreeing is meaningful.
"""

from __future__ import annotations

import numpy as np


def clip3(lo, hi, x):
    return np.minimum(np.maximum(x, lo), hi)


# --- sad.c:47-60 / :101-121 --------------------------------------------------

def sad(src, ref):
    s = 0
    h, w = src.shape
    for y in range(h):
        for x in range(w):
            s += abs(int(src[y, x]) - int(ref[y, x]))
    return s


# --- ssd.c:43-55, diff.c:45-54 ----------------------------------------------

def ssd(a, b):
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


# --- hadamard.c:45-111 -------------------------------------------------------

def _hadamard_iteration(m, n, src):
    dst = [0] * m
    for i in range(0, m, 2 * n):
        for j in range(n):
            a, b = src[i + j], src[i + n + j]
            dst[i + j] = a + b
            dst[i + n + j] = a - b
    return dst


def _hadamard_transform(m, n, src):
    out = _hadamard_iteration(m, n, src)
    while n > 1:
        n //= 2
        out = _hadamard_iteration(m, n, out)
    return out


def satd(pa, pb):
    """compute_satd (hadamard.c:75-111), n in {2,4,8}."""
    n = pa.shape[0]
    inter = []
    for y in range(n):
        diff = [int(pa[y, x]) - int(pb[y, x]) for x in range(n)]
        inter.append(_hadamard_transform(n, n // 2, diff))
    s = n // 4
    for x in range(n):
        col = [inter[y][x] for y in range(n)]
        t = _hadamard_transform(n, n // 2, col)
        s += sum(abs(v) for v in t)
    return s // (n // 2)


# --- quantize.c --------------------------------------------------------------

def quantize(src, scale, shift, offset):
    """hevcasm_quantize_c_ref (quantize.c:160-186)."""
    off = offset << (shift - 16)
    out = np.zeros_like(src, dtype=np.int16)
    cbf = 0
    flat_in, flat_out = src.ravel(), out.ravel()
    for i, x in enumerate(flat_in):
        x = int(x)
        sign = -1 if x < 0 else 1
        x = (abs(x) * scale + off) >> shift
        x *= sign
        x = int(clip3(-32768, 32767, x))
        cbf |= x
        flat_out[i] = x
    return out, cbf


def quantize_inverse(src, scale, shift):
    """hevcasm_quantize_inverse_c_ref (quantize.c:53-62)."""
    x = src.astype(np.int64)
    y = (x * scale + (1 << (shift - 1))) >> shift
    return clip3(-32768, 32767, y).astype(np.int16)


def reconstruct(pred, res):
    """hevcasm_quantize_reconstruct_c_ref (quantize.c:292-302)."""
    return clip3(0, 255, pred.astype(np.int64) + res.astype(np.int64)).astype(np.uint8)


# --- residual_decode.c transforms -------------------------------------------
# Literal tables for 4/8/16 typed from the normative H.265 matrices (identical
# values appear at residual_decode.c:99-105, :132-142, :182-200); DST4 at
# :592-610.  These literals independently check the DCT32-derived matrices in
# hevcasm_tpu.ops.transform.

T4 = np.array(
    [[64, 64, 64, 64],
     [83, 36, -36, -83],
     [64, -64, -64, 64],
     [36, -83, 83, -36]], dtype=np.int64)

T8 = np.array(
    [[64, 64, 64, 64, 64, 64, 64, 64],
     [89, 75, 50, 18, -18, -50, -75, -89],
     [83, 36, -36, -83, -83, -36, 36, 83],
     [75, -18, -89, -50, 50, 89, 18, -75],
     [64, -64, -64, 64, 64, -64, -64, 64],
     [50, -89, 18, 75, -75, -18, 89, -50],
     [36, -83, 83, -36, -36, 83, -83, 36],
     [18, -50, 75, -89, 89, -75, 50, -18]], dtype=np.int64)

T16 = np.array(
    [[64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64],
     [90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90],
     [89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89],
     [87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87],
     [83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83],
     [80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80],
     [75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75],
     [70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70],
     [64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64],
     [57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57],
     [50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50],
     [43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43],
     [36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36],
     [25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25],
     [18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18],
     [9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9]],
    dtype=np.int64)

# Row 1 of the 32-point matrix (residual_decode.c:257), a literal spot-check
# of the odd rows that the T16 subset consistency cannot reach.
T32_ROW1 = np.array(
    [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
     -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90],
    dtype=np.int64)

DST4 = np.array(
    [[29, 55, 74, 84],
     [74, 74, 0, -74],
     [84, -29, -74, 55],
     [55, -84, 74, -29]], dtype=np.int64)


def _wrap16(x):
    return ((x.astype(np.int64) + 0x8000) % 0x10000 - 0x8000).astype(np.int64)


def forward_transform(res, t, shift1, shift2):
    """Two forward passes, dst = (T @ src^T + add) >> shift stored to int16
    (residual_decode.c:592-892): pass output index [k][i] = row k of T dotted
    with input row i."""
    def stage(x, shift):
        add = 1 << (shift - 1)
        y = (t @ x.T.astype(np.int64) + add) >> shift
        return _wrap16(y)

    return stage(stage(res.astype(np.int64), shift1), shift2).astype(np.int16)


def inverse_transform(coeffs, t, shift1=7, shift2=12):
    """Two inverse passes dst[i][k] = clip3((sum_j T[j][k] src[j][i]) >> s)
    (residual_decode.c:69-347)."""
    def stage(x, shift):
        add = 1 << (shift - 1)
        y = (x.T.astype(np.int64) @ t + add) >> shift
        return clip3(-32768, 32767, y)

    return stage(stage(coeffs.astype(np.int64), shift1), shift2).astype(np.int16)


def inverse_transform_add(coeffs, pred, t):
    res = inverse_transform(coeffs, t)
    return clip3(0, 255, pred.astype(np.int64) + res).astype(np.uint8)


# Butterfly transcriptions (structurally faithful to the C) for 4x4, to pin
# down the matmul-form <-> butterfly-form equivalence independently.

def fwd_butterfly_4x4(src, shift):
    """hevcasm_partial_butterfly_4x4_c_opt (residual_decode.c:613-639)."""
    add = 1 << (shift - 1)
    dst = np.zeros((4, 4), dtype=np.int64)
    for j in range(4):
        row = src[j].astype(np.int64)
        e = [row[0] + row[3], row[1] + row[2]]
        o = [row[0] - row[3], row[1] - row[2]]
        dst[0, j] = (64 * e[0] + 64 * e[1] + add) >> shift
        dst[2, j] = (64 * e[0] - 64 * e[1] + add) >> shift
        dst[1, j] = (83 * o[0] + 36 * o[1] + add) >> shift
        dst[3, j] = (36 * o[0] - 83 * o[1] + add) >> shift
    return _wrap16(dst)


def inv_butterfly_4x4(src, shift):
    """hevcasm_inverse_partial_butterfly_4x4_c_opt (residual_decode.c:91-121)."""
    add = 1 << (shift - 1)
    dst = np.zeros((4, 4), dtype=np.int64)
    for j in range(4):
        col = src[:, j].astype(np.int64)
        o0 = 83 * col[1] + 36 * col[3]
        o1 = 36 * col[1] - 83 * col[3]
        e0 = 64 * col[0] + 64 * col[2]
        e1 = 64 * col[0] - 64 * col[2]
        dst[j, 0] = clip3(-32768, 32767, (e0 + o0 + add) >> shift)
        dst[j, 1] = clip3(-32768, 32767, (e1 + o1 + add) >> shift)
        dst[j, 2] = clip3(-32768, 32767, (e1 - o1 + add) >> shift)
        dst[j, 3] = clip3(-32768, 32767, (e0 - o0 + add) >> shift)
    return dst


# --- pred_inter.c ------------------------------------------------------------

LUMA_KERNEL = [
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
]
CHROMA_KERNEL = [
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
]


def pred_uni_generic(src, oy, ox, w, h, vertical, taps, frac, shift, add, dst_is_16):
    """Transcription of hevcasm_pred_uni_generic (pred_inter.c:90-138).

    Output sample (y, x) reads src[oy + y + d, ox + x] (vertical taps) or
    src[oy + y, ox + x + d] (horizontal), d = k - taps/2 + 1 in
    [-(taps/2-1), taps/2]; (oy, ox) is the origin offset into the padded
    plane, kept explicit so no index ever goes negative (numpy would wrap).
    """
    kern = LUMA_KERNEL if taps == 8 else CHROMA_KERNEL
    out = np.zeros((h, w), dtype=np.int64)
    for y in range(h):
        for x in range(w):
            a = (add << shift) >> 1
            for k in range(taps):
                d = k - taps // 2 + 1
                if vertical:
                    s = int(src[oy + y + d, ox + x])
                else:
                    s = int(src[oy + y, ox + x + d])
                a += kern[frac][k] * s
            a >>= shift
            out[y, x] = a
    if dst_is_16:
        return _wrap16(out).astype(np.int16)
    return clip3(0, 255, out).astype(np.uint8)


def pred_uni(window, w, h, xfrac, yfrac, taps):
    """All four cases of get_pred_uni_8to8 (pred_inter.c:231-291) on an
    extended window whose integer-pel origin is at (pad, pad)."""
    pad = taps // 2 - 1
    if not xfrac and not yfrac:
        return window[pad : pad + h, pad : pad + w].astype(np.uint8)
    if xfrac and not yfrac:
        return pred_uni_generic(window, pad, pad, w, h, False, taps, xfrac, 6, 1, False)
    if not xfrac and yfrac:
        return pred_uni_generic(window, pad, pad, w, h, True, taps, yfrac, 6, 1, False)
    # HV (pred_inter.c:170-179): H 8->16 shift 0 over h+taps-1 rows, then
    # V 16->8 shift 12 on the int16 intermediate.
    inter = pred_uni_generic(window, 0, pad, w, h + taps - 1, False, taps, xfrac, 0, 0, True)
    return pred_uni_generic(inter.astype(np.int64), pad, 0, w, h, True, taps, yfrac, 12, 1, False)


def pred_bi(window0, window1, w, h, fx0, fy0, fx1, fy1, taps):
    """hevcasm_pred_bi_Xtap_8to8_c_ref (pred_inter.c:504-530)."""
    pad = taps // 2 - 1

    def uni16(win, fx, fy):
        inter = pred_uni_generic(win, 0, pad, w, h + taps - 1, False, taps, fx, 0, 0, True)
        return pred_uni_generic(inter.astype(np.int64), pad, 0, w, h, True, taps, fy, 6, 0, True)

    r0 = uni16(window0, fx0, fy0).astype(np.int64)
    r1 = uni16(window1, fx1, fy1).astype(np.int64)
    return clip3(0, 255, (r0 + r1 + 64) >> 7).astype(np.uint8)


# --- pred_intra.c:66-103 -----------------------------------------------------

def pred_intra_dc(left, above, n, filter_edge):
    """hevcasm_pred_intra_dc_ref with the neighbour pointer layout decoded:
    p(dx,-1) = above[dx], p(-1,dy) = left[dy] (pred_intra.c:57-63)."""
    k = n.bit_length() - 1
    dc = n + sum(int(above[x]) for x in range(n)) + sum(int(left[y]) for y in range(n))
    dc >>= k + 1
    dst = np.full((n, n), dc, dtype=np.uint8)
    if filter_edge:
        dst[0, 0] = (int(left[0]) + 2 * dc + int(above[0]) + 2) >> 2
        for x in range(1, n):
            dst[0, x] = (int(above[x]) + 3 * dc + 2) >> 2
        for y in range(1, n):
            dst[y, 0] = (int(left[y]) + 3 * dc + 2) >> 2
    return dst
