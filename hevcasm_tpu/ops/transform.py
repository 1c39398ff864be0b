"""HEVC core transforms: forward/inverse DCT-II 4/8/16/32 and DST-VII 4x4.

Bit-exact re-derivation of the reference's partial-butterfly C implementations
(/root/reference/src/lib/residual_decode.c:69-347 inverse, :592-852 forward),
reformulated as batched matrix products: each butterfly pass is an N x N
constant integer matrix product over a *batch* of blocks,
instead of a scalar butterfly over one block.

Semantics captured from the reference:

* The transform matrix is the standard HEVC 32-point matrix; the 16/8/4-point
  matrices are its even-row subsets (rows 0,2,4,.. / 0,4,8,.. / 0,8,16,24).
* Forward pass k (residual_decode.c:855-892):
      dst[k, i] = (sum_j T[k, j] * src[i, j] + (1 << (shift-1))) >> shift
  i.e. dst = (T @ src^T) >> shift, stored into int16 WITHOUT clipping (the C
  code assigns an int to int16_t, i.e. wraps).  Shift pairs per size:
  4x4 (1, 8), 8x8 (2, 9), 16x16 (3, 10), 32x32 (4, 11).
* Inverse pass (residual_decode.c:69-347):
      dst[i, k] = Clip3(-32768, 32767,
                        (sum_j T[j, k] * src[j, i] + (1 << (shift-1))) >> shift)
  i.e. dst = clip((src^T @ T) >> shift); shifts (7, 12) for every size.
* Inverse transform is fused with "add to predicted and clip to 8-bit"
  (residual_decode.c:359-368), the hevcasm_inverse_transform_add contract
  (residual_decode.h:54).
* DST-VII 4x4 uses the {29,55,74,84} matrix in the same two matmul forms
  (residual_decode.c:69-88 inverse, :592-610 forward).

All arithmetic is int32 with arithmetic right shifts; int16 narrowing uses
two's-complement truncation, matching C.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = [
    "DCT32",
    "dct_matrix",
    "DST4",
    "forward_transform",
    "inverse_transform",
    "inverse_transform_add",
    "add_residual",
    "forward_shifts",
    "INVERSE_SHIFTS",
]

# The 32-point HEVC transform matrix (residual_decode.c:254-288).  Rows are
# sampled cosines scaled by 64*sqrt(2); this table is normative in the HEVC
# specification (ITU-T H.265 section 8.6.4), re-entered here from the spec's
# first-column values via the recurrence T[k, j] = cos(k*(2j+1)*pi/64)-derived
# integer approximation.  Verified bit-exact against the reference in tests.
_T32_FIRST_COL = [
    64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
    64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
]


def _build_dct32() -> np.ndarray:
    """Construct the 32x32 HEVC matrix from its defining structure.

    Row k of the HEVC matrix satisfies T32[k, j] = s(k, j) * c[f(k, j)] where
    the magnitudes come from the first column read at index (k*(2j+1)) mod 128
    folded into [0, 64), with sign flips per quadrant — i.e. the integer
    cosine table evaluated at angle k*(2j+1)*pi/64.
    """
    c = np.asarray(_T32_FIRST_COL, dtype=np.int64)
    t = np.zeros((32, 32), dtype=np.int64)
    for k in range(32):
        for j in range(32):
            phase = (k * (2 * j + 1)) % 128  # angle in units of pi/64
            if phase >= 64:
                sign, phase = -1, phase - 64
            else:
                sign = 1
            if phase >= 32:
                # cos(pi/2 .. pi) region: mirror and negate
                val = -c[64 - phase] if phase != 32 else 0
            else:
                val = c[phase]
            t[k, j] = sign * val
    return t.astype(np.int32)


DCT32 = _build_dct32()

# DST-VII 4x4 matrix (residual_decode.c:592-610).
DST4 = np.array(
    [
        [29, 55, 74, 84],
        [74, 74, 0, -74],
        [84, -29, -74, 55],
        [55, -84, 74, -29],
    ],
    dtype=np.int32,
)

# Forward shift pairs, indexed by log2 transform size
# (residual_decode.c:855-892): shift1 = log2 - 1, shift2 = log2 + 6.
INVERSE_SHIFTS = (7, 12)  # all sizes (residual_decode.c:371-413)


def forward_shifts(log2: int) -> tuple[int, int]:
    return (log2 - 1, log2 + 6)


def dct_matrix(n: int) -> np.ndarray:
    """The n-point HEVC matrix as the even-row subset of DCT32."""
    assert n in (4, 8, 16, 32)
    step = 32 // n
    return np.ascontiguousarray(DCT32[::step, :n])


def _matrix(n: int, tr_type: int) -> np.ndarray:
    if tr_type:
        assert n == 4, "DST only defined for 4x4 luma intra"
        return DST4
    return dct_matrix(n)


def _fwd_stage(x: jnp.ndarray, t: jnp.ndarray, shift: int) -> jnp.ndarray:
    """One forward butterfly pass: (T @ x^T + add) >> shift, wrapped to int16.

    x: (..., n, n) int32.  Returns int16-wrapped values held in int32.
    """
    add = 1 << (shift - 1)
    y = jnp.einsum("kj,...ij->...ki", t, x.astype(jnp.int32))
    y = (y + add) >> shift
    # C stores into int16_t: two's-complement truncation, no clip
    # (residual_decode.c:605-608 et al.).
    return y.astype(jnp.int16).astype(jnp.int32)


def _inv_stage(x: jnp.ndarray, t: jnp.ndarray, shift: int) -> jnp.ndarray:
    """One inverse pass: clip3((x^T @ T + add) >> shift) per
    residual_decode.c:69-347."""
    add = 1 << (shift - 1)
    y = jnp.einsum("jk,...ji->...ik", t, x.astype(jnp.int32))
    y = (y + add) >> shift
    return jnp.clip(y, -32768, 32767)


def forward_transform(res: jnp.ndarray, tr_type: int = 0) -> jnp.ndarray:
    """Forward transform of a batch of square residual blocks.

    res: (..., n, n) integer residuals (int16 range).  n in {4, 8, 16, 32};
    tr_type=1 selects the 4x4 DST-VII (luma intra), else DCT-II.
    Returns int16 coefficients, bit-exact with hevcasm_dct_NxN_c_opt /
    hevcasm_dst_4x4_c_opt (residual_decode.c:855-892).
    """
    n = res.shape[-1]
    assert res.shape[-2] == n
    t = jnp.asarray(_matrix(n, tr_type))
    s1, s2 = forward_shifts(n.bit_length() - 1)
    return _fwd_stage(_fwd_stage(res, t, s1), t, s2).astype(jnp.int16)


def inverse_transform(coeffs: jnp.ndarray, tr_type: int = 0) -> jnp.ndarray:
    """Inverse transform only (the residual before add-to-predicted).

    coeffs: (..., n, n) int16 coefficients.  Returns int16 residuals,
    bit-exact with the two clipped inverse butterfly passes
    (residual_decode.c:371-413, shifts 7 then 12).
    """
    n = coeffs.shape[-1]
    t = jnp.asarray(_matrix(n, tr_type))
    s1, s2 = INVERSE_SHIFTS
    return _inv_stage(_inv_stage(coeffs, t, s1), t, s2).astype(jnp.int16)


def add_residual(pred: jnp.ndarray, res: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """rec = Clip3(0, (1<<bit_depth)-1, pred + res) (residual_decode.c:350-368)."""
    rec = pred.astype(jnp.int32) + res.astype(jnp.int32)
    return jnp.clip(rec, 0, (1 << bit_depth) - 1).astype(jnp.uint8)


def inverse_transform_add(
    coeffs: jnp.ndarray, pred: jnp.ndarray, tr_type: int = 0, bit_depth: int = 8
) -> jnp.ndarray:
    """Fused inverse transform + add to predicted + clip, the
    hevcasm_inverse_transform_add contract (residual_decode.h:54,
    residual_decode.c:371-413)."""
    return add_residual(pred, inverse_transform(coeffs, tr_type), bit_depth)
