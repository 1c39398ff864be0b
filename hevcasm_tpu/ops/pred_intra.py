"""Intra prediction (reference: /root/reference/src/lib/pred_intra.c).

The reference wires up only the DC mode with optional edge filtering
(pred_intra.c:66-103); the other 34 modes exist in its vendored f265 asm but
are never hooked up (pred_intra.c:116-139).  Here the full HEVC Main-profile
mode set is implemented: DC (bit-exact with the reference), planar, and the
33 angular modes per ITU-T H.265 section 8.4.4.2 — batched, so an encoder can
evaluate every mode for a stack of blocks in one call and pick the best by
SATD, which is the batched formulation of intra mode decision.

Neighbour convention (functional, instead of the reference's packed pointer
layout at pred_intra.c:57-63):
  left:   (..., 2n) samples p[-1][0..2n-1]   (top to bottom)
  above:  (..., 2n) samples p[0..2n-1][-1]   (left to right)
  corner: (...,)    sample  p[-1][-1]

Reference-sample processing (H.265 8.4.4.2.2-3) is provided here too:
substitute_references (availability substitution by scan-order forward
fill), filter_references ([1 2 1] smoothing + 32x32 strong bilinear
smoothing) and filter_flag (the mode/size decision) — callers run these
before prediction; the encode paths (encode/loop.py, intra_wavefront.py)
do so.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "pred_intra_dc", "pred_intra_planar", "pred_intra_angular", "pred_intra",
    "pred_intra_all_modes", "substitute_references", "filter_references",
    "filter_flag",
]

# intraPredAngle per predModeIntra 2..34 (H.265 table 8-5).
ANGLES = {
    2: 32, 3: 26, 4: 21, 5: 17, 6: 13, 7: 9, 8: 5, 9: 2, 10: 0,
    11: -2, 12: -5, 13: -9, 14: -13, 15: -17, 16: -21, 17: -26, 18: -32,
    19: -26, 20: -21, 21: -17, 22: -13, 23: -9, 24: -5, 25: -2, 26: 0,
    27: 2, 28: 5, 29: 9, 30: 13, 31: 17, 32: 21, 33: 26, 34: 32,
}

# invAngle per angle magnitude (H.265 table 8-6): round(8192*32/angle).
INV_ANGLES = {-2: -4096, -5: -1638, -9: -910, -13: -630, -17: -482, -21: -390, -26: -315, -32: -256}


def _scan_pack(left, above, corner):
    """Pack neighbours in the 8.4.4.2.2 scan order: p[-1][2n-1] .. p[-1][0],
    p[-1][-1], p[0][-1] .. p[2n-1][-1] — i.e. reversed left, corner, above."""
    return jnp.concatenate(
        [jnp.flip(left, -1), corner[..., None], above], axis=-1
    )


def _scan_unpack(s, n2):
    left = jnp.flip(s[..., :n2], -1)
    corner = s[..., n2]
    above = s[..., n2 + 1 :]
    return left, above, corner


def substitute_references(left, above, corner, left_avail, above_avail,
                          corner_avail):
    """Reference-sample substitution (H.265 8.4.4.2.2).

    left/above (..., 2n) uint8, corner (...,); *_avail are boolean masks of
    the same shapes.  Unavailable samples take the value of the previous
    available sample in scan order (bottom-left -> corner -> above-right);
    a leading unavailable run takes the first available sample; if nothing
    is available every sample becomes 1 << (BitDepth-1) = 128.

    Returns substituted (left, above, corner) as uint8.
    """
    n2 = left.shape[-1]
    s = _scan_pack(left.astype(jnp.int32), above.astype(jnp.int32),
                   corner.astype(jnp.int32))
    m = _scan_pack(left_avail, above_avail, corner_avail)

    # Forward fill as ONE gather-free associative scan over (value, avail)
    # pairs — the combinator keeps the later operand's value when it is
    # available — no index scan and take_along_axis gather back.
    def keep_last(a, b):
        return (jnp.where(b[1], b[0], a[0]), a[1] | b[1])

    ax = s.ndim - 1
    vals, _ = jax.lax.associative_scan(keep_last, (s, m), axis=ax)
    # A leading unavailable run takes the FIRST available sample: the
    # reversed scan folds the FLIPPED sequence (so the same keep_last
    # combinator yields the nearest available at-or-after each position),
    # and its position 0 holds the first available overall.
    rvals, _ = jax.lax.associative_scan(keep_last, (s, m), axis=ax,
                                        reverse=True)
    filled = jnp.cumsum(m.astype(jnp.int32), axis=-1) > 0
    vals = jnp.where(filled, vals, rvals[..., :1])
    vals = jnp.where(jnp.any(m, axis=-1)[..., None], vals, 128)
    l, a, c = _scan_unpack(vals, n2)
    return l.astype(jnp.uint8), a.astype(jnp.uint8), c.astype(jnp.uint8)


def filter_references(left, above, corner, n: int, strong: jnp.ndarray | None = None):
    """Reference-sample smoothing (H.265 8.4.4.2.3).

    [1 2 1]/4 filter along the scan-order sample run, endpoints unchanged.
    `strong` (optional, (...,) bool; only meaningful for n == 32) selects
    the strong bilinear smoothing per block: each edge run is linearly
    interpolated between the corner and its outermost sample.

    Returns filtered (left, above, corner) as uint8.
    """
    n2 = left.shape[-1]
    s = _scan_pack(left.astype(jnp.int32), above.astype(jnp.int32),
                   corner.astype(jnp.int32))
    interior = (s[..., :-2] + 2 * s[..., 1:-1] + s[..., 2:] + 2) >> 2
    sf = jnp.concatenate([s[..., :1], interior, s[..., -1:]], axis=-1)
    lf, af, cf = _scan_unpack(sf, n2)

    if strong is not None:
        assert n2 == 64, "strong smoothing is defined for 32x32 blocks"
        c32 = corner.astype(jnp.int32)[..., None]
        k = jnp.arange(n2, dtype=jnp.int32)
        a_end = above[..., n2 - 1].astype(jnp.int32)[..., None]
        l_end = left[..., n2 - 1].astype(jnp.int32)[..., None]
        a_str = ((63 - k) * c32 + (k + 1) * a_end + 32) >> 6
        l_str = ((63 - k) * c32 + (k + 1) * l_end + 32) >> 6
        a_str = a_str.at[..., n2 - 1].set(a_end[..., 0])
        l_str = l_str.at[..., n2 - 1].set(l_end[..., 0])
        sel = strong[..., None]
        lf = jnp.where(sel, l_str, lf.astype(jnp.int32))
        af = jnp.where(sel, a_str, af.astype(jnp.int32))
        cf = jnp.where(strong, corner.astype(jnp.int32), cf.astype(jnp.int32))
    return lf.astype(jnp.uint8), af.astype(jnp.uint8), cf.astype(jnp.uint8)


def strong_smoothing_condition(left, above, corner, bit_depth: int = 8):
    """The 32x32 flatness test gating strong smoothing (8.4.4.2.3): both
    edges must be near-linear within 1 << (BitDepth - 5).  Returns (...,)
    bool."""
    c = corner.astype(jnp.int32)
    a = above.astype(jnp.int32)
    l = left.astype(jnp.int32)
    thr = 1 << (bit_depth - 5)
    cond_a = jnp.abs(c + a[..., 63] - 2 * a[..., 31]) < thr
    cond_l = jnp.abs(c + l[..., 63] - 2 * l[..., 31]) < thr
    return cond_a & cond_l


# intraHorVerDistThres per nTbS (H.265 table 8-7).
_FILTER_THRES = {8: 7, 16: 1, 32: 0}


def filter_flag(mode: int, n: int) -> bool:
    """Whether mode `mode` predicts from the FILTERED reference samples for
    an n x n luma block (H.265 8.4.4.2.3 filterFlag)."""
    if mode == 1 or n not in _FILTER_THRES:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))  # == 10 for planar
    return min_dist > _FILTER_THRES[n]


def pred_intra_dc(
    left: jnp.ndarray, above: jnp.ndarray, n: int, filter_edge: bool = False
) -> jnp.ndarray:
    """DC prediction, bit-exact with hevcasm_pred_intra_dc_ref
    (pred_intra.c:66-103).

    dcVal = (n + sum(above[:n]) + sum(left[:n])) >> (log2(n)+1); with
    filter_edge the first row/column are blended 1:3 with the neighbours.
    """
    k = n.bit_length() - 1
    a = above[..., :n].astype(jnp.int32)
    l = left[..., :n].astype(jnp.int32)
    dc = (n + a.sum(-1) + l.sum(-1)) >> (k + 1)  # (...,)
    out = jnp.broadcast_to(dc[..., None, None], dc.shape + (n, n))
    if not filter_edge:
        return out.astype(jnp.uint8)
    dcb = dc[..., None]
    row0 = (a + 3 * dcb + 2) >> 2  # (..., n)
    col0 = (l + 3 * dcb + 2) >> 2
    corner00 = (l[..., 0] + 2 * dc + a[..., 0] + 2) >> 2  # (...,)
    out = out.at[..., 0, :].set(row0)
    out = out.at[..., :, 0].set(col0)
    out = out.at[..., 0, 0].set(corner00)
    return out.astype(jnp.uint8)


def pred_intra_planar(
    left: jnp.ndarray, above: jnp.ndarray, n: int
) -> jnp.ndarray:
    """Planar prediction (H.265 8.4.4.2.4):
    dst[y, x] = ((n-1-x)*left[y] + (x+1)*above[n] + (n-1-y)*above[x]
                 + (y+1)*left[n] + n) >> (log2(n)+1)."""
    k = n.bit_length() - 1
    a = above.astype(jnp.int32)
    l = left.astype(jnp.int32)
    x = jnp.arange(n, dtype=jnp.int32)
    y = jnp.arange(n, dtype=jnp.int32)
    ax = a[..., None, :n]                       # (..., 1, n)
    ly = l[..., :n, None]                       # (..., n, 1)
    tr = a[..., n, None, None]                  # above-right p[n][-1]
    bl = l[..., n, None, None]                  # below-left  p[-1][n]
    h = (n - 1 - x)[None, :] * ly + (x + 1)[None, :] * tr
    v = (n - 1 - y)[:, None] * ax + (y + 1)[:, None] * bl
    return ((h + v + n) >> (k + 1)).astype(jnp.uint8)


def _angular_ref(left, above, corner, n, angle):
    """Build the 1-D reference sample array ref[-n .. 2n] (index offset +n)
    for a vertical-family mode; for horizontal modes callers swap left/above.
    H.265 8.4.4.2.6 steps 1-2."""
    a = above.astype(jnp.int32)
    l = left.astype(jnp.int32)
    c = corner.astype(jnp.int32)[..., None]
    pos = jnp.concatenate([c, a], axis=-1)  # ref[0..2n]
    if angle >= 0:
        return pos, 0  # no negative part needed
    inv = INV_ANGLES[angle]
    neg_len = -((n * angle) >> 5)  # deepest index needed is (n*angle)>>5
    neg_idx = []
    for x in range(-1, -neg_len - 1, -1):
        y0 = -1 + ((x * inv + 128) >> 8)
        neg_idx.append(y0)
    # ref[x] = p[-1][y0] = corner if y0 == -1 else left[y0]
    parts = [jnp.where(y0 < 0, c[..., 0], l[..., max(y0, 0)])[..., None] for y0 in neg_idx]
    neg = jnp.concatenate(parts[::-1], axis=-1)  # ref[-neg_len .. -1]
    return jnp.concatenate([neg, pos], axis=-1), neg_len


def pred_intra_angular(
    left: jnp.ndarray,
    above: jnp.ndarray,
    corner: jnp.ndarray,
    n: int,
    mode: int,
    filter_edge: bool = False,
) -> jnp.ndarray:
    """Angular prediction, modes 2..34 (H.265 8.4.4.2.6).

    filter_edge applies the boundary smoothing of the pure horizontal /
    vertical modes (10 and 26) for luma blocks < 32x32.
    """
    assert 2 <= mode <= 34
    angle = ANGLES[mode]
    vertical = mode >= 18
    if not vertical:
        left, above = above, left  # horizontal family: swap then transpose
    ref, off = _angular_ref(left, above, corner, n, angle)

    # Static per-row interpolation indices/weights.
    yy = np.arange(1, n + 1)
    i_idx = (yy * angle) >> 5
    i_fact = (yy * angle) & 31
    xx = np.arange(n)
    gather = off + xx[None, :] + i_idx[:, None] + 1  # (n, n) into ref coords
    r0 = jnp.take(ref, jnp.asarray(gather), axis=-1)          # (..., n, n)
    r1 = jnp.take(ref, jnp.asarray(gather + 1), axis=-1)
    w = jnp.asarray(i_fact[:, None], jnp.int32)
    out = ((32 - w) * r0 + w * r1 + 16) >> 5

    if filter_edge and angle == 0 and n < 32:
        # Boundary smoothing of the pure vertical/horizontal modes 26/10
        # (8.4.4.2.6, luma, nTbS < 32).  In the post-swap (main, side) frame:
        # dst[y, 0] = Clip(main[0] + ((side[y] - corner) >> 1)); `above` holds
        # the main edge and `left` the side edge for both families here.
        main0 = above[..., 0].astype(jnp.int32)[..., None]    # (..., 1)
        delta = (left[..., :n].astype(jnp.int32) - corner.astype(jnp.int32)[..., None]) >> 1
        col0 = jnp.clip(main0 + delta, 0, 255)
        out = out.at[..., :, 0].set(col0)

    out = jnp.clip(out, 0, 255).astype(jnp.uint8)
    if not vertical:
        out = jnp.swapaxes(out, -1, -2)
    return out


def pred_intra(
    mode: int,
    left: jnp.ndarray,
    above: jnp.ndarray,
    corner: jnp.ndarray,
    n: int,
    filter_edge: bool = False,
) -> jnp.ndarray:
    """Dispatch one of the 35 HEVC intra modes (0=planar, 1=DC, 2..34 angular).

    Mode is static (shape-determining); for batched mode decision use
    pred_intra_all_modes."""
    if mode == 0:
        return pred_intra_planar(left, above, n)
    if mode == 1:
        return pred_intra_dc(left, above, n, filter_edge)
    return pred_intra_angular(left, above, corner, n, mode, filter_edge)


def pred_intra_all_modes(
    left: jnp.ndarray, above: jnp.ndarray, corner: jnp.ndarray, n: int
) -> jnp.ndarray:
    """Evaluate all 35 modes; returns (..., 35, n, n) for SATD-based mode
    decision in one batched sweep (replacing the reference's per-mode calls)."""
    outs = [pred_intra(m, left, above, corner, n) for m in range(35)]
    return jnp.stack(outs, axis=-3)
