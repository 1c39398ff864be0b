"""Closed-loop intra encoding with wavefront parallelism.

SURVEY.md section 7 lists "dependent CTU ordering (wavefront dependencies)"
as the hardest part it defers; this module implements it.  True HEVC intra
predicts each block from *reconstructed* neighbours, creating the raster
dependency (left, above, above-right).  The batched schedule is the WPP
wavefront: with wave index w = 2r + c every dependency of block (r, c) —
left (w-1), above (w-2), above-right (w-1) — lands in a strictly earlier
wave, so all blocks of a wave are independent and batch together:

    lax.scan over waves  x  batched block slots within a wave

**Skewed canvas.**  Keeping the reconstruction in frame layout costs, per
wave, a vmapped dynamic-slice neighbour gather and a 2-D scatter of the
reconstructed blocks, which swamp the arithmetic.  Block (r, c) is instead
stored at skewed block-column c + 2r, which makes every wave
COLUMN-ALIGNED:

  * wave w's blocks all live in skewed column w  -> the write is ONE
    dynamic_update_slice of a (gr*n, n) column;
  * every dependency lives in skewed columns w-3..w-1 (left at w-1, above
    at w-2, above-right at w-1, corner at w-3)  -> all neighbour runs come
    from ONE (ch, 3n) dynamic slice, rearranged by static reshapes.

The mapping (r, c) -> (r, c + 2r) is injective, so out-of-range slots
(waves touch at most min(gr, ...) valid blocks) write into cells no valid
block ever reads.  Predictions/decisions are bit-exact with the raster-
order sequential encode (tests/test_intra_wavefront.py).

(Dependencies of (r, c): left (r, c-1) -> wave w-1, above (r-1, c) -> w-2,
above-right (r-1, c+1) -> w-1, above-left (r-1, c-1) -> w-3.)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.psnr import psnr
from . import ctu as ctu_mod
from .loop import EncodeConfig, _intra_mode_decide, _prepare_intra_refs, \
    _residual_pipeline

__all__ = ["encode_intra_frame_wavefront"]

UNAVAILABLE = 128  # HEVC substitution value when no neighbour exists


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_intra_frame_wavefront(cur: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()):
    """Closed-loop intra frame: 35-mode decision against *reconstructed*
    neighbours, WPP wave schedule on a skewed canvas.  cur (H, W) uint8;
    H, W multiples of cfg.intra_block."""
    h, w = cur.shape
    n = cfg.intra_block
    gr, gc = h // n, w // n
    num_waves = 2 * (gr - 1) + gc

    # Skewed canvas: block (r, c) at rows [n + r*n, +n), block-column
    # 3 + c + 2r (3 left margin block-cols so the w-3 slab read is always
    # in range); one n-row margin top and bottom (the left-run read of the
    # last block row reaches one block-group below).
    ch = (gr + 2) * n
    cwb = 3 + num_waves
    canvas0 = jnp.full((ch, cwb * n), UNAVAILABLE, jnp.uint8)

    # Source in the same skewed layout, built once with static updates.
    src_sk = jnp.zeros((ch, cwb * n), jnp.uint8)
    for r in range(gr):
        src_sk = jax.lax.dynamic_update_slice(
            src_sk, cur[r * n : (r + 1) * n], (n + r * n, (3 + 2 * r) * n)
        )

    rr = jnp.arange(gr, dtype=jnp.int32)
    ii = jnp.arange(2 * n, dtype=jnp.int32)

    def wave_body(canvas, wv):
        col = wv * n  # slab covers skewed block-cols wv-3..wv-1 (+3 margin)
        slab = jax.lax.dynamic_slice(canvas, (0, col), (ch, 3 * n))
        g = slab.reshape(gr + 2, n, 3 * n)
        # Neighbour runs by static rearrangement of the slab:
        #   above(-right) 2n-run of slot r = canvas row (r+1)*n - 1 across
        #   skewed cols w-2, w-1  -> group r, inner row n-1, cols [n, 3n);
        #   left run rows [n + r*n, +2n) at the w-1 column's last lane ->
        #   groups r+1, r+2 (the lower half is never available: masked);
        #   corner = same row as above at the w-3 column's last lane.
        above = g[0:gr, n - 1, n : 3 * n]                  # (gr, 2n)
        lcol = g[:, :, 3 * n - 1]                          # (gr+2, n)
        left = jnp.concatenate([lcol[1 : gr + 1], lcol[2 : gr + 2]], axis=-1)
        corner = g[0:gr, n - 1, n - 1]                     # (gr,)

        src = jax.lax.dynamic_slice(src_sk, (0, col + 3 * n), (ch, n))
        src = src.reshape(gr + 2, n, n)[1 : gr + 1]        # (gr, n, n)

        c = wv - 2 * rr
        valid = (c >= 0) & (c < gc)
        # Availability under the wavefront coding order (8.4.4.2.2): the
        # left and above(-right) neighbours come from earlier waves, but
        # the below-left run belongs to wave w+1 and is never available.
        y_pix = rr[:, None] * n
        x_pix = c[:, None] * n
        lav = (c[:, None] > 0) & (y_pix + ii[None, :] < h) & (ii[None, :] < n)
        aav = (rr[:, None] > 0) & (x_pix + ii[None, :] < w) & valid[:, None]
        cav = (c > 0) & (rr > 0)
        refs_plain, refs_filt = _prepare_intra_refs(
            left, above, corner, lav, aav, cav, n, cfg
        )

        pred, best = _intra_mode_decide(src, refs_plain, refs_filt, n)

        # Invalid (masked) slots encode a zero residual so they contribute
        # nothing to the nnz statistic.
        src = jnp.where(valid[:, None, None], src, pred)
        rec, nnz, _ = _residual_pipeline(src, pred, cfg, intra=True)

        canvas = jax.lax.dynamic_update_slice(
            canvas, rec.reshape(gr * n, n), (n, col + 3 * n)
        )
        return canvas, nnz

    canvas, nnzs = jax.lax.scan(wave_body, canvas0, jnp.arange(num_waves, dtype=jnp.int32))

    # De-skew: block row r's gc block-columns start at skewed col 3 + 2r.
    rows = [
        jax.lax.slice(canvas, (n + r * n, (3 + 2 * r) * n),
                      (n + (r + 1) * n, (3 + 2 * r + gc) * n))
        for r in range(gr)
    ]
    recon = jnp.concatenate(rows, axis=0)
    return {
        "recon": recon,
        "nnz": jnp.sum(nnzs),
        "psnr_db": psnr(cur, recon),
    }
