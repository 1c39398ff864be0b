"""Matrix formulation of quarter-pel refinement: banded-matrix FIR matmuls.

The 8-tap HEVC interpolation FIR along an axis is a matmul with a constant
banded matrix B[x, o] = c[x - o] (pred_inter.c:57-63 coefficients), so the
16-candidate fractional sweep of motion.refine_quarter_pel becomes 4 + 32
frame-batched matmuls instead of 20 elementwise int32 FIR passes:

  H pass (per xfrac, 4x):   win (n, y, x) @ Bx (x, o)    -- uint8 inputs,
      products <= 64*255 and 8-tap sums < 2^18: exact in bf16 x bf16 -> f32.
  V pass (per yf*xf, 16x):  Ay (o, y) @ inter (n, y, w)  -- int16 wrapped
      intermediates via the hi/lo byte split (2 matmuls each), cf.
      kernels/xla_opt.py exactness argument.

Selection (per-CTU argmin of SAD over the 16 fracs, first-minimum ties) and
outputs are bit-exact with motion.refine_quarter_pel (tests/test_interp_xla.py).
On the GPU the bf16 x bf16 -> f32 contractions can run on the tensor cores;
exactness needs only that every partial sum stays an integer below 2^24.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.pred_inter import KERNEL8, qpel_score

__all__ = ["refine_quarter_pel_mxu", "refine_qpel_costmap_mxu"]

_TAPS = 8


def _banded(coef: np.ndarray, in_len: int, out_len: int) -> np.ndarray:
    """B[x, o] = coef[x - o] for 0 <= x - o < taps, else 0."""
    b = np.zeros((in_len, out_len), np.float32)
    for o in range(out_len):
        b[o : o + _TAPS, o] = coef
    return b


@jax.jit
def refine_qpel_costmap_mxu(src_blocks: jnp.ndarray, windows: jnp.ndarray):
    """All-16-candidate quarter-pel sweep WITHOUT selection: returns
    (preds (n, 16, b, b) uint8, costs (n, 16) int32 SAD per frac yf*4+xf).

    The building block for rectangular/AMP PU refinement: a PU larger than
    its square tile sums the tile costmaps, argmins ONE frac for the whole
    PU, and picks each tile's prediction at that frac
    (encode/partition.py)."""
    preds, costs = _qpel_sweep(src_blocks, windows)
    return jnp.stack(preds, axis=1), jnp.stack(costs, axis=1)


def _qpel_sweep(src_ctus, windows):
    """16-candidate interpolation + SAD lists (see refine_qpel_costmap_mxu)."""
    n, b, _ = src_ctus.shape
    wlen = b + _TAPS - 1
    win_bf = windows.astype(jnp.bfloat16)
    src32 = src_ctus.astype(jnp.int32)

    # 4 horizontal passes shared across the vertical fractions.
    inters = []
    for xf in range(4):
        bx = jnp.asarray(_banded(KERNEL8[xf], wlen, b)).astype(jnp.bfloat16)
        acc = jnp.einsum(
            "nyx,xo->nyo", win_bf, bx, preferred_element_type=jnp.float32
        ).astype(jnp.int32)
        # int16 intermediate store (pred_inter.c:124).
        inters.append(acc.astype(jnp.int16).astype(jnp.int32))

    preds, costs = [], []
    for yf in range(4):
        ay = jnp.asarray(_banded(KERNEL8[yf], wlen, b).T).astype(jnp.bfloat16)
        for xf in range(4):
            x = inters[xf]
            hi = (x >> 8).astype(jnp.bfloat16)
            lo = jnp.bitwise_and(x, 255).astype(jnp.bfloat16)
            yh = jnp.einsum("oy,nyw->now", ay, hi, preferred_element_type=jnp.float32)
            yl = jnp.einsum("oy,nyw->now", ay, lo, preferred_element_type=jnp.float32)
            acc = 256 * yh.astype(jnp.int32) + yl.astype(jnp.int32)
            p = jnp.clip((acc + 2048) >> 12, 0, 255).astype(jnp.uint8)
            preds.append(p)
            costs.append(qpel_score(acc, src32))

    return preds, costs


@jax.jit
def refine_quarter_pel_mxu(src_ctus: jnp.ndarray, windows: jnp.ndarray):
    """src_ctus (n, b, b) uint8, windows (n, b+7, b+7) uint8 at the integer
    MV.  Returns (pred (n, b, b) uint8, frac_idx (n,) int32 = yf*4+xf,
    cost (n,) int32), matching motion.refine_quarter_pel's selection."""
    preds, costs = _qpel_sweep(src_ctus, windows)
    preds = jnp.stack(preds, axis=1)  # (n, 16, b, b)
    costs = jnp.stack(costs, axis=1)  # (n, 16)
    best = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    pred = jnp.take_along_axis(preds, best[:, None, None, None], axis=1)[:, 0]
    cost = jnp.take_along_axis(costs, best[:, None], axis=1)[:, 0]
    return pred, best, cost


from .. import registry as _registry
from ..config import Tier as _Tier

_registry.register("refine_qpel", _Tier.JIT, refine_quarter_pel_mxu)
