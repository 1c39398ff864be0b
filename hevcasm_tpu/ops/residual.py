"""The fused residual-pipeline op family: transform -> quantize -> dequantize
-> inverse transform -> add -> clip over a stack of CTUs, the composition a
client encoder makes of the reference's four residual tables (SURVEY.md
section 3.3: residual_decode.c:592-852 forward, quantize.c:160-186 quant,
quantize.c:53-62 dequant, residual_decode.c:69-368 inverse+add).

This module is the REF tier: a per-TU composition of the individually
bit-exact ops.  Optimized tier: kernels/xla_opt.residual_pipeline_frame
(whole-frame block-diagonal matmuls, Tier.JIT).  Both tiers return the
same (recon, nnz, cbf) contract:

  recon (n, B, B) uint8; nnz () int32 total coded coefficients;
  cbf (n*(B/tu)^2,) bool per-TU coded-block flags in raster TU order.
"""

from __future__ import annotations

import jax.numpy as jnp

from .transform import forward_transform, inverse_transform_add
from .quantize import quantize, quantize_inverse

__all__ = ["residual_pipeline"]


def _split(blocks: jnp.ndarray, sub: int) -> jnp.ndarray:
    """(n, B, B) -> (n*(B/sub)^2, sub, sub), raster TU order per CTU."""
    n, big, _ = blocks.shape
    k = big // sub
    x = blocks.reshape(n, k, sub, k, sub).swapaxes(2, 3)
    return x.reshape(n * k * k, sub, sub)


def _merge(tus: jnp.ndarray, big: int) -> jnp.ndarray:
    sub = tus.shape[-1]
    k = big // sub
    n = tus.shape[0] // (k * k)
    x = tus.reshape(n, k, k, sub, sub).swapaxes(2, 3)
    return x.reshape(n, big, big)


def residual_pipeline(
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
    """REF-tier residual pipeline over (n, B, B) uint8 CTU stacks."""
    big = src_blocks.shape[-1]
    res = src_blocks.astype(jnp.int16) - pred_blocks.astype(jnp.int16)
    tus = _split(res, tu)
    ptus = _split(pred_blocks, tu)
    coeffs = forward_transform(tus, tr_type)
    levels, cbf = quantize(coeffs, qscale, qshift, qoffset)
    rcoeffs = quantize_inverse(levels, dscale, dshift)
    rec_tus = inverse_transform_add(rcoeffs, ptus, tr_type)
    rec = _merge(rec_tus, big)
    nnz = jnp.sum(levels.astype(jnp.int32) != 0)
    return rec, nnz, cbf.reshape(-1)
