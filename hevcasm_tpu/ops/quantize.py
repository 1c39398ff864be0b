"""Quantization family (reference: /root/reference/src/lib/quantize.c).

Three ops, all elementwise and batched here:

* quantize          - HM-style forward quantization with sign/abs split and
                      coded-block-flag reduction (quantize.c:160-186).
* quantize_inverse  - inverse quantization ("scaling", quantize.c:53-62).
* reconstruct       - rec = Clip3(0, 255, pred + res) (quantize.c:292-302).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["quantize", "quantize_inverse", "reconstruct", "quantize_checked",
           "check_params_traced"]


def _require(name, val, lo, hi, traced_check: bool):
    """Enforce a reference-asserted parameter range (quantize.c:162-165).

    Concrete values (python/numpy ints/arrays AND committed jax Arrays —
    every static-qp call path) fail immediately with
    ValueError.  Traced values (the rate-control path, encode/rate.py)
    cannot be inspected at trace time; when ``traced_check`` a
    checkify.check is emitted — callers must then be functionalized (use
    quantize_checked), since a bare check raises under plain jit."""
    import jax

    if isinstance(val, jax.Array) and not isinstance(val, jax.core.Tracer):
        val = np.asarray(val)
    if isinstance(val, (int, np.integer, np.ndarray)):
        if not np.all((np.asarray(val) >= lo) & (np.asarray(val) <= hi)):
            raise ValueError(f"quantize: {name}={val} outside [{lo}, {hi}] "
                             "(reference asserts this, quantize.c:162-165)")
    elif traced_check:
        checkify.check(
            jnp.all((jnp.asarray(val) >= lo) & (jnp.asarray(val) <= hi)),
            f"quantize: {name} outside [{lo}, {hi}]",
        )


def check_params_traced(scale, shift, offset):
    """Emit the reference's asserted forward-quantizer ranges
    (quantize.c:162-165) as checkify checks on traced parameters — for
    callers that feed the parameters to fused kernels without going
    through quantize() (encode/rate.py's fused tier).  Must run under a
    checkify transform."""
    _require("scale", scale, 1, 0x7FFF, True)
    _require("shift", shift, 16, 27, True)
    _require("offset", offset, 0, 0x7FFF, True)


def quantize(src: jnp.ndarray, scale, shift, offset,
             _traced_check: bool = False) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Forward quantization over the trailing two axes.

    src: (..., n, n) int16 transform coefficients.
    scale < 0x8000, 16 <= shift <= 27, offset < 0x8000 (asserted by the
    reference, quantize.c:162-165): concrete out-of-range parameters raise
    ValueError; traced ones (per-block rate control) are range-checked via
    quantize_checked.  scale/shift/offset may be python ints or
    broadcastable arrays.

    Returns (dst, cbf): dst int16 quantized levels, bit-exact with
    hevcasm_quantize_c_ref (quantize.c:160-186); cbf bool per block, true iff
    any level is non-zero (the C code ORs the levels and callers test !!cbf,
    quantize.c:181 / :257).
    """
    _require("scale", scale, 1, 0x7FFF, _traced_check)
    _require("shift", shift, 16, 27, _traced_check)
    _require("offset", offset, 0, 0x7FFF, _traced_check)
    x = src.astype(jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    shift = jnp.asarray(shift, jnp.int32)
    offset = jnp.asarray(offset, jnp.int32) << (shift - 16)
    sign = jnp.where(x < 0, -1, 1)
    q = ((jnp.abs(x) * scale + offset) >> shift) * sign
    q = jnp.clip(q, -32768, 32767)
    cbf = jnp.any(q != 0, axis=(-2, -1))
    return q.astype(jnp.int16), cbf


def quantize_checked(src, scale, shift, offset):
    """checkify-functionalized quantize for traced parameters (the rate-
    control path): returns (error, (dst, cbf)); error.throw() raises on any
    out-of-range parameter — the traced analogue of the reference's asserts
    (quantize.c:162-165)."""
    return checkify.checkify(
        lambda *a: quantize(*a, _traced_check=True)
    )(src, scale, shift, offset)


def quantize_inverse(src: jnp.ndarray, scale, shift) -> jnp.ndarray:
    """Inverse quantization over any shape.

    dst = Clip3(-32768, 32767, (src*scale + (1 << (shift-1))) >> shift),
    bit-exact with hevcasm_quantize_inverse_c_ref (quantize.c:53-62).
    """
    x = src.astype(jnp.int32)
    scale = jnp.asarray(scale, jnp.int32)
    shift = jnp.asarray(shift, jnp.int32)
    y = (x * scale + (1 << (shift - 1))) >> shift
    return jnp.clip(y, -32768, 32767).astype(jnp.int16)


def reconstruct(pred: jnp.ndarray, res: jnp.ndarray, bit_depth: int = 8) -> jnp.ndarray:
    """rec = Clip3(0, (1<<bit_depth)-1, pred + res), bit-exact with
    hevcasm_quantize_reconstruct_c_ref (quantize.c:292-302)."""
    rec = pred.astype(jnp.int32) + res.astype(jnp.int32)
    return jnp.clip(rec, 0, (1 << bit_depth) - 1).astype(jnp.uint8)
