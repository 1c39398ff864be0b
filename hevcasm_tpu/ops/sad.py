"""Sum-of-absolute-differences kernels (reference: /root/reference/src/lib/sad.c).

The reference exposes a single-block SAD (sad.c:47-60) and a 4-way multi-
reference SAD for the motion-search inner loop (sad.c:101-121), each behind a
rect-keyed function-pointer table.  Under jit the natural formulation is fully
batched: one call computes SAD for a whole stack of blocks (a CTU-tiled frame)
and an arbitrary number of candidate references, generalising the asm's
hard-coded ways=4 (sad.h:106) to an N-candidate axis, and the full candidate
grid of a motion search becomes a single scanned reduction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["sad", "sad_multiref", "sad_grid"]


def sad(src: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    """SAD over the trailing two (height, width) axes.

    src, ref: (..., h, w) uint8 (or any integer dtype).  Returns (...,) int32.
    Bit-exact with hevcasm_sad_c_ref (sad.c:47-60) for each block.
    """
    d = src.astype(jnp.int32) - ref.astype(jnp.int32)
    return jnp.sum(jnp.abs(d), axis=(-2, -1))


def sad_multiref(src: jnp.ndarray, refs: jnp.ndarray) -> jnp.ndarray:
    """Multi-reference SAD: one source block vs k candidate references.

    src:  (..., h, w)
    refs: (..., k, h, w)
    Returns (..., k) int32.  With k=4 this is bit-exact with
    hevcasm_sad_multiref_4_c_ref (sad.c:101-121); any k is allowed.
    """
    d = src[..., None, :, :].astype(jnp.int32) - refs.astype(jnp.int32)
    return jnp.sum(jnp.abs(d), axis=(-2, -1))


def sad_grid(src: jnp.ndarray, window: jnp.ndarray, num_dy: int, num_dx: int) -> jnp.ndarray:
    """Dense SAD over a full candidate grid, the motion-search inner loop.

    For each (dy, dx) in [0, num_dy) x [0, num_dx), computes
    ``sad(src, window[..., dy:dy+h, dx:dx+w])``.

    src:    (..., h, w) source block
    window: (..., h + num_dy - 1, w + num_dx - 1) search window from the
            reference frame; candidate (dy, dx) is the h x w slice at that
            offset.
    Returns (..., num_dy, num_dx) int32.

    This is the capability the reference leaves to its consumers: its 4-way
    multiref SAD (sad_a.asm:56-194) evaluates 4 horizontally-adjacent
    candidates per call; here the whole grid is one scan over dy with all dx
    candidates evaluated as a vectorised reduction per step, keeping peak
    memory at one row-band of candidates instead of the full grid.
    """
    h, w = src.shape[-2], src.shape[-1]
    assert window.shape[-2] >= h + num_dy - 1
    assert window.shape[-1] >= w + num_dx - 1
    src32 = src.astype(jnp.int32)[..., :, None, :]  # (..., h, 1, w)
    # (num_dx, w) gather indices: column x of candidate dx is window col dx+x.
    idx = jnp.arange(num_dx)[:, None] + jnp.arange(w)[None, :]

    def step(_, dy):
        rows = jax.lax.dynamic_slice_in_dim(window, dy, h, axis=-2)
        cand = jnp.take(rows, idx, axis=-1)  # (..., h, num_dx, w)
        d = jnp.abs(cand.astype(jnp.int32) - src32)
        return None, jnp.sum(d, axis=(-3, -1))  # (..., num_dx)

    _, out = jax.lax.scan(step, None, jnp.arange(num_dy))
    return jnp.moveaxis(out, 0, -2)  # (..., num_dy, num_dx)
