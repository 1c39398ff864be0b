"""CTU tiling: frame <-> (num_ctus, ctu, ctu) block stacks.

The reference operates on one block at a time and leaves frame traversal to
callers (SURVEY.md section 0); here the frame traversal IS the batch axis, so
every kernel call covers the whole frame.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["tile_frame", "untile_frame", "pad_frame", "grid_shape"]


def grid_shape(height: int, width: int, ctu: int) -> tuple[int, int]:
    assert height % ctu == 0 and width % ctu == 0, "pad frame to CTU multiple first"
    return height // ctu, width // ctu


def tile_frame(frame: jnp.ndarray, ctu: int) -> jnp.ndarray:
    """(..., H, W) -> (..., nRows*nCols, ctu, ctu), row-major CTU order."""
    h, w = frame.shape[-2], frame.shape[-1]
    gr, gc = grid_shape(h, w, ctu)
    lead = frame.shape[:-2]
    x = frame.reshape(*lead, gr, ctu, gc, ctu)
    x = jnp.swapaxes(x, -3, -2)  # (..., gr, gc, ctu, ctu)
    return x.reshape(*lead, gr * gc, ctu, ctu)


def untile_frame(blocks: jnp.ndarray, height: int, width: int) -> jnp.ndarray:
    """Inverse of tile_frame: (..., n, ctu, ctu) -> (..., H, W)."""
    ctu = blocks.shape[-1]
    gr, gc = grid_shape(height, width, ctu)
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, gr, gc, ctu, ctu)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, height, width)


def pad_frame(frame: jnp.ndarray, top: int, bottom: int, left: int, right: int) -> jnp.ndarray:
    """Edge-replicating pad over the trailing two axes (HEVC reference-frame
    boundary extension semantics)."""
    cfg = [(0, 0)] * (frame.ndim - 2) + [(top, bottom), (left, right)]
    return jnp.pad(frame, cfg, mode="edge")


def split_blocks(blocks: jnp.ndarray, sub: int) -> jnp.ndarray:
    """(..., n, N, N) -> (..., n * (N/sub)^2, sub, sub): split CTUs into TUs."""
    n_axis = blocks.shape[-3]
    big = blocks.shape[-1]
    k = big // sub
    lead = blocks.shape[:-3]
    x = blocks.reshape(*lead, n_axis, k, sub, k, sub)
    x = jnp.swapaxes(x, -3, -2)  # (..., n, k, k, sub, sub)
    return x.reshape(*lead, n_axis * k * k, sub, sub)


def merge_blocks(tus: jnp.ndarray, big: int) -> jnp.ndarray:
    """Inverse of split_blocks."""
    sub = tus.shape[-1]
    k = big // sub
    lead = tus.shape[:-3]
    n = tus.shape[-3] // (k * k)
    x = tus.reshape(*lead, n, k, k, sub, sub)
    x = jnp.swapaxes(x, -3, -2)
    return x.reshape(*lead, n, big, big)
