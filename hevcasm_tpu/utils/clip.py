"""Synthetic 4:2:0 test clips generated from a seed.

No footage ships with the repository, so the benchmark and the smoke test
generate their content: a multi-octave value-noise background, textured
moving objects, a global pan and film grain — natural-video-like statistics
for motion search, rather than pure noise or a pure pan.
"""

from __future__ import annotations

import numpy as np

from ..io import YuvArrays

__all__ = ["synthetic_clip"]


def synthetic_clip(seed: int, frames: int, height: int, width: int) -> list[YuvArrays]:
    """``frames`` 4:2:0 frames of ``height`` x ``width`` (even sizes) made
    from ``seed``; the same seed always gives the same clip."""
    rng = np.random.default_rng(seed)
    hh, ww = height + 64, width + 64
    bg = np.zeros((hh, ww), np.float32)
    for octave in (32, 64, 128, 256):
        g = rng.normal(0, 1, (hh // octave + 2, ww // octave + 2))
        bg += np.kron(g, np.ones((octave, octave)))[:hh, :ww] * octave
    bg = 128 + 70 * bg / np.abs(bg).max()
    size_hi = max(61, min(200, hh // 2, ww // 2))
    objs = [(rng.integers(0, hh - size_hi), rng.integers(0, ww - size_hi),
             rng.integers(min(60, size_hi - 1), size_hi), rng.integers(-6, 7),
             rng.integers(-6, 7), float(rng.integers(40, 220)))
            for _ in range(12)]
    tex = bg + rng.normal(0, 12, (hh, ww))
    out = []
    for t in range(frames):
        f = np.roll(tex, (2 * t, 3 * t), axis=(0, 1))
        for (oy, ox, sz, vy, vx, val) in objs:
            y0 = int(oy + vy * t) % (hh - sz)
            x0 = int(ox + vx * t) % (ww - sz)
            f[y0 : y0 + sz, x0 : x0 + sz] = (
                0.5 * f[y0 : y0 + sz, x0 : x0 + sz] + 0.5 * val)
        f = f + rng.normal(0, 2.0, (hh, ww))                  # film grain
        y = np.clip(f[:height, :width], 0, 255).astype(np.uint8)
        c = np.clip(f[: height // 2, : width // 2] * 0.5 + 64, 0, 255).astype(np.uint8)
        out.append(YuvArrays(y, c, 255 - c))
    return out
