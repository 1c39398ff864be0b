"""Benchmark: 1080p encode rows on one GPU, one process.

Each row compiles and warms its program, then times a steady window of
back-to-back calls ended by block_until_ready, and prints one JSON line
naming the platform, device kind, device count, and the card's name and
power limit.  The headline row (1080p luma P frame, CTUs per second) is
the last line.  A run without a GPU fails; it never falls back to the CPU.

    python bench.py
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 1088, 1920  # 1080p padded to whole CTUs: 17 x 30 = 510 CTUs
CTUS = (H // 64) * (W // 64)
ITERS = 20  # calls per steady window; the slow rows use fewer


def card() -> dict:
    from hevcasm_tpu.utils.timing import card_label

    name, limit = card_label().splitlines()[0].split(", ")
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()), "card": name, "power_limit": limit}


def steady_ms(fn, *args, iters: int) -> tuple[float, float]:
    """(first call incl. compile in s, steady ms per call)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / iters * 1e3


def main() -> int:
    sys.path.insert(0, ROOT)
    from hevcasm_tpu import io as hio
    from hevcasm_tpu.encode import EncodeConfig
    from hevcasm_tpu.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu.encode.loop import encode_inter_frame
    from hevcasm_tpu.encode.video import (
        YuvFrame, encode_b_frame_yuv, encode_inter_frame_yuv)
    from hevcasm_tpu.utils.cache import enable_persistent_cache
    from hevcasm_tpu.utils.clip import synthetic_clip
    from hevcasm_tpu.utils.timing import require_gpu

    require_gpu("bench")
    enable_persistent_cache()
    dev = card()
    cfg = EncodeConfig(search_range=32, qp=32)

    def row(name, fn, *fargs, iters=ITERS, **extra):
        first, ms = steady_ms(fn, *fargs, iters=iters)
        rec = {"row": name, **dev, "ms_per_frame": ms,
               "ctus_per_sec": CTUS / ms * 1e3, "first_call_s": first,
               "iters": iters, **extra}
        print(json.dumps(rec), flush=True)
        return rec

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as tmp:
        path = os.path.join(tmp, "clip.y4m")
        hio.write_y4m(path, synthetic_clip(7, 3, H, W), W, H)
        clip = [YuvFrame(*(jnp.asarray(getattr(f, k)) for k in ("y", "cb", "cr")))
                for f in hio.iter_frames(path)]
    f0, f1, f2 = clip
    psnr = float(encode_inter_frame(f1.y, f0.y, cfg)["psnr_db"])
    row("y4m_clip_p_frame_yuv420", encode_inter_frame_yuv, f1, f0, cfg)
    row("y4m_clip_b_frame_yuv420", encode_b_frame_yuv, f1, f0, f2, cfg)
    row("y4m_clip_pu_decision_luma", encode_inter_frame, f1.y, f0.y,
        EncodeConfig(search_range=32, qp=32, pu_decision=True), iters=5)
    row("y4m_clip_intra_wavefront_luma", encode_intra_frame_wavefront, f0.y, cfg,
        iters=5)

    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H + 64, W + 64), dtype=np.uint8)
    cur, ref = jnp.asarray(base[2 : 2 + H, 3 : 3 + W]), jnp.asarray(base[:H, :W])
    row("noise_pan_p_frame_luma", encode_inter_frame, cur, ref, cfg)
    row("1080p_ctus_per_sec_p_frame_luma", encode_inter_frame, f1.y, f0.y, cfg,
        psnr_db=psnr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
