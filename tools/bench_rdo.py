"""Cost/benefit of the variable-block-structure modes at 1080p on the
current backend: frame time and PSNR for fixed-PU/TU vs per-CTU PU decision
vs per-CTU TU selection.  Diagnostics only (bench.py stays on the fixed
path; this tool quantifies what the decisions buy).  Needs a GPU; prints
the card's name and power limit first, and exits non-zero if any variant
fails:  python tools/bench_rdo.py"""

from __future__ import annotations

import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import jax
    import jax.numpy as jnp

    from hevcasm_tpu.utils.cache import enable_persistent_cache
    from hevcasm_tpu.utils.timing import card_label, require_gpu

    require_gpu("bench_rdo")
    print(f"card: {card_label().splitlines()[0]}", flush=True)
    enable_persistent_cache()

    from hevcasm_tpu.encode import EncodeConfig
    from hevcasm_tpu.encode.loop import encode_inter_frame

    h, w = 1088, 1920
    rng = np.random.default_rng(0)
    # Panning content with a divergent-motion band so sub-CTU PUs matter.
    base = rng.integers(0, 256, (h + 128, w + 128), dtype=np.uint8)
    smooth = base.astype(np.float32)
    for _ in range(2):
        smooth = (np.roll(smooth, 1, 0) + smooth + np.roll(smooth, -1, 0)) / 3
        smooth = (np.roll(smooth, 1, 1) + smooth + np.roll(smooth, -1, 1)) / 3
    base = np.clip(smooth, 0, 255).astype(np.uint8)
    ref = base[32 : 32 + h, 32 : 32 + w]
    cur = np.empty_like(ref)
    cur[: h // 2] = base[32 + 3 : 32 + 3 + h // 2, 32 + 2 : 32 + 2 + w]
    cur[h // 2 :] = base[32 - 5 + h // 2 : 32 - 5 + h, 32 - 7 : 32 - 7 + w]
    cur, ref = jnp.asarray(cur), jnp.asarray(ref)

    def timed(cfg, iters=10):
        """Warm ms per frame over back-to-back calls ended by
        block_until_ready."""
        jax.block_until_ready(encode_inter_frame(cur, ref, cfg))
        t0 = time.perf_counter()
        for _ in range(iters):
            out = encode_inter_frame(cur, ref, cfg)
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / iters

    all_layouts = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter", "eighth")
    variants = {
        "fixed": EncodeConfig(search_range=32, qp=32),
        "pu_decision": EncodeConfig(search_range=32, qp=32, pu_decision=True),
        "pu_amp+8x8": EncodeConfig(search_range=32, qp=32, pu_decision=True,
                                   pu_layouts=all_layouts),
        "tu_select": EncodeConfig(search_range=32, qp=32, tu_sizes=(4, 8, 16, 32)),
        "pu+tu": EncodeConfig(search_range=32, qp=32, pu_decision=True,
                              tu_sizes=(4, 8, 16, 32)),
    }
    failed = []
    for name, cfg in variants.items():
        try:
            out = encode_inter_frame(cur, ref, cfg)
            p = float(out["psnr_db"])
            t = timed(cfg)
            extra = ""
            if "pu_layout" in out:
                lv = np.asarray(out["pu_layout"])
                extra = "  layouts " + "/".join(cfg.pu_layouts) + ": " + "/".join(
                    str(int(np.sum(lv == k))) for k in range(len(cfg.pu_layouts)))
            if "tu_choice" in out:
                ch = np.asarray(out["tu_choice"])
                extra += "  tu counts: " + "/".join(
                    str(int(np.sum(ch == k))) for k in range(4))
            print(f"{name:18s} {t*1e3:7.2f} ms/frame  psnr {p:6.2f} dB{extra}",
                  flush=True)
        except Exception:  # noqa: BLE001 - report every variant, then fail
            traceback.print_exc()
            print(f"{name:18s} FAILED", flush=True)
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
