"""Capture a JAX profiler trace of the 1080p P frame (default config).

Writes the trace under OUT_DIR (default chiprun_out/trace_frame in the
checkout; read the .xplane.pb with jax.profiler.ProfileData) to attribute
device time to the encode stages.  The content is the noise pan of
bench.py's noise_pan_p_frame_luma row.

Diagnostics only; needs a GPU and prints the card's name and power limit
first:  python tools/trace_frame.py [OUT_DIR]
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode.loop import encode_inter_frame
from hevcasm_tpu.utils.timing import card_label, require_gpu


def main():
    require_gpu("trace_frame")
    print(f"card: {card_label().splitlines()[0]}", flush=True)
    h, w = 1088, 1920
    cfg = EncodeConfig(search_range=32, qp=32)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (h + 64, w + 64), dtype=np.uint8)
    cur = jnp.asarray(base[2 : 2 + h, 3 : 3 + w])
    ref = jnp.asarray(base[:h, :w])

    @jax.jit
    def chain(c, r0):
        def f(_, r):
            return encode_inter_frame(c, r, cfg)["recon"]
        r = jax.lax.fori_loop(0, 20, f, r0)
        return jnp.sum(r.astype(jnp.uint32))

    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "chiprun_out", "trace_frame")
    int(chain(cur, ref))  # compile + warm
    with jax.profiler.trace(out_dir):
        int(chain(cur, ref))
    print(f"trace written to {out_dir}", flush=True)


if __name__ == "__main__":
    main()
