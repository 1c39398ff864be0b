"""Timing utilities: the accelerator analogue of the reference's rdtsc
cycle counting (hevcasm.h:52-58) and converging averager
(hevcasm_test.c:40-107).

On an accelerator there is no rdtsc; we time jitted callables wall-clock with
block_until_ready after a compile+warmup call, using best-of-k which plays
the same role as the reference's restart-if-faster-sample convergence loop.
"""

from __future__ import annotations

import subprocess
import sys
import time
from typing import Callable

import jax


def time_fn(fn: Callable, *args, iters: int = 10, inner: int = 1, warmup: int = 2):
    """Best-of-``iters`` wall time of ``fn(*args)`` in seconds.

    inner > 1 amortises dispatch overhead by timing ``inner`` sequential
    calls (the role of hevcasm_test.c's f(bound, 4) batching at :53-55).
    """
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / inner
        best = min(best, dt)
    return best


def time_fn_converged(fn: Callable, *args, inner: int = 4,
                      window: float = 0.125, min_samples: int = 8,
                      max_samples: int = 200, warmup: int = 2):
    """The reference harness's converging averager (hevcasm_test.c:40-107)
    for wall time: keep sampling ``inner``-call batches, RESTART the
    accumulation whenever a sample beats the running minimum by more than
    ``window`` (the +-12.5% logic of :59-73), and return the mean of the
    samples inside the stability window once ``min_samples`` agree.

    Steadier than best-of-k for micro cases whose single-dispatch times
    are dominated by scheduling noise."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    lo = float("inf")
    acc, cnt, total = 0.0, 0, 0
    while total < max_samples:
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / inner
        total += 1
        if dt < lo * (1 - window):
            lo, acc, cnt = dt, dt, 1      # faster regime found: restart
            continue
        lo = min(lo, dt)
        if dt <= lo * (1 + window):
            acc += dt
            cnt += 1
            if cnt >= min_samples:
                break
    return acc / max(cnt, 1)


def require_gpu(tool: str, count: int = 1) -> None:
    """Exit with code 1 unless JAX sees ``count`` GPUs: times and traces
    are taken on the card only, never on a CPU fallback."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        print(f"{tool}: needs {count} GPU(s), JAX found {devices}", file=sys.stderr)
        raise SystemExit(1)


def card_label() -> str:
    """The cards' names and power limits, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints
    them (a child process that stays off JAX).  Every time is reported
    beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


def gbps(num_bytes: int, seconds: float) -> float:
    return num_bytes / seconds / 1e9


def gops(num_ops: int, seconds: float) -> float:
    return num_ops / seconds / 1e9
