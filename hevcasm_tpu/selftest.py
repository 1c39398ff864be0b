"""Self-test + micro-benchmark driver: the analogue of hevcasm_main
(/root/reference/src/lib/hevcasm.c:152-186) and the generic harness
hevcasm_test (/root/reference/src/lib/hevcasm_test.c:110-137).

For every kernel suite, for every shape in its sweep, the REF tier produces
the golden output; every other enabled tier is run on the same fixtures,
compared bit-exactly, and timed.  Prints per-line results in the style of the
reference ("TIER:time(xSpeedup)", "-MISMATCH") and returns the total error
count (the reference's process exit code, hevcasm.c:183-185).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import jax

from . import registry
from .config import Tier
from .utils.timing import time_fn, time_fn_converged

_SEED = 0x48455643


@dataclasses.dataclass
class Case:
    """One (shape, args) instance of a suite: fixture arrays + call args."""

    name: str
    args: tuple
    iters: int = 10


@dataclasses.dataclass
class Suite:
    """A kernel family: op name + sweep of cases (cf. hevcasm_test_sad).

    ``op_alias`` lets several suites (e.g. the micro sweep and the
    frame-batched timing sweep) share one registry op; ``name`` is what the
    --suites filter matches."""

    name: str
    cases: Callable[[np.random.Generator], Sequence[Case]]
    op_alias: str | None = None

    @property
    def op(self) -> str:
        return self.op_alias or self.name


def _as_np(out):
    return [np.asarray(o) for o in jax.tree.leaves(out)]


def run_suite(
    suite: Suite,
    mask: Tier = Tier.ALL,
    verbose: bool = True,
    time_it: bool = True,
    records: list | None = None,
    converged: bool = False,
) -> int:
    errors = 0
    rng = np.random.default_rng(_SEED)
    ref_fn = registry.get_tier(suite.op, Tier.REF)
    if ref_fn is None:
        if verbose:
            print(f"{suite.op}: no REF tier registered", flush=True)
        return 1
    if verbose:
        print(f"\n{suite.op}", flush=True)
    for case in suite.cases(rng):
        golden = _as_np(ref_fn(*case.args))
        line = f"  {case.name}: "
        t_ref = None
        for tier in (Tier.REF, Tier.JIT):
            if not (mask & tier):
                continue
            fn = registry.get_tier(suite.op, tier)
            if fn is None:
                continue
            rec = {"op": suite.op, "case": case.name, "tier": tier.name}
            try:
                out = _as_np(fn(*case.args))
            except NotImplementedError:
                # A tier may legitimately not cover a geometry (the
                # reference's tables also leave slots at the C fallback).
                continue
            except Exception as e:  # noqa: BLE001 - report, count, continue
                line += f"{tier.name}:ERROR({type(e).__name__}) "
                errors += 1
                rec["error"] = type(e).__name__
                if records is not None:
                    records.append(rec)
                continue
            mismatch = any(
                not np.array_equal(a, b) for a, b in zip(golden, out)
            ) or len(golden) != len(out)
            rec["match"] = not mismatch
            if time_it:
                if converged:
                    t = time_fn_converged(fn, *case.args)
                else:
                    t = time_fn(fn, *case.args, iters=case.iters)
                if tier is Tier.REF:
                    t_ref = t
                speed = f"(x{t_ref / t:.2f})" if (t_ref and t > 0) else ""
                line += f"{tier.name}:{t * 1e6:.0f}us{speed} "
                rec["time_us"] = round(t * 1e6, 1)
                if t_ref and t > 0:
                    rec["speedup_vs_ref"] = round(t_ref / t, 2)
            else:
                line += f"{tier.name}:ok "
            if mismatch:
                line += "-MISMATCH "
                errors += 1
            if records is not None:
                records.append(rec)
        if verbose:
            print(line, flush=True)
    return errors


# ---------------------------------------------------------------------------
# Suite definitions: fixtures mirror the reference's test functions.

PARTITIONS = [  # sad.c:231-240
    (64, 64), (64, 48), (64, 32), (64, 16), (48, 64),
    (32, 64), (32, 32), (32, 24), (32, 16), (32, 8), (24, 32),
    (16, 64), (16, 32), (16, 16), (16, 12), (16, 8), (16, 4), (12, 16),
    (8, 32), (8, 16), (8, 8), (8, 4), (4, 8),
]


def _sad_cases(rng):
    src = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    ref = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    return [
        Case(f"{w}x{h}", (src[:h, :w], ref[1 : 1 + h, 1 : 1 + w]))
        for (w, h) in PARTITIONS
    ]


def _sad_multiref_cases(rng):
    src = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    ref = rng.integers(0, 256, (4, 128, 128), dtype=np.uint8)
    return [
        Case(f"4-way {w}x{h}", (src[:h, :w], ref[:, : h, : w]))
        for (w, h) in PARTITIONS
    ]


def _sad_grid_cases(rng):
    cases = []
    for (w, h, r) in [(64, 64, 8), (32, 32, 16)]:
        src = rng.integers(0, 256, (h, w), dtype=np.uint8)
        win = rng.integers(0, 256, (h + 2 * r, w + 2 * r), dtype=np.uint8)
        cases.append(Case(f"{w}x{h} +-{r}", (src, win, 2 * r + 1, 2 * r + 1)))
    return cases


def _ssd_grid_cases(rng):
    cases = []
    for (b, r) in [(64, 8), (32, 16)]:
        src = rng.integers(0, 256, (4, b, b), dtype=np.uint8)
        win = rng.integers(0, 256, (4, b + 2 * r, b + 2 * r), dtype=np.uint8)
        cases.append(Case(f"4x {b}x{b} +-{r}", (src, win, 2 * r + 1, 2 * r + 1)))
    return cases


def _ssd_cases(rng):
    a = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    b = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    return [Case(f"{n}x{n}", (a[:n, :n], b[:n, :n])) for n in (4, 8, 16, 32, 64)]


def _ssd_linear_cases(rng):
    a = rng.integers(0, 256, (0x200,), dtype=np.uint8)
    b = rng.integers(0, 256, (0x200,), dtype=np.uint8)
    return [Case("0x200", (a, b))]


def _satd_cases(rng):
    cases = []
    for n in (8, 4, 2):
        a = rng.integers(0, 256, (n, n), dtype=np.uint8)
        b = rng.integers(0, 256, (n, n), dtype=np.uint8)
        cases.append(Case(f"{n}x{n}", (a, b)))
    return cases


def _quantize_cases(rng):
    cases = []
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        src = rng.integers(-32768, 32768, (n, n)).astype(np.int16)
        cases.append(Case(f"{n}x{n}", (src, 51, 20, 14)))
    return cases


def _quantize_inverse_cases(rng):
    cases = []
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        src = (rng.integers(0, 256, (n, n)) - 0x100).astype(np.int16)
        cases.append(Case(f"{n}x{n}", (src, 51, 14)))
    return cases


def _reconstruct_cases(rng):
    cases = []
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        pred = rng.integers(0, 256, (n, n), dtype=np.uint8)
        res = (rng.integers(0, 0x200, (n, n)) - 0x100).astype(np.int16)
        cases.append(Case(f"{n}x{n}", (pred, res)))
    return cases


def _transform_cases(rng):
    cases = []
    for j, (n, tr) in enumerate([(4, 1), (4, 0), (8, 0), (16, 0), (32, 0)]):
        src = (rng.integers(0, 0x200, (n, n)) - 0x100).astype(np.int16)
        cases.append(Case(f"{'sine' if tr else 'cosine'} {n}x{n}", (src, tr)))
    return cases


def _inverse_transform_add_cases(rng):
    cases = []
    for (n, tr) in [(4, 1), (4, 0), (8, 0), (16, 0), (32, 0)]:
        coeffs = rng.integers(0, 0x10000, (n, n)).astype(np.uint16).astype(np.int16)
        pred = rng.integers(0, 256, (n, n), dtype=np.uint8)
        cases.append(Case(f"{'sine' if tr else 'cosine'} {n}x{n}", (coeffs, pred, tr)))
    return cases


def _pred_uni_cases(rng):
    cases = []
    for taps in (8, 4):
        for (w, h) in [(64, 64), (32, 16), (16, 16), (8, 4)]:
            w, h = w * taps // 8, h * taps // 8
            win = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
            for (xf, yf) in [(0, 0), (1, 0), (0, 1), (2, 3)]:
                cases.append(
                    Case(f"{taps}tap {w}x{h} ({xf},{yf})", (win, xf, yf, taps))
                )
    return cases


def _pred_bi_cases(rng):
    cases = []
    for taps in (8, 4):
        w = h = 32 * taps // 8
        w0 = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
        w1 = rng.integers(0, 256, (h + taps - 1, w + taps - 1), dtype=np.uint8)
        for fr in [(0, 0, 0, 0), (1, 2, 3, 1)]:
            cases.append(Case(f"{taps}tap {w}x{h} {fr}", (w0, w1, *fr, taps)))
    return cases


def _pred_intra_cases(rng):
    cases = []
    for n in (4, 8, 16, 32):
        left = rng.integers(0, 256, (2 * n,), dtype=np.uint8)
        above = rng.integers(0, 256, (2 * n,), dtype=np.uint8)
        corner = np.uint8(rng.integers(0, 256))
        for mode in (0, 1, 10, 26, 2, 18, 34, 23):
            cases.append(Case(f"mode{mode} {n}x{n}", (mode, left, above, corner, n)))
    return cases


# Frame-scale batch: the 1080p CTU count (510), so timed suites measure
# converged production-shaped work, not dispatch overhead (the reference
# times 100k-iteration hot loops, hevcasm_test.c:40-107).
FRAME_CTUS = 510


def _sad_grid_frame_cases(rng):
    src = rng.integers(0, 256, (FRAME_CTUS, 64, 64), dtype=np.uint8)
    win = rng.integers(0, 256, (FRAME_CTUS, 128, 128), dtype=np.uint8)
    return [Case(f"{FRAME_CTUS}x 64x64 +-32 (1080p)", (src, win, 65, 65), iters=4)]


def _ssd_grid_frame_cases(rng):
    src = rng.integers(0, 256, (FRAME_CTUS, 64, 64), dtype=np.uint8)
    win = rng.integers(0, 256, (FRAME_CTUS, 128, 128), dtype=np.uint8)
    return [Case(f"{FRAME_CTUS}x 64x64 +-32 (1080p)", (src, win, 65, 65), iters=4)]


def _refine_qpel_cases(rng):
    cases = []
    for n, name, iters in [(8, "8x 64x64", 10), (FRAME_CTUS, f"{FRAME_CTUS}x 64x64 (1080p)", 4)]:
        src = rng.integers(0, 256, (n, 64, 64), dtype=np.uint8)
        win = rng.integers(0, 256, (n, 71, 71), dtype=np.uint8)
        cases.append(Case(name, (src, win), iters=iters))
    return cases


def _residual_pipeline_cases(rng):
    cases = []
    for n, name, iters in [(8, "8x 64x64", 10), (FRAME_CTUS, f"{FRAME_CTUS}x 64x64 (1080p)", 4)]:
        src = rng.integers(0, 256, (n, 64, 64), dtype=np.uint8)
        pred = rng.integers(0, 256, (n, 64, 64), dtype=np.uint8)
        # qp=32 parameters (encode/loop.py quant_params/dequant_params).
        cases.append(Case(name, (src, pred, 20560, 23, 10880, 1632, 2), iters=iters))
    return cases


SUITES = [
    Suite("sad_multiref", _sad_multiref_cases),
    Suite("sad", _sad_cases),
    Suite("sad_grid", _sad_grid_cases),
    Suite("ssd_grid", _ssd_grid_cases),
    Suite("ssd", _ssd_cases),
    Suite("ssd_linear", _ssd_linear_cases),
    Suite("pred_intra", _pred_intra_cases),
    Suite("satd", _satd_cases),
    Suite("quantize_inverse", _quantize_inverse_cases),
    Suite("quantize", _quantize_cases),
    Suite("reconstruct", _reconstruct_cases),
    Suite("pred_uni", _pred_uni_cases),
    Suite("pred_bi", _pred_bi_cases),
    Suite("inverse_transform_add", _inverse_transform_add_cases),
    Suite("forward_transform", _transform_cases),
    Suite("sad_grid_frame", _sad_grid_frame_cases, op_alias="sad_grid"),
    Suite("ssd_grid_frame", _ssd_grid_frame_cases, op_alias="ssd_grid"),
    Suite("refine_qpel", _refine_qpel_cases),
    Suite("residual_pipeline", _residual_pipeline_cases),
]


def main(
    mask: Tier = Tier.ALL,
    time_it: bool = True,
    suites: list[str] | None = None,
    json_path: str | None = None,
    converged: bool = False,
) -> int:
    """Run all (or the named) suites, order mirroring hevcasm.c:169-180;
    returns the total error count.  ``json_path`` writes structured
    per-(op, case, tier) results (SURVEY.md section 5 metrics row);
    "-" writes them to stdout.  ``converged`` times with the reference
    harness's converging averager (hevcasm_test.c:40-107 semantics,
    utils.timing.time_fn_converged) instead of best-of-k — steadier for
    the dispatch-noise-dominated micro cases."""
    print(f"hevcasm_tpu self test (devices: {jax.devices()})", flush=True)
    errors = 0
    records: list = []
    for suite in SUITES:
        if suites and suite.name not in suites and suite.op not in suites:
            continue
        errors += run_suite(suite, mask, time_it=time_it, records=records,
                            converged=converged)
    print(f"\n{errors} errors" if errors else "\nself test passed", flush=True)
    if json_path:
        import json as _json

        payload = _json.dumps({"errors": errors, "results": records}, indent=1)
        if json_path == "-":
            print(payload, flush=True)
        else:
            with open(json_path, "w") as f:
                f.write(payload + "\n")
    return errors


if __name__ == "__main__":
    raise SystemExit(main())
