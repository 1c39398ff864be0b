"""Smoke test of the encoder on one GPU: the main path through its normal
entry points at 1080p, every stage compared bit-exactly with its REF tier.

    python chip_smoke.py [--seed N]     # one card, phases 1-4
    python chip_smoke.py --four-cards   # the multi-card phase only (4 cards)

Phases:
  1. header: JAX version, device kind, the card's name and power limit;
  2. ops at 1080p shapes (510 CTUs) vs REF: ssd_grid (+-32), quarter-pel
     refine, residual pipeline at TU 4/8/16/32, SATD, intra mode
     decision and all-mode prediction;
  3. main path on a generated 1920x1088 4:2:0 clip of 8 frames, written
     as Y4M and read back: closed-loop GOP, the CLI's ``encode --input``,
     the first P frame against the REF composition, a B frame, a PU
     decision frame and a rate-controlled GOP against their REF configs;
  4. first times (warm, ended by block_until_ready) and memory use.
  --four-cards: data-parallel GOP at 1080p and spatially sharded frame and
     closed-loop GOP at 3840x2176, each against the one-card encode.

The script refuses to run without a GPU and never falls back to the CPU.
Every failed phase makes it exit non-zero; the last line of a passing run
is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import statistics
import sys
import tempfile
import time
import traceback

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 4: 1080p (padded to whole CTUs) 4:2:0, GOP of 8, +-32, QP 32.
HEIGHT, WIDTH, FRAMES = 1088, 1920, 8
# BASELINE config 5 frame size for the sharded phase (2160 padded to CTUs).
HEIGHT_4K, WIDTH_4K = 2176, 3840


def log(msg: str) -> None:
    print(msg, flush=True)


class Mismatch(AssertionError):
    pass


def assert_same(name: str, got, want) -> None:
    """Zero-tolerance comparison: every output is an integer."""
    g, w = np.asarray(got), np.asarray(want)
    if g.shape != w.shape:
        raise Mismatch(f"{name}: shape {g.shape} != {w.shape}")
    if not np.array_equal(g, w):
        bad = int(np.sum(g != w))
        raise Mismatch(f"{name}: {bad} of {g.size} elements differ")


# ---------------------------------------------------------------------------
# Phase 2: ops at frame shapes vs REF


def check_ops(grid: tuple[int, int], seed: int) -> dict:
    """Each optimized op at the CTU count of a ``grid`` frame vs its REF."""
    from hevcasm_tpu import ops
    from hevcasm_tpu.encode import ctu as ctu_mod
    from hevcasm_tpu.encode.loop import (
        EncodeConfig, _intra_neighbours, _prepare_intra_refs)
    from hevcasm_tpu.kernels import intra_matrix, xla_opt
    from hevcasm_tpu.kernels.interp_xla import (
        refine_qpel_costmap_mxu, refine_quarter_pel_mxu)
    from hevcasm_tpu.ops.pred_inter import refine_qpel
    from hevcasm_tpu.ops.pred_intra import filter_flag, pred_intra
    from hevcasm_tpu.ops.residual import residual_pipeline

    rng = np.random.default_rng(seed)
    gr, gc = grid
    n = gr * gc
    src = jnp.asarray(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8))
    win = jnp.asarray(rng.integers(0, 256, (n, 128, 128), dtype=np.uint8))
    assert_same("ssd_grid +-32", xla_opt.ssd_grid(src, win, 65, 65),
                xla_opt.ssd_grid_ref(src, win, 65, 65))

    win71 = win[:, :71, :71]
    got, want = refine_quarter_pel_mxu(src, win71), refine_qpel(src, win71)
    for part, g, w in zip(("pred", "frac", "cost"), got, want):
        assert_same(f"refine_quarter_pel {part}", g, w)

    # The PU decision's cost maps, at its tile shapes: every 16x16 base tile
    # of the frame, and the 32x32 and 64x64 tiles of the coarser layouts.
    for t in (16, 32, 64):
        m = n * (64 // t) ** 2
        tiles = jnp.asarray(rng.integers(0, 256, (m, t, t), dtype=np.uint8))
        twin = jnp.asarray(rng.integers(0, 256, (m, t + 7, t + 7), dtype=np.uint8))
        assert_same(f"quarter-pel cost map {m} tiles of {t}x{t}",
                    refine_qpel_costmap_mxu(tiles, twin)[1], _costmap_ref(tiles, twin))

    pred = jnp.asarray(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8))
    for tu, intra in ((4, False), (8, False), (16, False), (32, False), (4, True)):
        cfg = EncodeConfig(tu=tu, qp=32)
        tr_type = 1 if intra else 0
        qp_args = (*cfg.quant_params(intra), *cfg.dequant_params())
        rec, nnz, cbf, _ = xla_opt.residual_pipeline_frame(
            src, pred, *qp_args, tu=tu, tr_type=tr_type)
        wrec, wnnz, wcbf = residual_pipeline(src, pred, *qp_args, tu=tu, tr_type=tr_type)
        label = f"residual tu={tu}{' DST' if intra else ''}"
        assert_same(f"{label} recon", rec, wrec)
        assert_same(f"{label} nnz", nnz, wnnz)
        assert_same(f"{label} cbf", cbf.reshape(-1), wcbf)

    a8 = ctu_mod.split_blocks(src, 8)
    b8 = ctu_mod.split_blocks(pred, 8)
    assert_same("satd 8x8", xla_opt.satd(a8, b8), ops.satd(a8, b8))

    # Intra at n = 32 on smooth content with real neighbour sets.
    frame = _smooth(rng, gr * 64, gc * 64)
    cfg = EncodeConfig()
    plain, filt = _prepare_intra_refs(*_intra_neighbours(frame, 32), 32, cfg)
    blocks = ctu_mod.tile_frame(frame, 32)
    ref_modes = jnp.stack(
        [pred_intra(m, *(filt if filter_flag(m, 32) else plain), 32,
                    filter_edge=False) for m in range(35)], axis=1)
    assert_same("intra all-mode prediction",
                intra_matrix.pred_intra_all_modes_mm(*plain, *filt, 32), ref_modes)
    pred_t, best, score = intra_matrix.intra_mode_decision_t(blocks, *plain, *filt, 32)
    want_best, want_score = _intra_decision_ref(blocks, plain, filt)
    assert_same("intra mode decision score", score, want_score)
    assert_same("intra mode decision mode", best, want_best)
    assert_same("intra mode decision pred",
                pred_t, jnp.take_along_axis(ref_modes, best[:, None, None, None], 1)[:, 0])
    return {"ctus": n, "intra_blocks": int(blocks.shape[0])}


def _costmap_ref(src, win):
    """The 16 fractions' costs by the REF route: jnp FIR accumulators and
    qpel_score, one fraction at a time."""
    from hevcasm_tpu.ops.pred_inter import _hv, qpel_score

    return jnp.stack([qpel_score(_hv(win, xf, yf, 8), src)
                      for yf in range(4) for xf in range(4)], axis=1)


def _smooth(rng, h, w):
    a = rng.integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(2):
        a = (np.roll(a, 1, 0) + a + np.roll(a, -1, 0)) / 3
        a = (np.roll(a, 1, 1) + a + np.roll(a, -1, 1)) / 3
    return jnp.asarray(np.clip(a, 0, 255).astype(np.uint8))


def _intra_decision_ref(blocks, plain, filt):
    """The Hadamard-domain mode score with one int32 matmul over the
    recombined weights, the Hadamard transform of the source on the host,
    and no int8 contraction: an independent route to the same integers."""
    from hevcasm_tpu.kernels.intra_matrix import mode_matrices_t
    from hevcasm_tpu.ops.satd import hadamard_matrix

    hi, lo, bias_t, shift_lane, src_scale, _ = mode_matrices_t(32)
    wt = jnp.asarray(hi.astype(np.int32) * 256 + lo.astype(np.int32))
    refs = jnp.concatenate(
        [plain[0], plain[1], plain[2][:, None], filt[0], filt[1], filt[2][:, None]],
        axis=-1).astype(jnp.int32) - 128
    acc = jnp.matmul(refs, wt, precision=jax.lax.Precision.HIGHEST,
                     preferred_element_type=jnp.int32) + jnp.asarray(bias_t)
    m = blocks.shape[0]
    h8 = hadamard_matrix(8).astype(np.int64)
    s = np.asarray(blocks).astype(np.int64).reshape(m, 4, 8, 4, 8)
    src_t = np.einsum("au,cv,mTuXv->mTXac", h8, h8, s).reshape(m, 1024)
    src_t = jnp.asarray(np.tile(src_t, (1, 35)).astype(np.int32))
    diff = jnp.abs(acc - src_t * jnp.asarray(src_scale))
    score = (diff >> jnp.asarray(shift_lane)).reshape(m, 35, 1024).sum(-1)
    return jnp.argmin(score, axis=-1).astype(jnp.int32), score


# ---------------------------------------------------------------------------
# Phase 3: the main path


def write_clip(path: str, seed: int, frames: int, height: int, width: int):
    """Generate the clip, write it as Y4M, and read it back through
    hevcasm_tpu.io as a YuvFrame of (T, H, W) stacks."""
    from hevcasm_tpu import io as hio
    from hevcasm_tpu.encode.video import YuvFrame
    from hevcasm_tpu.utils.clip import synthetic_clip

    hio.write_y4m(path, synthetic_clip(seed, frames, height, width), width, height)
    back = list(hio.iter_frames(path))
    if len(back) != frames:
        raise Mismatch(f"Y4M read back {len(back)} of {frames} frames")
    return YuvFrame(*(jnp.asarray(np.stack([getattr(f, p) for f in back]))
                      for p in ("y", "cb", "cr")))


def _frame(clip, t):
    from hevcasm_tpu.encode.video import YuvFrame

    return YuvFrame(clip.y[t], clip.cb[t], clip.cr[t])


def ref_configs(cfg):
    return dataclasses.replace(cfg, refine_impl="ref", residual_impl="ref")


@functools.partial(jax.jit, static_argnames=("cfg",))
def p_frame_ref(cur, ref, cfg):
    """The REF composition of one luma P frame: REF ssd_grid full search,
    jnp FIR quarter-pel refine, per-TU REF residual pipeline."""
    from hevcasm_tpu.encode import ctu as ctu_mod
    from hevcasm_tpu.encode import motion
    from hevcasm_tpu.kernels.xla_opt import ssd_grid_ref
    from hevcasm_tpu.ops.residual import residual_pipeline

    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src = ctu_mod.tile_frame(cur, cfg.ctu)
    r = cfg.search_range
    rp = ctu_mod.pad_frame(ref, r + motion.PAD_L, r + motion.PAD_R,
                           r + motion.PAD_L, r + motion.PAD_R)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    mv, best = motion.full_search(src, rp, pos, r, grid_fn=ssd_grid_ref, grid=(gr, gc))
    pred, mvq, _ = motion.refine_quarter_pel(src, rp, pos, mv, r)
    rec, nnz, _ = residual_pipeline(src, pred, *cfg.quant_params(False),
                                    *cfg.dequant_params(), tu=cfg.tu)
    return {"recon": ctu_mod.untile_frame(rec, h, w), "mvs": mvq, "sad": best, "nnz": nnz}


def check_gop(clip, cfg) -> dict:
    """Closed-loop GOP; its first P frame against the per-frame encoders
    and the REF composition (recon, MVs, nnz)."""
    from hevcasm_tpu.encode.loop import encode_inter_frame
    from hevcasm_tpu.encode.video import encode_gop_closed_loop_yuv, encode_inter_frame_yuv

    out = encode_gop_closed_loop_yuv(clip, cfg)
    psnr = np.asarray(out["psnr_y"])
    if psnr.shape != (clip.y.shape[0],) or not np.all(np.isfinite(psnr)):
        raise Mismatch(f"GOP psnr {psnr}")
    if out["recon"].y.shape != clip.y.shape:
        raise Mismatch(f"GOP recon shape {out['recon'].y.shape}")
    seed = _frame(out["recon"], 0)
    yuv = encode_inter_frame_yuv(_frame(clip, 1), seed, cfg)
    for plane in ("y", "cb", "cr"):
        assert_same(f"GOP frame 1 {plane} vs encode_inter_frame_yuv",
                    getattr(out["recon"], plane)[1], getattr(yuv["recon"], plane))
    got = encode_inter_frame(clip.y[1], seed.y, cfg)
    want = p_frame_ref(clip.y[1], seed.y, cfg)
    assert_same("P frame luma vs yuv", got["recon"], yuv["recon"].y)
    for key in ("recon", "mvs", "sad", "nnz"):
        assert_same(f"P frame {key} vs REF", got[key], want[key])
    return {"psnr_y": [round(float(p), 3) for p in psnr], "nnz_p1": int(got["nnz"])}


def check_cli(path: str, frames: int) -> dict:
    """``python -m hevcasm_tpu encode --input <clip>`` in this process."""
    from hevcasm_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["encode", "--input", path, "--frames", str(frames),
                       "--search-range", "32"])
    if rc != 0:
        raise Mismatch(f"cli encode exit {rc}")
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    if out["frames"] != frames or not 20.0 < out["psnr_y_db"] < 99.0:
        raise Mismatch(f"cli encode output {out}")
    return out


def check_b_frame(clip, cfg) -> dict:
    from hevcasm_tpu.encode.video import encode_b_frame_yuv

    args = (_frame(clip, 1), _frame(clip, 0), _frame(clip, 2))
    got = encode_b_frame_yuv(*args, cfg)
    want = encode_b_frame_yuv(*args, ref_configs(cfg))
    for plane in ("y", "cb", "cr"):
        assert_same(f"B frame {plane}", getattr(got["recon"], plane),
                    getattr(want["recon"], plane))
    for key in ("mvs0", "mvs1", "nnz"):
        assert_same(f"B frame {key}", got[key], want[key])
    return {"psnr_y": round(float(got["psnr_y"]), 3)}


def check_pu_decision(clip, cfg) -> dict:
    """The pruned PU decision through encode_inter_frame vs the refine-
    every-layout decision on REF grids, then the REF residual."""
    from hevcasm_tpu.encode.loop import encode_inter_frame

    cfg_pu = dataclasses.replace(cfg, pu_decision=True)
    got = encode_inter_frame(clip.y[1], clip.y[0], cfg_pu)
    want = pu_decision_ref(clip.y[1], clip.y[0], cfg_pu)
    for key in ("recon", "pu_layout", "sad", "nnz"):
        assert_same(f"PU decision {key}", got[key], want[key])
    return {"psnr_db": round(float(got["psnr_db"]), 3)}


@functools.partial(jax.jit, static_argnames=("cfg",))
def pu_decision_ref(cur, ref, cfg):
    """Every layout refined, then selected, on REF grids, then the REF
    residual.  Its cost maps come from the same cost-map op as the pruned
    path; check_ops holds that op to the REF route at these tile shapes."""
    from hevcasm_tpu.encode import ctu as ctu_mod
    from hevcasm_tpu.encode import motion, partition
    from hevcasm_tpu.kernels.xla_opt import ssd_grid_ref
    from hevcasm_tpu.ops.residual import residual_pipeline

    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src = ctu_mod.tile_frame(cur, cfg.ctu)
    r = cfg.search_range
    rp = ctu_mod.pad_frame(ref, r + motion.PAD_L, r + motion.PAD_R,
                           r + motion.PAD_L, r + motion.PAD_R)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    win = motion.extract_windows(rp, pos + motion.PAD_L, cfg.ctu + 2 * r)
    pred, choice, _, best64 = partition.select_pu_layout(
        src, rp, pos, win, r, partition.mv_lambda(cfg.qp), cfg.pu_layouts, ssd_grid_ref)
    rec, nnz, _ = residual_pipeline(src, pred, *cfg.quant_params(False),
                                    *cfg.dequant_params(), tu=cfg.tu)
    return {"recon": ctu_mod.untile_frame(rec, h, w), "pu_layout": choice,
            "sad": best64, "nnz": nnz}


def check_rate_control(clip, cfg) -> dict:
    from hevcasm_tpu.encode.rate import encode_gop_rate_controlled

    h, w = clip.y.shape[1:]
    target = 0.05 * h * w  # bits per frame
    got = encode_gop_rate_controlled(clip.y, target, cfg.qp, cfg)
    want = encode_gop_rate_controlled(clip.y, target, cfg.qp, ref_configs(cfg))
    for key in ("recon", "bits", "qp"):
        assert_same(f"rate-controlled GOP {key}", got[key], want[key])
    return {"qp": [int(q) for q in got["qp"]], "bits": [int(b) for b in got["bits"]]}


# ---------------------------------------------------------------------------
# Phase 4: first times


def time_ms(fn, *args, reps: int = 5) -> list[float]:
    """Warm wall times in ms, each call ended by block_until_ready."""
    jax.block_until_ready(fn(*args))
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def first_times(clip, cfg, label: str, reps: int = 5) -> dict:
    from hevcasm_tpu.encode import ctu as ctu_mod
    from hevcasm_tpu.encode import motion
    from hevcasm_tpu.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu.encode.loop import encode_inter_frame
    from hevcasm_tpu.encode.video import encode_b_frame_yuv, encode_inter_frame_yuv
    from hevcasm_tpu.kernels.xla_opt import ssd_grid

    cur, ref = clip.y[1], clip.y[0]
    r = cfg.search_range
    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src = ctu_mod.tile_frame(cur, cfg.ctu)
    rp = ctu_mod.pad_frame(ref, r + motion.PAD_L, r + motion.PAD_R,
                           r + motion.PAD_L, r + motion.PAD_R)
    win = motion.extract_windows(
        rp, motion.ctu_positions(gr, gc, cfg.ctu) + motion.PAD_L, cfg.ctu + 2 * r)
    num = 2 * r + 1
    cfg_pu = dataclasses.replace(cfg, pu_decision=True)
    cases = {
        "P frame luma": (encode_inter_frame, (cur, ref, cfg)),
        "P frame 4:2:0": (encode_inter_frame_yuv, (_frame(clip, 1), _frame(clip, 0), cfg)),
        "B frame 4:2:0": (encode_b_frame_yuv,
                          (_frame(clip, 1), _frame(clip, 0), _frame(clip, 2), cfg)),
        "I frame wavefront luma": (encode_intra_frame_wavefront, (clip.y[0], cfg)),
        "PU decision luma": (encode_inter_frame, (cur, ref, cfg_pu)),
        "ssd_grid alone": (ssd_grid, (src, win, num, num)),
    }
    result = {}
    for name, (fn, args) in cases.items():
        t = time_ms(fn, *args, reps=reps)
        result[name] = t
        log(f"[{label}] time {name}: median {statistics.median(t)} ms, "
            f"min {min(t)} ms over {len(t)} warm calls")
    share = statistics.median(result["ssd_grid alone"]) / statistics.median(
        result["P frame luma"])
    log(f"[{label}] ssd_grid share of the luma P frame: {share}")
    mem = encode_inter_frame.lower(cur, ref, cfg=cfg).compile().memory_analysis()
    if mem is not None:
        log(f"[{label}] P frame memory_analysis: "
            f"argument {mem.argument_size_in_bytes} B, output "
            f"{mem.output_size_in_bytes} B, temp {mem.temp_size_in_bytes} B, "
            f"code {mem.generated_code_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{label}] peak_bytes_in_use {stats.get('peak_bytes_in_use')}")
    return {"ms": result, "ssd_grid_share": share}


# ---------------------------------------------------------------------------
# Phase 5: four cards


def check_four_cards(seed: int, cfg, sizes=None) -> dict:
    """Data-parallel GOP at 1080p on mesh (frames=4, rows=1); spatially
    sharded frame and closed-loop GOP at 4K on mesh (frames=2, rows=2);
    each against the one-card encode of the same frames."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hevcasm_tpu.encode.loop import encode_inter_frame
    from hevcasm_tpu.encode.video import encode_gop_closed_loop
    from hevcasm_tpu.parallel import (
        encode_gop_closed_loop_spatial, encode_gop_data_parallel,
        encode_inter_frame_spatial, make_mesh)
    from hevcasm_tpu.utils.clip import synthetic_clip

    (h1, w1), (h4, w4) = sizes or ((HEIGHT, WIDTH), (HEIGHT_4K, WIDTH_4K))
    frames = jnp.asarray(np.stack([f.y for f in synthetic_clip(seed, 5, h1, w1)]))
    dp = encode_gop_data_parallel(frames, make_mesh(frames=4, rows=1), cfg)
    for t in range(1, 5):
        one = encode_inter_frame(frames[t], frames[t - 1], cfg)
        for key in ("recon", "mvs", "nnz"):
            assert_same(f"data-parallel frame {t} {key}", dp[key][t - 1], one[key])

    gop = jnp.asarray(np.stack([f.y for f in synthetic_clip(seed + 1, 3, h4, w4)]))
    mesh = make_mesh(frames=2, rows=2)
    sh = NamedSharding(mesh, P("rows", None))
    sp = encode_inter_frame_spatial(
        jax.device_put(gop[1], sh), jax.device_put(gop[0], sh), mesh, cfg)
    one = encode_inter_frame(gop[1], gop[0], cfg)
    for key in ("recon", "sad", "nnz"):
        assert_same(f"spatial frame {key}", sp[key], one[key])
    cl = encode_gop_closed_loop_spatial(gop, mesh, cfg)
    one = encode_gop_closed_loop(gop, cfg, gop.shape[0])
    assert_same("spatial closed-loop GOP recon", cl["recon"], one["recon"])
    return {"dp_frames": 4, "spatial_size": f"{w4}x{h4}",
            "closed_loop_psnr": [round(float(p), 3) for p in cl["psnr_db"]]}


# ---------------------------------------------------------------------------


class Phases:
    """Runs named phases; a failure is reported and remembered, and the
    remaining phases still run so one call shows every fault."""

    def __init__(self, label: str):
        self.label = label
        self.failed: list[str] = []

    def run(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            result = fn(*args, **kwargs)
        except Exception:  # noqa: BLE001 - report every phase's fault
            traceback.print_exc()
            self.failed.append(name)
            log(f"[{self.label}] FAIL {name} after {time.perf_counter() - t0:.1f} s")
            return None
        summary = json.dumps(result) if isinstance(result, dict) else type(result).__name__
        log(f"[{self.label}] ok {name} in {time.perf_counter() - t0:.1f} s: {summary}")
        return result


def _load_package():
    """Import the package from this script's own checkout, or fail."""
    sys.path.insert(0, ROOT)
    try:
        import hevcasm_tpu
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the hevcasm_tpu package is not beside "
                         f"this script ({e})")
    if os.path.dirname(os.path.dirname(os.path.abspath(hevcasm_tpu.__file__))) != ROOT:
        raise SystemExit("chip_smoke: hevcasm_tpu was imported from outside "
                         "this checkout")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the multi-card phase, on 4 cards")
    args = p.parse_args(argv)

    _load_package()
    devices = jax.devices()
    want = 4 if args.four_cards else 1
    if devices[0].platform != "gpu" or len(devices) < want:
        print(f"chip_smoke: needs {want} GPU(s), JAX found {devices}", file=sys.stderr)
        return 1
    from hevcasm_tpu.utils.timing import card_label

    label = card_label()
    first_card = label.splitlines()[0]
    log(f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
        f"{len(devices)} device(s)")
    log(f"nvidia-smi name, power.limit: {label}")

    from hevcasm_tpu.encode import EncodeConfig
    from hevcasm_tpu.utils.cache import enable_persistent_cache

    log(f"compilation cache: {enable_persistent_cache()}")
    cfg = EncodeConfig(search_range=32, qp=32)
    phases = Phases(first_card)
    if args.four_cards:
        phases.run("four cards vs one", check_four_cards, args.seed, cfg)
    else:
        phases.run("ops at 1080p vs REF", check_ops, (HEIGHT // 64, WIDTH // 64),
                   args.seed)
        with tempfile.TemporaryDirectory(dir=ROOT, prefix=".smoke_") as tmp:
            path = os.path.join(tmp, "clip.y4m")
            clip = phases.run("Y4M clip write/read", write_clip, path, args.seed,
                              FRAMES, HEIGHT, WIDTH)
            if clip is not None:
                phases.run("closed-loop GOP + P frame vs REF", check_gop, clip, cfg)
                phases.run("CLI encode --input", check_cli, path, FRAMES)
                phases.run("B frame vs REF config", check_b_frame, clip, cfg)
                phases.run("PU decision vs REF", check_pu_decision, clip, cfg)
                phases.run("rate-controlled GOP vs REF config",
                           check_rate_control, clip, cfg)
                phases.run("first times", first_times, clip, cfg, first_card)
    if phases.failed:
        print(f"chip_smoke: failed phases: {phases.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
