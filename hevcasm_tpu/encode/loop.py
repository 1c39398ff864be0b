"""The encode inner loop: motion search + interpolation + transform +
quantization + reconstruction, fully batched per frame.

This composes the kernel families the way a client encoder composes the
reference's populate/get tables (SURVEY.md sections 3.2-3.4), as one jitted
program per frame:

  inter frame:  full-search ME -> quarter-pel refine -> predict -> residual
                -> 8x8 DCT -> quantize -> dequantize -> IDCT+add -> recon
  intra frame:  35-mode batched intra prediction at 32x32 -> SATD mode
                decision -> same TU pipeline

Quantizer parameters follow the HM/HEVC convention for 8-bit video:
  forward:  scale = QUANT_SCALES[qp%6],  shift = 21 + qp//6 - log2(TU),
            offset such that added rounding = (85 or 171) << (shift - 9)
  inverse:  scale = DEQUANT_SCALES[qp%6] << (qp//6), shift = log2(TU) - 1
which satisfy the reference's asserted ranges (quantize.c:162-165).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from ..ops.satd import satd as _satd
from ..ops.pred_intra import pred_intra
from ..utils.psnr import psnr
from . import ctu as ctu_mod
from . import motion

__all__ = ["EncodeConfig", "encode_inter_frame", "encode_intra_frame", "encode_gop"]

QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)
DEQUANT_SCALES = (40, 45, 51, 57, 64, 72)


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    ctu: int = 64
    tu: int = 8           # transform unit size for the residual pipeline
    intra_block: int = 32  # intra prediction block size
    search_range: int = 32
    qp: int = 32
    # Motion-search scoring metric: "ssd" is exact integer SSD scored as
    # batched correlation matmuls (kernels/xla_opt.ssd_grid), "sad" the
    # reference-faithful |a-b| path.  On x86 SAD is the cheap metric
    # (psadbw); with matrix units SSD is — and it is the better distortion
    # proxy.
    me_metric: str = "ssd"
    # "full" = exhaustive +-R grid; "pyramid" = 2-level hierarchical search
    # covering the same window at ~1/60 the arithmetic (motion.pyramid_search).
    me_strategy: str = "full"
    # Quarter-pel refinement implementation: "xla" (banded-matrix matmul
    # FIRs, kernels/interp_xla.py), "ref" (jnp FIRs).  Bit-identical.
    refine_impl: str = "xla"
    # Residual pipeline implementation: "xla" (whole-frame block-diagonal
    # matmuls, kernels/xla_opt.residual_pipeline_frame), "ref" (per-TU
    # composition of the REF ops).  Bit-identical.
    residual_impl: str = "xla"
    # Intra prediction source: "open_loop" predicts from original-frame
    # neighbours (all blocks parallel); "wavefront" predicts from
    # reconstructed neighbours with the WPP 2r+c wave schedule
    # (encode/intra_wavefront.py), the conforming-encoder behaviour.
    intra_mode: str = "open_loop"
    # Apply the 32x32 strong (bilinear) reference-sample smoothing when the
    # flatness condition holds (H.265 8.4.4.2.3, sps strong_intra_smoothing
    # — HM default on).
    strong_intra_smoothing: bool = True
    # Per-CTU PU-layout decision (encode/partition.py): ONE base-
    # granularity search + integral-image aggregation gives the exact SSD
    # grid of every rectangular PU; each PU refines with its own MV (one
    # qpel fraction per PU); the layout minimising SSD + lambda*numPU wins.
    pu_decision: bool = False
    # Candidate layouts (keys of partition.PU_LAYOUTS): square levels
    # 2Nx2N/NxN/quarter(16x16)/eighth(8x8) and the rectangular 2NxN/Nx2N
    # splits.  Adding "eighth" drops the search granularity to 8x8.
    pu_layouts: tuple = ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter")
    # Per-CTU TU-size selection: run the residual pipeline at each listed
    # size and pick by distortion + lambda*nnz.  () = fixed cfg.tu.
    tu_sizes: tuple = ()

    def __post_init__(self):
        # Typos in impl strings must fail loudly, not silently select a
        # slower path.
        _check = {
            "me_metric": ("sad", "ssd"),
            "me_strategy": ("full", "pyramid"),
            "refine_impl": ("xla", "ref"),
            "residual_impl": ("xla", "ref"),
            "intra_mode": ("open_loop", "wavefront"),
        }
        for field, valid in _check.items():
            v = getattr(self, field)
            if v not in valid:
                raise ValueError(f"{field}={v!r} (valid: {', '.join(valid)})")
        from .partition import PU_LAYOUTS

        for name in self.pu_layouts:
            if name not in PU_LAYOUTS:
                raise ValueError(
                    f"pu_layouts entry {name!r} (valid: {', '.join(PU_LAYOUTS)})"
                )

    @property
    def tu_log2(self) -> int:
        return self.tu.bit_length() - 1

    def quant_params(self, intra: bool = False):
        qp = self.qp
        shift = 21 + qp // 6 - self.tu_log2
        offset = (171 if intra else 85) << 7  # == x << (shift-9-(shift-16))
        scale = QUANT_SCALES[qp % 6]
        return scale, shift, offset

    def dequant_params(self):
        # level = C * f * 2^-(21 + per - log2N) and f*g ~= 2^20, so recovering
        # d ~= C needs shift = log2N - 1 with scale g << per.  (Verified by
        # the near-lossless qp=4 round-trip test.)
        qp = self.qp
        scale = DEQUANT_SCALES[qp % 6] << (qp // 6)
        shift = self.tu_log2 - 1
        return scale, shift


def _integer_search(src_ctus, ref, ref_padded, pos, cfg: EncodeConfig, grid):
    """The integer-pel ME stage behind every inter path: full or pyramid
    per cfg.  Returns (mv_int (n, 2), best (n,))."""
    r = cfg.search_range
    grid_fn = motion.grid_metric_fn(cfg.me_metric)
    if cfg.me_strategy == "pyramid":
        return motion.pyramid_search(
            src_ctus, ref, ref_padded, pos, r, grid_fn=grid_fn, grid=grid
        )
    return motion.full_search(src_ctus, ref_padded, pos, r, grid_fn=grid_fn, grid=grid)


def _refine_fn(cfg: EncodeConfig):
    """The cfg-selected quarter-pel refinement over gathered (B+7)^2
    windows: (src_ctus, win) -> (pred, frac_idx, cost)."""
    if cfg.refine_impl == "xla":
        from ..kernels.interp_xla import refine_quarter_pel_mxu

        return refine_quarter_pel_mxu
    from ..ops.pred_inter import refine_qpel

    return refine_qpel


def _residual_pipeline(src_blocks, pred_blocks, cfg: EncodeConfig, intra: bool, luma: bool = True):
    """residual -> TU transform -> quant -> dequant -> inverse+add -> recon.

    src/pred: (n, B, B) uint8.  Returns (recon_blocks (n, B, B) uint8,
    num_nonzero () int32, cbf (n*(B/tu)^2,) bool flat per-TU coded-block
    flags in ctu.split_blocks order) — the same shapes from every impl.
    """
    # HEVC uses the DST-VII for 4x4 intra luma TUs (residual_decode.c:914);
    # chroma always uses the DCT.
    tr_type = 1 if (intra and luma and cfg.tu == 4) else 0
    scale, shift, offset = cfg.quant_params(intra)
    dscale, dshift = cfg.dequant_params()

    if cfg.residual_impl == "xla":
        from ..kernels.xla_opt import residual_pipeline_frame

        rec, nnz, cbf, _ = residual_pipeline_frame(
            src_blocks, pred_blocks, scale, shift, offset, dscale, dshift,
            tu=cfg.tu, tr_type=tr_type,
        )
        return rec, nnz, cbf.reshape(-1)

    from ..ops.residual import residual_pipeline

    return residual_pipeline(
        src_blocks, pred_blocks, scale, shift, offset, dscale, dshift,
        tu=cfg.tu, tr_type=tr_type,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_inter_frame(cur: jnp.ndarray, ref: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()):
    """Encode one inter (P) frame against a reference plane.

    cur, ref: (H, W) uint8, H/W multiples of cfg.ctu.
    Returns dict with recon (H, W) uint8, mvs (n, 2) quarter-pel, psnr_db,
    nnz (coded-coefficient count), sad (best integer SAD per CTU).
    """
    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu)
    r = cfg.search_range
    ref_padded = ctu_mod.pad_frame(ref, r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)

    grid_fn = motion.grid_metric_fn(cfg.me_metric)
    if cfg.pu_decision:
        # Variable PU structure: one base-granularity search, exact
        # integral-grid aggregation to every (incl. rectangular) layout,
        # per-PU MVs + one qpel fraction per PU, layout chosen by cost.
        from . import partition

        size = cfg.ctu + 2 * r
        if size % cfg.ctu == 0:
            win = motion.extract_aligned_windows(
                ref_padded, (motion.PAD_L, motion.PAD_L), (gr, gc), cfg.ctu, size
            )
        else:
            win = motion.extract_windows(ref_padded, pos + motion.PAD_L, size)
        lam = partition.mv_lambda(cfg.qp)
        pred, choice, mv_tiles, best_sad = partition.select_pu_layout_pruned(
            src_ctus, ref_padded, pos, win, r, lam, cfg.pu_layouts, grid_fn,
        )
        # Frame-level "mvs" report: the chosen layout's top-left tile MV.
        mv_qpel = mv_tiles[:, 0, 0, :]
        if cfg.tu_sizes:
            rec_ctus, tu_choice, nnz = partition.select_tu_recon(
                src_ctus, pred, cfg, cfg.tu_sizes
            )
        else:
            rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False)
        recon = ctu_mod.untile_frame(rec_ctus, h, w)
        return {
            "recon": recon,
            "mvs": mv_qpel,
            "pu_layout": choice,
            "sad": best_sad,
            "nnz": nnz,
            "psnr_db": psnr(cur, recon),
        }
    if not cfg.tu_sizes:
        rec_ctus, mv_qpel, best_sad, nnz = _inter_core(
            src_ctus, ref, ref_padded, pos, cfg, (gr, gc)
        )
        recon = ctu_mod.untile_frame(rec_ctus, h, w)
        return {
            "recon": recon,
            "mvs": mv_qpel,
            "sad": best_sad,
            "nnz": nnz,
            "psnr_db": psnr(cur, recon),
        }
    # TU-size selection composes with the staged refine.
    from . import partition

    mv_int, best_sad = _integer_search(src_ctus, ref, ref_padded, pos, cfg, (gr, gc))
    start = pos + mv_int + r
    winr = motion.extract_windows(ref_padded, start, cfg.ctu + motion.TAPS - 1)
    pred, frac, _ = _refine_fn(cfg)(src_ctus, winr)
    mv_qpel = mv_int * 4 + jnp.stack([frac // 4, frac % 4], axis=-1)
    rec_ctus, tu_choice, nnz = partition.select_tu_recon(
        src_ctus, pred, cfg, cfg.tu_sizes
    )
    recon = ctu_mod.untile_frame(rec_ctus, h, w)
    return {
        "recon": recon,
        "mvs": mv_qpel,
        "tu_choice": tu_choice,
        "sad": best_sad,
        "nnz": nnz,
        "psnr_db": psnr(cur, recon),
    }


def _inter_core(src_ctus, ref, ref_padded, pos, cfg: EncodeConfig, grid):
    """The inter engine: integer search + quarter-pel refine + residual
    pipeline, each stage at its cfg-selected implementation.

    Shared by encode_inter_frame, the multi-chip band step
    (parallel/sharding._band_frame_step), and the YUV frame encoders —
    every client calls through the best populated implementation, the
    reference's table model (sad.h:69-87).

    src_ctus (n, B, B); ref the unpadded plane (pyramid coarse level);
    ref_padded padded by (r + PAD_L/PAD_R); pos (n, 2); grid (rows, cols).
    Returns (rec_ctus (n, B, B) uint8, mv_qpel (n, 2), best (n,), nnz).
    """
    if cfg.pu_decision or cfg.tu_sizes:
        # This engine runs the fixed CTU/TU geometry; silently dropping a
        # requested RDO decision would encode something other than the
        # config asked for (the reference's populate/get always dispatches
        # what the mask selects or the caller finds out, sad.h:69-87).
        # The YUV, spatial-sharding, and rate-control entry points all
        # route here.
        raise ValueError(
            "this entry point runs the fixed CTU/TU geometry; "
            "pu_decision/tu_sizes compose only with encode_inter_frame"
        )
    r = cfg.search_range
    mv_int, best_sad = _integer_search(src_ctus, ref, ref_padded, pos, cfg, grid)
    start = pos + mv_int + r
    win = motion.extract_windows(ref_padded, start, cfg.ctu + motion.TAPS - 1)
    pred, frac, _ = _refine_fn(cfg)(src_ctus, win)
    mv_qpel = mv_int * 4 + jnp.stack([frac // 4, frac % 4], axis=-1)
    rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False)
    return rec_ctus, mv_qpel, best_sad, nnz


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_inter_frame_multiref(
    cur: jnp.ndarray, refs: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()
):
    """P frame with multiple reference frames: per-CTU reference selection.

    refs: (k, H, W) candidate reference planes (e.g. the last k
    reconstructions).  All k references are searched in ONE batched grid
    call (motion.full_search_multi — the k-way generalisation of the
    reference's 4-way multiref SAD, sad.h:94-112) and the (ref, mv) pair
    minimizing the integer score is selected jointly per CTU; one compile
    regardless of k.  k == 1 is bit-identical to encode_inter_frame.  The
    refine windows are gathered from the k planes stacked into one flat
    plane (offset rows select the reference).
    """
    if cfg.me_strategy == "pyramid":
        # The single-pass k-way search is exhaustive; silently ignoring the
        # strategy would change MVs vs the configured intent.
        raise ValueError(
            "encode_inter_frame_multiref searches exhaustively; "
            "me_strategy='pyramid' is not honored here (use 'full')"
        )
    if cfg.pu_decision or cfg.tu_sizes:
        raise ValueError(
            "encode_inter_frame_multiref runs the fixed CTU/TU geometry; "
            "pu_decision/tu_sizes compose only with encode_inter_frame"
        )
    h, w = cur.shape
    k = refs.shape[0]
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu)
    r = cfg.search_range
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    grid_fn = motion.grid_metric_fn(cfg.me_metric)

    planes = jax.vmap(
        lambda p: ctu_mod.pad_frame(
            p, r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R
        )
    )(refs)                                              # (k, Hp, Wp)
    mv_int, ref_idx, _ = motion.full_search_multi(
        src_ctus, planes, pos, r, grid_fn=grid_fn, grid=(gr, gc),
    )

    hp, wp = planes.shape[1], planes.shape[2]
    flat = planes.reshape(k * hp, wp)
    start = pos + mv_int + r
    row0 = ref_idx * hp + start[:, 0]

    win = motion.extract_windows(
        flat, jnp.stack([row0, start[:, 1]], axis=-1), cfg.ctu + motion.TAPS - 1
    )
    pred, frac, _ = _refine_fn(cfg)(src_ctus, win)
    mv_qpel = mv_int * 4 + jnp.stack([frac // 4, frac % 4], axis=-1)

    rec_ctus, nnz, _ = _residual_pipeline(src_ctus, pred, cfg, intra=False)
    recon = ctu_mod.untile_frame(rec_ctus, h, w)
    return {
        "recon": recon,
        "mvs": mv_qpel,
        "ref_idx": ref_idx,
        "nnz": nnz,
        "psnr_db": psnr(cur, recon),
    }


def _intra_neighbours(frame: jnp.ndarray, n: int):
    """Open-loop intra neighbours + availability for every n x n block.

    Returns (left, above, corner, left_avail, above_avail, corner_avail)
    for blocks in row-major order: left/above (num, 2n), corner (num,).
    Availability is in-frame presence (open-loop predicts from original
    samples, so there is no coding-order constraint); substitution of the
    unavailable samples (8.4.4.2.2) is the caller's next step.
    """
    h, w = frame.shape
    gr, gc = h // n, w // n
    # Pad: 1 left/top and 2n right / n bottom so every extraction is in
    # range; out-of-frame content is masked by the availability flags.
    p = jnp.pad(frame, ((1, n), (1, 2 * n)), mode="edge")

    def runs(mat, blocks, count):
        """(rows, 1 + count*n + n) -> (rows, count, 2n): the 2n-run starting
        one past each n-aligned position — two shifted reshapes, no
        per-block gather."""
        x1 = mat[:, 1 : 1 + count * n].reshape(blocks, count, n)
        x2 = mat[:, 1 + n : 1 + count * n + n].reshape(blocks, count, n)
        return jnp.concatenate([x1, x2], axis=-1)

    rows_mat = p[0 : gr * n : n]                       # (gr, 1 + w + 2n)
    above = runs(rows_mat, gr, gc).reshape(gr * gc, 2 * n)
    corner = rows_mat[:, 0 : gc * n : n].reshape(gr * gc)
    cols_mat = p.T[0 : gc * n : n]                     # (gc, 1 + h + n)
    left = runs(cols_mat, gc, gr)                      # (gc, gr, 2n)
    left = jnp.swapaxes(left, 0, 1).reshape(gr * gc, 2 * n)

    ys = jnp.arange(gr) * n
    xs = jnp.arange(gc) * n
    yy, xx = jnp.meshgrid(ys, xs, indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    i = jnp.arange(2 * n, dtype=jnp.int32)
    lav = (xx[:, None] > 0) & (yy[:, None] + i[None, :] < h)
    aav = (yy[:, None] > 0) & (xx[:, None] + i[None, :] < w)
    cav = (xx > 0) & (yy > 0)
    return left, above, corner, lav, aav, cav


def _prepare_intra_refs(left, above, corner, lav, aav, cav, n, cfg):
    """Substitution + smoothing (8.4.4.2.2-3): returns the plain and the
    filtered reference sets; pred for mode m uses the filtered set iff
    filter_flag(m, n)."""
    from ..ops.pred_intra import (
        filter_references, strong_smoothing_condition, substitute_references)

    left, above, corner = substitute_references(left, above, corner, lav, aav, cav)
    strong = None
    if n == 32 and cfg.strong_intra_smoothing:
        strong = strong_smoothing_condition(left, above, corner)
    lf, af, cf = filter_references(left, above, corner, n, strong=strong)
    return (left, above, corner), (lf, af, cf)


def _satd_cost(a, b):
    """SATD summed over 8x8 sub-blocks (standard mode-decision cost)."""
    a8 = ctu_mod.split_blocks(a, 8)
    b8 = ctu_mod.split_blocks(b, 8)
    per = _satd(a8, b8)
    k = (a.shape[-1] // 8) ** 2
    return per.reshape(a.shape[0], k).sum(-1) if a.ndim == 3 else per


def _intra_mode_sweep(blocks, refs_plain, refs_filt, n: int):
    """All-35-mode predictions + SATD costs for a batch of blocks.

    Returns (preds (m, 35, n, n) uint8, costs (m, 35) int32).  At n == 32
    (no edge filtering) the sweep is ONE constant int8 matmul
    (kernels/intra_matrix, in place of the gather-heavy per-mode loop);
    other sizes run the per-mode REF path.  SATD over 8x8 sub-blocks is
    the standard mode-decision cost
    (what the reference's hadamard_satd kernels exist for,
    hadamard.c:75-111)."""
    from ..ops.pred_intra import filter_flag

    m = blocks.shape[0]
    if n == 32:
        from ..kernels.intra_matrix import pred_intra_all_modes_mm

        preds = pred_intra_all_modes_mm(*refs_plain, *refs_filt, n)
    else:
        preds = jnp.stack(
            [pred_intra(mode,
                        *(refs_filt if filter_flag(mode, n) else refs_plain),
                        n, filter_edge=n < 32)
             for mode in range(35)],
            axis=1,
        )
    tiled = jnp.broadcast_to(blocks[:, None], (m, 35, n, n)).reshape(-1, n, n)
    costs = _satd_cost(tiled, preds.reshape(-1, n, n)).reshape(m, 35)
    return preds, costs


def _intra_mode_decide(blocks, refs_plain, refs_filt, n: int):
    """Mode decision + winning prediction for a batch of blocks.

    Returns (pred (m, n, n) uint8, best (m,) int32).  At n == 32 the whole
    decision runs in the Hadamard domain (kernels/intra_matrix.
    intra_mode_decision_t — no candidate plane is materialized; the metric
    is the raw-accumulator analogue of 8x8 SATD, so near-ties can resolve
    to a different mode than the classic SATD sweep, while the winning
    mode's prediction stays bit-exact with ops.pred_intra).  Other sizes
    run the per-mode sweep with classic SATD."""
    if n == 32:
        from ..kernels.intra_matrix import intra_mode_decision_t

        pred, best, _ = intra_mode_decision_t(
            blocks, *refs_plain, *refs_filt, n)
        return pred, best
    preds, costs = _intra_mode_sweep(blocks, refs_plain, refs_filt, n)
    best = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    pred = jnp.take_along_axis(preds, best[:, None, None, None], axis=1)[:, 0]
    return pred, best


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_intra_frame(cur: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()):
    """Encode one intra (I) frame: batched 35-mode prediction at
    cfg.intra_block, SATD mode decision, then the TU pipeline."""
    h, w = cur.shape
    n = cfg.intra_block
    blocks = ctu_mod.tile_frame(cur, n)                        # (m, n, n)
    refs_plain, refs_filt = _prepare_intra_refs(
        *_intra_neighbours(cur, n), n, cfg
    )

    pred, best = _intra_mode_decide(blocks, refs_plain, refs_filt, n)

    rec_blocks, nnz, _ = _residual_pipeline(blocks, pred, cfg, intra=True)
    recon = ctu_mod.untile_frame(rec_blocks, h, w)
    return {
        "recon": recon,
        "modes": best,
        "nnz": nnz,
        "psnr_db": psnr(cur, recon),
    }


def encode_gop(frames: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()):
    """Encode a GOP (IPPP, open loop): frame 0 intra, frame t>0 predicted
    from original frame t-1.  frames: (T, H, W) uint8.

    Open-loop referencing makes every P frame independent given the source,
    which is what lets config 4 shard frames across chips with no sequential
    dependency (SURVEY.md section 2.3).
    """
    if cfg.intra_mode == "wavefront":
        from .intra_wavefront import encode_intra_frame_wavefront

        intra = encode_intra_frame_wavefront(frames[0], cfg)
    else:
        intra = encode_intra_frame(frames[0], cfg)
    results = [intra]
    for t in range(1, frames.shape[0]):
        results.append(encode_inter_frame(frames[t], frames[t - 1], cfg))
    recon = jnp.stack([r["recon"] for r in results])
    return {
        "recon": recon,
        "psnr_db": psnr(frames, recon),
        "nnz": sum(int(r["nnz"]) for r in results),
    }
