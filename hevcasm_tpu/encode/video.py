"""Full-video (4:2:0) encoding: luma + chroma planes, B frames with
bi-prediction, and closed-loop (reconstructed-reference) GOP encoding.

This is the layer a real consumer of the reference library would have had to
write around its kernels (SURVEY.md section 0): the reference ships 4-tap
chroma MC (pred_inter.c:69-79) and bi-pred combining (pred_inter.c:490-530)
but no frame pipeline.  Here:

* Chroma MVs follow HEVC semantics: the luma quarter-pel MV applied at
  chroma resolution becomes an eighth-pel MV (integer = mv >> 3,
  frac = mv & 7) driving the 4-tap kernels.
* Chroma qp derives from luma qp via the normative 4:2:0 mapping
  (H.265 table 8-10).
* B frames bi-predict from two reference frames: independent full search on
  each, then the fused (r0 + r1 + 64) >> 7 combining mean.
* Closed-loop mode chains each P frame off the previous *reconstruction*
  inside one lax.scan-compiled program, the structure a conforming encoder
  needs (and what bench.py measures).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.pred_inter import pred_uni, pred_uni_16
from ..utils.psnr import psnr
from . import ctu as ctu_mod
from . import motion
from .loop import EncodeConfig, _inter_core, _residual_pipeline, encode_intra_frame

__all__ = ["YuvFrame", "chroma_qp", "encode_inter_frame_yuv",
           "encode_b_frame_yuv", "encode_gop_yuv", "encode_gop_closed_loop",
           "encode_gop_closed_loop_yuv", "encode_gop_closed_loop_yuv_b"]


class YuvFrame(NamedTuple):
    """4:2:0 planes: y (H, W), cb/cr (H/2, W/2); leading batch dims allowed."""

    y: jnp.ndarray
    cb: jnp.ndarray
    cr: jnp.ndarray


# H.265 table 8-10: qPc as a function of qPi for 4:2:0.
_QPC = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34, 37: 34,
        38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp(qp: int) -> int:
    if qp < 30:
        return qp
    if qp > 43:
        return qp - 6
    return _QPC[qp]


def _chroma_cfg(cfg: EncodeConfig) -> EncodeConfig:
    # Chroma only uses the residual pipeline (MC comes from the luma MVs).
    return dataclasses.replace(
        cfg, qp=chroma_qp(cfg.qp), tu=4, ctu=cfg.ctu // 2,
        search_range=cfg.search_range // 2,
    )


def _chroma_mc(plane: jnp.ndarray, mv_qpel: jnp.ndarray, cfg: EncodeConfig,
               out16: bool = False):
    """Motion-compensate one chroma plane with the luma quarter-pel MVs.

    plane: (H/2, W/2) reference chroma; mv_qpel (n, 2) luma quarter-pel MVs
    (one per 64x64 luma CTU == one per 32x32 chroma block).
    Returns (n, ctu/2, ctu/2): uint8 predictions, or with ``out16`` the
    int16 (acc >> 6) intermediates the reference's bi-pred combining mean
    consumes (pred_inter.c:490-530).
    """
    taps = 4
    b = cfg.ctu // 2
    rc = cfg.search_range // 2 + 1  # chroma integer-pel reach (+1 for mv>>3 rounding)
    pad_l, pad_r = taps // 2 - 1, taps // 2  # 1, 2
    h2, w2 = plane.shape
    padded = ctu_mod.pad_frame(plane, rc + pad_l, rc + pad_r + 1, rc + pad_l, rc + pad_r + 1)
    gr, gc = h2 // b, w2 // b
    pos = motion.ctu_positions(gr, gc, b)
    # Chroma MV in eighth-pel at chroma resolution == luma qpel value.
    mv_int = mv_qpel >> 3              # arithmetic: floor division by 8
    frac = mv_qpel & 7                 # (n, 2) in [0, 8)
    start = pos + mv_int + rc          # window top-left in padded coords
    win = motion.extract_windows(padded, start, b + taps - 1)
    if out16:
        return pred_uni_16(win, frac[:, 1], frac[:, 0], taps)
    return pred_uni(win, frac[:, 1], frac[:, 0], taps)


def _chroma_residual(cur_plane, pred_blocks, cfg: EncodeConfig, intra: bool):
    ccfg = _chroma_cfg(cfg)
    src_blocks = ctu_mod.tile_frame(cur_plane, ccfg.ctu)
    rec, nnz, _ = _residual_pipeline(src_blocks, pred_blocks, ccfg, intra, luma=False)
    return ctu_mod.untile_frame(rec, *cur_plane.shape), nnz


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_inter_frame_yuv(cur: YuvFrame, ref: YuvFrame, cfg: EncodeConfig = EncodeConfig()):
    """One P frame over 4:2:0 planes: luma ME + MC, chroma MC from luma MVs,
    full residual pipelines on all three planes.

    The luma plane runs the same inter engine as the luma-only encoder
    (loop._inter_core)."""
    h, w = cur.y.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur.y, cfg.ctu)
    r = cfg.search_range
    ref_padded = ctu_mod.pad_frame(ref.y, r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)

    rec_y_ctus, mv_qpel, _, nnz_y = _inter_core(
        src_ctus, ref.y, ref_padded, pos, cfg, (gr, gc)
    )
    rec_y = ctu_mod.untile_frame(rec_y_ctus, h, w)

    pred_cb = _chroma_mc(ref.cb, mv_qpel, cfg)
    pred_cr = _chroma_mc(ref.cr, mv_qpel, cfg)
    rec_cb, nnz_cb = _chroma_residual(cur.cb, pred_cb, cfg, intra=False)
    rec_cr, nnz_cr = _chroma_residual(cur.cr, pred_cr, cfg, intra=False)

    return {
        "recon": YuvFrame(rec_y, rec_cb, rec_cr),
        "mvs": mv_qpel,
        "nnz": nnz_y + nnz_cb + nnz_cr,
        "psnr_y": psnr(cur.y, rec_y),
        "psnr_cb": psnr(cur.cb, rec_cb),
        "psnr_cr": psnr(cur.cr, rec_cr),
    }


def _b_frame_luma(src_ctus, ref0_y, ref1_y, pos, grid, cfg: EncodeConfig,
                  qparams=None):
    """Shared B-frame luma core: per-reference integer search + quarter-pel
    refinement + bi combine + residual.

    qparams None uses cfg.quant_params (nnz returned); a traced
    (qscale, qshift, qoffset, dscale, dshift) tuple selects the traced-qp
    residual stage (bits returned) — the rate controller's path.
    Returns (rec_y_ctus, [mv0_qpel, mv1_qpel], nnz, bits)."""
    from .loop import _refine_fn

    gr, gc = grid
    r = cfg.search_range
    grid_fn = motion.grid_metric_fn(cfg.me_metric)

    # Both references searched per-reference (a B frame needs both MVs) in
    # ONE batched grid call over the stacked planes.
    planes = jax.vmap(
        lambda p: ctu_mod.pad_frame(
            p, r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R
        )
    )(jnp.stack([ref0_y, ref1_y]))
    mv_ints, _ = motion.full_search_multi(
        src_ctus, planes, pos, r, grid_fn=grid_fn, grid=(gr, gc), joint=False,
    )

    mvs, preds16 = [], []
    for i in range(2):
        start = pos + mv_ints[i] + r
        win = motion.extract_windows(planes[i], start, cfg.ctu + motion.TAPS - 1)
        _, frac_idx, _ = _refine_fn(cfg)(src_ctus, win)
        mv_qpel = mv_ints[i] * 4 + jnp.stack(
            [frac_idx // 4, frac_idx % 4], axis=-1)
        frac = mv_qpel & 3
        p16 = pred_uni_16(win, frac[:, 1], frac[:, 0], motion.TAPS)
        mvs.append(mv_qpel)
        preds16.append(p16.astype(jnp.int32))

    pred_y = jnp.clip((preds16[0] + preds16[1] + 64) >> 7, 0, 255).astype(jnp.uint8)
    if qparams is None:
        rec_y_ctus, nnz_y, _ = _residual_pipeline(src_ctus, pred_y, cfg, intra=False)
        return rec_y_ctus, mvs, nnz_y, None
    from .rate import _residual_pipeline_traced_params

    rec_y_ctus, bits = _residual_pipeline_traced_params(
        src_ctus, pred_y, qparams, cfg)
    return rec_y_ctus, mvs, None, bits


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_b_frame_yuv(cur: YuvFrame, ref0: YuvFrame, ref1: YuvFrame, cfg: EncodeConfig = EncodeConfig()):
    """One B frame: independent integer full search against both references,
    quarter-pel refinement of each, then the fused bi-pred combining mean
    (r0 + r1 + 64) >> 7 — the hevcasm_pred_bi contract (pred_inter.c:490-530).
    Chroma bi-predicts with the same MV pair (luma core: _b_frame_luma)."""
    h, w = cur.y.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur.y, cfg.ctu)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)

    rec_y_ctus, mvs, nnz_y, _ = _b_frame_luma(
        src_ctus, ref0.y, ref1.y, pos, (gr, gc), cfg)
    rec_y = ctu_mod.untile_frame(rec_y_ctus, h, w)

    def chroma_bi(plane0, plane1, mv0, mv1, cur_plane):
        # Reference bi contract: each uni path keeps the int16 (acc >> 6)
        # intermediate and the combining mean is (r0 + r1 + 64) >> 7
        # (pred_inter.c:490-530) — the r3 encoder's pavgb-style rounding of
        # the two 8-bit uni outputs deviated from it.
        p0 = _chroma_mc(plane0, mv0, cfg, out16=True).astype(jnp.int32)
        p1 = _chroma_mc(plane1, mv1, cfg, out16=True).astype(jnp.int32)
        pred = jnp.clip((p0 + p1 + 64) >> 7, 0, 255).astype(jnp.uint8)
        return _chroma_residual(cur_plane, pred, cfg, intra=False)

    rec_cb, nnz_cb = chroma_bi(ref0.cb, ref1.cb, mvs[0], mvs[1], cur.cb)
    rec_cr, nnz_cr = chroma_bi(ref0.cr, ref1.cr, mvs[0], mvs[1], cur.cr)

    return {
        "recon": YuvFrame(rec_y, rec_cb, rec_cr),
        "mvs0": mvs[0],
        "mvs1": mvs[1],
        "nnz": nnz_y + nnz_cb + nnz_cr,
        "psnr_y": psnr(cur.y, rec_y),
    }


def _chroma_intra_plane(plane: jnp.ndarray, cfg: EncodeConfig) -> tuple:
    """Chroma intra: planar/DC/H/V mode decision per block (the HEVC
    chroma candidate set, 8.4.3) from in-plane neighbours, SATD decision,
    then the chroma TU pipeline.  Replaces the r4 flat-block-mean
    stand-in, which cost ~1.9 dB chroma PSNR on smooth content.  Open-loop
    neighbours (original samples), consistent with the luma open-loop
    intra path.  Returns (recon_plane, nnz)."""
    from .loop import (_intra_neighbours, _prepare_intra_refs,
                       _residual_pipeline, _satd_cost)
    from ..ops.pred_intra import filter_flag, pred_intra

    ccfg = _chroma_cfg(cfg)
    n = ccfg.ctu
    blocks = ctu_mod.tile_frame(plane, n)
    refs_plain, refs_filt = _prepare_intra_refs(
        *_intra_neighbours(plane, n), n, ccfg)
    preds, costs = [], []
    for mode in (0, 1, 10, 26):  # planar, DC, horizontal, vertical
        refs = refs_filt if filter_flag(mode, n) else refs_plain
        p = pred_intra(mode, *refs, n, filter_edge=False)
        preds.append(p)
        costs.append(_satd_cost(blocks, p))
    preds = jnp.stack(preds, axis=1)
    costs = jnp.stack(costs, axis=1)
    best = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    pred = jnp.take_along_axis(preds, best[:, None, None, None], axis=1)[:, 0]
    rec, nnz, _ = _residual_pipeline(blocks, pred, ccfg, intra=True, luma=False)
    return ctu_mod.untile_frame(rec, *plane.shape), nnz


def encode_intra_frame_yuv(cur: YuvFrame, cfg: EncodeConfig = EncodeConfig()):
    """I frame: luma 35-mode intra; chroma uses the TU pipeline against a DC
    (flat-mean) prediction per block."""
    out_y = encode_intra_frame(cur.y, cfg)
    rec_cb, nnz_cb = _chroma_intra_plane(cur.cb, cfg)
    rec_cr, nnz_cr = _chroma_intra_plane(cur.cr, cfg)
    return {
        "recon": YuvFrame(out_y["recon"], rec_cb, rec_cr),
        "nnz": out_y["nnz"] + nnz_cb + nnz_cr,
        "psnr_y": out_y["psnr_db"],
    }


def encode_gop_yuv(frames: YuvFrame, cfg: EncodeConfig = EncodeConfig(), b_frames: bool = False):
    """Encode a 4:2:0 GOP.  frames: YuvFrame with leading time axis.

    b_frames=False: IPPP (open loop, frames independent given sources).
    b_frames=True:  IBPBP...: odd frames are B, bi-predicted from the
    surrounding even frames (sources).
    """
    t_total = frames.y.shape[0]

    def frame_at(t):
        return YuvFrame(frames.y[t], frames.cb[t], frames.cr[t])

    results = [encode_intra_frame_yuv(frame_at(0), cfg)]
    for t in range(1, t_total):
        if b_frames and t % 2 == 1 and t + 1 < t_total:
            results.append(encode_b_frame_yuv(frame_at(t), frame_at(t - 1), frame_at(t + 1), cfg))
        else:
            results.append(encode_inter_frame_yuv(frame_at(t), frame_at(t - 1), cfg))
    rec = YuvFrame(
        jnp.stack([r["recon"].y for r in results]),
        jnp.stack([r["recon"].cb for r in results]),
        jnp.stack([r["recon"].cr for r in results]),
    )
    return {
        "recon": rec,
        "psnr_y": psnr(frames.y, rec.y),
        "nnz": sum(int(r["nnz"]) for r in results),
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_gop_closed_loop_yuv(frames: YuvFrame, cfg: EncodeConfig = EncodeConfig()):
    """Closed-loop 4:2:0 IPPP GOP as ONE compiled program: frame 0 intra
    (closed-loop wavefront luma + DC chroma), every P frame predicted from
    the previous frame's RECONSTRUCTION on all three planes (lax.scan) —
    the conforming full-video chain.  Luma runs loop._inter_core.

    frames: YuvFrame with leading time axis.  Returns {"recon": YuvFrame
    stacks, "psnr_y": (T,)} — bit-exact vs per-frame encode_inter_frame_yuv
    chained on reconstructions (tests/test_video.py).
    """
    from .intra_wavefront import encode_intra_frame_wavefront

    intra_y = encode_intra_frame_wavefront(frames.y[0], cfg)

    seed = YuvFrame(intra_y["recon"],
                    _chroma_intra_plane(frames.cb[0], cfg)[0],
                    _chroma_intra_plane(frames.cr[0], cfg)[0])

    def body(prev, cur_planes):
        cur = YuvFrame(*cur_planes)
        out = encode_inter_frame_yuv(cur, prev, cfg)
        rec = out["recon"]
        return rec, (rec.y, rec.cb, rec.cr, out["psnr_y"])

    _, (ys, cbs, crs, psnrs) = jax.lax.scan(
        body, seed, (frames.y[1:], frames.cb[1:], frames.cr[1:])
    )
    rec = YuvFrame(
        jnp.concatenate([seed.y[None], ys]),
        jnp.concatenate([seed.cb[None], cbs]),
        jnp.concatenate([seed.cr[None], crs]),
    )
    return {
        "recon": rec,
        "psnr_y": jnp.concatenate([intra_y["psnr_db"][None], psnrs]),
    }


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_gop_closed_loop_yuv_b(frames: YuvFrame, cfg: EncodeConfig = EncodeConfig()):
    """Closed-loop 4:2:0 GOP with B frames, ONE compiled program.

    Display order I B P B P ... (odd frame count, ends on P); encode order
    I, P2, B1, P4, B3, ...: each P is predicted from the previous P/I
    RECONSTRUCTION and each B bi-predicts from the two surrounding
    reconstructions — the conforming referencing structure (encode order !=
    display order).  Returns display-order
    recon stacks + per-frame luma psnr; bit-exact vs composing
    encode_inter_frame_yuv / encode_b_frame_yuv per frame in the same
    encode order (tests/test_video.py)."""
    t = frames.y.shape[0]
    assert t % 2 == 1 and t >= 3, "IBPBP GOP needs an odd frame count >= 3"
    from .intra_wavefront import encode_intra_frame_wavefront

    intra_y = encode_intra_frame_wavefront(frames.y[0], cfg)

    seed = YuvFrame(intra_y["recon"],
                    _chroma_intra_plane(frames.cb[0], cfg)[0],
                    _chroma_intra_plane(frames.cr[0], cfg)[0])

    def at(t0, step=2):
        return YuvFrame(frames.y[t0::step], frames.cb[t0::step],
                        frames.cr[t0::step])

    fb, fp = at(1), at(2)

    def body(prev, cur2):
        cur_b, cur_p = (YuvFrame(*cur2[0]), YuvFrame(*cur2[1]))
        outp = encode_inter_frame_yuv(cur_p, prev, cfg)
        outb = encode_b_frame_yuv(cur_b, prev, outp["recon"], cfg)
        rb, rp = outb["recon"], outp["recon"]
        return rp, ((rb.y, rb.cb, rb.cr), (rp.y, rp.cb, rp.cr),
                    outb["psnr_y"], outp["psnr_y"])

    _, (rb, rp, psb, psp) = jax.lax.scan(
        body, seed, ((fb.y, fb.cb, fb.cr), (fp.y, fp.cb, fp.cr))
    )

    def interleave(b, p, lead):
        pairs = jnp.stack([b, p], axis=1).reshape((-1,) + b.shape[1:])
        return jnp.concatenate([lead[None], pairs])

    rec = YuvFrame(interleave(rb[0], rp[0], seed.y),
                   interleave(rb[1], rp[1], seed.cb),
                   interleave(rb[2], rp[2], seed.cr))
    psnrs = jnp.concatenate([
        intra_y["psnr_db"][None],
        jnp.stack([psb, psp], axis=1).reshape(-1),
    ])
    return {"recon": rec, "psnr_y": psnrs}


@functools.partial(jax.jit, static_argnames=("cfg", "num_frames"))
def encode_gop_closed_loop(frames_y: jnp.ndarray, cfg: EncodeConfig, num_frames: int):
    """Closed-loop IPPP luma GOP as ONE compiled program: frame 0 is encoded
    with the closed-loop wavefront intra encoder and each P frame is
    predicted from the previous frame's *reconstruction* (lax.scan) — the
    conforming-encoder chain with no encoder/decoder drift, I frame
    included.

    frames_y: (T, H, W) uint8 with T == num_frames.
    Returns {"recon": (T, H, W) recon stack (I frame first),
    "psnr_db": (T,) per-frame psnr}.
    """
    from .intra_wavefront import encode_intra_frame_wavefront
    from .loop import encode_inter_frame

    intra = encode_intra_frame_wavefront(frames_y[0], cfg)

    def body(prev_recon, cur):
        out = encode_inter_frame(cur, prev_recon, cfg)
        return out["recon"], (out["recon"], out["psnr_db"])

    _, (recs, psnrs) = jax.lax.scan(body, intra["recon"], frames_y[1:num_frames])
    return {
        "recon": jnp.concatenate([intra["recon"][None], recs]),
        "psnr_db": jnp.concatenate([intra["psnr_db"][None], psnrs]),
    }
