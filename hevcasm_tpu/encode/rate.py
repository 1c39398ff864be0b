"""Rate control: per-frame qp adaptation toward a bit budget.

The reference has no rate control (no config system beyond the ISA mask,
SURVEY.md section 5); a production encoder needs one.  Compiled-program
design constraint: qp must be a *traced* value, otherwise every qp change would
recompile the frame program.  quantize/quantize_inverse already accept traced
scale/shift/offset arrays, so the quantizer parameter derivation below is
pure jnp (table gathers + shifts) and one compiled program serves all qps.

Bit cost uses an Exp-Golomb-style proxy:
  bits(q) = 0                   if q == 0
          = 2*floor(log2|q|)+3  otherwise  (sign + unary prefix + suffix)
which tracks real CABAC rates well enough for proportional control.

The controller is the classic per-frame proportional update:
  qp[t+1] = clip(qp[t] + round(k * log2(bits[t] / target)), qp_min, qp_max)
run inside lax.scan over the GOP, so a whole rate-controlled GOP is still a
single compiled program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.transform import forward_transform, inverse_transform_add
from ..ops.quantize import quantize, quantize_inverse
from ..utils.psnr import psnr
from . import ctu as ctu_mod
from . import motion
from .loop import EncodeConfig, QUANT_SCALES, DEQUANT_SCALES

__all__ = ["quant_params_traced", "bits_estimate",
           "encode_inter_frame_traced_qp", "encode_b_frame_traced_qp",
           "encode_gop_rate_controlled"]


def quant_params_traced(qp: jnp.ndarray, tu_log2: int, intra: bool = False):
    """Traced-qp version of EncodeConfig.quant_params/dequant_params."""
    qp = jnp.asarray(qp, jnp.int32)
    rem, per = qp % 6, qp // 6
    qscales = jnp.asarray(QUANT_SCALES, jnp.int32)
    dscales = jnp.asarray(DEQUANT_SCALES, jnp.int32)
    qscale = jnp.take(qscales, rem)
    qshift = 21 + per - tu_log2
    qoffset = (171 if intra else 85) << 7
    dscale = jnp.take(dscales, rem) << per
    dshift = tu_log2 - 1
    return qscale, qshift, qoffset, dscale, dshift


def bits_estimate(levels: jnp.ndarray) -> jnp.ndarray:
    """Exp-Golomb-style bit-cost proxy of quantized levels (scalar int32).

    floor(log2 a) comes from the f32 exponent field (|levels| <= 32767
    < 2^24 converts exactly) — the same integer-exact formulation as the
    per-CTU bits of kernels/xla_opt.residual_pipeline_frame."""
    a = jnp.abs(levels.astype(jnp.int32))
    fl = (jax.lax.bitcast_convert_type(
        jnp.maximum(a, 1).astype(jnp.float32), jnp.int32) >> 23) - 127
    bits = jnp.where(a > 0, 2 * fl + 3, 0)
    return jnp.sum(bits)


def _residual_pipeline_traced_params(src_blocks, pred_blocks, qparams,
                                     cfg: EncodeConfig, checked: bool = False):
    """cfg-shaped residual pipeline with pre-derived traced quantizer
    parameters; returns (rec, bits)."""
    qscale, qshift, qoffset, dscale, dshift = qparams
    res = src_blocks.astype(jnp.int16) - pred_blocks.astype(jnp.int16)
    tus = ctu_mod.split_blocks(res, cfg.tu)
    ptus = ctu_mod.split_blocks(pred_blocks, cfg.tu)
    coeffs = forward_transform(tus)
    levels, _ = quantize(coeffs, qscale, qshift, qoffset, _traced_check=checked)
    rcoeffs = quantize_inverse(levels, dscale, dshift)
    rec_tus = inverse_transform_add(rcoeffs, ptus)
    rec = ctu_mod.merge_blocks(rec_tus, src_blocks.shape[-1])
    return rec, bits_estimate(levels)


def _residual_pipeline_traced(src_blocks, pred_blocks, qp, cfg: EncodeConfig,
                              intra: bool, checked: bool):
    """cfg-shaped residual pipeline with a traced qp; returns (rec, bits).

    With ``checked`` the quantizer emits checkify range checks on its
    traced parameters — an out-of-range qp derivation (e.g. shift past the
    reference's asserted 16..27 window, quantize.c:162-165) raises from
    encode_gop_rate_controlled instead of passing silently.  Callers
    passing checked=True must run under a checkify
    transform."""
    qparams = quant_params_traced(qp, cfg.tu_log2, intra)
    return _residual_pipeline_traced_params(src_blocks, pred_blocks, qparams,
                                            cfg, checked=checked)


@functools.partial(jax.jit, static_argnames=("cfg", "checked"))
def encode_inter_frame_traced_qp(cur, ref, qp, cfg: EncodeConfig = EncodeConfig(),
                                 checked: bool = False):
    """encode_inter_frame with a traced qp; one compile serves all qps.
    Search and refinement are the fixed-qp frame's stages; the residual
    runs with the traced quantizer parameters and returns its Exp-Golomb
    bit estimate."""
    if cfg.pu_decision or cfg.tu_sizes:
        # The traced-qp path runs the fixed 64/8x8 geometry; silently
        # dropping a requested RDO decision would encode something other
        # than the config asked for (the reference's populate/get always
        # dispatches what the mask selects or the caller finds out,
        # sad.h:69-87).
        raise ValueError(
            "encode_inter_frame_traced_qp does not compose with "
            "pu_decision/tu_sizes (use encode_inter_frame at fixed qp)"
        )
    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu)
    r = cfg.search_range
    ref_padded = ctu_mod.pad_frame(
        ref, r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R
    )
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    from .loop import _integer_search, _refine_fn

    mv_int, _ = _integer_search(src_ctus, ref, ref_padded, pos, cfg, (gr, gc))
    start = pos + mv_int + r
    win = motion.extract_windows(ref_padded, start, cfg.ctu + motion.TAPS - 1)
    pred, _, _ = _refine_fn(cfg)(src_ctus, win)
    rec_ctus, bits = _residual_pipeline_traced(
        src_ctus, pred, qp, cfg, intra=False, checked=checked
    )
    recon = ctu_mod.untile_frame(rec_ctus, h, w)
    return {"recon": recon, "bits": bits, "psnr_db": psnr(cur, recon), "qp": qp}


@functools.partial(jax.jit, static_argnames=("cfg", "checked"))
def encode_b_frame_traced_qp(cur, ref0, ref1, qp, cfg: EncodeConfig = EncodeConfig(),
                             checked: bool = False):
    """B frame (luma) with a traced qp: per-reference search + refinement +
    the bi combine (video._b_frame_luma) with the traced quantizer
    parameters — the B-frame counterpart of encode_inter_frame_traced_qp."""
    if cfg.pu_decision or cfg.tu_sizes:
        raise ValueError(
            "encode_b_frame_traced_qp does not compose with "
            "pu_decision/tu_sizes"
        )
    from .video import _b_frame_luma

    h, w = cur.shape
    gr, gc = ctu_mod.grid_shape(h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur, cfg.ctu)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    qparams = quant_params_traced(qp, cfg.tu_log2, False)
    if checked:
        from ..ops.quantize import check_params_traced

        check_params_traced(qparams[0], qparams[1], qparams[2])
    rec_ctus, mvs, _, bits = _b_frame_luma(
        src_ctus, ref0, ref1, pos, (gr, gc), cfg, qparams=qparams)
    recon = ctu_mod.untile_frame(rec_ctus, h, w)
    return {"recon": recon, "bits": bits, "psnr_db": psnr(cur, recon),
            "qp": qp}


def _gop_rc_body(frames, target, qp0, *, cfg, qp_min, qp_max, checked,
                 b_frames=False):
    def qp_update(qp, bits, frame_target):
        # Damped proportional update in the log-bit domain.  The bits-vs-qp
        # slope steepens at high qp, so an aggressive gain oscillates; a
        # gain of 1.5 steps/octave with a +-6 step clamp converges smoothly.
        err = jnp.log2(jnp.maximum(bits.astype(jnp.float32), 1.0) / frame_target)
        step = jnp.clip(jnp.round(1.5 * err).astype(jnp.int32), -6, 6)
        return jnp.clip(qp + step, qp_min, qp_max)

    if not b_frames:
        def body(carry, cur):
            prev_recon, qp = carry
            out = encode_inter_frame_traced_qp(cur, prev_recon, qp, cfg,
                                               checked=checked)
            qp_next = qp_update(qp, out["bits"], target)
            return (out["recon"], qp_next), (out["recon"], out["bits"], qp, out["psnr_db"])

        (_, _), (recs, bits, qps, psnrs) = jax.lax.scan(
            body, (frames[0], qp0), frames[1:]
        )
        return {"recon": recs, "bits": bits, "qp": qps, "psnr_db": psnrs}

    # IBPBP...: display order B(2k+1), P(2k+2); encode order P first (from
    # the previous P/I recon), then B bi-predicted from the two surrounding
    # recons; one qp serves the pair and updates on the pair's total bits
    # vs twice the per-frame target.
    t = frames.shape[0]
    assert t % 2 == 1, "b_frames GOP needs an odd frame count (ends on P)"
    fb, fp = frames[1::2], frames[2::2]

    def body(carry, cur2):
        prev_recon, qp = carry
        cur_b, cur_p = cur2
        outp = encode_inter_frame_traced_qp(cur_p, prev_recon, qp, cfg,
                                            checked=checked)
        outb = encode_b_frame_traced_qp(cur_b, prev_recon, outp["recon"],
                                        qp, cfg, checked=checked)
        bits2 = outp["bits"] + outb["bits"]
        qp_next = qp_update(qp, bits2, 2.0 * target)
        ys = (outb["recon"], outp["recon"], bits2, qp,
              outb["psnr_db"], outp["psnr_db"])
        return (outp["recon"], qp_next), ys

    (_, _), (recb, recp, bits, qps, psb, psp) = jax.lax.scan(
        body, (frames[0], qp0), (fb, fp)
    )
    # Interleave back to display order.
    recs = jnp.stack([recb, recp], axis=1).reshape((-1,) + frames.shape[1:])
    psnrs = jnp.stack([psb, psp], axis=1).reshape(-1)
    return {"recon": recs, "bits": bits, "qp": qps, "psnr_db": psnrs}


@functools.partial(jax.jit, static_argnames=("cfg", "qp_min", "qp_max",
                                             "b_frames"))
def _gop_rc_checked(frames, target, qp0, cfg, qp_min, qp_max, b_frames):
    from jax.experimental import checkify

    return checkify.checkify(functools.partial(
        _gop_rc_body, cfg=cfg, qp_min=qp_min, qp_max=qp_max, checked=True,
        b_frames=b_frames,
    ))(frames, target, qp0)


def encode_gop_rate_controlled(
    frames: jnp.ndarray,
    target_bits_per_frame,
    qp0,
    cfg: EncodeConfig = EncodeConfig(),
    qp_min: int = 10,
    qp_max: int = 49,
    b_frames: bool = False,
):
    """Closed-loop GOP with per-frame proportional qp control, as one
    compiled program (lax.scan).  frames (T, H, W); frame 0 is used as the
    initial reference (caller encodes it intra separately).
    b_frames=False encodes IPPP; b_frames=True encodes display-order
    IBPBP... (odd T required): each P from the previous P/I recon, each B
    bi-predicted from the two surrounding recons, one qp per B/P pair
    updated on the pair's bits.

    The quantizer's reference-asserted parameter ranges are enforced via
    checkify: an out-of-range traced qp raises here (tests/test_rate.py).

    Returns per-frame recon, bits, qp, psnr arrays.
    """
    target = jnp.maximum(jnp.asarray(target_bits_per_frame, jnp.float32), 1.0)
    qp0 = jnp.asarray(qp0, jnp.int32)
    err, out = _gop_rc_checked(frames, target, qp0, cfg, qp_min, qp_max,
                               b_frames)
    err.throw()
    return out
