"""4:2:0 video pipeline: chroma MC from luma MVs, B frames, closed loop."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode.video import (
    YuvFrame,
    chroma_qp,
    encode_inter_frame_yuv,
    encode_b_frame_yuv,
    encode_intra_frame_yuv,
    encode_gop_yuv,
    encode_gop_closed_loop,
)


def _smooth(rng, h, w):
    a = rng.integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(2):
        a = (np.roll(a, 1, 0) + a + np.roll(a, -1, 0)) / 3
        a = (np.roll(a, 1, 1) + a + np.roll(a, -1, 1)) / 3
    return np.clip(a, 0, 255).astype(np.uint8)


def _yuv_clip(rng, t, h, w, dy=2, dx=4):
    ybase = _smooth(rng, h + 2 * t * dy + 8, w + 2 * t * dx + 8)
    cbase = _smooth(rng, (h + 2 * t * dy + 8) // 2, (w + 2 * t * dx + 8) // 2)
    crbase = _smooth(rng, (h + 2 * t * dy + 8) // 2, (w + 2 * t * dx + 8) // 2)
    ys, cbs, crs = [], [], []
    for i in range(t):
        ys.append(ybase[i * dy : i * dy + h, i * dx : i * dx + w])
        # chroma pans at half rate (consistent with 4:2:0 subsampling)
        cbs.append(cbase[i * dy // 2 : i * dy // 2 + h // 2, i * dx // 2 : i * dx // 2 + w // 2])
        crs.append(crbase[i * dy // 2 : i * dy // 2 + h // 2, i * dx // 2 : i * dx // 2 + w // 2])
    return YuvFrame(jnp.asarray(np.stack(ys)), jnp.asarray(np.stack(cbs)), jnp.asarray(np.stack(crs)))


def test_chroma_qp_table():
    assert chroma_qp(20) == 20
    assert chroma_qp(30) == 29
    assert chroma_qp(37) == 34
    assert chroma_qp(43) == 37
    assert chroma_qp(51) == 45


def test_inter_frame_yuv(rng):
    clip = _yuv_clip(rng, 2, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    cur = YuvFrame(clip.y[1], clip.cb[1], clip.cr[1])
    ref = YuvFrame(clip.y[0], clip.cb[0], clip.cr[0])
    out = encode_inter_frame_yuv(cur, ref, cfg)
    assert out["recon"].y.shape == (128, 128)
    assert out["recon"].cb.shape == (64, 64)
    assert float(out["psnr_y"]) > 38.0
    assert float(out["psnr_cb"]) > 35.0
    assert float(out["psnr_cr"]) > 35.0


def test_b_frame_yuv(rng):
    clip = _yuv_clip(rng, 3, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    cur = YuvFrame(clip.y[1], clip.cb[1], clip.cr[1])
    r0 = YuvFrame(clip.y[0], clip.cb[0], clip.cr[0])
    r1 = YuvFrame(clip.y[2], clip.cb[2], clip.cr[2])
    out = encode_b_frame_yuv(cur, r0, r1, cfg)
    assert float(out["psnr_y"]) > 38.0


def test_intra_frame_yuv(rng):
    clip = _yuv_clip(rng, 1, 128, 128)
    cfg = EncodeConfig(qp=27)
    out = encode_intra_frame_yuv(YuvFrame(clip.y[0], clip.cb[0], clip.cr[0]), cfg)
    assert float(out["psnr_y"]) > 30.0
    assert out["recon"].cb.shape == (64, 64)


@pytest.mark.parametrize("b_frames", [False, True])
def test_gop_yuv(rng, b_frames):
    clip = _yuv_clip(rng, 4, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    out = encode_gop_yuv(clip, cfg, b_frames=b_frames)
    assert out["recon"].y.shape == clip.y.shape
    assert float(out["psnr_y"]) > 33.0


def test_closed_loop_gop(rng):
    clip = _yuv_clip(rng, 4, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    out = encode_gop_closed_loop(clip.y, cfg, 4)
    assert out["recon"].shape == (4, 128, 128)  # I frame + 3 P frames
    # closed-loop quality should not collapse over the chain
    psnrs = np.asarray(out["psnr_db"])
    assert psnrs.min() > 35.0


def test_closed_loop_gop_yuv(rng):
    """Closed-loop YUV GOP == the per-frame chain on reconstructions,
    bit-exact, and conforming quality over the chain."""
    import jax

    from hevcasm_tpu.encode.video import (
        encode_gop_closed_loop_yuv, encode_intra_frame_yuv)
    from hevcasm_tpu.encode.intra_wavefront import encode_intra_frame_wavefront
    from hevcasm_tpu.encode.video import _chroma_cfg, _residual_pipeline

    clip = _yuv_clip(rng, 4, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    out = encode_gop_closed_loop_yuv(clip, cfg)
    assert out["recon"].y.shape == clip.y.shape
    assert out["recon"].cb.shape == clip.cb.shape
    assert np.asarray(out["psnr_y"])[1:].min() > 35.0

    # Reference chain: wavefront-intra seed + per-frame closed-loop calls.
    from hevcasm_tpu.encode import ctu as ctu_mod
    import jax.numpy as jnp

    intra_y = encode_intra_frame_wavefront(clip.y[0], cfg)

    from hevcasm_tpu.encode.video import _chroma_intra_plane

    prev = YuvFrame(intra_y["recon"],
                    _chroma_intra_plane(clip.cb[0], cfg)[0],
                    _chroma_intra_plane(clip.cr[0], cfg)[0])
    np.testing.assert_array_equal(np.asarray(out["recon"].y[0]), np.asarray(prev.y))
    for t in range(1, 4):
        step = encode_inter_frame_yuv(
            YuvFrame(clip.y[t], clip.cb[t], clip.cr[t]), prev, cfg)
        prev = step["recon"]
        for plane in ("y", "cb", "cr"):
            np.testing.assert_array_equal(
                np.asarray(getattr(out["recon"], plane)[t]),
                np.asarray(getattr(prev, plane)), err_msg=f"t={t} {plane}")


def test_closed_loop_gop_yuv_b(rng):
    # IBPBP closed loop: display order I B P B P, every P from the previous
    # P/I recon, every B from the two surrounding recons; the scan program
    # must equal the per-frame composition in the same encode order.
    from hevcasm_tpu.encode.video import encode_gop_closed_loop_yuv_b

    clip = _yuv_clip(rng, 5, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=30)
    out = encode_gop_closed_loop_yuv_b(clip, cfg)
    assert out["recon"].y.shape == clip.y.shape
    assert np.asarray(out["psnr_y"])[1:].min() > 35.0

    def at(t):
        return YuvFrame(clip.y[t], clip.cb[t], clip.cr[t])

    def rec_at(t):
        return YuvFrame(out["recon"].y[t], out["recon"].cb[t],
                        out["recon"].cr[t])

    prev = rec_at(0)  # the wavefront-intra seed the program produced
    for k in range(2):
        tb, tp = 2 * k + 1, 2 * k + 2
        stepp = encode_inter_frame_yuv(at(tp), prev, cfg)
        stepb = encode_b_frame_yuv(at(tb), prev, stepp["recon"], cfg)
        for t, step in ((tp, stepp), (tb, stepb)):
            for plane in ("y", "cb", "cr"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(out["recon"], plane)[t]),
                    np.asarray(getattr(step["recon"], plane)),
                    err_msg=f"t={t} {plane}")
        prev = stepp["recon"]


def test_yuv_rdo_config_raises(rng):
    # The YUV entry points run the fixed geometry via loop._inter_core;
    # a requested RDO decision must fail loudly, not be silently dropped.
    clip = _yuv_clip(rng, 2, 128, 128)
    cur = YuvFrame(clip.y[1], clip.cb[1], clip.cr[1])
    ref = YuvFrame(clip.y[0], clip.cb[0], clip.cr[0])
    cfg = EncodeConfig(search_range=8, qp=30, pu_decision=True)
    with pytest.raises(ValueError, match="fixed CTU/TU geometry"):
        encode_inter_frame_yuv(cur, ref, cfg)
