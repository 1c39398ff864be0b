"""End-to-end encode inner loop: tiling round-trips, motion search finds
planted motion, quarter-pel refinement, full frame encode quality."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode import ctu as ctu_mod
from hevcasm_tpu.encode import motion
from hevcasm_tpu.encode import EncodeConfig, encode_gop
from hevcasm_tpu.encode.loop import encode_inter_frame, encode_intra_frame


def test_tile_untile_roundtrip(rng):
    f = rng.integers(0, 256, (128, 192), dtype=np.uint8)
    t = ctu_mod.tile_frame(jnp.asarray(f), 64)
    assert t.shape == (6, 64, 64)
    # row-major CTU order
    np.testing.assert_array_equal(np.asarray(t[1]), f[:64, 64:128])
    np.testing.assert_array_equal(np.asarray(ctu_mod.untile_frame(t, 128, 192)), f)


def test_split_merge_blocks(rng):
    b = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    s = ctu_mod.split_blocks(jnp.asarray(b), 8)
    assert s.shape == (12, 8, 8)
    np.testing.assert_array_equal(np.asarray(s[1]), b[0, :8, 8:])
    np.testing.assert_array_equal(np.asarray(ctu_mod.merge_blocks(s, 16)), b)


def test_full_search_finds_planted_motion(rng):
    """Current frame is the reference shifted by (+3, -5): every CTU's MV
    must come back (3, -5).  Both frames are cropped from a larger base so
    every candidate window's true content exists (no edge replication in the
    matched region)."""
    h, w, r = 128, 128, 8
    m = r + motion.PAD_R  # margin so the hand-built padded ref stays in base
    base = rng.integers(0, 256, (h + 2 * m, w + 2 * m), dtype=np.uint8)
    dy, dx = 3, -5
    cur = base[m + dy : m + dy + h, m + dx : m + dx + w]
    # padded ref exactly as pad_frame would lay it out, but with real content:
    # padded[y + r + PAD_L, x + r + PAD_L] == ref[y, x] == base[m + y, m + x]
    ref_padded = base[
        m - r - motion.PAD_L : m + h + r + motion.PAD_R,
        m - r - motion.PAD_L : m + w + r + motion.PAD_R,
    ]
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    pos = motion.ctu_positions(2, 2, 64)
    mv, sad = motion.full_search(src, jnp.asarray(ref_padded), pos, r)
    np.testing.assert_array_equal(np.asarray(sad), np.zeros(4, np.int32))
    np.testing.assert_array_equal(np.asarray(mv), np.tile([dy, dx], (4, 1)))


def test_aligned_windows_match_gather(rng):
    """The reshape-based aligned-window extractor (active when the window
    span is a multiple of the tile, e.g. the r=32/b=64 bench config) must be
    bit-identical to the dynamic-slice gather path."""
    plane = rng.integers(0, 256, (200, 264), dtype=np.uint8)
    for tile, gr, gc, k in [(16, 4, 6, 2), (64, 2, 3, 2), (16, 3, 5, 3)]:
        size = k * tile
        oy, ox = 5, 7
        pos = motion.ctu_positions(gr, gc, tile) + jnp.asarray([oy, ox])
        want = motion.extract_windows(jnp.asarray(plane), pos, size)
        got = motion.extract_aligned_windows(
            jnp.asarray(plane), (oy, ox), (gr, gc), tile, size
        )
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_full_search_aligned_grid_matches_gather(rng):
    """full_search with grid= (aligned extractor active at r=8, b=16) must
    return identical MVs/scores to the per-CTU gather path."""
    h = w = 64
    r = 8  # b=16: size = 32 = 2*b -> aligned path taken
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref_padded = ctu_mod.pad_frame(
        jnp.asarray(ref), r + motion.PAD_L, r + motion.PAD_R, r + motion.PAD_L, r + motion.PAD_R
    )
    src = ctu_mod.tile_frame(jnp.asarray(cur), 16)
    pos = motion.ctu_positions(4, 4, 16)
    mv_a, sad_a = motion.full_search(src, ref_padded, pos, r, grid=(4, 4))
    mv_g, sad_g = motion.full_search(src, ref_padded, pos, r, grid=None)
    np.testing.assert_array_equal(np.asarray(mv_a), np.asarray(mv_g))
    np.testing.assert_array_equal(np.asarray(sad_a), np.asarray(sad_g))


def test_refine_quarter_pel_zero_frac_is_copy(rng):
    """With a perfect integer match the best fraction must be (0,0) and the
    prediction the exact reference block."""
    h = w = 64
    r = 4
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cur = ref.copy()
    ref_padded = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    pos = motion.ctu_positions(1, 1, 64)
    mv = jnp.zeros((1, 2), jnp.int32)
    pred, mv_q, _ = motion.refine_quarter_pel(src, ref_padded, pos, mv, r)
    np.testing.assert_array_equal(np.asarray(pred[0]), ref)
    np.testing.assert_array_equal(np.asarray(mv_q), [[0, 0]])


def _moving_clip(rng, t, h, w, dy=2, dx=3):
    base = rng.integers(0, 256, (h + t * abs(dy) + 8, w + t * abs(dx) + 8), dtype=np.uint8)
    # Smooth the texture so sub-pel interpolation and transforms see natural
    # content rather than white noise.
    k = np.ones((3, 3)) / 9.0
    sm = base.astype(np.float32)
    for _ in range(2):
        sm = (
            np.roll(sm, 1, 0) + sm + np.roll(sm, -1, 0)
        ) / 3.0
        sm = (
            np.roll(sm, 1, 1) + sm + np.roll(sm, -1, 1)
        ) / 3.0
    base = np.clip(sm, 0, 255).astype(np.uint8)
    return np.stack([base[i * dy : i * dy + h, i * dx : i * dx + w] for i in range(t)])


def test_encode_inter_frame_quality(rng):
    """Encoding a shifted frame must (a) recover the global motion, (b)
    reconstruct with high PSNR at moderate qp."""
    frames = _moving_clip(rng, 2, 128, 192)
    cfg = EncodeConfig(search_range=8, qp=27)
    out = encode_inter_frame(jnp.asarray(frames[1]), jnp.asarray(frames[0]), cfg)
    mvs = np.asarray(out["mvs"])
    # global pan (dy=2, dx=3) in quarter-pel units = (8, 12)
    assert (mvs == [8, 12]).all(axis=-1).mean() > 0.8
    assert float(out["psnr_db"]) > 38.0
    assert out["recon"].shape == frames[1].shape


def test_encode_intra_frame(rng):
    frames = _moving_clip(rng, 1, 128, 128)
    cfg = EncodeConfig(qp=27)
    out = encode_intra_frame(jnp.asarray(frames[0]), cfg)
    assert out["recon"].shape == (128, 128)
    # smooth content intra-predicts decently; the TU pipeline must not break
    assert float(out["psnr_db"]) > 30.0


def test_encode_gop(rng):
    frames = _moving_clip(rng, 3, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=27)
    out = encode_gop(jnp.asarray(frames), cfg)
    assert out["recon"].shape == frames.shape
    assert float(out["psnr_db"]) > 33.0


def test_encode_lossless_when_static(rng):
    """A static scene at low qp: P frame should reconstruct near-perfectly
    (motion search finds the exact block, residual ~ 0)."""
    f = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    cfg = EncodeConfig(search_range=4, qp=4)
    out = encode_inter_frame(jnp.asarray(f), jnp.asarray(f), cfg)
    np.testing.assert_array_equal(np.asarray(out["recon"]), f)


def test_encode_gop_fast_path_matches_stages(rng):
    """The full GOP (wavefront intra seed + P chain) with the default
    (XLA) stages equals the all-REF configuration bit-exactly — the
    production configuration is the verified one."""
    import dataclasses

    h, w = 128, 192
    base = rng.integers(0, 256, (3, h + 16, w + 16), dtype=np.uint8)
    frames = np.stack([base[t, t : t + h, 2 * t : 2 * t + w] for t in range(3)])
    cfg_f = EncodeConfig(search_range=8, qp=32, intra_mode="wavefront")
    cfg_s = dataclasses.replace(cfg_f, refine_impl="ref", residual_impl="ref")
    out_s = encode_gop(jnp.asarray(frames), cfg_s)
    out_f = encode_gop(jnp.asarray(frames), cfg_f)
    np.testing.assert_array_equal(
        np.asarray(out_s["recon"]), np.asarray(out_f["recon"])
    )
