"""The XLA path that the encoder runs on every backend, checked bit-exactly
against the REF tier and the scalar oracles at the geometries of the
integer search, motion compensation, residual and refinement stages, and
end to end: the default (XLA) configuration against the all-REF one."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hevcasm_tpu import ops, registry
from hevcasm_tpu.config import Tier
from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode import ctu as ctu_mod, motion, partition
from hevcasm_tpu.encode.loop import (
    encode_inter_frame, encode_inter_frame_multiref, _residual_pipeline)
from hevcasm_tpu.kernels.interp_xla import (
    refine_qpel_costmap_mxu, refine_quarter_pel_mxu)
from hevcasm_tpu.kernels.xla_opt import ssd_grid, ssd_grid_ref
import oracles


def _ref_cfg(cfg):
    return dataclasses.replace(cfg, refine_impl="ref", residual_impl="ref")


def _smooth(rng, h, w):
    a = rng.integers(0, 256, (h, w)).astype(np.float32)
    for _ in range(2):
        a = (np.roll(a, 1, 0) + a + np.roll(a, -1, 0)) / 3
        a = (np.roll(a, 1, 1) + a + np.roll(a, -1, 1)) / 3
    return np.clip(a, 0, 255).astype(np.uint8)


def _assert_outputs_equal(a, b, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# --- integer search: xla_opt.ssd_grid vs the REF scan ---------------------


@pytest.mark.parametrize("b,r", [(16, 8), (16, 4), (32, 12), (64, 32)])
def test_ssd_grid_block_sizes(rng, b, r):
    n, num, size = 3, 2 * r + 1, b + 2 * r
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (n, size, size), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(ssd_grid(src, win, num, num)),
                                  np.asarray(ssd_grid_ref(src, win, num, num)))


def _content(kind, rng, shape):
    if kind == "zeros":
        return np.zeros(shape, np.uint8)
    if kind == "full":
        return np.full(shape, 255, np.uint8)
    if kind == "checker":
        yy, xx = np.indices(shape[-2:])
        return np.broadcast_to(((yy + xx) % 2 * 255).astype(np.uint8), shape).copy()
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("b,r", [(16, 8), (32, 16), (64, 32)])
@pytest.mark.parametrize("src_kind,win_kind", [
    ("zeros", "full"),      # the largest SSD every candidate can reach
    ("full", "full"),       # the largest correlation and energy terms
    ("checker", "checker"),  # alternating extremes: exact zero and max terms
    ("random", "full"),
])
def test_ssd_grid_extreme_content(rng, b, r, src_kind, win_kind):
    """The bf16/f32 exactness argument at the sample extremes."""
    n, num, size = 2, 2 * r + 1, b + 2 * r
    src = _content(src_kind, rng, (n, b, b))
    win = _content(win_kind, rng, (n, size, size))
    np.testing.assert_array_equal(np.asarray(ssd_grid(src, win, num, num)),
                                  np.asarray(ssd_grid_ref(src, win, num, num)))


@pytest.mark.parametrize("b,ndy,ndx", [
    (64, 65, 65), (64, 9, 17), (32, 33, 33), (16, 5, 9), (8, 17, 3)])
def test_ssd_grid_asymmetric_grids(rng, b, ndy, ndx):
    n = 2
    src = rng.integers(0, 256, (n, b, b), dtype=np.uint8)
    win = rng.integers(0, 256, (n, b + ndy - 1, b + ndx - 1), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(ssd_grid(src, win, ndy, ndx)),
                                  np.asarray(ssd_grid_ref(src, win, ndy, ndx)))


@pytest.mark.parametrize("base", [8, 16, 32])
def test_base_grids_match_per_block_search(rng, base):
    """partition.base_grid_search at +-32 == independent REF searches of
    every sub-block over its slice of the CTU window."""
    n, r = 2, 32
    src = jnp.asarray(rng.integers(0, 256, (n, 64, 64), dtype=np.uint8))
    win = jnp.asarray(rng.integers(0, 256, (n, 128, 128), dtype=np.uint8))
    k = 64 // base
    got = np.asarray(partition.base_grid_search(src, win, r, ssd_grid, base))
    srcb = ctu_mod.split_blocks(src, base)
    wsub = base + 2 * r
    slabs = [win[:, base * i : base * i + wsub, base * j : base * j + wsub]
             for i in range(k) for j in range(k)]
    winb = jnp.stack(slabs, axis=1).reshape(n * k * k, wsub, wsub)
    want = np.asarray(ssd_grid_ref(srcb, winb, 65, 65)).reshape(n, k, k, 65, 65)
    np.testing.assert_array_equal(got, want)


def _search_setup(rng, gr, gc, r):
    h, w = gr * 64, gc * 64
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    pad = ctu_mod.pad_frame(jnp.asarray(ref), r + motion.PAD_L, r + motion.PAD_R,
                            r + motion.PAD_L, r + motion.PAD_R)
    return src, pad, motion.ctu_positions(gr, gc, 64)


def test_full_search_aligned_windows_at_r32(rng):
    """The reshape-stitched window path at the 1080p geometry (+-32, 64x64)
    == the per-CTU gather path."""
    src, pad, pos = _search_setup(rng, 2, 4, 32)
    a = motion.full_search(src, pad, pos, 32, grid_fn=ssd_grid, grid=(2, 4))
    b = motion.full_search(src, pad, pos, 32, grid_fn=ssd_grid, grid=None)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_full_search_xla_matches_ref_grid(rng):
    src, pad, pos = _search_setup(rng, 3, 4, 32)
    a = motion.full_search(src, pad, pos, 32, grid_fn=ssd_grid, grid=(3, 4))
    b = motion.full_search(src, pad, pos, 32, grid_fn=ssd_grid_ref, grid=(3, 4))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_full_search_multi_matches_per_plane(rng):
    """k reference planes in one batched grid call == k single searches."""
    gr, gc, r, k = 2, 2, 32, 3
    src, pad0, pos = _search_setup(rng, gr, gc, r)
    planes = jnp.stack([pad0] + [
        ctu_mod.pad_frame(jnp.asarray(rng.integers(0, 256, (gr * 64, gc * 64),
                                                   dtype=np.uint8)),
                          r + 3, r + 4, r + 3, r + 4) for _ in range(k - 1)])
    mv, best = motion.full_search_multi(src, planes, pos, r, grid_fn=ssd_grid,
                                        grid=(gr, gc), joint=False)
    for p in range(k):
        mv1, best1 = motion.full_search(src, planes[p], pos, r, grid_fn=ssd_grid_ref,
                                        grid=(gr, gc))
        np.testing.assert_array_equal(np.asarray(mv[p]), np.asarray(mv1))
        np.testing.assert_array_equal(np.asarray(best[p]), np.asarray(best1))


def test_registry_picks_xla_ssd_grid():
    assert registry.get("ssd_grid") is ssd_grid
    assert registry.get("ssd_grid", Tier.REF) is ssd_grid_ref
    assert motion.grid_metric_fn("ssd") is ssd_grid


# --- motion compensation: the registry's JIT tier vs the scalar oracle ----


@pytest.mark.parametrize("wh", [(64, 64), (32, 16), (16, 16), (8, 4)])
def test_pred_uni_jit_tier_matches_oracle(rng, wh):
    w, h = wh
    fn = registry.get_tier("pred_uni", Tier.JIT)
    win = rng.integers(0, 256, (h + 7, w + 7), dtype=np.uint8)
    for (xf, yf) in [(0, 0), (1, 0), (0, 1), (2, 3)]:
        np.testing.assert_array_equal(np.asarray(fn(win, xf, yf, 8)),
                                      oracles.pred_uni(win, w, h, xf, yf, 8),
                                      err_msg=f"{wh} ({xf},{yf})")


def test_pred_uni_traced_fractions_per_block(rng):
    win = rng.integers(0, 256, (5, 39, 39), dtype=np.uint8)
    xfs = rng.integers(0, 4, (5,)).astype(np.int32)
    yfs = rng.integers(0, 4, (5,)).astype(np.int32)
    got = np.asarray(ops.pred_uni(jnp.asarray(win), jnp.asarray(xfs), jnp.asarray(yfs)))
    for i in range(5):
        np.testing.assert_array_equal(
            got[i], oracles.pred_uni(win[i], 32, 32, int(xfs[i]), int(yfs[i]), 8))


@pytest.mark.parametrize("wh", [(32, 32), (16, 8), (4, 2)])
def test_pred_uni_chroma_jit_tier_matches_oracle(rng, wh):
    """4-tap chroma eighth-pel family, all 8 phases reachable."""
    w, h = wh
    fn = registry.get_tier("pred_uni", Tier.JIT)
    win = rng.integers(0, 256, (h + 3, w + 3), dtype=np.uint8)
    for (xf, yf) in [(0, 0), (1, 0), (0, 7), (5, 3)]:
        np.testing.assert_array_equal(np.asarray(fn(win, xf, yf, 4)),
                                      oracles.pred_uni(win, w, h, xf, yf, 4),
                                      err_msg=f"{wh} ({xf},{yf})")


@pytest.mark.parametrize("taps,fr", [(4, (1, 6, 3, 2)), (8, (1, 2, 3, 1))])
def test_pred_bi_jit_tier_matches_oracle(rng, taps, fr):
    n = 16 if taps == 4 else 32
    fn = registry.get_tier("pred_bi", Tier.JIT)
    w0 = rng.integers(0, 256, (n + taps - 1, n + taps - 1), dtype=np.uint8)
    w1 = rng.integers(0, 256, (n + taps - 1, n + taps - 1), dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(fn(w0, w1, *fr, taps)),
                                  oracles.pred_bi(w0, w1, n, n, *fr, taps))


def test_registry_tiers_are_ref_and_jit():
    assert Tier.ALL == Tier.REF | Tier.JIT
    for op in registry.ops():
        assert registry.get_tier(op, Tier.REF) is not None, op
        assert registry.get_tier(op, Tier.JIT) is not None, op


@pytest.mark.parametrize("op", ["sad", "sad_multiref", "sad_grid"])
def test_sad_jit_tier_matches_ref(rng, op):
    a = rng.integers(0, 256, (3, 8, 8), dtype=np.uint8)
    if op == "sad":
        args = (a, rng.integers(0, 256, (3, 8, 8), dtype=np.uint8))
    elif op == "sad_multiref":
        args = (a, rng.integers(0, 256, (3, 4, 8, 8), dtype=np.uint8))
    else:
        args = (a, rng.integers(0, 256, (3, 12, 12), dtype=np.uint8), 5, 5)
    np.testing.assert_array_equal(
        np.asarray(registry.get_tier(op, Tier.JIT)(*args)),
        np.asarray(registry.get_tier(op, Tier.REF)(*args)))


# --- residual: the frame pipeline vs the per-TU REF composition -----------


@pytest.mark.parametrize("qp", [4, 27, 45])
def test_frame_residual_across_qps(rng, qp):
    src = jnp.asarray(rng.integers(0, 256, (2, 64, 64), dtype=np.uint8))
    pred = jnp.asarray(rng.integers(0, 256, (2, 64, 64), dtype=np.uint8))
    a = _residual_pipeline(src, pred, EncodeConfig(qp=qp), intra=False)
    b = _residual_pipeline(src, pred, EncodeConfig(qp=qp, residual_impl="ref"),
                           intra=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("tu", [4, 8, 16, 32])
def test_frame_residual_intra_quant(rng, tu):
    """Intra rounding offset at every TU size (DST-VII at 4x4 luma)."""
    src = jnp.asarray(rng.integers(0, 256, (3, 64, 64), dtype=np.uint8))
    pred = jnp.asarray(rng.integers(0, 256, (3, 64, 64), dtype=np.uint8))
    a = _residual_pipeline(src, pred, EncodeConfig(tu=tu), intra=True)
    b = _residual_pipeline(src, pred, EncodeConfig(tu=tu, residual_impl="ref"),
                           intra=True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- quarter-pel refinement ---------------------------------------------


def _ref_costmap(src, win):
    """REF costs of the 16 fractions: jnp FIR accumulators + qpel_score."""
    from hevcasm_tpu.ops.pred_inter import _hv, qpel_score

    return jnp.stack([qpel_score(_hv(win, xf, yf, 8), src)
                      for yf in range(4) for xf in range(4)], axis=1)


@pytest.mark.parametrize("b", [16, 32, 64])
def test_costmap_xla_matches_ref(rng, b):
    n = 5
    src = jnp.asarray(rng.integers(0, 256, (n, b, b), dtype=np.uint8))
    win = jnp.asarray(rng.integers(0, 256, (n, b + 7, b + 7), dtype=np.uint8))
    preds, costs = refine_qpel_costmap_mxu(src, win)
    np.testing.assert_array_equal(np.asarray(costs), np.asarray(_ref_costmap(src, win)))
    np.testing.assert_array_equal(
        np.asarray(preds[:, 6]), np.asarray(ops.pred_uni(win, 2, 1)))


def test_refine_xla_matches_ref_at_random_mvs(rng):
    n, b, r = 4, 64, 4
    src = jnp.asarray(rng.integers(0, 256, (n, b, b), dtype=np.uint8))
    plane = jnp.asarray(rng.integers(0, 256, (2 * b + 2 * r + 8,) * 2, dtype=np.uint8))
    pos = motion.ctu_positions(2, 2, b)
    mv = jnp.asarray(rng.integers(-r, r + 1, (n, 2)), jnp.int32)
    want_pred, want_mvq, win = motion.refine_quarter_pel(src, plane, pos, mv, r)
    pred, frac, _ = refine_quarter_pel_mxu(src, win)
    np.testing.assert_array_equal(np.asarray(pred), np.asarray(want_pred))
    np.testing.assert_array_equal(
        np.asarray(mv * 4 + jnp.stack([frac // 4, frac % 4], -1)), np.asarray(want_mvq))


# --- end to end: default (XLA) configuration vs all-REF ------------------


@pytest.mark.parametrize("h,w,r,qp,shift", [
    (128, 192, 8, 32, (5, 7)),     # the staged geometry
    (128, 128, 16, 32, (16, 16)),  # motion at the +R corner of the window
    (192, 256, 32, 32, (3, -5)),   # the +-32 production range
    (128, 128, 4, 4, (0, 0)),      # static scene, near-lossless qp
    (128, 192, 8, 37, (-2, 9)),
])
def test_encode_default_matches_ref_config(rng, h, w, r, qp, shift):
    m = r + 16
    base = _smooth(rng, h + 2 * m, w + 2 * m)
    dy, dx = shift
    ref = base[m : m + h, m : m + w]
    cur = base[m + dy : m + dy + h, m + dx : m + dx + w]
    cfg = EncodeConfig(search_range=r, qp=qp)
    a = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    b = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), _ref_cfg(cfg))
    _assert_outputs_equal(a, b, ("recon", "mvs", "sad", "nnz"))


def test_encode_sad_metric_matches_ref_config(rng):
    base = _smooth(rng, 160, 224)
    cfg = EncodeConfig(search_range=8, qp=30, me_metric="sad")
    args = (jnp.asarray(base[3:131, 5:197]), jnp.asarray(base[:128, :192]))
    _assert_outputs_equal(encode_inter_frame(*args, cfg),
                          encode_inter_frame(*args, _ref_cfg(cfg)),
                          ("recon", "mvs", "sad", "nnz"))


def test_multiref_default_matches_ref_config(rng):
    h, w = 128, 192
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    cur = base[5 : 5 + h, 7 : 7 + w]
    refs = np.stack([base[:h, :w], base[9 : 9 + h, 2 : 2 + w],
                     base[1 : 1 + h, 11 : 11 + w]])
    cfg = EncodeConfig(search_range=8)
    a = encode_inter_frame_multiref(jnp.asarray(cur), jnp.asarray(refs), cfg)
    b = encode_inter_frame_multiref(jnp.asarray(cur), jnp.asarray(refs), _ref_cfg(cfg))
    _assert_outputs_equal(a, b, ("recon", "mvs", "ref_idx", "nnz"))


def _yuv(rng, t, h, w):
    from hevcasm_tpu.encode.video import YuvFrame

    y = _smooth(rng, h + 4 * t, w + 4 * t)
    c = _smooth(rng, h // 2 + 2 * t, w // 2 + 2 * t)
    frames = [YuvFrame(jnp.asarray(y[2 * i : 2 * i + h, 3 * i : 3 * i + w]),
                       jnp.asarray(c[i : i + h // 2, i : i + w // 2]),
                       jnp.asarray(255 - c[i : i + h // 2, i : i + w // 2]))
              for i in range(t)]
    return frames


def test_yuv_p_frame_default_matches_ref_config(rng):
    from hevcasm_tpu.encode.video import encode_inter_frame_yuv

    f = _yuv(rng, 2, 128, 192)
    cfg = EncodeConfig(search_range=8, qp=27)
    a = encode_inter_frame_yuv(f[1], f[0], cfg)
    b = encode_inter_frame_yuv(f[1], f[0], _ref_cfg(cfg))
    for plane in ("y", "cb", "cr"):
        np.testing.assert_array_equal(np.asarray(getattr(a["recon"], plane)),
                                      np.asarray(getattr(b["recon"], plane)))
    _assert_outputs_equal(a, b, ("mvs", "nnz"))


def test_b_frame_default_matches_ref_config(rng):
    from hevcasm_tpu.encode.video import encode_b_frame_yuv

    f = _yuv(rng, 3, 128, 192)
    cfg = EncodeConfig(search_range=8, qp=30)
    a = encode_b_frame_yuv(f[1], f[0], f[2], cfg)
    b = encode_b_frame_yuv(f[1], f[0], f[2], _ref_cfg(cfg))
    for plane in ("y", "cb", "cr"):
        np.testing.assert_array_equal(np.asarray(getattr(a["recon"], plane)),
                                      np.asarray(getattr(b["recon"], plane)))
    _assert_outputs_equal(a, b, ("mvs0", "mvs1", "nnz"))


@pytest.mark.parametrize("b_frames", [False, True])
def test_rate_controlled_gop_default_matches_ref_config(rng, b_frames):
    from hevcasm_tpu.encode.rate import encode_gop_rate_controlled

    frames = jnp.stack([f.y for f in _yuv(rng, 5, 128, 128)])
    cfg = EncodeConfig(search_range=8)
    a = encode_gop_rate_controlled(frames, 6000.0, 32, cfg, b_frames=b_frames)
    b = encode_gop_rate_controlled(frames, 6000.0, 32, _ref_cfg(cfg),
                                   b_frames=b_frames)
    _assert_outputs_equal(a, b, ("recon", "bits", "qp"))


def test_rate_controlled_b_gop_out_of_range_qp_raises(rng):
    from hevcasm_tpu.encode.rate import encode_gop_rate_controlled

    frames = jnp.stack([f.y for f in _yuv(rng, 3, 128, 128)])
    with pytest.raises(Exception, match="outside"):
        encode_gop_rate_controlled(frames, 6000.0, 60, EncodeConfig(search_range=8),
                                   qp_min=55, qp_max=70, b_frames=True)


@pytest.mark.parametrize("content", ["random", "smooth"])
def test_spatial_sharding_matches_ref_config(rng, content):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hevcasm_tpu.parallel import encode_inter_frame_spatial, make_mesh

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    h, w = 256, 128
    if content == "smooth":
        base = _smooth(rng, h + 8, w + 8)
        cur, ref = base[3 : 3 + h, 2 : 2 + w], base[:h, :w]
    else:
        cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
        ref = rng.integers(0, 256, (h, w), dtype=np.uint8)
    cfg = EncodeConfig(search_range=4, qp=32)
    mesh = make_mesh(frames=1, rows=2, devices=jax.devices()[:2])
    sh = NamedSharding(mesh, P("rows", None))
    out = encode_inter_frame_spatial(jax.device_put(jnp.asarray(cur), sh),
                                     jax.device_put(jnp.asarray(ref), sh), mesh, cfg)
    single = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), _ref_cfg(cfg))
    _assert_outputs_equal(out, single, ("recon", "sad", "nnz"))


# --- PU decision at the production search range ---------------------------


def _pu_setup(rng, r=32):
    h, w = 128, 192
    base = rng.integers(0, 256, (h + 80, w + 80), dtype=np.uint8)
    cur, ref = base[5 : 5 + h, 7 : 7 + w], base[:h, :w]
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    rp = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    pos = motion.ctu_positions(h // 64, w // 64, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)
    return src, rp, pos, win


@pytest.mark.parametrize("layouts", [
    ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter"),
    ("2Nx2N", "NxN", "eighth"),
])
def test_pruned_pu_selection_matches_full_at_r32(rng, layouts):
    src, rp, pos, win = _pu_setup(rng)
    lam = partition.mv_lambda(32)
    pred_f, choice_f, _, best_f = partition.select_pu_layout(
        src, rp, pos, win, 32, lam, layouts, ssd_grid)
    pred_p, choice_p, _, best_p = partition.select_pu_layout_pruned(
        src, rp, pos, win, 32, lam, layouts, ssd_grid)
    for x, y in ((pred_f, pred_p), (choice_f, choice_p), (best_f, best_p)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pu_decision_xla_grids_match_ref_grids(rng):
    src, rp, pos, win = _pu_setup(rng)
    layouts = EncodeConfig().pu_layouts
    lam = partition.mv_lambda(32)
    a = partition.select_pu_layout_pruned(src, rp, pos, win, 32, lam, layouts, ssd_grid)
    b = partition.select_pu_layout_pruned(src, rp, pos, win, 32, lam, layouts,
                                          ssd_grid_ref)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# --- configuration --------------------------------------------------------


@pytest.mark.parametrize("field,value", [
    ("refine_impl", "mxu"), ("residual_impl", "fused"), ("me_metric", "satd")])
def test_config_rejects_unknown_impls(field, value):
    with pytest.raises(ValueError, match=field):
        EncodeConfig(**{field: value})


def test_config_has_no_backend_selection_fields():
    names = {f.name for f in dataclasses.fields(EncodeConfig)}
    assert not names & {"inter_impl", "search_impl", "fused_group", "fused_refine"}
