"""Variable block structure: PU-size decision and TU-size selection."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode import ctu as ctu_mod, motion, partition
from hevcasm_tpu.encode.loop import encode_inter_frame
from hevcasm_tpu.ops.sad import sad_grid
from hevcasm_tpu.kernels.xla_opt import ssd_grid


@pytest.fixture
def frames(rng):
    h, w = 128, 192
    base = rng.integers(0, 256, (h + 40, w + 40), dtype=np.uint8)
    cur = base[5 : 5 + h, 7 : 7 + w]
    ref = base[:h, :w]
    return cur, ref


def test_grid_additivity_vs_ctu_search(frames, rng):
    """The 16x16-aggregated 64-level grid must equal the direct CTU search:
    same best SSD and same argmin MV."""
    cur, ref = frames
    h, w = cur.shape
    r = 8
    gr, gc = h // 64, w // 64
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    rp = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    pos = motion.ctu_positions(gr, gc, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)

    search = partition.multi_level_search(src, win, r, ssd_grid)
    mv_d, best_d = motion.full_search(src, rp, pos, r, grid_fn=ssd_grid)
    assert np.array_equal(np.asarray(search["best64"]), np.asarray(best_d))
    assert np.array_equal(np.asarray(search["mv64"]), np.asarray(mv_d))


def test_sub_pu_grids_match_independent_search(frames):
    """Each 16x16 sub-block's grid equals an independent search of that
    sub-block over the equivalent window."""
    cur, ref = frames
    r = 8
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    rp = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    gr, gc = cur.shape[0] // 64, cur.shape[1] // 64
    pos = motion.ctu_positions(gr, gc, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)
    search = partition.multi_level_search(src, win, r, ssd_grid)

    # independent: sub-block (1, 2) of CTU 0
    i, j = 1, 2
    sub = np.asarray(src[0, 16 * i : 16 * i + 16, 16 * j : 16 * j + 16])
    wsub = np.asarray(win[0, 16 * i : 16 * i + 16 + 2 * r,
                          16 * j : 16 * j + 16 + 2 * r])
    g = np.asarray(ssd_grid(jnp.asarray(sub)[None], jnp.asarray(wsub)[None],
                            2 * r + 1, 2 * r + 1))[0]
    best = g.reshape(-1).min()
    assert int(search["best16"][0, i, j]) == int(best)


def test_pu_decision_end_to_end(frames):
    cur, ref = frames
    cfg = EncodeConfig(search_range=8, qp=32, pu_decision=True)
    out = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    assert out["recon"].shape == cur.shape
    lv = np.asarray(out["pu_layout"])
    assert lv.shape == (6,) and set(np.unique(lv)) <= set(range(len(cfg.pu_layouts)))
    assert float(out["psnr_db"]) > 25.0


def test_pu_decision_with_eighth_and_amp(frames):
    """The extended ladder: 8x8 PUs (base-8 search) and the rectangular
    2NxN / Nx2N splits compose end-to-end."""
    cur, ref = frames
    cfg = EncodeConfig(
        search_range=8, qp=32, pu_decision=True,
        pu_layouts=("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter", "eighth"),
    )
    out = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    assert out["recon"].shape == cur.shape
    lv = np.asarray(out["pu_layout"])
    assert set(np.unique(lv)) <= set(range(6))
    assert float(out["psnr_db"]) > 25.0


def test_rect_grid_matches_independent_search(frames):
    """A rectangular (64x32 top) PU's aggregated grid equals an
    independent direct search of that rectangle."""
    cur, ref = frames
    r = 8
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    rp = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    gr, gc = cur.shape[0] // 64, cur.shape[1] // 64
    pos = motion.ctu_positions(gr, gc, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)
    g = partition.base_grid_search(src, win, r, ssd_grid, 16)
    gint = partition.grid_integral(g)
    got = np.asarray(partition.rect_grid(gint, (0, 0, 32, 64), 16))[0]

    sub = np.asarray(src[0, :32, :])                 # top 64x32 (h=32, w=64)
    wsub = np.asarray(win[0, : 32 + 2 * r, :])
    num = 2 * r + 1
    want = np.zeros((num, num), np.int64)
    for dy in range(num):
        for dx in range(num):
            d = sub.astype(np.int64) - wsub[dy : dy + 32, dx : dx + 64]
            want[dy, dx] = (d * d).sum()
    assert np.array_equal(got, want)


def test_amp_chosen_for_split_motion(rng):
    """Top and bottom halves moving differently should make the 2NxN
    layout beat 2Nx2N (and be chosen over NxN by the rate term)."""
    h, w = 64, 64
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    ref = base[8 : 8 + h, 8 : 8 + w]
    cur = np.zeros((h, w), np.uint8)
    cur[:32] = base[8 + 4 : 8 + 32 + 4, 8 + 2 : 8 + w + 2]     # top: (4, 2)
    cur[32:] = base[8 + 32 - 5 : 8 + h - 5, 8 - 3 : 8 + w - 3] # bottom: (-5, -3)
    cfg = EncodeConfig(search_range=8, qp=32, pu_decision=True)
    out = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    assert cfg.pu_layouts[int(out["pu_layout"][0])] == "2NxN"
    assert float(out["psnr_db"]) > 35.0


def test_pu_decision_picks_small_pus_for_divergent_motion(rng):
    """A frame whose four 32x32 quadrants move in different directions
    should prefer sub-CTU partitions."""
    h, w = 64, 64
    base = rng.integers(0, 256, (h + 32, w + 32), dtype=np.uint8)
    ref = base[8 : 8 + h, 8 : 8 + w]
    cur = np.zeros((h, w), np.uint8)
    shifts = {(0, 0): (3, 2), (0, 1): (-4, 1), (1, 0): (2, -5), (1, 1): (-3, -3)}
    for (qi, qj), (dy, dx) in shifts.items():
        cur[32 * qi : 32 * qi + 32, 32 * qj : 32 * qj + 32] = base[
            8 + 32 * qi + dy : 8 + 32 * qi + 32 + dy,
            8 + 32 * qj + dx : 8 + 32 * qj + 32 + dx,
        ]
    cfg = EncodeConfig(search_range=8, qp=32, pu_decision=True)
    out = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    assert cfg.pu_layouts[int(out["pu_layout"][0])] != "2Nx2N"  # split chosen
    assert float(out["psnr_db"]) > 30.0

    # The 32-level search must recover the planted per-quadrant shifts.
    from hevcasm_tpu.encode import ctu as _ctu
    src = _ctu.tile_frame(jnp.asarray(cur), 64)
    rp = _ctu.pad_frame(jnp.asarray(ref), 11, 12, 11, 12)
    pos = motion.ctu_positions(1, 1, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 16)
    s = partition.multi_level_search(src, win, 8, ssd_grid)
    got = {(qi, qj): tuple(int(v) for v in np.asarray(s["mv32"])[0, qi, qj])
           for qi in range(2) for qj in range(2)}
    assert got == shifts


def test_tu_selection_singleton_matches_fixed(frames):
    cur, ref = frames
    out_fixed = encode_inter_frame(
        jnp.asarray(cur), jnp.asarray(ref), EncodeConfig(search_range=8, qp=32)
    )
    out_sel = encode_inter_frame(
        jnp.asarray(cur), jnp.asarray(ref),
        EncodeConfig(search_range=8, qp=32, tu_sizes=(8,)),
    )
    np.testing.assert_array_equal(
        np.asarray(out_fixed["recon"]), np.asarray(out_sel["recon"])
    )


def test_tu_selection_all_sizes(frames):
    cur, ref = frames
    cfg = EncodeConfig(search_range=8, qp=32, tu_sizes=(4, 8, 16, 32))
    out = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    ch = np.asarray(out["tu_choice"])
    assert ch.shape == (6,) and set(np.unique(ch)) <= {0, 1, 2, 3}
    assert float(out["psnr_db"]) > 25.0


@pytest.mark.parametrize("layouts", [
    ("2Nx2N", "2NxN", "Nx2N", "NxN", "quarter"),
    ("2Nx2N", "NxN", "eighth"),
])
def test_pruned_pu_selection_matches_full(frames, layouts):
    """select_pu_layout_pruned (refine only the winning layout, one shared
    base tiling) is bit-identical to the refine-everything path's selected
    output: SAD additivity over tiles + FIR translation invariance."""
    cur, ref = frames
    h, w = cur.shape
    r = 8
    gr, gc = h // 64, w // 64
    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    rp = ctu_mod.pad_frame(jnp.asarray(ref), r + 3, r + 4, r + 3, r + 4)
    pos = motion.ctu_positions(gr, gc, 64)
    win = motion.extract_windows(rp, pos + 3, 64 + 2 * r)
    lam = partition.mv_lambda(32)

    pred_f, choice_f, _, best_f = partition.select_pu_layout(
        src, rp, pos, win, r, lam, layouts, ssd_grid)
    pred_p, choice_p, mv_tiles, best_p = partition.select_pu_layout_pruned(
        src, rp, pos, win, r, lam, layouts, ssd_grid)
    assert np.array_equal(np.asarray(choice_f), np.asarray(choice_p))
    assert np.array_equal(np.asarray(best_f), np.asarray(best_p))
    assert np.array_equal(np.asarray(pred_f), np.asarray(pred_p))
    k = 64 // partition.base_for(layouts)
    assert mv_tiles.shape == (src.shape[0], k, k, 2)


def test_tu_selection_prices_real_bits(rng):
    """select_tu_recon's rate term is the REAL Exp-Golomb bit estimate:
    the per-CTU bits emitted by the frame residual pipeline equal
    encode/rate.bits_estimate on the quantized levels exactly.  (The r3
    proxy lam*nnz*tu measured r = -0.82 correlation against these bits
    across TU sizes — recorded in docs/DESIGN.md section 7 — which is why
    the decision now prices bits directly)"""
    import jax.numpy as jnp

    from hevcasm_tpu.encode import ctu as ctu_mod
    from hevcasm_tpu.encode.rate import bits_estimate
    from hevcasm_tpu.kernels.xla_opt import residual_pipeline_frame
    from hevcasm_tpu.ops.transform import forward_transform
    from hevcasm_tpu.ops.quantize import quantize

    h, w = 128, 192
    base = rng.integers(0, 256, (h + 16, w + 16)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    cur, ref = base[3 : 3 + h, 4 : 4 + w], base[:h, :w]

    src = ctu_mod.tile_frame(jnp.asarray(cur), 64)
    pred = ctu_mod.tile_frame(jnp.asarray(ref), 64)
    n = src.shape[0]
    for tu in (4, 8, 16, 32):
        cfg = EncodeConfig(qp=32, tu=tu)
        scale, shift, offset = cfg.quant_params(False)
        dscale, dshift = cfg.dequant_params()
        _, _, _, bits = residual_pipeline_frame(
            src, pred, scale, shift, offset, dscale, dshift, tu=tu)
        res = src.astype(jnp.int16) - pred.astype(jnp.int16)
        tus = ctu_mod.split_blocks(res, tu)
        coeffs = forward_transform(tus)
        levels, _ = quantize(coeffs, scale, shift, offset)
        k = (64 // tu) ** 2
        lv = levels.reshape(n, k, tu, tu)
        want = np.asarray([int(bits_estimate(lv[c])) for c in range(n)])
        np.testing.assert_array_equal(np.asarray(bits), want, err_msg=f"tu={tu}")
