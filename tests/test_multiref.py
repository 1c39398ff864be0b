"""Multi-reference P frames: per-CTU reference selection must pick the
reference that actually contains each CTU's content."""

import numpy as np
import jax.numpy as jnp

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode.loop import encode_inter_frame, encode_inter_frame_multiref


def test_multiref_selects_matching_reference(rng):
    """ref0 matches the left half of the frame, ref1 the right half;
    selection must split accordingly and beat either single reference."""
    h, w = 128, 256
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    noise0 = rng.integers(-60, 61, (h, w))
    noise1 = rng.integers(-60, 61, (h, w))
    ref0 = cur.astype(np.int16).copy()
    ref1 = cur.astype(np.int16).copy()
    ref0[:, w // 2 :] += noise0[:, w // 2 :]   # ref0 bad on the right
    ref1[:, : w // 2] += noise1[:, : w // 2]   # ref1 bad on the left
    ref0 = np.clip(ref0, 0, 255).astype(np.uint8)
    ref1 = np.clip(ref1, 0, 255).astype(np.uint8)

    cfg = EncodeConfig(search_range=4, qp=27)
    out = encode_inter_frame_multiref(
        jnp.asarray(cur), jnp.asarray(np.stack([ref0, ref1])), cfg
    )
    ref_idx = np.asarray(out["ref_idx"]).reshape(2, 4)  # 2x4 CTU grid
    assert (ref_idx[:, :2] == 0).all(), ref_idx         # left half from ref0
    assert (ref_idx[:, 2:] == 1).all(), ref_idx         # right half from ref1

    single0 = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref0), cfg)
    assert float(out["psnr_db"]) > float(single0["psnr_db"]) + 3.0


def test_multiref_single_ref_matches_plain(rng):
    """k=1 multiref must equal the plain single-reference encode."""
    base = rng.integers(0, 256, (144, 144)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    cur, ref = base[3:131, 5:133], base[:128, :128]
    cfg = EncodeConfig(search_range=8, qp=30)
    plain = encode_inter_frame(jnp.asarray(cur), jnp.asarray(ref), cfg)
    multi = encode_inter_frame_multiref(jnp.asarray(cur), jnp.asarray(ref)[None], cfg)
    np.testing.assert_array_equal(np.asarray(plain["recon"]), np.asarray(multi["recon"]))


def test_multiref_k_scaling(rng):
    """The single-pass search handles growing k in one batched call; more
    references never hurt the score-selected quality."""
    h, w = 128, 128
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    refs = []
    for s in (1, 3, 5, 7):
        r = np.roll(cur, s, axis=1).astype(np.int16)
        r += rng.integers(-20 - 4 * s, 21 + 4 * s, (h, w))
        refs.append(np.clip(r, 0, 255).astype(np.uint8))
    refs = np.stack(refs)
    cfg = EncodeConfig(search_range=8, qp=30)
    p1 = float(encode_inter_frame_multiref(jnp.asarray(cur), jnp.asarray(refs[:1]), cfg)["psnr_db"])
    p4 = float(encode_inter_frame_multiref(jnp.asarray(cur), jnp.asarray(refs), cfg)["psnr_db"])
    assert p4 >= p1 - 1e-6
