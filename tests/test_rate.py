"""Rate control: traced-qp quantizer params match the static path; the
controller steers bits toward the target."""

import numpy as np
import jax.numpy as jnp
import pytest

from hevcasm_tpu.encode import EncodeConfig
from hevcasm_tpu.encode.loop import encode_inter_frame
from hevcasm_tpu.encode.rate import (
    quant_params_traced,
    bits_estimate,
    encode_inter_frame_traced_qp,
    encode_gop_rate_controlled,
)


def test_traced_params_match_static():
    for qp in (4, 22, 32, 45, 51):
        cfg = EncodeConfig(qp=qp)
        qs, qh, qo = cfg.quant_params(False)
        ds, dh = cfg.dequant_params()
        tqs, tqh, tqo, tds, tdh = quant_params_traced(jnp.int32(qp), cfg.tu_log2)
        assert (int(tqs), int(tqh), tqo, int(tds), int(tdh)) == (qs, qh, qo, ds, dh)


def test_bits_estimate():
    levels = np.array([0, 1, -1, 2, 3, -4, 100], dtype=np.int16)
    # bits: 0, 3, 3, 5, 5, 7, 2*6+3=15
    assert int(bits_estimate(jnp.asarray(levels))) == 3 + 3 + 5 + 5 + 7 + 15


def _clip(rng, t, h, w, noise=0):
    base = rng.integers(0, 256, (h + 4 * t, w + 4 * t)).astype(np.float32)
    for _ in range(2):
        base = (np.roll(base, 1, 0) + base + np.roll(base, -1, 0)) / 3
        base = (np.roll(base, 1, 1) + base + np.roll(base, -1, 1)) / 3
    base = np.clip(base, 0, 255).astype(np.uint8)
    out = np.stack([base[2 * i : 2 * i + h, 3 * i : 3 * i + w] for i in range(t)])
    if noise:
        # per-frame independent noise so residuals never quantize to zero
        n = rng.integers(-noise, noise + 1, out.shape)
        out = np.clip(out.astype(np.int16) + n, 0, 255).astype(np.uint8)
    return out


def test_traced_qp_frame_matches_static(rng):
    frames = _clip(rng, 2, 128, 128)
    cfg = EncodeConfig(search_range=8, qp=30)
    static = encode_inter_frame(jnp.asarray(frames[1]), jnp.asarray(frames[0]), cfg)
    traced = encode_inter_frame_traced_qp(
        jnp.asarray(frames[1]), jnp.asarray(frames[0]), jnp.int32(30), cfg
    )
    np.testing.assert_array_equal(np.asarray(static["recon"]), np.asarray(traced["recon"]))


def test_rate_control_steers_bits(rng):
    frames = _clip(rng, 8, 128, 128, noise=12)
    cfg = EncodeConfig(search_range=8)
    # Pick a target between two mid qps so the controller must move qp.
    lo = encode_inter_frame_traced_qp(
        jnp.asarray(frames[1]), jnp.asarray(frames[0]), jnp.int32(38), cfg
    )["bits"]
    hi = encode_inter_frame_traced_qp(
        jnp.asarray(frames[1]), jnp.asarray(frames[0]), jnp.int32(22), cfg
    )["bits"]
    target = int(np.sqrt(max(int(lo), 1) * max(int(hi), 1)))
    out = encode_gop_rate_controlled(jnp.asarray(frames), target, 40, cfg)
    bits = np.asarray(out["bits"]).astype(float)
    qps = np.asarray(out["qp"])
    # After settling, frames should land within ~an octave of the target.
    settled = bits[3:]
    assert np.all(settled > target / 2.5) and np.all(settled < target * 2.5), (bits, qps, target)
    # and qp must actually have moved from the start value
    assert qps[0] == 40 and qps[-1] != 40


def test_rate_control_out_of_range_qp_raises(rng):
    """A traced qp that drives the quantizer shift past the reference's
    asserted 16..27 window (quantize.c:162-165) fails loudly via checkify
    instead of silently wrapping."""
    frames = _clip(rng, 3, 128, 128, noise=10)
    cfg = EncodeConfig(search_range=8, refine_impl="ref")
    with pytest.raises(Exception, match="outside"):
        # qp 60 -> shift = 21 + 10 - 3 = 28 > 27
        encode_gop_rate_controlled(
            jnp.asarray(frames), 6000.0, 60, cfg, qp_min=55, qp_max=70
        )


def test_rc_gop_b_frames(rng):
    # IBPBP rate-controlled GOP: the scan program's first pair must equal
    # the per-frame traced-qp composition at qp0.
    from hevcasm_tpu.encode.rate import (
        encode_b_frame_traced_qp, encode_gop_rate_controlled)

    frames = jnp.asarray(_clip(rng, 5, 128, 192))
    cfg = EncodeConfig(search_range=8, qp=32)
    out = encode_gop_rate_controlled(frames, 20000.0, 32, cfg, b_frames=True)
    assert out["recon"].shape == (4, 128, 192)
    assert np.asarray(out["bits"]).min() > 0

    p2 = encode_inter_frame_traced_qp(frames[2], frames[0], jnp.int32(32), cfg)
    b1 = encode_b_frame_traced_qp(frames[1], frames[0], p2["recon"],
                                  jnp.int32(32), cfg)
    np.testing.assert_array_equal(np.asarray(out["recon"][1]),
                                  np.asarray(p2["recon"]))
    np.testing.assert_array_equal(np.asarray(out["recon"][0]),
                                  np.asarray(b1["recon"]))


def test_traced_qp_rdo_config_raises(rng):
    frames = jnp.asarray(_clip(rng, 2, 128, 128))
    cfg = EncodeConfig(search_range=8, qp=32, tu_sizes=(4, 8))
    with pytest.raises(ValueError, match="pu_decision/tu_sizes"):
        encode_inter_frame_traced_qp(frames[1], frames[0], jnp.int32(32), cfg)
