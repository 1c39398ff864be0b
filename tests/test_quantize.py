"""Quantize family vs oracles, sweeping log2 sizes 2..5 with the reference's
test parameters (quantize.c:148-156, :276-285, :399-424)."""

import numpy as np
import pytest

from hevcasm_tpu import ops
import oracles


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_quantize_inverse(rng, log2):
    n = 1 << log2
    src = (rng.integers(0, 256, (n, n)) - 0x100).astype(np.int16)
    got = np.asarray(ops.quantize_inverse(src, scale=51, shift=14))
    want = oracles.quantize_inverse(src, 51, 14)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_quantize(rng, log2):
    n = 1 << log2
    src = (rng.integers(-32768, 32768, (n, n))).astype(np.int16)
    got, cbf = ops.quantize(src, scale=51, shift=20, offset=14)
    want, want_cbf = oracles.quantize(src, 51, 20, 14)
    np.testing.assert_array_equal(np.asarray(got), want)
    assert bool(cbf) == bool(want_cbf)


def test_quantize_cbf_zero():
    src = np.zeros((8, 8), dtype=np.int16)
    _, cbf = ops.quantize(src, scale=51, shift=20, offset=14)
    assert not bool(cbf)
    # Small values that quantize to zero must also clear cbf.
    src2 = np.ones((8, 8), dtype=np.int16)
    q, cbf2 = ops.quantize(src2, scale=51, shift=20, offset=14)
    assert not np.any(np.asarray(q)) and not bool(cbf2)


def test_quantize_batched(rng):
    src = rng.integers(-32768, 32768, (7, 16, 16)).astype(np.int16)
    got, cbf = ops.quantize(src, scale=51, shift=20, offset=14)
    got, cbf = np.asarray(got), np.asarray(cbf)
    for i in range(7):
        want, want_cbf = oracles.quantize(src[i], 51, 20, 14)
        np.testing.assert_array_equal(got[i], want)
        assert bool(cbf[i]) == bool(want_cbf)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_reconstruct(rng, log2):
    n = 1 << log2
    pred = rng.integers(0, 256, (n, n), dtype=np.uint8)
    res = (rng.integers(0, 0x200, (n, n)) - 0x100).astype(np.int16)
    got = np.asarray(ops.reconstruct(pred, res))
    np.testing.assert_array_equal(got, oracles.reconstruct(pred, res))


def test_quantize_rejects_out_of_range_static_params():
    """Concrete parameters outside the reference's asserted ranges
    (quantize.c:162-165) fail loudly."""
    from hevcasm_tpu.ops.quantize import quantize

    src = np.zeros((8, 8), np.int16)
    for bad in [dict(scale=0x8000), dict(shift=15), dict(shift=28),
                dict(offset=0x8000), dict(scale=0)]:
        kw = dict(scale=51, shift=20, offset=14)
        kw.update(bad)
        with pytest.raises(ValueError, match="quantize:"):
            quantize(src, kw["scale"], kw["shift"], kw["offset"])


def test_quantize_checked_traced_params():
    """Traced out-of-range parameters are caught by the checkified wrapper
    (the rate-control analogue of the C asserts)."""
    import jax
    import jax.numpy as jnp
    import pytest
    from hevcasm_tpu.ops.quantize import quantize_checked

    src = jnp.asarray(np.full((8, 8), 1000, np.int16))

    @jax.jit
    def run(scale, shift, offset):
        return quantize_checked(src, scale, shift, offset)

    err, (q, cbf) = run(jnp.int32(51), jnp.int32(20), jnp.int32(14))
    err.throw()  # in-range: no error
    from hevcasm_tpu.ops.quantize import quantize
    want, _ = quantize(src, 51, 20, 14)
    assert np.array_equal(np.asarray(q), np.asarray(want))

    err, _ = run(jnp.int32(0x8000), jnp.int32(20), jnp.int32(14))
    with pytest.raises(Exception, match="scale"):
        err.throw()
    err, _ = run(jnp.int32(51), jnp.int32(31), jnp.int32(14))
    with pytest.raises(Exception, match="shift"):
        err.throw()
