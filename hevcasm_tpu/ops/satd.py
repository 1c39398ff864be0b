"""Hadamard-transformed SAD (SATD) for mode-decision cost.

Reference: /root/reference/src/lib/hadamard.c.  The C code runs a recursive
butterfly (hadamard.c:45-72) over the difference block, then sums absolute
transformed values with rounding (sad + n/4) / (n/2) (hadamard.c:97-110).

Matrix formulation: the 2-D Hadamard transform is H @ D @ H^T with the
Sylvester Hadamard matrix H (entries +-1).  The recursive butterfly computes
the same transform up to a row permutation and the sum of absolute values is
permutation-invariant, so the matmul form is bit-exact.  Batched over blocks,
the two matmuls run as batched matrix products.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["satd", "hadamard_matrix"]


def hadamard_matrix(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of order n (n a power of two, n <= 8)."""
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def satd(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """SATD over the trailing two axes; block size n in {2, 4, 8}.

    a, b: (..., n, n) uint8.  Returns (...,) int32, bit-exact with
    compute_satd (hadamard.c:75-111): satd = (sum|H (a-b) H| + n/4) / (n/2).
    """
    n = a.shape[-1]
    assert a.shape[-2] == n and n in (2, 4, 8)
    h = jnp.asarray(hadamard_matrix(n))
    d = a.astype(jnp.int32) - b.astype(jnp.int32)
    # transformed = H @ d @ H^T; H symmetric so H^T == H.
    t = jnp.einsum("ky,...yx,xj->...kj", h, d, h)
    s = jnp.sum(jnp.abs(t), axis=(-2, -1)) + n // 4
    # C integer division of a non-negative value by n/2 (a power of two).
    return s // (n // 2)
