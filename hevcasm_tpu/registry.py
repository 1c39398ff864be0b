"""Kernel registry: the accelerator analogue of the reference's dispatch
tables.

The reference keys per-kernel function-pointer tables by block geometry and
fills them from a capability mask (`hevcasm_populate_*`, e.g. sad.c:89-98,
with best-tier-wins selection sad.c:63-86).  Under jit, shape
specialisation comes free, so the registry keys on (op name, tier) only;
`get` returns the best implementation allowed by a Tier mask, falling back
tier by tier exactly as the reference falls back C_REF -> SSE2 -> AVX2.

The jnp reference implementations register as Tier.REF; the optimized XLA
formulations (kernels/) as Tier.JIT.  The self-test harness iterates tiers
and compares each against REF, reproducing the testing model of
hevcasm_test.c:110-137.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import jax

from .config import Tier, tiers_in

_REGISTRY: Dict[Tuple[str, Tier], Callable] = {}
# Per-op static (shape/branch-determining) argument positions, used when the
# default JIT tier wraps the REF implementation in jax.jit — the analogue of
# geometry being baked into which table slot the reference selects.
_STATIC_ARGNUMS: Dict[str, tuple] = {}


def register(op: str, tier: Tier, fn: Callable | None = None, *,
             static_argnums: tuple | None = None):
    """Register ``fn`` as implementation of ``op`` at ``tier``.

    Usable as a decorator: ``@register("sad", Tier.REF)``.
    ``static_argnums`` marks Python-level args (mode, grid extents, taps)
    that must stay static under the default jit-of-REF tier.
    """

    def _do(f):
        _REGISTRY[(op, tier)] = f
        if static_argnums is not None:
            _STATIC_ARGNUMS[op] = tuple(static_argnums)
        if tier is Tier.REF:
            _JIT_CACHE.pop(op, None)  # stale default-JIT wrapper
        return f

    return _do(fn) if fn is not None else _do


# Memoized jit wrappers: repeated get()/populate() must return the SAME
# jax.jit object so its trace cache is reused (a fresh wrapper per call
# recompiles on every binding).
_JIT_CACHE: Dict[str, Callable] = {}


def _jit_ref(op: str, ref: Callable) -> Callable:
    fn = _JIT_CACHE.get(op)
    if fn is None:
        fn = jax.jit(ref, static_argnums=_STATIC_ARGNUMS.get(op, ()))
        _JIT_CACHE[op] = fn
    return fn


def get(op: str, mask: Tier = Tier.ALL) -> Callable | None:
    """Best implementation of ``op`` whose tier is enabled in ``mask``
    (JIT > REF), or None — mirroring get_sad (sad.c:63-86)."""
    for tier in tiers_in(mask):
        f = get_tier(op, tier)
        if f is not None:
            return f
    return None


def get_tier(op: str, tier: Tier) -> Callable | None:
    """Exactly the given tier (no fallback); None if not implemented —
    how the harness binds one tier at a time (hevcasm_test.c:126-132).
    The JIT tier defaults to jitting the REF implementation, the role of
    C_OPT (same maths, compiler-scheduled)."""
    if tier is Tier.JIT and (op, Tier.JIT) not in _REGISTRY:
        ref = _REGISTRY.get((op, Tier.REF))
        return _jit_ref(op, ref) if ref is not None else None
    return _REGISTRY.get((op, tier))


def populate(mask: Tier = Tier.ALL) -> Dict[str, Callable]:
    """Fill a {op: best impl} table for every known op, the analogue of
    running all hevcasm_populate_* with one mask."""
    return {op: get(op, mask) for op in ops()}


def ops() -> Iterable[str]:
    return sorted({op for (op, _) in _REGISTRY})


def tiers_of(op: str) -> Tier:
    """Mask of tiers with an explicit registration for ``op``."""
    mask = Tier.NONE
    for (name, tier) in _REGISTRY:
        if name == op:
            mask |= tier
    return mask
