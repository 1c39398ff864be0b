"""Configuration and tier selection for hevcasm_tpu.

The reference library keys every kernel family off a CPU-capability bitmask
(``hevcasm_instruction_set``, /root/reference/src/lib/hevcasm.h:113-138) probed
at runtime with cpuid.  On an accelerator there is no instruction-set zoo;
the analogous degrees of freedom are *which implementation tier* runs (the
plain jnp reference, or its optimized XLA formulation) and *how work is laid
out* (mesh shape, precision).  ``Tier`` is therefore an IntFlag mask exactly
like the reference's, so callers (and the self-test harness) can force lower
tiers the same way ``hevcasm_test.c:126-132`` iterates instruction sets.
"""

from __future__ import annotations

import dataclasses
import enum


class Tier(enum.IntFlag):
    """Implementation tiers, by ascending priority (cf. hevcasm.h:113-124).

    REF     pure jax.numpy integer implementation; the golden oracle
            (role of the reference's C_REF tier).
    JIT     same maths, shape-specialised and jitted, often re-expressed
            as exact integer matmuls (role of C_OPT).
    """

    NONE = 0
    REF = 1
    JIT = 2
    ALL = REF | JIT


#: Tiers in descending selection priority; populate() picks the first
#: available implementation whose tier bit is set in the mask, mirroring the
#: descending C_REF -> SSE2 -> ... -> AVX2 selection of e.g. sad.c:63-86.
TIER_PRIORITY = (Tier.JIT, Tier.REF)


def tiers_in(mask: Tier):
    """Yield individual tiers present in ``mask``, highest priority first."""
    for t in TIER_PRIORITY:
        if mask & t:
            yield t


@dataclasses.dataclass(frozen=True)
class Config:
    """Global knobs for the framework (role of the reference's mask argument
    plus the build-time flags it never had).

    Attributes:
      tiers:        which implementation tiers populate() may select.
      bit_depth:    sample bit depth.  v0 implements HEVC Main profile, 8-bit,
                    matching the reference's scope (README.md:24-37).
      ctu_size:     coding-tree-unit size used by the encode loop.
      search_range: full-search motion estimation range in luma pels.
      mesh_frames:  data-parallel axis size for GOP/frame sharding.
      mesh_rows:    spatial axis size for CTU-row sharding within a frame.
    """

    tiers: Tier = Tier.ALL
    bit_depth: int = 8
    ctu_size: int = 64
    search_range: int = 32
    mesh_frames: int = 1
    mesh_rows: int = 1


DEFAULT = Config()
