"""Optimized kernel tier (Tier.JIT, the C_OPT analogue).

* xla_opt — exact integer transforms/SATD as bf16 matmuls via hi/lo byte
  splitting, the frame-batched residual pipeline, and the correlation
  formulation of the full-search SSD grid.
* interp_xla — quarter-pel refinement as banded-matrix FIR matmuls.
* intra_matrix — the 35-mode intra sweep as one constant int8 matmul.

Importing this package registers the optimized tier.
"""

from . import xla_opt  # noqa: F401
from . import interp_xla  # noqa: F401
