"""hevcasm_tpu — an HEVC Main-profile (8-bit) encode inner-loop engine,
built from scratch in JAX/XLA.

Capability-equivalent to kupix/hevcasm (reference mounted at
/root/reference): SAD/SSD/SATD block matching, forward/inverse DCT & DST
transforms, quantization, motion-compensation interpolation, intra
prediction, a bit-exact dual-tier self-test harness — plus the multi-chip
frame/GOP-sharded encode loop the reference leaves to its consumers.
"""

from .config import Config, Tier, DEFAULT
from . import registry
from . import ops  # registers the REF tier
from . import kernels  # registers the optimized tier (JIT)

__version__ = "0.1.0"

__all__ = ["Config", "Tier", "DEFAULT", "registry", "ops"]
