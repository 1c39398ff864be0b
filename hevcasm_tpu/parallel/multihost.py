"""Multi-process runtime: process bring-up and a global mesh
(SURVEY.md section 2.3, BASELINE config 5).

GSPMD means the per-process program is identical; the only multi-process
code is initialization and building a global mesh.  A 4K 32-frame GOP then
runs through encode_gop_data_parallel / encode_inter_frame_spatial
unchanged: row-axis halo exchange stays between the cards of one host
(make_global_mesh puts 'rows' innermost), frame-axis traffic may cross
hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["initialize", "make_global_mesh"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Bring up jax.distributed for a multi-process run.

    Pass the coordinator address (``host:port``), the process count and
    this process's id; a cluster environment JAX recognises may supply
    them instead.  Idempotent: safe to call when already initialized or
    single-process.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        # Already initialized, or single-process run without coordinator.
        pass


def make_global_mesh(frames: int, rows: int) -> Mesh:
    """A (frames, rows) mesh over ALL devices in the job (across hosts).

    'rows' is the innermost axis so halo ppermutes stay between the cards
    of one host rather than crossing hosts; 'frames' spans hosts, where
    only whole reconstructed frames ever cross.
    """
    devs = np.asarray(jax.devices())
    assert devs.size == frames * rows, (
        f"mesh {frames}x{rows} != {devs.size} devices"
    )
    return Mesh(devs.reshape(frames, rows), axis_names=("frames", "rows"))
