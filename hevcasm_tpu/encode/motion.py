"""Motion estimation: batched full-search + quarter-pel refinement.

The reference provides only the per-block SAD primitives and leaves the
search to client encoders (SURVEY.md section 3.2).  Here the whole frame's
CTUs search in one batched call:

  1. integer full search: sad_grid over a (2R+1)^2 candidate grid per CTU;
  2. quarter-pel refinement: the 16 (xFrac, yFrac) interpolations at the best
     integer MV, evaluated with the unified pred_uni path and scored by SAD.

All shapes static; MVs are traced values (gathers), so the whole pipeline
jits into one program.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.sad import sad_grid

__all__ = [
    "ctu_positions",
    "extract_windows",
    "full_search",
    "full_search_multi",
    "refine_quarter_pel",
    "grid_metric_fn",
]


def grid_metric_fn(metric: str):
    """Best available grid-scoring implementation for a metric name.

    "sad": reference-faithful |a-b| grid; "ssd": squared-error grid, whose
    optimized tier is correlation matmuls (kernels/xla_opt.ssd_grid, exact
    integers).
    """
    from .. import registry  # late import: kernels register on package load

    op = {"sad": "sad_grid", "ssd": "ssd_grid"}[metric]
    fn = registry.get(op)
    assert fn is not None, f"no implementation for {op}"
    return fn

TAPS = 8
PAD_L = TAPS // 2 - 1  # 3
PAD_R = TAPS // 2      # 4


def ctu_positions(grid_rows: int, grid_cols: int, ctu: int) -> jnp.ndarray:
    """(n, 2) [y, x] pixel positions of each CTU, row-major."""
    r = jnp.arange(grid_rows) * ctu
    c = jnp.arange(grid_cols) * ctu
    yy, xx = jnp.meshgrid(r, c, indexing="ij")
    return jnp.stack([yy.reshape(-1), xx.reshape(-1)], axis=-1).astype(jnp.int32)


def extract_windows(plane: jnp.ndarray, positions: jnp.ndarray,
                    size: int | tuple[int, int]) -> jnp.ndarray:
    """Gather a (sy, sx) window at each position from a 2-D plane.

    positions are top-left coords into `plane`; `size` is an int (square)
    or (rows, cols).  Returns (n, sy, sx).
    """
    sy, sx = (size, size) if isinstance(size, int) else size

    def one(pos):
        return jax.lax.dynamic_slice(plane, (pos[0], pos[1]), (sy, sx))

    return jax.vmap(one)(positions)


def extract_aligned_windows(
    plane: jnp.ndarray, origin: tuple[int, int], grid: tuple[int, int], tile: int, size: int
) -> jnp.ndarray:
    """Window extraction for grid-aligned positions via pure reshapes.

    Every search window of a CTU grid starts at origin + (r*tile, c*tile),
    and when ``size`` is a multiple of ``tile`` the windows are stitchable
    from a (size/tile)^2 neighbourhood of a single tiling of the plane —
    no per-window dynamic-slice gather (which costs more than the SAD/SSD
    arithmetic it feeds at production sizes).

    Returns (grid_r * grid_c, size, size), bit-identical to extract_windows
    at the same positions.
    """
    gr, gc = grid
    k = size // tile
    assert k * tile == size, "window size must be a multiple of the tile"
    oy, ox = origin
    a = jax.lax.slice(
        plane, (oy, ox), (oy + (gr + k - 1) * tile, ox + (gc + k - 1) * tile)
    )
    t = a.reshape(gr + k - 1, tile, gc + k - 1, tile).transpose(0, 2, 1, 3)
    rows = []
    for dy in range(k):
        cols = [t[dy : dy + gr, dx : dx + gc] for dx in range(k)]
        rows.append(jnp.concatenate(cols, axis=-1))  # (gr, gc, tile, k*tile)
    win = jnp.concatenate(rows, axis=-2)             # (gr, gc, size, size)
    return win.reshape(gr * gc, size, size)


def full_search(
    src_ctus: jnp.ndarray,
    ref_padded: jnp.ndarray,
    positions: jnp.ndarray,
    search_range: int,
    grid_fn=sad_grid,
    grid: tuple[int, int] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Integer-pel full search.

    src_ctus:   (n, B, B) current-frame CTUs.
    ref_padded: reference plane padded by (R + PAD_L) top/left and
                (R + PAD_R) bottom/right (see pad amounts in loop.py).
    positions:  (n, 2) CTU pixel positions in unpadded coords.
    grid_fn:    grid-scoring implementation (sad_grid, ssd_grid, any tier).
    grid:       (rows, cols) of the CTU grid; when given and the window span
                is tile-aligned, windows come from the reshape-based
                extractor instead of per-CTU gathers.

    Returns (mvs, best_sad): mvs (n, 2) integer-pel [dy, dx] in [-R, R],
    best_sad (n,) int32.
    """
    b = src_ctus.shape[-1]
    r = search_range
    num = 2 * r + 1
    size = b + 2 * r
    # Search window top-left in padded coords: (y0 - R) + (R + PAD_L).
    if grid is not None and size % b == 0:
        win = extract_aligned_windows(ref_padded, (PAD_L, PAD_L), grid, b, size)
    else:
        win = extract_windows(ref_padded, positions + PAD_L, size)
    sads = grid_fn(src_ctus, win, num, num)  # (n, num, num)
    flat = sads.reshape(sads.shape[0], -1)
    best = jnp.argmin(flat, axis=-1).astype(jnp.int32)
    best_sad = jnp.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
    mv = jnp.stack([best // num - r, best % num - r], axis=-1)
    return mv, best_sad


def full_search_multi(
    src_ctus: jnp.ndarray,
    planes: jnp.ndarray,
    positions: jnp.ndarray,
    search_range: int,
    grid_fn=sad_grid,
    grid: tuple[int, int] | None = None,
    joint: bool = True,
):
    """Integer full search against k stacked reference planes in ONE
    batched grid call — the k-way generalisation of the reference's 4-way
    multiref SAD (sad.h:94-112), searched single-pass instead of a Python
    loop over references.

    planes: (k, Hp, Wp) each padded like full_search's ref_padded.  With
    ``joint`` (P-frame reference selection), returns (mv (n, 2),
    ref_idx (n,), best (n,)) minimizing the score over (ref, dy, dx)
    jointly; k == 1 is bit-identical to full_search.  With joint=False
    (B-frame style), returns per-reference (mv (k, n, 2), best (k, n)).
    """
    k = planes.shape[0]
    n, b = src_ctus.shape[0], src_ctus.shape[-1]
    r = search_range
    num = 2 * r + 1
    size = b + 2 * r
    wins = []
    for i in range(k):
        if grid is not None and size % b == 0:
            wins.append(extract_aligned_windows(planes[i], (PAD_L, PAD_L), grid, b, size))
        else:
            wins.append(extract_windows(planes[i], positions + PAD_L, size))
    win = jnp.concatenate(wins, axis=0)              # (k*n, S, S)
    srcs = jnp.tile(src_ctus, (k, 1, 1))             # (k*n, b, b)
    scores = grid_fn(srcs, win, num, num).reshape(k, n, num * num)
    if joint:
        flat = jnp.moveaxis(scores, 0, 1).reshape(n, k * num * num)
        best = jnp.argmin(flat, axis=-1).astype(jnp.int32)
        best_score = jnp.take_along_axis(flat, best[:, None], axis=-1)[:, 0]
        ref_idx = best // (num * num)
        rem = best % (num * num)
        mv = jnp.stack([rem // num - r, rem % num - r], axis=-1)
        return mv, ref_idx, best_score
    best = jnp.argmin(scores, axis=-1).astype(jnp.int32)  # (k, n)
    best_score = jnp.take_along_axis(scores, best[..., None], axis=-1)[..., 0]
    mv = jnp.stack([best // num - r, best % num - r], axis=-1)
    return mv, best_score


def _downsample4(x: jnp.ndarray) -> jnp.ndarray:
    """4x box decimation with rounding over the trailing two axes."""
    h, w = x.shape[-2] // 4, x.shape[-1] // 4
    lead = x.shape[:-2]
    v = x.astype(jnp.int32).reshape(*lead, h, 4, w, 4).sum(axis=(-3, -1))
    return ((v + 8) >> 4).astype(jnp.uint8)


def pyramid_search(
    src_ctus: jnp.ndarray,
    ref_plane: jnp.ndarray,
    ref_padded: jnp.ndarray,
    positions: jnp.ndarray,
    search_range: int,
    grid_fn=sad_grid,
    fine_range: int = 3,
    grid: tuple[int, int] | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Two-level hierarchical integer search covering the same +-R window as
    full_search at ~1/60 the arithmetic.

    Level 0: 4x-decimated frame, full grid over +-R/4 (integer coarse MV).
    Level 1: full resolution, +-fine_range grid around the upscaled coarse MV.

    src_ctus:   (n, B, B); ref_plane (H, W) unpadded; ref_padded as produced
    by pad_frame(ref, R+PAD_L, R+PAD_R, ...) — shared with the quarter-pel
    refinement stage.  Returns (mv_int, best_score).
    """
    b = src_ctus.shape[-1]
    r = search_range
    rc = r // 4
    bc = b // 4

    # --- coarse level ------------------------------------------------------
    src_c = _downsample4(src_ctus)                     # (n, B/4, B/4)
    ref_c = _downsample4(ref_plane)                    # (H/4, W/4)
    ref_c_pad = jnp.pad(
        ref_c, ((rc, rc), (rc, rc)), mode="edge"
    )
    pos_c = positions // 4
    if grid is not None and (bc + 2 * rc) % bc == 0:
        win_c = extract_aligned_windows(ref_c_pad, (0, 0), grid, bc, bc + 2 * rc)
    else:
        win_c = extract_windows(ref_c_pad, pos_c, bc + 2 * rc)
    num_c = 2 * rc + 1
    sc = grid_fn(src_c, win_c, num_c, num_c)           # (n, num_c, num_c)
    flat = sc.reshape(sc.shape[0], -1)
    best_c = jnp.argmin(flat, axis=-1).astype(jnp.int32)
    mv_c = jnp.stack([best_c // num_c - rc, best_c % num_c - rc], axis=-1) * 4

    # --- fine level --------------------------------------------------------
    f = fine_range
    mv_c = jnp.clip(mv_c, -r + f, r - f)               # keep fine grid in range
    start = positions + mv_c - f + (r + PAD_L)
    win_f = extract_windows(ref_padded, start, b + 2 * f)
    num_f = 2 * f + 1
    sf = grid_fn(src_ctus, win_f, num_f, num_f)
    flatf = sf.reshape(sf.shape[0], -1)
    best_f = jnp.argmin(flatf, axis=-1).astype(jnp.int32)
    best_score = jnp.take_along_axis(flatf, best_f[:, None], axis=-1)[:, 0]
    mv = mv_c + jnp.stack([best_f // num_f - f, best_f % num_f - f], axis=-1)
    return mv, best_score


def refine_quarter_pel(
    src_ctus: jnp.ndarray,
    ref_padded: jnp.ndarray,
    positions: jnp.ndarray,
    mv_int: jnp.ndarray,
    search_range: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Evaluate the 16 quarter-pel fractional offsets at the best integer MV
    and return (pred, mv_qpel, windows).

    pred:   (n, B, B) uint8 best interpolated prediction
    mv_qpel:(n, 2) motion vectors in quarter-pel units (mv_int*4 + frac)
    """
    from ..ops.pred_inter import refine_qpel

    b = src_ctus.shape[-1]
    # Interp window top-left (unpadded): y0 + dy - PAD_L; padded offset
    # +(R + PAD_L) makes it y0 + dy + R >= 0.
    start = positions + mv_int + search_range
    win = extract_windows(ref_padded, start, b + TAPS - 1)  # (n, B+7, B+7)
    pred, frac, _ = refine_qpel(src_ctus, win)
    mv_qpel = mv_int * 4 + jnp.stack([frac // 4, frac % 4], axis=-1)
    return pred, mv_qpel, win
