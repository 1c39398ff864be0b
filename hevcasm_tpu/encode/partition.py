"""Variable block structure: per-CTU PU-layout decision (square 64/32/16/8
levels plus the rectangular 2NxN / Nx2N splits) and per-CTU TU-size
selection (4/8/16/32).

The reference keys every kernel table on block geometry — including the
non-square partitions (sad.h:52-67, pred_inter.h:58-67,
residual_decode.h:56-74) — and leaves the split decisions to client
encoders.  The batched formulation keeps every shape static and turns
the decisions into masked selections between frame-batched alternatives:

* Motion/PU: the integer-SSD candidate grid is ADDITIVE over sub-blocks —
  grid(PU) == sum of the grids of its base-granularity sub-blocks at the
  same displacement.  ONE search at base granularity (16, or 8 when the
  "eighth" layout is enabled) plus a 2-D integral image over the sub-block
  grid yields the exact grid of EVERY rectangular PU in O(1) lookups.
  Each PU takes its own argmin (independent MVs); the per-CTU layout
  choice minimises  sum(best SSD) + lambda_mv * num_PUs (a motion-rate
  proxy).

* Quarter-pel refinement for any PU shape: each PU is tiled by squares of
  side min(h, w); all tiles' 16-candidate cost maps
  (kernels/interp_xla.refine_qpel_costmap_mxu) are summed per PU, ONE
  fraction is chosen for the whole PU (one MV per PU, as HEVC requires),
  and each tile's prediction at that fraction is assembled.

* TU: the frame residual pipeline runs per candidate TU size over the
  whole frame (block-diagonal kron(I, T_tu) matmuls), and the per-CTU
  choice minimises SSD + lambda_tu * nnz.

All decisions are bit-reproducible given the config; tests verify grid
additivity against independent searches and the end-to-end paths
(tests/test_partition.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import ctu as ctu_mod
from . import motion

__all__ = [
    "PU_LAYOUTS", "base_for", "base_grid_search", "grid_integral",
    "rect_grid", "layout_decision", "refine_layout", "select_pu_layout",
    "select_pu_layout_pruned", "multi_level_search", "select_tu_recon",
    "mv_lambda",
]

# Layout name -> PU rects (y0, x0, h, w) tiling the 64x64 CTU.  The HEVC
# split modes at depth 0 plus the deeper square levels the r2 encoder had.
PU_LAYOUTS = {
    "2Nx2N": ((0, 0, 64, 64),),
    "2NxN": ((0, 0, 32, 64), (32, 0, 32, 64)),
    "Nx2N": ((0, 0, 64, 32), (0, 32, 64, 32)),
    "NxN": tuple((32 * i, 32 * j, 32, 32) for i in range(2) for j in range(2)),
    "quarter": tuple((16 * i, 16 * j, 16, 16) for i in range(4) for j in range(4)),
    "eighth": tuple((8 * i, 8 * j, 8, 8) for i in range(8) for j in range(8)),
}


def mv_lambda(qp: int) -> int:
    """Motion-cost weight for the PU-level decision: the HM-style
    lambda = 0.85 * 2^((qp-12)/3), scaled to integer-SSD units."""
    return max(1, int(round(0.85 * 2.0 ** ((qp - 12) / 3.0))))


def base_for(layouts) -> int:
    """Base search granularity: the smallest PU side over the layout set."""
    return min(min(r[2], r[3]) for name in layouts for r in PU_LAYOUTS[name])


def _argmin_grid(g: jnp.ndarray, r: int):
    """(..., ndy, ndx) -> (mv (..., 2) int32 in [-r, r], best (...,) int32)."""
    ndy, ndx = g.shape[-2], g.shape[-1]
    flat = g.reshape(*g.shape[:-2], ndy * ndx)
    idx = jnp.argmin(flat, axis=-1).astype(jnp.int32)
    best = jnp.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    mv = jnp.stack([idx // ndx - r, idx % ndx - r], axis=-1)
    return mv, best


def base_grid_search(src_ctus: jnp.ndarray, windows: jnp.ndarray, r: int,
                     grid_fn, base: int) -> jnp.ndarray:
    """Full search at (base x base) granularity.

    src_ctus (n, 64, 64); windows (n, 64+2r, 64+2r) CTU-level search
    windows (each sub-block's window is a slice).  Returns the exact SSD
    grids g (n, k, k, num, num) with k = 64 // base."""
    n = src_ctus.shape[0]
    num = 2 * r + 1
    k = 64 // base
    srcb = ctu_mod.split_blocks(src_ctus, base)          # (n*k*k, base, base)
    wsub = base + 2 * r
    slabs = [windows[:, base * i : base * i + wsub, base * j : base * j + wsub]
             for i in range(k) for j in range(k)]
    winb = jnp.stack(slabs, axis=1).reshape(n * k * k, wsub, wsub)
    return grid_fn(srcb, winb, num, num).reshape(n, k, k, num, num)


def grid_integral(g: jnp.ndarray) -> jnp.ndarray:
    """2-D integral image over the sub-block axes (zero-padded), so any
    rectangular PU's grid is 4 lookups.  SSD sums stay < 2^31 (a whole-CTU
    SSD is at most 64*64*255^2 ~ 2.7e8)."""
    gi = jnp.cumsum(jnp.cumsum(g.astype(jnp.int32), axis=1), axis=2)
    return jnp.pad(gi, ((0, 0), (1, 0), (1, 0), (0, 0), (0, 0)))


def rect_grid(gint: jnp.ndarray, rect, base: int) -> jnp.ndarray:
    """Exact SSD grid of the PU `rect` from the integral image: (n, num, num)."""
    y0, x0, h, w = rect
    i0, j0 = y0 // base, x0 // base
    i1, j1 = (y0 + h) // base, (x0 + w) // base
    return (gint[:, i1, j1] - gint[:, i0, j1]
            - gint[:, i1, j0] + gint[:, i0, j0])


def layout_decision(gint: jnp.ndarray, layouts, r: int, lam: int, base: int,
                    rect_fn=None):
    """Integer-MV argmin per PU per layout + per-CTU layout costs.

    rect_fn(rect) -> (n, num, num) overrides the default CTU-major
    integral lookup (the grid-major plane path passes its own).
    Returns (costs (n, L) int32, mvs {layout: (n, P, 2)} integer MVs)."""
    if rect_fn is None:
        rect_fn = lambda rect: rect_grid(gint, rect, base)
    costs, mvs = [], {}
    for name in layouts:
        rects = PU_LAYOUTS[name]
        tot = 0
        mvl = []
        for rect in rects:
            g = rect_fn(rect)
            mv, best = _argmin_grid(g, r)
            tot = tot + best
            mvl.append(mv)
        costs.append(tot + lam * len(rects))
        mvs[name] = jnp.stack(mvl, axis=1)
    return jnp.stack(costs, axis=-1), mvs


def refine_layout(src_ctus, ref_padded, pos, rects, mvs, r: int):
    """Quarter-pel refine one PU layout: ONE fraction per PU (summed tile
    cost maps), square tiles of side min(h, w) per PU.

    mvs (n, P, 2) integer MVs.  Returns (pred (n, 64, 64) uint8,
    mv_qpel (n, P, 2)).

    Costs come from the 16-candidate cost map
    (kernels/interp_xla.refine_qpel_costmap_mxu); only the CHOSEN fraction
    is then interpolated, once per tile, via ops.pred_inter.pred_uni with
    traced per-tile fractions.  Bit-identical to sweeping predictions and
    selecting."""
    from ..kernels.interp_xla import refine_qpel_costmap_mxu
    from ..ops.pred_inter import pred_uni

    n = src_ctus.shape[0]
    tiles = []                                  # (pu_idx, ty, tx)
    t = min(rects[0][2], rects[0][3])           # uniform within a layout
    for pi, (y0, x0, hh, ww) in enumerate(rects):
        for dy in range(0, hh, t):
            for dx in range(0, ww, t):
                tiles.append((pi, y0 + dy, x0 + dx))
    m = len(tiles)
    P = len(rects)
    src_tiles = jnp.stack(
        [src_ctus[:, ty : ty + t, tx : tx + t] for (_, ty, tx) in tiles], axis=1
    ).reshape(n * m, t, t)
    offs = jnp.asarray([(ty, tx) for (_, ty, tx) in tiles], jnp.int32)
    pu_of = jnp.asarray([pi for (pi, _, _) in tiles], jnp.int32)
    mv_tiles = jnp.take_along_axis(
        mvs, pu_of[None, :, None].repeat(n, 0), axis=1
    )                                            # (n, m, 2)
    start = (pos[:, None, :] + offs[None] + mv_tiles + r).reshape(n * m, 2)
    win = motion.extract_windows(ref_padded, start, t + motion.TAPS - 1)
    _, costs = refine_qpel_costmap_mxu(src_tiles, win)
    costs = costs.reshape(n, m, 16)
    cost_pu = jnp.zeros((n, P, 16), jnp.int32).at[:, pu_of].add(costs)
    frac_pu = jnp.argmin(cost_pu, axis=-1).astype(jnp.int32)       # (n, P)
    frac_tiles = jnp.take_along_axis(
        frac_pu, pu_of[None].repeat(n, 0), axis=1
    ).reshape(n * m)
    pt = pred_uni(win, frac_tiles % 4, frac_tiles // 4)            # (n*m, t, t)
    pt = pt.reshape(n, m, t, t)
    pred = jnp.zeros((n, 64, 64), jnp.uint8)
    for ti, (_, ty, tx) in enumerate(tiles):
        pred = pred.at[:, ty : ty + t, tx : tx + t].set(pt[:, ti])
    mv_qpel = mvs * 4 + jnp.stack([frac_pu // 4, frac_pu % 4], axis=-1)
    return pred, mv_qpel


def _tile_pu_table(layouts, base: int) -> np.ndarray:
    """(L, k*k) int32: PU index owning each (base x base) tile, per layout.

    Every PU rect of every layout is a union of base tiles (base is the
    minimum PU side over the layout set and all PU dims are multiples of
    it), so ONE base tiling serves every layout's refinement."""
    import numpy as np

    k = 64 // base
    table = np.zeros((len(layouts), k * k), np.int32)
    for li, name in enumerate(layouts):
        for pi, (y0, x0, hh, ww) in enumerate(PU_LAYOUTS[name]):
            assert hh % base == 0 and ww % base == 0
            for ty in range(y0 // base, (y0 + hh) // base):
                for tx in range(x0 // base, (x0 + ww) // base):
                    table[li, ty * k + tx] = pi
    return table


def select_pu_layout_pruned(src_ctus, ref_padded, pos, windows, r: int,
                            lam: int, layouts, grid_fn):
    """PU decision with refinement PRUNED to each CTU's winning layout.

    The r3 path refined ALL layouts for ALL CTUs and then discarded all
    but the argmin (select_pu_layout) — ~6 full refine passes where ~1.2
    would do.  Here the integer-SSD layout decision runs
    first (it needs only the base-granularity grids), and the quarter-pel
    refinement runs ONCE on a single base-granularity tiling shared by
    every layout: each base tile looks up its owning PU in the chosen
    layout (_tile_pu_table gather), the per-tile 16-candidate cost maps
    (ONE batched cost-map call) sum into per-PU maps, one
    fraction is argmin'd per PU, and each tile interpolates once at its
    PU's fraction.  SAD additivity over tiles and the FIR's translation
    invariance make this bit-identical to the unpruned path's selected
    output (tests/test_partition.py).

    Returns (pred (n, 64, 64) uint8, choice (n,) int32, mv_qpel_tiles
    (n, k, k, 2) int32 per-base-tile quarter-pel MVs, best64 (n,)).
    """
    from ..kernels.interp_xla import refine_qpel_costmap_mxu
    from ..ops.pred_inter import pred_uni

    n = src_ctus.shape[0]
    base = base_for(layouts)
    k = 64 // base
    m = k * k
    pmax = max(len(PU_LAYOUTS[name]) for name in layouts)

    g = base_grid_search(src_ctus, windows, r, grid_fn, base)
    gint = grid_integral(g)
    costs, mvs = layout_decision(gint, layouts, r, lam, base)
    _, best64 = _argmin_grid(rect_grid(gint, (0, 0, 64, 64), base), r)
    choice = jnp.argmin(costs, axis=-1).astype(jnp.int32)

    # Per-tile PU index and integer MV of the CHOSEN layout only.
    table = jnp.asarray(_tile_pu_table(layouts, base))       # (L, m)
    pu_of = jnp.take(table, choice, axis=0)                  # (n, m)
    mv_tiles_l = jnp.stack(
        [jnp.take_along_axis(
            mvs[name], table[li][None, :, None].repeat(n, 0), axis=1)
         for li, name in enumerate(layouts)], axis=1)        # (n, L, m, 2)
    mv_tiles = jnp.take_along_axis(
        mv_tiles_l, choice[:, None, None, None], axis=1)[:, 0]  # (n, m, 2)

    # ONE batched cost-map call over every base tile of the frame.
    offs = jnp.asarray(
        [(ty * base, tx * base) for ty in range(k) for tx in range(k)],
        jnp.int32)                                           # (m, 2)
    src_tiles = ctu_mod.split_blocks(src_ctus, base)         # (n*m, base, base)
    start = (pos[:, None, :] + offs[None] + mv_tiles + r).reshape(n * m, 2)
    win = motion.extract_windows(ref_padded, start, base + motion.TAPS - 1)
    _, cost_t = refine_qpel_costmap_mxu(src_tiles, win)
    cost_t = cost_t.reshape(n, m, 16)

    # Tile maps -> per-PU maps; ONE fraction per PU (masked one-hot sum,
    # a fused elementwise pass instead of a scatter-add).
    onehot = (pu_of[:, :, None] == jnp.arange(pmax, dtype=jnp.int32)[None, None])
    cost_pu = jnp.sum(
        jnp.where(onehot[..., None], cost_t[:, :, None, :], 0), axis=1
    )                                                        # (n, pmax, 16)
    frac_pu = jnp.argmin(cost_pu, axis=-1).astype(jnp.int32)  # (n, pmax)
    frac_t = jnp.take_along_axis(frac_pu, pu_of, axis=1).reshape(n * m)

    # Interpolate each tile ONCE at its PU's fraction, assemble the CTU.
    pt = pred_uni(win, frac_t % 4, frac_t // 4)              # (n*m, base, base)
    pred = ctu_mod.merge_blocks(pt.reshape(n * m, base, base), 64)
    frac2 = frac_t.reshape(n, m)
    mv_qpel = mv_tiles * 4 + jnp.stack(
        [frac2 // 4, frac2 % 4], axis=-1)                    # (n, m, 2)
    return pred, choice, mv_qpel.reshape(n, k, k, 2), best64


def select_pu_layout(src_ctus, ref_padded, pos, windows, r: int, lam: int,
                     layouts, grid_fn):
    """The full PU decision: base search -> integral grids -> per-layout
    costs/MVs -> per-layout refinement -> per-CTU layout selection.

    Returns (pred (n, 64, 64) uint8, choice (n,) int32 index into
    `layouts`, mv_qpel {layout: (n, P, 2)}, best64 (n,) int32 whole-CTU
    best integer SSD)."""
    base = base_for(layouts)
    g = base_grid_search(src_ctus, windows, r, grid_fn, base)
    gint = grid_integral(g)
    costs, mvs = layout_decision(gint, layouts, r, lam, base)
    choice = jnp.argmin(costs, axis=-1).astype(jnp.int32)

    _, best64 = _argmin_grid(rect_grid(gint, (0, 0, 64, 64), base), r)

    preds, mvq = [], {}
    for name in layouts:
        p, q = refine_layout(src_ctus, ref_padded, pos, PU_LAYOUTS[name],
                             mvs[name], r)
        preds.append(p)
        mvq[name] = q
    preds = jnp.stack(preds, axis=1)                     # (n, L, 64, 64)
    pred = jnp.take_along_axis(
        preds, choice[:, None, None, None], axis=1
    )[:, 0]
    return pred, choice, mvq, best64


def multi_level_search(src_ctus: jnp.ndarray, windows: jnp.ndarray, r: int,
                       grid_fn, base: int = 16):
    """Square-level search dict (kept for the aggregation tests and any
    caller wanting the classic 64/32/16 levels): one base-granularity
    search aggregated exactly to every level.

    Returns mv16 (n, 4, 4, 2), mv32 (n, 2, 2, 2), mv64 (n, 2) + bests."""
    g = base_grid_search(src_ctus, windows, r, grid_fn, 16)
    gint = grid_integral(g)
    out = {}
    for name, key in (("quarter", "16"), ("NxN", "32"), ("2Nx2N", "64")):
        rects = PU_LAYOUTS[name]
        mvl, bl = [], []
        for rect in rects:
            mv, best = _argmin_grid(rect_grid(gint, rect, 16), r)
            mvl.append(mv)
            bl.append(best)
        k = int(len(rects) ** 0.5)
        n = src_ctus.shape[0]
        if k == 1:
            out[f"mv{key}"] = mvl[0]
            out[f"best{key}"] = bl[0]
        else:
            out[f"mv{key}"] = jnp.stack(mvl, axis=1).reshape(n, k, k, 2)
            out[f"best{key}"] = jnp.stack(bl, axis=1).reshape(n, k, k)
    return out


def select_tu_recon(src_ctus, pred, cfg, tu_sizes, intra: bool = False):
    """Run the residual pipeline at each candidate TU size and pick per CTU
    by the RD cost  SSD + lambda * bits  with REAL Exp-Golomb bits from the
    quantized levels (encode/rate.bits_estimate's model, emitted per CTU by
    the frame residual pipeline) and the HM lambda (mv_lambda).  The r3
    rate proxy lam*nnz*tu measured r = -0.82 correlation against actual
    bits across TU sizes (larger TUs compact energy into fewer, LARGER
    levels) — pricing real bits fixed the model.
    Exercises the 4/8/16/32 transforms end-to-end.

    Returns (recon (n, 64, 64) uint8, tu_choice (n,) int32 index into
    tu_sizes, nnz () int32 of the selected blocks)."""
    import dataclasses

    from ..kernels.xla_opt import residual_pipeline_frame

    n = src_ctus.shape[0]
    lam = mv_lambda(cfg.qp)
    recs, costs, nnzs = [], [], []
    for tu in tu_sizes:
        c = dataclasses.replace(cfg, tu=tu)
        tr_type = 1 if (intra and c.tu == 4) else 0
        scale, shift, offset = c.quant_params(intra)
        dscale, dshift = c.dequant_params()
        rec, _, cbf, bits = residual_pipeline_frame(
            src_ctus, pred, scale, shift, offset, dscale, dshift,
            tu=tu, tr_type=tr_type,
        )
        k = (64 // tu) ** 2
        nnz_tu = cbf.reshape(n, k).sum(axis=-1)             # coded-TU count
        d = src_ctus.astype(jnp.int32) - rec.astype(jnp.int32)
        dist = jnp.sum(d * d, axis=(-2, -1))
        costs.append(dist + lam * bits)
        recs.append(rec)
        nnzs.append(nnz_tu)
    costs = jnp.stack(costs, axis=-1)                       # (n, num_tu)
    choice = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    recs = jnp.stack(recs, axis=1)                          # (n, num_tu, 64, 64)
    recon = jnp.take_along_axis(
        recs, choice[:, None, None, None], axis=1
    )[:, 0]
    nnz_sel = jnp.take_along_axis(
        jnp.stack(nnzs, axis=-1), choice[:, None], axis=-1
    )[:, 0]
    return recon, choice, jnp.sum(nnz_sel)
