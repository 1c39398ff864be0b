"""Multi-chip sharding of the encode loop (SURVEY.md section 2.3: greenfield
components mandated by BASELINE configs 4-5; the reference has no parallelism
of any kind).

Two axes:

* ``frames`` (data parallel): open-loop IPPP makes every P frame depend only
  on source frames, so a GOP's P frames shard perfectly across chips; XLA/
  GSPMD partitions the vmapped per-frame program with no communication except
  final reductions.

* ``rows`` (spatial): a frame's CTU-row bands shard across chips; each band
  needs a halo of (search_range + filter pad) reference rows from its
  neighbours, exchanged with jax.lax.ppermute inside shard_map — the video
  analogue of ring/context-parallel neighbour exchange.  The result is
  bit-identical to the single-chip encode (verified in tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..encode import ctu as ctu_mod
from ..encode import motion
from ..encode.loop import EncodeConfig, encode_inter_frame, _inter_core
from ..utils.psnr import psnr

__all__ = [
    "make_mesh",
    "encode_p_frames_batch",
    "encode_gop_data_parallel",
    "encode_inter_frame_spatial",
    "encode_gop_closed_loop_spatial",
]


def make_mesh(frames: int = 1, rows: int = 1, devices=None) -> Mesh:
    """A (frames, rows) device mesh.  frames*rows must equal the device count
    used; axis names: 'frames' (dp over GOP frames), 'rows' (spatial)."""
    if devices is None:
        devices = jax.devices()[: frames * rows]
    dev = np.asarray(devices).reshape(frames, rows)
    return Mesh(dev, axis_names=("frames", "rows"))


@functools.partial(jax.jit, static_argnames=("cfg",))
def encode_p_frames_batch(curs: jnp.ndarray, refs: jnp.ndarray, cfg: EncodeConfig = EncodeConfig()):
    """vmap of encode_inter_frame over a leading frame axis: (T, H, W) x 2.

    Shard the leading axis over the 'frames' mesh axis (device_put with
    NamedSharding) and GSPMD partitions the whole program data-parallel."""
    fn = functools.partial(encode_inter_frame, cfg=cfg)
    return jax.vmap(fn)(curs, refs)


def encode_gop_data_parallel(frames: jnp.ndarray, mesh: Mesh, cfg: EncodeConfig = EncodeConfig()):
    """BASELINE config 4: IPPP GOP with P frames sharded over mesh axis
    'frames'.  frames: (T, H, W) with (T-1) divisible by the axis size."""
    curs, refs = frames[1:], frames[:-1]
    sh = NamedSharding(mesh, P("frames", None, None))
    curs = jax.device_put(curs, sh)
    refs = jax.device_put(refs, sh)
    return encode_p_frames_batch(curs, refs, cfg)


def _exchange_halo(band: jnp.ndarray, top: int, bottom: int, axis: str) -> jnp.ndarray:
    """Concatenate ppermute-received neighbour rows above/below a band.

    Edge devices replicate their own edge rows, matching the single-chip
    pad_frame(mode='edge') semantics exactly.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)

    if n == 1:
        top_rows = jnp.repeat(band[:1], top, axis=0)
        bot_rows = jnp.repeat(band[-1:], bottom, axis=0)
        return jnp.concatenate([top_rows, band, bot_rows], axis=0)

    # My top halo = bottom `top` rows of device idx-1 (shift downward).
    from_above = jax.lax.ppermute(
        band[-top:], axis, perm=[(i, i + 1) for i in range(n - 1)]
    )
    # My bottom halo = top `bottom` rows of device idx+1 (shift upward).
    from_below = jax.lax.ppermute(
        band[:bottom], axis, perm=[(i + 1, i) for i in range(n - 1)]
    )
    # Edge replication where no neighbour exists.
    top_edge = jnp.repeat(band[:1], top, axis=0)
    bot_edge = jnp.repeat(band[-1:], bottom, axis=0)
    top_rows = jnp.where((idx == 0), top_edge, from_above)
    bot_rows = jnp.where((idx == n - 1), bot_edge, from_below)
    return jnp.concatenate([top_rows, band, bot_rows], axis=0)


def _band_frame_step(cur_band, ref_band, cfg: EncodeConfig, band_h: int,
                     w: int, h: int):
    """One inter-frame step on this device's CTU-row band, inside a
    shard_map over axis 'rows': halo exchange, then the SAME inter engine
    as one device (loop._inter_core; each band owns its haloed plane).
    Returns (recon_band, best_sad, nnz, psnr) with nnz/psnr already
    psum-reduced over 'rows'."""
    if cfg.me_strategy == "pyramid":
        # The coarse pyramid level would decimate the halo-extended band
        # with band-local positions — silently wrong across shard
        # boundaries; refuse rather than mis-search (fail-loudly rule).
        raise ValueError("spatial sharding supports me_strategy='full' only")
    r = cfg.search_range
    halo_t, halo_b = r + motion.PAD_L, r + motion.PAD_R
    # Vertical halo via neighbour exchange; horizontal via local edge pad.
    ref_v = _exchange_halo(ref_band, halo_t, halo_b, "rows")
    ref_padded = ctu_mod.pad_frame(ref_v, 0, 0, halo_t, halo_b)

    gr, gc = ctu_mod.grid_shape(band_h, w, cfg.ctu)
    src_ctus = ctu_mod.tile_frame(cur_band, cfg.ctu)
    pos = motion.ctu_positions(gr, gc, cfg.ctu)
    rec_ctus, mv_qpel, best_sad, nnz = _inter_core(
        src_ctus, ref_v, ref_padded, pos, cfg, (gr, gc)
    )
    recon = ctu_mod.untile_frame(rec_ctus, band_h, w)
    d = cur_band.astype(jnp.float32) - recon.astype(jnp.float32)
    sse = jax.lax.psum(jnp.sum(d * d), "rows")
    mse = sse / (h * w)
    frame_psnr = 10.0 * jnp.log10(255.0 * 255.0 / jnp.maximum(mse, 1e-10))
    return recon, best_sad, jax.lax.psum(nnz, "rows"), frame_psnr


def encode_inter_frame_spatial(
    cur: jnp.ndarray, ref: jnp.ndarray, mesh: Mesh, cfg: EncodeConfig = EncodeConfig()
):
    """BASELINE config 5 core: one inter frame with CTU-row bands sharded
    over mesh axis 'rows', reference-window halos exchanged via ppermute.

    cur, ref: (H, W); H must split into mesh.shape['rows'] bands of whole
    CTUs.  Returns {recon (H, W), psnr_db, sad, nnz}; recon is bit-identical
    to encode_inter_frame on one chip.
    """
    h, w = cur.shape
    nrows = mesh.shape["rows"]
    band_h = h // nrows
    assert band_h * nrows == h and band_h % cfg.ctu == 0

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P("rows", None), P("rows", None)),
        out_specs={
            "recon": P("rows", None),
            "sad": P("rows"),
            "nnz": P(),
            "psnr_db": P(),
        },
        check_vma=False,
    )
    def step(cur_band, ref_band):
        cur_band = cur_band.reshape(band_h, w)
        ref_band = ref_band.reshape(band_h, w)
        recon, best_sad, nnz, frame_psnr = _band_frame_step(
            cur_band, ref_band, cfg, band_h, w, h
        )
        return {
            "recon": recon,
            "sad": best_sad,
            "nnz": nnz,
            "psnr_db": frame_psnr,
        }

    return jax.jit(step)(cur, ref)


def encode_gop_closed_loop_spatial(
    frames_y: jnp.ndarray, mesh: Mesh, cfg: EncodeConfig = EncodeConfig()
):
    """BASELINE config 5: closed-loop IPPP GOP (every P frame predicted from
    the previous frame's RECONSTRUCTION) with each frame's CTU-row bands
    sharded over mesh axis 'rows' — the conforming-encoder GOP chain of
    encode/video.encode_gop_closed_loop, spatially distributed.

    Frame 0 is encoded with the closed-loop wavefront intra encoder (its
    wave schedule is sequential, so it runs replicated outside the
    shard_map; one frame of T) and seeds the chain — the same conforming
    I+P chain as encode/video.encode_gop_closed_loop.  The
    lax.scan over P frames runs INSIDE one shard_map: per frame, each
    device encodes its band after a ppermute halo exchange of the previous
    reconstruction; only the (halo_t + halo_b) boundary rows ever cross
    chips.  frames_y: (T, H, W) uint8.  Returns {recon (T, H, W) with the
    I frame first, psnr_db (T,)} bit-identical to the single-chip
    closed-loop GOP (tests/test_parallel.py).
    """
    from ..encode.intra_wavefront import encode_intra_frame_wavefront

    t, h, w = frames_y.shape
    nrows = mesh.shape["rows"]
    band_h = h // nrows
    assert band_h * nrows == h and band_h % cfg.ctu == 0

    intra = encode_intra_frame_wavefront(frames_y[0], cfg)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(None, "rows", None), P("rows", None)),
        out_specs={"recon": P(None, "rows", None), "psnr_db": P()},
        check_vma=False,
    )
    def run(frames_band, seed_band):
        frames_band = frames_band.reshape(t - 1, band_h, w)
        seed_band = seed_band.reshape(band_h, w)

        def body(prev_band, cur_band):
            recon, _, _, frame_psnr = _band_frame_step(
                cur_band, prev_band, cfg, band_h, w, h
            )
            return recon, (recon, frame_psnr)

        _, (recs, psnrs) = jax.lax.scan(body, seed_band, frames_band)
        return {"recon": recs, "psnr_db": psnrs}

    sh = NamedSharding(mesh, P(None, "rows", None))
    out = jax.jit(run)(
        jax.device_put(frames_y[1:], sh),
        jax.device_put(intra["recon"], NamedSharding(mesh, P("rows", None))),
    )
    return {
        "recon": jnp.concatenate([intra["recon"][None], out["recon"]]),
        "psnr_db": jnp.concatenate([intra["psnr_db"][None], out["psnr_db"]]),
    }
