"""Command-line entry point: ``python -m hevcasm_tpu`` runs the self-test
(the role of the reference's hevcasm executable, src/bin/main.c:39-42);
subcommands expose the encode loop and benchmarks."""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .config import Tier


def _cmd_selftest(args):
    from . import selftest

    mask = Tier.ALL
    if args.tiers:
        mask = Tier.NONE
        for t in args.tiers.split(","):
            try:
                mask |= Tier[t.strip().upper()]
            except KeyError:
                valid = ", ".join(m.name.lower() for m in (Tier.REF, Tier.JIT))
                print(f"error: unknown tier '{t}' (valid: {valid})", file=sys.stderr)
                return 2
    suites = args.suites.split(",") if getattr(args, "suites", None) else None
    return selftest.main(
        mask=mask,
        time_it=not args.no_time,
        suites=suites,
        json_path=getattr(args, "json", None),
        converged=getattr(args, "converged", False),
    )


def _cmd_encode(args):
    import jax.numpy as jnp

    from .encode import encode_gop, EncodeConfig

    cfg = EncodeConfig(
        qp=args.qp, search_range=args.search_range,
        me_strategy="pyramid" if args.pyramid else "full",
    )

    if args.input:
        return _encode_file(args, cfg)

    rng = np.random.default_rng(0)
    frames = _synthetic_video(rng, args.frames, args.height, args.width)
    out = encode_gop(jnp.asarray(frames), cfg)
    print(
        json.dumps(
            {
                "frames": args.frames,
                "size": f"{args.width}x{args.height}",
                "qp": args.qp,
                "psnr_db": float(out["psnr_db"]),
                "nnz": int(out["nnz"]),
            }
        )
    )
    return 0


def _encode_file(args, cfg):
    """Encode a .y4m / raw .yuv clip (4:2:0) and optionally write the
    reconstruction as .y4m."""
    import jax.numpy as jnp

    from . import io as yio
    from .encode.video import YuvFrame, encode_gop_yuv

    frames = list(yio.iter_frames(args.input, width=args.width, height=args.height))
    if args.frames:
        frames = frames[: args.frames]
    if not frames:
        print("error: no frames read", file=sys.stderr)
        return 1
    h, w = frames[0].y.shape
    # Crop to CTU multiples.
    h64, w64 = h // 64 * 64, w // 64 * 64
    gop = YuvFrame(
        jnp.asarray(np.stack([f.y[:h64, :w64] for f in frames])),
        jnp.asarray(np.stack([f.cb[: h64 // 2, : w64 // 2] for f in frames])),
        jnp.asarray(np.stack([f.cr[: h64 // 2, : w64 // 2] for f in frames])),
    )
    out = encode_gop_yuv(gop, cfg, b_frames=args.b_frames)
    if args.output:
        rec = out["recon"]
        yio.write_y4m(
            args.output,
            [yio.YuvArrays(np.asarray(rec.y[t]), np.asarray(rec.cb[t]), np.asarray(rec.cr[t]))
             for t in range(rec.y.shape[0])],
            w64, h64,
        )
    print(
        json.dumps(
            {
                "input": args.input,
                "frames": int(gop.y.shape[0]),
                "size": f"{w64}x{h64}",
                "qp": cfg.qp,
                "psnr_y_db": float(out["psnr_y"]),
                "nnz": int(out["nnz"]),
                "output": args.output or None,
            }
        )
    )
    return 0


def _synthetic_video(rng, t, h, w):
    """Moving-texture synthetic clip: global pan + noise, so motion search
    has real structure to find."""
    base = rng.integers(0, 256, (h + 2 * t + 64, w + 2 * t + 64), dtype=np.uint8)
    frames = np.empty((t, h, w), dtype=np.uint8)
    for i in range(t):
        dy, dx = 2 * i, 3 * i
        frames[i] = base[dy : dy + h, dx : dx + w]
    noise = rng.integers(-2, 3, frames.shape)
    return np.clip(frames.astype(np.int16) + noise, 0, 255).astype(np.uint8)


def _cmd_info(_args):
    """Device + tier availability report: the analogue of
    hevcasm_print_instruction_set_support (hevcasm.c:141-149)."""
    import jax

    from . import registry

    print(f"jax {jax.__version__}, backend {jax.default_backend()}")
    for d in jax.devices():
        print(f"  device: {d}")
    print("\nop families and registered tiers:")
    for op in registry.ops():
        tiers = registry.tiers_of(op)
        names = [t.name for t in (Tier.REF, Tier.JIT) if tiers & t]
        print(f"  {op:24s} {' '.join(names)}")
    return 0


def _apply_platform(platform: str | None):
    """Select the jax backend BEFORE first device use.

    The reference binary runs on any host (src/bin/main.c:39-42): 'cpu'
    runs anywhere, 'gpu' insists on a GPU (JAX fails at start-up without
    one), 'auto' leaves JAX's own choice."""
    if platform and platform != "auto":
        import jax

        jax.config.update("jax_platforms", platform)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="hevcasm_tpu")
    p.add_argument(
        "--platform",
        choices=["auto", "cpu", "gpu"],
        default=None,
        help="jax backend to use (default: auto-detect; 'cpu' runs anywhere)",
    )
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="device + implementation-tier report")

    st = sub.add_parser("selftest", help="kernel self-test + micro-benchmarks")
    st.add_argument("--tiers", help="comma list: ref,jit (default all)")
    st.add_argument("--suites", help="comma list of suite names (default all)")
    st.add_argument("--no-time", action="store_true")
    st.add_argument("--converged", action="store_true",
                    help="converging-averager timing (reference "
                         "hevcasm_test.c semantics) instead of best-of-k")
    st.add_argument("--json", help="write structured results to this path ('-' = stdout)")

    enc = sub.add_parser("encode", help="encode a .y4m/.yuv clip or a synthetic GOP")
    enc.add_argument("--input", help=".y4m or raw .yuv file (default: synthetic)")
    enc.add_argument("--output", help="write reconstruction as .y4m")
    enc.add_argument("--frames", type=int, default=4)
    enc.add_argument("--width", type=int, default=640)
    enc.add_argument("--height", type=int, default=384)
    enc.add_argument("--qp", type=int, default=32)
    enc.add_argument("--search-range", type=int, default=16)
    enc.add_argument("--pyramid", action="store_true", help="hierarchical ME")
    enc.add_argument("--b-frames", action="store_true", help="IBPB GOP structure")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    _apply_platform(args.platform)
    from .utils.cache import enable_persistent_cache

    enable_persistent_cache()
    if args.cmd == "info":
        return _cmd_info(args)
    if args.cmd == "encode":
        return _cmd_encode(args)
    if args.cmd == "selftest" or args.cmd is None:
        if args.cmd is None:
            args = argparse.Namespace(tiers=None, no_time=False, json=None,
                                      converged=False)
        return _cmd_selftest(args)
    p.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
