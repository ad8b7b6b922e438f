"""Config-driven CLI, drop-in compatible with the reference's main.cpp.

Usage:  python -m imageencoder_tpu <settings.conf> [--mode encode|decode|both]
        [--backend numpy|jax] [--no-huffman] [--trace]

The settings file uses the reference's key=value schema (bin/ex*.conf run
unchanged).  Mode detection follows main.cpp:34-52: image configs carry the
full 8-key image schema; video encoder configs add gop/merange; video
decoder configs carry encfile/decfile/motioncompensation.  The reference
ships separate encoder/decoder binaries (-DENCODER/-DDECODER, main.cpp:10-17)
or a combined build; --mode selects the equivalent behaviour (default both,
like the combined build).
"""

from __future__ import annotations

import argparse
import sys
import time

from .models.image import ImageDecoder, ImageEncoder
from .models.video import VideoDecoder, VideoEncoder
from .utils.config import ConfigReader
from .utils.logger import Logger
from .utils.quant import QuantMatrix


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="imageencoder_tpu", description=__doc__)
    ap.add_argument("config", help="key=value settings file (reference schema)")
    ap.add_argument("--mode", choices=["encode", "decode", "both"], default="both")
    ap.add_argument("--backend", choices=["numpy", "fast", "jax"],
                    default="numpy",
                    help="numpy = bit-parity float64; fast = host float32 "
                         "BLAS (+-1 on ~0.003%% of pixels); jax = device "
                         "(GPU) path")
    ap.add_argument("--no-huffman", action="store_true",
                    help="disable the whole-stream Huffman pass")
    ap.add_argument("--ref-mode", choices=["raw", "recon"], default="raw",
                    help="video motion reference: raw = shipped-binary "
                         "parity (fully parallel), recon = source-code "
                         "semantics (tracks the decoder more closely)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="video encode: persist per-GOP segments here and "
                         "resume after interruption (utils/checkpoint.py)")
    ap.add_argument("--workers", type=int, default=0,
                    help="video decode: decode this many GOPs in parallel "
                         "(GOPs are data-independent; output is identical "
                         "to the serial decode)")
    ap.add_argument("--block-size", type=int, default=4, choices=[4, 8],
                    help="image transform block size (reference supports 4; "
                         "8 requires --norm ortho)")
    ap.add_argument("--trace", action="store_true",
                    help="print a per-stage timing table for each encode/"
                         "decode (utils/profiling.py ambient trace)")
    ap.add_argument("--norm", choices=["reference", "ortho"],
                    default="reference",
                    help="DCT scaling: reference = 4x4-only C() quirk "
                         "(bit parity), ortho = correct for any size")
    args = ap.parse_args(argv)

    c = ConfigReader()
    if not c.read(args.config):
        print(f"Error reading file '{args.config}': {c.error}", file=sys.stderr)
        return 2
    mode = c.detect_mode()
    if mode == "invalid":
        print(f"Error in settings! {c.error}", file=sys.stderr)
        return 3

    if args.backend == "jax":
        from .utils.jaxcache import configure_compile_cache

        configure_compile_cache()
    Logger.create(c.get("logfile"))
    use_huffman = not args.no_huffman
    try:
        return _run(c, mode, args, use_huffman)
    except OSError as e:
        # Reference behaviour: file-level errors abort with a message
        # (ImageBase.cpp:22-27 exits -1 at read time).
        print(str(e), file=sys.stderr)
        return 1


def _run(c, mode, args, use_huffman) -> int:
    import contextlib

    from .utils import profiling

    def traced(name, pixels=None):
        """--trace: collect the library's ambient stage() marks and print
        the per-stage table after the operation; otherwise free."""
        if not args.trace:
            return contextlib.nullcontext()
        return _Reporting(name, pixels)

    class _Reporting:
        def __init__(self, name, pixels):
            self._cm = profiling.tracing(name, pixels)

        def __enter__(self):
            self._t = self._cm.__enter__()
            return self._t

        def __exit__(self, *exc):
            r = self._cm.__exit__(*exc)
            if exc[0] is None:
                self._t.report()
            return r

    if mode == "image":
        quant = QuantMatrix.from_file(c.get("quantfile"), size=args.block_size)
        w, h = int(c.get("width")), int(c.get("height"))
        rle = bool(int(c.get("rle")))
        if args.mode in ("encode", "both"):
            t0 = time.perf_counter()
            enc = ImageEncoder(c.get("rawfile"), c.get("encfile"), w, h, rle,
                               quant, use_huffman=use_huffman,
                               backend=args.backend, norm=args.norm,
                               block_size=args.block_size)
            with traced("image encode", w * h):
                enc.process()
            enc.save_result()
            Logger.write(f"Elapsed time: {1e3 * (time.perf_counter() - t0):.3f} ms")
        if args.mode in ("decode", "both"):
            t0 = time.perf_counter()
            dec = ImageDecoder(c.get("encfile"), c.get("decfile"),
                               backend=args.backend, norm=args.norm,
                               block_size=args.block_size)
            with traced("image decode", w * h):
                dec.process()
            dec.save_result()
            Logger.write(f"Elapsed time: {1e3 * (time.perf_counter() - t0):.3f} ms")
        return 0

    if mode == "video-encode":
        quant = QuantMatrix.from_file(c.get("quantfile"),
                                      size=args.block_size)
        t0 = time.perf_counter()
        if args.mode == "decode":
            pass  # decode-only run on an encoder-schema config
        elif args.checkpoint_dir:
            from .utils.checkpoint import encode_video_checkpointed

            with open(c.get("rawfile"), "rb") as f:
                data = f.read()
            Logger.write("[VideoEncoder] Processing video (checkpointed)...")
            result = encode_video_checkpointed(
                data, int(c.get("width")), int(c.get("height")), quant,
                bool(int(c.get("rle"))), int(c.get("gop")),
                int(c.get("merange")), args.checkpoint_dir,
                use_huffman=use_huffman, backend=args.backend,
                ref_mode=args.ref_mode)
            with open(c.get("encfile"), "wb") as f:
                f.write(result)
            Logger.write(f"[VideoEncoder] Encoded size: {len(result)} bytes"
                         f" => Ratio: {len(result) / len(data) * 100:.2f}%")
        else:
            enc = VideoEncoder(c.get("rawfile"), c.get("encfile"),
                               int(c.get("width")), int(c.get("height")),
                               bool(int(c.get("rle"))), quant,
                               int(c.get("gop")), int(c.get("merange")),
                               use_huffman=use_huffman, backend=args.backend,
                               ref_mode=args.ref_mode, norm=args.norm,
                               block_size=args.block_size)
            with traced("video encode"):
                enc.process()
            enc.save_result()
        if args.mode != "decode":
            Logger.write(f"Elapsed time: {1e3 * (time.perf_counter() - t0):.3f} ms")
        if "decfile" in c.values and args.mode in ("decode", "both"):
            dec = VideoDecoder(c.get("encfile"), c.get("decfile"),
                               motioncomp=bool(int(c.get("motioncompensation", "1"))),
                               backend=args.backend, workers=args.workers,
                               norm=args.norm, block_size=args.block_size)
            with traced("video decode"):
                dec.process()
            dec.save_result()
        elif args.mode == "decode":
            # A decode-only run was requested but this encoder-schema config
            # names no decfile: silently returning 0 would read as success.
            print("--mode decode requested but the config has no decfile; "
                  "nothing was decoded", file=sys.stderr)
            return 4
        return 0

    # video-decode
    if args.mode == "encode":
        print("config is a video-decode job; nothing to encode",
              file=sys.stderr)
        return 3
    t0 = time.perf_counter()
    dec = VideoDecoder(c.get("encfile"), c.get("decfile"),
                       motioncomp=bool(int(c.get("motioncompensation"))),
                       backend=args.backend, workers=args.workers,
                       norm=args.norm, block_size=args.block_size)
    with traced("video decode"):
        dec.process()
    dec.save_result()
    Logger.write(f"Elapsed time: {1e3 * (time.perf_counter() - t0):.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
