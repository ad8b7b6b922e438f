"""Smoke test of the codec's device path on NVIDIA GPUs.

    python chip_smoke.py              # one card: every single-device phase
    python chip_smoke.py --devices 4  # four cards: only the sharded paths
                                      # and the single-device streams they
                                      # must equal

Drives the user entry points (encode_image / decode_image / the batch and
stream encoders / encode_video / decode_video / the CLI) at the sizes the
repository treats as real: still images at 912x4096 and video at 1280x720
x 25 frames, GOP 4, merange 16.  Inputs are generated from a seed; the
quantization matrices are the in-tree fixtures (tests/fixtures/).

Every check compares the device result with the exact host path:
  * streams decode with the exact host decoder;
  * quantized coefficients and decoded pixels differ from the float64
    path by exactly +-1 on at most 0.5% of values (f32 at HIGHEST vs the
    exact f64 order can only flip a y/q within f32 rounding of a .5 tie);
  * batch and stream encodes are byte-identical to single-image encodes;
  * raw-reference motion vectors are identical to the host search (SADs
    are integers); recon-reference PSNR is within 0.1 dB of the host's;
  * the SAD-map kernel's maps equal the plain scan's bit for bit.

The script fails (non-zero exit, no result line) when JAX finds no GPU or
when any check fails, and before any output when the package is not beside
it.  Its last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.  One process uses
the card(s); the CLI phase runs in this process.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from imageencoder_tpu.utils.synth import seeded_image, seeded_video

IMG_H, IMG_W = 912, 4096
VID_W, VID_H, VID_F, GOP, MERANGE = 1280, 720, 25, 4, 16
# Sharded video: 720 rows are 45 macroblock rows, which two stripes cannot
# split, and 25 frames do not split over two frame chunks, so the 2x2 mesh
# takes 704-row frames, 24 of them.
SHARD_VID_H, SHARD_VID_F = 704, 24
SAD_SHAPES = [(2, VID_H, VID_W), (1, 2160, 3840)]  # kernel vs scan
MAX_TIE_SHARE = 0.005
STAGES = ("transform", "rle_fields", "pack", "histogram", "motion_search",
          "idct")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def log(msg):
    print(msg, flush=True)


def device_facts(n_devices: int):
    """Device facts; raises unless JAX runs on at least n GPUs."""
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"JAX found no GPU (platform {devs[0].platform!r})")
    check(len(devs) >= n_devices,
          f"{n_devices} GPUs requested, JAX sees {len(devs)}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for line in smi.splitlines():
        log(f"card: {line}")

    from imageencoder_tpu.runtime import build, native
    from imageencoder_tpu.utils.jaxcache import configure_compile_cache

    so = build.build()
    check(native.available(), "native runtime did not load")
    log(f"native runtime: {so} built from {build.HERE / 'runtime.cpp'}, "
        f"loaded")
    log(f"compile cache: {configure_compile_cache()}")
    return devs


def stream_coeffs(data: bytes, block_size: int) -> np.ndarray:
    """Quantized coefficients [N, B, B] of an image stream (host parse)."""
    from imageencoder_tpu.models.headers import read_image_header
    from imageencoder_tpu.models.image import extract_block_coeffs
    from imageencoder_tpu.ops.bitpack import BitReader
    from imageencoder_tpu.ops.huffman import huffman_decode

    if data[0] & 0x80:
        payload, start = huffman_decode(data), 0
    else:
        payload, start = data, 1
    reader = BitReader(bytes(payload[:65536]), position=start)
    _, use_rle, w, h = read_image_header(reader, block_size)
    n = (w // block_size) * (h // block_size)
    coeffs, _ = extract_block_coeffs(None, reader.position, n, use_rle,
                                     block_size, packed=bytes(payload))
    return np.asarray(coeffs, np.int64)


def tie_share(a, b, what):
    """Share of values that differ; raises unless every difference is
    exactly +-1 and at most MAX_TIE_SHARE of values differ."""
    d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
    check(d.shape == np.asarray(b).shape and d.max() <= 1,
          f"{what}: max difference {d.max()} (only +-1 ties allowed)")
    share = float((d != 0).mean())
    check(share <= MAX_TIE_SHARE,
          f"{what}: {share:.4%} of values differ (limit "
          f"{MAX_TIE_SHARE:.1%})")
    return share


def best_of(fn, n=3):
    """(result, min wall seconds) over n calls; fn blocks on its result."""
    out, best = None, float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return out, best


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


def memory_line(compiled, dev):
    ma = compiled.memory_analysis()
    peak = peak_bytes(dev)
    return (f"memory: args {ma.argument_size_in_bytes} B, out "
            f"{ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B; "
            f"peak_bytes_in_use {peak} B")


def image_phase(img, quant, block_size, norm, dev):
    import jax.numpy as jnp

    from imageencoder_tpu.models.headers import write_image_header
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.ops.device_pack import header_to_words
    from imageencoder_tpu.ops.pipeline import make_encode_packed_hist

    tag = f"image {img.shape[0]}x{img.shape[1]} B={block_size} {norm}"
    streams = {}
    for huff in (True, False):
        def enc():
            return encode_image(img, quant, True, huff, norm, "jax",
                                block_size)

        t0 = time.perf_counter()
        s = enc()
        first = time.perf_counter() - t0
        s, warm = best_of(enc)
        exact = encode_image(img, quant, True, huff, norm, "numpy",
                             block_size)
        px = decode_image(s, norm, "numpy", block_size)
        check(px.shape == img.shape, f"{tag}: decoded shape {px.shape}")
        share = tie_share(stream_coeffs(s, block_size),
                          stream_coeffs(exact, block_size),
                          f"{tag} huffman={huff} coefficients")
        log(f"{tag} huffman={huff}: {len(s)} B (exact path {len(exact)} B), "
            f"first call {first:.3f} s (compile incl.), warm {warm * 1e3:.2f}"
            f" ms, coefficient tie share {share:.5%}")
        streams[huff] = s

    w = BitWriter()
    write_image_header(w, quant, True, img.shape[1], img.shape[0])
    args = (jnp.asarray(img), jnp.asarray(quant.as_float(np.float32)),
            np.int32(w.position), jnp.asarray(header_to_words(w.getvalue())))
    compiled = make_encode_packed_hist(block_size, True, norm).lower(
        *args).compile()
    log(f"{tag} " + memory_line(compiled, dev))
    return streams[True], compiled.as_text()


def serving_phase(img, quant, single, dev):
    from imageencoder_tpu.models.batch import (encode_image_batch,
                                               encode_image_stream)
    from imageencoder_tpu.models.image import decode_image, encode_image

    imgs = np.stack([np.roll(img, 13 * i, axis=1) for i in range(8)])
    ones = [encode_image(im, quant, True, True, backend="jax") for im in imgs]
    check(ones[0] == single, "single-image encode is not deterministic")
    batch, bt = best_of(lambda: encode_image_batch(imgs, quant, True, True),
                        2)
    check(batch == ones, "encode_image_batch != single-image streams")
    stream, st = best_of(
        lambda: list(encode_image_stream(imgs, quant, True, True)), 2)
    check(stream == ones, "encode_image_stream != single-image streams")
    log(f"batch(8): byte-identical, {bt * 1e3:.1f} ms; stream(8): "
        f"byte-identical, {st * 1e3:.1f} ms")

    dj, djt = best_of(lambda: decode_image(single, backend="jax"))
    dn = decode_image(single, backend="numpy")
    share = tie_share(dj, dn, "decode_image jax pixels")
    log(f"decode_image jax: warm {djt * 1e3:.2f} ms, pixel tie share "
        f"{share:.5%}; peak_bytes_in_use {peak_bytes(dev)} B")


def video_phase(quant, rng, dev):
    from imageencoder_tpu.models.video import (decode_video, encode_video,
                                               parse_video_stream)
    from imageencoder_tpu.utils.metrics import psnr

    data, ys = seeded_video(rng, VID_W, VID_H, VID_F)
    tag = f"video {VID_W}x{VID_H}x{VID_F} gop {GOP} merange {MERANGE}"

    def enc(backend, ref_mode):
        return encode_video(data, VID_W, VID_H, quant, True, GOP, MERANGE,
                            use_huffman=True, backend=backend,
                            ref_mode=ref_mode)

    def y_planes(yuv):
        fs = VID_W * VID_H * 3 // 2
        return np.frombuffer(yuv, np.uint8).reshape(-1, fs)[
            :, :VID_W * VID_H].reshape(-1, VID_H, VID_W)

    out = {}
    for ref_mode in ("raw", "recon"):
        t0 = time.perf_counter()
        enc("jax", ref_mode)
        first = time.perf_counter() - t0
        sj, warm = best_of(lambda: enc("jax", ref_mode))
        sn = enc("numpy", ref_mode)
        dj, _, _ = decode_video(sj)
        dn, _, _ = decode_video(sn)
        pj, pn = psnr(y_planes(dj), ys), psnr(y_planes(dn), ys)
        mpix = VID_W * VID_H * VID_F / warm / 1e6
        msg = (f"{tag} {ref_mode}: {len(sj)} B (exact path {len(sn)} B), "
               f"first call {first:.2f} s (compile incl.), warm "
               f"{warm * 1e3:.1f} ms = {mpix:.1f} Mpix/s, PSNR {pj:.3f} dB "
               f"(exact path {pn:.3f} dB)")
        if ref_mode == "raw":
            mj = [p[0] for p in parse_video_stream(sj)[6]]
            mn = [p[0] for p in parse_video_stream(sn)[6]]
            check(all((a is None and b is None) or np.array_equal(a, b)
                      for a, b in zip(mj, mn)) and len(mj) == len(mn),
                  f"{tag} raw: motion vectors differ from the host search")
            msg += ", motion vectors identical to the host search"
        else:
            check(abs(pj - pn) <= 0.1,
                  f"{tag} recon: PSNR {pj:.3f} vs exact {pn:.3f} dB")
        log(msg)
        out[ref_mode] = sj

    vj, vjt = best_of(lambda: decode_video(out["raw"], backend="jax"), 2)
    vn, _, _ = decode_video(out["raw"])
    share = tie_share(y_planes(vj[0]), y_planes(vn), "decode_video jax Y")
    log(f"decode_video jax: warm {vjt * 1e3:.1f} ms, pixel tie share "
        f"{share:.5%}; peak_bytes_in_use {peak_bytes(dev)} B")
    return data


def sad_kernel_phase(rng):
    """The SAD-map kernel against the plain scan, bit for bit."""
    import jax
    import jax.numpy as jnp

    from imageencoder_tpu.ops.sad_maps import sad_maps_scan, sad_maps_triton

    for f, h, w in SAD_SHAPES:
        cur = jnp.asarray(rng.integers(0, 256, (f, h, w), dtype=np.uint8))
        ref = jnp.asarray(rng.integers(0, 256, (f, h, w), dtype=np.uint8))
        k = jax.jit(sad_maps_triton, static_argnums=2)
        s = jax.jit(sad_maps_scan, static_argnums=2)
        km = np.asarray(k(cur, ref, MERANGE))
        sm = np.asarray(s(cur, ref, MERANGE))
        check(np.array_equal(km, sm), f"SAD kernel != scan at {f}x{h}x{w}")
        log(f"sad_maps kernel == scan bit for bit at {f}x{h}x{w} "
            f"(maps {km.shape})")


def cli_phase(img, quant_path):
    from imageencoder_tpu import cli
    from imageencoder_tpu.models.image import decode_image

    h, w = img.shape
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        os.chdir(d)
        try:
            img.tofile("in.raw")
            with open("job.conf", "w") as f:
                f.write(f"rawfile=in.raw\nencfile=out.enc\ndecfile=dec.raw\n"
                        f"rle=1\nquantfile={quant_path}\nwidth={w}\n"
                        f"height={h}\nlogfile=job.log\n")
            rc = cli.main(["job.conf", "--backend", "jax"])
            check(rc == 0, f"CLI exited {rc}")
            enc = open("out.enc", "rb").read()
            dec = np.fromfile("dec.raw", np.uint8).reshape(h, w)
        finally:
            os.chdir(cwd)
    share = tie_share(dec, decode_image(enc, backend="numpy"),
                      "CLI jax decode")
    log(f"CLI --backend jax: {len(enc)} B stream, decode tie share "
        f"{share:.5%}")


def trace_stages(name, fn, hlo_texts, reps=3):
    """Device time per named stage over ``reps`` warm calls of ``fn``,
    from a profiler trace (utils/profiling.device_stage_times)."""
    import jax

    from imageencoder_tpu.utils.profiling import device_stage_times

    fn()
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    jax.profiler.start_trace(trace_dir)
    try:
        for _ in range(reps):
            fn()
    finally:
        jax.profiler.stop_trace()
    times, other = device_stage_times(trace_dir, STAGES, hlo_texts)
    parts = ", ".join(f"{k} {v / reps / 1e6:.3f} ms"
                      for k, v in times.items() if v)
    top = sorted(other.items(), key=lambda kv: -kv[1])[:5]
    log(f"device time per {name} ({reps} warm calls): {parts}; largest "
        f"unattributed kernels: "
        + ", ".join(f"{k} {v / reps / 1e6:.3f} ms" for k, v in top))


def stage_phase(img, quant, img_hlo, video_data, image_stream):
    import jax.numpy as jnp

    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.models.video import (encode_video, mvec_bits,
                                               split_yuv420)
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.ops.device_pack import header_to_words
    from imageencoder_tpu.ops.pipeline import make_decode_blocks_rowmajor
    from imageencoder_tpu.ops.video_pipeline import make_encode_video_packed

    w = BitWriter()
    write_image_header(w, quant, True, VID_W, VID_H)
    write_video_params(w, VideoParams(VID_F, GOP, MERANGE))
    frames = split_yuv420(video_data, VID_W, VID_H)
    qf = jnp.asarray(quant.as_float(np.float32))
    video_hlo = make_encode_video_packed(
        GOP, MERANGE, mvec_bits(MERANGE), 4, True, "reference",
        with_hist=True).lower(
        jnp.asarray(frames), qf, np.int32(w.position),
        jnp.asarray(header_to_words(w.getvalue()))).compile().as_text()
    decode_hlo = make_decode_blocks_rowmajor(4, "reference", False).lower(
        jnp.zeros(((IMG_H // 4) * (IMG_W // 4), 4, 4), jnp.int16),
        qf).compile().as_text()

    trace_stages("image encode",
                 lambda: encode_image(img, quant, True, True, backend="jax"),
                 [img_hlo])
    trace_stages("video encode",
                 lambda: encode_video(video_data, VID_W, VID_H, quant, True,
                                      GOP, MERANGE, backend="jax"),
                 [video_hlo])
    trace_stages("image decode",
                 lambda: decode_image(image_stream, backend="jax"),
                 [decode_hlo])


def single_device(args):
    import jax

    dev = device_facts(1)[0]
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(args.seed)
    q4_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "quant4.txt")
    q8_path = os.path.join(os.path.dirname(q4_path), "quant8_annexk.txt")
    quant = QuantMatrix.from_file(q4_path)
    quant8 = QuantMatrix.from_file(q8_path, size=8)
    img = seeded_image(rng, IMG_H, IMG_W)

    single, img_hlo = image_phase(img, quant, 4, "reference", dev)
    image_phase(img, quant8, 8, "ortho", dev)
    serving_phase(img, quant, single, dev)
    sad_kernel_phase(rng)
    video_data = video_phase(quant, rng, dev)
    cli_phase(img, q4_path)
    stage_phase(img, quant, img_hlo, video_data, single)
    return jax.devices()


def sharded(args):
    import jax

    device_facts(args.devices)
    from imageencoder_tpu.models.image import encode_image
    from imageencoder_tpu.models.video import (decode_video, encode_video,
                                               split_yuv420)
    from imageencoder_tpu.parallel import (decode_video_sharded,
                                           encode_sharded_image_batch,
                                           encode_video_sharded, make_mesh)
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(args.seed)
    q4_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "quant4.txt")
    quant = QuantMatrix.from_file(q4_path)
    mesh = make_mesh(args.devices)
    log(f"mesh {dict(mesh.shape)} over {args.devices} devices")

    imgs = np.stack([seeded_image(rng, IMG_H, IMG_W)
                     for _ in range(mesh.shape["frame"])])
    for huff in (True, False):
        got = encode_sharded_image_batch(imgs, quant, mesh, True, huff)
        want = [encode_image(im, quant, True, huff, backend="jax")
                for im in imgs]
        check(got == want, f"sharded image streams (huffman={huff}) != "
              f"single-device streams")
    log(f"sharded image encode {imgs.shape}: streams byte-identical to "
        f"single-device encode_image (huffman on and off)")

    w, h, n = VID_W, SHARD_VID_H, SHARD_VID_F
    data, _ = seeded_video(rng, w, h, n)
    frames = split_yuv420(data, w, h)
    streams = {}
    for ref_mode in ("raw", "recon"):
        got = encode_video_sharded(frames, quant, mesh, True, GOP, MERANGE,
                                   use_huffman=True, ref_mode=ref_mode)
        want = encode_video(data, w, h, quant, True, GOP, MERANGE,
                            use_huffman=True, backend="jax",
                            ref_mode=ref_mode)
        check(got == want, f"sharded video ({ref_mode}) != single-device")
        log(f"sharded video encode {w}x{h}x{n} {ref_mode}: stream "
            f"byte-identical to single-device encode_video ({len(got)} B)")
        streams[ref_mode] = want
    for ref_mode, stream in streams.items():
        sdec = decode_video_sharded(stream, mesh)
        ddec = decode_video(stream, backend="jax")
        check(sdec[0] == ddec[0],
              f"sharded video decode ({ref_mode}) != single-device decode")
    log("sharded video decode: byte-identical to single-device decode_video")
    return jax.devices()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="1: all single-device phases; N>1: only the "
                         "sharded paths on an N-device mesh")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    devs = single_device(args) if args.devices == 1 else sharded(args)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
