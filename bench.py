"""Headline benchmark: end-to-end image encode throughput on one GPU.

The reference's headline metric (README.md:187-197 of the original
project) is the wall clock to encode its ex4 fixture (4096x912, the largest
shipped image) with RLE + whole-stream Huffman, raw bytes in -> encoded
stream out: 461.9 ms on an i7-7700K with OpenMP (BASELINE.md) = 8.09
Mpix/s.  The fixture's pixels are not in this repository, so the input is
a seeded image at the ex4 geometry (utils/synth.py) and the quantization
matrix is the in-tree tests/fixtures/quant4.txt; "vs_baseline" compares
throughput at equal geometry, not on equal content.

The encode is the fused device pipeline (transform + quantize + RLE stats
+ on-device bit packing + byte histogram, ops/pipeline.make_encode_packed_
hist) plus the host Huffman stage; only the packed stream crosses to the
host.  Every time is the host clock around work that ends on the host
(returned bytes) or in block_until_ready, min over repetitions.

Host-only phases (backend="numpy") run in this process: they never touch
the device, so one process holds the card.  The script fails when JAX
finds no GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"extra"}; "device" names the platform, device_kind, device count and the
card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MPIX_S = 3735552 / 0.4619 / 1e6  # ex4 OpenMP+Huffman encode
BASELINE_DECODE_MS = 327.0  # ex4 OpenMP decode
BASELINE_VIDEO_MPIX_S = 0.38  # 720p25
IMG_H, IMG_W = 912, 4096
VID_W, VID_H, VID_F = 1280, 720, 25


def best(fn, reps):
    """min wall seconds of fn() over reps calls (after one warm call)."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts)


def note(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: JAX found no GPU (platform {dev.platform})")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()

    from imageencoder_tpu.models.batch import encode_image_batch
    from imageencoder_tpu.models.headers import write_image_header
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.models.video import decode_video, encode_video
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.ops.device_pack import header_to_words
    from imageencoder_tpu.ops.pipeline import make_encode_packed_hist
    from imageencoder_tpu.utils.jaxcache import configure_compile_cache
    from imageencoder_tpu.utils.quant import QuantMatrix
    from imageencoder_tpu.utils.synth import seeded_image, seeded_video

    configure_compile_cache()
    repo = os.path.dirname(os.path.abspath(__file__))
    quant = QuantMatrix.from_file(os.path.join(repo, "tests", "fixtures",
                                               "quant4.txt"))
    rng = np.random.default_rng(0)
    img = seeded_image(rng, IMG_H, IMG_W)
    extra = {}

    def enc():
        return encode_image(img, quant, use_rle=True, use_huffman=True,
                            backend="jax")

    t0 = time.perf_counter()
    stream = enc()
    extra["image_encode_first_call_s"] = time.perf_counter() - t0
    dec = decode_image(stream, backend="numpy")
    assert dec.shape == img.shape, (dec.shape, img.shape)
    t_img = best(enc, 8)
    note(f"image encode e2e {t_img * 1e3:.2f} ms ({len(stream)} B)")

    # Device half alone: the jitted step with its inputs already on device.
    w = BitWriter()
    write_image_header(w, quant, True, IMG_W, IMG_H)
    fn = make_encode_packed_hist(4, True, "reference")
    args = (jax.device_put(img), jax.device_put(quant.as_float(np.float32)),
            np.int32(w.position),
            jax.device_put(jnp.asarray(header_to_words(w.getvalue()))))
    extra["device_encode_ms"] = best(lambda: fn(*args), 20) * 1e3

    imgs = np.stack([np.roll(img, 13 * i, axis=1) for i in range(8)])
    assert encode_image_batch(imgs[:1], quant)[0] == stream
    t_batch = best(lambda: encode_image_batch(imgs, quant), 3)
    extra["batch8_encode_mpix_s"] = imgs.size / t_batch / 1e6

    t_dec = best(lambda: decode_image(stream, backend="jax"), 5)
    extra["device_decode_ms"] = t_dec * 1e3
    extra["host_encode_ms"] = best(
        lambda: encode_image(img, quant, True, True, backend="numpy"),
        8) * 1e3
    extra["host_decode_ms"] = best(
        lambda: decode_image(stream, backend="numpy"), 8) * 1e3
    extra["host_decode_vs_baseline"] = (BASELINE_DECODE_MS
                                        / extra["host_decode_ms"])

    vdata, _ = seeded_video(rng, VID_W, VID_H, VID_F)
    vpix = VID_W * VID_H * VID_F

    def venc(backend):
        return encode_video(vdata, VID_W, VID_H, quant, True, 4, 16,
                            use_huffman=True, backend=backend)

    t0 = time.perf_counter()
    vstream = venc("jax")
    extra["video_encode_first_call_s"] = time.perf_counter() - t0
    t_venc = best(lambda: venc("jax"), 3)
    extra["video_encode_mpix_s"] = vpix / t_venc / 1e6
    extra["video_vs_baseline"] = extra["video_encode_mpix_s"] \
        / BASELINE_VIDEO_MPIX_S
    extra["host_video_encode_mpix_s"] = vpix / best(lambda: venc("numpy"),
                                                    2) / 1e6
    extra["video_decode_device_mpix_s"] = vpix / best(
        lambda: decode_video(vstream, backend="jax"), 3) / 1e6
    extra["video_decode_host_mpix_s"] = vpix / best(
        lambda: decode_video(vstream, backend="fast", workers=4), 3) / 1e6
    note(f"video encode {t_venc * 1e3:.1f} ms")

    mpix_s = img.size / t_img / 1e6
    print(json.dumps({
        "metric": "image_encode_throughput_ex4_geometry",
        "value": mpix_s,
        "unit": "Mpix/s",
        "vs_baseline": mpix_s / BASELINE_MPIX_S,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "nvidia_smi": card},
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
