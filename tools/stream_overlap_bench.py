"""Pipelined-streaming overlap evidence.

Checks that the pipelined serving mode (models/batch.encode_image_stream)
overlaps the device stage with the host Huffman stage, with the device
stage on the LOCAL CPU backend: XLA dispatch is asynchronous there too
(compute runs on XLA's thread pool), so if the pipeline is built right,
streamed wall time approaches max(device, host) per image rather than
their sum.  These are CPU timings of the pipeline's structure, not device
numbers.

Measures, for a batch of identical-shape images:
  1. serial:    dispatch -> drain -> host Huffman, one image at a time
     (encode_image_stream with depth=0),
  2. pipelined: depth-2 in-flight window (the serving default),
and reports the overlap ratio serial/pipelined plus the isolated stage
times.  Results -> tools/stream_overlap_results.json.

Usage: python tools/stream_overlap_bench.py
"""

import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from imageencoder_tpu.models.batch import encode_image_stream  # noqa: E402
from imageencoder_tpu.utils.quant import QuantMatrix  # noqa: E402

QUANT4 = pathlib.Path(__file__).resolve().parents[1] / "tests" / "fixtures" \
    / "quant4.txt"


def run(imgs, quant, depth):
    t0 = time.perf_counter()
    out = list(encode_image_stream(imgs, quant, depth=depth))
    return time.perf_counter() - t0, out


def main():
    quant = QuantMatrix.from_file(str(QUANT4))
    rng = np.random.default_rng(0)
    h, w = 512, 1024  # CPU-backend-sized frames (the point is the overlap
    n = 10            # ratio, not absolute throughput)
    base = np.kron(rng.integers(0, 256, (h // 8, w // 8)),
                   np.ones((8, 8))).astype(np.float64)
    imgs = [np.clip(base + rng.normal(0, 12, (h, w)), 0, 255)
            .astype(np.uint8) for _ in range(n)]

    # Warm both jit caches + the Huffman path.
    run(imgs[:3], quant, depth=2)

    t_serial, out_a = run(imgs, quant, depth=0)
    t_pipe, out_b = run(imgs, quant, depth=2)
    assert [bytes(a) for a in out_a] == [bytes(b) for b in out_b]

    # Isolated stage times (same warm caches): device-only = drain the
    # dispatch without the host stage; host-only = re-finish held outputs.
    import jax.numpy as jnp

    from imageencoder_tpu.models.batch import BitWriter, write_image_header
    from imageencoder_tpu.ops.device_pack import header_to_words
    from imageencoder_tpu.ops.huffman import huffman_encode_from_meta
    from imageencoder_tpu.ops.pipeline import make_encode_packed_hist

    writer = BitWriter()
    write_image_header(writer, quant, True, w, h)
    hdr = jnp.asarray(header_to_words(writer.getvalue()))
    fn = make_encode_packed_hist(4, True, "reference")
    qf = jnp.asarray(quant.as_float(np.float32))

    t0 = time.perf_counter()
    held = []
    for img in imgs:
        words, meta = fn(jnp.asarray(img), qf, np.int32(writer.position), hdr)
        held.append((np.asarray(words), np.asarray(meta)))  # blocks: D2H
    t_device = time.perf_counter() - t0

    t0 = time.perf_counter()
    for words, meta in held:
        huffman_encode_from_meta(words, meta)
    t_host = time.perf_counter() - t0

    res = {
        "n_images": n, "shape": [h, w],
        "serial_s": round(t_serial, 3),
        "pipelined_s": round(t_pipe, 3),
        "overlap_speedup": round(t_serial / t_pipe, 3),
        "device_stage_s": round(t_device, 3),
        "host_stage_s": round(t_host, 3),
        "sum_stages_s": round(t_device + t_host, 3),
        "max_stage_s": round(max(t_device, t_host), 3),
        "pipelined_vs_max_stage": round(t_pipe / max(t_device, t_host), 3),
    }
    print(json.dumps(res, indent=2))
    out = pathlib.Path(__file__).parent / "stream_overlap_results.json"
    out.write_text(json.dumps(res, indent=2) + "\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
