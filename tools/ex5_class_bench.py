"""ex5-class (2160x2160) head-to-head vs the LOCAL reference binaries.

`ex5.raw` is absent upstream (`.MISSING_LARGE_BLOBS`, BASELINE.md), so the
published 506.1 ms encode / 373.1 ms decode row (reference README.md:194,
i7-7700K) cannot be verified byte-for-byte.  This tool produces the honest
substitute: seeded synthetic 2160x2160 content (blocky base + noise, the
same ex5 geometry/conf parameters: rle=1, matrix.txt), timed through BOTH
codecs ON THE SAME MACHINE:

  * reference encoder/decoder binaries — process wall time minus a
    measured startup floor (the binaries print no internal timings; the
    floor is the same binary run on the 64-byte ex0 fixture, which makes
    the subtraction an overestimate of real startup+IO, i.e. generous to
    the reference),
  * our host paths — in-process API timing (min of N), the same
    measurement bench.py reports.

Parity is asserted on every run: our decode of the reference stream must
equal the reference's own decode, and our stream must round-trip.

Usage: python tools/ex5_class_bench.py [--runs 3] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

W = H = 2160
REF_BIN = "/root/reference/bin"


def synth_image(seed: int = 0) -> np.ndarray:
    """Blocky base + gaussian noise: a
    mid-complexity photographic stand-in that compresses to ~45% with
    matrix.txt — HARDER than ex5's published ~34%/29% ratios."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (H // 8, W // 8)), np.ones((8, 8)))
    img = np.clip(base + rng.normal(0, 6.0, (H, W)), 0, 255)
    return img.astype(np.uint8)


def _run(binary: str, conf: str, cwd: str) -> float:
    t0 = time.perf_counter()
    p = subprocess.run([binary, conf], cwd=cwd, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL)
    dt = time.perf_counter() - t0
    # rc 139 = benign teardown segfault AFTER writing output (tests/oracle.py)
    if p.returncode not in (0, 139, -11):
        raise RuntimeError(f"{binary} {conf} rc={p.returncode}")
    return dt


def _conf(d: str, name: str, **kv) -> str:
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write("".join(f"{k}={v}\n" for k, v in kv.items()))
    return name


def bench_reference(img: np.ndarray, runs: int, d: str):
    shutil.copy(f"{REF_BIN}/encoder", d)
    shutil.copy(f"{REF_BIN}/decoder", d)
    shutil.copy(f"{REF_BIN}/matrix.txt", d)
    os.chmod(os.path.join(d, "encoder"), 0o755)
    os.chmod(os.path.join(d, "decoder"), 0o755)
    img.tofile(os.path.join(d, "s5.raw"))
    # startup+IO floor: the same binaries on the 64-byte ex0 fixture
    shutil.copy(f"{REF_BIN}/ex0.raw", d)
    c0 = _conf(d, "f.conf", rawfile="ex0.raw", encfile="f.enc",
               decfile="f_dec.raw", width=8, height=8, rle=1,
               quantfile="matrix.txt", logfile="f.log")
    enc_floor = min(_run("./encoder", c0, d) for _ in range(runs))
    dec_floor = min(_run("./decoder", c0, d) for _ in range(runs))
    c5 = _conf(d, "s5.conf", rawfile="s5.raw", encfile="s5.enc",
               decfile="s5_dec.raw", width=W, height=H, rle=1,
               quantfile="matrix.txt", logfile="s5.log")
    enc_wall = min(_run("./encoder", c5, d) for _ in range(runs))
    dec_wall = min(_run("./decoder", c5, d) for _ in range(runs))
    with open(os.path.join(d, "s5.enc"), "rb") as f:
        stream = f.read()
    refdec = np.fromfile(os.path.join(d, "s5_dec.raw"),
                         np.uint8).reshape(H, W)
    return (max(enc_wall - enc_floor, 0.0), max(dec_wall - dec_floor, 0.0),
            enc_floor, dec_floor, stream, refdec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="tools/ex5_class_results.json")
    args = ap.parse_args()

    img = synth_image()
    d = tempfile.mkdtemp(prefix="ex5class_")
    try:
        (ref_enc_s, ref_dec_s, enc_floor, dec_floor, ref_stream,
         refdec) = bench_reference(img, args.runs, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    import jax

    jax.config.update("jax_platforms", "cpu")  # host paths only; no device
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(f"{REF_BIN}/matrix.txt")
    our_stream = encode_image(img, quant, use_rle=True, use_huffman=True,
                              backend="numpy")
    ours_enc_s = 1e9
    for _ in range(args.runs):
        t0 = time.perf_counter()
        encode_image(img, quant, use_rle=True, use_huffman=True,
                     backend="numpy")
        ours_enc_s = min(ours_enc_s, time.perf_counter() - t0)
    mine = decode_image(our_stream, backend="numpy")
    ours_dec_s = 1e9
    for _ in range(args.runs):
        t0 = time.perf_counter()
        decode_image(our_stream, backend="numpy")
        ours_dec_s = min(ours_dec_s, time.perf_counter() - t0)

    # parity: our decoder on the reference's stream == its own decode
    cross = decode_image(ref_stream, backend="numpy")
    assert np.array_equal(cross, refdec), "cross-decode parity failed"
    assert np.array_equal(mine, decode_image(our_stream, backend="fast")), \
        "fast/numpy decode divergence"
    # both encoders round-trip to the same pixels (identical arithmetic)
    assert np.array_equal(mine, refdec), "round-trip pixel parity failed"

    mpix = W * H / 1e6
    res = {
        "geometry": f"{W}x{H}", "content": "synthetic blocky+noise seed 0",
        "ratio_ours": len(our_stream) / img.nbytes,
        "ratio_ref": len(ref_stream) / img.nbytes,
        "ref_encode_ms": round(ref_enc_s * 1e3, 1),
        "ref_decode_ms": round(ref_dec_s * 1e3, 1),
        "ref_startup_floor_ms": round(max(enc_floor, dec_floor) * 1e3, 1),
        "ours_encode_ms": round(ours_enc_s * 1e3, 1),
        "ours_decode_ms": round(ours_dec_s * 1e3, 1),
        "encode_speedup": round(ref_enc_s / ours_enc_s, 1),
        "decode_speedup": round(ref_dec_s / ours_dec_s, 1),
        "ours_encode_mpix_s": round(mpix / ours_enc_s, 1),
        "ours_decode_mpix_s": round(mpix / ours_dec_s, 1),
        "published_i7_7700K_ms": {"encode": 506.1, "decode": 373.1},
    }
    print(json.dumps(res))
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
