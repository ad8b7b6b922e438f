"""A/B measurements on one NVIDIA GPU for the choices the device path makes.

    python tools/gpu_ab.py [--pairs N]

  1. SAD maps at 720p25, merange 16: the Triton-route kernel vs the plain
     scan (u8 operands) and vs the scan with int32 operands; maps compared
     bit for bit.  Then the kernel's tile sweep: {8, 16, 32} macroblock
     columns per program x {4, 8} warps, run round robin.
  2. 720p25 video encode end to end (encode_video, backend="jax", raw
     reference, Huffman on) with the SAD kernel and with the u8 scan.
  3. The forward block transform alone on the ex4 geometry's 4x4 blocks,
     the three-operand einsum the code uses vs one product with
     kron(D, D); then ex4-geometry image encode end to end (encode_image,
     backend="jax", Huffman on) with each.
  4. The stream byte histogram at ex4 size: the [M, 256] broadcast-compare
     reduction vs a scatter-add, on the words of a real encode.

Every A/B runs N pairs in one process, alternating which side runs first,
and prints each side's median and quartiles and how many pairs the
first-named side won; the tile sweep runs N rounds of every tile.  Times are host wall clock around work that ends in
block_until_ready or returned bytes.  The script prints the card's name and
power limit and fails when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import itertools
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def timed(fn):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def quartiles(ts):
    q1, q2, q3 = np.percentile(np.asarray(ts) * 1e3, [25, 50, 75])
    return f"median {q2:.3f} ms (p25 {q1:.3f}, p75 {q3:.3f}, n={len(ts)})"


def ab(what, a, b, pairs):
    """Alternate two (name, fn) sides for `pairs` pairs; print both."""
    (na, fa), (nb, fb) = a, b
    timed(fa), timed(fb)
    ta, tb = [], []
    for i in range(pairs):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            (ta, tb)[side].append(timed((fa, fb)[side]))
    wins = sum(x < y for x, y in zip(ta, tb))
    print(f"{what}: {na} {quartiles(ta)}; {nb} {quartiles(tb)}; "
          f"{na} faster in {wins}/{pairs} pairs", flush=True)


def sad_scan_i32(cur_u8, ref_u8, merange):
    """The scan with int32 frames held across steps (the earlier form)."""
    import jax
    import jax.numpy as jnp

    f, h, w = cur_u8.shape
    pad = merange - 1
    d = 2 * pad + 1
    nby, nbx = h // 16, w // 16
    cur = cur_u8.astype(jnp.int32)
    refp = jnp.pad(ref_u8.astype(jnp.int32), ((0, 0), (pad, pad), (pad, pad)))

    def sad_at(carry, od):
        sh = jax.lax.dynamic_slice(refp, (0, od[0], od[1]), (f, h, w))
        x = jnp.abs(cur - sh).reshape(f, nby, 16, w).sum(axis=2)
        return carry, x.reshape(f, nby, nbx, 16).sum(axis=3)

    offs = jnp.stack(jnp.meshgrid(jnp.arange(d), jnp.arange(d),
                                  indexing="ij"), axis=-1).reshape(-1, 2)
    return jax.lax.scan(sad_at, 0, offs)[1].reshape(d, d, f, nby, nbx)


def build(factories, factory_args, patch_module, attr, impl, run):
    """The jitted step `factories[0](*factory_args)` traced with
    `patch_module.attr = impl` (every factory's cache cleared first, so
    nested jitted steps are traced afresh too)."""
    orig = getattr(patch_module, attr)
    setattr(patch_module, attr, impl)
    for f in factories:
        f.cache_clear()
    try:
        fn = factories[0](*factory_args[0], **factory_args[1])
        run()
    finally:
        setattr(patch_module, attr, orig)
        for f in factories:
            f.cache_clear()
    return fn


def swapped(module, attr, fn, run):
    """run() with module.attr replaced by a factory returning fn."""
    def go():
        orig = getattr(module, attr)
        setattr(module, attr, lambda *a, **k: fn)
        try:
            return run()
        finally:
            setattr(module, attr, orig)
    return go


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("gpu_ab: JAX found no GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    from imageencoder_tpu.models.image import encode_image
    from imageencoder_tpu.models.video import (encode_video, mvec_bits,
                                               split_yuv420)
    from imageencoder_tpu.ops import pipeline as pl_mod
    from imageencoder_tpu.ops import sad_maps as sm
    from imageencoder_tpu.ops import video_pipeline as vp
    from imageencoder_tpu.ops.dct import dct_matrix
    from imageencoder_tpu.utils.jaxcache import configure_compile_cache
    from imageencoder_tpu.utils.quant import QuantMatrix
    from imageencoder_tpu.utils.synth import seeded_image, seeded_video

    configure_compile_cache()
    quant = QuantMatrix.from_file(os.path.join(REPO, "tests", "fixtures",
                                               "quant4.txt"))
    rng = np.random.default_rng(0)
    w, h, nf, m = 1280, 720, 25, 16
    data, _ = seeded_video(rng, w, h, nf)
    frames = jnp.asarray(split_yuv420(data, w, h))
    cur, ref = frames, jnp.roll(frames, 1, axis=0)

    # 1. SAD maps alone.
    fns = {"kernel": jax.jit(lambda c, r: sm.sad_maps_triton(c, r, m)),
           "scan_u8": jax.jit(lambda c, r: sm.sad_maps_scan(c, r, m)),
           "scan_i32": jax.jit(lambda c, r: sad_scan_i32(c, r, m))}
    want = np.asarray(fns["scan_u8"](cur, ref))
    for name, fn in fns.items():
        if not np.array_equal(np.asarray(fn(cur, ref)), want):
            raise SystemExit(f"{name} maps differ from the scan")
    for other in ("scan_u8", "scan_i32"):
        ab(f"sad_maps {nf}x{h}x{w} merange {m} (maps equal)",
           ("kernel", lambda: fns["kernel"](cur, ref)),
           (other, lambda o=other: fns[o](cur, ref)), args.pairs)

    # Tile sweep: each tile compiled with the module's tile constants set,
    # then timed round robin so drift reaches every tile alike.
    tiles = {}
    orig = (sm.TILE_MB, sm.NUM_WARPS)
    try:
        for tile, warps in itertools.product((8, 16, 32), (4, 8)):
            sm.TILE_MB, sm.NUM_WARPS = tile, warps
            sm._sad_call.cache_clear()
            fn = jax.jit(lambda c, r: sm.sad_maps_triton(c, r, m))
            if not np.array_equal(np.asarray(fn(cur, ref)), want):
                raise SystemExit(f"tile {tile}x{warps} maps differ")
            tiles[(tile, warps)] = fn
    finally:
        sm.TILE_MB, sm.NUM_WARPS = orig
        sm._sad_call.cache_clear()
    tt = {key: [] for key in tiles}
    for _ in range(args.pairs):
        for key, fn in tiles.items():
            tt[key].append(timed(lambda: fn(cur, ref)))
    for (tile, warps), ts in tt.items():
        print(f"sad_maps tile {tile} macroblock columns x {warps} warps "
              f"(maps equal): {quartiles(ts)}", flush=True)

    # 2. Video encode end to end, kernel vs u8 scan.
    def venc():
        return encode_video(data, w, h, quant, True, 4, m, backend="jax")

    vargs = ((4, m, mvec_bits(m), 4, True, "reference"), {"with_hist": True})
    vside = {name: swapped(vp, "make_encode_video_packed",
                           build([vp.make_encode_video_packed], vargs, vp,
                                 "sad_maps", impl, venc), venc)
             for name, impl in (("kernel", sm.sad_maps_triton),
                                ("scan", sm.sad_maps_scan))}
    if vside["kernel"]() != vside["scan"]():
        raise SystemExit("kernel and scan video streams differ")
    ab(f"video encode e2e {w}x{h}x{nf} (streams equal)",
       ("kernel", vside["kernel"]), ("scan", vside["scan"]), args.pairs)

    # 3. Forward transform alone, then image encode end to end, einsum vs
    # kron(D, D) forward transform.
    img = seeded_image(rng, 912, 4096)

    def ienc():
        return encode_image(img, quant, True, True, backend="jax")

    def kron_forward(blocks, dct_m, inverse=False):
        if inverse:
            return pl_mod.block_transform(blocks, dct_m, inverse=True)
        n, b, _ = blocks.shape
        y = jnp.dot(blocks.reshape(n, b * b), jnp.kron(dct_m, dct_m).T,
                    precision=jax.lax.Precision.HIGHEST)
        return y.reshape(n, b, b)

    dct_m = jnp.asarray(dct_matrix(4, "reference"), jnp.float32)
    blocks = (jnp.asarray(img, jnp.float32).reshape(228, 4, 1024, 4)
              .swapaxes(1, 2).reshape(-1, 4, 4) - 128.0)
    t_ein = jax.jit(pl_mod.block_transform)
    t_kron = jax.jit(kron_forward)
    gap = float(jnp.max(jnp.abs(t_kron(blocks, dct_m)
                                - t_ein(blocks, dct_m))))
    ab(f"forward transform alone ({blocks.shape[0]} blocks, max |einsum - "
       f"kron| {gap:.3g})",
       ("einsum", lambda: t_ein(blocks, dct_m)),
       ("kron", lambda: t_kron(blocks, dct_m)), args.pairs)

    iargs = ((4, True, "reference"), {})
    factories = [pl_mod.make_encode_packed_hist, pl_mod.make_encode_packed]
    iside = {name: swapped(pl_mod, "make_encode_packed_hist",
                           build(factories, iargs, pl_mod, "block_transform",
                                 impl, ienc), ienc)
             for name, impl in (("einsum", pl_mod.block_transform),
                                ("kron", kron_forward))}
    ab("image encode e2e 912x4096 (forward transform)",
       ("einsum", iside["einsum"]), ("kron", iside["kron"]), args.pairs)

    # 4. Byte histogram at ex4 size.
    from imageencoder_tpu.models.headers import write_image_header
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.ops.device_pack import header_to_words

    wr = BitWriter()
    write_image_header(wr, quant, True, img.shape[1], img.shape[0])
    words, total = pl_mod.make_encode_packed(4, True, "reference")(
        jnp.asarray(img), jnp.asarray(quant.as_float(np.float32)),
        np.int32(wr.position), jnp.asarray(header_to_words(wr.getvalue())))

    def hist_scatter(words, total_bits):
        nbytes = (total_bits + 7) // 8
        lanes = ((words[:, None] >> jnp.array([24, 16, 8, 0], jnp.uint32))
                 & 0xFF).reshape(-1)
        live = (jnp.arange(lanes.shape[0]) < nbytes).astype(jnp.int32)
        hist = jnp.zeros(256, jnp.int32).at[lanes].add(live)
        return jnp.concatenate([total_bits.astype(jnp.int32)[None], hist])

    h_cmp = jax.jit(pl_mod.stream_byte_histogram)
    h_sct = jax.jit(hist_scatter)
    if not np.array_equal(np.asarray(h_cmp(words, total)),
                          np.asarray(h_sct(words, total))):
        raise SystemExit("histogram forms differ")
    ab(f"byte histogram ({words.shape[0]} words, "
       f"{(int(total) + 7) // 8} stream bytes)",
       ("broadcast_compare", lambda: h_cmp(words, total)),
       ("scatter_add", lambda: h_sct(words, total)), args.pairs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
