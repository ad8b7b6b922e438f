"""Whole-video device pipeline (ops/video_pipeline.py) vs the host path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageencoder_tpu.models.video import (decode_video, encode_video,
                                           split_yuv420)
from imageencoder_tpu.ops.motion import find_motion, predict_image
from imageencoder_tpu.ops.video_pipeline import _batched_motion
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.test_video_parity import make_video
from tests.oracle import QUANT4, QUANT8

MATRIX = QUANT4


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


def test_batched_motion_matches_per_frame():
    data, _ = make_video(smooth=False, seed=11)
    frames = split_yuv420(data, 64, 64)
    mv_d, pred_d = jax.jit(lambda f: _batched_motion(f, 4, 16))(
        jnp.asarray(frames))
    mv_d, pred_d = np.asarray(mv_d), np.asarray(pred_d)
    for f in range(1, len(frames)):
        if f % 4 == 0:
            continue
        mv_n, _ = find_motion(frames[f], frames[f - 1], 16)
        np.testing.assert_array_equal(mv_d[f], mv_n, err_msg=f"frame {f}")
        np.testing.assert_array_equal(
            pred_d[f], predict_image(frames[f - 1], mv_n, 64, 64))


@pytest.mark.parametrize("f,h,w,merange,halo", [
    (2, 32, 48, 4, 0),     # narrower than one column tile
    (1, 48, 280, 3, 0),    # partial last tile, width not a multiple of 16
    (3, 64, 64, 16, 0),    # the codec's default search range
    (1, 16, 2176, 4, 0),   # 136 macroblock columns: wider than 2048 px
    (2, 32, 160, 4, 2),    # halo rows short of the 3 merange 4 reads
    (2, 32, 160, 4, 3),    # exactly the rows it reads
    (2, 32, 160, 4, 4),    # more: the sharded step's merange-row halo
])
def test_sad_kernel_matches_scan(f, h, w, merange, halo):
    """The Triton-route SAD-map kernel (interpret mode) is bit-equal to the
    lax.scan maps, which in turn equal a direct numpy evaluation.  With
    ``halo`` reference rows above and below the frame (a stripe's
    neighbour rows), both read those rows and zeros only past them."""
    from imageencoder_tpu.ops.sad_maps import sad_maps_scan, sad_maps_triton

    rng = np.random.default_rng(h * w + merange + halo)
    cur = rng.integers(0, 256, (f, h, w), dtype=np.uint8)
    ref = rng.integers(0, 256, (f, h + 2 * halo, w), dtype=np.uint8)
    scan = np.asarray(sad_maps_scan(jnp.asarray(cur), jnp.asarray(ref),
                                    merange, halo))
    kern = np.asarray(sad_maps_triton(jnp.asarray(cur), jnp.asarray(ref),
                                      merange, halo, interpret=True))
    np.testing.assert_array_equal(kern, scan)

    # Reference rows -pad .. h + pad: the halo rows, zeros beyond them.
    pad = merange - 1
    d = 2 * pad + 1
    nby, nbx = h // 16, w // 16
    rows = np.zeros((f, h + 2 * max(pad, halo), w), np.int64)
    rows[:, max(pad, halo) - halo:][:, :h + 2 * halo] = ref
    rp = np.pad(rows[:, max(0, halo - pad):][:, :h + 2 * pad],
                ((0, 0), (0, 0), (pad, pad)))
    for dy, dx in [(0, 0), (d - 1, 0), (pad, d - 1), (d // 3, d // 2),
                   (d - 1, d - 1)]:
        diff = np.abs(cur.astype(np.int64) - rp[:, dy:dy + h, dx:dx + w])
        want = diff[:, :nby * 16, :nbx * 16] \
            .reshape(f, nby, 16, nbx, 16).sum(axis=(2, 4))
        np.testing.assert_array_equal(scan[dy, dx], want)


def test_wide_frame_sad_search_matches_host():
    """Frames wider than 2048 px run the same SAD-map search; its vectors
    and predictions equal the host search (ops/motion.py)."""
    from imageencoder_tpu.ops.video_pipeline import sad_motion_search

    rng = np.random.default_rng(3)
    h, w = 32, 2176
    base = rng.integers(0, 256, (h + 8, w + 8), dtype=np.uint8)
    ref = base[None, 4:4 + h, 4:4 + w]
    cur = base[None, 2:2 + h, 5:5 + w]
    off, pred = sad_motion_search(jnp.asarray(cur), jnp.asarray(ref), 4)
    mv_n, _ = find_motion(cur[0], ref[0], 4)
    np.testing.assert_array_equal(np.asarray(off)[0], mv_n)
    np.testing.assert_array_equal(np.asarray(pred)[0],
                                  predict_image(ref[0], mv_n, h, w))


def test_device_video_stream_decodes(quant):
    data, frames_list = make_video(smooth=True)
    enc = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True,
                       backend="jax")
    dec, params, (w, h) = decode_video(enc)
    assert (params.frame_count, w, h) == (8, 64, 64)
    ys = np.frombuffer(dec, dtype=np.uint8).reshape(8, -1)[:, :64 * 64]
    orig = np.stack([f.reshape(-1) for f in frames_list]).astype(float)
    mse = ((ys - orig) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / mse) > 30


def test_device_vs_host_streams_nearly_identical(quant):
    """Only f32-vs-f64 rounding ties may differ (<0.1% of coefficients),
    so stream lengths match to within a few bytes and both decode."""
    data, _ = make_video(smooth=True, seed=2)
    a = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=False,
                     backend="numpy")
    b = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=False,
                     backend="jax")
    assert abs(len(a) - len(b)) <= 16
    da, _, _ = decode_video(a)
    db, _, _ = decode_video(b)
    ya = np.frombuffer(da, dtype=np.uint8).astype(np.int32)
    yb = np.frombuffer(db, dtype=np.uint8).astype(np.int32)
    assert np.abs(ya - yb).mean() < 0.5  # tie flips move pixels by ~1 rarely


def test_recon_scan_device_path(quant):
    """lax.scan recon-mode device encoder: decodable, near the host path."""
    from imageencoder_tpu.models.video import encode_video

    data, frames_list = make_video(smooth=False, seed=5)
    enc = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True,
                       backend="jax", ref_mode="recon")
    dec, params, _ = decode_video(enc)
    assert params.frame_count == 8
    ys = np.frombuffer(dec, dtype=np.uint8).reshape(8, -1)[:, :64 * 64]
    orig = np.stack([f.reshape(-1) for f in frames_list]).astype(float)
    mse = ((ys - orig) ** 2).mean()
    assert 10 * np.log10(255 ** 2 / mse) > 28

    host = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True,
                        backend="numpy", ref_mode="recon")
    assert abs(len(host) - len(enc)) < len(host) * 0.02  # f32/f64 tie drift


def _y_planes(raw: bytes, n: int, w: int = 64, h: int = 64):
    fs = w * h * 3 // 2
    a = np.frombuffer(raw, np.uint8).reshape(n, fs)
    return a[:, :w * h].astype(np.int32), a[:, w * h:]


def _assert_device_decode_matches(enc, n, block_size=4, motioncomp=True):
    """Device decode == numpy decode up to the documented f32/f64 IDCT
    rounding-tie class (docs/PARITY.md): |diff| <= 2, <0.1% of pixels."""
    dn, pn, (w, h) = decode_video(enc, motioncomp=motioncomp,
                                  block_size=block_size)
    dj, pj, (wj, hj) = decode_video(enc, motioncomp=motioncomp,
                                    backend="jax", block_size=block_size)
    assert (pn.frame_count, w, h) == (pj.frame_count, wj, hj)
    assert len(dn) == len(dj)
    ya, uva = _y_planes(dn, n, w, h)
    yb, uvb = _y_planes(dj, n, w, h)
    np.testing.assert_array_equal(uva, uvb)  # UV fill is exact
    d = np.abs(ya - yb)
    assert d.max() <= 2 and (d > 0).mean() < 1e-3, \
        f"max={d.max()} frac={(d > 0).mean()}"


def test_device_video_decode_matches_host(quant):
    """Fused per-GOP device decode (make_decode_video_device): prediction
    gather + residual IDCT + add + clamp in one lax.scan per chunk."""
    data, _ = make_video(smooth=True, seed=2)
    enc = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True)
    _assert_device_decode_matches(enc, 8)


def test_device_video_decode_variants(quant):
    for n, gop, rle, mc, seed in [(6, 1, True, True, 7),   # all-I
                                  (8, 8, False, True, 7),  # no RLE
                                  (5, 3, True, True, 7),   # gop !| n
                                  (8, 4, True, False, 3)]:  # motioncomp off
        data, _ = make_video(n=n, smooth=True, seed=seed)
        enc = encode_video(data, 64, 64, quant, rle, gop, 16,
                           use_huffman=True)
        _assert_device_decode_matches(enc, n, motioncomp=mc)


def test_device_video_decode_chunked(quant):
    """>32 frames: decode runs GOP-aligned scan chunks; carry resets at
    each chunk's leading I-frame so chunks are independent."""
    data, _ = make_video(n=40, smooth=True, seed=7)
    enc = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True)
    _assert_device_decode_matches(enc, 40)


def test_device_video_decode_block8():
    q8 = QuantMatrix.from_file(QUANT8, 8)
    data, _ = make_video(n=6, smooth=True, seed=9)
    enc = encode_video(data, 64, 64, q8, True, 3, 16, use_huffman=True,
                       block_size=8)
    _assert_device_decode_matches(enc, 6, block_size=8)


def test_long_video_gop_chunking_identical(quant):
    """>32-frame device encode chunks by GOPs; stream must equal the
    unchunked device encode bit-for-bit."""
    import jax.numpy as jnp

    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.models.video import encode_video, mvec_bits
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.ops.device_pack import header_to_words, words_to_bytes
    from imageencoder_tpu.ops.video_pipeline import make_encode_video_packed

    data, _ = make_video(n=40, seed=31, smooth=False)
    chunked = encode_video(data, 64, 64, quant, True, 4, 16,
                           use_huffman=False, backend="jax")

    frames = split_yuv420(data, 64, 64)
    w = BitWriter()
    w.put_bit(0)
    write_image_header(w, quant, True, 64, 64)
    write_video_params(w, VideoParams(40, 4, 16))
    fn = make_encode_video_packed(4, 16, mvec_bits(16), 4, True, "reference")
    words, total = fn(jnp.asarray(frames),
                      jnp.asarray(quant.as_float(np.float32)),
                      np.int32(w.position),
                      jnp.asarray(header_to_words(w.getvalue())))
    unchunked = words_to_bytes(words, int(total))
    assert chunked == unchunked

