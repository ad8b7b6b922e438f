"""8x8 block support (proper orthonormal DCT — the reference's 8x8 is a
recompile with a 4x4-only scale factor, algo.cpp:294-297; ours is correct
under norm='ortho' and works on both backends)."""

import numpy as np
import pytest

from imageencoder_tpu.models.image import decode_image, encode_image
from imageencoder_tpu.utils.metrics import psnr
from imageencoder_tpu.utils.quant import QuantMatrix
from tests.oracle import QUANT8


@pytest.fixture(scope="module")
def quant8():
    return QuantMatrix.from_file(QUANT8, size=8)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_roundtrip_8x8(backend, quant8):
    rng = np.random.default_rng(1)
    img = np.kron(rng.integers(0, 256, (16, 16)),
                  np.ones((8, 8))).astype(np.uint8)
    enc = encode_image(img, quant8, True, use_huffman=True, norm="ortho",
                       backend=backend, block_size=8)
    dec = decode_image(enc, norm="ortho", backend=backend, block_size=8)
    assert dec.shape == img.shape
    assert psnr(img, dec) > 40


def test_8x8_backends_compatible(quant8):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    enc_np = encode_image(img, quant8, True, use_huffman=False, norm="ortho",
                          backend="numpy", block_size=8)
    # numpy stream decodes on the jax backend and vice versa
    dec = decode_image(enc_np, norm="ortho", backend="jax", block_size=8)
    dec2 = decode_image(enc_np, norm="ortho", backend="numpy", block_size=8)
    assert np.abs(dec.astype(int) - dec2.astype(int)).max() <= 1  # f32 ties


def test_8x8_jax_device_pack_nontrivial(quant8):
    """Regression: 8x8 records can reach ~979 bits; the device packer must
    size its register file and output from the record width, not assume 4x4
    (it used to truncate streams silently on content like this)."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    a = encode_image(img, quant8, True, use_huffman=False, norm="ortho",
                     backend="numpy", block_size=8)
    b = encode_image(img, quant8, True, use_huffman=False, norm="ortho",
                     backend="jax", block_size=8)
    # Streams may differ on f32 rounding ties only; lengths must be close
    # and the decodes near-identical (not garbage).
    assert abs(len(a) - len(b)) <= 16, (len(a), len(b))
    da = decode_image(a, norm="ortho", backend="numpy", block_size=8)
    db = decode_image(b, norm="ortho", backend="numpy", block_size=8)
    assert np.abs(da.astype(int) - db.astype(int)).mean() < 0.5


@pytest.mark.parametrize("backend", ["numpy", "fast", "jax"])
def test_video_8x8_roundtrip(backend):
    """8x8 blocks through the VIDEO codec (reference: a compile-time
    recompile, Block.hpp:13; norm='ortho' because the reference C() is
    4x4-only, algo.cpp:294-297)."""
    from imageencoder_tpu.models.video import decode_video, encode_video

    from tests.test_video_parity import make_video

    w, h = 64, 64
    data, frames = make_video(w=w, h=h, n=6, seed=5)
    quant = QuantMatrix.from_file(QUANT8, size=8)
    enc = encode_video(data, w, h, quant, True, 3, 16, use_huffman=True,
                       norm="ortho", backend=backend, block_size=8)
    dec, params, dims = decode_video(enc, norm="ortho", backend="numpy",
                                     block_size=8)
    assert dims == (w, h) and params.frame_count == 6
    y_size = w * h
    fs = y_size + y_size // 2
    for f in range(6):
        got = np.frombuffer(dec[f * fs:f * fs + y_size],
                            dtype=np.uint8).reshape(h, w)
        assert np.mean(np.abs(got.astype(int) - frames[f].astype(int))) < 20


def test_video_8x8_sharded_step_matches():
    """8x8 sharded video step produces the same stream as single-device."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import jax.numpy as jnp

    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.models.video import encode_video, mvec_bits
    from imageencoder_tpu.models.video import split_yuv420
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.parallel.mesh import make_mesh
    from imageencoder_tpu.parallel.video_sharding import (
        assemble_sharded_video_packed, make_sharded_video_packed)

    from tests.test_video_parity import make_video

    w, h = 64, 128
    data, _ = make_video(w=w, h=h, n=4, seed=9, smooth=False)
    frames = split_yuv420(data, w, h)
    quant = QuantMatrix.from_file(QUANT8, size=8)

    mesh = make_mesh(8, frame_axis=4)
    step = make_sharded_video_packed(mesh, 4, 16, mvec_bits(16),
                                     block_size=8, norm="ortho")
    wtr = BitWriter()
    write_image_header(wtr, quant, True, w, h)
    write_video_params(wtr, VideoParams(4, 4, 16))
    mvw, blw, blk_bits, hist = jax.block_until_ready(
        step(jnp.asarray(frames), jnp.asarray(quant.as_float(np.float32)),
             np.int32(wtr.position)))
    assembled = assemble_sharded_video_packed(
        mvw, blw, blk_bits, w, h, quant, True, 4, 16,
        use_huffman=True, hist=hist)
    single = encode_video(data, w, h, quant, True, 4, 16, use_huffman=True,
                          norm="ortho", backend="jax", block_size=8)
    assert assembled == single


def test_video_8x8_sharded_stage2_huffman():
    """8x8 blocks through the packed sharded video path WITH stage-2
    distributed entropy coding."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    import jax.numpy as jnp

    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.models.video import (encode_video, mvec_bits,
                                               split_yuv420)
    from imageencoder_tpu.ops.bitpack import BitWriter
    from imageencoder_tpu.parallel.mesh import make_mesh
    from imageencoder_tpu.parallel.video_sharding import (
        encode_sharded_video_huffman, make_sharded_video_packed)

    from tests.test_video_parity import make_video

    w, h = 64, 128
    data, _ = make_video(w=w, h=h, n=4, seed=9, smooth=False)
    frames = split_yuv420(data, w, h)
    quant = QuantMatrix.from_file(QUANT8, size=8)

    mesh = make_mesh(8, frame_axis=4)
    step = make_sharded_video_packed(mesh, 4, 16, mvec_bits(16),
                                     block_size=8, norm="ortho")
    wtr = BitWriter()
    write_image_header(wtr, quant, True, w, h)
    write_video_params(wtr, VideoParams(4, 4, 16))
    mvw, blw, blk_bits, hist = jax.block_until_ready(
        step(jnp.asarray(frames), jnp.asarray(quant.as_float(np.float32)),
             np.int32(wtr.position)))
    got = encode_sharded_video_huffman(mvw, blw, blk_bits, hist, w, h,
                                       quant, True, 4, 16, mesh)
    single = encode_video(data, w, h, quant, True, 4, 16, use_huffman=True,
                          norm="ortho", backend="jax", block_size=8)
    assert got == single
