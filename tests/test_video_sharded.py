"""Sharded video step (halo-exchange motion search) vs single-device path.

Runs on the virtual 8-device CPU mesh; validates that stripe-local motion
search with ppermute halos reproduces the global search bit-for-bit, and
that the residual fields match the unsharded device pipeline.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageencoder_tpu.models.video import mvec_bits, split_yuv420
from imageencoder_tpu.ops.motion import find_motion, predict_image
from imageencoder_tpu.ops.pipeline import _round_half_away, fields_from_coeffs
from imageencoder_tpu.ops.dct import dct_matrix
from imageencoder_tpu.ops.zigzag import zigzag_order
from imageencoder_tpu.parallel.mesh import make_mesh
from imageencoder_tpu.parallel.video_sharding import make_sharded_video_step

from tests.test_video_parity import make_video
from tests.oracle import QUANT4


@pytest.fixture(autouse=True)
def _eight_devices():
    """Decided per test, never at import (conftest sets 8 CPU devices)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")

GOP, MERANGE = 4, 16


def expected_frame_fields(cur, ref, is_i, quant, merange=MERANGE):
    """Unsharded oracle: same f32 ops as the device pipeline."""
    h, w = cur.shape
    if is_i:
        x = cur.astype(np.float32)
        mv = np.zeros(((h // 16) * (w // 16), 2), np.int32)
    else:
        mv, _ = find_motion(cur, ref, merange)
        pred = predict_image(ref, mv, h, w)
        x = cur.astype(np.float32) - pred.astype(np.float32)
    d = jnp.asarray(np.asarray(dct_matrix(4, "reference"), np.float32))
    blocks = x.reshape(h // 4, 4, w // 4, 4).swapaxes(1, 2).reshape(-1, 4, 4)
    y = jnp.einsum("ui,nij,vj->nuv", d,
                   jnp.asarray(blocks) - jnp.float32(128.0), d,
                   precision=jax.lax.Precision.HIGHEST)
    q = _round_half_away(jnp, y / jnp.asarray(quant)).astype(jnp.int32)
    czz = q.reshape(-1, 16)[:, jnp.asarray(zigzag_order(4))]
    vals, nbits = fields_from_coeffs(czz, True)
    return mv, np.asarray(vals), np.asarray(nbits)


def test_sharded_video_step_matches_single_device():
    data, _ = make_video(w=64, h=128, n=4, seed=21, smooth=False)
    frames = split_yuv420(data, 64, 128)
    quant = np.full((4, 4), 5.0, dtype=np.float32)

    mesh = make_mesh(8, frame_axis=4)  # 4 frame chunks x 2 stripes of 64 rows
    step = make_sharded_video_step(mesh, GOP, MERANGE, mvec_bits(MERANGE))
    mvals, bvals, bnbits, base = jax.block_until_ready(
        step(jnp.asarray(frames), jnp.asarray(quant)))
    mvals, bvals, bnbits, base = map(np.asarray, (mvals, bvals, bnbits, base))

    mask = (1 << mvec_bits(MERANGE)) - 1
    for f in range(4):
        is_i = f % GOP == 0
        ref = frames[f - 1] if f else None
        mv, vals, nbits = expected_frame_fields(frames[f], ref, is_i, quant)
        np.testing.assert_array_equal(bvals[f], vals, err_msg=f"frame {f}")
        np.testing.assert_array_equal(bnbits[f], nbits, err_msg=f"frame {f}")
        if not is_i:
            np.testing.assert_array_equal(mvals[f], mv & mask,
                                          err_msg=f"frame {f} mv")
        else:
            assert (mvals[f] == 0).all()
        # base holds per-stripe totals; stripe s = rows [s*64, (s+1)*64)
        per_stripe = nbits.reshape(2, -1).sum(axis=1)
        np.testing.assert_array_equal(base[f], per_stripe)


def test_sharded_video_step_large_motion():
    """Cross-stripe motion: content shifted by more than a stripe's guard."""
    rng = np.random.default_rng(3)
    base_img = np.kron(rng.integers(0, 256, (32, 16)),
                       np.ones((4, 4))).astype(np.uint8)  # 128x64
    f0 = base_img
    f1 = np.roll(base_img, 14, axis=0)  # vertical motion near merange
    frames = np.stack([f0, f1])

    quant = np.full((4, 4), 5.0, dtype=np.float32)
    mesh = make_mesh(8, frame_axis=2)  # 2 chunks x 4 stripes of 32 rows
    step = make_sharded_video_step(mesh, GOP, MERANGE, mvec_bits(MERANGE))
    mvals, bvals, bnbits, base = jax.block_until_ready(
        step(jnp.asarray(frames), jnp.asarray(quant)))

    mv, vals, nbits = expected_frame_fields(f1, f0, False, quant)
    mask = (1 << mvec_bits(MERANGE)) - 1
    np.testing.assert_array_equal(np.asarray(mvals)[1], mv & mask)
    np.testing.assert_array_equal(np.asarray(bvals)[1], vals)


def test_sharded_video_step_merange32():
    """Wider search radius: halo = 31 rows, stripes of 64."""
    rng = np.random.default_rng(8)
    base = np.kron(rng.integers(0, 256, (32, 16)),
                   np.ones((4, 4))).astype(np.uint8)  # 128x64
    frames = np.stack([base, np.roll(base, 25, axis=0)])
    quant = np.full((4, 4), 5.0, dtype=np.float32)
    mesh = make_mesh(8, frame_axis=4)  # frames padded below to 4 chunks
    frames4 = np.concatenate([frames, frames])  # 4 frames over 4 chunks
    step = make_sharded_video_step(mesh, 4, 32, mvec_bits(32))
    mvals, bvals, bnbits, base_o = jax.block_until_ready(
        step(jnp.asarray(frames4), jnp.asarray(quant)))

    mv, vals, nbits = expected_frame_fields(frames4[1], frames4[0], False,
                                            quant, merange=32)
    mask = (1 << mvec_bits(32)) - 1
    np.testing.assert_array_equal(np.asarray(mvals)[1], mv & mask)
    np.testing.assert_array_equal(np.asarray(bvals)[1], vals)


def test_sharded_step_assembles_to_identical_stream():
    """Sharded-step outputs assemble to the exact single-device stream."""
    from imageencoder_tpu.models.video import decode_video, encode_video
    from imageencoder_tpu.parallel.video_sharding import assemble_sharded_video
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=4, seed=33, smooth=False)
    frames = split_yuv420(data, 64, 128)

    mesh = make_mesh(8, frame_axis=4)
    step = make_sharded_video_step(mesh, GOP, MERANGE, mvec_bits(MERANGE))
    mvals, bvals, bnbits, base = jax.block_until_ready(
        step(jnp.asarray(frames), jnp.asarray(quant.as_float(np.float32))))

    for uh in (False, True):
        assembled = assemble_sharded_video(mvals, bnbits, bvals, 64, 128,
                                           quant, True, GOP, MERANGE,
                                           use_huffman=uh)
        single = encode_video(data, 64, 128, quant, True, GOP, MERANGE,
                              use_huffman=uh, backend="jax")
        assert assembled == single, uh
    dec, params, _ = decode_video(assembled)
    assert params.frame_count == 4


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("use_huffman", [False, True])
def test_sharded_video_packed_stream(ref_mode, use_huffman):
    """The PACKED sharded video path: on-device per-segment packing +
    byte-OR splice + psum'd byte histogram must reproduce the
    single-device jax stream byte-for-byte, in both reference modes."""
    from imageencoder_tpu.models.video import encode_video
    from imageencoder_tpu.parallel.video_sharding import (
        assemble_sharded_video_packed, make_sharded_video_packed)
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=8, seed=33, smooth=False)
    frames = split_yuv420(data, 64, 128)

    mesh = make_mesh(8, frame_axis=2)  # 2 chunks x 4 frames (gop-aligned)
    step = make_sharded_video_packed(mesh, GOP, MERANGE,
                                     mvec_bits(MERANGE), ref_mode=ref_mode)
    # start_bit must match the real video header for this geometry.
    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.ops.bitpack import BitWriter

    wtr = BitWriter()
    if not use_huffman:
        wtr.put_bit(0)
    write_image_header(wtr, quant, True, 64, 128)
    write_video_params(wtr, VideoParams(8, GOP, MERANGE))

    mvw, blw, blk_bits, hist = jax.block_until_ready(
        step(jnp.asarray(frames),
             jnp.asarray(quant.as_float(np.float32)),
             np.int32(wtr.position)))
    assembled = assemble_sharded_video_packed(
        mvw, blw, blk_bits, 64, 128, quant, True, GOP, MERANGE,
        use_huffman=use_huffman, hist=hist)
    single = encode_video(data, 64, 128, quant, True, GOP, MERANGE,
                          use_huffman=use_huffman, backend="jax",
                          ref_mode=ref_mode)
    assert assembled == single


@pytest.mark.parametrize("use_huffman", [False, True])
def test_sharded_video_auto_chunking(use_huffman):
    """encode_video_sharded auto-chunks past the (injected) int32 offset
    capacity instead of raising, and the spliced stream is byte-identical
    to the unchunked sharded pass and the single-device encoder."""
    from imageencoder_tpu.models.video import encode_video
    from imageencoder_tpu.parallel.video_sharding import encode_video_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=8, seed=33, smooth=False)
    frames = split_yuv420(data, 64, 128)
    mesh = make_mesh(8, frame_axis=2)

    one_pass = encode_video_sharded(frames, quant, mesh, True, GOP, MERANGE,
                                    use_huffman=use_huffman)
    # Capacity that fits ~4 frames of worst-case payload: forces 2 chunks.
    chunked = encode_video_sharded(frames, quant, mesh, True, GOP, MERANGE,
                                   use_huffman=use_huffman,
                                   bit_capacity=3_000_000)
    assert chunked == one_pass
    single = encode_video(data, 64, 128, quant, True, GOP, MERANGE,
                          use_huffman=use_huffman, backend="jax")
    assert chunked == single


def test_sharded_video_auto_chunking_recon():
    from imageencoder_tpu.models.video import encode_video
    from imageencoder_tpu.parallel.video_sharding import encode_video_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=16, seed=9, smooth=False)
    frames = split_yuv420(data, 64, 128)
    mesh = make_mesh(8, frame_axis=2)
    # recon granularity = gop * frame_axis = 8 frames; force 2 chunks.
    chunked = encode_video_sharded(frames, quant, mesh, True, GOP, MERANGE,
                                   use_huffman=True, ref_mode="recon",
                                   bit_capacity=6_000_000)
    single = encode_video(data, 64, 128, quant, True, GOP, MERANGE,
                          use_huffman=True, backend="jax", ref_mode="recon")
    assert chunked == single


def test_sharded_video_capacity_error_when_unchunkable():
    from imageencoder_tpu.parallel.video_sharding import encode_video_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=8, seed=3, smooth=True)
    frames = split_yuv420(data, 64, 128)
    mesh = make_mesh(8, frame_axis=2)
    with pytest.raises(ValueError, match="capacity"):
        encode_video_sharded(frames, quant, mesh, True, GOP, MERANGE,
                             bit_capacity=100_000)  # < one GOP of frames


def test_sharded_video_decode_bit_identical():
    """GOP-sharded device decode == single-device jax decode, bit for bit, incl. ragged GOP counts that need padding and the
    motioncomp=0 toggle."""
    from imageencoder_tpu.models.video import decode_video, encode_video
    from imageencoder_tpu.parallel.video_sharding import decode_video_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    mesh = make_mesh(8, frame_axis=2)
    for n, gop, mc in [(8, GOP, True),   # 2 GOPs -> padded to 8
                       (11, 3, True),    # ragged tail GOP
                       (8, GOP, False)]:
        data, _ = make_video(w=64, h=128, n=n, seed=5, smooth=False)
        enc = encode_video(data, 64, 128, quant, True, gop, MERANGE,
                           use_huffman=True)
        want, wp, (ww, wh) = decode_video(enc, motioncomp=mc, backend="jax")
        got, gp, (gw, gh) = decode_video_sharded(enc, mesh, motioncomp=mc)
        assert (wp.frame_count, ww, wh) == (gp.frame_count, gw, gh)
        assert got == want, (n, gop, mc)


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_sharded_video_stage2_huffman(ref_mode):
    """Distributed entropy coding over the packed video segments must be
    byte-identical to the single-device huffman stream."""
    from imageencoder_tpu.models.video import encode_video
    from imageencoder_tpu.parallel.video_sharding import (
        encode_sharded_video_huffman, make_sharded_video_packed)
    from imageencoder_tpu.utils.quant import QuantMatrix

    quant = QuantMatrix.from_file(QUANT4)
    data, _ = make_video(w=64, h=128, n=8, seed=33, smooth=False)
    frames = split_yuv420(data, 64, 128)

    mesh = make_mesh(8, frame_axis=2)
    step = make_sharded_video_packed(mesh, GOP, MERANGE,
                                     mvec_bits(MERANGE), ref_mode=ref_mode)
    from imageencoder_tpu.models.headers import (VideoParams,
                                                 write_image_header,
                                                 write_video_params)
    from imageencoder_tpu.ops.bitpack import BitWriter

    wtr = BitWriter()
    write_image_header(wtr, quant, True, 64, 128)
    write_video_params(wtr, VideoParams(8, GOP, MERANGE))
    mvw, blw, blk_bits, hist = jax.block_until_ready(
        step(jnp.asarray(frames),
             jnp.asarray(quant.as_float(np.float32)),
             np.int32(wtr.position)))
    got = encode_sharded_video_huffman(mvw, blw, blk_bits, hist, 64, 128,
                                       quant, True, GOP, MERANGE, mesh)
    single = encode_video(data, 64, 128, quant, True, GOP, MERANGE,
                          use_huffman=True, backend="jax",
                          ref_mode=ref_mode)
    assert got == single
