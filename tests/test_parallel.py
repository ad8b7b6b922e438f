"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates that the sharded encode step (parallel/sharding.py) produces
exactly the same wire-format fields — and therefore bit-identical streams —
as the single-device path, plus the correctness of its collectives
(all_gather prefix offsets, psum histogram).
"""

import numpy as np
import pytest

import jax

from imageencoder_tpu.ops import bitpack
from imageencoder_tpu.ops.blockify import blockify
from imageencoder_tpu.ops.pipeline import make_encode_fields_from_blocks
from imageencoder_tpu.parallel import make_mesh, make_sharded_encode_step


@pytest.fixture(autouse=True)
def _eight_devices():
    """Decided per test, never at import (conftest sets 8 CPU devices)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(42)
    # Smooth-ish content so RLE paths are exercised (not max-entropy noise).
    base = rng.integers(0, 256, size=(4, 8, 8)).astype(np.float64)
    up = np.kron(base, np.ones((1, 8, 8)))  # [4, 64, 64]
    return np.clip(up + rng.normal(0, 4, up.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def quant():
    return np.full((4, 4), 10.0, dtype=np.float32)


def test_sharded_fields_match_single_device(frames, quant):
    mesh = make_mesh(8)
    step = make_sharded_encode_step(mesh)
    vals_s, nbits_s, base = jax.block_until_ready(step(frames, quant))

    single = make_encode_fields_from_blocks(4, True, "reference")
    for f in range(frames.shape[0]):
        vals_1, nbits_1 = single(blockify(frames[f], 4), quant)
        np.testing.assert_array_equal(np.asarray(vals_s)[f], np.asarray(vals_1))
        np.testing.assert_array_equal(np.asarray(nbits_s)[f], np.asarray(nbits_1))


def test_sharded_stream_assembly_bit_identical(frames, quant):
    """Stripes concatenated at their all_gather'd base offsets == serial pack."""
    mesh = make_mesh(8)
    s = mesh.shape["block"]
    step = make_sharded_encode_step(mesh)
    vals, nbits, base = jax.block_until_ready(step(frames, quant))
    vals, nbits, base = map(np.asarray, (vals, nbits, base))

    f = 0
    serial, total = bitpack.pack_fields(vals[f].ravel(), nbits[f].ravel())

    # Reassemble from per-stripe packs placed at their base offsets.
    n_loc = vals.shape[1] // s
    bitbuf = np.zeros(((total + 7) // 8) * 8, dtype=np.uint8)
    for stripe in range(s):
        sl = slice(stripe * n_loc, (stripe + 1) * n_loc)
        data, nb = bitpack.pack_fields(vals[f, sl].ravel(), nbits[f, sl].ravel())
        off = int(base[f, stripe])
        assert off == int(nbits[f, :stripe * n_loc].sum())
        bitbuf[off:off + nb] = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8))[:nb]
    assert np.packbits(bitbuf).tobytes() == serial


def test_sharded_packed_stream_and_histogram(frames, quant):
    """The packed sharded path: per-shard device packing, funnel alignment,
    byte-OR splice, and the psum'd byte histogram — the collective is
    CONSUMED by the Huffman build and must equal the exact stream
    histogram once boundary bytes are added."""
    import jax.numpy as jnp

    from imageencoder_tpu.parallel import (assemble_packed_stream,
                                           boundary_byte_histogram,
                                           make_sharded_encode_packed)

    mesh = make_mesh(8)
    step = make_sharded_encode_packed(mesh, mode="concat")
    start_bit = 37
    words, bits, hist = jax.block_until_ready(
        step(frames, quant, np.int32(start_bit)))

    # Reference: serial pack of the full field stream at the same offset.
    fields = make_encode_fields_from_blocks(4, True, "reference")
    all_vals, all_nbits = [np.array([0])], [np.array([start_bit])]
    for f in range(frames.shape[0]):
        v1, n1 = fields(blockify(frames[f], 4), quant)
        all_vals.append(np.asarray(v1).ravel())
        all_nbits.append(np.asarray(n1).ravel())
    serial, total = bitpack.pack_fields(
        np.concatenate(all_vals).astype(np.int64),
        np.concatenate(all_nbits).astype(np.int64))

    header = b"\x00" * ((start_bit + 7) // 8)  # zero header region
    inner, tbits = assemble_packed_stream(words, bits, start_bit, header,
                                          mode="concat")
    assert tbits == total
    assert inner == serial

    dev_hist = np.asarray(hist)[:, :256].sum(axis=0).astype(np.int64)
    full = dev_hist + boundary_byte_histogram(inner, bits, start_bit)
    expect = np.bincount(np.frombuffer(inner, np.uint8), minlength=256)
    np.testing.assert_array_equal(full, expect)


def test_sharded_image_batch_streams_decode(frames, quant):
    """encode_sharded_image_batch: each image's stream decodes identically
    to the single-device jax-backend stream."""
    from imageencoder_tpu.models.image import encode_image
    from imageencoder_tpu.parallel import encode_sharded_image_batch
    from imageencoder_tpu.utils.quant import QuantMatrix

    mesh = make_mesh(8)
    qm = QuantMatrix(quant.astype(np.uint32))
    streams = encode_sharded_image_batch(frames, qm, mesh, use_rle=True,
                                         use_huffman=True)
    for f in range(frames.shape[0]):
        single = encode_image(frames[f], qm, use_rle=True, use_huffman=True,
                              backend="jax")
        assert streams[f] == single


def test_mesh_factorization():
    m = make_mesh(8)
    assert m.shape["frame"] * m.shape["block"] == 8
    m = make_mesh(8, frame_axis=2)
    assert m.shape["frame"] == 2 and m.shape["block"] == 4


@pytest.mark.parametrize("mode", ["concat", "separate"])
def test_stage2_distributed_huffman(frames, quant, mode):
    """Stage-2 distributed entropy coding: shard-local per-byte re-encode
    + device pack + compressed-byte splice must be byte-identical to the
    serial huffman_encode of the assembled inner stream."""
    import jax.numpy as jnp

    from imageencoder_tpu.ops.huffman import huffman_encode
    from imageencoder_tpu.parallel import (assemble_packed_stream,
                                           encode_sharded_huffman,
                                           make_sharded_encode_packed)

    mesh = make_mesh(8)
    start_bit = 37
    step = make_sharded_encode_packed(mesh, mode=mode)
    words, bits, hist = jax.block_until_ready(
        step(frames, quant, np.int32(start_bit)))
    header = b"\x12\x34\x50\x00\x00"[:(start_bit + 7) // 8]

    got = encode_sharded_huffman(words, bits, hist, start_bit, header,
                                 mesh, mode=mode)
    if mode == "concat":
        inner, _ = assemble_packed_stream(words, bits, start_bit, header,
                                          mode="concat")
        assert got == huffman_encode(inner)
    else:
        parts = assemble_packed_stream(words, bits, start_bit, header,
                                       mode="separate")
        for fi, (inner, _) in enumerate(parts):
            assert got[fi] == huffman_encode(inner), fi


def test_stage2_fallback_on_incompressible(quant):
    """Noise does not compress: stage 2 must emit the exact [0][raw]
    fallback the serial path produces."""
    import jax.numpy as jnp

    from imageencoder_tpu.ops.huffman import huffman_encode
    from imageencoder_tpu.parallel import (assemble_packed_stream,
                                           encode_sharded_huffman,
                                           make_sharded_encode_packed)

    rng = np.random.default_rng(0)
    noisy = rng.integers(0, 256, (4, 64, 64), dtype=np.uint8)
    mesh = make_mesh(8)
    step = make_sharded_encode_packed(mesh, mode="concat")
    words, bits, hist = jax.block_until_ready(
        step(noisy, quant, np.int32(8)))
    got = encode_sharded_huffman(words, bits, hist, 8, b"\x00", mesh,
                                 mode="concat")
    inner, _ = assemble_packed_stream(words, bits, 8, b"\x00",
                                      mode="concat")
    assert got == huffman_encode(inner)


def test_image_batch_device_entropy(frames, quant):
    from imageencoder_tpu.models.image import encode_image
    from imageencoder_tpu.parallel import encode_sharded_image_batch
    from imageencoder_tpu.utils.quant import QuantMatrix

    mesh = make_mesh(8)
    qm = QuantMatrix(quant.astype(np.uint32))
    streams = encode_sharded_image_batch(frames, qm, mesh, use_rle=True,
                                         use_huffman=True,
                                         device_entropy=True)
    for f in range(frames.shape[0]):
        single = encode_image(frames[f], qm, use_rle=True, use_huffman=True,
                              backend="jax")
        assert streams[f] == single, f


def test_sharded_image_decode_matches_single_device():
    """decode_image_sharded == decode_image(backend='jax') bit-for-bit:
    stripe batching does not change the per-block transform."""
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.parallel import decode_image_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(7)
    base = np.kron(rng.integers(0, 256, (8, 16)), np.ones((8, 8)))
    img = np.clip(base + rng.normal(0, 5, base.shape), 0,
                  255).astype(np.uint8)  # 64x128 -> 16 block rows = 2/shard
    q = QuantMatrix(np.full((4, 4), 10.0))
    for use_huffman in (True, False):
        enc = encode_image(img, q, use_rle=True, use_huffman=use_huffman,
                           backend="numpy")
        got = decode_image_sharded(enc, make_mesh(8))
        want = decode_image(enc, backend="jax")
        np.testing.assert_array_equal(got, want)
        # and the numpy parity path agrees up to f32 rounding ties
        exact = decode_image(enc, backend="numpy")
        assert np.abs(got.astype(int) - exact.astype(int)).max() <= 1


def test_sharded_image_decode_pads_odd_block_rows():
    """Block-row counts that don't divide the mesh size are zero-padded
    on device and sliced off after reassembly (9 rows over 8 devices)."""
    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.parallel import decode_image_sharded
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (36, 32), dtype=np.uint8)  # 9 block rows
    q = QuantMatrix(np.full((4, 4), 8.0))
    enc = encode_image(img, q, use_rle=True, use_huffman=True,
                       backend="numpy")
    got = decode_image_sharded(enc, make_mesh(8))
    want = decode_image(enc, backend="jax")
    assert got.shape == (36, 32)
    np.testing.assert_array_equal(got, want)
