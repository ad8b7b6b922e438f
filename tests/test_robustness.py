"""Robustness on malformed inputs.

The reference reads zeros past the end of a truncated stream
(BitStream.cpp:14-28) and produces garbage output without crashing; it
aborts the process on some malformed Huffman streams.  We match the
read-zeros semantics and never crash the interpreter.
"""

import numpy as np
import pytest

from imageencoder_tpu import (QuantMatrix, decode_image, decode_video,
                              encode_image, encode_video)
from tests.oracle import QUANT4

MATRIX = QUANT4


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


@pytest.fixture(scope="module")
def enc(quant):
    rng = np.random.default_rng(0)
    img = np.kron(rng.integers(0, 256, (8, 8)),
                  np.ones((8, 8))).astype(np.uint8)
    return encode_image(img, quant, True, use_huffman=False), img


def test_truncated_stream_decodes_to_garbage_not_crash(enc):
    data, img = enc
    for frac in (0.9, 0.5, 0.1):
        cut = data[: int(len(data) * frac)]
        out = decode_image(cut)
        assert out.shape == img.shape  # zero-filled tail, like the reference


def test_truncated_huffman_stream(quant):
    rng = np.random.default_rng(1)
    img = np.kron(rng.integers(0, 256, (8, 8)),
                  np.ones((8, 8))).astype(np.uint8)
    data = encode_image(img, quant, True, use_huffman=True)
    out = decode_image(data[: len(data) // 2])
    assert out.shape == img.shape


def test_truncated_video_stream(quant):
    rng = np.random.default_rng(2)
    y = np.kron(rng.integers(0, 256, (8, 8)), np.ones((8, 8))).astype(np.uint8)
    data = b"".join(np.roll(y, k, axis=0).tobytes() + bytes([0x80]) * 2048
                    for k in range(4))
    enc = encode_video(data, 64, 64, quant, True, 2, 8, use_huffman=False)
    dec, params, _ = decode_video(enc[: len(enc) * 2 // 3])
    assert params.frame_count == 4
    assert len(dec) == len(data)


def test_bit_flip_corruption_does_not_crash(enc):
    data, img = enc
    for pos in (len(data) // 3, len(data) // 2, len(data) - 5):
        corrupt = bytearray(data)
        corrupt[pos] ^= 0x55
        out = decode_image(bytes(corrupt))
        assert out.shape == img.shape


def test_empty_ish_image():
    q = QuantMatrix(np.full((4, 4), 2))
    img = np.zeros((4, 4), dtype=np.uint8)
    enc_ = encode_image(img, q, True, use_huffman=False)
    out = decode_image(enc_)
    np.testing.assert_array_equal(out, img)


def test_encode_deterministic_across_runs(quant):
    """No data races: repeated encodes are byte-identical (the reference
    relies on OpenMP loop structure for this; we rely on pure functions)."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    streams = {encode_image(img, quant, True, use_huffman=True)
               for _ in range(3)}
    assert len(streams) == 1

    y = np.kron(rng.integers(0, 256, (8, 8)), np.ones((8, 8))).astype(np.uint8)
    data = b"".join(np.roll(y, k, axis=1).tobytes() + bytes([0x80]) * 2048
                    for k in range(4))
    vstreams = {encode_video(data, 64, 64, quant, True, 2, 8)
                for _ in range(3)}
    assert len(vstreams) == 1


def test_empty_stream_raises_typed_error():
    from imageencoder_tpu.utils.exceptions import StreamFormatError

    with pytest.raises(StreamFormatError):
        decode_image(b"")
    with pytest.raises(StreamFormatError):
        decode_video(b"")


def test_zero_frame_video(quant):
    for backend in ("numpy", "jax"):
        enc = encode_video(b"\x80" * 100, 64, 64, quant, True, 4, 16,
                           use_huffman=False, backend=backend)
        dec, params, (w, h) = decode_video(enc)
        assert params.frame_count == 0
        assert dec == b""


def test_video_dims_must_be_macroblock_multiples(quant):
    with pytest.raises(ValueError):
        encode_video(b"\x00" * (20 * 32 * 3 // 2), 20, 32, quant, True, 4, 16)
