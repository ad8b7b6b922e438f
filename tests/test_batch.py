"""Batch image encoding: per-image streams byte-identical to single encodes."""

import numpy as np
import pytest

from imageencoder_tpu.models.batch import encode_image_batch
from imageencoder_tpu.models.image import decode_image, encode_image
from imageencoder_tpu.utils.quant import QuantMatrix
from tests.oracle import QUANT4

MATRIX = QUANT4


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


@pytest.fixture(scope="module")
def imgs():
    rng = np.random.default_rng(3)
    base = np.kron(rng.integers(0, 256, (5, 16, 12)),
                   np.ones((1, 4, 4))).astype(np.float64)
    return np.clip(base + rng.normal(0, 5, base.shape), 0,
                   255).astype(np.uint8)  # [5, 64, 48]


@pytest.mark.parametrize("use_huffman", [False, True])
def test_batch_matches_single_image_encodes(quant, imgs, use_huffman):
    batch = encode_image_batch(imgs, quant, True, use_huffman=use_huffman)
    assert len(batch) == len(imgs)
    for i, img in enumerate(imgs):
        single = encode_image(img, quant, True, use_huffman=use_huffman,
                              backend="jax")
        assert batch[i] == single, f"image {i}"


def test_batch_streams_decode(quant, imgs):
    for stream, img in zip(encode_image_batch(imgs, quant, True), imgs):
        dec = decode_image(stream)
        assert dec.shape == img.shape


def test_batch_of_one(quant, imgs):
    [one] = encode_image_batch(imgs[:1], quant, True)
    assert one == encode_image(imgs[0], quant, True, use_huffman=True,
                               backend="jax")


def test_stream_encode_matches_single(quant):
    from imageencoder_tpu.models.batch import encode_image_stream
    from imageencoder_tpu.models.image import encode_image

    rng = np.random.default_rng(9)
    imgs = [np.kron(rng.integers(0, 256, (16, 16)),
                    np.ones((4, 4))).astype(np.uint8) for _ in range(5)]
    for uh in (True, False):
        got = list(encode_image_stream(iter(imgs), quant, True,
                                       use_huffman=uh))
        want = [encode_image(im, quant, True, use_huffman=uh,
                             backend="jax") for im in imgs]
        assert got == want, uh


def test_decode_batch_matches_single(quant):
    from imageencoder_tpu.models.batch import decode_image_batch
    from imageencoder_tpu.models.image import decode_image, encode_image

    rng = np.random.default_rng(3)
    streams = []
    for k in range(5):
        img = np.kron(rng.integers(0, 256, (16, 16)),
                      np.ones((4, 4))).astype(np.uint8)
        streams.append(encode_image(img, quant, True, use_huffman=True))
    got = decode_image_batch(streams, backend="numpy", max_workers=4)
    for s, g in zip(streams, got):
        assert np.array_equal(g, decode_image(s, backend="numpy"))


def test_header_hole_fits_every_legal_header():
    """The batch pack reserves GAP_RECORDS records of split16 widths for
    each image's header; the largest legal header (widest quant entries,
    biggest dims, no-Huffman flag) fits, and the encoder refuses bigger."""
    from imageencoder_tpu.models.batch import (GAP_RECORDS,
                                               header_hole_bits)
    from imageencoder_tpu.models.headers import write_image_header
    from imageencoder_tpu.ops.bitpack import BitWriter

    for b in (4, 8):
        assert header_hole_bits(b) == GAP_RECORDS * (b * b + 2) * 16
        w = BitWriter()
        w.put_bit(0)
        write_image_header(w, QuantMatrix(np.full((b, b), 65535)), True,
                           65535, 65535)
        assert w.position <= header_hole_bits(b)


def test_header_hole_check_raises(monkeypatch):
    from imageencoder_tpu.models import batch

    monkeypatch.setattr(batch, "header_hole_bits", lambda b: 8)
    with pytest.raises(ValueError, match="header hole"):
        batch.encode_image_batch(np.zeros((1, 16, 16), np.uint8),
                                 QuantMatrix(np.full((4, 4), 10)))
