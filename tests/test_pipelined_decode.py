"""Overlapped native decode pipeline (runtime.cpp::decode_image_pipelined):
bit-identity against the staged chain across stream shapes, plus the
native dict parse and bounded head decode."""

import os

import numpy as np
import pytest

import imageencoder_tpu.models.image as image_mod
from imageencoder_tpu.models.image import decode_image, encode_image
from imageencoder_tpu.runtime.native import available
from imageencoder_tpu.utils.quant import QuantMatrix
from tests.oracle import QUANT4, QUANT8

MATRIX = QUANT4

pytestmark = pytest.mark.skipif(not available(),
                                reason="native runtime not built")


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


def _pipe_vs_staged(enc, monkeypatch, block_size=4):
    monkeypatch.setenv("IER_PIPELINED_DECODE", "1")
    pipe = image_mod._decode_image_pipelined_host(enc, "reference",
                                                  block_size, exact=True)
    assert pipe is not None
    monkeypatch.delenv("IER_PIPELINED_DECODE")
    staged = decode_image(enc, backend="numpy", block_size=block_size)
    np.testing.assert_array_equal(pipe, staged)


@pytest.mark.parametrize("use_huffman,use_rle", [(True, True), (True, False),
                                                 (False, True)])
def test_pipelined_matches_staged(quant, monkeypatch, use_huffman, use_rle):
    raw = np.fromfile("/root/reference/bin/ex1.raw",
                      np.uint8).reshape(936, 936)
    enc = encode_image(raw, quant, use_rle=use_rle, use_huffman=use_huffman,
                       backend="numpy")
    _pipe_vs_staged(enc, monkeypatch)


def test_pipelined_small_and_flat(quant, monkeypatch):
    # Tiny image (single FSM chunk / no chunking) and an all-flat image
    # (maximal RLE, degenerate Huffman histogram).
    for img in (np.full((8, 8), 7, np.uint8),
                np.zeros((64, 64), np.uint8),
                np.arange(16 * 16, dtype=np.uint8).reshape(16, 16)):
        enc = encode_image(img, quant, use_rle=True, use_huffman=True,
                           backend="numpy")
        _pipe_vs_staged(enc, monkeypatch)


def test_pipelined_block8(monkeypatch):
    q8 = QuantMatrix.from_file(QUANT8, 8)
    rng = np.random.default_rng(5)
    img = np.kron(rng.integers(0, 256, (16, 16)),
                  np.ones((8, 8))).astype(np.uint8)
    enc = encode_image(img, q8, use_rle=True, use_huffman=True,
                       backend="numpy", block_size=8)
    _pipe_vs_staged(enc, monkeypatch, block_size=8)


def test_pipelined_decode_via_env(quant, monkeypatch):
    """decode_image routes through the pipeline when IER_PIPELINED_DECODE
    is set; output equals the default staged path."""
    raw = np.fromfile("/root/reference/bin/ex6.raw",
                      np.uint8).reshape(256, 512)
    enc = encode_image(raw, quant, use_rle=True, use_huffman=True,
                       backend="numpy")
    staged = decode_image(enc, backend="numpy")
    monkeypatch.setenv("IER_PIPELINED_DECODE", "1")
    pipe = decode_image(enc, backend="numpy")
    np.testing.assert_array_equal(pipe, staged)


def test_native_dict_parse_matches_python(quant):
    from imageencoder_tpu.ops.bitpack import BitReader
    from imageencoder_tpu.ops.huffman import parse_dict
    from imageencoder_tpu.runtime.native import parse_huffman_dict_native

    raw = np.fromfile("/root/reference/bin/ex6.raw",
                      np.uint8).reshape(256, 512)
    enc = encode_image(raw, quant, use_rle=True, use_huffman=True,
                       backend="numpy")
    assert enc[0] & 0x80
    reader = BitReader(enc[:65536])
    want = parse_dict(reader)
    got, end = parse_huffman_dict_native(enc)
    assert got == want
    assert end == reader.position


def test_head_decode_matches_full(quant):
    from imageencoder_tpu.ops.huffman import huffman_decode, parse_dict_bytes
    from imageencoder_tpu.runtime.native import huffman_fsm_decode_head_native

    raw = np.fromfile("/root/reference/bin/ex6.raw",
                      np.uint8).reshape(256, 512)
    enc = encode_image(raw, quant, use_rle=True, use_huffman=True,
                       backend="numpy")
    entries, end = parse_dict_bytes(enc)
    head = huffman_fsm_decode_head_native(enc, end, entries, max_out=512)
    full = huffman_decode(enc)
    assert head == full[:len(head)]
    assert len(head) == 512
