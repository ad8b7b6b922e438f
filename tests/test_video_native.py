"""One-pass native video back end (runtime.cpp::encode_frame_pack) vs the
numpy fields chain it replaced — bit-identity, both ref modes, all-I and
no-RLE variants, and the capacity error path."""

import numpy as np
import pytest

from imageencoder_tpu.models import video as video_mod
from imageencoder_tpu.models.video import encode_video, decode_video
from imageencoder_tpu.runtime.native import available
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.test_video_parity import make_video
from tests.oracle import QUANT4, QUANT8

MATRIX = QUANT4

pytestmark = pytest.mark.skipif(not available(),
                                reason="native runtime not built")


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(MATRIX)


def _legacy(monkeypatch):
    """Force the numpy fields fallback chain."""
    def boom(*a, **k):
        raise ImportError("disabled for test")
    monkeypatch.setattr(video_mod, "_encode_video_host_native", boom)


@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
@pytest.mark.parametrize("rle,gop,n", [(True, 4, 8), (False, 3, 7),
                                       (True, 1, 5), (True, 8, 8)])
def test_native_video_encode_bit_identical(quant, monkeypatch, ref_mode,
                                           rle, gop, n):
    data, _ = make_video(n=n, seed=rle + gop, smooth=True)
    want_warns = []
    monkeypatch.setattr(video_mod, "encode_video", video_mod.encode_video)
    native = encode_video(data, 64, 64, quant, rle, gop, 16,
                          use_huffman=False, ref_mode=ref_mode)
    _legacy(monkeypatch)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        legacy = encode_video(data, 64, 64, quant, rle, gop, 16,
                              use_huffman=False, ref_mode=ref_mode)
    assert native == legacy, (len(native), len(legacy), want_warns)


def test_native_video_encode_block8(monkeypatch):
    q8 = QuantMatrix.from_file(QUANT8, 8)
    data, _ = make_video(n=6, seed=3, smooth=True)
    native = encode_video(data, 64, 64, q8, True, 3, 16, use_huffman=False,
                          block_size=8)
    _legacy(monkeypatch)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        legacy = encode_video(data, 64, 64, q8, True, 3, 16,
                              use_huffman=False, block_size=8)
    assert native == legacy


def test_native_video_encode_decodes(quant):
    data, frames = make_video(n=8, seed=9, smooth=True)
    enc = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True)
    dec, params, (w, h) = decode_video(enc)
    assert (params.frame_count, w, h) == (8, 64, 64)
    ys = np.frombuffer(dec, np.uint8).reshape(8, -1)[:, :64 * 64]
    orig = np.stack([f.reshape(-1) for f in frames]).astype(float)
    psnr = 10 * np.log10(255 ** 2 / ((ys - orig) ** 2).mean())
    assert psnr > 30


def test_encode_frame_pack_capacity_error(quant):
    from imageencoder_tpu.ops.dct import _fwd_weights
    from imageencoder_tpu.ops.zigzag import zigzag_order
    from imageencoder_tpu.runtime.native import encode_frame_pack_native

    rng = np.random.default_rng(0)
    cur = rng.integers(0, 256, (16, 16), np.uint8)
    wf, scale = _fwd_weights(4, "reference")
    out = np.zeros(4, np.uint8)  # far too small
    with pytest.raises(ValueError):
        encode_frame_pack_native(cur, None, quant.as_float(), wf, scale,
                                 None, zigzag_order(4), 4, True, None, 0,
                                 None, 0, out)
