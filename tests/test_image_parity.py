"""End-to-end image codec parity against the shipped reference binaries.

The parity contract (SURVEY §2 quirks, BASELINE.md):
  * our encoder's streams decode bit-exactly on the reference decoder,
  * our decoder reproduces the reference decoder's pixels bit-exactly on
    reference-encoded streams,
  * when the reference's Huffman pass falls back to raw (noise images), the
    whole FILE is byte-identical (the inner stream has no nondeterminism),
  * when Huffman engages, sizes match within dict-serialization noise.
"""

import numpy as np
import pytest

from imageencoder_tpu.models.image import decode_image, encode_image
from imageencoder_tpu.utils.metrics import psnr
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.oracle import FIXTURES, QUANT4, ReferenceCodec, fixture_image

QUANTFILE = QUANT4


def assert_fallback_byte_exact(ours: bytes, ref: bytes):
    """Byte-exact comparison for Huffman-fallback streams, excluding the
    final byte's 7 padding bits: the reference writes 1+8n bits into an
    n-byte buffer (Huffman.cpp:332-340), so the last 7 bits of its final
    byte are out-of-bounds heap garbage (UB).  We emit zeros there; every
    meaningful bit must match."""
    assert len(ours) == len(ref)
    assert ours[:-1] == ref[:-1]
    assert (ours[-1] >> 7) == (ref[-1] >> 7)


@pytest.fixture(scope="module")
def ref():
    return ReferenceCodec()


@pytest.fixture(scope="module")
def quant():
    return QuantMatrix.from_file(QUANTFILE)


def _noise_image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w)).astype(np.uint8)


@pytest.mark.parametrize("use_rle", [True, False])
def test_noise_image_byte_exact_vs_reference(ref, quant, use_rle):
    """Huffman can't compress noise -> reference falls back to [0][raw];
    the full file must then match our encoder byte-for-byte."""
    img = _noise_image(64, 64, seed=42)
    ref_enc = ref.encode_image(img, QUANTFILE, use_rle, name=f"noise_rle{use_rle}")
    our_enc = encode_image(img, quant, use_rle, use_huffman=True)
    assert ref_enc[0] & 0x80 == 0, "expected Huffman fallback on noise"
    assert_fallback_byte_exact(our_enc, ref_enc)


@pytest.mark.parametrize("use_rle", [True, False])
def test_our_stream_decodes_on_reference_decoder(ref, quant, use_rle):
    img = fixture_image("ex6")
    our_enc = encode_image(img, quant, use_rle, use_huffman=True)
    ref_px = ref.decode_image(our_enc, img.shape[1], img.shape[0], QUANTFILE,
                              use_rle, name=f"ours_rle{use_rle}")
    our_px = decode_image(our_enc)
    assert np.array_equal(ref_px, our_px)


def test_reference_stream_decodes_bit_exact(ref, quant):
    """Round-trip the reference's own encoder output through both decoders."""
    img = fixture_image("ex6")
    ref_enc = ref.encode_image(img, QUANTFILE, True, name="ex6")
    ref_px = ref.decode_image(ref_enc, img.shape[1], img.shape[0], QUANTFILE,
                              name="ex6")
    our_px = decode_image(ref_enc)
    assert np.array_equal(our_px, ref_px)


def test_fixture_ex6_size_and_psnr(ref, quant):
    """BASELINE.md measured: ex6 -> 34,191 B (26.1%), PSNR 43.69 dB."""
    img = fixture_image("ex6")
    our_enc = encode_image(img, quant, True, use_huffman=True)
    ref_enc = ref.encode_image(img, QUANTFILE, True, name="ex6b")
    # Huffman dict serialization differs (we are deterministic, the
    # reference is unordered_map-ordered); sizes must agree within noise.
    assert abs(len(our_enc) - len(ref_enc)) <= 64, (len(our_enc), len(ref_enc))
    our_px = decode_image(our_enc)
    p = psnr(our_px, img)
    assert p >= 43.6, p


def test_flat_image_all_zero_blocks(ref, quant):
    """Pins the ffs(0) UB resolution: all-zero blocks emit width=1, len=0."""
    img = np.full((16, 16), 128, np.uint8)
    ref_enc = ref.encode_image(img, QUANTFILE, True, name="flat")
    our_enc = encode_image(img, quant, True, use_huffman=True)
    assert_fallback_byte_exact(our_enc, ref_enc)
    assert np.array_equal(decode_image(our_enc), img)


def test_gradient_image_huffman_roundtrip(ref, quant):
    """Smooth image -> Huffman engages; cross-decode both directions."""
    y, x = np.mgrid[0:64, 0:64]
    img = ((x + y) * 2).astype(np.uint8)
    our_enc = encode_image(img, quant, True, use_huffman=True)
    assert our_enc[0] & 0x80, "expected Huffman to engage on smooth image"
    ref_px = ref.decode_image(our_enc, 64, 64, QUANTFILE, name="grad")
    our_px = decode_image(our_enc)
    assert np.array_equal(ref_px, our_px)

    ref_enc = ref.encode_image(img, QUANTFILE, True, name="grad")
    assert np.array_equal(decode_image(ref_enc),
                          ref.decode_image(ref_enc, 64, 64, QUANTFILE, name="grad"))


def test_no_huffman_stream_roundtrip(quant):
    img = _noise_image(32, 48, seed=1)
    enc = encode_image(img, quant, True, use_huffman=False)
    dec = decode_image(enc)
    # noise under heavy quantization is lossy; but stream must parse fully
    assert dec.shape == img.shape


@pytest.mark.parametrize("name", ["ex0", "ex6", "ex2", "ex3", "ex1", "ex4"])
def test_fixture_cross_parity(ref, quant, name):
    """Full pipeline on real fixtures: our encode -> reference decode equals
    reference encode -> reference decode (coefficient-level parity)."""
    img = fixture_image(name)
    h, w = img.shape
    ref_enc = ref.encode_image(img, QUANTFILE, True, name=name)
    ref_px = ref.decode_image(ref_enc, w, h, QUANTFILE, name=name)

    our_enc = encode_image(img, quant, True, use_huffman=True)
    our_px_via_ref = ref.decode_image(our_enc, w, h, QUANTFILE, name=name + "x")
    assert np.array_equal(our_px_via_ref, ref_px), \
        "our stream decoded differently -> coefficient mismatch"
    assert np.array_equal(decode_image(our_enc), ref_px)
    assert np.array_equal(decode_image(ref_enc), ref_px)


BASELINE_PSNR = {  # measured with the shipped binaries (BASELINE.md)
    "ex0": 24.02, "ex1": 35.94, "ex2": 44.10, "ex3": 42.34,
    "ex4": 39.62, "ex6": 43.69,
}


@pytest.mark.parametrize("name", sorted(BASELINE_PSNR))
def test_fixture_psnr_matches_baseline_table(quant, name):
    """Full round trip reproduces the measured reference PSNR to 0.01 dB
    (bit-parity makes them identical; the tolerance covers table rounding)."""
    from imageencoder_tpu.utils.metrics import psnr

    img = fixture_image(name)
    enc = encode_image(img, quant, True, use_huffman=True)
    dec = decode_image(enc)
    assert abs(psnr(img, dec) - BASELINE_PSNR[name]) < 0.01, name


def test_alternate_quant_matrix_cross_parity(ref):
    """matrix4_2.txt (different value range -> different 5-bit width)."""
    qf = str(FIXTURES / "matrix4_2.txt")
    quant2 = QuantMatrix.from_file(qf)
    img = fixture_image("ex6")
    ref_enc = ref.encode_image(img, qf, True, name="q2ex6")
    ref_px = ref.decode_image(ref_enc, img.shape[1], img.shape[0], qf,
                              name="q2ex6")
    our_enc = encode_image(img, quant2, True, use_huffman=True)
    assert np.array_equal(
        ref.decode_image(our_enc, img.shape[1], img.shape[0], qf,
                         name="q2ex6x"), ref_px)
    assert np.array_equal(decode_image(our_enc), ref_px)


@pytest.mark.parametrize("backend", ["jax", "fast"])
def test_device_and_fast_streams_decode_on_reference_decoder(ref, quant,
                                                             backend):
    """Streams produced by the f32 device pipeline (Pallas packer) and the
    fast host path must decode on the shipped REFERENCE binary: the
    lossless stages are bit-exact by construction, and only quantized
    coefficients may differ (+-1 rounding-tie class)."""
    img = fixture_image("ex6")
    our_enc = encode_image(img, quant, True, use_huffman=True,
                           backend=backend)
    ref_px = ref.decode_image(our_enc, img.shape[1], img.shape[0], QUANTFILE,
                              True, name=f"ours_{backend}")
    our_px = decode_image(our_enc, backend="numpy")
    assert np.array_equal(ref_px, our_px)
