"""DCT matmul formulation vs a literal transcription of the reference's
naive O(n^4) float64 loops (algo.cpp:309-363)."""

import numpy as np

from imageencoder_tpu.ops.dct import (clamp_to_u8, dct2, dct_matrix,
                                      forward_transform, idct2,
                                      inverse_transform)
from imageencoder_tpu.utils.quant import QuantMatrix
from tests.oracle import QUANT4


def naive_dct(block: np.ndarray) -> np.ndarray:
    """Reference algo.cpp:309-331 semantics (C hard-coded for size 4)."""
    n = block.shape[0]
    factor = np.pi / 2.0 / n

    def c(i):
        return 0.5 if i == 0 else np.sqrt(0.5)

    out = np.zeros((n, n))
    for u in range(n):
        for v in range(n):
            s = 0.0
            for i in range(n):
                for j in range(n):
                    s += (np.cos((2 * i + 1) * u * factor)
                          * np.cos((2 * j + 1) * v * factor) * block[i, j])
            out[u, v] = s * c(u) * c(v)
    return out


def naive_idct(coeff: np.ndarray) -> np.ndarray:
    n = coeff.shape[0]
    factor = np.pi / 2.0 / n

    def c(i):
        return 0.5 if i == 0 else np.sqrt(0.5)

    out = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            s = 0.0
            for u in range(n):
                for v in range(n):
                    s += (c(u) * c(v) * np.cos((2 * i + 1) * u * factor)
                          * np.cos((2 * j + 1) * v * factor) * coeff[u, v])
            out[i, j] = s
    return out


def test_dct_matches_naive_reference():
    rng = np.random.default_rng(1)
    blocks = rng.integers(-128, 128, size=(8, 4, 4)).astype(np.float64)
    ours = dct2(blocks)
    for i in range(8):
        np.testing.assert_allclose(ours[i], naive_dct(blocks[i]),
                                   rtol=0, atol=1e-10)


def test_idct_matches_naive_reference():
    rng = np.random.default_rng(2)
    coeffs = rng.integers(-300, 300, size=(8, 4, 4)).astype(np.float64)
    ours = idct2(coeffs)
    for i in range(8):
        np.testing.assert_allclose(ours[i], naive_idct(coeffs[i]),
                                   rtol=0, atol=1e-10)


def test_roundtrip_orthonormal_4():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, 4, 4))
    np.testing.assert_allclose(idct2(dct2(x)), x, atol=1e-12)


def test_ortho_mode_roundtrip_8():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 8, 8))
    np.testing.assert_allclose(idct2(dct2(x, "ortho"), "ortho"), x, atol=1e-12)
    # and vs scipy oracle
    import scipy.fft

    expect = scipy.fft.dctn(x, axes=(1, 2), norm="ortho")
    np.testing.assert_allclose(dct2(x, "ortho"), expect, atol=1e-12)


def test_forward_inverse_transform_quantized():
    rng = np.random.default_rng(5)
    quant = QuantMatrix(np.array([[2, 4, 8, 16], [4, 4, 8, 16],
                                  [8, 8, 32, 64], [16, 32, 64, 128]]))
    px = rng.integers(0, 256, size=(32, 4, 4)).astype(np.uint8)
    coeffs = forward_transform(px, quant.as_float())
    assert coeffs.dtype == np.int32
    recon = clamp_to_u8(inverse_transform(coeffs, quant.as_float()))
    assert recon.shape == px.shape
    # reconstruction error bounded by quantization step
    assert np.abs(recon.astype(int) - px.astype(int)).mean() < 40


def test_jax_f32_close_to_f64_on_u8_blocks():
    """The fast f32 path may resolve exact rounding ties differently from the
    reference's noisy f64 accumulation (see ops/dct.py docstring): deviations
    must be rare (<0.5%) and never exceed one quantization level."""
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    quant = QuantMatrix(np.array([[2, 4, 8, 16], [4, 4, 8, 16],
                                  [8, 8, 32, 64], [16, 32, 64, 128]]))
    px = rng.integers(0, 256, size=(4096, 4, 4)).astype(np.uint8)
    exact = forward_transform(px, quant.as_float())
    fast = np.asarray(forward_transform(jnp.asarray(px),
                                        quant.as_float(np.float32),
                                        dtype=jnp.float32))
    diff = np.abs(exact - fast)
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.005


def test_reference_norm_is_orthonormal_only_at_4():
    d4 = dct_matrix(4, "reference")
    np.testing.assert_allclose(d4 @ d4.T, np.eye(4), atol=1e-12)
    d8 = dct_matrix(8, "reference")
    assert not np.allclose(d8 @ d8.T, np.eye(8))
    d8o = dct_matrix(8, "ortho")
    np.testing.assert_allclose(d8o @ d8o.T, np.eye(8), atol=1e-12)


def test_fast_transforms_match_f32_semantics():
    """The host 'fast' BLAS paths agree with the f64 parity path everywhere
    except +-1 rounding ties, and round-trip through the wire format."""
    import numpy as np

    from imageencoder_tpu.ops.dct import (forward_transform,
                                          forward_transform_fast,
                                          inverse_transform,
                                          inverse_transform_fast)

    rng = np.random.default_rng(11)
    blocks = rng.integers(0, 256, (500, 4, 4)).astype(np.uint8)
    quant = np.full((4, 4), 7.0)
    cf = forward_transform_fast(blocks, quant.astype(np.float32))
    ce = forward_transform(blocks, quant)
    assert np.abs(cf - ce).max() <= 1
    assert (cf != ce).mean() < 0.01

    xf = inverse_transform_fast(ce, quant.astype(np.float32))
    xe = inverse_transform(ce, quant)
    assert np.abs(xf - xe).max() < 0.51


def test_decode_image_fast_backend():
    import numpy as np

    from imageencoder_tpu.models.image import decode_image, encode_image
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(4)
    img = np.kron(rng.integers(0, 256, (16, 16)),
                  np.ones((4, 4))).astype(np.uint8)
    quant = QuantMatrix.from_file(QUANT4)
    enc = encode_image(img, quant, use_rle=True, use_huffman=True)
    d_parity = decode_image(enc, backend="numpy")
    d_fast = decode_image(enc, backend="fast")
    from imageencoder_tpu.runtime.native import available
    if available():
        # "fast" aliases the exact engine since the AVX-512 f64 kernel
        # made it the fastest path too: exact equality.
        np.testing.assert_array_equal(d_parity, d_fast)
    else:
        diff = np.abs(d_parity.astype(int) - d_fast.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01

    # fast-backend encode round-trips too
    enc_f = encode_image(img, quant, use_rle=True, use_huffman=True,
                         backend="fast")
    d2 = decode_image(enc_f, backend="fast")
    assert d2.shape == img.shape
