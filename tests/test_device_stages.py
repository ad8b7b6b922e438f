"""Device encode stages in their plain XLA forms vs independent references:
the stream byte histogram vs np.bincount, and the f32 transform + quantize
vs the exact float64 path (ops/dct.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from imageencoder_tpu.ops.blockify import blockify
from imageencoder_tpu.ops.dct import dct_matrix, forward_transform_quantize_zz
from imageencoder_tpu.ops.pipeline import (stream_byte_histogram,
                                           transform_quantize)
from imageencoder_tpu.ops.zigzag import zigzag_order


@pytest.mark.parametrize("seed,nwords,tail", [(0, 10000, 3), (1, 4096, 0),
                                              (2, 100, 1)])
def test_byte_histogram(seed, nwords, tail):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2 ** 32, nwords, dtype=np.uint64).astype(np.uint32)
    nbytes = nwords * 4 - tail
    meta = np.asarray(stream_byte_histogram(jnp.asarray(words),
                                            jnp.int32(nbytes * 8)))
    data = words.astype(">u4").tobytes()[:nbytes]
    expect = np.bincount(np.frombuffer(data, np.uint8), minlength=256)
    assert meta[0] == nbytes * 8
    np.testing.assert_array_equal(meta[1:], expect)


@pytest.mark.parametrize("shape", [(64, 128), (68, 132), (32, 128),
                                   (912, 256)])
def test_quantize_image_matches_exact(shape):
    """f32 at HIGHEST vs the exact f64 order: coefficients may differ only
    where y/q sits within f32 rounding of a .5 tie, so every difference is
    +-1 and they are rare."""
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    quant = np.asarray([[2, 4, 6, 8], [4, 4, 6, 8], [6, 6, 6, 8],
                        [8, 8, 8, 8]], np.float32)
    dm = jnp.asarray(np.asarray(dct_matrix(4, "reference"), np.float32))

    got = np.asarray(transform_quantize(jnp.asarray(img), jnp.asarray(quant),
                                        dm, 4))
    want = forward_transform_quantize_zz(blockify(img, 4),
                                         quant.astype(np.float64),
                                         "reference", zigzag_order(4))
    diff = np.abs(got.astype(np.int64) - np.asarray(want, np.int64))
    assert diff.max() <= 1
    assert (diff != 0).mean() <= 5e-3
