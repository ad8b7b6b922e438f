"""Tests that need an NVIDIA GPU: the compiled Pallas kernels against their
plain references.  They skip without a card; on one, run
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageencoder_tpu.ops.sad_maps import sad_maps_scan, sad_maps_triton

QUANT4 = Path(__file__).parent / "fixtures" / "quant4.txt"


@pytest.mark.gpu
@pytest.mark.parametrize("f,h,w,halo", [(2, 720, 1280, 0), (1, 64, 2176, 0),
                                        (2, 352, 1280, 16)])
def test_sad_kernel_compiled_matches_scan(gpu, f, h, w, halo):
    rng = np.random.default_rng(h + w)
    cur = jnp.asarray(rng.integers(0, 256, (f, h, w), dtype=np.uint8))
    ref = jnp.asarray(rng.integers(0, 256, (f, h + 2 * halo, w),
                                   dtype=np.uint8))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(sad_maps_triton, static_argnums=(2, 3))(
            cur, ref, 16, halo)),
        np.asarray(jax.jit(sad_maps_scan, static_argnums=(2, 3))(
            cur, ref, 16, halo)))


@pytest.mark.gpu
@pytest.mark.parametrize("ref_mode", ["raw", "recon"])
def test_sharded_video_kernel_on_one_card(gpu, ref_mode):
    """The sharded video step runs the SAD kernel inside shard_map; on a
    1x1 mesh its stream equals the single-device encode."""
    from imageencoder_tpu.models.video import encode_video, split_yuv420
    from imageencoder_tpu.parallel import encode_video_sharded, make_mesh
    from imageencoder_tpu.utils.quant import QuantMatrix
    from imageencoder_tpu.utils.synth import seeded_video

    quant = QuantMatrix.from_file(QUANT4)
    w, h, n = 640, 352, 8
    data, _ = seeded_video(np.random.default_rng(5), w, h, n)
    got = encode_video_sharded(split_yuv420(data, w, h), quant, make_mesh(1),
                               True, 4, 16, ref_mode=ref_mode)
    want = encode_video(data, w, h, quant, True, 4, 16, backend="jax",
                        ref_mode=ref_mode)
    assert got == want
