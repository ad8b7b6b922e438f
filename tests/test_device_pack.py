"""On-device bit packer vs the host packer (bit-exact equivalence)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from imageencoder_tpu.ops import bitpack
from imageencoder_tpu.ops.device_pack import pack_blocks_device, words_to_bytes
from imageencoder_tpu.ops.pipeline import (make_encode_fields,
                                           make_encode_packed)


@pytest.mark.parametrize("seed,start", [(0, 0), (1, 37), (2, 171), (3, 8)])
def test_pack_matches_host(seed, start):
    rng = np.random.default_rng(seed)
    n, f = 257, 18
    nbits = rng.integers(0, 17, (n, f)).astype(np.int32)
    vals = rng.integers(-(2 ** 15), 2 ** 15, (n, f)).astype(np.int32)

    fn = jax.jit(pack_blocks_device, static_argnums=(3,))
    words, total = fn(jnp.asarray(vals), jnp.asarray(nbits),
                      jnp.asarray(start, jnp.int32), n * 9 + 4)
    dev = words_to_bytes(words, int(total))

    host, tb = bitpack.pack_fields(
        np.concatenate([[0], vals.ravel()]),
        np.concatenate([[start], nbits.ravel()]))
    assert int(total) == tb
    assert dev == host


def test_full_image_pack_equivalence():
    """Device-packed stream == host-packed stream of the same device fields."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (64, 96), dtype=np.uint8)
    quant = np.full((4, 4), 7.0, dtype=np.float32)

    fields = make_encode_fields(4, True, "reference")
    vals, nbits = fields(img, quant)
    host, tb = bitpack.pack_fields(np.asarray(vals).ravel(),
                                   np.asarray(nbits).ravel())

    from imageencoder_tpu.ops.device_pack import HEADER_WORDS

    packed = make_encode_packed(4, True, "reference")
    words, total = packed(img, quant, np.int32(0),
                          np.zeros(HEADER_WORDS, np.uint32))
    assert int(total) == tb
    assert words_to_bytes(words, int(total)) == host


def test_empty_width_fields_skipped():
    vals = np.array([[3, 0, 5]], dtype=np.int32)
    nbits = np.array([[4, 0, 3]], dtype=np.int32)
    fn = jax.jit(pack_blocks_device, static_argnums=(3,))
    words, total = fn(jnp.asarray(vals), jnp.asarray(nbits),
                      jnp.asarray(0, jnp.int32), 12)
    assert int(total) == 7
    host, _ = bitpack.pack_fields(vals.ravel(), nbits.ravel())
    assert words_to_bytes(words, int(total)) == host


def _merge_vs_scatter(vals, nbits, start):
    # n*9+70 words everywhere: cases of equal [n, f] share compiled ops.
    nw = vals.shape[0] * 9 + 70
    args = (jnp.asarray(vals), jnp.asarray(nbits), jnp.int32(start), nw)
    ws, ts = pack_blocks_device(*args, method="scatter")
    wm, tm = pack_blocks_device(*args, method="merge")
    assert int(ts) == int(tm)
    assert np.array_equal(np.asarray(ws), np.asarray(wm))


@pytest.mark.parametrize("n,f,start", [(1, 3, 0), (2, 5, 7), (257, 18, 171),
                                       (1024, 18, 2047), (777, 16, 0),
                                       (1029, 16, 37), (2051, 18, 169)])
def test_merge_matches_scatter(n, f, start):
    """The log-depth merge packer (a scatter-free cross-check of the
    device path) must be bit-identical to the scatter packer for every
    dense layout, including counts just past a power of two."""
    rng = np.random.default_rng(n * 7 + f)
    nbits = rng.integers(0, 17, (n, f)).astype(np.int32)
    vals = rng.integers(-(2 ** 15), 2 ** 15, (n, f)).astype(np.int32)
    _merge_vs_scatter(vals, nbits, start)


def test_merge_word_aligned_records():
    """Records of exactly 32 bits: every record boundary is a word one."""
    n, f = 1024, 18
    nbits = np.zeros((n, f), dtype=np.int32)
    nbits[:, :2] = 16
    vals = np.arange(n * f, dtype=np.int32).reshape(n, f) & 0xFFFF
    _merge_vs_scatter(vals, nbits, 0)


def test_merge_empty():
    w, t = pack_blocks_device(jnp.zeros((0, 4), jnp.int32),
                              jnp.zeros((0, 4), jnp.int32), jnp.int32(9), 4,
                              method="merge")
    assert int(t) == 9 and np.asarray(w).shape == (4,)


@pytest.mark.parametrize("pattern", ["all_zero", "all_max", "alternating",
                                     "single_field", "first_last"])
def test_merge_edge_patterns(pattern):
    """Adversarial width patterns: all-empty records, all-maximal records
    (bound exactly reached), 0/16 alternation, and content only in the
    first and last records."""
    n, f = 2051, 18
    nbits = np.zeros((n, f), np.int32)
    if pattern == "all_max":
        nbits[:] = 16
    elif pattern == "alternating":
        nbits[:] = np.array([0, 16] * (f // 2), np.int32)
    elif pattern == "single_field":
        nbits[:, 3] = 5
    elif pattern == "first_last":
        nbits[0] = 16
        nbits[-1] = 16
    rng = np.random.default_rng(1)
    vals = rng.integers(-(2 ** 15), 2 ** 15, (n, f)).astype(np.int32)
    _merge_vs_scatter(vals, nbits, 7)


@pytest.mark.parametrize("dense", [False, True])
def test_merge_matches_bitwriter_order(dense):
    """The merge packer equals the BitWriter-order concatenation of the
    fields (bitpack.pack_fields): sparse records, and dense 10-bit ones."""
    rng = np.random.default_rng(5 if dense else 6)
    n, f, start = 1029, 16, 169
    if dense:
        nbits = np.full((n, f), 10, np.int32)
    else:
        nbits = rng.integers(0, 5, (n, f)).astype(np.int32)
    vals = rng.integers(0, 2 ** 9, (n, f)).astype(np.int32)
    exp_vals = np.concatenate([[0], (vals & ((1 << np.maximum(nbits, 1)) - 1))
                               .ravel()]).astype(np.int64)
    exp_bits = np.concatenate([[start], nbits.ravel()]).astype(np.int64)
    exp_bytes, exp_total = bitpack.pack_fields(exp_vals, exp_bits)
    words, total = pack_blocks_device(jnp.asarray(vals), jnp.asarray(nbits),
                                      jnp.int32(start), n * 9 + 70,
                                      method="merge")
    assert int(total) == exp_total
    got = np.asarray(words).astype(">u4").tobytes()[:(exp_total + 7) // 8]
    assert got == exp_bytes


def test_merge_zero_length_records():
    """Records whose every field is width 0 contribute nothing anywhere."""
    vals = np.array([[3, 0], [0, 0], [5, 1]], dtype=np.int32)
    nbits = np.array([[4, 0], [0, 0], [3, 2]], dtype=np.int32)
    ws, ts = pack_blocks_device(jnp.asarray(vals), jnp.asarray(nbits),
                                jnp.int32(5), 8, method="scatter")
    wm, tm = pack_blocks_device(jnp.asarray(vals), jnp.asarray(nbits),
                                jnp.int32(5), 8, method="merge")
    assert int(ts) == int(tm) == 5 + 4 + 5
    assert np.array_equal(np.asarray(ws), np.asarray(wm))
