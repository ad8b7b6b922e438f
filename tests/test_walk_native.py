"""Native offset walk (runtime.cpp walk_offsets) vs a reference bit walk.

The round-3 walk reads each record header with one unaligned 64-bit load
and falls back to a safe bit reader near the buffer end; these tests pin
the fast-path/safe-path boundary and past-the-end semantics (reads past
the end return 0 bits, reference BitStream.cpp:14-28).
"""

import numpy as np
import pytest

from imageencoder_tpu.runtime.native import walk_offsets_native
from tests.oracle import QUANT4


def _ref_walk(packed: bytes, start_bit: int, n_blocks: int, use_rle: bool,
              block_size: int):
    bits = np.unpackbits(np.frombuffer(packed, np.uint8))
    nbits = len(bits)
    k = block_size * block_size

    def get(pos, n):
        v = 0
        for i in range(n):
            b = int(bits[pos + i]) if pos + i < nbits else 0
            v = (v << 1) | b
        return v

    offs, dbits, counts = [], [], []
    pos = start_bit
    for _ in range(n_blocks):
        b = get(pos, 4)
        pos += 4
        count = k
        if use_rle:
            count = get(pos, b)
            pos += b
        offs.append(pos)
        dbits.append(b)
        counts.append(count)
        pos += b * count
    return (np.array(offs, np.int64), np.array(dbits, np.int32),
            np.array(counts, np.int32), pos)


@pytest.mark.parametrize("use_rle", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_walk_matches_reference_bit_walk(use_rle, seed):
    rng = np.random.default_rng(seed)
    # Random bytes ARE a valid record stream under this grammar (any 4-bit
    # width / any count parses); lengths chosen to land the last records
    # inside the <=9-byte safe-path tail.
    n_blocks = int(rng.integers(5, 40))
    packed = rng.integers(0, 256, int(rng.integers(16, 160)),
                          np.uint8).tobytes()
    start_bit = int(rng.integers(0, 16))
    ref = _ref_walk(packed, start_bit, n_blocks, use_rle, 4)
    got = walk_offsets_native(None, start_bit, n_blocks, use_rle, 4,
                              packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


@pytest.mark.parametrize("use_rle", [True, False])
def test_walk_overrun_reads_zero_bits(use_rle):
    # A width-15 record whose payload claims far more bits than the buffer
    # holds: the walk must advance past the end reading 0 bits, exactly
    # like the reference's BitStreamReader.
    packed = bytes([0xFF, 0xFF, 0xFF, 0xFF])
    ref = _ref_walk(packed, 0, 6, use_rle, 4)
    got = walk_offsets_native(None, 0, 6, use_rle, 4, packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


def test_walk_block8():
    rng = np.random.default_rng(9)
    packed = rng.integers(0, 256, 400, np.uint8).tobytes()
    ref = _ref_walk(packed, 3, 12, True, 8)
    got = walk_offsets_native(None, 3, 12, True, 8, packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


# ---- speculative chunk-parallel walk (round 5) ----
#
# walk_offsets parallelizes past 32768 records: chunk walkers start at
# chunk boundaries (in general mid-record) and the serial stitch adopts a
# walker's records from the first position that coincides with a true
# record start.  These tests force that path and its fallbacks.

@pytest.mark.parametrize("use_rle", [True, False])
@pytest.mark.parametrize("start_bit", [0, 13])
def test_walk_speculative_matches_reference(use_rle, start_bit):
    rng = np.random.default_rng(42)
    # Large random stream: >= 32768 records engages the speculative path.
    packed = rng.integers(0, 256, 4_000_000, np.uint8).tobytes()
    n_blocks = 50_000
    ref = _ref_walk(packed, start_bit, n_blocks, use_rle, 4)
    got = walk_offsets_native(None, start_bit, n_blocks, use_rle, 4,
                              packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


def test_walk_speculative_record_budget_overflow():
    # Adversarial skew: 40k giant records then 40k minimal 4-bit records.
    # The tiny records all land in one or two bit-chunks, overflowing the
    # per-chunk record budget — those chunks must fall back to the serial
    # stitch and still come out bit-exact.
    from imageencoder_tpu.ops.bitpack import pack_fields

    vals, nbits = [], []
    for _ in range(40_000):
        vals += [15, 16] + [0x5555] * 16
        nbits += [4, 15] + [15] * 16
    vals += [0] * 40_000
    nbits += [4] * 40_000
    packed, total = pack_fields(np.array(vals, np.int64),
                                np.array(nbits, np.int64))
    ref = _ref_walk(packed, 0, 80_000, True, 4)
    got = walk_offsets_native(None, 0, 80_000, True, 4, packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


def test_walk_speculative_truncated_stream():
    # n_blocks far beyond the buffer: the walk must run past the end
    # reading 0 bits for the tail records, exactly like the serial path.
    rng = np.random.default_rng(7)
    packed = rng.integers(0, 256, 300_000, np.uint8).tobytes()
    n_blocks = 60_000
    ref = _ref_walk(packed, 5, n_blocks, True, 4)
    got = walk_offsets_native(None, 5, n_blocks, True, 4, packed=packed)
    for r, g in zip(ref[:3], got[:3]):
        assert np.array_equal(r, g)
    assert ref[3] == got[3]


def test_walk_speculative_natural_stream():
    # A real encoded payload (not random bytes) above the speculative
    # threshold: natural record-size distribution, arbitrary start phase.
    from imageencoder_tpu.models.image import encode_image, read_image_header
    from imageencoder_tpu.ops.bitpack import BitReader
    from imageencoder_tpu.utils.quant import QuantMatrix

    rng = np.random.default_rng(3)
    img = np.clip(
        np.kron(rng.integers(0, 256, (75, 128)), np.ones((8, 8)))
        + rng.normal(0, 6, (600, 1024)), 0, 255).astype(np.uint8)
    quant = QuantMatrix.from_file(QUANT4)
    enc = encode_image(img, quant, use_rle=True, use_huffman=False,
                       backend="numpy")
    r = BitReader(enc[:65536], position=1)
    _, use_rle, w, h = read_image_header(r, 4)
    n_blocks = (w // 4) * (h // 4)
    assert n_blocks >= 32768  # speculative path engaged
    ref = _ref_walk(enc, r.position, n_blocks, use_rle, 4)
    got = walk_offsets_native(None, r.position, n_blocks, use_rle, 4,
                              packed=enc)
    for a, g in zip(ref[:3], got[:3]):
        assert np.array_equal(a, g)
    assert ref[3] == got[3]
