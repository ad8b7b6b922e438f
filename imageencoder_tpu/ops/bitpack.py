"""Vectorized MSB-first bitstream packing / unpacking.

The reference writes streams one bit at a time through BitStreamWriter::put
(BitStream.cpp:61-77, MSB-first within each field and within each byte).
The data-parallel redesign replaces the serial loop with a two-phase
"measure -> prefix-sum -> scatter" assembler:

  1. every field is a (value, nbits) pair; an exclusive cumsum of nbits
     yields each field's absolute bit offset,
  2. all field bits are scattered into a flat bit vector in parallel
     (loop over bit-within-field, vectorized over fields),
  3. np.packbits folds the bit vector into bytes.

Unpacking mirrors it: np.unpackbits + gathers at (offset + j) for j < nbits.
Both directions are bit-exact against the reference wire format and run at
memory bandwidth in numpy; a Pallas packer covers the on-device path.

Semantics notes (parity-critical):
  * values are truncated to their field width (put() emits low bits only),
  * reading past the end of the buffer yields 0-bits (BitStream.cpp:14-28),
  * trailing padding bits in the final byte are zero (buffers are
    zero-initialized via ``new T[n]()``, utils.hpp:444-446).
"""

from __future__ import annotations

import numpy as np


def pack_fields(values, nbits, pad_to_bytes: int | None = None) -> tuple[bytes, int]:
    """Pack (value, nbits) fields MSB-first into bytes.

    values: int64 array [M] (will be truncated to field width)
    nbits:  int32 array [M]; zero-width fields are skipped.

    Returns (packed bytes, total number of meaningful bits).
    If pad_to_bytes is given the output is zero-padded to that many bytes.
    """
    values = np.asarray(values, dtype=np.int64).ravel()
    nbits = np.asarray(nbits, dtype=np.int64).ravel()
    try:  # native C++ fast path (identical semantics; see runtime/native)
        from ..runtime.native import pack_fields_native

        return pack_fields_native(values, nbits, pad_to_bytes)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("pack_fields", e)
    offsets = np.cumsum(nbits) - nbits
    total_bits = int(offsets[-1] + nbits[-1]) if len(nbits) else 0

    nbytes = (total_bits + 7) // 8
    if pad_to_bytes is not None:
        nbytes = max(nbytes, pad_to_bytes)
    bitbuf = np.zeros(nbytes * 8, dtype=np.uint8)

    max_w = int(nbits.max()) if len(nbits) else 0
    uvals = values.view(np.uint64)
    for j in range(max_w):
        live = nbits > j
        if not live.any():
            continue
        shift = (nbits[live] - 1 - j).astype(np.uint64)
        bit = (uvals[live] >> shift) & 1
        bitbuf[offsets[live] + j] = bit
    return np.packbits(bitbuf).tobytes(), total_bits


def to_bits(data) -> np.ndarray:
    """bytes -> uint8 bit vector (MSB-first per byte)."""
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def concat_bit_segments(segments) -> bytes:
    """Concatenate (bytes, nbits) bit strings at bit granularity.

    Each segment's payload starts at bit 0 of its byte string; the result
    is the MSB-first concatenation of exactly nbits from each.  Used to
    splice independently-encoded GOP/stripe payloads into one stream
    (GOP boundaries are not byte-aligned).
    """
    total_bits = sum(nb for _, nb in segments)
    bitbuf = np.zeros(((total_bits + 7) // 8) * 8, dtype=np.uint8)
    pos = 0
    for data, nb in segments:
        bitbuf[pos:pos + nb] = np.unpackbits(
            np.frombuffer(data, dtype=np.uint8))[:nb]
        pos += nb
    return np.packbits(bitbuf).tobytes()


def read_fields(bits: np.ndarray, offsets, nbits) -> np.ndarray:
    """Gather unsigned field values from a bit vector.

    bits: uint8 [B*8]; offsets: int64 [M]; nbits: int32 [M] (max 32).
    Fields extending past the end read as 0-bits (reference semantics).
    Returns uint32 [M].
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    nbits = np.asarray(nbits, dtype=np.int64)
    out = np.zeros(offsets.shape, dtype=np.uint32)
    max_w = int(nbits.max()) if len(nbits) else 0
    n = len(bits)
    for j in range(max_w):
        live = nbits > j
        pos = offsets[live] + j
        valid = pos < n
        bit = np.zeros(pos.shape, dtype=np.uint32)
        bit[valid] = bits[pos[valid]]
        shift = (nbits[live] - 1 - j).astype(np.uint32)
        out[live] |= bit << shift
    return out


class BitWriter:
    """Small sequential writer for headers / host-side control data.

    Accumulates (value, nbits) fields and defers packing to pack_fields.
    Mirrors util::BitStreamWriter semantics (MSB-first, truncating put).
    """

    def __init__(self) -> None:
        self.values: list[int] = []
        self.nbits: list[int] = []

    def put(self, nbits: int, value: int) -> None:
        self.values.append(int(value))
        self.nbits.append(int(nbits))

    def put_bit(self, bit: int) -> None:
        self.put(1, bit)

    def extend_fields(self, values, nbits) -> None:
        self.values.extend(int(v) for v in np.asarray(values).ravel())
        self.nbits.extend(int(b) for b in np.asarray(nbits).ravel())

    @property
    def position(self) -> int:
        return int(np.sum(self.nbits, dtype=np.int64))

    def getvalue(self) -> bytes:
        data, _ = pack_fields(np.array(self.values, dtype=np.int64),
                              np.array(self.nbits, dtype=np.int64))
        return data


class BitReader:
    """Sequential MSB-first reader (util::BitStreamReader parity).

    Reads past the end return 0 (BitStream.cpp:14-28). Used for headers and
    tests; bulk payload extraction goes through read_fields.
    """

    def __init__(self, data, position: int = 0) -> None:
        self.bits = to_bits(data) if not isinstance(data, np.ndarray) else data
        self.position = position

    def get(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            bit = int(self.bits[self.position]) if self.position < len(self.bits) else 0
            v = (v << 1) | bit
            self.position += 1
        return v

    def get_bit(self) -> int:
        return self.get(1)
