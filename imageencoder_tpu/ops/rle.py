"""Per-block RLE / bit-width statistics, fully vectorized.

The reference builds a linked RLE sequence per block with a head "info"
element (algo.hpp:52-56, Block.cpp:186-232):

  * ``info.data``      — number of zig-zag elements up to and including the
    last nonzero coefficient (0 for an all-zero block),
  * ``info.data_bits`` — max over nonzero coefficients of ``bits_needed``,
    raised to at least ``ffs(info.data)`` (Block.cpp:231).  For all-zero
    blocks ``ffs(0)`` is UB in C++; the shipped binaries emit width 1
    (verified by experiment — see utils/bits.py), so we clamp to >= 1.

On the wire (Block.cpp:372-413) a block is simply:

    [4-bit data_bits][data_bits-bit count, if rle][count coefficients,
     each data_bits wide, zig-zag order, zeros included in-line]

with two reference quirks replicated exactly:
  * non-RLE mode writes all B*B coefficients and NO count field;
  * RLE mode, when the *last* zig-zag coefficient is nonzero
    (count == B*B) and it is preceded by >= 1 zeros, drops that final
    nonzero along with its preceding zero run (Block.cpp:388-390) —
    an intentional(?) lossy corner the decoder zero-fills.

All stats are computed batched over [N, K] zig-zag coefficient tensors with
integer ops only (exact on any device), feeding the prefix-sum bit packer.
"""

from __future__ import annotations

import numpy as np

from ..utils.bits import bits_needed, ffs


def block_stats(coeffs_zz, use_rle: bool):
    """Compute wire-format stats for a batch of blocks.

    coeffs_zz: int array [N, K] of quantized coefficients in zig-zag order.

    Returns dict of int32 arrays, all shape [N]:
      data_bits  — 4-bit field value (coefficient bit width)
      count      — value of the count field (meaningful when rle)
      n_payload  — number of coefficient fields emitted
      total_bits — total bits this block occupies on the wire
    """
    xp = _mod(coeffs_zz)
    n, k = coeffs_zz.shape
    nz = coeffs_zz != 0

    # info.data: 1 + index of last nonzero, 0 if none.
    rev_arg = xp.argmax(nz[:, ::-1].astype(xp.int32), axis=1)
    any_nz = xp.any(nz, axis=1)
    length_full = xp.where(any_nz, k - rev_arg, 0).astype(xp.int32)

    # info.data_bits (before the RLE strip — reference order Block.cpp:186-232).
    per_coeff_bits = xp.where(nz, bits_needed(coeffs_zz), 0)
    max_bits = xp.max(per_coeff_bits, axis=1).astype(xp.int32)
    data_bits = xp.maximum(xp.maximum(max_bits, ffs(length_full)), 1)

    if use_rle:
        # Strip the trailing (zero-run + final nonzero) when the block is
        # "full" and the final nonzero has a preceding zero gap.
        nz_head = nz[:, : k - 1]
        rev_arg_head = xp.argmax(nz_head[:, ::-1].astype(xp.int32), axis=1)
        any_head = xp.any(nz_head, axis=1)
        length_head = xp.where(any_head, (k - 1) - rev_arg_head, 0).astype(xp.int32)
        gap = (k - 1) - length_head  # zeros directly before the last element
        full = length_full == k
        count = xp.where(full & (gap > 0), length_head, length_full)
        n_payload = count
    else:
        count = length_full
        n_payload = xp.full((n,), k, dtype=xp.int32)

    total_bits = 4 + (data_bits if use_rle else 0) + n_payload * data_bits
    return {
        "data_bits": data_bits.astype(xp.int32),
        "count": count.astype(xp.int32),
        "n_payload": xp.asarray(n_payload).astype(xp.int32),
        "total_bits": total_bits.astype(xp.int32),
    }


def block_fields(coeffs_zz, stats, use_rle: bool):
    """Expand blocks into flat (value, nbits) field arrays for the bit packer.

    Layout per block: [width(4b)][count(data_bits) if rle][payload coeffs].
    Returns (values int64 [N, K+2], nbits int32 [N, K+2]); unused slots have
    nbits == 0 and are skipped by the packer.
    """
    xp = _mod(coeffs_zz)
    n, k = coeffs_zz.shape
    data_bits = stats["data_bits"]
    n_payload = stats["n_payload"]

    # int64 on the host packer path; int32 on device (jax x64 is disabled,
    # and every field value fits 16 bits anyway).
    val_dtype = xp.int64 if xp is np else xp.int32
    vals = xp.zeros((n, k + 2), dtype=val_dtype)
    nbits = xp.zeros((n, k + 2), dtype=xp.int32)

    # Slot 0: the 4-bit width header.
    vals = _set(xp, vals, (slice(None), 0), data_bits.astype(val_dtype))
    nbits = _set(xp, nbits, (slice(None), 0), xp.full((n,), 4, dtype=xp.int32))

    # Slot 1: the count field (RLE only).
    if use_rle:
        vals = _set(xp, vals, (slice(None), 1), stats["count"].astype(val_dtype))
        nbits = _set(xp, nbits, (slice(None), 1), data_bits)

    # Slots 2..: the first n_payload zig-zag coefficients, data_bits wide each.
    j = xp.arange(k, dtype=xp.int32)[None, :]
    live = j < n_payload[:, None]
    vals = _set(xp, vals, (slice(None), slice(2, None)),
                xp.where(live, coeffs_zz.astype(val_dtype), 0))
    nbits = _set(xp, nbits, (slice(None), slice(2, None)),
                 xp.where(live, xp.broadcast_to(data_bits[:, None], (n, k)), 0))
    return vals, nbits


def _set(xp, arr, idx, value):
    if xp is np:
        arr[idx] = value
        return arr
    return arr.at[idx].set(value)


def _mod(x):
    if type(x).__module__.split(".")[0] in ("jax", "jaxlib"):
        import jax.numpy as jnp

        return jnp
    return np
