"""Bit-width helpers defining the wire format.

These replicate the semantics of the reference's bit utilities
(reference: utils.hpp:210-269) as *vectorized* numpy/jax functions:

  * ``bits_needed(v)``  — minimal signed two's-complement width (>= 1) such that
    truncating ``v`` to that many bits and sign-extending recovers ``v``
    (reference: utils.hpp:226-243).
  * ``ffs(v)``          — 32 - clz(v): index of the highest set bit, 1-based
    (reference: utils.hpp:210-216).  ``ffs(0)`` is UB in the reference
    (__builtin_clz(0)); the shipped binaries were observed to produce
    data_bits == 1 for all-zero blocks (flat-128 image experiment), so block
    stats clamp the combined width to >= 1 instead (see ops/rle.py).
  * ``shift_signed(v, b)`` — sign-extend the low ``b`` bits of ``v``
    (reference: utils.hpp:266-269).
  * ``round_to_byte(bits)`` — ceil division to whole bytes (utils.hpp:253-255).
  * ``round_half_away(x)``  — std::round parity for the quantization step
    (reference: Block.cpp:152).

Everything here works on numpy arrays *and* jax arrays, using only integer
compares/adds so results are exact on any device (no float log tricks).
"""

from __future__ import annotations

import numpy as np


def _mod(x):
    """Pick numpy or jax.numpy based on the argument type."""
    if type(x).__module__.split(".")[0] in ("jax", "jaxlib"):
        import jax.numpy as jnp

        return jnp
    return np


def bit_length(x):
    """Number of bits in the binary representation of non-negative ``x``.

    bit_length(0) == 0, bit_length(1) == 1, bit_length(2) == 2, ...
    Vectorized and exact (16 integer compares; valid for 0 <= x < 2**16).
    """
    xp = _mod(x)
    x = xp.asarray(x)
    if xp is np:
        # frexp exponent == bit_length for positive integers (exact for
        # |x| < 2**53); one pass instead of 16 compare passes.
        return np.frexp(x.astype(np.float64))[1].astype(np.int32)
    total = xp.zeros(x.shape, dtype=xp.int32)
    for k in range(16):
        total = total + (x >= (1 << k)).astype(xp.int32)
    return total


def ffs(x):
    """32 - clz(x) for x > 0; returns 0 for x == 0 (reference UB, see module doc)."""
    return bit_length(x)


def bits_needed(v):
    """Minimal signed two's-complement bit width (>= 1) for int16 values ``v``.

    For v >= 0: bit_length(v) + 1 (room for the sign bit).
    For v <  0: bit_length(-v - 1) + 1.
    Matches reference utils.hpp:226-243 exactly (verified exhaustively in tests).
    """
    xp = _mod(v)
    vi = xp.asarray(v).astype(xp.int32)
    mag = xp.where(vi >= 0, vi, -vi - 1)
    return bit_length(mag) + 1


def shift_signed(value, src_bits):
    """Sign-extend the low ``src_bits`` bits of ``value`` to int32.

    src_bits == 0 yields 0 (reading 0 bits yields value 0).
    Matches reference utils.hpp:266-269 (<<(bits-b) then arithmetic >>).
    """
    xp = _mod(value)
    v64 = xp.asarray(value).astype(xp.int64)
    b = xp.asarray(src_bits).astype(xp.int64)
    one = xp.asarray(1, dtype=xp.int64)
    v = v64 & ((one << b) - 1)
    sign_bit = xp.where(b > 0, one << xp.maximum(b - 1, 0), xp.zeros_like(b))
    out = xp.where((v & sign_bit) != 0, v - (sign_bit << 1), v)
    return out.astype(xp.int32)


def round_to_byte(bits: int) -> int:
    """Round a bit count up to whole bytes (reference utils.hpp:253-255)."""
    return (int(bits) + 7) // 8


def round_half_away(x):
    """std::round semantics: round half away from zero (reference Block.cpp:152).

    jnp.round / np.round use banker's rounding — this is the parity-critical
    replacement used at the quantization step.  Implemented via trunc (exact:
    x - trunc(x) is representable), NOT floor(|x| + 0.5), which double-rounds
    for values like 0.49999999999999994.
    """
    xp = _mod(x)
    x = xp.asarray(x)
    t = xp.trunc(x)
    inc = xp.where(xp.abs(x - t) >= 0.5,
                   xp.where(x >= 0, 1, -1), 0).astype(x.dtype)
    return t + inc
