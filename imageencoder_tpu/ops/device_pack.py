"""On-device two-level bitstream packer (the data-parallel replacement for
the reference's serial BitStreamWriter loop, BitStream.cpp:61-77).

The serial writer is a bit-position carry chain; the parallel formulation
splits it in two levels, both data-parallel:

  level 1 (intra-block): each block owns F fields whose widths are known
    (vals/nbits from ops/pipeline.py).  An exclusive per-block cumsum gives
    each field's local bit offset; every field's value is deposited into the
    block's private uint32 register file (ceil(F*16/32) words — fields are
    at most 16 bits) with shifts + one-hot selects.

  level 2 (global): an exclusive cumsum of block bit-lengths gives every
    block's absolute start offset.  Each block's local words are funnel-
    shifted by (start & 31) into one extra word and scatter-added at
    (start >> 5).  Neighbouring blocks share at most a boundary word with
    disjoint bits, so add == or and the scatter needs no ordering.

Everything is exact int32/uint32 arithmetic, and the only host transfer
is the packed words themselves (the whole point: the fields tensor is
~20x larger than the packed stream).

The packed stream starts at bit offset ``start_bit`` (the caller ORs its
host-built header into the zero-prefix afterwards).
"""

from __future__ import annotations

import numpy as np

MAX_FIELD_BITS = 16  # coefficients, counts, mvecs, Huffman codes all fit
HEADER_WORDS = 64  # host header prefix capacity (2048 bits)


def local_words(n_fields: int) -> int:
    """Register-file words per record: worst case every field at 16 bits."""
    return (n_fields * MAX_FIELD_BITS + 31) // 32


def packed_words_bound(n_records: int, n_fields: int) -> int:
    """Static output allocation covering any record content plus header."""
    return n_records * local_words(n_fields) + HEADER_WORDS


def header_to_words(header: bytes) -> np.ndarray:
    """Pad a host-packed header to the fixed uint32[HEADER_WORDS] prefix."""
    assert len(header) <= HEADER_WORDS * 4, len(header)
    buf = np.zeros(HEADER_WORDS * 4, dtype=np.uint8)
    buf[:len(header)] = np.frombuffer(header, dtype=np.uint8)
    return buf.view(">u4").astype(np.uint32)


def _local_words(vals, nbits):
    """Level 1: per-record register files.

    vals/nbits: int32 [N, F] -> (local uint32 [N, lw] — each record's bits
    packed MSB-first from bit 0 of its own word row — and block_bits [N]).
    """
    import jax.numpy as jnp

    n, f = vals.shape
    nb = nbits.astype(jnp.int32)
    u32 = jnp.uint32

    lw = local_words(f)

    local_off = jnp.cumsum(nb, axis=1) - nb  # [N, F] exclusive
    block_bits = jnp.sum(nb, axis=1)  # [N]

    mask = ((jnp.uint32(1) << nb.astype(u32)) - jnp.uint32(1))
    v = vals.astype(u32) & jnp.where(nb > 0, mask, jnp.uint32(0))

    wi = (local_off >> 5).astype(jnp.int32)  # word index, 0..lw-1
    bo = (local_off & 31).astype(jnp.int32)  # bit offset in word
    avail = 32 - bo
    fits = nb <= avail
    # Bits for word wi (aligned so the field's MSB lands at bit `bo`).
    # Both where-branches evaluate, so every shift amount is clamped valid.
    sh1 = jnp.clip(avail - nb, 0, 31).astype(u32)
    sh1r = jnp.clip(nb - avail, 0, 31).astype(u32)
    part1 = jnp.where(fits, v << sh1, v >> sh1r)
    # Spill bits for word wi+1.
    spill = jnp.where(fits, 0, nb - avail).astype(u32)
    part2 = jnp.where(fits, jnp.uint32(0),
                      (v << ((32 - spill) % 32).astype(u32)) & jnp.uint32(0xFFFFFFFF))
    part2 = jnp.where(spill > 0, part2, jnp.uint32(0))
    part1 = jnp.where(nb > 0, part1, jnp.uint32(0))

    # One-hot accumulate into [N, lw].
    lanes = jnp.arange(lw, dtype=jnp.int32)[None, None, :]
    sel1 = (lanes == wi[:, :, None])
    sel2 = (lanes == (wi + 1)[:, :, None])
    local = (jnp.sum(jnp.where(sel1, part1[:, :, None], jnp.uint32(0)),
                     axis=1, dtype=u32)
             | jnp.sum(jnp.where(sel2, part2[:, :, None], jnp.uint32(0)),
                       axis=1, dtype=u32))
    return local, block_bits


def _bit_reverse_perm(n_pow2: int) -> np.ndarray:
    """perm[p] = bit-reversal of p: leaf position p of the merge tree must
    hold record perm[p] so that pair-(i, i+M/2) merging yields records in
    original order (FFT-style reordering)."""
    bits = max(0, n_pow2.bit_length() - 1)
    idx = np.arange(n_pow2, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _merge_levels(buf, lens):
    """Hierarchical bit-buffer concatenation — the scatter-free level 2.

    buf:  uint32 [W, M] — M bit-buffers in COLUMN layout (buffer m's word w
          at buf[w, m]; bits MSB-first), each a bit string of lens[0, m]
          bits starting at bit 0.
    lens: int32 [1, M].

    Repeatedly concatenates buffer pairs (m, m + M/2): B is shifted right
    by len(A) bits — the word-granular part as a data-dependent barrel of
    static sublane shifts selected by per-lane masks, the bit-granular part
    as a funnel shift by a per-lane vector amount.  Every op is a dense
    elementwise shift/where: no scatter, no gather, no dynamic layout.
    This is the serial BitStreamWriter carry chain (BitStream.cpp:61-77)
    reassociated into a log-depth reduction (bit-string concat is
    associative).

    Returns (flat uint32 [W * M], total_bits int32 scalar).
    """
    import jax.numpy as jnp

    u32 = jnp.uint32
    w, m = buf.shape
    while m > 1:
        half = m // 2
        a, b_ = buf[:, :half], buf[:, half:]
        la, lb = lens[:, :half], lens[:, half:]
        x = jnp.concatenate([b_, jnp.zeros_like(b_)], axis=0)  # [2W, half]
        o = la >> 5          # word offset, <= w
        s = (la & 31).astype(u32)
        for bit in range(int(w).bit_length()):
            k = 1 << bit
            sh = jnp.concatenate([jnp.zeros((k, half), u32), x[:-k]], axis=0)
            x = jnp.where(((o >> bit) & 1) == 1, sh, x)
        prev = jnp.concatenate([jnp.zeros((1, half), u32), x[:-1]], axis=0)
        x = jnp.where(s > 0, (x >> s) | (prev << ((32 - s) % 32)), x)
        buf = jnp.concatenate([a, jnp.zeros_like(a)], axis=0) | x
        lens = la + lb
        w, m = 2 * w, half
    return buf[:, 0], lens[0, 0]


def _pack_merge(vals, nbits, start_bit, n_words: int,
                start_words_bound: int = HEADER_WORDS):
    """Dense-layout pack via the merge tree (drop-in for the scatter path).

    start_bit must be < 32 * start_words_bound (callers' header/dict prefix
    capacity).  Returns (words uint32 [n_words], total_bits incl start_bit).
    """
    import jax
    import jax.numpy as jnp

    u32 = jnp.uint32
    n, f = vals.shape
    lw = local_words(f)
    if n == 0:
        return (jnp.zeros((n_words,), u32),
                jnp.asarray(start_bit, jnp.int32))

    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 > n:
        vals = jnp.pad(vals, ((0, n2 - n), (0, 0)))
        nbits = jnp.pad(nbits, ((0, n2 - n), (0, 0)))
    perm = jnp.asarray(_bit_reverse_perm(n2))
    local, block_bits = _local_words(vals[perm], nbits[perm])
    merged, rel_total = _merge_levels(local.T,
                                      block_bits[None, :].astype(jnp.int32))

    # Place the stream at start_bit: word roll + funnel via dynamic slices.
    wtot = merged.shape[0]
    p = start_words_bound + 1
    mp = jnp.concatenate([
        jnp.zeros((p,), u32), merged,
        jnp.zeros((max(0, n_words - wtot),), u32)])
    sb = jnp.asarray(start_bit, jnp.int32)
    o = sb >> 5
    s = (sb & 31).astype(u32)
    w1 = jax.lax.dynamic_slice(mp, (p - o,), (n_words,))
    w0 = jax.lax.dynamic_slice(mp, (p - o - 1,), (n_words,))
    out = jnp.where(s > 0, (w1 >> s) | (w0 << ((32 - s) % 32)), w1)
    return out, sb + rel_total


def pack_blocks_device(vals, nbits, start_bit, n_words: int, starts=None,
                       method: str = "scatter",
                       start_words_bound: int = HEADER_WORDS):
    """Pack per-block fields into a global uint32 word array on device.

    vals:  int32 [N, F] field values (will be truncated to field width)
    nbits: int32 [N, F] field widths, 0 = skip (<= 16)
    start_bit: traced int32 scalar — absolute bit offset of block 0
        (< 32 * start_words_bound on the merge path)
    n_words: static output size (upper bound; tail words stay 0)
    starts: optional int32 [N] absolute bit offset per block; when given,
        blocks land at these positions instead of the dense cumsum layout
        (callers guarantee non-overlap; used for segmented/aligned packing).
    method: "scatter" (two-level funnel + scatter-add, the device path)
        or "merge" (XLA log-depth bit-buffer merge, a scatter-free
        cross-check of the same layout).

    Returns (words uint32 [n_words] MSB-first within each word,
             total_bits int32 scalar incl. start_bit).
    """
    import jax

    if method == "merge":
        assert starts is None, "merge path packs the dense cumsum layout"
        return _pack_merge(vals, nbits, start_bit, n_words, start_words_bound)
    assert method == "scatter", method

    with jax.named_scope("pack"):
        return _pack_scatter(vals, nbits, start_bit, n_words, starts)


def _pack_scatter(vals, nbits, start_bit, n_words: int, starts):
    import jax.numpy as jnp

    n, f = vals.shape
    u32 = jnp.uint32
    lw = local_words(f)
    local, block_bits = _local_words(vals, nbits)

    # Level 2: global funnel shift + scatter.
    if starts is None:
        starts = (jnp.cumsum(block_bits) - block_bits
                  + jnp.asarray(start_bit, jnp.int32))  # [N]
    else:
        starts = starts.astype(jnp.int32)
    total_bits = starts[-1] + block_bits[-1] if n else jnp.asarray(start_bit)

    s = (starts & 31).astype(u32)[:, None]  # [N,1]
    base = (starts >> 5).astype(jnp.int32)  # [N]
    # shifted[k] = (local[k-1] << (32-s)) | (local[k] >> s), local[-1]=0
    ext = jnp.concatenate([local, jnp.zeros((n, 1), u32)], axis=1)
    prev_ext = jnp.concatenate([jnp.zeros((n, 1), u32), local], axis=1)
    lo = jnp.where(s > 0, prev_ext << ((32 - s) % 32).astype(u32), jnp.uint32(0))
    hi = jnp.where(s > 0, ext >> s, ext)
    shifted = lo | hi  # [N, lw+1]

    idx = base[:, None] + jnp.arange(lw + 1, dtype=jnp.int32)[None, :]
    words = jnp.zeros((n_words,), u32).at[idx.reshape(-1)].add(
        shifted.reshape(-1), mode="drop")
    return words, total_bits


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Host-side: big-endian word serialization, trimmed to whole bytes."""
    nbytes = (int(total_bits) + 7) // 8
    nw = (nbytes + 3) // 4
    return np.asarray(words[:nw]).astype(">u4").tobytes()[:nbytes]
