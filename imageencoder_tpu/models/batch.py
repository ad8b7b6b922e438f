"""Batched multi-image encoding — the production serving path.

Encoding one image is latency-bound (host<->device round trips); serving
encodes many.  This path runs transform + stats + bit packing for a WHOLE
BATCH of same-shape images in one jit dispatch:

    imgs [B,H,W] u8 -> per-image records -> one segmented pack where every
    image's stream region starts word-aligned -> host splits the word
    buffer per image, ORs in the (shared-shape) header, and entropy-codes
    each stream (threaded across images; the serial Huffman dict build is
    256 symbols, and the C++ packer releases the GIL).

The per-image streams are byte-identical to single-image encodes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np

from ..ops.bitpack import BitWriter
from ..ops.device_pack import pack_blocks_device, packed_words_bound
from ..ops.pipeline import fields_from_coeffs, transform_quantize
from ..ops.dct import dct_matrix
from ..utils.quant import QuantMatrix
from .headers import write_image_header
from .image import BLOCK_SIZE

GAP_RECORDS = 2  # zero pseudo-records that hold each image's header


def header_hole_bits(block_size: int) -> int:
    """Largest header the batch pack can hold: GAP_RECORDS records of
    B*B+2 fields, each split16 field at most 16 bits wide."""
    return GAP_RECORDS * (block_size * block_size + 2) * 16


@lru_cache(maxsize=None)
def _make_batch_encode(block_size: int, use_rle: bool, norm: str):
    import jax
    import jax.numpy as jnp

    dct_m = np.asarray(dct_matrix(block_size, norm), dtype=np.float32)

    @jax.jit
    def batch_encode(imgs, quant, hdr_bits):
        bsz, h, w = imgs.shape
        n = (h // block_size) * (w // block_size)
        k = block_size * block_size

        def one(img):
            czz = transform_quantize(img, quant, jnp.asarray(dct_m),
                                     block_size)
            return fields_from_coeffs(czz, use_rle)

        vals, nbits = jax.vmap(one)(imgs)  # [B, N, K+2]

        # Segmented pack expressed in the DENSE record layout (one plain
        # cumsum pack for the whole batch): per image, a zero-valued GAP
        # record of hdr_bits leads the region (the host ORs the shared
        # header bytes into it) and a zero-valued PAD record tail-aligns
        # the region to a word boundary.  Pseudo-record widths are split
        # into <=16-bit fields (the packer's field-width contract).
        f = k + 2
        rec_bits = jnp.sum(nbits, axis=(1, 2))  # [B]
        seg_bits = rec_bits + hdr_bits
        seg_words = (seg_bits + 31) // 32
        seg_word_start = jnp.cumsum(seg_words) - seg_words  # [B] exclusive

        def split16(total, nf):
            # total bits -> [B, nf] widths of <=16 each (sum == total)
            rem = total[:, None] - 16 * jnp.arange(nf)[None, :]
            return jnp.clip(rem, 0, 16).astype(jnp.int32)

        gap_n = split16(jnp.full((bsz,), hdr_bits),
                        GAP_RECORDS * f).reshape(bsz, GAP_RECORDS, f)
        pad_bits = seg_words * 32 - seg_bits  # <= 31 bits, 1 record
        pad_n = split16(pad_bits, f)[:, None, :]
        zero2 = jnp.zeros((bsz, GAP_RECORDS, f), jnp.int32)
        zero1 = jnp.zeros((bsz, 1, f), jnp.int32)

        flat_vals = jnp.concatenate(
            [zero2, vals, zero1], axis=1).reshape(-1, f)
        flat_nbits = jnp.concatenate(
            [gap_n, nbits, pad_n], axis=1).reshape(-1, f)
        n_words = int(bsz) * packed_words_bound(n + GAP_RECORDS + 1, f)
        words, _ = pack_blocks_device(flat_vals, flat_nbits, jnp.int32(0),
                                      n_words)
        return words, seg_word_start, seg_bits

    return batch_encode


def encode_image_batch(imgs, quant: QuantMatrix, use_rle: bool = True,
                       use_huffman: bool = True, norm: str = "reference",
                       block_size: int = BLOCK_SIZE,
                       max_workers: int = 8) -> list[bytes]:
    """Encode a batch of same-shape images. Returns one stream per image,
    byte-identical to per-image `encode_image(..., backend="jax")`."""
    import jax.numpy as jnp

    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    bsz, h, w = imgs.shape
    assert h % block_size == 0 and w % block_size == 0

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, w, h)
    header = writer.getvalue()
    hdr_bits = writer.position

    # The header hole is GAP_RECORDS zero pseudo-records of B*B+2 fields
    # of <= 16 bits each; every legal header fits (an image header is
    # bounded by 37 + B*B*16 bits), but check rather than assume — a bare
    # assert would vanish under `python -O` and silently truncate headers.
    hdr_cap = header_hole_bits(block_size)
    if hdr_bits > hdr_cap:
        raise ValueError(
            f"image header of {hdr_bits} bits exceeds the batch packer's "
            f"{hdr_cap}-bit header hole (block_size={block_size})")

    fn = _make_batch_encode(block_size, use_rle, norm)
    words, seg_word_start, seg_bits = fn(
        jnp.asarray(imgs), jnp.asarray(quant.as_float(np.float32)),
        np.int32(hdr_bits))
    words = np.asarray(words)
    seg_word_start = np.asarray(seg_word_start)
    seg_bits = np.asarray(seg_bits)

    def finish(s):
        nbytes = (int(seg_bits[s]) + 7) // 8
        nw = (nbytes + 3) // 4
        w0 = int(seg_word_start[s])
        inner = bytearray(words[w0:w0 + nw].astype(">u4").tobytes()[:nbytes])
        for i, b in enumerate(header):
            inner[i] |= b
        inner = bytes(inner)
        if use_huffman:
            from ..ops.huffman import huffman_encode

            return huffman_encode(inner)
        return inner

    if bsz == 1:
        return [finish(0)]
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(finish, range(bsz)))


def encode_image_stream(imgs, quant: QuantMatrix, use_rle: bool = True,
                        use_huffman: bool = True, norm: str = "reference",
                        block_size: int = BLOCK_SIZE, depth: int = 2):
    """Pipelined streaming encode: yields one wire stream per input image.

    JAX dispatch is asynchronous, so keeping ``depth`` encodes in flight
    overlaps image i+1's H2D + device compute with image i's host Huffman
    build and D2H — the sustained-throughput serving mode (a stream is
    bounded by max(device, host) stage time).  Streams are byte-identical
    to per-image encode_image(backend="jax").
    """
    import jax.numpy as jnp

    from ..ops.device_pack import HEADER_WORDS, header_to_words
    from ..ops.huffman import huffman_encode_from_meta
    from ..ops.pipeline import make_encode_packed, make_encode_packed_hist
    from ..ops.device_pack import words_to_bytes

    writer = None
    pending: list = []

    def finish(item):
        if use_huffman:
            words, meta = item
            return huffman_encode_from_meta(words, np.asarray(meta))
        words, total = item
        return words_to_bytes(np.asarray(words), int(total))

    for img in imgs:
        img = np.ascontiguousarray(img, dtype=np.uint8)
        if writer is None:
            h, w = img.shape
            writer = BitWriter()
            if not use_huffman:
                writer.put_bit(0)
            write_image_header(writer, quant, use_rle, w, h)
            hdr = jnp.asarray(header_to_words(writer.getvalue()))
            fn = (make_encode_packed_hist if use_huffman
                  else make_encode_packed)(block_size, use_rle, norm)
        assert img.shape == (h, w), "stream images must share a shape"
        # Dispatch (async) and only then drain the oldest in-flight encode.
        pending.append(fn(jnp.asarray(img), jnp.asarray(
            quant.as_float(np.float32)), np.int32(writer.position), hdr))
        if len(pending) > depth:
            yield finish(pending.pop(0))
    while pending:
        yield finish(pending.pop(0))


def decode_image_batch(streams, norm: str = "reference",
                       backend: str = "numpy", block_size: int = BLOCK_SIZE,
                       max_workers: int = 8):
    """Decode many wire streams concurrently (the serving counterpart of
    encode_image_batch).  Decode is host-stage-bound (Huffman FSM + offset
    walk + extract all release the GIL in native code, and the IDCT is a
    BLAS call), so a thread pool scales it across cores; outputs are
    identical to per-stream decode_image with the same ``backend`` (the
    default matches decode_image's bit-parity "numpy"; pass "fast" for the
    f32 path, which may differ by +-1 on ~0.003% of pixels)."""
    from .image import decode_image

    streams = list(streams)
    if len(streams) <= 1:
        return [decode_image(s, norm=norm, backend=backend,
                             block_size=block_size) for s in streams]
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(
            lambda s: decode_image(s, norm=norm, backend=backend,
                                   block_size=block_size), streams))
