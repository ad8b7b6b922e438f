"""Single-jit device encode pipeline: image -> wire-format bit fields.

This is the flagship device path.  Where the reference runs a per-block host
loop (ImageEncoder.cpp:121-146: DCT -> quantize -> RLE -> stream per 4x4
block), the device formulation traces ONE jitted function over the whole
image:

    [H,W] u8 --reshape--> [N,B,B] --(x-128, D@X@D^T, /Q, round)--> int32
    --zigzag gather--> [N,K] --stats--> widths/counts --> (vals, nbits) fields

All stages are batched tensor ops: the DCT is one matrix product, the RLE
statistics are integer compares/reductions, and the field expansion is a
masked broadcast.  Nothing here depends on data values at trace time, so
XLA fuses the whole pipeline into a handful of kernels.

The (vals, nbits) field arrays feed either the host bit packer
(ops/bitpack.py, native C++ fast path) or the on-device packer
(ops/device_pack.py).

Numerics: float32 matmuls with Precision.HIGHEST.  Quantized coefficients can
differ from the float64 bit-parity path (ops/dct.py) by +-1 on rounding-tie
coefficients (~0.1%); streams remain decoder-compatible either way.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .dct import dct_matrix
from .zigzag import zigzag_order


def _round_half_away(xp, x):
    """std::round parity (Block.cpp:152): trunc-based, no double rounding."""
    t = xp.trunc(x)
    inc = xp.where(xp.abs(x - t) >= 0.5,
                   xp.where(x >= 0.0, 1.0, -1.0), 0.0).astype(x.dtype)
    return t + inc


def block_transform(blocks, dct_m, inverse: bool = False):
    """[N,B,B] f32 tiles -> D X D^T, or D^T Y D with inverse=True.

    THE device block transform: every device pipeline (encode, decode,
    recon, sharded) calls it, so they all round identically.  Both
    directions run at Precision.HIGHEST.  A single [N, B*B] x [B*B, B*B]
    product with kron(D, D) is the alternative form; on the GPU its gain
    did not show end to end (tools/gpu_ab.py), and in the inverse its
    rounding reached 2 against the exact decode of a 25-frame
    motion-compensated chain.
    """
    import jax
    import jax.numpy as jnp

    spec = "ui,nuv,vj->nij" if inverse else "ui,nij,vj->nuv"
    return jnp.einsum(spec, dct_m, blocks, dct_m,
                      precision=jax.lax.Precision.HIGHEST)


def quantize_image(img, quant, dct_m, block_size: int):
    """[H,W] u8/f32 -> int32 [H,W] quantized coefficients in place
    (block (r,c) coefficient (u,v) at [B*r+u, B*c+v]).

    THE transform implementation for every pipeline (single-image, video,
    sharded).  Accepts float32 input for residual images (the -128 bias
    applies to residuals too, Block.cpp:139-153 under SUBTRACT_128).
    """
    import jax.numpy as jnp

    b = block_size
    h, w = img.shape
    by, bx = h // b, w // b
    blocks = img.reshape(by, b, bx, b).swapaxes(1, 2).reshape(-1, b, b)
    x = blocks.astype(jnp.float32) - jnp.float32(128.0)
    y = block_transform(x, dct_m)
    q = _round_half_away(jnp, y / quant.astype(jnp.float32)).astype(jnp.int32)
    return q.reshape(by, bx, b, b).swapaxes(1, 2).reshape(h, w)


def transform_quantize(img, quant, dct_m, block_size: int):
    """[H,W] u8 -> [N,K] int32 zig-zag quantized coefficients (one fused graph).

    Reference per-block equivalent: Block::processDCTDivQ (Block.cpp:139-153)
    + zig-zag gather (algo.cpp:68-87).
    """
    import jax
    import jax.numpy as jnp

    b = block_size
    h, w = img.shape
    by, bx = h // b, w // b
    n = by * bx
    zz = jnp.asarray(zigzag_order(b))
    with jax.named_scope("transform"):
        c = quantize_image(img, quant, dct_m, b)
        coeffs = c.reshape(by, b, bx, b).swapaxes(1, 2).reshape(n, b * b)
        return coeffs[:, zz]


def fields_from_coeffs(coeffs_zz, use_rle: bool):
    """[N,K] int32 zig-zag coefficients -> (vals int32 [N,K+2], nbits int32).

    Thin jit-compatible wrapper over the single source of truth for the
    wire-format statistics and field layout (ops/rle.py: block_stats +
    block_fields — Block::createRLESequence/streamEncoded parity incl. the
    full-block trailing-strip corner, Block.cpp:186-232, 372-413).
    """
    import jax

    from . import rle

    with jax.named_scope("rle_fields"):
        stats = rle.block_stats(coeffs_zz, use_rle)
        return rle.block_fields(coeffs_zz, stats, use_rle)


@lru_cache(maxsize=None)
def make_encode_fields(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference"):
    """Build the jitted [H,W] u8 -> (vals, nbits) encoder step.

    Returned fn signature: f(img_u8 [H,W], quant_f32 [B,B]) -> (vals, nbits),
    jit-compiled per image shape.
    """
    import jax
    import jax.numpy as jnp

    dct_m = np.asarray(dct_matrix(block_size, norm), dtype=np.float32)

    @jax.jit
    def encode_fields(img, quant):
        coeffs_zz = transform_quantize(img, quant, jnp.asarray(dct_m), block_size)
        return fields_from_coeffs(coeffs_zz, use_rle)

    return encode_fields


@lru_cache(maxsize=None)
def make_encode_fields_from_blocks(block_size: int = 4, use_rle: bool = True,
                                   norm: str = "reference"):
    """Like :func:`make_encode_fields` but over pre-tiled [N,B,B] u8 blocks."""
    import jax
    import jax.numpy as jnp

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    zz = zigzag_order(b)

    @jax.jit
    def encode_fields(blocks, quant):
        x = blocks.astype(jnp.float32) - jnp.float32(128.0)
        y = block_transform(x, jnp.asarray(dct_m))
        q = _round_half_away(jnp, y / quant.astype(jnp.float32)).astype(jnp.int32)
        coeffs_zz = q.reshape(q.shape[0], b * b)[:, jnp.asarray(zz)]
        return fields_from_coeffs(coeffs_zz, use_rle)

    return encode_fields


def stream_byte_histogram(words, total_bits):
    """Masked byte histogram of a packed word stream, as a broadcast-compare
    reduction (scatter-free).  Returns int32[257] with slot 0 = total_bits
    and slots 1..256 the byte counts — one array so the host needs a single
    device round-trip for both.
    """
    import jax
    import jax.numpy as jnp

    with jax.named_scope("histogram"):
        nbytes = (total_bits.astype(jnp.int32) + 7) // 8
        lanes = ((words[:, None]
                  >> jnp.array([24, 16, 8, 0], jnp.uint32)[None, :])
                 & jnp.uint32(0xFF)).astype(jnp.uint8).reshape(-1)
        mask = jnp.arange(lanes.shape[0], dtype=jnp.int32) < nbytes
        # [M,256] compare fused into the reduction by XLA.
        eq = (lanes[:, None] == jnp.arange(256, dtype=jnp.uint8)[None, :])
        hist = jnp.sum(eq & mask[:, None], axis=0, dtype=jnp.int32)
        return jnp.concatenate([total_bits.astype(jnp.int32)[None], hist])


@lru_cache(maxsize=None)
def make_encode_packed_hist(block_size: int = 4, use_rle: bool = True,
                            norm: str = "reference"):
    """make_encode_packed + fused byte histogram of the resulting stream.

    f(img, quant, start_bit, header_words) -> (words u32, meta i32[257])
    with meta[0] = total_bits, meta[1:] = byte histogram.  One jit, so the
    host learns the stream length AND the Huffman statistics in a single
    device round-trip.
    """
    import jax

    base = make_encode_packed(block_size, use_rle, norm)

    @jax.jit
    def encode_packed_hist(img, quant, start_bit, header_words):
        words, total = base(img, quant, start_bit, header_words)
        return words, stream_byte_histogram(words, total)

    return encode_packed_hist


@lru_cache(maxsize=None)
def make_encode_packed(block_size: int = 4, use_rle: bool = True,
                       norm: str = "reference"):
    """Fully-fused device encoder: [H,W] u8 -> packed uint32 words.

    f(img, quant_f32, start_bit, header_words u32[64]) ->
        (words uint32 [N*9+64], total_bits i32).
    ``header_words`` (the host-built stream header, big-endian packed) are
    OR'd into the word prefix so the returned words are the COMPLETE inner
    stream.  Only the packed words cross host<->device — ~20x less traffic
    than shipping the field tensors.
    """
    import jax
    import jax.numpy as jnp

    from .device_pack import (HEADER_WORDS, pack_blocks_device,
                              packed_words_bound)

    dct_m = np.asarray(dct_matrix(block_size, norm), dtype=np.float32)

    @jax.jit
    def encode_packed(img, quant, start_bit, header_words):
        coeffs_zz = transform_quantize(img, quant, jnp.asarray(dct_m),
                                       block_size)
        vals, nbits = fields_from_coeffs(coeffs_zz, use_rle)
        n = vals.shape[0]
        words, total = pack_blocks_device(
            vals, nbits, start_bit, packed_words_bound(n, vals.shape[1]))
        words = words.at[:HEADER_WORDS].set(words[:HEADER_WORDS]
                                            | header_words)
        return words, total

    return encode_packed


@lru_cache(maxsize=None)
def make_decode_blocks_rowmajor(block_size: int = 4, norm: str = "reference",
                                residual: bool = False):
    """Jitted decode half over ROW-MAJOR coefficients [N,B,B] (the native
    extractor un-zigzags already): dequant + IDCT -> clamped [N,B,B] u8,
    or the unclamped float32 expansion when residual=True (the P-frame
    path adds it onto the motion prediction before clamping,
    Frame.cpp:107-117)."""
    import jax
    import jax.numpy as jnp

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)

    @jax.jit
    @jax.named_scope("idct")
    def decode_blocks(coeffs, quant):
        y = coeffs.astype(jnp.float32) * quant.astype(jnp.float32)
        px = block_transform(y, jnp.asarray(dct_m), inverse=True) \
            + jnp.float32(128.0)
        if residual:
            return px
        return jnp.floor(jnp.clip(px, 0.0, 255.0)).astype(jnp.uint8)

    return decode_blocks
