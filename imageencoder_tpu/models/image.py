"""Still-image encoder/decoder — the data-parallel re-design of the
reference's ImageEncoder/ImageDecoder pipelines (ImageEncoder.cpp:52-175,
ImageDecoder.cpp:55-122).

Encode data-flow (batched; no per-block host loop):
    [H,W] u8 --blockify--> [N,B,B] --(-128, DCT, /Q, round)--> int coeffs
    --zigzag gather--> [N,K] --block_stats--> widths/counts
    --block_fields + prefix-sum packer--> bitstream

Decode data-flow:
    header parse -> sequential offset-recovery walk (the only inherently
    serial stage; variable-length block headers form a dependency chain,
    reference ImageDecoder.cpp:88-113 keeps it serial too) -> fully parallel
    coefficient gather -> iDCT batch -> deblockify.

The compute stage runs on numpy float64 ("exact", bit-parity with the C++
reference) or on JAX float32 on the device ("jax"); both share the same
stream format.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import bitpack, rle
from ..ops.bitpack import BitReader, BitWriter
from ..ops.blockify import blockify, deblockify
from ..ops.dct import clamp_to_u8, forward_transform, inverse_transform
from ..ops.zigzag import zigzag_order
from ..utils import profiling
from ..utils.bits import shift_signed
from ..utils.logger import Logger
from ..utils.quant import QuantMatrix
from .headers import read_image_header, write_image_header

BLOCK_SIZE = 4  # dc::BlockSize (Block.hpp:13); other sizes supported via block_size=


def encode_blocks(blocks_u8, quant: QuantMatrix, use_rle: bool,
                  norm: str = "reference", backend: str = "numpy"):
    """[N,B,B] u8 tiles -> (field values, field nbits) wire data.

    The batched device half of the encoder: transform + stats + field
    expansion. Returns numpy arrays ready for the bit packer.
    """
    b = blocks_u8.shape[-1]
    zz = zigzag_order(b)
    if backend == "jax":
        import jax.numpy as jnp

        from ..ops.pipeline import make_encode_fields_from_blocks

        fn = make_encode_fields_from_blocks(b, use_rle, norm)
        vals, nbits = fn(jnp.asarray(blocks_u8),
                         jnp.asarray(quant.as_float(np.float32)))
        return np.asarray(vals), np.asarray(nbits)
    if backend == "fast":
        from ..ops.dct import forward_transform_fast

        coeffs = forward_transform_fast(np.asarray(blocks_u8),
                                        quant.as_float(np.float32), norm)
        coeffs_zz = coeffs.reshape(coeffs.shape[0], b * b)[:, zz]
    else:
        from ..ops.dct import forward_transform_quantize_zz

        coeffs_zz = forward_transform_quantize_zz(
            np.asarray(blocks_u8), quant.as_float(), norm, zz)
    stats = rle.block_stats(coeffs_zz, use_rle)
    return rle.block_fields(coeffs_zz, stats, use_rle)


def encode_image(img: np.ndarray, quant: QuantMatrix, use_rle: bool = True,
                 use_huffman: bool = False, norm: str = "reference",
                 backend: str = "numpy", block_size: int = BLOCK_SIZE) -> bytes:
    """Encode a [H,W] uint8 image to the reference wire format.

    With use_huffman=False the stream leads with a '0' flag bit
    (ImageEncoder.cpp:84-86); with True the whole inner stream is wrapped by
    the Huffman layer (which falls back to the '0'+raw form if bigger).
    """
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    assert h % block_size == 0 and w % block_size == 0

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)  # no-Huffman flag leads the stream directly
    write_image_header(writer, quant, use_rle, w, h)

    if backend == "jax":
        # Fully-fused device path: transform + stats + bit-pack + Huffman on
        # chip; only the final stream comes back (ops/pipeline, ops/huffman).
        import jax.numpy as jnp

        from ..ops.device_pack import header_to_words, words_to_bytes
        from ..ops.pipeline import make_encode_packed, make_encode_packed_hist

        args = (jnp.asarray(img), jnp.asarray(quant.as_float(np.float32)),
                np.int32(writer.position),
                jnp.asarray(header_to_words(writer.getvalue())))
        if use_huffman:
            from ..ops.huffman import huffman_encode_from_meta

            with profiling.stage("device encode+pack+hist"):
                words, meta = make_encode_packed_hist(block_size, use_rle,
                                                      norm)(*args)
                meta = np.asarray(meta)
            with profiling.stage("huffman"):
                return huffman_encode_from_meta(words, meta)
        with profiling.stage("device encode+pack"):
            words, total = make_encode_packed(block_size, use_rle, norm)(*args)
            return words_to_bytes(words, int(total))
    else:
        from ..runtime.native import tune_allocator

        tune_allocator()
        inner = None
        try:
            # One native pass over the pixels: per-block read + exact-order
            # f64 DCT + quantize + RLE stats + chunk-parallel record
            # bitpack (runtime.cpp::encode_frame_pack with no prediction —
            # an image IS an I-frame, Frame.cpp:130-159).  No blockified
            # intermediates or coefficient tensors materialize.
            from ..ops.dct import _fwd_weights
            from ..runtime.native import encode_frame_pack_native

            wf, scale = _fwd_weights(block_size, norm)
            k = block_size * block_size
            n_blocks = (h // block_size) * (w // block_size)
            cap_bits = writer.position + 64 + n_blocks * (4 + 17 * (k + 1))
            # Uninitialized on purpose: the native packer plain-stores
            # every byte it owns and pre-zeroes the atomic-OR merge bytes
            # itself (zero_merge_bytes) — memset-ing this worst-case
            # capacity (~8.5 MB on ex4) cost ~1 ms per encode.
            out = np.empty((cap_bits + 7) // 8, dtype=np.uint8)
            prefix, _ = bitpack.pack_fields(
                np.asarray(writer.values, dtype=np.int64),
                np.asarray(writer.nbits, dtype=np.int64))
            out[:len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
            with profiling.stage("fused encode"):
                total = encode_frame_pack_native(
                    img, None, quant.as_float(), wf, scale, None,
                    zigzag_order(block_size), block_size, use_rle, None, 0,
                    None, writer.position, out)
            # Zero-copy view: huffman_encode and the bytes conversion
            # below only need the buffer protocol.
            inner = out[:(total + 7) // 8]
        except Exception as e:
            from ..runtime.native import warn_fallback
            warn_fallback("encode_frame_pack_image", e)
        if inner is None:
            with profiling.stage("transform"):
                from ..ops.dct import forward_transform_quantize_zz

                blocks = blockify(img, block_size)
                coeffs_zz = forward_transform_quantize_zz(
                    blocks, quant.as_float(), norm,
                    zigzag_order(block_size))
            with profiling.stage("stats"):
                stats = rle.block_stats(coeffs_zz, use_rle)
                vals, nbits = rle.block_fields(coeffs_zz, stats, use_rle)
            with profiling.stage("bitpack"):
                inner, _ = bitpack.pack_fields(
                    np.concatenate([np.asarray(writer.values, dtype=np.int64),
                                    np.asarray(vals, dtype=np.int64).ravel()]),
                    np.concatenate([np.asarray(writer.nbits, dtype=np.int64),
                                    np.asarray(nbits,
                                               dtype=np.int64).ravel()]))

    if use_huffman:
        from ..ops.huffman import huffman_encode

        with profiling.stage("huffman"):
            return huffman_encode(inner)
    return inner.tobytes() if isinstance(inner, np.ndarray) else inner


def walk_block_offsets(bits: np.ndarray | None, start_bit: int,
                       n_blocks: int, use_rle: bool,
                       block_size: int = BLOCK_SIZE,
                       packed: bytes | None = None):
    """Sequential offset-recovery over variable-length block records.

    Returns (payload_offsets [N], data_bits [N], n_payload [N], end_bit).
    This is the decode-side serial dependency chain (SURVEY §3.2); a native
    C++ walker (runtime/) replaces this Python loop on the hot path.
    ``bits`` may be None when ``packed`` is given — the hot path works on
    packed bytes and the bit array is only materialized by the fallback.
    """
    try:
        from ..runtime.native import walk_offsets_native

        return walk_offsets_native(bits, start_bit, n_blocks, use_rle,
                                   block_size, packed=packed)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("walk_offsets", e)

    if bits is None:
        bits = bitpack.to_bits(packed)
    k = block_size * block_size
    offs = np.empty(n_blocks, dtype=np.int64)
    dbits = np.empty(n_blocks, dtype=np.int32)
    counts = np.empty(n_blocks, dtype=np.int32)
    pos = start_bit
    bl = bits.tolist()  # python ints are much faster to index in a tight loop
    nbits_total = len(bl)

    def get(p, n):
        v = 0
        for i in range(n):
            v = (v << 1) | (bl[p + i] if p + i < nbits_total else 0)
        return v

    for i in range(n_blocks):
        b = get(pos, 4)
        pos += 4
        if use_rle:
            ln = get(pos, b)
            pos += b
        else:
            ln = k
        offs[i] = pos
        dbits[i] = b
        counts[i] = ln
        pos += b * ln
    return offs, dbits, counts, pos


def extract_block_coeffs(bits: np.ndarray | None, start_bit: int,
                         n_blocks: int, use_rle: bool,
                         block_size: int = BLOCK_SIZE,
                         packed: bytes | None = None):
    """Host serial front half of decode: offset walk + field extraction.

    Returns (coeffs [N, B, B] int row-major, end_bit).  The wire format
    forces this to stay host-side — block N's position depends on every
    previous block's width (ImageDecoder.cpp:88-113) — but everything
    after it (dequantize/IDCT/deblockify) is data-parallel; the sharded
    device back end (parallel/sharding.decode_image_sharded) consumes
    this output directly.
    """
    k = block_size * block_size
    if packed is None:
        packed = np.packbits(bits).tobytes()  # share across walk + extract
    with profiling.stage("offset walk"):
        offs, dbits, counts, end = walk_block_offsets(
            bits, start_bit, n_blocks, use_rle, block_size, packed=packed)
    try:
        from ..runtime.native import extract_coeffs_native

        with profiling.stage("extract"):
            coeffs = extract_coeffs_native(
                packed, offs, dbits, counts,
                zigzag_order(block_size), block_size)  # int16 row-major
        return coeffs.reshape(n_blocks, block_size, block_size), end
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("extract_coeffs", e)
    if bits is None:
        bits = bitpack.to_bits(packed)
    # Vectorized numpy fallback: field (i, j) at offs[i] + j*dbits[i].
    j = np.arange(k, dtype=np.int64)[None, :]
    live = j < counts[:, None]
    field_offs = offs[:, None] + j * dbits[:, None].astype(np.int64)
    field_bits = np.where(live, dbits[:, None], 0)
    raw = bitpack.read_fields(bits, field_offs.ravel(), field_bits.ravel())
    coeffs_zz = shift_signed(raw.reshape(n_blocks, k),
                             np.maximum(dbits[:, None], 1)) * live
    zz = zigzag_order(block_size)
    flat = np.zeros((n_blocks, k), dtype=np.int32)
    flat[:, zz] = coeffs_zz
    return flat.reshape(n_blocks, block_size, block_size), end


def decode_blocks(bits: np.ndarray | None, start_bit: int, n_blocks: int,
                  quant: QuantMatrix, use_rle: bool, norm: str = "reference",
                  backend: str = "numpy", block_size: int = BLOCK_SIZE,
                  residual: bool = False, packed: bytes | None = None):
    """Parse + inverse-transform all blocks. Returns ([N,B,B] u8, end_bit).

    With residual=True, returns the raw float IDCT output (the reference's
    ``expanded`` array incl. the +128 restore, Block.cpp:163-177) WITHOUT
    the clamp-to-byte — the P-frame residual path (Frame.cpp:107-117) adds
    it onto the motion prediction before clamping.

    ``bits`` may be None when ``packed`` is given — the native hot path
    never materializes the 8x bit array; only the numpy fallbacks do.
    """
    coeffs, end = extract_block_coeffs(bits, start_bit, n_blocks, use_rle,
                                       block_size, packed=packed)

    if backend == "jax":
        # Fully on-device inverse half (incl. the residual path);
        # backend="fast" covers host-only runs.
        import jax.numpy as jnp

        from ..ops.pipeline import make_decode_blocks_rowmajor

        fn = make_decode_blocks_rowmajor(block_size, norm, residual)
        with profiling.stage("idct"):
            px = fn(jnp.asarray(coeffs),
                    jnp.asarray(quant.as_float(np.float32)))
        if residual:
            return np.asarray(px).astype(np.float64), end
        return np.asarray(px), end

    if backend == "fast":
        # Host f32 BLAS path: ~4x faster than the bit-parity f64 IDCT;
        # +-1 on ~0.003% of pixels (docs/PARITY.md).
        from ..ops.dct import inverse_transform_fast

        with profiling.stage("idct"):
            px = inverse_transform_fast(coeffs, quant.as_float(np.float32),
                                        norm)
        if residual:
            return px.astype(np.float64), end
        return clamp_to_u8(px), end

    with profiling.stage("idct"):
        px = inverse_transform(coeffs, quant.as_float(), norm)
    if residual:
        return px, end
    return clamp_to_u8(px), end


def decode_image(data: bytes, norm: str = "reference", backend: str = "numpy",
                 block_size: int = BLOCK_SIZE):
    """Decode a reference-format stream back to a [H,W] uint8 image.

    The hot path stays in packed BYTES end-to-end (Huffman FSM -> native
    offset walk -> fused extract+IDCT+deblockify); the 8x-larger bit array
    is only materialized by the numpy fallbacks and the header parse (which
    unpacks a small prefix).
    """
    if not data:
        from ..utils.exceptions import StreamFormatError

        raise StreamFormatError("empty stream")
    if backend in ("fast", "numpy"):
        import os

        from ..runtime.native import tune_allocator

        tune_allocator()
        if os.environ.get("IER_PIPELINED_DECODE"):
            # Overlapped native pipeline: Huffman FSM || offset walk ||
            # extract+IDCT with no stage barriers or intermediate buffers
            # (runtime.cpp::decode_image_pipelined).  Bit-identical to the
            # staged chain; it wins where the serial walk fraction
            # dominates (many-core hosts) — on small machines the staged
            # chain's stages are compute-bound and it is faster, so staged
            # is the default.
            img = _decode_image_pipelined_host(data, norm, block_size,
                                               exact=True)
            if img is not None:
                return img
    if data[0] & 0x80:  # Huffman flag bit (stream is MSB-first)
        from ..ops.huffman import huffman_decode_view

        with profiling.stage("huffman decode"):
            # Zero-copy uint8 view on the native path — the walk/extract
            # below only need the buffer protocol.
            payload = huffman_decode_view(data)
        start = 0
    else:
        payload, start = data, 1

    # Header (quant matrix + dims) is tiny; parse it from a prefix.
    head = payload[:65536]
    if isinstance(head, np.ndarray):
        head = head.tobytes()
    reader = BitReader(head, position=start)
    quant, use_rle, w, h = read_image_header(reader, block_size)
    n_blocks = (w // block_size) * (h // block_size)

    if backend in ("fast", "numpy"):
        # Both host backends run the exact f64 engine: since the AVX-512
        # block kernel landed it is FASTER than the f32 chain it replaced
        # (round-4 A/B: 7.1 ms vs 16.9 ms on ex4) *and* bit-parity — a
        # "fast" mode must be fastest, so it aliases the exact engine.
        # The f32 engine remains for the composable
        # decode_blocks API and the video residual paths.
        img = _decode_to_image_fused(payload, reader.position, n_blocks,
                                     quant, use_rle, norm, block_size, h, w,
                                     exact=True)
        if img is not None:
            return img

    blocks, _ = decode_blocks(None, reader.position, n_blocks, quant,
                              use_rle, norm=norm, backend=backend,
                              block_size=block_size, packed=payload)
    return deblockify(blocks, h, w)


def _decode_image_pipelined_host(data: bytes, norm: str, block_size: int,
                                 exact: bool):
    """Whole-stream pipelined decode: the native runtime
    overlaps the Huffman byte-FSM, the serial offset walk and the fused
    per-block extract+IDCT instead of running them as barriers.  Returns
    the [h, w] image, or None when the native runtime is unavailable or
    the stream needs the staged fallback."""
    from ..runtime.native import (available, decode_image_pipelined_native,
                                  huffman_fsm_decode_head_native)

    if not available():
        return None
    try:
        entries = None
        start_bit = 0
        if data[0] & 0x80:  # Huffman-coded: parse the dict prefix only
            from ..ops.huffman import parse_dict_bytes, validate_dict_entries

            entries, start_bit = parse_dict_bytes(data)
            if not entries:
                return None
            # Same strict rejection as huffman_decode: a wrapped/corrupt
            # dict must not head-decode to garbage dims (the staged path
            # this falls back to raises the loud StreamFormatError).
            validate_dict_entries(entries)
            head = huffman_fsm_decode_head_native(data, start_bit, entries)
            hreader = BitReader(head, position=0)
        else:
            hreader = BitReader(data[:65536], position=1)
        quant, use_rle, w, h = read_image_header(hreader, block_size)
        n_blocks = (w // block_size) * (h // block_size)
        from ..ops.dct import _inv_weights

        wi = _inv_weights(block_size, norm)
        with profiling.stage("pipelined decode"):
            return decode_image_pipelined_native(
                data, start_bit, entries, hreader.position, n_blocks,
                use_rle, block_size, zigzag_order(block_size),
                quant.as_float(np.float64 if exact else np.float32),
                wi if exact else wi.astype(np.float32), exact, h, w)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("decode_image_pipelined", e)
        return None


def _decode_to_image_fused(payload: bytes, start_bit: int, n_blocks: int,
                           quant: QuantMatrix, use_rle: bool, norm: str,
                           block_size: int, h: int, w: int,
                           exact: bool = False):
    """Native fused decode: offset walk + one-pass extract + dequant +
    IDCT + clamp + deblockify (runtime.cpp::decode_to_image, or its f64
    bit-parity twin decode_to_image_exact when ``exact``).  Returns the
    [h, w] image, or None if the native runtime is unavailable (callers
    fall through to the composable decode_blocks path)."""
    from ..runtime.native import (available, decode_to_image_exact_native,
                                  decode_to_image_native)

    if not available():
        return None
    try:
        with profiling.stage("offset walk"):
            offs, dbits, counts, _ = walk_block_offsets(
                None, start_bit, n_blocks, use_rle, block_size,
                packed=payload)
        from ..ops.dct import _inv_weights

        with profiling.stage("extract+idct fused"):
            if exact:
                return decode_to_image_exact_native(
                    payload, offs, dbits, counts, zigzag_order(block_size),
                    block_size, quant.as_float(np.float64),
                    _inv_weights(block_size, norm), h, w)
            return decode_to_image_native(
                payload, offs, dbits, counts, zigzag_order(block_size),
                block_size, quant.as_float(np.float32),
                _inv_weights(block_size, norm).astype(np.float32), h, w)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("decode_to_image", e)
        return None


@dataclass
class ImageEncoder:
    """Drop-in style driver mirroring dc::ImageEncoder (ImageEncoder.cpp)."""

    source_file: str
    dest_file: str
    width: int
    height: int
    use_rle: bool
    quant: QuantMatrix
    use_huffman: bool = True
    backend: str = "numpy"
    norm: str = "reference"
    block_size: int = BLOCK_SIZE

    def process(self) -> bool:
        img = np.fromfile(self.source_file, dtype=np.uint8)
        assert img.size == self.width * self.height, \
            f"raw size {img.size} != {self.width}x{self.height}"
        Logger.write("[ImageEncoder] Processing image...")
        self._result = encode_image(img.reshape(self.height, self.width),
                                    self.quant, self.use_rle,
                                    use_huffman=self.use_huffman,
                                    norm=self.norm, backend=self.backend,
                                    block_size=self.block_size)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        raw = self.width * self.height
        Logger.write(f"[ImageEncoder] Encoded size: {len(self._result)} bytes"
                     f" => Ratio: {len(self._result) / raw * 100:.2f}%")


@dataclass
class ImageDecoder:
    """Driver mirroring dc::ImageDecoder (ImageDecoder.cpp)."""

    source_file: str
    dest_file: str
    backend: str = "numpy"
    norm: str = "reference"
    block_size: int = BLOCK_SIZE

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[ImageDecoder] Processing image...")
        self._result = decode_image(data, norm=self.norm,
                                    backend=self.backend,
                                    block_size=self.block_size)
        return True

    def save_result(self) -> None:
        self._result.tofile(self.dest_file)
        Logger.write(f"[ImageDecoder] Decoded size: {self._result.size} bytes")
