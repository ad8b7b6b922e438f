"""GOP / motion-compensated video codec (VideoEncoder/VideoDecoder parity).

Stream layout (VideoEncoder.cpp:64-91, VideoBase.cpp:45-86):

    [huffman wrap] [5-bit quant len + quant] [1-bit rle] [15-bit w] [15-bit h]
    [15-bit frame_count] [15-bit gop] [15-bit merange]
    then frames bit-contiguous, each:
      I-frame (f % gop == 0, VideoBase.hpp:32): 4x4 blocks exactly like an
        image payload, no header (Frame.cpp:130-159)
      P-frame: per-MacroBlock motion vectors, 2 x MVEC_BITS signed bits each
        (Block.cpp:416-423, MVEC_BITS = bits_needed(merange), VideoBase.cpp:42),
        then the residual coded exactly like an I-frame (Frame.cpp:160-243).

Input video is YUV420p; only Y is coded, UV is skipped on encode and filled
with 0x80 on decode (VideoBase.cpp:39-40, Frame.cpp:121-124).

Reference-parity reconstruction quirks replicated deliberately:
  * the encoder does NOT reconstruct I-frames — the next P-frame's motion
    search references the RAW I-frame pixels (Frame.cpp:130-159 never calls
    IDCT), while the decoder references decoded pixels: the codec has
    encoder/decoder drift by design (chronicled in reference doc/video),
  * P-frames ARE reconstructed in place: prediction window + dequantized
    residual, clamped (Frame.cpp:210-242, Block.cpp:111-119),
  * the residual is coded with the same -128 bias as pixels
    (SUBTRACT_128 applies to residual blocks too, Block.cpp:139-153),
  * motion vectors keep unclamped offsets; window fetches clamp
    (ImageBase.cpp:253-254).

Device formulation: each frame's blocks are one batched transform; the
motion search runs gather-free over translation SAD maps
(ops/video_pipeline.sad_motion_search; host fallback in ops/motion.py); in
raw-reference mode the whole video encodes in one fused device computation
(GOP-chunked with bit-splicing beyond 32 frames), in recon mode the
frame-to-frame reconstruction carry is a lax.scan.  GOPs are fully
independent (each starts with an I-frame) — the multi-chip / multi-host
axis (parallel/).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops import bitpack, rle
from ..ops.bitpack import BitReader, BitWriter
from ..ops.blockify import blockify, deblockify
from ..ops.dct import clamp_to_u8, forward_transform, inverse_transform
from ..ops.motion import MACRO, find_motion, predict_image
from ..ops.zigzag import zigzag_order
from ..utils.bits import bits_needed, shift_signed
from ..utils.logger import Logger
from ..utils.quant import QuantMatrix
from .headers import (VideoParams, read_image_header, read_video_params,
                      write_image_header, write_video_params)
from .image import (BLOCK_SIZE, decode_blocks, encode_blocks,
                    walk_block_offsets)

UV_FILL = 0x80  # dc::VIDEO_UV_FILL (Frame.hpp:12)


def mvec_bits(merange: int) -> int:
    """MVEC_BIT_SIZE = bits_needed(int16(merange)) (VideoBase.cpp:42)."""
    return int(bits_needed(np.int16(merange)))


def split_yuv420(data: bytes, width: int, height: int):
    """[F] list of Y planes [H,W]; UV bytes are skipped (VideoBase.cpp:39-40)."""
    y_size = width * height
    frame_size = y_size + y_size // 2
    n = len(data) // frame_size
    arr = np.frombuffer(data, dtype=np.uint8, count=n * frame_size)
    arr = arr.reshape(n, frame_size)
    return arr[:, :y_size].reshape(n, height, width).copy()


def _frame_fields(frame_u8, quant, use_rle, norm, backend,
                  block_size=BLOCK_SIZE):
    """Encode one frame's blocks to (vals, nbits) wire fields."""
    return encode_blocks(blockify(frame_u8, block_size), quant, use_rle,
                         norm=norm, backend=backend)


def _residual_fields_and_recon(residual, pred, quant, use_rle, norm, backend,
                               block_size=BLOCK_SIZE):
    """Encode a residual image and return (vals, nbits, reconstructed frame).

    residual: [H,W] float64 (cur - pred); pred: [H,W] uint8.
    Reconstruction = clamp(pred + dequantized residual) (Block.cpp:111-119),
    mirroring copyMacroblockToMatchingMicroblocks (ImageBase.cpp:266-306)
    which encodes then immediately decodes each residual block.
    """
    blocks = blockify(residual, block_size)
    if backend == "fast":
        from ..ops.dct import forward_transform_fast, inverse_transform_fast

        coeffs = forward_transform_fast(blocks, quant.as_float(np.float32),
                                        norm)
        zz = zigzag_order(block_size)
        czz = coeffs.reshape(coeffs.shape[0], -1)[:, zz]
        stats = rle.block_stats(czz, use_rle)
        vals, nbits = rle.block_fields(czz, stats, use_rle)
        expanded = inverse_transform_fast(coeffs,
                                          quant.as_float(np.float32), norm)
    elif backend == "jax":
        import jax.numpy as jnp

        # Fast path: float32 transform on device.
        coeffs = forward_transform(jnp.asarray(blocks), quant.as_float(np.float32),
                                   norm, dtype=jnp.float32)
        zz = zigzag_order(block_size)
        czz = np.asarray(coeffs).reshape(coeffs.shape[0], -1)[:, zz]
        stats = rle.block_stats(czz, use_rle)
        vals, nbits = rle.block_fields(czz, stats, use_rle)
        expanded = np.asarray(inverse_transform(
            jnp.asarray(coeffs), quant.as_float(np.float32), norm,
            dtype=jnp.float32))
    else:
        zz = zigzag_order(block_size)
        try:
            # Fused native bit-parity path: exact-order f64 transform +
            # quantize + zig-zag, then dequant + exact IDCT + prediction
            # add + clamp + deblockify, no numpy f64 tensor chains.
            from ..runtime.native import (dct_quantize_exact_f64_native,
                                          idct_recon_exact_native)
            from ..ops.dct import _fwd_weights, _inv_weights

            h, w = residual.shape
            k = block_size * block_size
            wf, scale = _fwd_weights(block_size, norm)
            czz = dct_quantize_exact_f64_native(
                blocks.reshape(-1, k), wf, scale, quant.as_float(), zz)
            stats = rle.block_stats(czz, use_rle)
            vals, nbits = rle.block_fields(czz, stats, use_rle)
            recon = idct_recon_exact_native(
                czz, block_size, zz, _inv_weights(block_size, norm),
                quant.as_float(), pred, h, w)
            return vals, nbits, recon
        except Exception as e:
            from ..runtime.native import warn_fallback
            warn_fallback("residual_recon", e)
        coeffs = forward_transform(blocks, quant.as_float(), norm)
        czz = coeffs.reshape(coeffs.shape[0], -1)[:, zz]
        stats = rle.block_stats(czz, use_rle)
        vals, nbits = rle.block_fields(czz, stats, use_rle)
        expanded = inverse_transform(coeffs, quant.as_float(), norm)

    h, w = residual.shape
    expanded_img = deblockify(expanded, h, w)
    recon = clamp_to_u8(pred.astype(np.float64) + expanded_img)
    return vals, nbits, recon


def _encode_video_host_native(frames, quant: QuantMatrix, use_rle: bool,
                              gop: int, merange: int, norm: str,
                              ref_mode: str, block_size: int,
                              writer: BitWriter) -> bytes:
    """Whole-video host encode through the one-pass native back end.

    Serial frame loop (the wire format's bit offsets chain through frames),
    OpenMP-parallel within each frame: native motion search + prediction,
    then runtime.cpp::encode_frame_pack fuses residual read, exact-order
    f64 DCT + quantize + zig-zag, RLE stats, mvec fields and the
    chunk-parallel record bitpack directly into one stream buffer.  In raw
    ref_mode the reconstruction is skipped entirely (the next frame
    references raw pixels); in recon mode it lands in a per-frame buffer
    that becomes the next reference.  Bit-identical to the numpy fields
    chain (test_video_native pins this).
    """
    from ..ops.dct import _fwd_weights, _inv_weights
    from ..ops.motion import search_steps
    from ..runtime.native import (encode_frame_pack_native,
                                  find_motion_native, predict_frame_native)

    n_frames, h, w = frames.shape
    k = block_size * block_size
    n_micro = (h // block_size) * (w // block_size)
    has_p = gop > 1 and h % MACRO == 0 and w % MACRO == 0
    n_macro = (h // MACRO) * (w // MACRO) if has_p else 0
    mb = mvec_bits(merange)
    wf, scale = _fwd_weights(block_size, norm)
    wi = _inv_weights(block_size, norm) if ref_mode == "recon" else None
    zz = zigzag_order(block_size)
    steps = search_steps(merange)
    qf = quant.as_float()

    cap_bits = writer.position + 64 + n_frames * (
        2 * n_macro * mb + n_micro * (4 + 17 * (k + 1)))
    # Uninitialized on purpose: the native packer pre-zeroes its atomic-OR
    # merge bytes (zero_merge_bytes) and plain-stores everything else, so
    # the worst-case capacity need not be memset (it is ~4x the stream).
    out = np.empty((cap_bits + 7) // 8, dtype=np.uint8)
    prefix, _ = bitpack.pack_fields(np.asarray(writer.values, dtype=np.int64),
                                    np.asarray(writer.nbits, dtype=np.int64))
    out[:len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    pos = writer.position
    ref: np.ndarray | None = None
    Logger.progress(0, n_frames)
    for f in range(n_frames):
        cur = np.ascontiguousarray(frames[f])
        if f % gop == 0:
            pos = encode_frame_pack_native(
                cur, None, qf, wf, scale, None, zz, block_size, use_rle,
                None, 0, None, pos, out)
            ref = cur  # I-frames are never reconstructed (Frame.cpp:130-159)
        else:
            mv = find_motion_native(cur, ref, steps)
            pred = predict_frame_native(ref, mv)
            recon = (np.empty((h, w), np.uint8) if ref_mode == "recon"
                     else None)
            pos = encode_frame_pack_native(
                cur, pred, qf, wf, scale, wi, zz, block_size, use_rle,
                mv, mb, recon, pos, out)
            ref = cur if ref_mode == "raw" else recon
        Logger.progress(f + 1, n_frames)
    # Zero-copy view: the caller's huffman_encode only needs the buffer
    # protocol, and the no-huffman return converts at the API boundary.
    # The bit position comes along for headerless callers (the checkpoint
    # GOP-payload path needs the exact bit length of its segment).
    return out[:(pos + 7) // 8], pos


def encode_video(data: bytes, width: int, height: int, quant: QuantMatrix,
                 use_rle: bool, gop: int, merange: int,
                 use_huffman: bool = True, norm: str = "reference",
                 backend: str = "numpy", ref_mode: str = "raw",
                 block_size: int = BLOCK_SIZE) -> bytes:
    """Encode a YUV420p byte stream to the reference video wire format.

    ref_mode selects the motion-reference policy:
      * "raw"  (default): every P-frame references the RAW previous frame.
        This is the behaviour of the SHIPPED reference binaries, verified
        bit-exactly by experiment (a video where frame2 == frame1 encodes
        frame2 with an all-zero residual, proving the encoder's reference
        was the raw frame1) — and it makes every frame's encode
        independent: no sequential carry, the whole GOP batches on the device.
      * "recon": P-frames reference the previous frame's reconstruction
        (prediction + dequantized residual), the semantics written in the
        shipped *source* (Frame.cpp:210-242 overwrites the frame buffer).
        The shipped binaries demonstrably do not do this — they appear to
        be built from an older revision.  Reconstruction tracks the decoder
        more closely, so this mode decodes at higher PSNR; streams remain
        format-compatible either way (the wire carries no reference state).
    """
    assert width % block_size == 0 and height % block_size == 0
    assert MACRO % block_size == 0, block_size
    gop = max(1, gop)
    if width % MACRO or height % MACRO:
        # The reference only asserts %4 (VideoEncoder.cpp:13-14) but its
        # P-frame path desyncs on non-%16 dims: MicroBlocks outside any
        # MacroBlock never get an RLE sequence, so streamEncoded skips them
        # while the decoder still reads them.  With gop == 1 no P-frame is
        # ever emitted (the reference handles all-I %4 dims correctly), so
        # only reject dims when P-frames would exist.
        if gop > 1:
            raise ValueError(
                f"video dimensions must be multiples of {MACRO} "
                f"(got {width}x{height}); the reference silently produces "
                f"undecodable streams for these when gop > 1")
        backend_eff = "all-i"  # no macro grid: motion pipelines don't apply
    else:
        backend_eff = backend
    frames = split_yuv420(data, width, height)
    n_frames = len(frames)
    mb = mvec_bits(merange)

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, width, height)
    write_video_params(writer, VideoParams(n_frames, gop, merange))

    if n_frames == 0:
        # Input shorter than one frame: header-only stream, like the
        # reference (frame_count = filesize / frame_size, VideoBase.cpp:39).
        inner = writer.getvalue()
        if use_huffman:
            from ..ops.huffman import huffman_encode

            return huffman_encode(inner)
        return inner

    if backend_eff == "jax":
        # Whole video in one device computation (ops/video_pipeline.py):
        # raw-reference mode has no frame-to-frame carry, so motion search,
        # transforms and bit packing batch over every frame at once;
        # recon mode carries the reconstruction through a lax.scan.
        import jax.numpy as jnp

        from ..ops.device_pack import (HEADER_WORDS, header_to_words,
                                       words_to_bytes)
        from ..ops.video_pipeline import (make_encode_video_packed,
                                          make_encode_video_packed_recon)

        factory = (make_encode_video_packed if ref_mode == "raw"
                   else make_encode_video_packed_recon)
        quant_f = jnp.asarray(quant.as_float(np.float32))
        if n_frames <= 32:
            fn = factory(gop, merange, mb, block_size, use_rle, norm,
                         with_hist=use_huffman)
            out = fn(jnp.asarray(frames), quant_f,
                     np.int32(writer.position),
                     jnp.asarray(header_to_words(writer.getvalue())))
            if use_huffman:
                from ..ops.huffman import huffman_encode_from_meta

                return huffman_encode_from_meta(*out)
            words, total = out
            return words_to_bytes(words, int(total))

        # Long videos: GOP-aligned chunks (GOPs are independent) encoded at
        # bit offset 0 and bit-spliced — identical stream, bounded memory.
        chunk = max(gop, (32 // gop) * gop)
        zeros_hdr = jnp.zeros(HEADER_WORDS, jnp.uint32)
        segments = [(writer.getvalue(), writer.position)]
        for s in range(0, n_frames, chunk):
            part = frames[s:s + chunk]
            fnc = factory(gop, merange, mb, block_size, use_rle, norm,
                          with_hist=False)
            words, total = fnc(jnp.asarray(part), quant_f, np.int32(0),
                               zeros_hdr)
            segments.append((words_to_bytes(words, int(total)), int(total)))
        inner = bitpack.concat_bit_segments(segments)
        if use_huffman:
            from ..ops.huffman import huffman_encode

            return huffman_encode(inner)
        return inner

    from ..runtime.native import tune_allocator

    tune_allocator()  # per-frame numpy temporaries: keep off the mmap path

    if backend_eff in ("numpy", "all-i"):
        # One-pass native back end: per frame, motion + prediction + fused
        # residual DCT/quant/stats/mvec/bitpack straight into the stream
        # buffer (runtime.cpp::encode_frame_pack) — no int64 field tensors,
        # no whole-video concatenate.  Bit-identical to the fallback chain.
        try:
            inner, _ = _encode_video_host_native(frames, quant, use_rle,
                                                 gop, merange, norm,
                                                 ref_mode, block_size,
                                                 writer)
        except Exception as e:
            from ..runtime.native import warn_fallback
            warn_fallback("encode_video_native", e)
        else:
            if use_huffman:
                from ..ops.huffman import huffman_encode

                return huffman_encode(inner)
            return inner.tobytes() if isinstance(inner, np.ndarray) else inner

    ref: np.ndarray | None = None  # previous frame (raw, or recon P)
    field_vals = [np.asarray(writer.values, dtype=np.int64)]
    field_nbits = [np.asarray(writer.nbits, dtype=np.int64)]
    Logger.progress(0, n_frames)
    for f in range(n_frames):
        Logger.progress(f + 1, n_frames)
        cur = frames[f]
        if f % gop == 0:
            vals, nbits = _frame_fields(cur, quant, use_rle, norm, backend,
                                        block_size)
            ref = cur  # never reconstructed (Frame.cpp:130-159) — raw
        else:
            mvec, _ = find_motion(cur, ref, merange)
            pred = predict_image(ref, mvec, height, width)
            residual = cur.astype(np.float64) - pred.astype(np.float64)
            vals, nbits, recon = _residual_fields_and_recon(
                residual, pred, quant, use_rle, norm, backend, block_size)
            # All mvecs first (Frame.cpp:210-229), masked to MVEC_BITS.
            mask = (1 << mb) - 1
            mv = np.empty(mvec.shape[0] * 2, dtype=np.int64)
            mv[0::2] = mvec[:, 0] & mask
            mv[1::2] = mvec[:, 1] & mask
            field_vals.append(mv)
            field_nbits.append(np.full(mv.shape[0], mb, dtype=np.int64))
            ref = cur if ref_mode == "raw" else recon
        field_vals.append(np.asarray(vals, dtype=np.int64).ravel())
        field_nbits.append(np.asarray(nbits, dtype=np.int64).ravel())

    inner, _ = bitpack.pack_fields(np.concatenate(field_vals),
                                   np.concatenate(field_nbits))
    if use_huffman:
        from ..ops.huffman import huffman_encode

        return huffman_encode(inner)
    return inner  # leading 0 flag bit was emitted into the writer above


def _decode_video_device(parsed, packed, quant, gop, n_micro, n_macro,
                         width, height, norm, motioncomp, block_size):
    """Device half of decode_video(backend="jax"): extract coefficients
    natively per frame, then run GOP-chunked fused decode scans."""
    import jax.numpy as jnp

    from ..ops.video_pipeline import make_decode_video_device
    from ..runtime.native import extract_coeffs_native

    zz = zigzag_order(block_size)
    k = block_size * block_size
    n_frames = len(parsed)

    coeffs = np.empty((n_frames, n_micro, k), dtype=np.int16)
    mvec = np.zeros((n_frames, n_macro, 2), dtype=np.int32)
    for f, (mv, start, (offs, dbits, counts)) in enumerate(parsed):
        coeffs[f] = extract_coeffs_native(packed, offs, dbits, counts, zz,
                                          block_size)
        if mv is not None:
            mvec[f] = mv

    chunk = max(gop, (32 // gop) * gop)  # GOP-aligned, carry resets at cuts
    fn = None
    out = np.empty((n_frames, height, width), dtype=np.uint8)
    for s in range(0, n_frames, chunk):
        part = coeffs[s:s + chunk]
        if fn is None or part.shape[0] != last_n:
            fn = make_decode_video_device(height, width, gop, block_size,
                                          norm, motioncomp)
            last_n = part.shape[0]
        dec = fn(jnp.asarray(part.astype(np.int32)
                             .reshape(-1, n_micro, block_size, block_size)),
                 jnp.asarray(mvec[s:s + chunk]),
                 jnp.asarray(quant.as_float(np.float32)))
        out[s:s + chunk] = np.asarray(dec)
    return out


def _decode_video_fast(parsed, packed, quant, gop, width, height, norm,
                       motioncomp, block_size, workers):
    """Host fast path: one fused native call per frame (extract + dequant +
    IDCT + prediction add + clamp + deblockify), prediction assembly
    native too.  Reuses the pass-1 record layout — no second offset walk.
    Since the AVX-512 f64 block kernel landed, the exact engine is both
    the FASTEST and bit-parity, so "fast" video decode now equals the
    "numpy" parity output (the f32 engine remains as the non-AVX
    fallback).  GOPs are independent (each starts with an I-frame), so
    workers>1 decodes them in a thread pool; ctypes releases the GIL for
    the native calls."""
    from ..ops.dct import _inv_weights
    from ..runtime.native import (decode_residual_to_image_exact_native,
                                  decode_to_image_exact_native,
                                  predict_frame_native)

    zz = zigzag_order(block_size)
    qf = quant.as_float(np.float64)
    wi = _inv_weights(block_size, norm)
    n_frames = len(parsed)

    def decode_gop(g0):
        frames_out = []
        ref = None
        for f in range(g0, min(g0 + gop, n_frames)):
            mv, _, (offs, dbits, counts) = parsed[f]
            if mv is None:
                ref = decode_to_image_exact_native(packed, offs, dbits,
                                                   counts, zz, block_size,
                                                   qf, wi, height, width)
            else:
                pred = predict_frame_native(ref, mv)
                if motioncomp:
                    ref = decode_residual_to_image_exact_native(
                        packed, offs, dbits, counts, zz, block_size, qf,
                        wi, pred, height, width)
                else:
                    ref = pred
            frames_out.append(ref)
        return frames_out

    gop_starts = list(range(0, n_frames, gop))
    if workers > 1 and len(gop_starts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            gop_frames = list(ex.map(decode_gop, gop_starts))
    else:
        gop_frames = [decode_gop(g0) for g0 in gop_starts]
    return [fr for g in gop_frames for fr in g]


def _parse_video_header(data: bytes, block_size: int = BLOCK_SIZE):
    """Huffman stage + header parse.  Returns (payload, quant, use_rle,
    params, width, height, first_record_bit)."""
    if not data:
        from ..utils.exceptions import StreamFormatError

        raise StreamFormatError("empty stream")
    from ..runtime.native import tune_allocator

    tune_allocator()  # host stages allocate per-frame temporaries
    # Stay in packed BYTES end-to-end (like decode_image): the 8x bit
    # array is only materialized for the small header prefix and the
    # per-frame mvec ranges; walk/extract/decode all take packed bytes.
    if data[0] & 0x80:  # Huffman flag bit (stream is MSB-first)
        from ..ops.huffman import huffman_decode

        payload, start = huffman_decode(data), 0
    else:
        payload, start = data, 1
    reader = BitReader(bitpack.to_bits(payload[:65536]), position=start)

    quant, use_rle, width, height = read_image_header(reader, block_size)
    params = read_video_params(reader)
    return payload, quant, use_rle, params, width, height, reader.position


def _iter_parsed_frames(payload, params, use_rle, width, height, pos,
                        block_size: int = BLOCK_SIZE):
    """Pass-1 record-layout walk, one frame at a time: yields
    (mv or None, start bit, (offsets, data_bits, counts)).  The walk is
    the stream's one true dependency chain (SURVEY §3.2); yielding per
    frame lets decode consumers overlap it."""
    mb = mvec_bits(params.merange)
    n_micro = (width // block_size) * (height // block_size)
    n_macro = (width // MACRO) * (height // MACRO)
    gop = max(1, params.gop)
    mv_reader = None
    try:
        # available() probes the built library: the wrapper itself raises
        # ImportError at CALL time when the lib is absent, which would
        # bypass the numpy fallback below.
        from ..runtime.native import available, read_signed_fields_native
        if available():
            mv_reader = read_signed_fields_native
    except Exception:
        pass
    for f in range(params.frame_count):
        if f % gop == 0:
            mv = None
        else:
            nb = 2 * n_macro * mb
            if mv_reader is not None:
                mv = mv_reader(payload, pos, 2 * n_macro,
                               mb).reshape(n_macro, 2)
            else:
                # Fixed-width contiguous fields: unpack their byte range.
                b0 = pos // 8
                local = np.unpackbits(np.frombuffer(
                    payload[b0:(pos + nb + 7) // 8], dtype=np.uint8))
                offs = (pos - b0 * 8) + np.arange(2 * n_macro,
                                                  dtype=np.int64) * mb
                raw = bitpack.read_fields(
                    local, offs, np.full(2 * n_macro, mb, dtype=np.int64))
                mv = shift_signed(raw, mb).reshape(n_macro, 2)
            pos = pos + nb
        start = pos
        walk = walk_block_offsets(None, pos, n_micro, use_rle,
                                  block_size=block_size, packed=payload)
        pos = walk[3]
        yield (mv, start, walk[:3])


def parse_video_stream(data: bytes, block_size: int = BLOCK_SIZE):
    """Host front half of video decode: Huffman stage, header parse and
    the serial pass-1 record-layout walk (the stream's one true
    dependency chain, SURVEY §3.2).

    Returns (payload, quant, use_rle, params, width, height, parsed)
    where parsed[f] = (mvec or None for I-frames, record start bit,
    (offsets, data_bits, counts)).  Shared by decode_video and the
    GOP-sharded decoder (parallel/video_sharding.decode_video_sharded).
    """
    (payload, quant, use_rle, params, width, height,
     pos) = _parse_video_header(data, block_size)
    parsed = list(_iter_parsed_frames(payload, params, use_rle, width,
                                      height, pos, block_size))
    return payload, quant, use_rle, params, width, height, parsed


def _assemble_yuv420(frames, width: int, height: int) -> bytes:
    """Y planes + 0x80 UV fill into ONE preallocated buffer (single copy;
    the per-frame tobytes + b"".join form copies the 1.5*W*H*F output
    twice more)."""
    y_size = width * height
    fs = y_size + y_size // 2
    out = np.empty(len(frames) * fs, np.uint8)
    ov = out.reshape(len(frames), fs)
    ov[:, y_size:] = UV_FILL
    for i, fr in enumerate(frames):
        ov[i, :y_size] = np.asarray(fr).reshape(-1)
    return out.tobytes()


def decode_video(data: bytes, motioncomp: bool = True,
                 norm: str = "reference", backend: str = "numpy",
                 workers: int = 0, block_size: int = BLOCK_SIZE):
    """Decode a video stream. Returns (yuv420 bytes, VideoParams, (w, h)).

    workers > 1 decodes GOPs in a thread pool: the stream walk is serial
    (variable-length records), but GOPs are data-independent (every GOP
    starts with an I-frame) and the heavy stages — native extraction and
    the IDCT matmuls — release the GIL.  Output is identical to serial.
    """
    # (A walk||decode overlapped pipeline was tried in round 4 and LOST on
    # this 4-core box — the decode jobs' internal OpenMP teams oversubscribe
    # against the walker thread, same lesson as the image decode pipeline —
    # so the staged fast path below stays the default.)
    (payload, quant, use_rle, params, width, height,
     parsed) = parse_video_stream(data, block_size)
    n_micro = (width // block_size) * (height // block_size)
    n_macro = (width // MACRO) * (height // MACRO)
    gop = max(1, params.gop)
    packed = payload  # shared by per-frame parsing

    if (backend == "jax" and params.frame_count > 0
            and width % MACRO == 0 and height % MACRO == 0):
        # Fused per-GOP device decode (ops/video_pipeline.py): the host
        # keeps the wire-forced serial stages (Huffman FSM + offset walk +
        # extraction); prediction gather, residual IDCT, add and clamp run
        # as one lax.scan on device.  GOP-aligned <=32-frame chunks bound
        # memory; chunks are independent (each starts with an I-frame).
        try:
            frames_u8 = _decode_video_device(
                parsed, packed, quant, gop, n_micro, n_macro, width, height,
                norm, motioncomp, block_size)
        except Exception as e:  # native extractor missing etc.
            from ..runtime.native import warn_fallback
            warn_fallback("decode_video_device", e)
        else:
            return (_assemble_yuv420(frames_u8, width, height), params,
                    (width, height))

    if (backend == "fast" and params.frame_count > 0
            and (gop == 1 or (width % MACRO == 0 and height % MACRO == 0))):
        try:
            frames_u8 = _decode_video_fast(parsed, packed, quant, gop, width,
                                           height, norm, motioncomp,
                                           block_size, workers)
        except Exception as e:  # native runtime unavailable etc.
            from ..runtime.native import warn_fallback
            warn_fallback("decode_video_fast", e)
        else:
            return (_assemble_yuv420(frames_u8, width, height), params,
                    (width, height))

    def decode_frame(f, ref):
        mv, start, _ = parsed[f]
        if mv is None:
            blocks, _ = decode_blocks(None, start, n_micro, quant,
                                      use_rle, norm=norm, backend=backend,
                                      block_size=block_size, packed=packed)
            return deblockify(blocks, height, width)
        pred = predict_image(ref, mv, height, width)
        blocks, _ = decode_blocks(None, start, n_micro, quant,
                                  use_rle, norm=norm, backend=backend,
                                  block_size=block_size, residual=True,
                                  packed=packed)
        if motioncomp:
            expanded = deblockify(blocks, height, width)
            return clamp_to_u8(pred.astype(np.float64) + expanded)
        return pred

    def decode_gop(g0):
        frames_out = []
        ref = None
        for f in range(g0, min(g0 + gop, params.frame_count)):
            ref = decode_frame(f, ref)
            frames_out.append(ref)
        return frames_out

    gop_starts = list(range(0, params.frame_count, gop))
    if workers > 1 and len(gop_starts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers) as ex:
            gop_frames = list(ex.map(decode_gop, gop_starts))
    else:
        gop_frames = []
        Logger.progress(0, len(gop_starts))
        for i, g0 in enumerate(gop_starts):
            gop_frames.append(decode_gop(g0))
            Logger.progress(i + 1, len(gop_starts))

    all_frames = [fr for g in gop_frames for fr in g]
    return (_assemble_yuv420(all_frames, width, height), params,
            (width, height))


@dataclass
class VideoEncoder:
    """Driver mirroring dc::VideoEncoder (VideoEncoder.cpp)."""

    source_file: str
    dest_file: str
    width: int
    height: int
    use_rle: bool
    quant: QuantMatrix
    gop: int
    merange: int
    use_huffman: bool = True
    backend: str = "numpy"
    ref_mode: str = "raw"
    norm: str = "reference"
    block_size: int = BLOCK_SIZE

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[VideoEncoder] Processing video...")
        self._raw_size = len(data)
        self._result = encode_video(data, self.width, self.height, self.quant,
                                    self.use_rle, self.gop, self.merange,
                                    use_huffman=self.use_huffman,
                                    norm=self.norm, backend=self.backend,
                                    ref_mode=self.ref_mode,
                                    block_size=self.block_size)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        Logger.write(f"[VideoEncoder] Encoded size: {len(self._result)} bytes"
                     f" => Ratio: {len(self._result) / self._raw_size * 100:.2f}%")


@dataclass
class VideoDecoder:
    """Driver mirroring dc::VideoDecoder (VideoDecoder.cpp)."""

    source_file: str
    dest_file: str
    motioncomp: bool = True
    backend: str = "numpy"
    workers: int = 0  # > 1: GOP-parallel decode (GOPs are independent)
    norm: str = "reference"
    block_size: int = BLOCK_SIZE

    def process(self) -> bool:
        with open(self.source_file, "rb") as f:
            data = f.read()
        Logger.write("[VideoDecoder] Processing video...")
        self._result, self._params, _ = decode_video(
            data, motioncomp=self.motioncomp, norm=self.norm,
            backend=self.backend, workers=self.workers,
            block_size=self.block_size)
        return True

    def save_result(self) -> None:
        with open(self.dest_file, "wb") as f:
            f.write(self._result)
        Logger.write(f"[VideoDecoder] Decoded size: {len(self._result)} bytes")
