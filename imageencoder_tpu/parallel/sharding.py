"""Sharded encode step over a ("frame", "block") mesh via shard_map.

This is the multi-chip replacement for the reference's OpenMP block loop
(ImageEncoder.cpp:121-146) and its sequential frame loop
(VideoEncoder.cpp:83-91):

  * a batch of frames [F, H, W] is sharded F over the "frame" axis (DP over
    frames/GOPs) and H over the "block" axis (spatial parallelism; each
    device owns a horizontal stripe of block rows),
  * each device computes its stripe's transform + quantize + RLE statistics
    entirely locally (the compute is embarrassingly parallel),
  * collectives assemble the global stream layout: per-shard payload bit
    totals are all_gather'd so every shard knows its exclusive prefix
    (= its base bit offset in the final stream); the packed steps below
    additionally psum byte histograms of the final-phase packed words —
    the distributed Huffman statistics stage (the reference builds its
    histogram serially, Huffman.cpp:236-243) — and stage 2 entropy-codes
    each shard's byte range on device.

Height striping is chosen deliberately: the wire format orders blocks
row-major over the frame (ImageBase.cpp:175-206), so the concatenation of
horizontal stripes IS the wire order — the sharded encode assembles to a
stream bit-identical to the single-device encode, no reordering pass.
(For motion search the halo is then the top/bottom merange rows of the
neighbouring stripes — a ring ppermute; see models/video.py.)
"""

from __future__ import annotations

import numpy as np

from ..ops.dct import dct_matrix
from ..ops.pipeline import (block_transform, fields_from_coeffs,
                            transform_quantize)


def make_sharded_encode_step(mesh, block_size: int = 4, use_rle: bool = True,
                             norm: str = "reference"):
    """Build the jitted sharded encode step.

    Returns f(frames u8 [F, H, W], quant f32 [B, B]) ->
        vals   int32 [F, N, K+2]   sharded (frame, block); dim 1 is already
                                   global row-major block order
        nbits  int32 [F, N, K+2]   likewise
        base   int64 [F, S]        exclusive per-(frame, stripe) bit offsets
                                   within the frame's payload region

    F must be divisible by the "frame" axis size and H/B by the "block"
    axis size.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)

    def per_shard(frames, quant):
        f_loc, h_loc, w = frames.shape
        by, bx = h_loc // b, w // b
        n_loc = by * bx
        # One transform implementation everywhere: stacking the local
        # frames vertically preserves every block row, so the whole shard
        # is a single transform_quantize call.
        coeffs_zz = transform_quantize(
            frames.reshape(f_loc * h_loc, w), quant, jnp.asarray(dct_m), b)
        vals, nbits = fields_from_coeffs(coeffs_zz, use_rle)
        vals = vals.reshape(f_loc, n_loc, -1)
        nbits = nbits.reshape(f_loc, n_loc, -1)

        # --- collective ---
        # Exclusive prefix of per-(frame, stripe) bit totals along the
        # block axis: every stripe learns its base bit offset inside its
        # frame's payload region (stripes concatenate in wire order).
        total_local = jnp.sum(nbits, axis=(1, 2), dtype=jnp.int32)  # [f_loc]
        gathered = jax.lax.all_gather(total_local, "block")  # [S, f_loc]
        idx = jax.lax.axis_index("block")
        mask = (jnp.arange(gathered.shape[0]) < idx)[:, None]
        base = jnp.sum(gathered * mask, axis=0).astype(jnp.int64)  # [f_loc]
        return vals, nbits, base[:, None]

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("frame", "block", None), P()),
        out_specs=(P("frame", "block", None), P("frame", "block", None),
                   P("frame", "block")),
        check_vma=False)
    return jax.jit(fn)


def _segment_byte_histogram(xp, words, base, nbits_seg):
    """int32[257] histogram of the FULLY-COVERED bytes of one aligned
    segment: words hold global bytes starting at 4*(base>>5); byte b is
    counted iff  base <= 8b and 8b+8 <= base+nbits_seg.  Slot 256 is
    unused padding (kept so the shape matches meta conventions)."""
    lanes = ((words[:, None]
              >> xp.array([24, 16, 8, 0], xp.uint32)[None, :])
             & xp.uint32(0xFF)).astype(xp.uint8).reshape(-1)
    gbit = (base >> 5) * 32 + xp.arange(lanes.shape[0], dtype=xp.int32) * 8
    live = (gbit >= base) & (gbit + 8 <= base + nbits_seg)
    eq = (lanes[:, None] == xp.arange(256, dtype=xp.uint8)[None, :])
    hist = xp.sum(eq & live[:, None], axis=0, dtype=xp.int32)
    return xp.concatenate([hist, xp.zeros((1,), xp.int32)])


def make_sharded_encode_packed(mesh, block_size: int = 4, use_rle: bool = True,
                               norm: str = "reference",
                               mode: str = "concat"):
    """Sharded encode that ships PACKED BITS off every device — the round-2
    replacement for field-tensor assembly (reference seam: the parallel
    compute / sequential stream split, ImageEncoder.cpp:135-146).

    Each (frame, stripe) shard packs its records on device (the scatter
    packer at bit offset 0), all_gathers the per-segment bit totals
    to learn its FINAL base offset in the stream, funnel-shifts its words
    to that bit phase, and psums a byte histogram of its fully-covered
    bytes — the distributed Huffman statistics stage (serial analogue:
    Huffman.cpp:236-243).  Host assembly is then a pure byte-OR splice of
    O(stream) bytes (assemble_packed_stream) and the Huffman code build
    consumes the psum'd histogram directly.

    mode: "concat"  — frames concatenate into one stream (video payload);
                      base offsets accumulate across frames.
          "separate" — every frame is its own stream whose payload starts
                      at start_bit (a batch of same-shape images).

    Returns jitted f(frames u8 [F, H, W], quant f32, start_bit i32) ->
        words  uint32 [F, S, WLOC]  per-segment words at final bit phase,
                                    word 0 = global word (base >> 5)
        bits   int32  [F, S]        per-segment payload bit counts
        hist   int32  [F, 257]      per-frame byte histogram of fully-
                                    covered payload bytes (psum over
                                    stripes; sum over F yourself in
                                    concat mode)
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.device_pack import local_words, pack_blocks_device

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    f_ax = mesh.shape["frame"]
    s_ax = mesh.shape["block"]
    assert mode in ("concat", "separate")

    def per_shard(frames, quant, start_bit):
        f_loc, h_loc, w = frames.shape
        by, bx = h_loc // b, w // b
        n_loc = by * bx
        k2 = b * b + 2
        lw = local_words(k2)
        wloc = n_loc * lw + 2
        # One transform implementation everywhere: stacking the local
        # frames vertically preserves every block row, so the whole shard
        # is a single transform_quantize call.
        coeffs_zz = transform_quantize(
            frames.reshape(f_loc * h_loc, w), quant, jnp.asarray(dct_m), b)
        vals, nbits = fields_from_coeffs(coeffs_zz, use_rle)
        vals = vals.reshape(f_loc, n_loc, k2)
        nbits = nbits.reshape(f_loc, n_loc, k2)

        # Per-local-frame device pack at bit 0.
        packed = []
        for i in range(f_loc):
            wd, _ = pack_blocks_device(vals[i], nbits[i], jnp.int32(0), wloc)
            packed.append(wd)
        words = jnp.stack(packed)                      # [f_loc, wloc]
        bits_local = jnp.sum(nbits, axis=(1, 2), dtype=jnp.int32)  # [f_loc]

        # Full [F, S] bit matrix via two all_gathers (a few bytes each).
        g1 = jax.lax.all_gather(bits_local, "block")   # [S, f_loc]
        g2 = jax.lax.all_gather(g1, "frame")           # [f_ax, S, f_loc]
        full = g2.transpose(0, 2, 1).reshape(f_ax * f_loc, s_ax)  # [F, S]

        fid = jax.lax.axis_index("frame")
        sid = jax.lax.axis_index("block")
        sb = jnp.asarray(start_bit, jnp.int32)
        if mode == "concat":
            flat = full.reshape(-1)
            prefix = (jnp.cumsum(flat) - flat).reshape(full.shape)
            base_f = sb + prefix                       # [F, S]
        else:
            prefix = jnp.cumsum(full, axis=1) - full   # within-frame
            base_f = sb + prefix

        my_rows = fid * f_loc + jnp.arange(f_loc)
        base = base_f[my_rows, sid]                    # [f_loc]

        # Funnel-shift each segment to its final 32-bit phase.
        s_sh = (base & 31).astype(jnp.uint32)[:, None]
        ext = jnp.concatenate(
            [words, jnp.zeros((f_loc, 1), jnp.uint32)], axis=1)
        prev = jnp.concatenate(
            [jnp.zeros((f_loc, 1), jnp.uint32), words], axis=1)
        aligned = jnp.where(
            s_sh > 0, (ext >> s_sh) | (prev << ((32 - s_sh) % 32)), ext)

        # Per-frame byte histogram of fully-covered bytes (psum stripes).
        hists = []
        for i in range(f_loc):
            hists.append(_segment_byte_histogram(
                jnp, aligned[i], base[i], bits_local[i]))
        hist = jax.lax.psum(jnp.stack(hists), "block")  # [f_loc, 257]

        return aligned[:, None, :], bits_local[:, None], hist

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("frame", "block", None), P(), P()),
        out_specs=(P("frame", "block", None), P("frame", "block"),
                   P("frame", None)),
        check_vma=False)
    return jax.jit(fn)


def make_sharded_huffman_pack(mesh, mode: str = "concat"):
    """Stage-2 distributed entropy coding: every shard Huffman-encodes ITS
    OWN byte range of the inner stream with the shared canonical code
    table and packs the codes on device — the multi-chip equivalent of the
    reference's serial per-byte re-encode loop (Huffman.cpp:314-319).

    Byte ownership: segment g owns inner bytes [ceil(base_g/8),
    ceil(end_g/8)) — a partition; its last byte may straddle into the next
    segment, so the host passes back the fully-merged boundary WORD
    (computed from tiny first/tail word extracts) and the shard ORs it in
    before extracting bytes.  Code bits then concatenate in byte order,
    which is exactly the serial payload — the final splice is the same
    byte-OR as stage 1.

    Returns jitted f(words [F,S,WLOC] u32 (stage-1 aligned segments,
    sharded), bits [F,S] i32 (sharded), bnd [F,S] u32 (replicated merged
    end-boundary words), code_w u32 [F,256], code_l i32 [F,256]
    (replicated; row 0 used for every frame in concat mode),
    inner_start i32, prefix_bits i32 [F] (output-side prefix: dict +
    header-byte codes; row 0 used in concat mode)) ->
        out_words [F, S, W2] u32 (aligned compressed segments)
        out_bits  [F, S] i32
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.device_pack import pack_blocks_device

    f_ax = mesh.shape["frame"]
    s_ax = mesh.shape["block"]
    assert mode in ("concat", "separate")

    def full_matrix(local, axis_names=("block", "frame")):
        g1 = jax.lax.all_gather(local, "block")        # [S, f_loc]
        g2 = jax.lax.all_gather(g1, "frame")           # [f_ax, S, f_loc]
        return g2.transpose(0, 2, 1).reshape(-1, s_ax)  # [F, S]

    def bases_from(full, start):
        if mode == "concat":
            flat = full.reshape(-1)
            return (start + jnp.cumsum(flat) - flat).reshape(full.shape)
        return start[:, None] + jnp.cumsum(full, axis=1) - full

    def per_shard(words, bits, bnd, code_w, code_l, inner_start,
                  prefix_bits):
        f_loc = words.shape[0]
        wloc = words.shape[2]
        nbytes_loc = wloc * 4
        fid = jax.lax.axis_index("frame")
        sid = jax.lax.axis_index("block")
        my_rows = fid * f_loc + jnp.arange(f_loc)

        full = full_matrix(bits[:, 0])
        if mode == "concat":
            base_f = bases_from(full, jnp.asarray(inner_start, jnp.int32))
        else:
            base_f = bases_from(full, jnp.full((full.shape[0],),
                                               inner_start, jnp.int32))
        base = base_f[my_rows, sid]                    # [f_loc]
        seg_len = bits[:, 0]
        end = base + seg_len

        out_words_l, out_bits_l = [], []
        for i in range(f_loc):
            w = words[i, 0]
            # OR in the fully-merged boundary word at the segment's end.
            idx_end = (end[i] >> 5) - (base[i] >> 5)
            col = jax.lax.broadcasted_iota(jnp.int32, (wloc,), 0)
            w = w | jnp.where(col == idx_end, bnd[my_rows[i], sid],
                              jnp.uint32(0))
            # Bytes + ownership mask.
            sh = jnp.array([24, 16, 8, 0], jnp.uint32)
            byts = ((w[:, None] >> sh[None, :]) & jnp.uint32(0xFF)) \
                .astype(jnp.int32).reshape(-1)          # [wloc*4]
            gb = (base[i] >> 5) * 4 + jnp.arange(nbytes_loc, dtype=jnp.int32)
            owned = (gb >= ((base[i] + 7) >> 3)) & (gb < ((end[i] + 7) >> 3))
            frame_row = my_rows[i] if mode == "separate" else 0
            lens = jnp.where(owned, code_l[frame_row][byts], 0)
            vals = code_w[frame_row][byts].astype(jnp.int32)
            out_w, total = pack_blocks_device(
                vals[:, None], lens[:, None], jnp.int32(0),
                (nbytes_loc * 15) // 32 + 2)
            out_words_l.append(out_w)
            out_bits_l.append(jnp.sum(lens, dtype=jnp.int32))
        out_words = jnp.stack(out_words_l)
        out_bits = jnp.stack(out_bits_l)

        # Output-side placement: prefix + exclusive cumsum, then align.
        out_full = full_matrix(out_bits)
        if mode == "concat":
            out_base_f = bases_from(out_full, prefix_bits[0])
        else:
            out_base_f = bases_from(out_full, prefix_bits)
        out_base = out_base_f[my_rows, sid]

        s_sh = (out_base & 31).astype(jnp.uint32)[:, None]
        ext = jnp.concatenate(
            [out_words, jnp.zeros((f_loc, 1), jnp.uint32)], axis=1)
        prev = jnp.concatenate(
            [jnp.zeros((f_loc, 1), jnp.uint32), out_words], axis=1)
        aligned = jnp.where(
            s_sh > 0, (ext >> s_sh) | (prev << ((32 - s_sh) % 32)), ext)
        return aligned[:, None, :], out_bits[:, None]

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("frame", "block", None), P("frame", "block"),
                  P(), P(), P(), P(), P()),
        out_specs=(P("frame", "block", None), P("frame", "block")),
        check_vma=False)
    return jax.jit(fn)


def _merged_boundary_words(words, bits, base_np, header: bytes,
                           streams: np.ndarray):
    """Host side: the fully-merged value of every segment-junction WORD,
    from two tiny device extracts (first + tail word per segment).

    ``streams[g]`` names the stream each segment belongs to (0 in concat
    mode, the frame index in separate mode — word indices collide across
    streams otherwise).  Returns (bnd [n_seg] uint32 — merged word at
    each segment's END word index — and a {(stream, word idx): uint32}
    map covering the header and every junction word, for reconstructing
    uncovered byte values)."""
    import jax.numpy as jnp

    f, s, wloc = words.shape
    flat_words = words.reshape(f * s, wloc)
    base = base_np.reshape(-1)
    lens = np.asarray(bits, dtype=np.int64).reshape(-1)
    end = base + lens
    idx_end = ((end >> 5) - (base >> 5)).astype(np.int32)
    fw = np.asarray(flat_words[:, 0])
    tw = np.asarray(jnp.take_along_axis(
        flat_words, jnp.asarray(idx_end)[:, None], axis=1))[:, 0]

    acc: dict[tuple[int, int], int] = {}
    for st in sorted(set(int(x) for x in streams)):
        for p in range(0, len(header), 4):
            wv = int.from_bytes(header[p:p + 4].ljust(4, b"\x00"), "big")
            acc[st, p // 4] = acc.get((st, p // 4), 0) | wv
    for g in range(len(base)):
        st = int(streams[g])
        kb, ke = (st, int(base[g]) >> 5), (st, int(end[g]) >> 5)
        acc[kb] = acc.get(kb, 0) | int(fw[g])
        acc[ke] = acc.get(ke, 0) | int(tw[g])
    bnd = np.array([acc.get((int(streams[g]), int(end[g]) >> 5), 0)
                    for g in range(len(base))], dtype=np.uint32)
    return bnd, acc


def _acc_byte(acc: dict, st: int, b: int) -> int:
    return (acc.get((st, b >> 2), 0) >> (24 - 8 * (b & 3))) & 0xFF


def encode_sharded_huffman(words, bits, hist, start_bit: int, header: bytes,
                           mesh, mode: str = "concat"):
    """Finish a stage-1 sharded encode with DISTRIBUTED entropy coding.

    The inner stream never materializes on the host: the exact byte
    histogram = psum'd device interiors + host-reconstructed boundary
    bytes (from tiny word extracts), the canonical codes build on host
    (256 symbols), and every shard re-encodes and packs its own byte
    range on device (make_sharded_huffman_pack).  The host splices only
    COMPRESSED bytes.  Output is byte-identical to
    huffman_encode(assembled inner stream).

    Returns bytes (concat) or a list of per-frame bytes (separate).
    """
    import jax.numpy as jnp

    from ..ops.bitpack import BitWriter
    from ..ops.huffman import _dict_and_codes, _fallback

    f, s, wloc = words.shape
    bits_np = np.asarray(bits, dtype=np.int64)
    n_streams = f if mode == "separate" else 1

    # Reconstruct per-stream base offsets (the same cumsum as on device).
    if mode == "concat":
        flat = bits_np.reshape(-1)
        base_np = (start_bit + np.cumsum(flat) - flat).reshape(f, s)
        check_int32_bit_capacity(start_bit + flat.sum())
    else:
        base_np = (start_bit + np.cumsum(bits_np, axis=1) - bits_np)
        check_int32_bit_capacity(start_bit + bits_np.sum(axis=1).max(initial=0))

    streams = (np.zeros(f * s, np.int64) if mode == "concat"
               else np.repeat(np.arange(f), s))
    bnd, acc = _merged_boundary_words(words, bits_np, base_np, header,
                                      streams)
    hist_np = np.asarray(hist)[:, :256].astype(np.int64)

    code_w = np.zeros((f, 256), np.uint32)
    code_l = np.zeros((f, 256), np.int32)
    prefix_bits = np.zeros(f, np.int32)
    prefix_streams: list[bytes | None] = [None] * f
    fallbacks: list[bytes | None] = [None] * n_streams

    for st in range(n_streams):
        frames_of = range(f) if mode == "concat" else [st]
        seg_ids = [fi * s + si for fi in frames_of for si in range(s)]
        total = int(start_bit + bits_np.reshape(-1)[seg_ids].sum())
        # Exact histogram: device interiors + uncovered bytes.
        freqs = hist_np[list(frames_of)].sum(axis=0)
        covered = np.zeros((total + 7) // 8 + 1, dtype=bool)
        for g in seg_ids:
            b0 = -(-int(base_np.reshape(-1)[g]) // 8)
            b1 = (int(base_np.reshape(-1)[g] + bits_np.reshape(-1)[g])) // 8
            if b1 > b0:
                covered[b0:b1] = True
        unc = np.nonzero(~covered[:(total + 7) // 8])[0]
        vals_unc = np.array([_acc_byte(acc, st if mode == "separate" else 0,
                                       int(b)) for b in unc],
                            dtype=np.int64)
        freqs = freqs + np.bincount(vals_unc, minlength=256)

        built = _dict_and_codes(freqs)
        inner_bytes = (total + 7) // 8
        if built is not None:
            w, cw, cl = built
            out_total = w.position + int(freqs @ cl.astype(np.int64))
        if built is None or inner_bytes < (out_total + 7) // 8:
            # Fallback [0][raw]: the degenerate path pulls the inner
            # stream (rare by construction — incompressible content).
            inner = assemble_packed_stream(
                np.asarray(words), bits_np, start_bit, header,
                mode="concat" if mode == "concat" else "separate")
            if mode == "concat":
                fallbacks[0] = _fallback(inner[0])
            else:
                fallbacks[st] = _fallback(inner[st][0])
            continue

        # Prefix: dict + codes of the header-region bytes [0, ceil(sb/8)).
        pw = BitWriter()
        pw.values.extend(w.values)
        pw.nbits.extend(w.nbits)  # position derives from nbits
        hdr_bytes = -(-start_bit // 8)
        for p in range(hdr_bytes):
            v = _acc_byte(acc, st if mode == "separate" else 0, p)
            pw.put(int(cl[v]), int(cw[v]))
        for fi in frames_of:
            code_w[fi] = cw
            code_l[fi] = cl
            prefix_bits[fi] = pw.position
            prefix_streams[fi] = pw.getvalue()

    step = make_sharded_huffman_pack(mesh, mode)
    out_words, out_bits = step(
        words, bits, jnp.asarray(bnd.reshape(f, s)),
        jnp.asarray(code_w), jnp.asarray(code_l),
        np.int32(start_bit), jnp.asarray(prefix_bits))

    if mode == "concat":
        if fallbacks[0] is not None:
            return fallbacks[0]
        out, _ = assemble_packed_stream(out_words, out_bits,
                                        int(prefix_bits[0]),
                                        prefix_streams[0], mode="concat")
        return out
    result = []
    for st in range(f):
        if fallbacks[st] is not None:
            result.append(fallbacks[st])
            continue
        # Per-frame prefix differs; re-splice frame st with its prefix.
        seg, _ = _splice_one(np.asarray(out_words)[st],
                             np.asarray(out_bits)[st],
                             int(prefix_bits[st]), prefix_streams[st])
        result.append(seg)
    return result


def _splice_one(words_row, bits_row, start_bit: int, header: bytes):
    """Byte-OR splice of one frame's aligned segments (helper for the
    separate-mode stage-2 assembly)."""
    bits_row = np.asarray(bits_row, dtype=np.int64)
    s = words_row.shape[0]
    total = int(start_bit + bits_row.sum())
    out = np.zeros((total + 7) // 8 + 4, dtype=np.uint8)
    out[:len(header)] = np.frombuffer(header, dtype=np.uint8)
    base = start_bit
    for si in range(s):
        nb = int(bits_row[si])
        if nb:
            seg = words_row[si].astype(">u4").view(np.uint8)
            b0 = (base >> 5) * 4
            n = ((base & 31) + nb + 7) // 8
            out[b0:b0 + n] |= seg[:n]
        base += nb
    return out[:(total + 7) // 8].tobytes(), total


def check_int32_bit_capacity(total_bits: int) -> None:
    """The device-side segment placement (base offsets, funnel phases,
    histograms) runs in int32 — jax x64 is disabled, so there is no wider
    path on chip.  A stream whose inner payload reaches 2**31 bits
    (~256 MB) would silently wrap and corrupt segment placement; refuse it
    loudly instead.  Long videos avoid this by GOP-chunked encoding
    (models/video.py splices per-chunk streams on host)."""
    if int(total_bits) >= 2**31:
        raise ValueError(
            f"sharded stream payload is {int(total_bits)} bits, beyond the "
            "int32 device offset capacity (2**31); encode in GOP/segment "
            "chunks and splice on host instead")


def assemble_packed_stream(words, bits, start_bit: int, header: bytes,
                           mode: str = "concat"):
    """Splice aligned per-segment words into inner stream bytes (host side).

    words: [F, S, WLOC] uint32 (final bit phase); bits: [F, S] payload bit
    counts; header: the host-built stream header occupying [0, start_bit).

    Returns (inner bytes, total_bits) in concat mode, or a list of
    per-frame (inner, total_bits) in separate mode.  Cost is O(stream
    bytes) — the field tensors never reach the host.
    """
    words = np.asarray(words)
    bits = np.asarray(bits, dtype=np.int64)
    f, s, wloc = words.shape

    def splice(frames_idx):
        total = int(start_bit + bits[frames_idx].sum())
        check_int32_bit_capacity(total)
        out = np.zeros((total + 7) // 8 + 4, dtype=np.uint8)
        out[:len(header)] = np.frombuffer(header, dtype=np.uint8)
        base = start_bit
        for fi in frames_idx:
            for si in range(s):
                nb = int(bits[fi, si])
                if nb:
                    seg = words[fi, si].astype(">u4").view(np.uint8)
                    b0 = (base >> 5) * 4
                    n = ((base & 31) + nb + 7) // 8
                    out[b0:b0 + n] |= seg[:n]
                base += nb
        return out[:(total + 7) // 8].tobytes(), total

    if mode == "concat":
        return splice(range(f))
    return [splice([fi]) for fi in range(f)]


def boundary_byte_histogram(inner: bytes, bits, start_bit: int) -> np.ndarray:
    """Histogram of the bytes NOT covered by the device-side psum: the
    header region, each segment-boundary partial byte, and the tail.
    device_hist + this == np.bincount(inner) exactly."""
    bits = np.asarray(bits, dtype=np.int64).reshape(-1)
    data = np.frombuffer(inner, dtype=np.uint8)
    covered = np.zeros(len(data) + 1, dtype=bool)
    base = start_bit
    for nb in bits:
        lo = -(-base // 8)
        hi = (base + int(nb)) // 8
        if hi > lo:
            covered[lo:hi] = True
        base += int(nb)
    idx = np.nonzero(~covered[:len(data)])[0]
    return np.bincount(data[idx], minlength=256).astype(np.int64)


def encode_sharded_image_batch(frames, quant, mesh, use_rle: bool = True,
                               use_huffman: bool = True,
                               norm: str = "reference",
                               block_size: int = 4,
                               device_entropy: bool = False) -> list[bytes]:
    """Batch of same-shape images, sharded over the mesh, each returning
    its own wire stream — byte-identical to encode_image(backend="jax")
    up to documented f32 rounding-tie coefficients (identical to the
    sharded fields path bit-for-bit).
    """
    from ..models.headers import write_image_header
    from ..ops.bitpack import BitWriter
    from ..ops.huffman import huffman_encode_with_hist
    from ..utils.quant import QuantMatrix

    frames = np.asarray(frames)
    f, h, w = frames.shape
    qm = quant if isinstance(quant, QuantMatrix) else QuantMatrix(
        np.asarray(quant))
    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, qm, use_rle, w, h)
    header = writer.getvalue()

    step = make_sharded_encode_packed(mesh, block_size, use_rle, norm,
                                      mode="separate")
    import jax.numpy as jnp

    words, bits, hist = step(jnp.asarray(frames),
                             jnp.asarray(qm.as_float(np.float32)),
                             np.int32(writer.position))
    if use_huffman and device_entropy:
        # Stage-2 distributed entropy coding: every shard re-encodes its
        # own byte range on device; the host splices only compressed
        # bytes (make_sharded_huffman_pack).
        return encode_sharded_huffman(words, bits, hist, writer.position,
                                      header, mesh, mode="separate")
    parts = assemble_packed_stream(words, bits, writer.position, header,
                                   mode="separate")
    out = []
    for fi, (inner, _) in enumerate(parts):
        if use_huffman:
            freqs = (np.asarray(hist)[fi][:256].astype(np.int64)
                     + boundary_byte_histogram(inner, bits[fi],
                                               writer.position))
            out.append(huffman_encode_with_hist(inner, freqs))
        else:
            out.append(inner)
    return out


def make_sharded_image_decode(mesh, h: int, w: int, block_size: int = 4,
                              norm: str = "reference"):
    """Mesh-parallel image-decode back end — the decode mirror of the
    sharded encode steps above (sharded VIDEO decode landed in
    video_sharding.py; this closes the image side).

    The wire format forces the Huffman FSM, offset walk and field
    extraction to stay host-side (block N's stream position depends on
    every previous block's width, ImageDecoder.cpp:88-113), but the
    heavy inverse half — dequantize, IDCT, +128 restore, clamp,
    deblockify (ImageDecoder.cpp:55-87) — is embarrassingly parallel
    over blocks.  Block ROWS are sharded over the FLATTENED
    (frame, block) mesh (a single image has no frame axis to occupy, so
    both axes gang on spatial stripes); each device reconstructs one
    horizontal stripe, and because the wire order is row-major the
    out-spec concatenation reassembles [h, w] without any collective.

    f(coeffs i32 [N, B, B] row-major, quant f32 [B, B]) -> image u8
    [h, w].  h/B must divide by the mesh size (the driver below pads).
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    bx = w // b

    def per_shard(coeffs, quant):
        rows = coeffs.shape[0] // bx
        d = jnp.asarray(dct_m)
        y = coeffs.astype(jnp.float32) * quant.astype(jnp.float32)
        x = block_transform(y, d, inverse=True) + jnp.float32(128.0)
        px = jnp.floor(jnp.clip(x, 0.0, 255.0)).astype(jnp.uint8)
        return px.reshape(rows, bx, b, b).swapaxes(1, 2).reshape(rows * b, w)

    fn = shard_map(per_shard, mesh=mesh,
                   in_specs=(P(("frame", "block")), P()),
                   out_specs=P(("frame", "block")),
                   check_vma=False)
    return jax.jit(fn)


def decode_image_sharded(data: bytes, mesh, norm: str = "reference",
                         block_size: int = 4) -> np.ndarray:
    """Decode one wire stream across every chip of the mesh.

    Host serial stages (Huffman FSM + offset walk + extraction, the
    stages the bit-serial wire format forces) feed the sharded device
    inverse half (make_sharded_image_decode).  Same f32 rounding-tie
    class as decode_image(backend="jax") — and bit-identical to it,
    since the per-block transform is unchanged by stripe batching.
    """
    import jax.numpy as jnp

    from ..models.headers import read_image_header
    from ..models.image import extract_block_coeffs
    from ..ops.bitpack import BitReader
    from ..ops.huffman import huffman_decode

    if data[0] & 0x80:
        payload, start = huffman_decode(data), 0
    else:
        payload, start = data, 1
    reader = BitReader(payload[:65536], position=start)
    quant, use_rle, w, h = read_image_header(reader, block_size)
    b = block_size
    by, bx = h // b, w // b
    coeffs, _ = extract_block_coeffs(None, reader.position, by * bx,
                                     use_rle, b, packed=payload)
    nd = mesh.devices.size
    rows_pad = -(-by // nd) * nd
    if rows_pad != by:  # zero blocks decode to gray padding, sliced off
        pad = np.zeros(((rows_pad - by) * bx, b, b), coeffs.dtype)
        coeffs = np.concatenate([coeffs, pad], axis=0)
    step = make_sharded_image_decode(mesh, rows_pad * b, w, b, norm)
    img = np.asarray(step(jnp.asarray(coeffs, jnp.int32),
                          jnp.asarray(quant.as_float(np.float32))))
    return img[:h]
