"""Sharded video encode step: motion search + residual fields over a
("frame", "block") mesh with genuine device collectives.

Data layout: frames [F, H, W] with F sharded over "frame" (contiguous
chunks) and H sharded over "block" (height stripes, multiples of 16).

Collectives per step (raw-reference mode, the shipped binaries' semantics):

  1. reference-frame pass: ref[f] = frames[f-1].  Inside a chunk that's a
     local shift; the chunk's first frame needs the PREVIOUS device's last
     frame — one ppermute along "frame" (ring, one frame of pixels).
  2. halo exchange: a stripe's motion search probes reference rows up to
     merange-1 beyond its boundary (2D-log offsets sum to merange-1 <
     merange), so each device receives the merange boundary rows of its
     up/down neighbours — two ppermutes along "block".  This is the
     context/ring-parallel analogue SURVEY §5 calls for.
  3. all_gather of per-stripe payload bit totals (stream assembly
     offsets); the packed step below additionally psums a byte histogram
     of the final-phase packed words — the distributed Huffman statistics
     stage (serial analogue: Huffman.cpp:236-243).

The motion arithmetic is identical to ops/motion.py (tie-breaks, clamping,
skip rule) — only indexing moves to stripe-local coordinates.  Outputs are
bit-identical to the single-device path (test_video_sharded.py).
"""

from __future__ import annotations

import numpy as np

from ..ops import bitpack
from ..ops.bitpack import BitWriter
from ..ops.dct import dct_matrix
from ..ops.motion import MACRO, MER_SIGNS, search_steps
from ..ops.pipeline import block_transform, fields_from_coeffs
from ..ops.sad_maps import sad_maps
from ..ops.zigzag import zigzag_order


def assemble_sharded_video(mvals, bnbits, bvals, width: int, height: int,
                           quant, use_rle: bool, gop: int, merange: int,
                           use_huffman: bool = True) -> bytes:
    """Wire stream from make_sharded_video_step outputs (host side).

    Height striping means the sharded tensors are already in global
    row-major block order, so assembly is the standard field flattening:
    header, then per frame [mvec fields (P only)][block fields].  Output is
    byte-identical to models.video.encode_video(backend="jax").
    """
    from ..models.headers import (VideoParams, write_image_header,
                                  write_video_params)
    from ..models.video import mvec_bits

    mvals = np.asarray(mvals)
    bvals = np.asarray(bvals)
    bnbits = np.asarray(bnbits)
    f = bvals.shape[0]
    mb = mvec_bits(merange)

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, width, height)
    write_video_params(writer, VideoParams(f, max(1, gop), merange))

    field_vals = [np.asarray(writer.values, dtype=np.int64)]
    field_nbits = [np.asarray(writer.nbits, dtype=np.int64)]
    for fi in range(f):
        if fi % max(1, gop) != 0:
            mv = mvals[fi].astype(np.int64).reshape(-1)  # (x, y) interleaved
            field_vals.append(mv)
            field_nbits.append(np.full(mv.shape[0], mb, dtype=np.int64))
        field_vals.append(bvals[fi].astype(np.int64).reshape(-1))
        field_nbits.append(bnbits[fi].astype(np.int64).reshape(-1))

    inner, _ = bitpack.pack_fields(np.concatenate(field_vals),
                                   np.concatenate(field_nbits))
    if use_huffman:
        from ..ops.huffman import huffman_encode

        return huffman_encode(inner)
    return inner


def make_sharded_video_step(mesh, gop: int, merange: int, mvec_nbits: int,
                            block_size: int = 4, use_rle: bool = True,
                            norm: str = "reference"):
    """Build the jitted sharded step.

    f(frames u8 [F, H, W], quant f32) ->
        mvals  int32 [F, Nmb, 2]     motion-vector field values (I rows 0)
        bvals  int32 [F, Nmicro, K+2] block field values (wire order)
        bnbits int32 [F, Nmicro, K+2]
        base   int64 [F, S]          per-(frame, stripe) micro-payload bit
                                     totals, all_gather'd (exclusive prefix
                                     is host-side trivial)

    Constraints: F % frame_axis == 0, (H / 16) % block_axis == 0, and every
    device chunk must hold at least 1 frame.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    b = block_size
    k = b * b
    m = int(merange)
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    zz = zigzag_order(b)
    f_ax = mesh.shape["frame"]
    s_ax = mesh.shape["block"]

    def per_shard(frames, quant):
        f_loc, h_loc, w = frames.shape
        assert h_loc >= m, (
            f"stripe height {h_loc} < merange {m}: motion offsets would "
            f"reach past the immediate neighbour's halo; use fewer stripes")
        sid = jax.lax.axis_index("block")
        fid = jax.lax.axis_index("frame")
        h_glob = h_loc * s_ax
        row0 = sid * h_loc  # global row of this stripe's first row
        f0 = fid * f_loc    # global index of this chunk's first frame

        # (1) reference frames: shift by one within the chunk; fetch the
        # previous chunk's last frame over the ring.
        last = frames[-1]
        prev_last = jax.lax.ppermute(
            last, "frame", [(i, (i + 1) % f_ax) for i in range(f_ax)])
        ref = jnp.concatenate([prev_last[None], frames[:-1]], axis=0)

        # (2) halo exchange along the stripe axis (on the reference frames).
        halo = min(m, h_loc)
        top = ref[:, :halo]      # my top rows -> neighbour below's up-halo
        bot = ref[:, -halo:]     # my bottom rows -> neighbour above's halo
        from_above = jax.lax.ppermute(
            bot, "block", [(i, i + 1) for i in range(s_ax - 1)])
        from_below = jax.lax.ppermute(
            top, "block", [(i, i - 1) for i in range(1, s_ax)])
        ref_h = jnp.concatenate([from_above, ref, from_below], axis=1)
        # ref_h rows cover global [row0 - halo, row0 + h_loc + halo)

        # (3) motion search, stripe-local macro grid with global clamping.
        nby, nbx = h_loc // MACRO, w // MACRO
        n_mb = nby * nbx
        by_l = (np.repeat(np.arange(nby), nbx) * MACRO).astype(np.int32)
        bx_l = (np.tile(np.arange(nbx), nby) * MACRO).astype(np.int32)
        by = jnp.asarray(by_l)[None, :] + row0  # global row coords [1,Nmb]
        bx = jnp.asarray(bx_l)[None, :]
        by = jnp.broadcast_to(by, (f_loc, n_mb))
        bx = jnp.broadcast_to(bx, (f_loc, n_mb))
        r = jnp.arange(MACRO)

        def ref_windows(py_g, px):
            # global row -> ref_h local row
            py_l = py_g - row0 + halo
            return ref_h[jnp.arange(f_loc)[:, None, None, None],
                         py_l[:, :, None, None] + r[None, None, :, None],
                         px[:, :, None, None] + r[None, None, None, :]]

        # Gather-free SAD-map search (see ops/video_pipeline.sad_motion_search):
        # the halo provides the +-(m-1) reference rows the stripe's
        # translation maps need, so the per-stripe maps are the
        # single-device ones with ref_h's halo rows in place of zero rows.
        off = jnp.zeros((f_loc, n_mb, 2), dtype=jnp.int32)
        if m >= 2:
            p_h = m - 1
            d_span = 2 * p_h + 1
            s = sad_maps(frames, ref_h, m, halo).reshape(
                d_span, d_span, f_loc, n_mb)

            fidx = jnp.arange(f_loc, dtype=jnp.int32)[:, None]
            bidx = jnp.arange(n_mb, dtype=jnp.int32)[None, :]

            def lookup(cand):
                dx_eff = jnp.clip(bx + cand[:, :, 0], 0, w - MACRO) - bx
                dy_eff = jnp.clip(by + cand[:, :, 1], 0, h_glob - MACRO) - by
                sad = s[dy_eff + p_h, dx_eff + p_h, fidx, bidx]
                return sad, (dx_eff == 0) & (dy_eff == 0)

            best = jnp.full((f_loc, n_mb), jnp.iinfo(jnp.int32).max,
                            jnp.int32)
            for step in search_steps(m):
                running = best
                sel = off
                for p in range(len(MER_SIGNS)):
                    sx, sy = int(MER_SIGNS[p, 0]), int(MER_SIGNS[p, 1])
                    cand = off + jnp.array([sx * step, sy * step], jnp.int32)
                    diff, at_self = lookup(cand)
                    skip = at_self if p > 0 else jnp.zeros_like(at_self)
                    acc = (~skip) & (diff <= running)
                    running = jnp.where(acc, diff, running)
                    sel = jnp.where(acc[:, :, None], cand, sel)
                off = sel
                best = running

        px = jnp.clip(bx + off[:, :, 0], 0, w - MACRO)
        py = jnp.clip(by + off[:, :, 1], 0, h_glob - MACRO)
        win = ref_windows(py, px)
        pred = win.reshape(f_loc, nby, nbx, MACRO, MACRO) \
                  .swapaxes(2, 3).reshape(f_loc, h_loc, w)

        # (4) transform + fields for this stripe's 4x4 blocks.
        is_i_np = np.array([(f0_i % gop) == 0 for f0_i in range(f_ax * f_loc)])
        # per-chunk static slice of the I-frame mask
        is_i = jax.lax.dynamic_slice(jnp.asarray(is_i_np), (f0,), (f_loc,))
        x = jnp.where(is_i[:, None, None], frames.astype(jnp.float32),
                      frames.astype(jnp.float32) - pred.astype(jnp.float32))
        mby, mbx = h_loc // b, w // b
        n_micro = mby * mbx
        from ..ops.pipeline import transform_quantize

        coeffs_zz = transform_quantize(x.reshape(f_loc * h_loc, w), quant,
                                       jnp.asarray(dct_m), b)
        bvals, bnbits = fields_from_coeffs(coeffs_zz, use_rle)
        bvals = bvals.reshape(f_loc, n_micro, k + 2)
        bnbits = bnbits.reshape(f_loc, n_micro, k + 2)

        mask = (1 << mvec_nbits) - 1
        mvals = jnp.where(is_i[:, None, None], 0, off & mask)

        # (5) stream-assembly collectives: per-(frame, stripe) micro bit
        # totals (all_gather over "block") and the global width histogram.
        total_local = jnp.sum(bnbits, axis=(1, 2), dtype=jnp.int32)
        gathered = jax.lax.all_gather(total_local, "block")  # [S, f_loc]
        base = gathered.T.astype(jnp.int64)  # [f_loc, S] totals per stripe

        return mvals, bvals, bnbits, base

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("frame", "block", None), P()),
        out_specs=(P("frame", "block", None),
                   P("frame", "block", None), P("frame", "block", None),
                   P("frame", None)),
        check_vma=False)
    import jax

    return jax.jit(fn)


def make_sharded_video_packed(mesh, gop: int, merange: int, mvec_nbits: int,
                              block_size: int = 4, use_rle: bool = True,
                              norm: str = "reference", ref_mode: str = "raw"):
    """Sharded video encode that ships PACKED BITS off every device.

    The round-2 canonical multi-chip video path: each (frame-chunk, stripe)
    shard runs the halo-exchange motion search, packs its motion-vector
    and residual-block segments on device (scatter packer at bit offset
    0), all_gathers per-segment bit totals to learn its FINAL base
    offsets, funnel-shifts its words to that phase, and psums a byte
    histogram of its fully-covered bytes (the distributed Huffman
    statistics stage; serial analogue Huffman.cpp:236-243).  Host assembly
    (assemble_sharded_video_packed) is then a byte-OR splice of O(stream)
    bytes.

    ref_mode "raw": P-frames reference the previous RAW frame (shipped-
    binary semantics; the cross-chunk reference is one ppermute).
    ref_mode "recon": P-frames reference the previous frame's
    reconstruction (shipped-source semantics, Frame.cpp:210-242) — the
    carry rides a lax.scan whose halo exchange runs per step; frame chunks
    must align with GOP boundaries (F / frame_axis % gop == 0) so no
    reconstruction dependency crosses devices (GOPs are independent).

    Returns jitted f(frames u8 [F, H, W], quant f32, start_bit i32) ->
        mvw      uint32 [F, S, WMV]   aligned motion-vector segment words
        blw      uint32 [F, S, WBLK]  aligned residual-block segment words
        blk_bits int32  [F, S]        per-segment block-payload bit counts
                                      (mv bits are static: P * Nmb * 2*mb)
        hist     int32  [F, 257]      per-frame fully-covered-byte
                                      histogram (psum over stripes)
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.device_pack import local_words, pack_blocks_device
    from .sharding import _segment_byte_histogram

    b = block_size
    k = b * b
    m = int(merange)
    mb = int(mvec_nbits)
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    f_ax = mesh.shape["frame"]
    s_ax = mesh.shape["block"]
    gop = max(1, gop)

    def per_shard(frames, quant, start_bit):
        f_loc, h_loc, w = frames.shape
        assert h_loc >= m, (
            f"stripe height {h_loc} < merange {m}; use fewer stripes")
        if ref_mode == "recon":
            assert f_loc % gop == 0, (
                f"recon mode needs GOP-aligned frame chunks: "
                f"{f_loc} frames/chunk vs gop {gop}")
        sid = jax.lax.axis_index("block")
        fid = jax.lax.axis_index("frame")
        h_glob = h_loc * s_ax
        row0 = sid * h_loc
        f0 = fid * f_loc
        halo = min(m, h_loc)
        nby, nbx = h_loc // MACRO, w // MACRO
        n_mb = nby * nbx
        mby, mbx = h_loc // b, w // b
        n_micro = mby * mbx
        qf = quant.astype(jnp.float32)
        d = jnp.asarray(dct_m)

        # Global I-frame mask for this chunk's frames.
        is_i_all = np.array([(i % gop) == 0 for i in range(f_ax * f_loc)])
        is_i = jax.lax.dynamic_slice(jnp.asarray(is_i_all), (f0,), (f_loc,))

        by_l = (np.repeat(np.arange(nby), nbx) * MACRO).astype(np.int32)
        bx_l = (np.tile(np.arange(nbx), nby) * MACRO).astype(np.int32)
        by_g = jnp.asarray(by_l) + row0 * jnp.int32(1)  # global rows [n_mb]
        bx_g = jnp.asarray(bx_l)
        r = jnp.arange(MACRO)
        p_h = m - 1
        d_span = 2 * p_h + 1

        def one_frame(ref_stripe, cur, i_frame):
            """Motion + residual fields for ONE frame given the reference
            stripe (raw or recon).  Returns (off, vals, nbits, recon)."""
            # halo exchange of the reference stripe borders (ring ppermute)
            top = ref_stripe[:halo]
            bot = ref_stripe[-halo:]
            from_above = jax.lax.ppermute(
                bot, "block", [(i, i + 1) for i in range(s_ax - 1)])
            from_below = jax.lax.ppermute(
                top, "block", [(i, i - 1) for i in range(1, s_ax)])
            ref_h = jnp.concatenate([from_above, ref_stripe, from_below],
                                    axis=0)

            off = jnp.zeros((n_mb, 2), dtype=jnp.int32)
            if m >= 2:
                smap = sad_maps(cur[None], ref_h[None], m, halo).reshape(
                    d_span, d_span, n_mb)
                bidx = jnp.arange(n_mb, dtype=jnp.int32)

                def lookup(cand):
                    dx_eff = jnp.clip(bx_g + cand[:, 0], 0, w - MACRO) - bx_g
                    dy_eff = (jnp.clip(by_g + cand[:, 1], 0, h_glob - MACRO)
                              - by_g)
                    sad = smap[dy_eff + p_h, dx_eff + p_h, bidx]
                    return sad, (dx_eff == 0) & (dy_eff == 0)

                best = jnp.full((n_mb,), jnp.iinfo(jnp.int32).max, jnp.int32)
                for step_sz in search_steps(m):
                    running = best
                    sel = off
                    for p in range(len(MER_SIGNS)):
                        sx, sy = int(MER_SIGNS[p, 0]), int(MER_SIGNS[p, 1])
                        cand = off + jnp.array([sx * step_sz, sy * step_sz],
                                               jnp.int32)
                        diff, at_self = lookup(cand)
                        skip = (at_self if p > 0
                                else jnp.zeros_like(at_self))
                        acc = (~skip) & (diff <= running)
                        running = jnp.where(acc, diff, running)
                        sel = jnp.where(acc[:, None], cand, sel)
                    off = sel
                    best = running

            px = jnp.clip(bx_g + off[:, 0], 0, w - MACRO)
            py = jnp.clip(by_g + off[:, 1], 0, h_glob - MACRO)
            py_l = py - row0 + halo
            win = ref_h[py_l[:, None, None] + r[None, :, None],
                        px[:, None, None] + r[None, None, :]]
            pred = win.reshape(nby, nbx, MACRO, MACRO) \
                      .swapaxes(1, 2).reshape(h_loc, w)

            x = jnp.where(i_frame, cur.astype(jnp.float32),
                          cur.astype(jnp.float32)
                          - pred.astype(jnp.float32))
            from ..ops.pipeline import quantize_image

            # Reconstruction (Block.cpp:111-119; I-frames stay raw,
            # Frame.cpp:130-159).  Only the recon carry needs the
            # quantized coefficients inside the step — the wire fields
            # are produced post-scan; in raw mode XLA dead-code-eliminates
            # this whole branch.
            qimg = quantize_image(x, quant, d, b)       # [h_loc, w] int32
            q = qimg.reshape(mby, b, mbx, b).swapaxes(1, 2) \
                    .reshape(n_micro, b, b)
            deq = q.astype(jnp.float32) * qf
            expanded = block_transform(deq, d, inverse=True) \
                + jnp.float32(128.0)
            exp_img = expanded.reshape(mby, mbx, b, b).swapaxes(1, 2) \
                              .reshape(h_loc, w)
            recon = jnp.floor(jnp.clip(pred.astype(jnp.float32) + exp_img,
                                       0.0, 255.0)).astype(jnp.uint8)
            recon = jnp.where(i_frame, cur, recon)
            return off, x, recon

        def scan_body(carry, inp):
            cur, i_frame = inp
            off, x, recon = one_frame(carry, cur, i_frame)
            new_carry = cur if ref_mode == "raw" else recon
            return new_carry, (off, x)

        if ref_mode == "raw":
            # Cross-chunk raw reference: previous chunk's last frame.
            init = jax.lax.ppermute(
                frames[-1], "frame",
                [(i, (i + 1) % f_ax) for i in range(f_ax)])
        else:
            init = jnp.zeros((h_loc, w), jnp.uint8)  # chunk starts a GOP
        _, (off_all, x_all) = jax.lax.scan(
            scan_body, init, (frames, is_i))

        mask = (1 << mb) - 1
        mvals = jnp.where(is_i[:, None, None], 0, off_all & mask)

        # ---- wire fields + device packing, per local frame ----
        lw_blk = local_words(k + 2)
        lw_mv = local_words(2)
        wblk = n_micro * lw_blk + 2
        wmv = n_mb * lw_mv + 2
        from ..ops.pipeline import transform_quantize

        coeffs_zz = transform_quantize(
            x_all.reshape(f_loc * h_loc, w), quant, d, b)
        bvals, bnbits = fields_from_coeffs(coeffs_zz, use_rle)
        bvals = bvals.reshape(f_loc, n_micro, k + 2)
        bnbits = bnbits.reshape(f_loc, n_micro, k + 2)
        mv_nb = jnp.where(is_i[:, None, None], 0,
                          jnp.full((f_loc, n_mb, 2), mb, jnp.int32))
        blk_w, mv_w = [], []
        for i in range(f_loc):
            bw, _ = pack_blocks_device(bvals[i], bnbits[i], jnp.int32(0),
                                       wblk)
            mw, _ = pack_blocks_device(mvals[i], mv_nb[i], jnp.int32(0), wmv)
            blk_w.append(bw)
            mv_w.append(mw)
        blk_words = jnp.stack(blk_w)
        mv_words = jnp.stack(mv_w)
        blk_bits = jnp.sum(bnbits, axis=(1, 2), dtype=jnp.int32)  # [f_loc]

        # Full [F, S] block-bit matrix (two tiny all_gathers).
        g1 = jax.lax.all_gather(blk_bits, "block")       # [S, f_loc]
        g2 = jax.lax.all_gather(g1, "frame")             # [f_ax, S, f_loc]
        full_blk = g2.transpose(0, 2, 1).reshape(f_ax * f_loc, s_ax)

        # Static per-frame mvec totals; wire order per frame is
        # [mv(s0)..mv(sS-1)][blk(s0)..blk(sS-1)] (Frame.cpp:210-242).
        mv_seg_bits = n_mb * 2 * mb
        mv_total_np = np.where(is_i_all, 0, s_ax * mv_seg_bits)
        mv_total = jnp.asarray(mv_total_np.astype(np.int64)).astype(jnp.int32)
        frame_total = mv_total + jnp.sum(full_blk, axis=1)
        sb = jnp.asarray(start_bit, jnp.int32)
        frame_start = sb + jnp.cumsum(frame_total) - frame_total  # [F]

        my_rows = f0 + jnp.arange(f_loc)
        my_is_p = ~is_i
        mv_base = (frame_start[my_rows]
                   + sid * mv_seg_bits * my_is_p.astype(jnp.int32))
        blk_prefix = (jnp.cumsum(full_blk, axis=1) - full_blk)  # [F, S]
        blk_base = (frame_start[my_rows] + mv_total[my_rows]
                    + blk_prefix[my_rows, sid])

        def align(words, base):
            s_sh = (base & 31).astype(jnp.uint32)[:, None]
            ext = jnp.concatenate(
                [words, jnp.zeros((f_loc, 1), jnp.uint32)], axis=1)
            prev = jnp.concatenate(
                [jnp.zeros((f_loc, 1), jnp.uint32), words], axis=1)
            return jnp.where(
                s_sh > 0, (ext >> s_sh) | (prev << ((32 - s_sh) % 32)), ext)

        mv_aligned = align(mv_words, mv_base)
        blk_aligned = align(blk_words, blk_base)

        my_mv_bits = my_is_p.astype(jnp.int32) * mv_seg_bits
        hists = []
        for i in range(f_loc):
            h_mv = _segment_byte_histogram(jnp, mv_aligned[i], mv_base[i],
                                           my_mv_bits[i])
            h_blk = _segment_byte_histogram(jnp, blk_aligned[i],
                                            blk_base[i], blk_bits[i])
            hists.append(h_mv + h_blk)
        hist = jax.lax.psum(jnp.stack(hists), "block")    # [f_loc, 257]

        return (mv_aligned[:, None, :], blk_aligned[:, None, :],
                blk_bits[:, None], hist)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P("frame", "block", None), P(), P()),
        out_specs=(P("frame", "block", None), P("frame", "block", None),
                   P("frame", "block"), P("frame", None)),
        check_vma=False)
    import jax

    return jax.jit(fn)


def _splice_video_segments(mvw, blw, blk_bits, header: bytes,
                           start_bit: int, gop: int, mv_seg_bits: int):
    """Byte-OR splice of aligned per-(frame, stripe) segment words in wire
    order ([mvec segments][block segments] per frame).  Returns
    (inner bytes, seg_bits list, total_bits)."""
    from .sharding import check_int32_bit_capacity

    mvw = np.asarray(mvw)
    blw = np.asarray(blw)
    blk_bits = np.asarray(blk_bits, dtype=np.int64)
    f, s = blk_bits.shape
    seg_bits = []
    base = start_bit
    total = start_bit + sum(
        (0 if fi % gop == 0 else s * mv_seg_bits) + int(blk_bits[fi].sum())
        for fi in range(f))
    check_int32_bit_capacity(total)
    out = np.zeros((total + 7) // 8 + 8, dtype=np.uint8)
    out[:len(header)] = np.frombuffer(header, dtype=np.uint8)

    def put(words_row, base, nb):
        if nb:
            seg = words_row.astype(">u4").view(np.uint8)
            b0 = (base >> 5) * 4
            n = ((base & 31) + nb + 7) // 8
            out[b0:b0 + n] |= seg[:n]

    for fi in range(f):
        is_p = fi % gop != 0
        for si in range(s):
            nb = mv_seg_bits if is_p else 0
            put(mvw[fi, si], base, nb)
            seg_bits.append(nb)
            base += nb
        for si in range(s):
            nb = int(blk_bits[fi, si])
            put(blw[fi, si], base, nb)
            seg_bits.append(nb)
            base += nb
    return out[:(total + 7) // 8].tobytes(), seg_bits, total


def encode_video_sharded(frames, quant, mesh, use_rle: bool = True,
                         gop: int = 4, merange: int = 16,
                         use_huffman: bool = True, ref_mode: str = "raw",
                         block_size: int = 4, norm: str = "reference",
                         bit_capacity: int = 2 ** 31) -> bytes:
    """Top-level sharded video encode with AUTOMATIC chunking past the
    int32 device offset capacity.

    The device-side segment placement (cumsum'd frame base offsets, funnel
    phases) runs in int32, so one pass cannot address a payload of 2**31
    bits (~256 MB).  Rather than refusing (check_int32_bit_capacity), this
    entry splits the video into GOP-aligned chunks that each fit, encodes
    every chunk at bit offset 0 on the mesh, and bit-splices the chunk
    payloads after the header on host — exactly the strategy the
    single-device path uses for >32-frame videos (models/video.py), so the
    result is byte-identical to what one oversized pass would produce.

    frames: u8 [F, H, W]; F must divide the mesh "frame" axis (and, in
    recon mode, each chunk's per-device frame count must be GOP-aligned —
    the same constraints as make_sharded_video_packed).
    """
    import math

    import jax
    import jax.numpy as jnp

    from ..models.headers import (VideoParams, write_image_header,
                                  write_video_params)
    from ..models.video import mvec_bits
    from ..ops import bitpack
    from ..ops.huffman import huffman_encode

    f, h, w = frames.shape
    gop = max(1, gop)
    mb = mvec_bits(merange)
    k = block_size * block_size
    n_micro = (h // block_size) * (w // block_size)
    n_macro = (h // MACRO) * (w // MACRO)
    f_ax = mesh.shape["frame"]
    s_ax = mesh.shape["block"]

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, w, h)
    write_video_params(writer, VideoParams(f, gop, merange))
    header = writer.getvalue()
    start_bit = writer.position

    # Worst-case payload bits per frame (same bound class as the packers:
    # 4-bit width + <=17-bit count + 17 bits per coefficient).
    worst_frame = n_macro * 2 * mb + n_micro * (4 + 17 * (k + 1))
    g = math.lcm(gop, f_ax) if ref_mode == "raw" else gop * f_ax
    chunk_f = max(0, (int((bit_capacity - 64 - start_bit) // worst_frame)
                      // g) * g)
    if chunk_f == 0 and f > 0:
        raise ValueError(
            f"even {g} frames ({g * worst_frame} worst-case bits) exceed "
            f"the {bit_capacity}-bit device offset capacity")

    step = make_sharded_video_packed(mesh, gop, merange, mb, block_size,
                                     use_rle, norm, ref_mode)
    quant_f = jnp.asarray(quant.as_float(np.float32))
    if f <= chunk_f:
        mvw, blw, blk_bits, hist = jax.block_until_ready(
            step(jnp.asarray(frames), quant_f, np.int32(start_bit)))
        return assemble_sharded_video_packed(
            mvw, blw, blk_bits, w, h, quant, use_rle, gop, merange,
            use_huffman=use_huffman, hist=hist)

    n_mb_loc = (h // s_ax // MACRO) * (w // MACRO)
    mv_seg_bits = n_mb_loc * 2 * mb
    segments: list[tuple[bytes, int]] = [(header, start_bit)]
    for c0 in range(0, f, chunk_f):
        part = np.asarray(frames[c0:c0 + chunk_f])
        mvw, blw, blk_bits, _ = jax.block_until_ready(
            step(jnp.asarray(part), quant_f, np.int32(0)))
        inner, _, total = _splice_video_segments(
            mvw, blw, blk_bits, b"", 0, gop, mv_seg_bits)
        segments.append((inner, total))
    inner = bitpack.concat_bit_segments(segments)
    if use_huffman:
        return huffman_encode(inner)
    return inner


def assemble_sharded_video_packed(mvw, blw, blk_bits, width: int, height: int,
                                  quant, use_rle: bool, gop: int,
                                  merange: int, use_huffman: bool = True,
                                  hist=None) -> bytes:
    """Byte-OR splice of make_sharded_video_packed outputs into the final
    wire stream (host cost O(stream bytes); the field tensors never leave
    the devices).  When ``hist`` (the psum'd per-frame byte histograms) is
    given, the Huffman code build consumes it directly — only boundary
    bytes are counted on host."""
    from ..models.headers import (VideoParams, write_image_header,
                                  write_video_params)
    from ..models.video import mvec_bits
    from ..ops.huffman import huffman_encode, huffman_encode_with_hist
    from .sharding import boundary_byte_histogram

    mvw = np.asarray(mvw)
    blw = np.asarray(blw)
    blk_bits = np.asarray(blk_bits, dtype=np.int64)
    f, s, _ = blw.shape
    gop = max(1, gop)
    mb = mvec_bits(merange)
    n_mb_loc = (height // s // MACRO) * (width // MACRO)
    mv_seg_bits = n_mb_loc * 2 * mb

    writer = BitWriter()
    if not use_huffman:
        writer.put_bit(0)
    write_image_header(writer, quant, use_rle, width, height)
    write_video_params(writer, VideoParams(f, gop, merange))
    header = writer.getvalue()
    start_bit = writer.position

    inner, seg_bits, total = _splice_video_segments(
        mvw, blw, blk_bits, header, start_bit, gop, mv_seg_bits)

    if not use_huffman:
        return inner
    if hist is None:
        return huffman_encode(inner)
    freqs = (np.asarray(hist)[:, :256].sum(axis=0).astype(np.int64)
             + boundary_byte_histogram(inner, np.asarray(seg_bits),
                                       start_bit))
    return huffman_encode_with_hist(inner, freqs)


def make_sharded_video_decode(mesh, h: int, w: int, gop: int,
                              block_size: int = 4, norm: str = "reference",
                              motioncomp: bool = True):
    """GOP-sharded device video DECODE step.

    GOPs are mutually independent (every GOP opens with an I-frame), so
    the decode's frame-chain recursion shards perfectly at GOP
    granularity: the GOP axis is laid over BOTH mesh axes (the decode
    needs no stripe halo — prediction windows read the shard's own full
    frames), and each device runs the same lax.scan chain as the
    single-device decoder (ops/video_pipeline.make_decode_video_chain) on
    its GOPs — frames come out bit-identical to the serial device decode.

    Returns jitted f(coeffs i32 [G, L, Nmicro, B, B],
                     mvec i32 [G, L, Nmacro, 2] (zero rows for I-frames),
                     quant f32 [B, B]) -> frames u8 [G, L, h, w]
    with G sharded over ("frame", "block") — G must divide the mesh size.
    L is the (padded) GOP length; the caller trims padding.

    Reference analogue: the strictly serial frame loop of
    VideoDecoder.cpp:33-62.
    """
    import jax
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    from ..ops.video_pipeline import make_decode_video_chain

    chain = make_decode_video_chain(h, w, gop, block_size, norm, motioncomp)

    def per_shard(coeffs, mvec, quant):
        return jax.vmap(lambda c, m: chain(c, m, quant))(coeffs, mvec)

    fn = shard_map(
        per_shard, mesh=mesh,
        in_specs=(P(("frame", "block")), P(("frame", "block")), P()),
        out_specs=P(("frame", "block")),
        check_vma=False)
    return jax.jit(fn)


def decode_video_sharded(data: bytes, mesh, motioncomp: bool = True,
                         norm: str = "reference", block_size: int = 4):
    """Multi-chip video decode: the wire-forced serial stages (Huffman
    FSM, offset walk, coefficient extraction) run on host, then the
    per-GOP prediction/IDCT frame chains run sharded across the mesh —
    the decode mirror of the sharded encoder.  Returns
    (yuv420 bytes, VideoParams, (w, h)), byte-identical to
    decode_video(..., backend="jax").

    GOPs are padded (with zero GOPs, trimmed after) to a multiple of the
    mesh size, and short tail GOPs to the full GOP length with zero
    coefficients — padding never influences real frames (each GOP's chain
    is independent and starts from its own I-frame).
    """
    import jax
    import jax.numpy as jnp

    from ..models.video import parse_video_stream
    from ..ops.zigzag import zigzag_order
    from ..runtime.native import extract_coeffs_native

    (payload, quant, use_rle, params, width, height,
     parsed) = parse_video_stream(data, block_size)
    f = params.frame_count
    gop = max(1, params.gop)
    k = block_size * block_size
    n_micro = (width // block_size) * (height // block_size)
    n_macro = (width // MACRO) * (height // MACRO)
    zz = zigzag_order(block_size)

    n_dev = mesh.shape["frame"] * mesh.shape["block"]
    n_gops = -(-f // gop)
    g_pad = -(-n_gops // n_dev) * n_dev

    coeffs = np.zeros((g_pad, gop, n_micro, k), dtype=np.int32)
    mvec = np.zeros((g_pad, gop, n_macro, 2), dtype=np.int32)
    for fi, (mv, _, (offs, dbits, counts)) in enumerate(parsed):
        coeffs[fi // gop, fi % gop] = extract_coeffs_native(
            payload, offs, dbits, counts, zz, block_size)
        if mv is not None:
            mvec[fi // gop, fi % gop] = mv

    step = make_sharded_video_decode(mesh, height, width, gop, block_size,
                                     norm, motioncomp)
    frames = np.asarray(jax.block_until_ready(step(
        jnp.asarray(coeffs.reshape(g_pad, gop, n_micro,
                                   block_size, block_size)),
        jnp.asarray(mvec),
        jnp.asarray(quant.as_float(np.float32)))))
    frames = frames.reshape(g_pad * gop, height, width)[:f]

    from ..models.video import _assemble_yuv420

    return (_assemble_yuv420(frames, width, height), params,
            (width, height))


def encode_sharded_video_huffman(mvw, blw, blk_bits, hist, width: int,
                                 height: int, quant, use_rle: bool,
                                 gop: int, merange: int, mesh) -> bytes:
    """Stage-2 distributed entropy coding for the packed sharded VIDEO
    stream: the per-frame [mvec segments][block segments] wire order is a
    flat concat over 2F "virtual frames" (mv row f -> 2f, block row f ->
    2f+1), which keeps both kinds on frame-shard f — so the generic
    image-side stage-2 (parallel/sharding.encode_sharded_huffman) applies
    verbatim.  Byte-identical to assemble_sharded_video_packed(...,
    use_huffman=True)."""
    import jax.numpy as jnp

    from ..models.headers import (VideoParams, write_image_header,
                                  write_video_params)
    from ..models.video import mvec_bits
    from .sharding import encode_sharded_huffman

    f, s, wblk = np.asarray(blw.shape, dtype=np.int64)
    f, s, wblk = int(f), int(s), int(wblk)
    wmv = int(mvw.shape[2])
    gop = max(1, gop)
    mb = mvec_bits(merange)
    n_mb_loc = (height // s // MACRO) * (width // MACRO)
    mv_seg_bits = n_mb_loc * 2 * mb

    writer = BitWriter()
    write_image_header(writer, quant, use_rle, width, height)
    write_video_params(writer, VideoParams(f, gop, merange))
    header = writer.getvalue()
    start_bit = writer.position

    w_star = max(wmv, wblk)
    mvp = jnp.pad(mvw, ((0, 0), (0, 0), (0, w_star - wmv)))
    blp = jnp.pad(blw, ((0, 0), (0, 0), (0, w_star - wblk)))
    words_v = jnp.stack([mvp, blp], axis=1).reshape(2 * f, s, w_star)

    mv_bits = np.where(np.arange(f) % gop == 0, 0,
                       mv_seg_bits)[:, None] * np.ones((1, s), np.int64)
    bits_v = np.stack([mv_bits.astype(np.int32),
                       np.asarray(blk_bits, np.int32)],
                      axis=1).reshape(2 * f, s)

    hist_np = np.asarray(hist)
    hist_v = np.stack([hist_np, np.zeros_like(hist_np)],
                      axis=1).reshape(2 * f, hist_np.shape[1])

    return encode_sharded_huffman(words_v, jnp.asarray(bits_v), hist_v,
                                  start_bit, header, mesh, mode="concat")
