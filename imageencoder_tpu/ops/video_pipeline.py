"""Whole-video single-jit encode pipeline (ref_mode="raw").

Because the shipped reference binaries use the RAW previous frame as motion
reference (see models/video.py), every frame's encode is independent — the
entire video batches into ONE device computation:

    frames [F,H,W] u8
      -> batched motion search for all P-frames at once (ops/motion.py,
         vmapped: cur = frames[1:], ref = frames[:-1], I-frame slots masked)
      -> residual/pixel transform for ALL frames' 4x4 blocks in one product
      -> wire fields (mvec records + block records, stream order)
      -> on-device two-level bit packer (ops/device_pack.py)

Output is the packed inner payload; the host prepends the video header bits
and runs the optional Huffman stage.  The reference encodes the same video
with a serial frame loop of serial block loops (VideoEncoder.cpp:83-91).

Stream order per frame (Frame.cpp:194-242): P-frames emit all motion
vectors (2 x MVEC_BITS signed each, macro row-major), then the residual
blocks; I-frames emit pixel blocks only.  Records are rows of a single
[R, 18] field matrix, so one pack call emits the whole video.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .device_pack import (HEADER_WORDS, pack_blocks_device,
                          packed_words_bound)
from .dct import dct_matrix
from .motion import MACRO, MER_SIGNS, macro_grid, search_steps
from .pipeline import block_transform, fields_from_coeffs
from .sad_maps import sad_maps
from .zigzag import zigzag_order


def _batched_motion_sadmap(frames, merange: int):
    """Gather-free batched motion search via translation SAD maps.

    Per-probe window gathers cost one element gather per pixel per probe.
    This formulation exploits two structural facts:

      1. every candidate the 2D-log search can visit has an offset within
         [-(merange-1), merange-1]^2 (the level steps sum to merange-1);
      2. a CLAMPED candidate (window pushed back inside the frame,
         ImageBase.cpp:253-254) equals the translation-SAD at the block's
         *effective* offset clip(pos+off)-pos, which lies in the same range.

    So: precompute S[dy, dx, f, by, bx] = block-pooled SAD of
    |cur - ref translated by (dy,dx)| for ALL D^2 = (2*merange-1)^2 offsets
    (ops/sad_maps.py), then run the exact reference descent (tie-breaks,
    skip rule, carry) as TINY [F, Nmb] lookups into S.

    Memory: D^2 * F * Nmb * 4 bytes (e.g. 346 MB for 25 frames of 720p at
    merange 16); callers chunk frames for very large jobs.

    Returns (mvec [F,Nmb,2], pred [F,H,W]) like _batched_motion; row f is
    predicted from frames[f-1] (row 0 garbage, masked by caller).
    """
    import jax.numpy as jnp

    refu8 = jnp.roll(frames, 1, axis=0)
    return sad_motion_search(frames, refu8, merange)


def sad_motion_search(cur_u8, ref_u8, merange: int):
    """Gather-free search core: cur/ref [F,H,W] u8 (explicit references).

    See :func:`_batched_motion_sadmap` for the method; works for any F
    including 1 (used by the lax.scan recon path per step).
    """
    import jax
    import jax.numpy as jnp

    f, h, w = cur_u8.shape
    m = int(merange)
    nby, nbx = h // MACRO, w // MACRO
    n = nby * nbx
    bx_np, by_np = macro_grid(h, w)
    bx, by = jnp.asarray(bx_np), jnp.asarray(by_np)

    with jax.named_scope("motion_search"):
        off = jnp.zeros((f, n, 2), jnp.int32)
        if m >= 2:
            pad = m - 1
            s = sad_maps(cur_u8, ref_u8, m)  # [dy, dx, f, by, bx]
            fidx = jnp.arange(f, dtype=jnp.int32)[:, None]
            byi = jnp.asarray(by_np // MACRO)[None, :]
            bxi = jnp.asarray(bx_np // MACRO)[None, :]

            def lookup(cand):
                dx_eff = jnp.clip(bx[None, :] + cand[:, :, 0], 0, w - MACRO) \
                    - bx[None, :]
                dy_eff = jnp.clip(by[None, :] + cand[:, :, 1], 0, h - MACRO) \
                    - by[None, :]
                sad = s[dy_eff + pad, dx_eff + pad, fidx, byi, bxi]
                return sad, (dx_eff == 0) & (dy_eff == 0)

            best = jnp.full((f, n), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)
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

        # Single window gather for the final predictions.
        px = jnp.clip(bx[None, :] + off[:, :, 0], 0, w - MACRO)
        py = jnp.clip(by[None, :] + off[:, :, 1], 0, h - MACRO)
        r = jnp.arange(MACRO)
        win = ref_u8[jnp.arange(f)[:, None, None, None],
                     py[:, :, None, None] + r[None, None, :, None],
                     px[:, :, None, None] + r[None, None, None, :]]
        pred = win.reshape(f, nby, nbx, MACRO, MACRO) \
                  .swapaxes(2, 3).reshape(f, h, w)
        return off, pred


def _batched_motion(frames, gop: int, merange: int):
    """Motion vectors + predictions for every frame (I-frame rows unused).

    frames: [F,H,W] u8 device array.  Returns (mvec int32 [F,Nmb,2],
    pred uint8 [F,H,W]) where row f describes frame f predicted from raw
    frame f-1 (row 0 is garbage, masked by the caller).
    """
    import jax.numpy as jnp

    f, h, w = frames.shape
    cur = frames  # [F,...]; ref[f] = frames[f-1] (roll; row 0 unused)
    ref = jnp.roll(frames, 1, axis=0)

    bx_np, by_np = macro_grid(h, w)
    bx, by = jnp.asarray(bx_np), jnp.asarray(by_np)
    n = bx_np.shape[0]
    r = jnp.arange(MACRO)

    def windows(img, py, px):  # img [F,H,W]; py/px [F,N]
        return img[jnp.arange(f)[:, None, None, None],
                   py[:, :, None, None] + r[None, None, :, None],
                   px[:, :, None, None] + r[None, None, None, :]]

    cur_blocks = windows(cur, jnp.broadcast_to(by, (f, n)),
                         jnp.broadcast_to(bx, (f, n))).astype(jnp.int32)

    off = jnp.zeros((f, n, 2), dtype=jnp.int32)
    best = jnp.full((f, n), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)

    for step in search_steps(merange):
        running = best
        sel = off
        for p in range(len(MER_SIGNS)):
            sx, sy = int(MER_SIGNS[p, 0]), int(MER_SIGNS[p, 1])
            cand = off + jnp.array([sx * step, sy * step], jnp.int32)
            px = jnp.clip(bx[None, :] + cand[:, :, 0], 0, w - MACRO)
            py = jnp.clip(by[None, :] + cand[:, :, 1], 0, h - MACRO)
            win = windows(ref, py, px).astype(jnp.int32)
            diff = jnp.abs(cur_blocks - win).sum(axis=(2, 3))
            if p > 0:
                skip = (px == bx[None, :]) & (py == by[None, :])
            else:
                skip = jnp.zeros((f, n), bool)
            acc = (~skip) & (diff <= running)
            running = jnp.where(acc, diff, running)
            sel = jnp.where(acc[:, :, None], cand, sel)
        off = sel
        best = running

    px = jnp.clip(bx[None, :] + off[:, :, 0], 0, w - MACRO)
    py = jnp.clip(by[None, :] + off[:, :, 1], 0, h - MACRO)
    win = windows(ref, py, px)  # [F,N,16,16]
    nbx = w // MACRO
    pred = win.reshape(f, h // MACRO, nbx, MACRO, MACRO) \
              .swapaxes(2, 3).reshape(f, h, w)
    return off, pred


@lru_cache(maxsize=None)
def make_encode_video_packed_recon(gop: int, merange: int, mvec_nbits: int,
                                   block_size: int = 4, use_rle: bool = True,
                                   norm: str = "reference",
                                   with_hist: bool = False):
    """Whole-video device encoder for ref_mode="recon" (source semantics).

    Reconstruction-referenced P-frames have a true sequential dependency —
    frame f's motion reference is frame f-1's reconstruction — so the frame
    loop becomes a `lax.scan` whose carry is the reconstructed reference
    frame (SURVEY §5: "inside a GOP the frame recursion is a lax.scan
    carry").  Per step: batched motion search against the carry, residual
    transform, wire fields, and the reconstruction (prediction + dequantized
    residual, Frame.cpp:210-242) which becomes the next carry; I-frames
    reset the carry to their raw pixels.  The stacked per-frame fields feed
    the same single pack call as the raw-mode path.
    """
    import jax
    import jax.numpy as jnp

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    zz = zigzag_order(b)
    izz = np.empty(b * b, dtype=np.int32)
    izz[zz] = np.arange(b * b)

    @jax.jit
    def encode_video_packed(frames, quant, start_bit, header_words):
        f, h, w = frames.shape
        n_micro = (h // b) * (w // b)
        n_macro = (h // MACRO) * (w // MACRO)
        k = b * b
        by_, bx_ = h // b, w // b
        d = jnp.asarray(dct_m)
        qf = quant.astype(jnp.float32)
        is_i = jnp.asarray([fi % gop == 0 for fi in range(f)])

        def step(ref, inp):
            cur, i_frame = inp
            off1, pred1 = sad_motion_search(cur[None], ref[None], merange)
            off, pred = off1[0], pred1[0]

            x = jnp.where(i_frame, cur.astype(jnp.float32),
                          cur.astype(jnp.float32) - pred.astype(jnp.float32))
            from .pipeline import quantize_image

            qimg = quantize_image(x, quant, d, b)       # [h, w] int32
            q = qimg.reshape(by_, b, bx_, b).swapaxes(1, 2) \
                    .reshape(n_micro, b, b)
            coeffs_zz = q.reshape(n_micro, k)[:, jnp.asarray(zz)]
            vals, nbits = fields_from_coeffs(coeffs_zz, use_rle)

            # Reconstruction for the next carry (Block.cpp:111-119): P-frames
            # add the dequantized residual onto the prediction; I-frames stay
            # raw (Frame.cpp:130-159 never reconstructs them).
            deq = q.astype(jnp.float32) * qf
            expanded = block_transform(deq, d, inverse=True) \
                + jnp.float32(128.0)
            exp_img = expanded.reshape(by_, bx_, b, b).swapaxes(1, 2) \
                              .reshape(h, w)
            recon = jnp.floor(jnp.clip(pred.astype(jnp.float32) + exp_img,
                                       0.0, 255.0)).astype(jnp.uint8)
            new_ref = jnp.where(i_frame, cur, recon)
            return new_ref, (off, vals, nbits)

        init = frames[0]  # frame 0 is always an I-frame (gop >= 1)
        _, (mvec, bvals, bnbits) = jax.lax.scan(step, init, (frames, is_i))

        mask = (1 << mvec_nbits) - 1
        mvals = jnp.zeros((f, n_macro, k + 2), dtype=jnp.int32)
        mnbits = jnp.zeros((f, n_macro, k + 2), dtype=jnp.int32)
        mvals = mvals.at[:, :, 0].set(mvec[:, :, 0] & mask)
        mvals = mvals.at[:, :, 1].set(mvec[:, :, 1] & mask)
        mnbits = mnbits.at[:, :, :2].set(mvec_nbits)
        mnbits = jnp.where(~is_i[:, None, None], mnbits, 0)

        vals = jnp.concatenate([mvals, bvals], axis=1).reshape(-1, k + 2)
        nbits = jnp.concatenate([mnbits, bnbits], axis=1).reshape(-1, k + 2)
        n_rows = f * (n_macro + n_micro)
        words, total = pack_blocks_device(vals, nbits, start_bit,
                                          packed_words_bound(n_rows, k + 2))
        words = words.at[:HEADER_WORDS].set(words[:HEADER_WORDS]
                                            | header_words)
        if with_hist:
            from .pipeline import stream_byte_histogram

            return words, stream_byte_histogram(words, total)
        return words, total

    return encode_video_packed


@lru_cache(maxsize=None)
def make_decode_video_device(h: int, w: int, gop: int,
                             block_size: int = 4, norm: str = "reference",
                             motioncomp: bool = True):
    """Fused per-GOP device video DECODE — the decode mirror of
    make_encode_video_packed_recon.

    One jit runs the whole frame chain as a lax.scan whose carry is the
    previous DECODED frame: per step, motion-window gather from the carry
    (clamped starts, ImageBase.cpp:253-254 / Block.cpp:482-496), residual
    dequantize + IDCT + +128 restore (Frame.cpp:85-118), prediction add
    and clamp (Block.cpp:111-119); I-frames decode standalone and reset
    the carry.  The host keeps only the serial stages the wire format
    forces (Huffman FSM + offset walk + coefficient extraction).

    f(coeffs i32 [F, Nmicro, B, B] row-major, mvec i32 [F, Nmacro, 2]
      (zero rows for I-frames), quant f32 [B, B]) -> frames u8 [F, H, W].

    Numerics: f32 IDCT at HIGHEST precision — same +-1-on-rounding-tie
    class as every device inverse path (docs/PARITY.md); the motion /
    prediction arithmetic is integer-exact.
    """
    import jax

    fn = make_decode_video_chain(h, w, gop, block_size, norm, motioncomp)
    return jax.jit(fn)


@lru_cache(maxsize=None)
def make_decode_video_chain(h: int, w: int, gop: int, block_size: int = 4,
                            norm: str = "reference",
                            motioncomp: bool = True):
    """The traced (un-jitted) decode frame chain — shared by the
    single-device jit (make_decode_video_device) and the GOP-sharded
    shard_map step (parallel/video_sharding.make_sharded_video_decode),
    so both produce bit-identical frames."""
    import jax
    import jax.numpy as jnp

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    by_, bx_ = h // b, w // b
    nby, nbx = h // MACRO, w // MACRO
    bx_np, by_np = macro_grid(h, w)

    def decode_video_chain(coeffs, mvec, quant):
        f = coeffs.shape[0]
        d = jnp.asarray(dct_m)
        qf = quant.astype(jnp.float32)
        bx, by = jnp.asarray(bx_np), jnp.asarray(by_np)
        r = jnp.arange(MACRO)
        is_i = jnp.asarray([fi % max(1, gop) == 0 for fi in range(f)])

        @jax.named_scope("idct")
        def expand(cf):  # [N, B, B] i32 -> [h, w] f32 (+128 restored)
            y = cf.astype(jnp.float32) * qf
            x = block_transform(y, d, inverse=True) + jnp.float32(128.0)
            return x.reshape(by_, bx_, b, b).swapaxes(1, 2).reshape(h, w)

        def predict(ref, off):  # ref [h, w] u8; off [Nmb, 2] -> [h, w] u8
            px = jnp.clip(bx + off[:, 0], 0, w - MACRO)
            py = jnp.clip(by + off[:, 1], 0, h - MACRO)
            win = ref[py[:, None, None] + r[None, :, None],
                      px[:, None, None] + r[None, None, :]]
            return win.reshape(nby, nbx, MACRO, MACRO) \
                      .swapaxes(1, 2).reshape(h, w)

        def step(ref, inp):
            cf, off, i_frame = inp
            exp = expand(cf)
            own = jnp.floor(jnp.clip(exp, 0.0, 255.0)).astype(jnp.uint8)
            pred = predict(ref, off)
            if motioncomp:
                padd = jnp.floor(jnp.clip(
                    pred.astype(jnp.float32) + exp, 0.0, 255.0)) \
                    .astype(jnp.uint8)
            else:
                padd = pred
            out = jnp.where(i_frame, own, padd)
            return out, out

        init = jnp.zeros((h, w), jnp.uint8)  # frame 0 is always an I-frame
        _, frames = jax.lax.scan(step, init, (coeffs, mvec, is_i))
        return frames

    return decode_video_chain


@lru_cache(maxsize=None)
def make_encode_video_packed(gop: int, merange: int, mvec_nbits: int,
                             block_size: int = 4, use_rle: bool = True,
                             norm: str = "reference",
                             with_hist: bool = False):
    """Build the jitted whole-video encoder (shapes fix at first call).

    f(frames u8 [F,H,W], quant f32, start_bit i32) -> (words u32, total i32).
    """
    import jax
    import jax.numpy as jnp

    b = block_size
    dct_m = np.asarray(dct_matrix(b, norm), dtype=np.float32)
    zz = zigzag_order(b)

    @jax.jit
    def encode_video_packed(frames, quant, start_bit, header_words):
        f, h, w = frames.shape
        n_micro = (h // b) * (w // b)
        n_macro = (h // MACRO) * (w // MACRO)
        k = b * b

        is_i = np.array([fi % gop == 0 for fi in range(f)])
        # SAD-map search when its S tensor fits comfortably; per-probe
        # window gathers otherwise.
        d_span = 2 * (merange - 1) + 1 if merange >= 2 else 1
        s_bytes = (d_span ** 2) * f * (h // MACRO) * (w // MACRO) * 4
        if s_bytes <= 2 << 30:
            mvec, pred = _batched_motion_sadmap(frames, merange)
        else:
            mvec, pred = _batched_motion(frames, gop, merange)

        # Transform input: pixels for I-frames, residual for P-frames.
        # Residual carries the same -128 bias (SUBTRACT_128, Block.cpp:139).
        # The shared -128 bias below turns these into pixels-128 (I) and
        # residual-128 (P), the reference's DCT inputs for both paths.
        x = jnp.where(jnp.asarray(is_i)[:, None, None],
                      frames.astype(jnp.float32),
                      frames.astype(jnp.float32) - pred.astype(jnp.float32))
        n_rows = f * (n_macro + n_micro)
        n_words = packed_words_bound(n_rows, k + 2)
        from .pipeline import transform_quantize

        coeffs_zz = transform_quantize(x.reshape(f * h, w), quant,
                                       jnp.asarray(dct_m), b)
        bvals, bnbits = fields_from_coeffs(coeffs_zz, use_rle)
        bvals = bvals.reshape(f, n_micro, k + 2)
        bnbits = bnbits.reshape(f, n_micro, k + 2)

        # Motion-vector records: [F, Nmacro, k+2] with 2 live fields.
        mask = (1 << mvec_nbits) - 1
        mvals = jnp.zeros((f, n_macro, k + 2), dtype=jnp.int32)
        mnbits = jnp.zeros((f, n_macro, k + 2), dtype=jnp.int32)
        mvals = mvals.at[:, :, 0].set(mvec[:, :, 0] & mask)
        mvals = mvals.at[:, :, 1].set(mvec[:, :, 1] & mask)
        mnbits = mnbits.at[:, :, :2].set(mvec_nbits)
        p_rows = ~jnp.asarray(is_i)[:, None, None]
        mnbits = jnp.where(p_rows, mnbits, 0)  # I-frames emit no mvecs

        # Stream order: per frame, mvec rows then block rows.
        vals = jnp.concatenate([mvals, bvals], axis=1).reshape(-1, k + 2)
        nbits = jnp.concatenate([mnbits, bnbits],
                                axis=1).reshape(-1, k + 2)
        words, total = pack_blocks_device(vals, nbits, start_bit, n_words)
        words = words.at[:HEADER_WORDS].set(words[:HEADER_WORDS]
                                            | header_words)
        if with_hist:
            from .pipeline import stream_byte_histogram

            return words, stream_byte_histogram(words, total)
        return words, total

    return encode_video_packed
