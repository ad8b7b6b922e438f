"""Vectorized 2D-log motion search (reference parity).

The reference walks a recursive 9-point diamond LUT per MacroBlock, serially
(algo.cpp:90-139 builds the LUT, Block.cpp:268-339 the descent).  Semantics
verified from source:

  * levels: step sizes merange//2, merange//4, ... 1 (integer halving);
    a level's 9 candidates are the selected parent offset + sign*step with
    sign order MER_SIGNS (algo.cpp:90-100); child p=0 repeats the parent,
  * candidate pixel positions are the block's own position + candidate
    offset, CLAMPED into [0, W-16] x [0, H-16] (ImageBase.cpp:253-254);
    the stored motion vector keeps the UNCLAMPED offset (Block.cpp:333-334),
  * a candidate p>0 whose clamped position equals the block's own position
    is skipped (Block.cpp:297-301, isDifferentBlock);
  * cost is the 16x16 SAD (relativeAbsDifferenceWith, Block.cpp:242-254);
    acceptance is `diff <= running_best` so LATER candidates win ties
    (Block.cpp:306); the running best carries across levels,
  * the p=0 candidate always ties the carried best, so the descent always
    runs the full depth (the reference's early-exit branch at
    Block.cpp:318-321 is unreachable) — making the loop a fixed-trip-count
    structure that vectorizes over every MacroBlock at once.

The whole search therefore becomes: for each static level, gather 9 * N
windows from the reference frame, compute SADs as batched reductions, and
select with masked minimum — data-parallel over N on the device, no host loop.
"""

from __future__ import annotations

import numpy as np

MACRO = 16  # dc::MacroBlockSize (Block.hpp:14)

# algo.cpp:90-100, in evaluation order.
MER_SIGNS = np.array([(0, 0), (1, 0), (1, 1), (0, 1), (-1, 1),
                      (-1, 0), (-1, -1), (0, -1), (1, -1)], dtype=np.int32)


def search_steps(merange: int) -> list[int]:
    """Per-level step sizes: merange//2, //4, ... 1 (algo.cpp:119-139)."""
    steps = []
    m = int(merange) // 2
    while m > 0:
        steps.append(m)
        m //= 2
    return steps


def macro_grid(h: int, w: int):
    """Row-major MacroBlock top-left coords (ImageBase.cpp:220-233)."""
    bys, bxs = np.mgrid[0:h // MACRO, 0:w // MACRO]
    return (bxs.ravel() * MACRO).astype(np.int32), (bys.ravel() * MACRO).astype(np.int32)


def _windows_np(ref, py, px):
    """Gather [N,16,16] windows at (py, px) top-left coords."""
    r = np.arange(MACRO)
    return ref[py[:, None, None] + r[None, :, None],
               px[:, None, None] + r[None, None, :]]


def find_motion(cur: np.ndarray, ref: np.ndarray, merange: int):
    """2D-log search for every MacroBlock of ``cur`` against ``ref``.

    cur, ref: [H, W] uint8.  Returns (mvec [N,2] int32 as (x, y) relative
    offsets, pred [N,16,16] uint8 motion-compensated windows).
    """
    h, w = cur.shape
    bx, by = macro_grid(h, w)
    n = bx.shape[0]
    r = np.arange(MACRO)

    try:
        from ..runtime.native import find_motion_native

        off = find_motion_native(cur, ref, search_steps(merange))
        px = np.clip(bx + off[:, 0], 0, w - MACRO)
        py = np.clip(by + off[:, 1], 0, h - MACRO)
        return off, _windows_np(ref, py, px)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("find_motion", e)

    cur_blocks = cur[by[:, None, None] + r[None, :, None],
                     bx[:, None, None] + r[None, None, :]].astype(np.int32)

    off = np.zeros((n, 2), dtype=np.int32)  # (x, y)
    best = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)

    for step in search_steps(merange):
        running = best.copy()
        sel = off.copy()
        for p in range(len(MER_SIGNS)):
            cand = off + MER_SIGNS[p][None, :] * step
            px = np.clip(bx + cand[:, 0], 0, w - MACRO)
            py = np.clip(by + cand[:, 1], 0, h - MACRO)
            win = _windows_np(ref, py, px).astype(np.int32)
            diff = np.abs(cur_blocks - win).sum(axis=(1, 2)).astype(np.int64)
            skip = (p > 0) & (px == bx) & (py == by)
            acc = ~skip & (diff <= running)
            running = np.where(acc, diff, running)
            sel = np.where(acc[:, None], cand, sel)
        off = sel
        best = running

    px = np.clip(bx + off[:, 0], 0, w - MACRO)
    py = np.clip(by + off[:, 1], 0, h - MACRO)
    pred = _windows_np(ref, py, px)
    return off, pred


def predict_image(ref: np.ndarray, mvec: np.ndarray, h: int, w: int) -> np.ndarray:
    """Assemble the full-frame motion-compensated prediction [H, W] from
    per-MacroBlock vectors (decode side of loadFromReferenceStream,
    Block.cpp:482-496: position = own coord + mvec, clamped)."""
    bx, by = macro_grid(h, w)
    px = np.clip(bx + mvec[:, 0], 0, w - MACRO)
    py = np.clip(by + mvec[:, 1], 0, h - MACRO)
    win = _windows_np(ref, py, px)
    pred = np.empty((h, w), dtype=ref.dtype)
    nbx = w // MACRO
    pred_view = pred.reshape(h // MACRO, MACRO, nbx, MACRO).swapaxes(1, 2)
    pred_view[:] = win.reshape(h // MACRO, nbx, MACRO, MACRO)
    return pred


def find_motion_jax(cur, ref, merange: int):
    """JAX version of :func:`find_motion` (jit-compatible; static merange).

    cur, ref: [H, W] uint8 jax arrays.  Same reference semantics, expressed
    as static-unrolled levels of batched gathers + reductions.
    """
    import jax.numpy as jnp

    h, w = cur.shape
    bx_np, by_np = macro_grid(h, w)
    bx, by = jnp.asarray(bx_np), jnp.asarray(by_np)
    n = bx_np.shape[0]
    r = jnp.arange(MACRO)

    def windows(py, px):
        return ref[py[:, None, None] + r[None, :, None],
                   px[:, None, None] + r[None, None, :]]

    cur_blocks = cur[by[:, None, None] + r[None, :, None],
                     bx[:, None, None] + r[None, None, :]].astype(jnp.int32)

    off = jnp.zeros((n, 2), dtype=jnp.int32)
    best = jnp.full((n,), jnp.iinfo(jnp.int32).max, dtype=jnp.int32)

    for step in search_steps(merange):
        running = best
        sel = off
        for p in range(len(MER_SIGNS)):
            sx, sy = int(MER_SIGNS[p, 0]), int(MER_SIGNS[p, 1])
            cand = off + jnp.array([sx * step, sy * step], dtype=jnp.int32)[None, :]
            px = jnp.clip(bx + cand[:, 0], 0, w - MACRO)
            py = jnp.clip(by + cand[:, 1], 0, h - MACRO)
            win = windows(py, px).astype(jnp.int32)
            diff = jnp.abs(cur_blocks - win).sum(axis=(1, 2))
            skip = (px == bx) & (py == by) if p > 0 else jnp.zeros((n,), bool)
            acc = (~skip) & (diff <= running)
            running = jnp.where(acc, diff, running)
            sel = jnp.where(acc[:, None], cand, sel)
        off = sel
        best = running

    px = jnp.clip(bx + off[:, 0], 0, w - MACRO)
    py = jnp.clip(by + off[:, 1], 0, h - MACRO)
    pred = windows(py, px)
    return off, pred
