"""Translation SAD maps: the motion-search hot loop of device video encode.

For every offset (dy, dx) in [-pad, pad]^2 (pad = merange - 1, D = 2*pad+1
offsets per axis) the map holds, per 16x16 macroblock, the sum of
|cur - ref translated by (dy, dx)| with the reference zero-padded outside
the frame.  The search descent (ops/video_pipeline.sad_motion_search) then
reads D^2 candidates per block as tiny lookups instead of gathering pixel
windows (Block.cpp:268-339 semantics; see that function for why every
candidate the 2D-log search visits is one of these maps).

Two implementations with bit-equal integer results:

  * :func:`sad_maps_scan` — plain XLA: a ``lax.scan`` over the D^2 offsets,
    each step one dynamic slice of the padded reference + abs-diff +
    16x16 sum-pool.  Every step re-reads both frames (D^2 * 2 frame reads,
    ~44 GB of u8 traffic for 25 frames of 720p at merange 16).
  * :func:`sad_maps_triton` — a Pallas kernel on the Triton route.  One
    program owns one (frame, macroblock row, column tile, dy): it loads the
    current tile once and loops over the D dx offsets, reading the
    reference windows through the cache and reducing 16x16 block sums in
    registers.  Tiles are by columns, so frame width is unbounded.

:func:`sad_maps` picks the kernel on a GPU and the scan elsewhere.  Each
form takes an optional ``halo``: the reference then carries that many rows
above and below the frame (a height stripe's neighbour rows in the sharded
encoder, parallel/video_sharding.py), and only rows past the halo read as
zero.
"""

from __future__ import annotations

from functools import lru_cache

MACRO = 16
# Tile of 8 macroblock columns (128 px) with 8 warps: the fastest of
# {8, 16, 32} x {4, 8} tiles x warps at 720p25, merange 16 on an H100.
TILE_MB = 8
NUM_WARPS = 8


def _rows_padded(ref_u8, pad: int, halo: int):
    """The reference with exactly ``pad`` rows above and below the frame:
    the caller's ``halo`` rows, cropped or extended with zero rows."""
    import jax.numpy as jnp

    if halo > pad:
        cut = halo - pad
        return ref_u8[:, cut:ref_u8.shape[1] - cut]
    return jnp.pad(ref_u8, ((0, 0), (pad - halo, pad - halo), (0, 0)))


def sad_maps_scan(cur_u8, ref_u8, merange: int, halo: int = 0):
    """[F,H,W] u8 cur, [F,H+2*halo,W] u8 ref ->
    int32 [D, D, F, H//16, W//16] SAD maps."""
    import jax
    import jax.numpy as jnp

    f, h, w = cur_u8.shape
    pad = int(merange) - 1
    d = 2 * pad + 1
    nby, nbx = h // MACRO, w // MACRO
    refp = jnp.pad(_rows_padded(ref_u8, pad, halo),
                   ((0, 0), (0, 0), (pad, pad)))

    def pool(x):  # [F,H,W] -> [F,nby,nbx] 16x16 block sums
        x = x[:, :nby * MACRO, :nbx * MACRO]
        x = x.reshape(f, nby, MACRO, nbx * MACRO).sum(axis=2)
        return x.reshape(f, nby, nbx, MACRO).sum(axis=3)

    def sad_at(carry, od):
        shifted = jax.lax.dynamic_slice(refp, (0, od[0], od[1]), (f, h, w))
        # u8 operands widened inside the fusion: 1 B/px of traffic per read.
        diff = jnp.abs(cur_u8.astype(jnp.int32) - shifted.astype(jnp.int32))
        return carry, pool(diff)

    offsets = jnp.stack(jnp.meshgrid(jnp.arange(d), jnp.arange(d),
                                     indexing="ij"), axis=-1).reshape(-1, 2)
    _, maps = jax.lax.scan(sad_at, 0, offsets)
    return maps.reshape(d, d, f, nby, nbx)


@lru_cache(maxsize=None)
def _sad_call(f: int, h: int, n_tiles: int, d: int, interpret: bool):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plt

    nby = h // MACRO
    tw = TILE_MB * MACRO

    def kernel(cur_ref, ref_ref, out_ref):
        fi = pl.program_id(0)
        by = pl.program_id(1)
        t = pl.program_id(2)
        dy = pl.program_id(3)
        y0 = by * MACRO
        x0 = t * tw
        cur = cur_ref[fi, pl.ds(y0, MACRO), pl.ds(x0, tw)].astype(jnp.int32)

        def body(dx, carry):
            win = ref_ref[fi, pl.ds(y0 + dy, MACRO), pl.ds(x0 + dx, tw)]
            diff = jnp.abs(cur - win.astype(jnp.int32))
            sad = diff.reshape(MACRO, TILE_MB, MACRO).sum(axis=(0, 2))
            out_ref[dy, dx, fi, by, pl.ds(t * TILE_MB, TILE_MB)] = sad
            return carry

        jax.lax.fori_loop(0, d, body, 0)

    return pl.pallas_call(
        kernel,
        grid=(f, nby, n_tiles, d),
        out_shape=jax.ShapeDtypeStruct((d, d, f, nby, n_tiles * TILE_MB),
                                       jnp.int32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="sad_maps",
    )


def sad_maps_triton(cur_u8, ref_u8, merange: int, halo: int = 0,
                    interpret: bool = False):
    """Kernel form of :func:`sad_maps_scan` (same output, bit for bit)."""
    import jax.numpy as jnp

    f, h, w = cur_u8.shape
    pad = int(merange) - 1
    d = 2 * pad + 1
    nbx = w // MACRO
    n_tiles = max(1, -(-nbx // TILE_MB))
    wp = n_tiles * TILE_MB * MACRO
    # Zero columns past the frame: tiles never read out of bounds, and the
    # reference keeps the scan's zero padding on every side.
    cur = jnp.pad(cur_u8, ((0, 0), (0, 0), (0, wp - w)))
    refp = jnp.pad(_rows_padded(ref_u8, pad, halo),
                   ((0, 0), (0, 0), (pad, wp - w + pad)))
    maps = _sad_call(f, h, n_tiles, d, interpret)(cur, refp)
    return maps[..., :nbx]


def sad_maps(cur_u8, ref_u8, merange: int, halo: int = 0):
    """SAD maps on the best implementation for the running platform."""
    import jax

    if jax.default_backend() == "gpu":
        return sad_maps_triton(cur_u8, ref_u8, merange, halo)
    return sad_maps_scan(cur_u8, ref_u8, merange, halo)
