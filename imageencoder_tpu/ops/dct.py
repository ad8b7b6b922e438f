"""Batched 2-D DCT-II / DCT-III as matrix products, plus the quantization step.

The reference computes a naive O(n^4) 2-D DCT per block in float64
(algo.cpp:309-363) with scale factors C(0)=0.5, C(u)=1/sqrt(2) hard-coded
"voor size=4" (algo.cpp:294-297).  For N=4 that is exactly the orthonormal
DCT-II, so the device formulation is a pair of batched matrix products:

    forward:  Y = D @ X @ D^T        (one einsum over [N, B, B] tiles)
    inverse:  X = D^T @ Y @ D

with D[u, i] = C(u) * cos((2i+1) * u * pi / (2B)).

``norm="reference"`` keeps the reference's (4x4-only-correct) C() for any
size — needed for bit parity.  ``norm="ortho"`` uses the proper orthonormal
scaling for all sizes (the reference README flags 8x8 support as broken; we
support it correctly under this mode).

Quantization follows Block.cpp:139-153: subtract 128, DCT, divide by the
quant matrix and round half-away-from-zero; the result is integral and is
carried as int32.  Dequantization follows Block.cpp:163-177.

Two precision paths share this module:

  * exact parity path (numpy float64): bit-identical to the C++ reference.
    This is subtler than "use float64": the reference's naive accumulation
    (row-major over (i,j), algo.cpp:314-328) drifts off exact rounding ties
    by a few ulps — e.g. a true coefficient of -3.5 is computed as
    -3.4999999999999982 and rounds to -3, where clean math rounds to -4.
    ``dct2_exact``/``idct2_exact`` replicate the reference's f64 arithmetic
    *order* (precomputed cos-product weights, 16-step serial accumulation,
    vectorized across all blocks) and take cos from libm via ctypes so the
    weight values match the C++ binary's std::cos bit-for-bit.

  * device fast path: float32 batched products at Precision.HIGHEST (no
    reduced-precision matrix units).  Self-consistent and stream-valid; quantized coefficients may differ from the reference by
    +-1 level on ~0.1% of coefficients (f64-noise ties resolving the other
    way), with negligible PSNR effect.  Validated against the exact path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..utils.bits import round_half_away


@lru_cache(maxsize=None)
def dct_matrix(n: int, norm: str = "reference") -> np.ndarray:
    """The DCT-II basis matrix D (float64), rows scaled by C(u)."""
    u = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.cos((2.0 * i + 1.0) * u * (np.pi / 2.0 / n))
    if norm == "reference":
        # Reference algo.cpp:294-297 — correct only for n == 4.
        c = np.where(u == 0, 0.5, np.sqrt(0.5))
    elif norm == "ortho":
        c = np.where(u == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return d * c


def _libm_cos(x: float) -> float:
    """glibc's cos (what the reference binary calls), via ctypes."""
    global _LIBM
    if _LIBM is None:
        import ctypes

        lib = ctypes.CDLL("libm.so.6")
        lib.cos.restype = ctypes.c_double
        lib.cos.argtypes = [ctypes.c_double]
        _LIBM = lib
    return _LIBM.cos(x)


_LIBM = None


@lru_cache(maxsize=None)
def _cos_table(n: int) -> np.ndarray:
    """cos((2i+1) * u * pi/(2n)) with the reference's exact f64 argument
    evaluation order (algo.cpp:318: ((2i+1) * u) * factor, factor = M_PI_2/n)."""
    factor = (np.pi / 2.0) / float(n)  # M_PI_2 / double(size)
    t = np.empty((n, n), dtype=np.float64)
    for u in range(n):
        for i in range(n):
            t[u, i] = _libm_cos(float((2 * i + 1) * u) * factor)
    return t


def _c_factors(n: int, norm: str) -> np.ndarray:
    if norm == "reference":
        return np.where(np.arange(n) == 0, 0.5, np.sqrt(0.5))
    return np.where(np.arange(n) == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))


@lru_cache(maxsize=None)
def _fwd_weights(n: int, norm: str) -> tuple[np.ndarray, np.ndarray]:
    """Forward weights W[k=(i,j), (u,v)] = cosU[u,i]*cosV[v,j] and the final
    C(u)*C(v) scale, with f64 product order matching algo.cpp:318-325."""
    cos = _cos_table(n)
    w = np.empty((n * n, n * n), dtype=np.float64)
    for i in range(n):
        for j in range(n):
            # cos((2i+1)u f) * cos((2j+1)v f) — one f64 product, C++ order
            w[i * n + j] = np.multiply.outer(cos[:, i], cos[:, j]).ravel()
    c = _c_factors(n, norm)
    scale = np.multiply.outer(c, c).ravel()  # C(u) * C(v), computed first
    return w, scale


@lru_cache(maxsize=None)
def _inv_weights(n: int, norm: str) -> np.ndarray:
    """Inverse weights W[k=(u,v), (i,j)] = ((C(u)*C(v))*cosU[u,i])*cosV[v,j]
    (left-to-right product order of algo.cpp:352-355)."""
    cos = _cos_table(n)
    c = _c_factors(n, norm)
    w = np.empty((n * n, n * n), dtype=np.float64)
    for u in range(n):
        for v in range(n):
            cc = c[u] * c[v]
            w[u * n + v] = np.multiply.outer(cc * cos[u, :], cos[v, :]).ravel()
    return w


def dct2_exact(blocks: np.ndarray, norm: str = "reference") -> np.ndarray:
    """Bit-exact replica of the reference forward DCT (algo.cpp:309-331).

    Serial 16-step accumulation in the reference's (i,j) order, vectorized
    over all blocks; each step is one f64 multiply then one f64 add, exactly
    like ``temp[uv] += cos*cos*x`` per iteration.
    """
    n = blocks.shape[-1]
    w, scale = _fwd_weights(n, norm)
    flat = np.ascontiguousarray(blocks, dtype=np.float64).reshape(-1, n * n)
    try:  # OpenMP C++ with the identical multiply/add order
        from ..runtime.native import dct_exact_native

        return dct_exact_native(flat, w, scale).reshape(blocks.shape)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("dct_exact", e)
    acc = np.zeros_like(flat)
    tmp = np.empty_like(flat)  # preallocated: the 16-step loop is alloc-bound
    for k in range(n * n):
        np.multiply(flat[:, k, None], w[k][None, :], out=tmp)
        acc += tmp
    acc *= scale[None, :]
    return acc.reshape(blocks.shape)


def idct2_exact(coeffs: np.ndarray, norm: str = "reference") -> np.ndarray:
    """Bit-exact replica of the reference inverse DCT (algo.cpp:343-363)."""
    n = coeffs.shape[-1]
    w = _inv_weights(n, norm)
    flat = np.ascontiguousarray(coeffs, dtype=np.float64).reshape(-1, n * n)
    try:
        from ..runtime.native import dct_exact_native

        return dct_exact_native(flat, w, None).reshape(coeffs.shape)
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("idct_exact", e)
    acc = np.zeros_like(flat)
    tmp = np.empty_like(flat)
    for k in range(n * n):
        np.multiply(flat[:, k, None], w[k][None, :], out=tmp)
        acc += tmp
    return acc.reshape(coeffs.shape)


def dct2(blocks, norm: str = "reference"):
    """Forward 2-D DCT on [N, B, B] (float in, float out): D @ X @ D^T."""
    xp, dtype = _xp(blocks)
    d = xp.asarray(dct_matrix(blocks.shape[-1], norm), dtype=dtype)
    return _mm(xp, _mm(xp, d, blocks), d.T)


def idct2(coeffs, norm: str = "reference"):
    """Inverse 2-D DCT on [N, B, B]: D^T @ Y @ D (reference algo.cpp:343-363)."""
    xp, dtype = _xp(coeffs)
    d = xp.asarray(dct_matrix(coeffs.shape[-1], norm), dtype=dtype)
    return _mm(xp, _mm(xp, d.T, coeffs), d)


def forward_transform(blocks_u8, quant, norm: str = "reference", dtype=np.float64):
    """Pixels -> quantized DCT coefficients (reference Block.cpp:139-153).

    blocks_u8: [N, B, B] uint8; quant: [B, B] float.
    Returns int32 [N, B, B] quantized coefficients.
    """
    xp, _ = _xp(blocks_u8)
    x = blocks_u8.astype(dtype) - dtype(128.0)
    if xp is np and np.dtype(dtype) == np.float64:
        y = dct2_exact(x, norm)  # bit-parity path
    else:
        y = dct2(x, norm)
    q = round_half_away(y / xp.asarray(quant, dtype=dtype))
    return q.astype(xp.int32)


def inverse_transform(coeffs, quant, norm: str = "reference", dtype=np.float64):
    """Quantized coefficients -> reconstructed float pixels (Block.cpp:163-177).

    Returns float [N, B, B] values (128-offset restored, NOT yet clamped).
    """
    xp, _ = _xp(coeffs)
    y = coeffs.astype(dtype) * xp.asarray(quant, dtype=dtype)
    if xp is np and np.dtype(dtype) == np.float64:
        x = idct2_exact(y, norm)  # bit-parity path
    else:
        x = idct2(y, norm)
    return x + dtype(128.0)


def forward_transform_quantize_zz(blocks_u8, quant, norm: str, zz):
    """u8 [N, B, B] -> int32 [N, K] quantized coefficients in ZIG-ZAG
    order, bit-identical to forward_transform + the zig-zag gather but in
    one native pass (no f64 block expansion or numpy rounding passes)."""
    n = blocks_u8.shape[-1]
    k = n * n
    w, scale = _fwd_weights(n, norm)
    try:
        from ..runtime.native import dct_quantize_exact_native

        return dct_quantize_exact_native(
            np.ascontiguousarray(blocks_u8, dtype=np.uint8).reshape(-1, k),
            w, scale, np.asarray(quant, np.float64), np.asarray(zz))
    except Exception as e:
        from ..runtime.native import warn_fallback
        warn_fallback("dct_quantize_exact", e)
    q = forward_transform(np.asarray(blocks_u8), quant, norm)
    return q.reshape(-1, k)[:, np.asarray(zz)]


def forward_transform_fast(blocks_u8, quant, norm: str = "reference"):
    """Host fast path: one [N, k] @ [k, k] float32 BLAS matmul per image.

    Same math as the f32 device path — quantized coefficients may differ
    from the f64 bit-parity path by +-1 on ~0.1% rounding ties; streams
    stay decoder-compatible (docs/PARITY.md).
    """
    n = blocks_u8.shape[-1]
    k = n * n
    wf, scale = _fwd_weights(n, norm)
    x = blocks_u8.reshape(-1, k).astype(np.float32) - np.float32(128.0)
    y = (x @ wf.astype(np.float32)) * scale.astype(np.float32)[None, :]
    q = round_half_away(y / np.asarray(quant, np.float32).reshape(1, k))
    return q.astype(np.int32).reshape(-1, n, n)


def inverse_transform_fast(coeffs, quant, norm: str = "reference"):
    """Host fast inverse: dequant + IDCT as one float32 BLAS matmul.

    Returns float32 [N, B, B] (128-offset restored, NOT clamped); decoded
    pixels can differ +-1 from the bit-parity path on ~0.003% of pixels.
    """
    n = coeffs.shape[-1]
    k = n * n
    wi = _inv_weights(n, norm).astype(np.float32)
    y = (coeffs.reshape(-1, k).astype(np.float32)
         * np.asarray(quant, np.float32).reshape(1, k))
    return (y @ wi + np.float32(128.0)).reshape(-1, n, n)


def clamp_to_u8(x):
    """uint8(std::clamp(x, 0., 255.)) — C++ double->uint8 truncates (Block.cpp:100-107)."""
    xp, _ = _xp(x)
    return xp.floor(xp.clip(x, 0.0, 255.0)).astype(xp.uint8)


def _xp(x):
    if type(x).__module__.split(".")[0] in ("jax", "jaxlib"):
        import jax.numpy as jnp

        return jnp, (x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.float32)
    return np, (x.dtype if np.issubdtype(np.asarray(x).dtype, np.floating) else np.float64)


def _mm(xp, a, b):
    if xp is np:
        return a @ b
    import jax

    return xp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)
