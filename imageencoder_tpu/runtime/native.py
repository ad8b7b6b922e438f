"""ctypes loader for the native C++ runtime (serial hot loops).

The device compute path is JAX; the host-side serial stages — decode
offset recovery and the Huffman FSM walk — are implemented in C++
(runtime/native/runtime.cpp) and loaded here.  Every entry point has a pure
numpy/Python fallback in the calling module, so the framework degrades
gracefully when the shared library has not been built.

Build: ``python -m imageencoder_tpu.runtime.build`` (or it auto-builds on
first import if a compiler is available).
"""

from __future__ import annotations

import ctypes
import pathlib

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    import os

    override = os.environ.get("IER_NATIVE_LIB")
    if override:  # e.g. the TSAN/ASAN-instrumented build (test gate)
        so = pathlib.Path(override)
        if not so.exists():
            return None
        lib = ctypes.CDLL(str(so))
        _register(lib)
        _LIB = lib
        return lib
    so = pathlib.Path(__file__).parent / "native" / "libier_runtime.so"
    try:
        from .build import build

        build()  # no-op when the .so is newer than runtime.cpp
    except Exception:
        # Build failed (no compiler?).  Only fall back to a pre-existing
        # .so if its build tag matches THIS host's ISA: the library is
        # built with -march=native, and CDLL-ing a binary from a newer
        # host dies with an uncatchable SIGILL instead of the graceful
        # Python fallback.
        try:
            from .build import _host_tag

            tag = so.with_name(so.name + ".buildtag")
            if (not tag.exists()
                    or tag.read_text().strip() != _host_tag()):
                return None
        except Exception:
            return None
    if not so.exists():
        return None
    lib = ctypes.CDLL(str(so))
    _register(lib)
    _LIB = lib
    return lib


def _register(lib) -> None:
    """Attach restype/argtypes for every entry point."""
    lib.tune_host_allocator.restype = ctypes.c_longlong
    lib.walk_offsets.restype = ctypes.c_longlong
    lib.walk_offsets.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.huffman_fsm_decode.restype = ctypes.c_longlong
    lib.huffman_fsm_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.huffman_fsm_decode_head.restype = ctypes.c_longlong
    lib.huffman_fsm_decode_head.argtypes = lib.huffman_fsm_decode.argtypes
    lib.read_signed_fields.restype = ctypes.c_longlong
    lib.read_signed_fields.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.byte_histogram.restype = ctypes.c_longlong
    lib.byte_histogram.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64)]
    lib.huffman_code_lengths.restype = ctypes.c_longlong
    lib.huffman_code_lengths.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.validate_huffman_dict.restype = ctypes.c_longlong
    lib.validate_huffman_dict.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32]
    lib.parse_huffman_dict.restype = ctypes.c_longlong
    lib.parse_huffman_dict.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32]
    lib.decode_image_pipelined.restype = ctypes.c_longlong
    lib.decode_image_pipelined.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8)]
    lib.pack_fields.restype = ctypes.c_longlong
    lib.pack_fields.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.huffman_pack_bytes.restype = ctypes.c_longlong
    lib.huffman_pack_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong]
    lib.encode_pack_blocks.restype = ctypes.c_longlong
    lib.encode_pack_blocks.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong]
    lib.encode_frame_pack.restype = ctypes.c_longlong
    lib.encode_frame_pack.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
    lib.find_motion.restype = ctypes.c_longlong
    lib.find_motion.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.dct_quantize_exact.restype = ctypes.c_longlong
    lib.dct_quantize_exact.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.dct_quantize_exact_f64.restype = ctypes.c_longlong
    lib.dct_quantize_exact_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.idct_recon_exact.restype = ctypes.c_longlong
    lib.idct_recon_exact.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.dct_exact.restype = ctypes.c_longlong
    lib.dct_exact.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    lib.decode_to_image.restype = ctypes.c_longlong
    lib.decode_to_image.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.decode_to_image_exact.restype = ctypes.c_longlong
    lib.decode_to_image_exact.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.decode_residual_to_image.restype = ctypes.c_longlong
    lib.decode_residual_to_image.argtypes = (
        lib.decode_to_image.argtypes[:-1]
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)])
    lib.decode_residual_to_image_exact.restype = ctypes.c_longlong
    lib.decode_residual_to_image_exact.argtypes = (
        lib.decode_to_image_exact.argtypes[:-1]
        + [ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)])
    lib.predict_frame.restype = ctypes.c_longlong
    lib.predict_frame.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8)]
    lib.extract_coeffs.restype = ctypes.c_longlong
    lib.extract_coeffs.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int16)]


_TUNED = False


def tune_allocator() -> None:
    """Process-wide glibc allocator tuning for the host hot paths: raises
    M_MMAP_THRESHOLD/M_TRIM_THRESHOLD so numpy's tens-of-MB per-frame
    temporaries stay on the heap instead of per-allocation mmap/munmap
    (~3x on the host video path; see runtime.cpp tune_host_allocator).

    Deliberately NOT run at import/load time: it permanently pins RSS at
    the high-water mark, which an embedding application may not want.  The
    host video/image encode and decode entry points call this; library
    consumers touching only individual kernels are left untouched.  Set
    IER_NO_ALLOC_TUNE=1 to disable entirely.
    """
    global _TUNED
    if _TUNED:
        return
    _TUNED = True
    import os

    if os.environ.get("IER_NO_ALLOC_TUNE"):
        return
    lib = _load()
    if lib is not None:
        lib.tune_host_allocator()


def walk_offsets_native(bits: np.ndarray, start_bit: int, n_blocks: int,
                        use_rle: bool, block_size: int,
                        packed: bytes | None = None):
    """Native decode offset-recovery walk over packed BYTES (not the bit array)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    data = (np.frombuffer(packed, dtype=np.uint8) if packed is not None
            else np.packbits(bits))
    offs = np.empty(n_blocks, dtype=np.int64)
    dbits = np.empty(n_blocks, dtype=np.int32)
    counts = np.empty(n_blocks, dtype=np.int32)
    end = lib.walk_offsets(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
        int(start_bit), int(n_blocks), int(bool(use_rle)), int(block_size),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if end < 0:
        raise ValueError("native walk_offsets failed")
    return offs, dbits, counts, int(end)


def huffman_fsm_decode_native(data: bytes, start_bit: int, entries,
                              as_array: bool = False):
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    syms = np.array([e[0] for e in entries], dtype=np.int32)
    words = np.array([e[1] for e in entries], dtype=np.int32)
    lens = np.array([e[2] for e in entries], dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    # Worst case: every bit is a 1-bit code.
    out = np.empty(len(data) * 8 + 8, dtype=np.uint8)
    n = lib.huffman_fsm_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        int(start_bit),
        syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(entries),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out))
    if n < 0:
        raise ValueError("native huffman decode failed")
    return out[:n] if as_array else out[:n].tobytes()


def read_signed_fields_native(data: bytes, start_bit: int, n: int,
                              width: int) -> np.ndarray:
    """n consecutive width-bit sign-extended fields (int32 [n])."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(n, np.int32)
    rc = lib.read_signed_fields(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        int(start_bit), int(n), int(width),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise ValueError("native read_signed_fields failed")
    return out


def huffman_code_lengths_native(freqs: np.ndarray) -> np.ndarray:
    """Huffman tree build -> per-symbol code length (int32 [256]), the
    bit-identical native twin of ops/huffman.py::code_lengths' heap loop
    (length limiting stays in the Python caller).  Raises ValueError when
    fewer than 2 symbols are present."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    f = np.ascontiguousarray(np.asarray(freqs[:256]), dtype=np.int64)
    if f.shape != (256,):
        f = np.pad(f, (0, 256 - f.shape[0]))
    out = np.zeros(256, np.int32)
    rc = lib.huffman_code_lengths(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise ValueError("need >= 2 distinct symbols")
    return out


def validate_huffman_dict_native(entries) -> int:
    """Strict prefix validation of parsed dict entries.

    0 = valid; -1 = zero-length code; -2 = duplicate / non-prefix dict.
    Same semantics as ops/huffman.py's Python loop (which stays as the
    fallback); native because the per-bit tree build cost ~0.2 ms per
    decode in Python.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    words = np.array([e[1] for e in entries], dtype=np.int32)
    lens = np.array([e[2] for e in entries], dtype=np.int32)
    return int(lib.validate_huffman_dict(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(entries)))


def byte_histogram_native(data: bytes) -> np.ndarray:
    """Parallel exact byte histogram (int64 [256])."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(256, np.int64)
    rc = lib.byte_histogram(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc < 0:
        raise ValueError("native byte_histogram failed")
    return out


def parse_huffman_dict_native(data: bytes, start_bit: int = 0):
    """Parse the serialized Huffman dict (ops/huffman.py::parse_dict wire
    grammar) natively.  Returns (entries list of (sym, word, len), end bit
    position)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = 4096
    syms = np.empty(cap, np.int32)
    words = np.empty(cap, np.int32)
    lens = np.empty(cap, np.int32)
    n = ctypes.c_int32(0)
    i32p = ctypes.POINTER(ctypes.c_int32)
    end = lib.parse_huffman_dict(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        int(start_bit), syms.ctypes.data_as(i32p),
        words.ctypes.data_as(i32p), lens.ctypes.data_as(i32p),
        ctypes.byref(n), cap)
    if end < 0:
        raise ValueError("native parse_huffman_dict failed")
    m = int(n.value)
    return (list(zip(syms[:m].tolist(), words[:m].tolist(),
                     lens[:m].tolist())), int(end))


def huffman_fsm_decode_head_native(data: bytes, start_bit: int, entries,
                                   max_out: int = 4096) -> bytes:
    """Serial bounded Huffman decode: the first <= max_out payload symbols
    (enough for any stream header) without touching the rest."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    syms = np.array([e[0] for e in entries], dtype=np.int32)
    words = np.array([e[1] for e in entries], dtype=np.int32)
    lens = np.array([e[2] for e in entries], dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max_out + 8, dtype=np.uint8)
    n = lib.huffman_fsm_decode_head(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        int(start_bit),
        syms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(entries),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), int(max_out))
    if n < 0:
        raise ValueError("native huffman_fsm_decode_head failed")
    return out[:n].tobytes()


def decode_image_pipelined_native(data: bytes, start_bit: int, entries,
                                  hdr_bits: int, n_blocks: int,
                                  use_rle: bool, block_size: int,
                                  zz: np.ndarray, quant: np.ndarray,
                                  wi: np.ndarray, exact: bool, h: int,
                                  w: int) -> np.ndarray:
    """Overlapped Huffman-FSM / offset-walk / extract+IDCT image decode
    (runtime.cpp::decode_image_pipelined).  `entries` is the parsed
    Huffman dict, or None/[] for a non-Huffman stream (then `data` is the
    payload and hdr_bits counts from bit 0 incl. the flag bit).  `quant`
    and `wi` are f64 when exact else f32.  Output is bit-identical to the
    staged chain (huffman_fsm_decode -> walk_offsets ->
    decode_to_image[_exact])."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    entries = entries or []
    syms = np.array([e[0] for e in entries], dtype=np.int32)
    words = np.array([e[1] for e in entries], dtype=np.int32)
    lens = np.array([e[2] for e in entries], dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    k = block_size * block_size
    i32p = ctypes.POINTER(ctypes.c_int32)
    out = np.empty(h * w, dtype=np.uint8)
    if exact:
        q64 = np.ascontiguousarray(
            np.asarray(quant, dtype=np.float64)).reshape(k)
        wi64 = np.ascontiguousarray(wi, dtype=np.float64)
        q32p = ctypes.POINTER(ctypes.c_float)()
        wi32p = ctypes.POINTER(ctypes.c_float)()
        q64p = q64.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        wi64p = wi64.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    else:
        q32 = np.ascontiguousarray(
            np.asarray(quant, dtype=np.float32)).reshape(k)
        wi32 = np.ascontiguousarray(wi, dtype=np.float32)
        q32p = q32.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        wi32p = wi32.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        q64p = ctypes.POINTER(ctypes.c_double)()
        wi64p = ctypes.POINTER(ctypes.c_double)()
    rc = lib.decode_image_pipelined(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        int(start_bit), syms.ctypes.data_as(i32p),
        words.ctypes.data_as(i32p), lens.ctypes.data_as(i32p), len(entries),
        int(hdr_bits), int(n_blocks), int(bool(use_rle)), int(block_size),
        zz32.ctypes.data_as(i32p), q64p, wi64p, q32p, wi32p,
        int(bool(exact)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native decode_image_pipelined failed")
    return out.reshape(h, w)


def pack_fields_native(values: np.ndarray, nbits: np.ndarray,
                       pad_to_bytes: int | None = None):
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    values = np.ascontiguousarray(values, dtype=np.int64)
    nbits32 = np.ascontiguousarray(nbits, dtype=np.int32)
    total_bits = int(np.sum(nbits32, dtype=np.int64))
    data_bytes = (total_bits + 7) // 8
    nbytes = data_bytes
    if pad_to_bytes is not None:
        nbytes = max(nbytes, pad_to_bytes)
    # Uninitialized on purpose: pack_fields writes every data byte with
    # plain stores (its chunked path pre-zeroes the atomic-OR merge
    # bytes); only the pad_to_bytes tail needs explicit zeros.
    out = np.empty(nbytes, dtype=np.uint8)
    out[data_bytes:] = 0
    rc = lib.pack_fields(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        nbits32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(values),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbytes)
    if rc < 0:
        raise ValueError("native pack_fields failed")
    return out.tobytes(), total_bits


def huffman_pack_bytes_native(data: bytes, code_words: np.ndarray,
                              code_lens: np.ndarray, prefix: bytes,
                              prefix_bits: int, total_bits: int):
    """One-pass chunk-parallel Huffman payload pack through a 256-entry
    (code, len) LUT, with the serialized dict `prefix` pre-placed.

    total_bits must be prefix_bits + dot(freqs, lens) (exact — the caller
    knows it from the histogram).  Returns the complete stream bytes.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    d = np.frombuffer(data, dtype=np.uint8)
    cw = np.ascontiguousarray(code_words, dtype=np.uint32)
    cl = np.ascontiguousarray(code_lens, dtype=np.uint8)
    nbytes = (total_bits + 7) // 8
    # Uninitialized on purpose: huffman_pack_bytes pre-zeroes its chunk
    # merge bytes and plain-stores every other byte past the prefix.
    out = np.empty(nbytes, dtype=np.uint8)
    out[:len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    rc = lib.huffman_pack_bytes(
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(d),
        cw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(prefix_bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbytes)
    if rc != total_bits:
        raise ValueError("native huffman_pack_bytes failed")
    return out.tobytes()


def find_motion_native(cur: np.ndarray, ref: np.ndarray,
                       steps) -> np.ndarray:
    """2D-log motion search (Block.cpp:268-339 semantics, see
    ops/motion.py) over all MacroBlocks; returns int32 [N, 2] (x, y)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    c = np.ascontiguousarray(cur, dtype=np.uint8)
    r = np.ascontiguousarray(ref, dtype=np.uint8)
    h, w = c.shape
    st = np.ascontiguousarray(steps, dtype=np.int32)
    out = np.empty(((h // 16) * (w // 16), 2), dtype=np.int32)
    rc = lib.find_motion(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        r.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(st),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise ValueError("native find_motion failed")
    return out


def dct_quantize_exact_native(blocks_u8: np.ndarray, w: np.ndarray,
                              scale: np.ndarray, quant: np.ndarray,
                              zz: np.ndarray) -> np.ndarray:
    """Fused bit-parity forward transform + quantize: u8 [N, K] blocks ->
    int32 [N, K] coefficients in zig-zag order (exact accumulation order +
    separate *scale / quant f64 ops + trunc-based round-half-away, bit
    identical to the numpy chain)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    b = np.ascontiguousarray(blocks_u8, dtype=np.uint8)
    n, k = b.shape
    wc = np.ascontiguousarray(w, dtype=np.float64)
    sc = np.ascontiguousarray(scale, dtype=np.float64)
    qc = np.ascontiguousarray(quant, dtype=np.float64).reshape(k)
    zc = np.ascontiguousarray(zz, dtype=np.int32)
    out = np.empty((n, k), dtype=np.int32)
    rc = lib.dct_quantize_exact(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, k,
        wc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        zc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise ValueError("native dct_quantize_exact failed")
    return out


def dct_quantize_exact_f64_native(blocks: np.ndarray, w: np.ndarray,
                                  scale: np.ndarray, quant: np.ndarray,
                                  zz: np.ndarray) -> np.ndarray:
    """f64-input twin of dct_quantize_exact_native (video residuals)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    b = np.ascontiguousarray(blocks, dtype=np.float64)
    n, k = b.shape
    wc = np.ascontiguousarray(w, dtype=np.float64)
    sc = np.ascontiguousarray(scale, dtype=np.float64)
    qc = np.ascontiguousarray(quant, dtype=np.float64).reshape(k)
    zc = np.ascontiguousarray(zz, dtype=np.int32)
    out = np.empty((n, k), dtype=np.int32)
    rc = lib.dct_quantize_exact_f64(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k,
        wc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        zc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc < 0:
        raise ValueError("native dct_quantize_exact_f64 failed")
    return out


def idct_recon_exact_native(czz: np.ndarray, block_size: int,
                            zz: np.ndarray, wi: np.ndarray,
                            quant: np.ndarray, pred: np.ndarray,
                            h: int, w: int) -> np.ndarray:
    """Exact f64 residual reconstruction: zig-zag int32 coefficients ->
    dequant -> reference-order IDCT -> +128 -> +pred -> clamp, deblockified
    (bit-identical to the numpy chain in _residual_fields_and_recon)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    c = np.ascontiguousarray(czz, dtype=np.int32)
    n, k = c.shape
    zc = np.ascontiguousarray(zz, dtype=np.int32)
    wic = np.ascontiguousarray(wi, dtype=np.float64)
    qc = np.ascontiguousarray(quant, dtype=np.float64).reshape(k)
    p = np.ascontiguousarray(pred, dtype=np.uint8)
    out = np.empty(h * w, dtype=np.uint8)
    rc = lib.idct_recon_exact(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, block_size,
        zc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        wic.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        qc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native idct_recon_exact failed")
    return out.reshape(h, w)


def encode_pack_blocks_native(coeffs_zz: np.ndarray, use_rle: bool,
                              prefix: bytes, prefix_bits: int):
    """One-pass RLE stats + field emission + bit pack over int32 [N, K]
    zig-zag coefficients (Block.cpp:186-232 + 372-413 in one native
    sweep).  `prefix` is the packed stream header (zero-padded tail byte).
    Returns (stream bytes, total_bits)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    c = np.ascontiguousarray(coeffs_zz, dtype=np.int32)
    n, k = c.shape
    cap_bits = prefix_bits + n * (4 + 17 * (k + 1)) + 64
    nbytes = (cap_bits + 7) // 8
    out = np.zeros(nbytes, dtype=np.uint8)
    out[:len(prefix)] = np.frombuffer(prefix, dtype=np.uint8)
    total = lib.encode_pack_blocks(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n, k,
        int(bool(use_rle)), int(prefix_bits),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), nbytes)
    if total < 0:
        raise ValueError("native encode_pack_blocks failed")
    return out[: (int(total) + 7) // 8].tobytes(), int(total)


def encode_frame_pack_native(cur: np.ndarray, pred: np.ndarray | None,
                             quant: np.ndarray, wf: np.ndarray,
                             scale: np.ndarray, wi: np.ndarray | None,
                             zz: np.ndarray, block_size: int, use_rle: bool,
                             mvec: np.ndarray | None, mvec_nbits: int,
                             recon_out: np.ndarray | None, start_bit: int,
                             out: np.ndarray) -> int:
    """One-pass native frame encode into the shared stream buffer `out`
    (u8, may be uninitialized past the pre-placed header prefix — the
    native side pre-zeroes its atomic-OR merge bytes): residual/pixel
    read +
    exact f64 DCT + quantize + RLE stats + mvec fields + chunk-parallel
    record bitpack, plus the reconstruction when `recon_out` is given.
    Returns the new total bit position.  Bit-identical to the
    blockify -> dct_quantize_exact* -> block_stats/fields -> pack_fields
    chain it replaces (Frame.cpp:160-243 in one sweep)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    cur = np.ascontiguousarray(cur, dtype=np.uint8)
    h, w = cur.shape
    k = block_size * block_size
    as_u8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))  # noqa: E731
    as_f64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))  # noqa: E731
    pred_p = None
    if pred is not None:
        pred = np.ascontiguousarray(pred, dtype=np.uint8)
        pred_p = as_u8p(pred)
    wfc = np.ascontiguousarray(wf, dtype=np.float64)
    sc = np.ascontiguousarray(scale, dtype=np.float64)
    qc = np.ascontiguousarray(np.asarray(quant, dtype=np.float64)).reshape(k)
    zc = np.ascontiguousarray(zz, dtype=np.int32)
    mv_p, n_macro = None, 0
    if mvec is not None:
        mvec = np.ascontiguousarray(mvec, dtype=np.int32)
        mv_p = mvec.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_macro = mvec.shape[0]
    wi_p = None
    if wi is not None and recon_out is not None:
        wi = np.ascontiguousarray(wi, dtype=np.float64)
        wi_p = as_f64p(wi)
    rc = lib.encode_frame_pack(
        as_u8p(cur), pred_p, h, w, int(block_size), as_f64p(wfc),
        as_f64p(sc), as_f64p(qc), zc.ctypes.data_as(
            ctypes.POINTER(ctypes.c_int32)),
        int(bool(use_rle)), mv_p, n_macro, int(mvec_nbits), wi_p,
        as_u8p(recon_out) if recon_out is not None else None,
        int(start_bit), as_u8p(out), out.size)
    if rc < 0:
        raise ValueError("native encode_frame_pack failed")
    return int(rc)


def extract_coeffs_native(data: bytes, offsets, dbits, counts,
                          zz, block_size: int) -> np.ndarray:
    """Extract + sign-extend + un-zigzag all block coefficients.

    Returns int16 [N, B*B] in row-major coefficient order.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    dbits = np.ascontiguousarray(dbits, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    n = len(offsets)
    k = block_size * block_size
    out = np.zeros(n * k, dtype=np.int16)
    rc = lib.extract_coeffs(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
        zz32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), block_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
    if rc < 0:
        raise ValueError("native extract_coeffs failed")
    return out.reshape(n, k)


def decode_to_image_exact_native(data: bytes, offsets, dbits, counts, zz,
                                 block_size: int, quant: np.ndarray,
                                 wi: np.ndarray, h: int,
                                 w: int) -> np.ndarray:
    """f64 BIT-PARITY twin of decode_to_image_native: reference-order f64
    inverse DCT (dct_exact accumulation order), dequant, clamp and
    deblockify fused — output bit-identical to the numpy chain
    (extract -> inverse_transform -> clamp_to_u8 -> deblockify)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    dbits = np.ascontiguousarray(dbits, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    quant = np.ascontiguousarray(np.asarray(quant).ravel(), dtype=np.float64)
    wi = np.ascontiguousarray(wi, dtype=np.float64)
    out = np.empty(h * w, dtype=np.uint8)
    rc = lib.decode_to_image_exact(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(offsets),
        zz32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), block_size,
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        wi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native decode_to_image_exact failed")
    return out.reshape(h, w)


def decode_to_image_native(data: bytes, offsets, dbits, counts, zz,
                           block_size: int, quant: np.ndarray,
                           wi: np.ndarray, h: int, w: int) -> np.ndarray:
    """Fused extract + dequant + inverse DCT + clamp + deblockify.

    quant: f32 [k] row-major; wi: f32 [k, k] inverse weights
    (y_flat = (coeffs * quant) @ wi + 128, the inverse_transform_fast
    contraction).  Returns the decoded [h, w] uint8 image directly.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    dbits = np.ascontiguousarray(dbits, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    quant = np.ascontiguousarray(np.asarray(quant).ravel(), dtype=np.float32)
    wi = np.ascontiguousarray(wi, dtype=np.float32)
    out = np.empty(h * w, dtype=np.uint8)
    rc = lib.decode_to_image(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(offsets),
        zz32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), block_size,
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native decode_to_image failed")
    return out.reshape(h, w)


def decode_residual_to_image_exact_native(
        data: bytes, offsets, dbits, counts, zz, block_size: int,
        quant: np.ndarray, wi: np.ndarray, pred: np.ndarray, h: int,
        w: int) -> np.ndarray:
    """f64 BIT-PARITY P-frame fused decode: residual extract + exact-order
    IDCT + prediction add + clamp + deblockify.  quant/wi are f64."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    dbits = np.ascontiguousarray(dbits, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    quant = np.ascontiguousarray(np.asarray(quant).ravel(), dtype=np.float64)
    wi = np.ascontiguousarray(wi, dtype=np.float64)
    pred = np.ascontiguousarray(pred, dtype=np.uint8)
    out = np.empty(h * w, dtype=np.uint8)
    rc = lib.decode_residual_to_image_exact(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(offsets),
        zz32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), block_size,
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        wi.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), h, w,
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native decode_residual_to_image_exact failed")
    return out.reshape(h, w)


def decode_residual_to_image_native(data: bytes, offsets, dbits, counts,
                                    zz, block_size: int, quant: np.ndarray,
                                    wi: np.ndarray, pred: np.ndarray,
                                    h: int, w: int) -> np.ndarray:
    """P-frame fused decode: residual extract + IDCT + pred add + clamp
    + deblockify (out = clamp(pred + IDCT + 128)).  pred: u8 [h, w]."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    buf = np.frombuffer(data, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    dbits = np.ascontiguousarray(dbits, dtype=np.int32)
    counts = np.ascontiguousarray(counts, dtype=np.int32)
    zz32 = np.ascontiguousarray(zz, dtype=np.int32)
    quant = np.ascontiguousarray(np.asarray(quant).ravel(), dtype=np.float32)
    wi = np.ascontiguousarray(wi, dtype=np.float32)
    pred = np.ascontiguousarray(pred, dtype=np.uint8)
    out = np.empty(h * w, dtype=np.uint8)
    rc = lib.decode_residual_to_image(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbits.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(offsets),
        zz32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), block_size,
        quant.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        wi.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native decode_residual_to_image failed")
    return out.reshape(h, w)


def predict_frame_native(ref: np.ndarray, mvec: np.ndarray) -> np.ndarray:
    """Motion-compensated prediction assembly (16x16 clamped windows)."""
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    h, w = ref.shape
    mv = np.ascontiguousarray(mvec, dtype=np.int32)
    out = np.empty((h, w), dtype=np.uint8)
    rc = lib.predict_frame(
        ref.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        mv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc < 0:
        raise ValueError("native predict_frame failed")
    return out


def dct_exact_native(blocks: np.ndarray, w: np.ndarray,
                     scale: np.ndarray | None) -> np.ndarray:
    """Bit-exact reference-order DCT accumulation (OpenMP over blocks).

    blocks: f64 [N, k]; w: f64 [k, k]; scale: f64 [k] or None.
    Returns f64 [N, k]; identical bits to the numpy 16-step loop.
    """
    lib = _load()
    if lib is None:
        raise ImportError("native runtime not built")
    blocks = np.ascontiguousarray(blocks, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    n, k = blocks.shape
    out = np.empty_like(blocks)
    scale_p = None
    if scale is not None:
        scale = np.ascontiguousarray(scale, dtype=np.float64)
        scale_p = scale.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.dct_exact(
        blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, k,
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), scale_p,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc < 0:
        raise ValueError("native dct_exact failed")
    return out


def available() -> bool:
    return _load() is not None


_WARNED: set = set()


def warn_fallback(stage: str, exc: BaseException) -> None:
    """Log — once per stage per process — that a native fast path demoted
    to its Python/numpy fallback.  The fallbacks are orders of magnitude
    slower (the pure-Python offset walk is O(bits) interpreted), so a
    silent demotion would look like a performance bug; surface it."""
    if stage in _WARNED:
        return
    _WARNED.add(stage)
    import warnings

    warnings.warn(
        f"native runtime unavailable for {stage} "
        f"({type(exc).__name__}: {exc}); falling back to the slow "
        "Python path", RuntimeWarning, stacklevel=3)
