"""ctypes bindings for the native host codec (libctpu.so).

Import is failure-tolerant: if the shared library is missing it is built on
first use when a compiler is available; otherwise ``LIB`` is None and callers
fall back to the pure-Python/numpy paths.  Set ``CTPU_NATIVE=0`` to force the
fallback, ``CTPU_NATIVE=1`` to require the native path.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# CTPU_NATIVE_SO overrides the library path (used by the sanitizer job to
# load the ASan/UBSan build; see tests/test_sanitizer.py)
_SO = os.environ.get("CTPU_NATIVE_SO") or os.path.join(_HERE, "libctpu.so")

u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


class RangeEncState(ctypes.Structure):
    _fields_ = [
        ("lower", ctypes.c_uint64),
        ("range", ctypes.c_uint64),
        ("num_inverted", ctypes.c_uint64),
        ("first_inverted", ctypes.c_uint32),
    ]


class RangeDecState(ctypes.Structure):
    _fields_ = [
        ("lower", ctypes.c_uint64),
        ("range", ctypes.c_uint64),
        ("point", ctypes.c_uint64),
        ("cursor", ctypes.c_int64),
    ]


class ChainState(ctypes.Structure):
    _fields_ = [
        ("head_compressed", ctypes.c_uint64),
        ("head_remainders", ctypes.c_uint64),
        ("compressed_len", ctypes.c_int64),
        ("remainders_len", ctypes.c_int64),
    ]


def _stale() -> bool:
    """Rebuild when a C++ source is newer than the .so (source edits must
    not be silently shadowed by an old binary)."""
    if not os.path.exists(_SO):
        return True
    try:
        so_m = os.path.getmtime(_SO)
        return any(
            os.path.getmtime(os.path.join(_HERE, f)) > so_m
            for f in ("codec.cpp", "surrogate.cpp")
        )
    except OSError:
        return True


def _load() -> Optional[ctypes.CDLL]:
    if os.environ.get("CTPU_NATIVE", "1") == "0":
        return None
    if not os.environ.get("CTPU_NATIVE_SO") and _stale():
        try:
            from . import build

            build.build(verbose=False)
        except Exception:
            if os.environ.get("CTPU_NATIVE") == "1":
                raise
            if not os.path.exists(_SO):
                return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        if os.environ.get("CTPU_NATIVE") == "1":
            raise
        return None

    try:
        return _bind(lib)
    except AttributeError as e:
        # The .so predates a binding (possible only with CTPU_NATIVE_SO
        # pointing at an old build; the default path rebuilds on staleness).
        if os.environ.get("CTPU_NATIVE") == "1":
            raise RuntimeError(
                f"native library {_SO} is stale (missing symbol): {e}; "
                "rebuild it with python -m constriction_tpu.native.build"
            ) from e
        return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ctpu_erf_array.restype = None
    lib.ctpu_erf_array.argtypes = [f64p, f64p, c.c_int64]
    lib.ctpu_erfc_array.restype = None
    lib.ctpu_erfc_array.argtypes = [f64p, f64p, c.c_int64]
    lib.ctpu_exact_boundaries.restype = c.c_int64
    lib.ctpu_exact_boundaries.argtypes = [
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        f64p, f64p, c.c_int64, c.c_int32, u32p, u32p,
    ]
    lib.ctpu_exact_ncore.restype = None
    lib.ctpu_exact_ncore.argtypes = [
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        f64p, f64p, c.c_int64, u32p,
    ]
    lib.ctpu_surrogate_window.restype = None
    lib.ctpu_surrogate_window.argtypes = [
        c.c_int32, c.c_double, c.c_double, c.c_double,
        c.c_int64, c.c_int64, f64p,
    ]
    lib.ctpu_quantized_ecp.restype = c.c_int32
    lib.ctpu_quantized_ecp.argtypes = [
        c.c_int32, c.c_int32, c.c_int32, c.c_int32,
        i32p, f64p, f64p, c.c_int64, u32p, u32p,
    ]
    lib.ctpu_binomial_ecp.restype = c.c_int32
    lib.ctpu_binomial_ecp.argtypes = [
        c.c_int32, i32p, i32p, f64p, c.c_int64, u32p, u32p,
    ]
    lib.ctpu_ans_encode_reverse.restype = c.c_int64
    lib.ctpu_ans_encode_reverse.argtypes = [
        c.POINTER(c.c_uint64), u32p, c.c_int64,
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_ans_decode_lookup.restype = c.c_int64
    lib.ctpu_ans_decode_lookup.argtypes = [
        c.POINTER(c.c_uint64), u32p, c.c_int64,
        u32p, u32p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_ans_decode_cdf.restype = c.c_int64
    lib.ctpu_ans_decode_cdf.argtypes = [
        c.POINTER(c.c_uint64), u32p, c.c_int64,
        u32p, c.c_int64, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_ans_decode_quantized.restype = c.c_int64
    lib.ctpu_ans_decode_quantized.argtypes = [
        c.POINTER(c.c_uint64), u32p, c.c_int64,
        c.c_int32, c.c_int32, c.c_int32, f64p, f64p,
        i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_range_encode.restype = c.c_int64
    lib.ctpu_range_encode.argtypes = [
        c.POINTER(RangeEncState), u32p, c.c_int64,
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_range_decode_lookup.restype = c.c_int64
    lib.ctpu_range_decode_lookup.argtypes = [
        c.POINTER(RangeDecState), u32p, c.c_int64,
        u32p, u32p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_range_decode_quantized.restype = c.c_int64
    lib.ctpu_range_decode_quantized.argtypes = [
        c.POINTER(RangeDecState), u32p, c.c_int64,
        c.c_int32, c.c_int32, c.c_int32, f64p, f64p,
        i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_ilans_encode.restype = None
    lib.ctpu_ilans_encode.argtypes = [
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        u32p, c.c_int64, i64p,
    ]
    lib.ctpu_ilans_decode_lookup.restype = None
    lib.ctpu_ilans_decode_lookup.argtypes = [
        u32p, c.c_int64, i64p, c.c_int64, c.c_int32, c.c_int32,
        u32p, u32p, c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_ilans2_encode.restype = c.c_int64
    lib.ctpu_ilans2_encode.argtypes = [
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        u32p, u32p, c.c_int64,
    ]
    lib.ctpu_ilans2_encode_seeded.restype = c.c_int64
    lib.ctpu_ilans2_encode_seeded.argtypes = [
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32,
        u32p, u32p, u32p, c.c_int64,
    ]
    lib.ctpu_ilans2_decode_cdf64.restype = None
    lib.ctpu_ilans2_decode_cdf64.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, c.c_int32, c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_ilans2_decode_cdf64_l1.restype = None
    lib.ctpu_ilans2_decode_cdf64_l1.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, c.c_int32, u32p, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_ilans2_range_decode_cdf_l1.restype = c.c_int64
    lib.ctpu_ilans2_range_decode_cdf_l1.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, c.c_int32, u32p, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_ilans2_decode_lookup.restype = None
    lib.ctpu_ilans2_decode_lookup.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, u32p, c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_ilans2_decode_ckpt.restype = None
    lib.ctpu_ilans2_decode_ckpt.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, u32p, c.c_int32, c.c_int32, c.c_int32, i32p,
        c.c_int64, i64p, u32p,
    ]
    lib.ctpu_ilans2_range_encode.restype = c.c_int64
    lib.ctpu_ilans2_range_encode.argtypes = [
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32,
        c.c_int32, c.c_int32, c.c_int32, u32p, u32p,
    ]
    lib.ctpu_ilans2_range_decode_lookup.restype = c.c_int64
    lib.ctpu_ilans2_range_decode_lookup.argtypes = [
        u32p, u32p, c.c_int64, c.c_int64, c.c_int32, c.c_int32,
        u32p, u32p, c.c_int32, c.c_int32, c.c_int32, i32p,
    ]
    lib.ctpu_chain_decode_lookup.restype = c.c_int64
    lib.ctpu_chain_decode_lookup.argtypes = [
        c.POINTER(ChainState), u32p, u32p, c.c_int64,
        u32p, u32p, i32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    lib.ctpu_chain_encode_reverse.restype = c.c_int64
    lib.ctpu_chain_encode_reverse.argtypes = [
        c.POINTER(ChainState), u32p, c.c_int64, u32p,
        u32p, u32p, c.c_int64, c.c_int32, c.c_int32, c.c_int32,
    ]
    return lib


LIB = _load()


def available() -> bool:
    return LIB is not None


DIST_KIND = {"gaussian": 0, "laplace": 1, "cauchy": 2, "binomial": 3}


def ilans_encode(cums, probs, num_symbols, cfg, num_steps, max_words):
    """OpenMP-parallel interleaved encode; bit-identical to the numpy path."""
    L = cfg.num_lanes
    words = np.zeros((L, max_words), dtype=np.uint32)
    counts = np.zeros(L, dtype=np.int64)
    LIB.ctpu_ilans_encode(
        np.ascontiguousarray(cums, dtype=np.uint32),
        np.ascontiguousarray(probs, dtype=np.uint32),
        num_symbols, L, num_steps,
        cfg.word_bits, cfg.state_bits, cfg.precision,
        words, max_words, counts,
    )
    return words, counts


def ilans_decode_lookup(words, counts, num_symbols, lookup, cdf, cfg, num_steps):
    L = cfg.num_lanes
    out = np.zeros(num_steps * L, dtype=np.int32)
    LIB.ctpu_ilans_decode_lookup(
        np.ascontiguousarray(words, dtype=np.uint32),
        words.shape[1], np.ascontiguousarray(counts, dtype=np.int64),
        num_symbols, L, num_steps,
        np.ascontiguousarray(lookup, dtype=np.uint32),
        np.ascontiguousarray(cdf, dtype=np.uint32),
        cfg.word_bits, cfg.state_bits, cfg.precision, out,
    )
    return out[:num_symbols]
