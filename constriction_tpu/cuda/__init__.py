"""Hopper kernels of the ILANS2 device coder, called through ``jax.ffi``.

The CUDA sources sit next to this file; :func:`build` compiles them with
``nvcc`` for ``sm_90a`` into ``_build/`` (listed in ``.gitignore``) the
first time a kernel is needed, or ahead of time with
``python -c "import constriction_tpu.cuda as c; c.build(verbose=True)"``.
The build is rerun when a source is newer than the library.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("ilans2.cu",)
BUILD_DIR = os.path.join(HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libctpu_cuda.so")

# FFI target name -> exported handler symbol
TARGETS = {
    "ctpu_ilans2_decode_u32": "CtpuIlans2Decode32",
    "ctpu_ilans2_decode_u64": "CtpuIlans2Decode64",
    "ctpu_ilans2_encode_u32": "CtpuIlans2Encode32",
    "ctpu_ilans2_encode_u64": "CtpuIlans2Encode64",
}

# decode bucket table: exact quantile -> symbol lookup up to this precision
TABLE_BITS = 12


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(HERE, s)) > built
               for s in SOURCES)


def build(verbose: bool = False) -> str:
    """Compile the kernels into ``_build/libctpu_cuda.so`` if stale."""
    import jax

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _stale():
            return LIB_PATH
        tmp = LIB_PATH + f".{os.getpid()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            # the FFI headers trip these warnings; the kernels do not
            "-diag-suppress", "940,2473", "-Xcompiler", "-Wno-return-type",
            "-Xcompiler", "-Wno-attributes",
            "-I", jax.ffi.include_dir(), "-o", tmp,
            *[os.path.join(HERE, s) for s in SOURCES],
        ]
        if verbose:
            print(" ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


_registered = False


def register() -> None:
    """Build if needed, load the library, register its FFI targets."""
    global _registered
    if _registered:
        return
    import jax

    lib = ctypes.cdll.LoadLibrary(build())
    for name, symbol in TARGETS.items():
        jax.ffi.register_ffi_target(
            name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
        )
    _registered = True


def bucket_table(cdf: np.ndarray, precision: int) -> np.ndarray:
    """u32[2^b + 1] with b = min(P, TABLE_BITS): entry i is the largest
    symbol whose left cumulative is <= i << (P - b).  Exact lookup for
    P <= TABLE_BITS; above, it brackets a binary search over the CDF."""
    b = min(precision, TABLE_BITS)
    bases = np.arange((1 << b) + 1, dtype=np.uint64) << np.uint64(
        precision - b)
    return (np.searchsorted(np.asarray(cdf, np.uint64), bases, side="right")
            - 1).astype(np.uint32)


def decode_blocks(states, streams, lens, cdf, tbl, nsym, *, cfg, T: int):
    """FFI twin of ``jax_coder2.decode_blocks`` (``tbl`` from
    :func:`bucket_table`)."""
    import jax
    import jax.numpy as jnp

    register()
    B, L = states.shape
    suffix = "u64" if cfg.state_bits > 32 else "u32"
    return jax.ffi.ffi_call(
        f"ctpu_ilans2_decode_{suffix}",
        (jax.ShapeDtypeStruct((B, T * L), jnp.int32),
         jax.ShapeDtypeStruct((B, L), states.dtype)),
    )(states, streams, lens, cdf, tbl, nsym,
      word_bits=np.int64(cfg.word_bits), precision=np.int64(cfg.precision),
      table_bits=np.int64(min(cfg.precision, TABLE_BITS)))


def encode_blocks(syms, seeds, cdf, nsym, *, cfg, T: int):
    """FFI twin of ``jax_coder2.encode_blocks``."""
    import jax
    import jax.numpy as jnp

    register()
    B, L = seeds.shape
    suffix = "u64" if cfg.state_bits > 32 else "u32"
    return jax.ffi.ffi_call(
        f"ctpu_ilans2_encode_{suffix}",
        (jax.ShapeDtypeStruct((B, T * L), jnp.uint32),
         jax.ShapeDtypeStruct((B, L), seeds.dtype),
         jax.ShapeDtypeStruct((B,), jnp.int32)),
    )(syms, seeds, cdf, nsym,
      word_bits=np.int64(cfg.word_bits), precision=np.int64(cfg.precision))

