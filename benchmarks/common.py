"""What the benchmark, the suite and chip_smoke.py share: the compile
cache, the GPU check, the card's name and power limit, the flagship
workload, and a timer."""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# used only when JAX_COMPILATION_CACHE_DIR is not set; listed in .gitignore
CACHE_DIR = os.path.join(ROOT, ".jax_cache")

# the flagship cell: 2^24 i.i.d. symbols over 32768 lanes from a K=100
# Dirichlet(2) categorical model
FLAGSHIP_SYMBOLS = 1 << 24
FLAGSHIP_LANES = 1 << 15
FLAGSHIP_ALPHABET = 100


def enable_compile_cache() -> str:
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says (JAX reads the variable itself); otherwise in CACHE_DIR."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def require_gpu():
    """The default JAX device, or exit 1 when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: needs an NVIDIA GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    return dev


def card() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def flagship(seed: int, precision: int, n: int = FLAGSHIP_SYMBOLS):
    """``(symbols int64[n], cdf)``: the flagship data made from ``seed``."""
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )

    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(FLAGSHIP_ALPHABET, 2.0))
    symbols = rng.choice(FLAGSHIP_ALPHABET, size=n, p=probs).astype(np.int64)
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision
    ).cdf
    return symbols, cdf


def timed(fn, reps: int):
    """Run ``fn`` once to warm up, then ``reps`` times; returns the median
    and the (min, max) of the wall times in seconds.  ``fn`` must block
    until its device work is done (numpy results do)."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), (min(ts), max(ts))
