"""Differential fuzz: random models x random messages x random presets,
round-tripped through every host coder and cross-checked between the native
(C++) and numpy paths.

Runs a quick pass by default (~5 s); set ``CTPU_FUZZ_SECONDS=600`` for an
extended soak.  Any failure prints the reproducing seed.
"""

import os
import time

import numpy as np
import pytest

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
    LazyContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops.ans import AnsCoderCore
from constriction_tpu.ops.range import RangeDecoderCore, RangeEncoderCore

FUZZ_SECONDS = float(os.environ.get("CTPU_FUZZ_SECONDS", "5"))

# (word_bits, state_bits) presets whose precision budget covers the model;
# mirrors the reference matrix breadth (tests/random_data.rs:158-192) plus
# odd 24/48-bit states
PRESETS = [
    (16, 32), (32, 64), (16, 48), (8, 24),
    (8, 16), (8, 32), (8, 64), (16, 64), (32, 128), (64, 128), (16, 128),
]


def _random_probabilities(rng, K: int, kinds) -> np.ndarray:
    """Shared distribution generator for all fuzz legs (flat / skewed /
    tiny-tail / two-hot shapes)."""
    kind = rng.choice(list(kinds))
    if kind == "flat":
        p = np.ones(K) / K
    elif kind == "skewed":
        p = rng.dirichlet(np.full(K, 0.05))
    elif kind == "tiny-tail":
        p = rng.dirichlet(np.ones(K))
        p[-1] = 1e-12
        p /= p.sum()
    else:  # two-hot
        p = np.full(K, 1e-9)
        p[rng.randint(K)] = 0.5
        p[rng.randint(K)] += 0.5 - p.sum() + 1e-9 * K
        p = np.abs(p) / np.abs(p).sum()
    return p


def _random_categorical(rng, P: int, kinds, allow_lazy: bool):
    """Random categorical model at precision P, or None when the quantizer
    legitimately rejects the draw.  Returns (model, K)."""
    K = int(rng.choice([2, 3, 7, 50, 300, 1000]))
    if K >= (1 << P) - 1:
        K = (1 << P) - 2
    p = _random_probabilities(rng, K, kinds)
    lazy = allow_lazy and bool(rng.randint(2)) and P >= 12
    cls = (LazyContiguousCategoricalEntropyModel if lazy
           else ContiguousCategoricalEntropyModel)
    try:
        model = cls.from_floating_point_probabilities_fast(p, P)
    except ValueError:
        return None  # legitimately rejected quantization
    return model, K


def _round_trip_once(seed: int) -> bool:
    """Returns True only when a round trip was actually asserted."""
    rng = np.random.RandomState(seed)
    P = int(rng.choice([8, 12, 16, 24]))
    made = _random_categorical(
        rng, P, ("flat", "skewed", "tiny-tail", "two-hot"), allow_lazy=True
    )
    if made is None:
        return False
    model, K = made
    W, S = PRESETS[rng.randint(len(PRESETS))]
    if P > W or S < W + P:
        return False  # incompatible preset; the coders reject it by design
    n = int(rng.choice([0, 1, 63, 64, 65, 500, 4097]))
    cdf = np.asarray(model.cdf if hasattr(model, "cdf") else None)
    probs_f = (np.diff(cdf.astype(np.int64)) / (1 << P)
               if cdf is not None and cdf.ndim else None)
    if probs_f is None:
        b = model._boundaries()
        probs_f = np.diff(b.astype(np.int64)) / (1 << P)
    symbols = rng.choice(K, size=n, p=probs_f / probs_f.sum()).astype(np.int64)

    # ANS
    ans = AnsCoderCore(W, S)
    ans.encode_iid_symbols_reverse(symbols, model)
    dec = AnsCoderCore.from_compressed(ans.get_compressed(), W, S)
    out = dec.decode_iid_symbols(n, model)
    np.testing.assert_array_equal(out, symbols, err_msg=f"ANS seed={seed}")

    # Range
    enc = RangeEncoderCore(W, S)
    enc.encode_iid_symbols(symbols, model)
    rdec = RangeDecoderCore.from_compressed(enc.get_compressed(), W, S)
    out = rdec.decode_iid_symbols(n, model)
    np.testing.assert_array_equal(out, symbols, err_msg=f"range seed={seed}")

    # Chain bits-back (default preset only: the chain coder pins W/S/P)
    if (W, S) == (32, 64) and P == 24 and n:
        import constriction_tpu as constriction

        words = rng.randint(0, 2**32, size=max(n * 2, 8),
                            dtype=np.uint64).astype(np.uint32)
        cc = constriction.stream.chain.ChainCoder(words, seal=True)
        try:
            dec_syms = cc.decode(_PublicModel(model), n)
        except (ValueError, AssertionError):
            return True  # ANS+range asserted; chain legitimately out of data
        pre, suf = cc.get_remainders()
        cc2 = constriction.stream.chain.ChainCoder(
            np.concatenate([pre, suf]), is_remainders=True
        )
        cc2.encode_reverse(dec_syms.astype(np.int32), _PublicModel(model))
        dp, ds = cc2.get_data(unseal=True)
        np.testing.assert_array_equal(
            np.concatenate([dp, ds]), words, err_msg=f"chain seed={seed}"
        )
    return True


class _PublicModel:
    """Adapter presenting a core entropy model through the public Model
    protocol (concrete model, no family parameters)."""

    def __init__(self, core):
        self._core = core

    def _as_parameterized(self):
        return self._core

    def _parameterize(self, args):
        raise ValueError("no family parameters in the fuzz harness")


def test_fuzz_round_trips():
    deadline = time.monotonic() + FUZZ_SECONDS
    base = int(os.environ.get("CTPU_FUZZ_BASE_SEED", "1000000"))
    attempts = count = 0
    while time.monotonic() < deadline:
        count += bool(_round_trip_once(base + attempts))
        attempts += 1
    assert count > 0, f"no round trip exercised in {attempts} attempts"
    print(f"fuzz: {count}/{attempts} random round trips OK")


def _family_round_trip_once(seed: int) -> None:
    import constriction_tpu as constriction

    rng = np.random.RandomState(seed)
    kind = ["gaussian", "laplace", "cauchy"][rng.randint(3)]
    n = int(rng.choice([1, 5, 64, 200, 1000]))
    lo, hi = -int(rng.choice([10, 100, 1000])), int(rng.choice([10, 100, 1000]))
    means = rng.uniform(lo, hi, size=n)
    scales = 10.0 ** rng.uniform(-2, 2, size=n)
    Fam = {
        "gaussian": constriction.stream.model.QuantizedGaussian,
        "laplace": constriction.stream.model.QuantizedLaplace,
        "cauchy": constriction.stream.model.QuantizedCauchy,
    }[kind]
    fam = Fam(lo, hi)
    symbols = np.clip(
        np.round(means + rng.randn(n) * scales), lo, hi
    ).astype(np.int32)

    enc = constriction.stream.stack.AnsCoder()
    enc.encode_reverse(symbols, fam, means, scales)
    dec = constriction.stream.stack.AnsCoder(enc.get_compressed())
    out = dec.decode(fam, means, scales)
    np.testing.assert_array_equal(out, symbols, err_msg=f"{kind} seed={seed}")

    renc = constriction.stream.queue.RangeEncoder()
    renc.encode(symbols, fam, means, scales)
    rdec = renc.get_decoder()
    out = rdec.decode(fam, means, scales)
    np.testing.assert_array_equal(
        out, symbols, err_msg=f"range {kind} seed={seed}"
    )
    return True


def test_fuzz_family_round_trips():
    deadline = time.monotonic() + FUZZ_SECONDS
    base = int(os.environ.get("CTPU_FUZZ_BASE_SEED", "1000000")) + 500_000_000
    attempts = count = 0
    while time.monotonic() < deadline:
        count += bool(_family_round_trip_once(base + attempts))
        attempts += 1
    assert count > 0, f"no round trip exercised in {attempts} attempts"
    print(f"family fuzz: {count}/{attempts} random round trips OK")


def _device_round_trip_once(seed: int) -> bool:
    """Fuzz the DEVICE paths: the ILANS2 facade (the device coder; its XLA
    route on the CPU) and the sharded container, cross-checking the device
    container bytes against the bit-identical host encoder.  Returns True
    only when the round-trip assertions actually ran."""
    from constriction_tpu import parallel, tpu
    from constriction_tpu.ops.interleaved import LaneConfig

    rng = np.random.RandomState(seed)
    W, S, P = [(16, 32, 8), (16, 32, 12), (16, 32, 16),
               (32, 64, 24)][rng.randint(4)]
    made = _random_categorical(
        rng, P, ("flat", "skewed", "tiny-tail"), allow_lazy=False
    )
    if made is None:
        return False
    model, K = made
    cdf = np.asarray(model.cdf)
    probs_f = np.diff(cdf.astype(np.int64)).astype(np.float64)
    n = int(rng.choice([1, 63, 129, 500, 4000]))
    symbols = rng.choice(K, size=n, p=probs_f / probs_f.sum()).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=W, state_bits=S, precision=P)

    # ILANS2 facade round trip through the device coder, alternating the
    # compact v2 framing (recovered-seed region split engages at the
    # larger n draws) and the raw v1 container
    container = tpu.encode_iid(
        symbols, cdf, cfg, compact=bool(rng.randint(2))
    )
    out = tpu.decode_iid(container, cdf)
    np.testing.assert_array_equal(out, symbols, err_msg=f"facade seed={seed}")

    # sharded container: device bytes == host bytes, and both decode;
    # compact v2 (pooled-tail seed recovery) alternates in for rANS; range
    # containers are coded on the host
    B = int(rng.choice([1, 2, 3]))
    coder = ["rans", "range"][rng.randint(2)]
    compact = coder == "rans" and bool(rng.randint(2))
    c_host = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=B,
                             device=False, coder=coder, compact=compact)
    c_dev = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=B,
                            device=coder == "rans", coder=coder,
                            compact=compact)
    np.testing.assert_array_equal(
        c_host, c_dev,
        err_msg=f"container bytes ({coder}, compact={compact}) seed={seed}",
    )
    out = parallel.decode(c_dev, cdf,
                          device=coder == "rans" and bool(rng.randint(2)))
    np.testing.assert_array_equal(
        out, symbols,
        err_msg=f"container ({coder}, compact={compact}) seed={seed}",
    )
    return True


def test_fuzz_device_round_trips():
    deadline = time.monotonic() + FUZZ_SECONDS
    base = int(os.environ.get("CTPU_FUZZ_BASE_SEED", "1000000")) + 900_000_000
    attempts = count = 0
    while time.monotonic() < deadline:
        count += bool(_device_round_trip_once(base + attempts))
        attempts += 1
    assert count > 0, f"no round trip exercised in {attempts} attempts"
    print(f"device fuzz: {count}/{attempts} random round trips OK")
