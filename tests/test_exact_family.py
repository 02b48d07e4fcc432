"""Reference-exact families (ops/exact_family.py): host tables and oracle.

The golden contract: the compact boundary tables must equal the host f64
LeakyQuantizer's bit-for-bit over random (mean, scale), and a round trip
through them must be exact.  The host quantizer itself is
golden-verified against the reference (tests/test_golden_reference.py), so
equality here chains to quantize.rs:525-568.

The (mean, scale) sample count scales with CTPU_EXACT_SOAK_N (default
2000 per family; the full 10^6 soak: CTPU_EXACT_SOAK_N=1000000
python -m pytest tests/test_exact_family.py -k golden -v).
"""

import os

import numpy as np
import pytest

from constriction_tpu.models.quantized import (
    Cauchy,
    Gaussian,
    Laplace,
    LeakyQuantizer,
)
from constriction_tpu.ops import exact_family as ef
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops.interleaved import LaneConfig

P, MIN, MAX = 12, -100, 100
DIST = {"gaussian": Gaussian, "laplace": Laplace, "cauchy": Cauchy}
CMAX = {"gaussian": 128, "laplace": 202, "cauchy": 202}
SOAK_N = int(os.environ.get("CTPU_EXACT_SOAK_N", "2000"))


def _params(rng, n):
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(8.0), n))
    return means, scales


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_golden_tables_vs_host_quantizer(family):
    """Full-table equality: every (sym, cum, prob) the compact
    tables produce equals the host f64 LeakyQuantizer's quantile_function,
    over random (mean, scale) and a quantile sample per model."""
    rng = np.random.RandomState(hash(family) % (1 << 31))
    n = SOAK_N
    means, scales = _params(rng, n)
    aux, core = ef.exact_boundary_tables(
        means, scales, family, MIN, MAX, P, CMAX[family]
    )
    quant = LeakyQuantizer(MIN, MAX, P)
    # spot-verify a subsample per model against the scalar qf oracle (the
    # scalar oracle is slow; the table *construction* above is the full
    # 2-eval-per-boundary exact computation for all n models)
    check = rng.choice(n, size=min(n, 300), replace=False)
    qs = np.unique(
        np.concatenate([rng.randint(0, 1 << P, 40), [0, (1 << P) - 1]])
    )
    for i in check:
        m = quant.quantize(DIST[family](means[i], scales[i]))
        sym, cum, prob = ef._invert_with_tables(
            qs,
            np.repeat(aux[i : i + 1], len(qs)),
            np.repeat(core[i : i + 1], len(qs), axis=0),
            MIN, MAX, P,
        )
        for j, q in enumerate(qs):
            ws, wc, wp = m.qf(int(q))
            assert (sym[j], cum[j], prob[j]) == (ws, wc, wp), (
                family, i, q, means[i], scales[i]
            )
    # ecp twin over the full sample
    syms = np.clip(
        np.round(means + rng.randn(n) * scales), MIN, MAX
    ).astype(np.int64)
    cums, probs = ef.exact_ecp(syms, means, scales, family, MIN, MAX, P)
    for i in check:
        m = quant.quantize(DIST[family](means[i], scales[i]))
        wc, wp = m.ecp(int(syms[i]))
        assert (int(cums[i]), int(probs[i])) == (wc, wp), (family, i)
    # table-level consistency for ALL n models: the boundary tables and the
    # ecp tables must agree (cum from inversion at q=cum equals ecp's)
    sym2, cum2, prob2 = ef._invert_with_tables(
        cums.astype(np.int64), aux, core, MIN, MAX, P
    )
    np.testing.assert_array_equal(sym2, syms)
    np.testing.assert_array_equal(cum2, cums.astype(np.uint64))
    np.testing.assert_array_equal(prob2, probs.astype(np.uint64))


def test_edge_cases():
    """Means far outside the support, near-delta scales, and the cmax
    guard."""
    rng = np.random.RandomState(9)
    quant = LeakyQuantizer(MIN, MAX, P)
    means = np.array([-1e4, 1e4, -100.0, 100.0, 0.0, 3.25])
    scales = np.array([1.0, 1.0, 0.02, 0.02, 1e-6, 5.0])
    aux, core = ef.exact_boundary_tables(
        means, scales, "gaussian", MIN, MAX, P, 128
    )
    qs = np.unique(np.concatenate([rng.randint(0, 1 << P, 200),
                                   [0, 1, (1 << P) - 2, (1 << P) - 1]]))
    for i in range(len(means)):
        m = quant.quantize(Gaussian(means[i], scales[i]))
        sym, cum, prob = ef._invert_with_tables(
            qs, np.repeat(aux[i : i + 1], len(qs)),
            np.repeat(core[i : i + 1], len(qs), axis=0), MIN, MAX, P,
        )
        for j, q in enumerate(qs):
            assert (sym[j], cum[j], prob[j]) == m.qf(int(q)), (i, q)
    # a flat distribution makes the whole support non-linear: cmax guard
    with pytest.raises(ValueError, match="cmax"):
        ef.exact_boundary_tables(
            np.zeros(4), np.full(4, 500.0), "gaussian", MIN, MAX, P, 64
        )


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy", "binomial"])
def test_native_boundary_tables_match_numpy_twin(family):
    """The C++ bisection boundary generator must agree exactly with the
    windowed numpy twin over random parameters."""
    import constriction_tpu.native as native

    if native.LIB is None:
        pytest.skip("native lib unavailable")
    rng = np.random.RandomState(13)
    n = 4000
    if family == "binomial":
        ns_, ps_ = _binomial_params(rng, n)
        aux_n, core_n = ef.exact_boundary_tables(
            ns_, ps_, family, 0, N_TRIALS, P, 64
        )
        lib = native.LIB
        try:
            native.LIB = None
            aux_p, core_p = ef.exact_boundary_tables(
                ns_, ps_, family, 0, N_TRIALS, P, 64
            )
        finally:
            native.LIB = lib
        np.testing.assert_array_equal(aux_n, aux_p)
        np.testing.assert_array_equal(core_n, core_p)
        return
    means, scales = _params(rng, n)
    aux_n, core_n = ef.exact_boundary_tables(
        means, scales, family, MIN, MAX, P, CMAX[family]
    )
    lib = native.LIB
    try:
        native.LIB = None
        aux_p, core_p = ef.exact_boundary_tables(
            means, scales, family, MIN, MAX, P, CMAX[family]
        )
    finally:
        native.LIB = lib
    np.testing.assert_array_equal(aux_n, aux_p)
    np.testing.assert_array_equal(core_n, core_p)
    # and the cmax guard still raises through the native path
    with pytest.raises(ValueError, match="cmax"):
        ef.exact_boundary_tables(
            np.zeros(4), np.full(4, 500.0), family, MIN, MAX, P, 16
        )


def test_p16_top_quantile_regression():
    """P = 16 regression: with a full-support core (flat distribution),
    q = 0xFFFF must not count the 0xFFFF pads as boundaries, and the
    no-next-boundary sentinel must be 2^16 (not 0xFFFF) so the top interval
    keeps its full width.  Exhaustive over the whole top region."""
    P16, mn, mx = 16, -50, 50
    means = np.array([0.0])
    scales = np.array([500.0])
    aux, core = ef.exact_boundary_tables(
        means, scales, "gaussian", mn, mx, P16, 128
    )
    syms = np.arange(mn, mx + 1)
    cums, probs = ef.exact_ecp(
        syms, np.full(len(syms), 0.0), np.full(len(syms), 500.0),
        "gaussian", mn, mx, P16,
    )
    c64 = cums.astype(np.int64)
    p64 = probs.astype(np.int64)
    qs = np.concatenate([
        np.arange(int(c64[-1]) - 3, 1 << 16), [0, 1, 32768]
    ])
    s, c, p = ef._invert_with_tables(
        qs, np.repeat(aux, len(qs)), np.repeat(core, len(qs), axis=0),
        mn, mx, P16,
    )
    idx = np.searchsorted(c64, qs, side="right") - 1
    np.testing.assert_array_equal(s, syms[idx])
    np.testing.assert_array_equal(c.astype(np.int64), c64[idx])
    np.testing.assert_array_equal(p.astype(np.int64), p64[idx])


# ---------------------------------------------------------------------------
# DEFAULT-preset (P = 24, W = 32, S = 64) wide-table exact families
# ---------------------------------------------------------------------------

CFG64 = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=24)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_wide_tables_golden_vs_host_quantizer_p24(family):
    """P = 24 exact tables == the host f64 LeakyQuantizer (the precision
    the reference's Python API pins), over random (mean, scale)."""
    rng = np.random.RandomState(21)
    n = min(SOAK_N, 500)  # scalar host quantizer comparison loop
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.05), np.log(6.0), n))
    syms = np.clip(
        np.round(means + rng.randn(n) * scales), MIN, MAX
    ).astype(np.int64)
    cums, probs = ef.exact_ecp(syms, means, scales, family, MIN, MAX, 24)
    quant = LeakyQuantizer(MIN, MAX, precision=24)
    for i in range(n):
        cc, pp = quant.quantize(DIST[family](means[i], scales[i])).ecp(
            int(syms[i])
        )
        assert cc == cums[i] and pp == probs[i], (family, i)


# ---------------------------------------------------------------------------
# Binomial (the reference's 4th quantized family,
# pybindings/stream/model.rs:927-966) + auto-sized cmax
# ---------------------------------------------------------------------------

N_TRIALS = 60


def _binomial_params(rng, n):
    """(n_trials, p) in the generic (means, scales) parameter slots."""
    return np.full(n, float(N_TRIALS)), rng.uniform(0.02, 0.98, n)


def test_binomial_golden_tables_vs_host_quantizer():
    """Binomial exact tables == the host f64 LeakyQuantizer over random p
    (AS 63 inc_beta CDF on both sides; chains to the golden-verified host
    quantizer)."""
    from constriction_tpu.models.quantized import Binomial

    rng = np.random.RandomState(17)
    n = SOAK_N  # full CTPU_EXACT_SOAK_N, same as the continuous families
    ns, ps = _binomial_params(rng, n)
    aux, core = ef.exact_boundary_tables(ns, ps, "binomial", 0, N_TRIALS, P)
    quant = LeakyQuantizer(0, N_TRIALS, P)
    check = rng.choice(n, size=min(n, 200), replace=False)
    qs = np.unique(
        np.concatenate([rng.randint(0, 1 << P, 40), [0, (1 << P) - 1]])
    )
    for i in check:
        m = quant.quantize(Binomial(N_TRIALS, ps[i]))
        sym, cum, prob = ef._invert_with_tables(
            qs, np.repeat(aux[i : i + 1], len(qs)),
            np.repeat(core[i : i + 1], len(qs), axis=0), 0, N_TRIALS, P,
        )
        for j, q in enumerate(qs):
            assert (sym[j], cum[j], prob[j]) == m.qf(int(q)), (i, q, ps[i])
    # ecp twin
    syms = np.clip(rng.binomial(N_TRIALS, ps), 0, N_TRIALS).astype(np.int64)
    cums, probs = ef.exact_ecp(syms, ns, ps, "binomial", 0, N_TRIALS, P)
    for i in check:
        m = quant.quantize(Binomial(N_TRIALS, ps[i]))
        assert (int(cums[i]), int(probs[i])) == m.ecp(int(syms[i])), i


@pytest.mark.parametrize(
    "family,support",
    [("gaussian", (MIN, MAX)), ("laplace", (MIN, MAX)),
     ("cauchy", (MIN, MAX)), ("binomial", (0, N_TRIALS))],
)
def test_exact_ncore_native_matches_numpy_twin(family, support):
    """The C++ ncore probe (per-symbol core sizes, used to auto-size cmax)
    must agree exactly with the vectorized numpy bisection twin."""
    import constriction_tpu.native as native

    mn, mx = support
    rng = np.random.RandomState(37)
    n = 1000
    if family == "binomial":
        means, scales = _binomial_params(rng, n)
    else:
        means, scales = _params(rng, n)
    nc = ef.exact_ncore(means, scales, family, mn, mx, P)
    if native.LIB is not None:
        lib = native.LIB
        try:
            native.LIB = None
            nc_np = ef.exact_ncore(means, scales, family, mn, mx, P)
        finally:
            native.LIB = lib
        np.testing.assert_array_equal(nc, nc_np)
    # the probe bounds the table builder's actual core occupancy exactly:
    # auto-sized tables must equal explicitly-sized ones at cmax=max(ncore)
    cmax = int(nc.max())
    cmax += cmax & 1  # narrow tables pack boundary pairs
    aux_a, core_a = ef.exact_boundary_tables(
        means, scales, family, mn, mx, P, None
    )
    aux_e, core_e = ef.exact_boundary_tables(
        means, scales, family, mn, mx, P, cmax
    )
    assert core_a.shape[1] == cmax
    np.testing.assert_array_equal(aux_a, aux_e)
    np.testing.assert_array_equal(core_a, core_e)


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
def test_native_wide_boundary_tables_match_numpy_twin_p24(family):
    """The C++ generator emits the same WIDE (P = 24) pad + aux packing as
    the numpy twin."""
    import constriction_tpu.native as native

    if native.LIB is None:
        pytest.skip("native lib unavailable")
    rng = np.random.RandomState(29)
    n = 1500
    means = rng.uniform(-110, 110, n)
    scales = np.exp(rng.uniform(np.log(0.05), np.log(6.0), n))
    aux_n, core_n = ef.exact_boundary_tables(
        means, scales, family, MIN, MAX, 24, 202
    )
    lib = native.LIB
    try:
        native.LIB = None
        aux_p, core_p = ef.exact_boundary_tables(
            means, scales, family, MIN, MAX, 24, 202
        )
    finally:
        native.LIB = lib
    np.testing.assert_array_equal(aux_n, aux_p)
    np.testing.assert_array_equal(core_n, core_p)

# ---------------------------------------------------------------------------
# Core-size-grouped coding (ops/exact_family.py group_plan + the segment
# kernels): symbols are stable-sorted by per-symbol core size so the decode
# runs tight-cmax segments; the wire format is the ungrouped format of the
# permuted message.
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Surrogate fast path (native/surrogate.cpp): the vectorized approximation
# of free * CDF only has to stay within the trunc-ambiguity margin of the
# exact glibc value -- codec.cpp re-derives every margin-close decision
# exactly -- so these tests pin (a) the error bound with a wide safety
# factor and (b) bit-identical outputs of the fast and pure paths.
# ---------------------------------------------------------------------------


def test_surrogate_error_bound():
    from constriction_tpu import native

    if native.LIB is None:
        pytest.skip("native library unavailable")
    import math

    rng = np.random.RandomState(7)
    P = 24
    min_s, max_s = -100, 100
    free = float((1 << P) - 1 - (max_s - min_s))
    margin = 2.0 ** -9

    def exact_cdf(kind, x, a, b):
        if kind == 0:
            return (1.0 + math.erf((x - a) / (b * math.sqrt(2.0)))) / 2.0
        if kind == 1:
            if x < a:
                return 0.5 * math.exp((x - a) / b)
            return 1.0 - 0.5 * math.exp((a - x) / b)
        return 0.5 + math.atan((x - a) / b) / math.pi

    worst = 0.0
    for kind in (0, 1, 2):
        for trial in range(60):
            a = float(rng.randn() * 10.0 ** rng.randint(-2, 4))
            b = float(np.exp(rng.uniform(-6, 6)))
            s0 = int(rng.randint(min_s + 1, max_s))
            m = min(64, max_s - s0 + 1)
            A = np.empty(m, np.float64)
            native.LIB.ctpu_surrogate_window(kind, a, b, free, s0, m, A)
            for j in range(m):
                y = free * exact_cdf(kind, (s0 + j) - 0.5, a, b)
                worst = max(worst, abs(A[j] - y))
    # >32x safety under the ambiguity margin
    assert worst < margin / 32.0, worst


def test_fast_path_bit_identical_to_pure():
    """ctpu_exact_ncore + ctpu_quantized_ecp under CTPU_EXACT_FAST=1 vs =0,
    elementwise, in subprocesses (the flag is latched per process)."""
    import subprocess
    import sys

    code = r"""
import os, sys
import numpy as np
from constriction_tpu import native
if native.LIB is None:
    print("SKIP"); raise SystemExit(0)
lib = native.LIB
rng = np.random.RandomState(int(os.environ["CTPU_AB_SEED"]))
n = 1 << 12
means = np.ascontiguousarray(rng.randn(n) * 50.0)
scales = np.ascontiguousarray(np.exp(rng.normal(0.5, 1.5, size=n)))
syms = np.clip(np.round(means + scales * rng.randn(n)), -100, 100
               ).astype(np.int32)
syms = np.ascontiguousarray(syms)
chks = []
for kind in (0, 1, 2):
    nc = np.empty(n, np.uint32)
    lib.ctpu_exact_ncore(kind, -100, 100, 24, means, scales, n, nc)
    cums = np.empty(n, np.uint32)
    probs = np.empty(n, np.uint32)
    err = lib.ctpu_quantized_ecp(
        kind, -100, 100, 24, syms, means, scales, n, cums, probs)
    assert err == 0
    chks.append((nc.tolist(), int(cums.sum(dtype=np.uint64)),
                 int(probs.sum(dtype=np.uint64))))
print(chks)
"""
    outs = {}
    for flag in ("1", "0"):
        env = dict(os.environ)
        env["CTPU_EXACT_FAST"] = flag
        env["CTPU_AB_SEED"] = "1234"
        r = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert r.returncode == 0, r.stderr[-2000:]
        outs[flag] = r.stdout.strip()
    if "SKIP" in outs["1"]:
        pytest.skip("native library unavailable")
    assert outs["1"] == outs["0"], (outs["1"], outs["0"])


@pytest.mark.parametrize("family", ["gaussian", "laplace", "cauchy"])
@pytest.mark.parametrize("prec,W,S", [(12, 16, 32), (24, 32, 64)])
def test_exact_host_roundtrip(family, prec, W, S):
    """exact_ecp planes coded by the ILANS2 host encoder decode back through
    the boundary tables (decode_family_exact_host), at both presets."""
    rng = np.random.RandomState(prec + len(family))
    n, L = 2500, 64
    means, scales = _params(rng, n)
    syms = np.clip(np.round(means + rng.randn(n) * scales), MIN, MAX).astype(
        np.int64)
    cums, probs = ef.exact_ecp(syms, means, scales, family, MIN, MAX, prec)
    cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=prec)
    st, stream = il2.encode_shared(cums, probs, cfg)
    out = ef.decode_family_exact_host(st, stream, means, scales, family, MIN,
                                      MAX, cfg, n)
    np.testing.assert_array_equal(out, syms)
