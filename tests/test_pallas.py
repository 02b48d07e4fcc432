"""The ILANS2 device coder (ops/device_coder.py) vs the numpy oracle.

On the CPU the route selector (ops/route.py) picks the plain-XLA coder
(ops/jax_coder2.py); on a GPU the same entry points run the CUDA kernels,
which tests/test_gpu_kernels.py compares with this path on the card.  The
file keeps its historical name.
"""

import numpy as np
import pytest

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import device_coder as dc
from constriction_tpu.ops import route
from constriction_tpu.ops.interleaved import LaneConfig


def _roundtrip(L, n, alphabet, seed, precision=12):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(alphabet, 2.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=precision)
    cdf64 = cdf.astype(np.uint64)
    init_states, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    ref = il2.decode_shared_cdf(init_states, stream, n, cdf, cfg)
    assert np.array_equal(ref, symbols)
    out = np.asarray(dc.decode(init_states, stream, n, cdf, cfg))
    np.testing.assert_array_equal(out, symbols)


@pytest.mark.parametrize(
    "L,n,alphabet,seed",
    [
        (128, 1024, 16, 0),
        (256, 2000, 100, 1),  # ragged tail
        (256, 2048, 2, 2),  # binary alphabet
        (512, 700, 7, 3),  # n > L but not 2L
        (128, 128, 33, 4),  # single step
        (128, 100, 5, 5),  # n < L
    ],
)
def test_pallas_decode_matches_oracle(L, n, alphabet, seed):
    _roundtrip(L, n, alphabet, seed)


def test_pallas_decode_skewed_model():
    # very skewed model: long refill bursts stress the rank computation
    rng = np.random.RandomState(9)
    alphabet = 64
    w = np.exp(rng.randn(alphabet) * 4)
    probs = w / w.sum()
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    n, L = 5000, 256
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf64 = cdf.astype(np.uint64)
    init_states, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    out = np.asarray(dc.decode(init_states, stream, n, cdf, cfg))
    np.testing.assert_array_equal(out, symbols)


# ---------------------------------------------------------------------------
# ILANS2-R (shared-stream interleaved RANGE coding)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Pallas encoder (bit-exact with the host ILANS2 encoder)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "L,n,alphabet,seed",
    [
        (128, 1024, 16, 0),
        (256, 2000, 100, 1),
        (128, 100, 5, 2),
        (384, 5000, 60, 3),  # R=3: unaligned row count exercises RPAD
    ],
)
def test_pallas_encode_bit_exact(L, n, alphabet, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(alphabet, 2.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf64 = cdf.astype(np.uint64)
    ref_states, ref_stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    got_states, got_stream = dc.encode(symbols, cdf, cfg)
    np.testing.assert_array_equal(np.asarray(got_states), ref_states)
    np.testing.assert_array_equal(np.asarray(got_stream), ref_stream)


def test_pallas_encode_decode_roundtrip():
    # device encode -> device decode
    rng = np.random.RandomState(11)
    alphabet, n, L = 40, 3000, 256
    probs = rng.dirichlet(np.full(alphabet, 1.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    states, stream = dc.encode(symbols, cdf, cfg)
    out = np.asarray(
        dc.decode(np.asarray(states), np.asarray(stream), n, cdf, cfg)
    )
    np.testing.assert_array_equal(out, symbols)


def test_pallas_prefix_decode():
    # decoding only the first n' symbols of a longer container is valid
    # (lane states evolve identically through the first ceil(n'/L) steps)
    rng = np.random.RandomState(3)
    alphabet, n, L = 30, 4000, 128
    probs = rng.dirichlet(np.full(alphabet, 2.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf64 = cdf.astype(np.uint64)
    states, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    for n_prefix in (L, 3 * L, 5 * L):
        out = np.asarray(
            dc.decode(states, stream, n_prefix, cdf, cfg)
        )
        np.testing.assert_array_equal(out, symbols[:n_prefix])


@pytest.mark.parametrize("seed", range(6))
def test_pallas_fuzz_roundtrips(seed):
    """Randomized end-to-end property: device encode -> device decode is the
    identity for random lane counts, alphabet sizes, skews and lengths."""
    rng = np.random.RandomState(1000 + seed)
    L = 128 * int(rng.choice([1, 2, 3, 4]))
    alphabet = int(rng.randint(2, 200))
    n = int(rng.randint(1, 6 * L))
    skew = float(np.exp(rng.randn() * 1.5))
    w = rng.dirichlet(np.full(alphabet, skew))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        w, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=w).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    states, stream = dc.encode(symbols, cdf, cfg)
    out = np.asarray(
        dc.decode(np.asarray(states), np.asarray(stream), n, cdf, cfg)
    )
    np.testing.assert_array_equal(out, symbols)


def test_pallas_decode_large_alphabet():
    """A 1000-symbol alphabet codes bit-exactly (the decoder's lookup table
    covers every quantile)."""
    rng = np.random.RandomState(12)
    alphabet, n, L = 1000, 3000, 128
    probs = rng.dirichlet(np.full(alphabet, 0.5))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    states, stream = dc.encode(symbols, cdf, cfg)
    cdf64 = cdf.astype(np.uint64)
    ref_states, ref_stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    np.testing.assert_array_equal(np.asarray(states), ref_states)
    np.testing.assert_array_equal(np.asarray(stream), ref_stream)
    out = np.asarray(
        dc.decode(ref_states, ref_stream, n, cdf, cfg)
    )
    np.testing.assert_array_equal(out, symbols)


@pytest.mark.parametrize("precision", [8, 10, 14, 16])
def test_pallas_precision_range(precision):
    """The device coder covers the full precision range at W=16/S=32
    (P=16 uses S = W + P exactly)."""
    rng = np.random.RandomState(precision)
    alphabet = min(50, (1 << precision) - 2)
    n, L = 3000, 128
    probs = rng.dirichlet(np.full(alphabet, 1.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=precision)
    cdf64 = cdf.astype(np.uint64)
    ref_st, ref_w = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    st, w = dc.encode(symbols, cdf, cfg)
    np.testing.assert_array_equal(np.asarray(st), ref_st)
    np.testing.assert_array_equal(np.asarray(w), ref_w)
    out = np.asarray(dc.decode(ref_st, ref_w, n, cdf, cfg))
    np.testing.assert_array_equal(out, symbols)


def _leaky_cdf(rng, K, precision):
    """Random strictly-increasing fixed-point CDF (every prob >= 1) that,
    unlike the _fast constructor, also covers dense alphabets K ~ 2^P."""
    extra = rng.multinomial((1 << precision) - K, rng.dirichlet(np.full(K, 0.3)))
    return np.concatenate([[0], np.cumsum(1 + extra)]).astype(np.int64)


@pytest.mark.parametrize("K", [1000, 4096])
def test_pallas_decode_bitmap_roundtrip(K):
    """End-to-end device decode at dense alphabets (K up to 2^P) stays
    identical to the host oracle."""
    rng = np.random.RandomState(K)
    n, L, P = 5000, 256, 12
    cdf = _leaky_cdf(rng, K, P)
    probs = (cdf[1:] - cdf[:-1]) / float(1 << P)
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)
    cdf64 = cdf.astype(np.uint64)
    states, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    ref = il2.decode_shared_cdf(states, stream, n, cdf, cfg)
    np.testing.assert_array_equal(ref, symbols)
    out = np.asarray(dc.decode(states, stream, n, cdf, cfg))
    np.testing.assert_array_equal(out, symbols)


@pytest.mark.parametrize("K", [1000, 4096])
def test_pallas_encode_bitmap_roundtrip(K):
    """End-to-end device encode at dense alphabets (K up to 2^P) stays
    bitstream-identical to the host encoder."""
    rng = np.random.RandomState(K + 1)
    n, L, P = 5000, 256, 12
    cdf = _leaky_cdf(rng, K, P)
    probs = (cdf[1:] - cdf[:-1]) / float(1 << P)
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=P)
    cdf64 = cdf.astype(np.uint64)
    states, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    st_d, stream_d = dc.encode(symbols, cdf, cfg)
    np.testing.assert_array_equal(np.asarray(st_d), states)
    np.testing.assert_array_equal(np.asarray(stream_d), stream)


# ---------------------------------------------------------------------------
# Route selection, both widths: seeds, final states, tails, batches
# ---------------------------------------------------------------------------

PRESETS = [(12, 16, 32), (24, 32, 64)]


def _setup(P, W, S, L, n, seed, K=40):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    ).cdf
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    cdf64 = cdf.astype(np.uint64)
    return rng, cdf, symbols, cfg, cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols]


def test_route_selector_cpu():
    assert route.platform() == "cpu"
    assert route.coder_route() == "xla"
    assert not route.on_accelerator()
    with route.forced("xla"):
        assert route.coder_route() == "xla"
    with pytest.raises(RuntimeError, match="GPU"):
        with route.forced("cuda"):
            pass
    with pytest.raises(ValueError, match="route"):
        with route.forced("bogus"):
            pass
    assert route.coder_route() == "xla"


@pytest.mark.parametrize("W,S,P,ok", [
    (16, 32, 12, True), (16, 32, 16, True), (32, 64, 24, True),
    (32, 64, 32, True), (8, 32, 12, False), (16, 64, 24, False),
])
def test_device_coder_supports(W, S, P, ok):
    assert dc.supports(LaneConfig(128, W, S, P)) is ok


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("L", [1, 37, 128, 1000])
def test_device_seeds_and_final_states(P, W, S, L):
    n = 5 * L + 3
    rng, cdf, symbols, cfg, cums, probs = _setup(P, W, S, L, n, seed=L + P)
    F = S - W
    seeds = (np.uint64(1) << np.uint64(F)) | rng.randint(
        0, 1 << min(F, 31), size=L).astype(np.uint64)
    ref_st, ref_w = il2.encode_shared(cums, probs, cfg, seeds=seeds)
    st, w = dc.encode(symbols, cdf, cfg, seeds=seeds)
    np.testing.assert_array_equal(st.astype(np.uint64), ref_st.astype(np.uint64))
    np.testing.assert_array_equal(w, ref_w)
    out, fin = dc.decode(ref_st, ref_w, n, cdf, cfg, return_final_states=True)
    np.testing.assert_array_equal(out, symbols)
    np.testing.assert_array_equal(fin.astype(np.uint64), seeds)


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("dn", [-1, 0, 1, 7])
def test_device_tail_step(P, W, S, dn):
    """Lanes past the message end are inactive in the last step only."""
    L = 64
    n = 3 * L + dn
    _, cdf, symbols, cfg, cums, probs = _setup(P, W, S, L, n, seed=dn + 10)
    ref_st, ref_w = il2.encode_shared(cums, probs, cfg)
    st, w = dc.encode(symbols, cdf, cfg)
    np.testing.assert_array_equal(st.astype(np.uint64), ref_st.astype(np.uint64))
    np.testing.assert_array_equal(w, ref_w)
    np.testing.assert_array_equal(dc.decode(ref_st, ref_w, n, cdf, cfg), symbols)


@pytest.mark.parametrize("P,W,S", PRESETS)
def test_device_blocks_match_host_per_block(P, W, S):
    L, B, block_len = 32, 3, 200
    _, cdf, symbols, cfg, cums, probs = _setup(P, W, S, L, B * block_len, seed=P)
    st, streams = dc.encode_blocks(symbols.reshape(B, block_len), cdf, cfg)
    for b in range(B):
        sl = slice(b * block_len, (b + 1) * block_len)
        ref_st, ref_w = il2.encode_shared(cums[sl], probs[sl], cfg)
        np.testing.assert_array_equal(st[b].astype(np.uint64),
                                      ref_st.astype(np.uint64))
        np.testing.assert_array_equal(streams[b], ref_w)
    out, fin = dc.decode_blocks(st, streams, block_len, cdf, cfg)
    np.testing.assert_array_equal(out.reshape(-1), symbols)
    assert np.all(fin.astype(np.uint64) == np.uint64(1 << (S - W)))


@pytest.mark.parametrize("P,W,S", PRESETS)
def test_device_truncated_stream_matches_oracle(P, W, S):
    """Words past the end of a truncated stream read as zero, as in the
    host oracle's numpy twin (n < 256 keeps the oracle off the native
    decoder)."""
    L, n = 16, 200
    _, cdf, symbols, cfg, cums, probs = _setup(P, W, S, L, n, seed=3)
    st, w = il2.encode_shared(cums, probs, cfg)
    cut = w[: len(w) // 2]
    ref = il2.decode_shared_cdf(st, cut, n, cdf, cfg)
    np.testing.assert_array_equal(dc.decode(st, cut, n, cdf, cfg), ref)


@pytest.mark.parametrize("P,W,S", PRESETS)
def test_device_empty_message(P, W, S):
    _, cdf, _, cfg, _, _ = _setup(P, W, S, 8, 0, seed=0)
    st, w = dc.encode(np.zeros(0, np.int64), cdf, cfg)
    assert len(w) == 0 and np.all(st.astype(np.uint64) == np.uint64(1 << (S - W)))
    out, fin = dc.decode(st, w, 0, cdf, cfg, return_final_states=True)
    assert len(out) == 0
    np.testing.assert_array_equal(fin, st)
