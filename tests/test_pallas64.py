"""ILANS2-64: the default-preset (W=32, S=64, P<=24) device coder
(ops/device_coder.py, on the CPU through the plain-XLA route) vs the
width-generic numpy oracle (ops/interleaved2), plus the container round
trip.  Reference preset: stack.rs:139 (DefaultAnsCoder = AnsCoder<u32,u64>)
with the Python API's P=24 fixed-point models."""

import numpy as np
import pytest

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import device_coder as dc
from constriction_tpu.ops.interleaved import LaneConfig


def _model(K, P, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    m = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    )
    return m.cdf, probs


@pytest.mark.parametrize("K,P,n", [
    (16, 24, 2000),
    (100, 24, 5000),
    (100, 20, 3000),
    (2, 24, 1500),
    (1000, 24, 4000),
    (100, 24, 256 * 7),   # exact multiple of L (no tail)
    (100, 24, 1),         # single symbol
])
def test_decode64_matches_oracle(K, P, n):
    cdf, probs = _model(K, P, seed=K + P)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(n)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(cdf64[syms], cdf64[syms + 1] - cdf64[syms], cfg)
    assert st.dtype == np.uint64
    out = dc.decode(st, stream, n, cdf, cfg)
    assert np.array_equal(np.asarray(out), syms)


@pytest.mark.parametrize("K,P,n", [
    (16, 24, 2000),
    (100, 24, 5000),
    (100, 20, 3000),
    (100, 24, 256 * 7),
    (100, 24, 3),
])
def test_encode64_bit_exact_with_host(K, P, n):
    cdf, probs = _model(K, P, seed=3 * K + P)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(n + 1)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    ref_st, ref_w = il2.encode_shared(
        cdf64[syms], cdf64[syms + 1] - cdf64[syms], cfg
    )
    st, w = dc.encode(syms, cdf, cfg)
    assert np.array_equal(st, ref_st)
    assert np.array_equal(np.asarray(w), ref_w)


def test_container64_roundtrip_device_path():
    K, P, n = 100, 24, 6000
    cdf, probs = _model(K, P, seed=99)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(0)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    data = il2.encode_iid_categorical2(syms, cdf, cfg, device=True)
    # host and device decodes agree on the same container
    out_dev = il2.decode_iid_categorical2(data, cdf, device=True)
    out_host = il2.decode_iid_categorical2(data, cdf, device=False)
    assert np.array_equal(out_dev, syms)
    assert np.array_equal(out_host, syms)
    # and the device container equals the host container bit for bit
    data_host = il2.encode_iid_categorical2(syms, cdf, cfg, device=False)
    assert np.array_equal(data, data_host)


def test_container64_state_planes():
    """S = 64 containers store lane states as lo/hi u32 planes."""
    K, P, n = 16, 24, 1000
    cdf, probs = _model(K, P, seed=5)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(2)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(cdf64[syms], cdf64[syms + 1] - cdf64[syms], cfg)
    data = il2.pack_container2(st, stream, n, cfg)
    st2, stream2, n2, cfg2 = il2.unpack_container2(data)
    assert n2 == n and cfg2 == cfg
    assert st2.dtype == np.uint64
    assert np.array_equal(st2, st)
    assert np.array_equal(stream2, stream)


def test_checkpoints64_suffix_decode():
    """Interleaved random-access checkpoints carry u64 states at S = 64;
    suffix decode from a snapshot equals the full decode's suffix."""
    K, P, n = 60, 24, 256 * 12
    cdf, probs = _model(K, P, seed=17)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(4)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(cdf64[syms], cdf64[syms + 1] - cdf64[syms], cfg)
    interval = 4
    offsets, ckpts = il2.build_checkpoints(st, stream, n, cdf, cfg, interval)
    assert ckpts.dtype == np.uint64
    c = len(offsets) - 1
    start = (c + 1) * interval * cfg.num_lanes
    suffix = il2.decode_shared_cdf(
        ckpts[c], stream[offsets[c]:], n - start, cdf, cfg
    )
    assert np.array_equal(np.asarray(suffix), syms[start:])


def test_native_host_paths_match_numpy_s64():
    """The C++ ILANS2-64 host paths (encode with (lo, hi) state pairs;
    decode via CDF binary search) equal the numpy twins bit for bit."""
    from constriction_tpu import native

    if native.LIB is None:
        pytest.skip("needs the native codec")
    K, P, n = 100, 24, 50000
    cdf, probs = _model(K, P, seed=23)
    cfg = LaneConfig(num_lanes=512, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(6)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    cums = cdf64[syms]
    ps = cdf64[syms + 1] - cums

    st_n, w_n = il2.encode_shared(cums, ps, cfg)
    lib = native.LIB
    try:
        native.LIB = None
        st_p, w_p = il2.encode_shared(cums, ps, cfg)
    finally:
        native.LIB = lib
    assert st_n.dtype == np.uint64 and st_p.dtype == np.uint64
    np.testing.assert_array_equal(st_n, st_p)
    np.testing.assert_array_equal(w_n, w_p)

    out_n = il2.decode_shared_cdf(st_n, w_n, n, cdf, cfg)
    try:
        native.LIB = None
        out_p = il2.decode_shared_cdf(st_n, w_n, n, cdf, cfg)
    finally:
        native.LIB = lib
    np.testing.assert_array_equal(out_n, out_p)
    np.testing.assert_array_equal(out_n, syms)


def test_decode_from_checkpoint64_device_path():
    """decode_from_checkpoint resumes S=64 configs on the device coder with
    u64 checkpoint states."""
    K, P, n = 60, 24, 256 * 12
    cdf, probs = _model(K, P, seed=17)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=P)
    rng = np.random.RandomState(4)
    syms = rng.choice(K, size=n, p=probs).astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(cdf64[syms], cdf64[syms + 1] - cdf64[syms], cfg)
    interval = 4
    offsets, ckpts = il2.build_checkpoints(st, stream, n, cdf, cfg, interval)
    c = len(offsets) - 1
    start, suffix = il2.decode_from_checkpoint(
        c, offsets, ckpts, stream, n, cdf, cfg, interval, device=True
    )
    assert start == (c + 1) * interval * cfg.num_lanes
    assert np.array_equal(np.asarray(suffix), syms[start:])
