"""The CUDA kernels of the device coder (constriction_tpu/cuda) on the card.

Each test runs the kernel route and compares it, byte for byte, with the
host oracle (ops/interleaved2.py) and with the plain-XLA route at real
widths.  The CUDA kernels have no interpret mode, so every test here takes
the ``gpu`` fixture and skips without a GPU; ``python chip_smoke.py`` runs
them on the card.
"""

import numpy as np
import pytest

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import device_coder as dc
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import route
from constriction_tpu.ops.interleaved import LaneConfig

pytestmark = pytest.mark.gpu

PRESETS = [(12, 16, 32), (24, 32, 64)]


def _data(P, n, seed, K=100, alpha=2.0):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, alpha))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    ).cdf
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    c = cdf.astype(np.uint64)
    return rng, cdf, symbols, c[symbols], c[symbols + 1] - c[symbols]


def _both_routes(fn):
    with route.forced("cuda"):
        a = fn()
    with route.forced("xla"):
        b = fn()
    return a, b


@pytest.mark.parametrize("P,W,S", PRESETS)
def test_cuda_matches_host_and_xla_at_full_width(gpu, P, W, S):
    L, n = 32768, (1 << 20) + 12345
    _, cdf, syms, cums, probs = _data(P, n, seed=P)
    cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    ref_st, ref_w = il2.encode_shared(cums, probs, cfg)
    (st_c, w_c), (st_x, w_x) = _both_routes(lambda: dc.encode(syms, cdf, cfg))
    for st, w in ((st_c, w_c), (st_x, w_x)):
        np.testing.assert_array_equal(st.astype(np.uint64),
                                      ref_st.astype(np.uint64))
        np.testing.assert_array_equal(w, ref_w)
    (o_c, f_c), (o_x, f_x) = _both_routes(
        lambda: dc.decode(ref_st, ref_w, n, cdf, cfg, return_final_states=True))
    np.testing.assert_array_equal(o_c, syms)
    np.testing.assert_array_equal(o_x, syms)
    np.testing.assert_array_equal(f_c, f_x)


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("L", [1, 100, 1024, 4096, 8192, 65536, 131072])
def test_cuda_lane_geometries(gpu, P, W, S, L):
    """Lanes per thread (1..16) and cluster sizes (1..8), ragged tails,
    seeded starts, three blocks in one launch."""
    B, block_len = 3, 3 * L + 5
    rng, cdf, syms, cums, probs = _data(P, B * block_len, seed=L % 97)
    cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    F = S - W
    seeds = (np.uint64(1) << np.uint64(F)) | rng.randint(
        0, 1 << min(F, 31), size=(B, L)).astype(np.uint64)
    with route.forced("cuda"):
        st, streams = dc.encode_blocks(syms.reshape(B, block_len), cdf, cfg,
                                       seeds=seeds)
        out, fin = dc.decode_blocks(st, streams, block_len, cdf, cfg)
    for b in range(B):
        sl = slice(b * block_len, (b + 1) * block_len)
        ref_st, ref_w = il2.encode_shared(cums[sl], probs[sl], cfg,
                                          seeds=seeds[b])
        np.testing.assert_array_equal(st[b].astype(np.uint64),
                                      ref_st.astype(np.uint64))
        np.testing.assert_array_equal(streams[b], ref_w)
    np.testing.assert_array_equal(out.reshape(-1), syms)
    np.testing.assert_array_equal(fin.astype(np.uint64), seeds)


@pytest.mark.parametrize("P,K", [(12, 4000), (16, 20000), (24, 50000)])
def test_cuda_large_alphabets(gpu, P, K):
    """Bucket-table inversion: exact lookup at P <= 12, a binary search over
    a CDF too large for shared memory above."""
    W, S = (16, 32) if P <= 16 else (32, 64)
    n, L = 200_000, 4096
    _, cdf, syms, cums, probs = _data(P, n, seed=K, K=K, alpha=0.5)
    cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    ref_st, ref_w = il2.encode_shared(cums, probs, cfg)
    with route.forced("cuda"):
        st, w = dc.encode(syms, cdf, cfg)
        out = dc.decode(ref_st, ref_w, n, cdf, cfg)
    np.testing.assert_array_equal(w, ref_w)
    np.testing.assert_array_equal(st.astype(np.uint64), ref_st.astype(np.uint64))
    np.testing.assert_array_equal(out, syms)


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("compact", [True, False])
def test_cuda_facade_container_equals_host(gpu, P, W, S, compact):
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.ops import framing

    n = 1 << 20
    _, cdf, syms, _, _ = _data(P, n, seed=5 + P)
    cfg = LaneConfig(num_lanes=32768, word_bits=W, state_bits=S, precision=P)
    assert route.coder_route() == "cuda"
    data = ctpu.encode_iid(syms, cdf, cfg, compact=compact)
    host = (framing.encode_iid_v2(syms, cdf, cfg, device=False) if compact
            else il2.encode_iid_categorical2(syms, cdf, cfg, device=False))
    np.testing.assert_array_equal(data, host)
    np.testing.assert_array_equal(ctpu.decode_iid(data, cdf), syms)
