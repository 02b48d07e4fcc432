"""Public device facade (constriction_tpu.tpu) round trips; on the CPU the
device coder is the plain-XLA route."""

import numpy as np
import pytest

import constriction_tpu.tpu as ctpu
from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)


def test_facade_iid_roundtrip():
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.ones(30))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    symbols = rng.choice(30, size=5000, p=probs).astype(np.int64)
    data = ctpu.encode_iid(symbols, model.cdf)
    out = ctpu.decode_iid(data, model.cdf)
    np.testing.assert_array_equal(np.asarray(out), symbols)


def test_facade_chain_decode():
    from constriction_tpu.ops.chain import ChainCoderCore

    rng = np.random.RandomState(2)
    probs = rng.dirichlet(np.ones(9))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    )
    data = rng.randint(1, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    data[-1] |= 0x80000000
    core = ChainCoderCore.from_compressed(list(data))
    ref = core.decode_iid_symbols(40, model)
    out = ctpu.decode_chain_iid(data, 40, model.cdf)
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_facade_non_contiguous_alphabet():
    """Device coding for non-contiguous alphabets: host index mapping,
    device codes indices (non_contiguous.rs parity on the device path)."""
    import numpy as np

    import constriction_tpu.tpu as ctpu
    from constriction_tpu.ops.interleaved import LaneConfig

    rng = np.random.RandomState(4)
    alphabet = np.array([-70, -3, 8, 99, 400, 1000])
    K = len(alphabet)
    extra = rng.multinomial((1 << 12) - K, rng.dirichlet(np.full(K, 1.0)))
    cdf = np.concatenate([[0], np.cumsum(1 + extra)]).astype(np.uint32)
    p = (cdf[1:] - cdf[:-1]) / 4096.0
    syms = rng.choice(alphabet, size=9000, p=p)
    cfg = LaneConfig(128, 16, 32, 12)
    cont = ctpu.encode_iid(syms, cdf, cfg, alphabet=alphabet)
    out = ctpu.decode_iid(cont, cdf, alphabet=alphabet)
    np.testing.assert_array_equal(out, syms)
    import pytest

    with pytest.raises(ValueError, match="not in the alphabet"):
        ctpu.encode_iid(np.array([5]), cdf, cfg, alphabet=alphabet)


def test_facade_encode_iid_rejects_out_of_range_symbols():
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(10))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    import pytest

    with pytest.raises(ValueError, match="symbols must be in"):
        ctpu.encode_iid(np.array([-1, 0, 1]), model.cdf)
    with pytest.raises(ValueError, match="symbols must be in"):
        ctpu.encode_iid(np.array([0, 10]), model.cdf)


def test_facade_precision_follows_model():
    """The facade infers the lane config from the model's fixed-point CDF:
    a P=24 model rides the S=64 coder with no explicit cfg."""
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )

    rng = np.random.RandomState(4)
    p = np.array([0.9] + [0.1 / 9] * 9)
    syms = rng.choice(10, size=600, p=p)
    m24 = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(p, 24)
    data = ctpu.encode_iid(syms, m24.cdf)
    from constriction_tpu.ops import framing

    cfg = framing.peek_cfg(np.asarray(data))
    assert (cfg.precision, cfg.state_bits, cfg.word_bits) == (24, 64, 32)
    np.testing.assert_array_equal(ctpu.decode_iid(data, m24.cdf), syms)

    m16 = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(p, 16)
    d16 = ctpu.encode_iid(syms, m16.cdf)
    cfg16 = framing.peek_cfg(np.asarray(d16))
    assert (cfg16.precision, cfg16.state_bits) == (16, 32)
    np.testing.assert_array_equal(ctpu.decode_iid(d16, m16.cdf), syms)

    with pytest.raises(ValueError, match="power of two"):
        # 11-entry cdf (10 symbols, all syms in range) topping at 110
        ctpu.encode_iid(syms, np.arange(0, 121, 11))


PRESETS = [(12, 16, 32), (24, 32, 64)]


def _model_syms(P, n, seed, K=60):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    ).cdf
    return cdf, rng.choice(K, size=n, p=probs).astype(np.int64)


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("compact", [True, False])
def test_facade_container_bytes_equal_host(P, W, S, compact):
    """The facade's device container equals the host-built container byte
    for byte, compact (v2) and v1, at both presets."""
    from constriction_tpu.ops import framing
    from constriction_tpu.ops import interleaved2 as il2
    from constriction_tpu.ops.interleaved import LaneConfig

    cdf, syms = _model_syms(P, 40000, seed=P + compact)
    cfg = LaneConfig(num_lanes=256, word_bits=W, state_bits=S, precision=P)
    data = ctpu.encode_iid(syms, cdf, cfg, compact=compact)
    if compact:
        host = framing.encode_iid_v2(syms, cdf, cfg, device=False)
    else:
        host = il2.encode_iid_categorical2(syms, cdf, cfg, device=False)
    np.testing.assert_array_equal(data, host)
    np.testing.assert_array_equal(ctpu.decode_iid(data, cdf), syms)


@pytest.mark.parametrize("P,W,S", PRESETS)
@pytest.mark.parametrize("compact", [True, False])
def test_facade_checkpoint_resume(P, W, S, compact):
    from constriction_tpu.ops.interleaved import LaneConfig

    cdf, syms = _model_syms(P, 30000, seed=7 + P)
    cfg = LaneConfig(num_lanes=128, word_bits=W, state_bits=S, precision=P)
    data = ctpu.encode_iid(syms, cdf, cfg, compact=compact)
    offsets, states = ctpu.build_checkpoints(data, cdf, 16)
    for c in (0, len(offsets) // 2):
        start, suffix = ctpu.decode_from_checkpoint(data, cdf, 16, c,
                                                    offsets, states)
        assert start == (c + 1) * 16 * 128
        np.testing.assert_array_equal(suffix, syms[start:])
