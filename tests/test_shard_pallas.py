"""Sharded device encode/decode (parallel.sharding.shard_encode2 /
shard_decode2) over the 8-device CPU test mesh; on the CPU the device
coder is the plain-XLA route.  The file keeps its historical name."""

import jax
import numpy as np

from constriction_tpu.models.categorical import ContiguousCategoricalEntropyModel
from constriction_tpu.ops import device_coder as dc
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops.interleaved import LaneConfig
from constriction_tpu.parallel import sharding as sh


def _blocks(seed, D, block_len, alphabet, P):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.full(alphabet, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    ).cdf
    symbols = rng.choice(alphabet, size=D * block_len, p=probs).astype(np.int64)
    return cdf, symbols


def test_sharded_pallas_roundtrip():
    mesh = sh.make_mesh()
    D = len(jax.devices())
    block_len, L = 1000, 128
    cdf, symbols = _blocks(0, D, block_len, 50, 12)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)

    states, streams = sh.shard_encode2(mesh, symbols.reshape(D, block_len), cdf, cfg)
    cdf64 = cdf.astype(np.uint64)
    for d in range(D):
        blk = symbols[d * block_len:(d + 1) * block_len]
        ref_st, ref_stream = il2.encode_shared(
            cdf64[blk], cdf64[blk + 1] - cdf64[blk], cfg)
        assert np.array_equal(states[d], ref_st), d
        assert np.array_equal(streams[d], ref_stream), d

    out, fin = sh.shard_decode2(mesh, states, streams, cdf, cfg, block_len)
    assert np.array_equal(out.reshape(-1), symbols), "decode mismatch"
    assert np.all(fin == 1 << 16)


def test_sharded_container_random_access():
    """Blocks are independent ILANS2 units: any single block decodes alone
    (the random-access / seek analog for the sharded container format)."""
    D, block_len, L = 4, 800, 128
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf, symbols = _blocks(1, D, block_len, 20, 12)
    mesh = sh.make_mesh(min(D, len(jax.devices())))
    states, streams = sh.shard_encode2(mesh, symbols.reshape(D, block_len), cdf, cfg)
    # decode ONLY block 2, without touching the others
    d = 2
    out = dc.decode(states[d], streams[d], block_len, cdf, cfg)
    np.testing.assert_array_equal(out, symbols[d * block_len:(d + 1) * block_len])


def test_sharded_pallas64_default_preset_roundtrip():
    """DEFAULT-preset (W=32/S=64/P=24) blocks coded in parallel under
    shard_map, u64 lane states."""
    mesh = sh.make_mesh()
    D = len(jax.devices())
    block_len, L = 700, 128
    cdf, symbols = _blocks(3, D, block_len, 40, 24)
    cfg = LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=24)
    cdf64 = cdf.astype(np.uint64)
    states, streams = [], []
    for d in range(D):
        blk = symbols[d * block_len:(d + 1) * block_len]
        st, sw = il2.encode_shared(cdf64[blk], cdf64[blk + 1] - cdf64[blk], cfg)
        states.append(st)
        streams.append(sw)
    out, _ = sh.shard_decode2(mesh, np.stack(states), streams, cdf, cfg, block_len)
    assert np.array_equal(out.reshape(-1), symbols)
    st_d, streams_d = sh.shard_encode2(
        mesh, symbols.reshape(D, block_len), cdf, cfg)
    assert st_d.dtype == np.uint64
    assert np.array_equal(st_d, np.stack(states))
    for d in range(D):
        assert np.array_equal(streams_d[d], streams[d]), d
