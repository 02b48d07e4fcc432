"""On-device table builders: validity + self-consistent round trips."""

import numpy as np

from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops import tables_jax as tj
from constriction_tpu.ops.interleaved import LaneConfig


def test_fast_quantized_cdf_jax_valid_and_close_to_host():
    rng = np.random.RandomState(0)
    for k in (2, 5, 64, 250):
        p = rng.dirichlet(np.full(k, 0.7)).astype(np.float32)
        cdf_dev = np.asarray(tj.fast_quantized_cdf_jax(p, 12)).astype(np.int64)
        assert cdf_dev[0] == 0 and cdf_dev[-1] == 1 << 12
        d = np.diff(cdf_dev)
        assert d.min() >= 1  # leaky
        # matches the host f32 builder up to the documented cumsum-order slack
        from constriction_tpu.models.categorical import fast_quantized_cdf

        cdf_host = fast_quantized_cdf(p, 12).astype(np.int64)
        assert np.abs(cdf_dev - cdf_host).max() <= 1


def test_uniform_cdf_jax():
    cdf = np.asarray(tj.uniform_cdf_jax(10, 12)).astype(np.int64)
    assert cdf[0] == 0 and cdf[-1] == 1 << 12
    assert np.all(np.diff(cdf)[:-1] == (1 << 12) // 10)


def test_device_built_table_roundtrip():
    # a table built on-device encodes and decodes self-consistently
    rng = np.random.RandomState(1)
    k, n, L = 40, 3000, 128
    p = rng.dirichlet(np.full(k, 1.0)).astype(np.float32)
    cdf = np.asarray(tj.fast_quantized_cdf_jax(p, 12)).astype(np.uint64)
    symbols = rng.randint(0, k, size=n).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    states, stream = il2.encode_shared(
        cdf[symbols], cdf[symbols + 1] - cdf[symbols], cfg
    )
    out = il2.decode_shared_cdf(states, stream, n, cdf, cfg)
    np.testing.assert_array_equal(out, symbols)


def test_fast_cdf_jax_clamps_overshoot_to_leaky():
    """f32 trunc can overshoot free_weight for a tiny trailing probability;
    the device builder must still emit a valid leaky table (the host twin
    raises -- a raise is impossible under jit)."""
    import jax.numpy as jnp

    from constriction_tpu.ops.tables_jax import fast_quantized_cdf_jax

    p = jnp.asarray(
        [0.888, 0.631, 0.356, 0.528, 0.226, 0.777, 1e-7], jnp.float32
    )
    cdf = np.asarray(fast_quantized_cdf_jax(p, 24))
    assert cdf[0] == 0 and cdf[-1] == 1 << 24
    assert np.all(np.diff(cdf.astype(np.int64)) > 0)


def test_uniform_cdf_jax_validates_size():
    import pytest

    from constriction_tpu.ops.tables_jax import uniform_cdf_jax

    with pytest.raises(ValueError, match="range too large"):
        uniform_cdf_jax(5000, 12)
    with pytest.raises(ValueError, match="range > 1"):
        uniform_cdf_jax(1, 12)
