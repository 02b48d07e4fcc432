"""Tests for ILANS v2 (shared-stream interleaved rANS, gather-free decode)."""

import numpy as np
import pytest

from constriction_tpu.models.categorical import ContiguousCategoricalEntropyModel
from constriction_tpu.ops import interleaved2 as il2
from constriction_tpu.ops.interleaved import LaneConfig


def _make(seed=1234, alphabet=100, precision=12):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(alphabet))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision
    )
    return rng, probs, model


@pytest.mark.parametrize("num_lanes", [1, 2, 64, 256])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 10007])
def test_host_roundtrip2(num_lanes, n):
    rng, probs, model = _make()
    symbols = rng.choice(100, size=n, p=probs)
    cfg = LaneConfig(num_lanes=num_lanes, word_bits=16, state_bits=32, precision=12)
    data = il2.encode_iid_categorical2(symbols, model.cdf, cfg)
    out = il2.decode_iid_categorical2(data, model.cdf)
    assert np.array_equal(out, symbols)


def test_overhead_is_small():
    rng, probs, model = _make()
    n = 200000
    symbols = rng.choice(100, size=n, p=probs)
    cfg = LaneConfig(num_lanes=1024, word_bits=16, state_bits=32, precision=12)
    data = il2.encode_iid_categorical2(symbols, model.cdf, cfg)
    cdf = model.cdf.astype(np.float64)
    info_bits = -np.sum(np.log2(np.diff(cdf)[symbols] / (1 << 12)))
    total_bits = len(data) * 32
    # overhead = header + L*4B states; payload itself is near-optimal
    assert total_bits < info_bits * 1.02 + 1024 * 32 + 7 * 32 + 64


def test_jax_decode_matches_host():
    from constriction_tpu.ops import jax_coder2 as jc2

    rng, probs, model = _make()
    symbols = rng.choice(100, size=10007, p=probs)
    cfg = LaneConfig(num_lanes=64, word_bits=16, state_bits=32, precision=12)
    data = il2.encode_iid_categorical2(symbols, model.cdf, cfg)
    init_states, stream, n, _ = il2.unpack_container2(data)
    T = -(-n // 64)
    out, fin = jc2.decode_blocks(
        init_states[None], stream[None].astype(np.uint32),
        np.array([len(stream)], np.int32), model.cdf.astype(np.uint32),
        jc2.lookup_table(model.cdf, 12), np.array([n], np.int32),
        cfg=cfg, T=T,
    )
    assert np.array_equal(np.asarray(out)[0, :n], symbols)
    assert np.all(np.asarray(fin) == 1 << 16)


def test_jax_encode_matches_host():
    import jax
    import jax.numpy as jnp

    from constriction_tpu.ops import jax_coder2 as jc2

    rng, probs, model = _make(seed=5)
    cdf64 = model.cdf.astype(np.uint64)
    N = 4099
    symbols = rng.choice(100, size=N, p=probs)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    T = -(-N // 128)

    syms = np.zeros((1, T * 128), np.int32)
    syms[0, :N] = symbols
    seeds = np.full((1, 128), 1 << 16, np.uint32)
    max_stream = T * 128

    stream_j, st_j, len_j = jax.jit(
        lambda s, sd: jc2.encode_blocks(
            s, sd, jnp.asarray(model.cdf, jnp.uint32),
            jnp.array([N], jnp.int32), cfg=cfg, T=T)
    )(jnp.asarray(syms), jnp.asarray(seeds))
    st_j, stream_j, len_j = st_j[0], stream_j[0], len_j[0]
    st_h, stream_h = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    len_j = int(len_j)
    assert np.array_equal(np.asarray(st_j), st_h)
    assert len_j == len(stream_h)
    assert np.array_equal(np.asarray(stream_j)[max_stream - len_j :], stream_h)


def test_per_symbol_rows_roundtrip():
    """Rank-2 categorical (a different PMF per symbol), XLA decode."""
    import jax
    import jax.numpy as jnp

    from constriction_tpu.ops import jax_coder2 as jc2

    rng = np.random.RandomState(3)
    K = 8
    N = 2050
    cfg = LaneConfig(num_lanes=64, word_bits=16, state_bits=32, precision=12)
    T = -(-N // 64)

    # per-symbol CDF rows (exact fixed point)
    pmfs = rng.dirichlet(np.ones(K), size=N)
    weights = np.maximum((pmfs * ((1 << 12) - K)).astype(np.int64), 0) + 1
    weights[:, -1] += (1 << 12) - weights.sum(axis=1)
    rows = np.zeros((N, K + 1), dtype=np.uint32)
    rows[:, 1:] = np.cumsum(weights, axis=1)
    symbols = np.array([rng.choice(K, p=p) for p in pmfs])

    cums = rows[np.arange(N), symbols].astype(np.uint64)
    probs = (rows[np.arange(N), symbols + 1] - rows[np.arange(N), symbols]).astype(np.uint64)

    states, stream = il2.encode_shared(cums, probs, cfg)

    rows_padded = np.zeros((T * 64, K + 1), dtype=np.uint32)
    rows_padded[:N] = rows
    rows_padded[N:, 1:] = 1 << 12  # prob 2^12 on symbol 0 for inactive slots
    out = np.asarray(
        jax.jit(
            lambda s, w, r: jc2.decode_shared_rows(s, w, r, cfg, T, N)
        )(
            jnp.asarray(states, dtype=jnp.uint32),
            jnp.asarray(stream, dtype=jnp.uint32),
            jnp.asarray(rows_padded.reshape(T, 64, K + 1)),
        )
    )[:N]
    assert np.array_equal(out, symbols)


def test_decode_shared_batched():
    """B independent blocks decoded in one scan (ops/jax_coder2)."""
    import jax.numpy as jnp

    from constriction_tpu.ops import jax_coder2 as jc2

    rng = np.random.RandomState(5)
    B, L, block_len, alphabet = 3, 128, 700, 20
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    probs = rng.dirichlet(np.full(alphabet, 1.5))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf.astype(np.uint64)
    T = -(-block_len // L)
    blocks = [
        rng.choice(alphabet, size=block_len, p=probs).astype(np.int64)
        for _ in range(B)
    ]
    states = np.zeros((B, L), np.uint32)
    cap = T * L
    streams = np.zeros((B, cap), np.uint32)
    for b, blk in enumerate(blocks):
        st, w = il2.encode_shared(cdf[blk], cdf[blk + 1] - cdf[blk], cfg)
        states[b] = st
        streams[b, : len(w)] = w
    out, _ = jc2.decode_blocks(
        jnp.asarray(states), jnp.asarray(streams),
        jnp.full((B,), cap, jnp.int32), jnp.asarray(model.cdf, jnp.uint32),
        jnp.asarray(jc2.lookup_table(model.cdf, 12)),
        jnp.array([block_len], jnp.int32), cfg=cfg, T=T,
    )
    out = np.asarray(out)
    for b, blk in enumerate(blocks):
        np.testing.assert_array_equal(out[b, :block_len], blk)


def test_checkpoint_seek_decode():
    """Periodic decoder checkpoints let the suffix be decoded from the
    middle, bit-exactly equal to the full decode's tail (host + device)."""
    rng = np.random.RandomState(21)
    alphabet, n, L = 40, 20000, 128
    probs = rng.dirichlet(np.ones(alphabet))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    interval = 16
    offs, cst = il2.build_checkpoints(st, stream, n, cdf, cfg, interval)
    assert len(offs) >= 2
    for c in range(len(offs)):
        for device in (False, True):
            start, suffix = il2.decode_from_checkpoint(
                c, offs, cst, stream, n, cdf, cfg, interval, device=device
            )
            np.testing.assert_array_equal(suffix, symbols[start:])


def test_checkpoint_numpy_twin_matches_native():
    rng = np.random.RandomState(22)
    alphabet, n, L = 30, 9000, 64
    probs = rng.dirichlet(np.ones(alphabet))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(
        cdf64[symbols], cdf64[symbols + 1] - cdf64[symbols], cfg
    )
    offs_n, cst_n = il2.build_checkpoints(st, stream, n, cdf, cfg, 8)
    import constriction_tpu.native as native
    if native.LIB is None:
        return
    # force the numpy twin by bypassing the gate (P > 20 is impossible here,
    # so temporarily disable the native lib)
    lib = native.LIB
    try:
        native.LIB = None
        offs_p, cst_p = il2.build_checkpoints(st, stream, n, cdf, cfg, 8)
    finally:
        native.LIB = lib
    np.testing.assert_array_equal(offs_n, offs_p)
    np.testing.assert_array_equal(cst_n, cst_p)


def test_mismatched_args_raise_not_crash():
    """Misuse of the ops-level entry points (e.g. passing (symbols, cdf)
    instead of per-symbol (cums, probs)) must raise ValueError up front
    instead of handing bogus lengths to the native codec (which would read
    out of bounds)."""
    rng = np.random.RandomState(0)
    probs = rng.dirichlet(np.full(100, 1.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, precision=12
    )
    cdf = model.cdf
    cfg = LaneConfig(num_lanes=512, word_bits=16, state_bits=32, precision=12)
    syms = rng.randint(0, 100, 512 * 4).astype(np.int32)
    with pytest.raises(ValueError, match="equal length"):
        il2.encode_shared(syms, cdf, cfg)
    cdf64 = cdf.astype(np.uint64)
    st, stream = il2.encode_shared(
        cdf64[syms].astype(np.uint32),
        (cdf64[syms + 1] - cdf64[syms]).astype(np.uint32),
        cfg,
    )
    with pytest.raises(ValueError, match="num_lanes"):
        il2.decode_shared_cdf(stream, st, len(syms), cdf, cfg)
    with pytest.raises(ValueError, match="cdf"):
        il2.decode_shared_cdf(st, stream, len(syms), cdf[:-1], cfg)
    with pytest.raises(ValueError, match="num_lanes"):
        il2.decode_shared_range_cdf(stream, st, len(syms), cdf, cfg)


def test_range_decode_rejects_wrong_precision_cdf():
    """decode_shared_range_cdf validates cdf[-1] == 2**precision up front on
    BOTH the native and numpy paths (a short cdf would otherwise send the
    native two-level search past the end of the table)."""
    from constriction_tpu import native

    if native.LIB is None:
        pytest.skip("needs the native codec")
    rng = np.random.RandomState(5)
    _, probs, model = _make(seed=5)
    cfg = LaneConfig(num_lanes=512, word_bits=16, state_bits=32, precision=12)
    syms = rng.choice(100, size=2048, p=probs).astype(np.int64)
    cdf64 = model.cdf.astype(np.uint64)
    pts, stream = il2.encode_shared_range(
        (cdf64[syms]).astype(np.uint32),
        (cdf64[syms + 1] - cdf64[syms]).astype(np.uint32),
        cfg,
    )
    with pytest.raises(ValueError, match="cdf"):
        il2.decode_shared_range_cdf(pts, stream, len(syms), model.cdf[:-1], cfg)
    # small message (numpy fallback) hits the same validation
    with pytest.raises(ValueError, match="cdf"):
        il2.decode_shared_range_cdf(pts, stream, 100, model.cdf[:-1], cfg)


def test_range_decode_numpy_fallback_flags_invalid_data():
    """Corrupt range data raises the same 'inconsistent with the entropy
    model' ValueError on the numpy fallback as on the native path (not an
    IndexError from cdf[K + 1])."""
    _, probs, model = _make(seed=6)
    cfg = LaneConfig(num_lanes=64, word_bits=16, state_bits=32, precision=12)
    # all-ones points make the very first quantile >= 2**P in every lane
    pts = np.full(64, 0xFFFFFFFF, dtype=np.uint64)
    stream = np.zeros(0, dtype=np.uint32)
    with pytest.raises(ValueError, match="inconsistent with the entropy"):
        il2.decode_shared_range_cdf(pts, stream, 100, model.cdf, cfg)


def test_ilans2_container_format_is_pinned():
    """Golden container bytes for the single-chip ILANS2 format (magic
    'ILN2', version 1): the wire format is a product guarantee.  If this
    fails, bump the header version and add a compatibility path instead of
    editing the constants."""
    import hashlib

    rng = np.random.RandomState(42)
    probs = rng.dirichlet(np.ones(17))
    syms = rng.choice(17, size=1000, p=probs)
    m = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    data = il2.encode_iid_categorical2(syms, m.cdf, cfg)
    arr = np.asarray(data, np.uint32)
    assert list(arr[:7]) == [0x494C4E32, 1, 2100240, 1000, 0, 128, 135]
    assert len(arr) == 203
    got = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
    assert got == "4e2267c5a0e2ee9e", f"container bytes changed ({got})"
    assert np.array_equal(il2.decode_iid_categorical2(data, m.cdf), syms)


def test_range_decode_ignores_garbage_in_inactive_lanes():
    """A corrupt point in a padding (inactive) lane must not crash the
    numpy fallback (searchsorted past the table end); active symbols still
    decode correctly."""
    from constriction_tpu import native

    if native.LIB is None:
        pytest.skip("needs the native codec")
    rng = np.random.RandomState(8)
    _, probs, model = _make(seed=8)
    cfg = LaneConfig(num_lanes=64, word_bits=16, state_bits=32, precision=12)
    n = 32  # only half the lanes carry a symbol
    syms = rng.choice(100, size=n, p=probs).astype(np.int64)
    cdf64 = model.cdf.astype(np.uint64)
    pts, stream = il2.encode_shared_range(
        cdf64[syms].astype(np.uint32),
        (cdf64[syms + 1] - cdf64[syms]).astype(np.uint32),
        cfg,
    )
    pts = np.asarray(pts, np.uint64).copy()
    pts[40] = 0xFFFFFFFF  # garbage in an inactive lane
    out = il2.decode_shared_range_cdf(pts, stream, n, model.cdf, cfg)
    assert np.array_equal(out, syms)
