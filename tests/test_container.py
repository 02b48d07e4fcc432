"""Sharded container: one-call mesh encode/decode, mesh-shape independence.

`parallel.encode(symbols, model, mesh)` / `parallel.decode`
must round-trip on any mesh shape including ragged tails, and the container
bytes must not depend on the mesh.  Runs on the 8-device CPU mesh
(conftest sets xla_force_host_platform_device_count).
"""

import numpy as np
import pytest

from constriction_tpu import parallel
from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops.interleaved import LaneConfig


def _workload(n, alphabet=37, seed=5):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(alphabet))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    return symbols, model.cdf


CFG = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)


@pytest.mark.parametrize("n", [1, 777, 4096, 10007])
def test_container_roundtrip_host(n):
    symbols, cdf = _workload(n)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=8, device=False)
    out = parallel.decode(cont, cdf, device=False)
    np.testing.assert_array_equal(out, symbols)


def test_container_mesh_independent():
    """Same bytes from host and device encode; decodes on any D | B."""
    import jax

    symbols, cdf = _workload(6000)
    cont_host = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=8, device=False)
    mesh8 = parallel.make_mesh(min(8, len(jax.devices())))
    cont_dev = parallel.encode(
        symbols, cdf, cfg=CFG, num_blocks=8, mesh=mesh8, device=True
    )
    np.testing.assert_array_equal(cont_host, cont_dev)

    for d in (1, 2, 8):
        if d > len(jax.devices()):
            continue
        mesh = parallel.make_mesh(d)
        out = parallel.decode(cont_host, cdf, mesh=mesh, device=True)
        np.testing.assert_array_equal(out, symbols)
    out = parallel.decode(cont_dev, cdf, device=False)
    np.testing.assert_array_equal(out, symbols)


def test_container_ragged_tail():
    """A message whose tail block is mostly padding still round-trips and
    records the true length."""
    symbols, cdf = _workload(8 * 513 - 311)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=8, device=False)
    states, streams, n, block_len, cfg, _coder = parallel.unpack_sharded(cont)
    assert n == len(symbols) and len(streams) == 8
    out = parallel.decode(cont, cdf, device=True)
    np.testing.assert_array_equal(out, symbols)


def test_container_large_alphabet_bitmap():
    """Container + bitmap-rank inversion compose (K > 255)."""
    rng = np.random.RandomState(11)
    K = 600
    extra = rng.multinomial((1 << 12) - K, rng.dirichlet(np.full(K, 2.0)))
    cdf = np.concatenate([[0], np.cumsum(1 + extra)]).astype(np.uint32)
    p = (cdf[1:] - cdf[:-1]) / 4096.0
    symbols = rng.choice(K, size=5000, p=p).astype(np.int64)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=4, device=True)
    out = parallel.decode(cont, cdf, device=True)
    np.testing.assert_array_equal(out, symbols)


def test_container_blocks_not_matching_devices():
    """num_blocks that no available device count divides evenly still works:
    the codec picks the largest divisor of B within the device budget."""
    symbols, cdf = _workload(3000, seed=9)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=6, device=True)
    out = parallel.decode(cont, cdf, device=True)
    np.testing.assert_array_equal(out, symbols)
    cont3 = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=3, device=True)
    np.testing.assert_array_equal(parallel.decode(cont3, cdf, device=False),
                                  symbols)


def test_sharded_container_default_preset_s64():
    """A default-preset (W=32/S=64/P=24) sharded container round-trips on
    the mesh device path and the host loop, mesh-shape independently, with
    u64 lane states stored as lo/hi planes."""
    import jax

    from constriction_tpu import parallel
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops.interleaved import LaneConfig

    rng = np.random.RandomState(11)
    K = 80
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    ).cdf
    n = 5000
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)
    D = len(jax.devices())
    mesh = parallel.make_mesh(D)

    cont_dev = parallel.encode(
        symbols, cdf, cfg=cfg, num_blocks=D, mesh=mesh, device=True
    )
    cont_host = parallel.encode(
        symbols, cdf, cfg=cfg, num_blocks=D, device=False
    )
    assert np.array_equal(cont_dev, cont_host)
    out_dev = parallel.decode(cont_dev, cdf, mesh=mesh)
    out_host = parallel.decode(cont_dev, cdf, device=False)
    assert np.array_equal(out_dev, symbols)
    assert np.array_equal(out_host, symbols)

    # states round-trip as u64
    states, streams, n2, bl, cfg2, _coder = parallel.unpack_sharded(cont_dev)
    assert states.dtype == np.uint64 and cfg2 == cfg and n2 == n


def _needs_native():
    from constriction_tpu import native

    if native.LIB is None:
        pytest.skip("needs the native codec")


def test_container_range_roundtrip():
    """coder="range": each block is an ILANS2-R unit (stored states are the
    decoder point headers, queue.rs:847-868).  Range containers are coded
    on the host: a mesh does not move them to the device, and an explicit
    device request is rejected."""
    import jax

    _needs_native()
    symbols, cdf = _workload(6000, seed=21)
    cont_host = parallel.encode(
        symbols, cdf, cfg=CFG, num_blocks=8, device=False, coder="range"
    )
    mesh8 = parallel.make_mesh(min(8, len(jax.devices())))
    cont_mesh = parallel.encode(
        symbols, cdf, cfg=CFG, num_blocks=8, mesh=mesh8, coder="range",
    )
    np.testing.assert_array_equal(cont_host, cont_mesh)
    # header records queue semantics
    *_, coder = parallel.unpack_sharded(cont_mesh)
    assert coder == parallel.CODER_RANGE
    with pytest.raises(ValueError, match="range containers"):
        parallel.encode(symbols, cdf, cfg=CFG, num_blocks=8, device=True,
                        coder="range")
    with pytest.raises(ValueError, match="range containers"):
        parallel.decode(cont_host, cdf, device=True)

    for d in (1, 2, 8):
        if d > len(jax.devices()):
            continue
        mesh = parallel.make_mesh(d)
        out = parallel.decode(cont_host, cdf, mesh=mesh)
        np.testing.assert_array_equal(out, symbols)
    out = parallel.decode(cont_mesh, cdf, device=False)
    np.testing.assert_array_equal(out, symbols)


def test_container_range_ragged_tail_device_encode():
    """Range container with a mostly-padding tail block (host coders; the
    device coder covers rANS)."""
    _needs_native()
    symbols, cdf = _workload(8 * 513 - 311, seed=23)
    cont = parallel.encode(
        symbols, cdf, cfg=CFG, num_blocks=8, device=False, coder="range"
    )
    out = parallel.decode(cont, cdf)
    np.testing.assert_array_equal(out, symbols)


def test_container_range_default_preset_s64():
    """coder="range" at the DEFAULT preset (W=32/S=64/P=24): u64 point
    headers as lo/hi planes; a mesh leaves range coding on the host."""
    import jax

    _needs_native()
    rng = np.random.RandomState(31)
    K = 80
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    ).cdf
    n = 5000
    symbols = rng.choice(K, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)
    D = len(jax.devices())
    mesh = parallel.make_mesh(D)

    cont_dev = parallel.encode(
        symbols, cdf, cfg=cfg, num_blocks=D, mesh=mesh, coder="range",
    )
    cont_host = parallel.encode(
        symbols, cdf, cfg=cfg, num_blocks=D, device=False, coder="range"
    )
    assert np.array_equal(cont_dev, cont_host)
    out_dev = parallel.decode(cont_dev, cdf, mesh=mesh)
    out_host = parallel.decode(cont_dev, cdf, device=False)
    assert np.array_equal(out_dev, symbols)
    assert np.array_equal(out_host, symbols)
    states, *_ = parallel.unpack_sharded(cont_dev)
    assert states.dtype == np.uint64


def test_container_range_invalid_data():
    """Corrupt point headers trip the queue decoder's InvalidData check
    (queue.rs:991-993) through the container's host decoder."""
    _needs_native()
    symbols, cdf = _workload(2000, seed=25)
    cont = parallel.encode(
        symbols, cdf, cfg=CFG, num_blocks=4, device=False, coder="range"
    )
    states, streams, n, bl, cfg, coder = parallel.unpack_sharded(cont)
    bad = parallel.pack_sharded(
        np.full_like(states, 0xFFFFFFFF), streams, n, bl, cfg, coder
    )
    with pytest.raises(ValueError, match="inconsistent with the entropy"):
        parallel.decode(bad, cdf)


def test_encode_rejects_unknown_coder():
    symbols, cdf = _workload(100, seed=31)
    with pytest.raises(ValueError, match="coder must be one of"):
        parallel.encode(symbols, cdf, cfg=CFG, num_blocks=2, coder="queue")


def test_container_format_is_pinned():
    """Golden container bytes: the on-disk format (header layout + payload)
    must stay stable across releases — decoding old containers is a product
    guarantee.  If this fails, you changed the wire format: bump the header
    version and add a compatibility path instead of editing the constants."""
    import hashlib

    rng = np.random.RandomState(42)
    probs = rng.dirichlet(np.ones(17))
    syms = rng.choice(17, size=1000, p=probs).astype(np.int64)
    m = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    want = {
        "rans": (2100240, "f013edd12ed31e0a"),
        "range": (18877456, "1dfd768b7498063c"),
    }
    for coder, (packed_cfg, sha16) in want.items():
        cont = parallel.encode(
            syms, m.cdf, cfg=cfg, num_blocks=4, device=False, coder=coder
        )
        arr = np.asarray(cont, np.uint32)
        assert list(arr[:8]) == [
            0x494C4E53, 1, packed_cfg, 1000, 0, 128, 4, 250
        ], coder
        assert len(arr) == 524, coder
        got = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        assert got == sha16, f"{coder}: container bytes changed ({got})"
        out = parallel.decode(cont, m.cdf, device=False)
        assert np.array_equal(out, syms), coder


def test_encode_validates_inputs():
    symbols, cdf = _workload(500, seed=33)
    with pytest.raises(ValueError, match="num_blocks"):
        parallel.encode(symbols, cdf, cfg=CFG, num_blocks=0)
    with pytest.raises(ValueError, match="cdf"):
        # precision-12 config with a truncated cdf (cdf[-1] != 2**12)
        parallel.encode(symbols, cdf[:-1], cfg=CFG, num_blocks=2)
    bad = symbols.copy()
    bad[3] = len(cdf) - 1  # one past the top symbol
    with pytest.raises(ValueError, match="symbols must be in"):
        parallel.encode(bad, cdf, cfg=CFG, num_blocks=2)
    bad[3] = -1
    with pytest.raises(ValueError, match="symbols must be in"):
        parallel.encode(bad, cdf, cfg=CFG, num_blocks=2)


def test_decode_validates_cdf_and_container():
    symbols, cdf = _workload(500, seed=34)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=2, device=False)
    with pytest.raises(ValueError, match="cdf"):
        parallel.decode(cont, cdf[:-1], device=False)
    with pytest.raises(ValueError, match="truncated or oversized"):
        parallel.decode(cont[:-3], cdf, device=False)
    bad = cont.copy()
    bad[2] |= np.uint32(2 << 24)  # unknown coder id
    with pytest.raises(ValueError, match="unknown coder id"):
        parallel.decode(bad, cdf, device=False)


def test_padding_avoids_zero_probability_symbol():
    """A model whose symbol 0 has zero probability must still produce a
    correct container when the message needs padding (the pad symbol is the
    first symbol with nonzero mass)."""
    cdf = np.array([0, 0, 1000, 3000, 1 << 12], dtype=np.uint32)
    symbols = np.array([1, 2, 3, 2, 1, 3, 2], dtype=np.int64)  # 7 % 2 != 0
    for device in (False, True):
        cont = parallel.encode(
            symbols, cdf, cfg=CFG, num_blocks=2, device=device
        )
        out = parallel.decode(cont, cdf, device=device)
        assert np.array_equal(out, symbols), f"device={device}"


def test_block_checkpoints_random_access():
    """Within-block checkpoint seek: decoding a block suffix from a
    checkpoint is bit-equal to the corresponding slice of the full decode
    (reference analog: Pos/Seek jump tables, lib.rs:425-580)."""
    n = 20011
    symbols, cdf = _workload(n)
    cont = parallel.encode(symbols, cdf, cfg=CFG, num_blocks=4, device=False)
    full = parallel.decode(cont, cdf, device=False)
    np.testing.assert_array_equal(full, symbols)
    _, _, _, block_len, cfg, _ = parallel.unpack_sharded(cont)
    interval = 3
    offs, sts = parallel.build_block_checkpoints(cont, cdf, interval)
    assert offs.shape[0] == 4
    L = cfg.num_lanes
    for block in (0, 2, 3):
        for ck in (0, offs.shape[1] - 1):
            start, suffix = parallel.decode_block_from_checkpoint(
                cont, cdf, interval, block, ck, offs, sts
            )
            rel = (ck + 1) * interval * L
            assert start == block * block_len + rel
            end = min((block + 1) * block_len, n)
            np.testing.assert_array_equal(suffix, symbols[start:end])


def test_block_checkpoints_s64_and_range():
    """Checkpoints work at the DEFAULT preset (u64 block states), for both
    the rANS and the RANGE sharded containers (range snapshots carry the
    full (lows, rngs, pts) decoder state; queue.rs:911-928 analog)."""
    n = 6000
    rng = np.random.RandomState(11)
    probs = rng.dirichlet(np.ones(37))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    )
    symbols = rng.choice(37, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=32, state_bits=64, precision=24)
    cont = parallel.encode(
        symbols, model.cdf, cfg=cfg, num_blocks=2, device=False
    )
    interval = 2
    offs, sts = parallel.build_block_checkpoints(cont, model.cdf, interval)
    assert sts.dtype == np.uint64
    start, suffix = parallel.decode_block_from_checkpoint(
        cont, model.cdf, interval, 1, 0, offs, sts
    )
    end = min(2 * (n // 2 + n % 2) + len(suffix), n)
    np.testing.assert_array_equal(suffix, symbols[start : start + len(suffix)])
    assert start + len(suffix) == n  # final block clips to message length

    cont_r = parallel.encode(
        symbols, model.cdf, cfg=cfg, num_blocks=2, device=False,
        coder="range",
    )
    offs_r, sts_r = parallel.build_block_checkpoints(
        cont_r, model.cdf, interval
    )
    assert isinstance(sts_r, tuple) and len(sts_r) == 3
    block_len_r = n // 2 + n % 2
    for block in (0, 1):
        for ck in (0, offs_r.shape[1] - 1):
            start, suffix = parallel.decode_block_from_checkpoint(
                cont_r, model.cdf, interval, block, ck, offs_r, sts_r,
            )
            end = min((block + 1) * block_len_r, n)
            np.testing.assert_array_equal(suffix, symbols[start:end])
    with pytest.raises(ValueError, match="host"):
        parallel.decode_block_from_checkpoint(
            cont_r, model.cdf, interval, 0, 0, offs_r, sts_r, device=True)


def test_parallel_encode_infers_precision_from_cdf():
    """Regression (round-4 review): parallel.encode with cfg=None must
    infer the precision from the model's CDF like the tpu facade does."""
    import numpy as np

    from constriction_tpu import parallel
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )

    rng = np.random.RandomState(8)
    p = rng.dirichlet(np.ones(50) * 2)
    mdl = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(p, 24)
    s = rng.choice(50, size=1 << 14, p=p)
    blocks = parallel.encode(s, mdl.cdf, num_blocks=4)
    out = parallel.decode(blocks, mdl.cdf)
    np.testing.assert_array_equal(np.asarray(out), s)


def test_sharded_compact_v2_roundtrip_and_rate():
    """Sharded v2 (compact=True): variable-width block states + pooled-tail
    seed recovery.  Host and device (XLA route) bytes identical, round
    trips on both, total size well under v1's raw state header."""
    rng = np.random.RandomState(21)
    probs = rng.dirichlet(np.full(60, 1.2))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    )
    cdf = model.cdf
    p = np.diff(cdf.astype(np.float64)) / (1 << 24)
    n = 200_000
    syms = rng.choice(60, size=n, p=p).astype(np.int64)
    cfg = LaneConfig(num_lanes=256, word_bits=32, state_bits=64, precision=24)
    c_h = parallel.encode(syms, cdf, cfg=cfg, num_blocks=4, device=False,
                          compact=True)
    c_d = parallel.encode(syms, cdf, cfg=cfg, num_blocks=4, device=True,
                          compact=True)
    np.testing.assert_array_equal(c_h, np.asarray(c_d))
    for device in (False, True):
        np.testing.assert_array_equal(
            parallel.decode(c_h, cdf, device=device), syms
        )
    # the pooled-tail split engaged and the container beats v1
    from constriction_tpu.parallel.container import unpack_sharded_v2

    assert unpack_sharded_v2(np.asarray(c_h))[5] > 0
    c1 = parallel.encode(syms, cdf, cfg=cfg, num_blocks=4, device=False)
    assert len(c_h) < len(c1)
    # range + compact is rejected explicitly
    with pytest.raises(ValueError, match="compact"):
        parallel.encode(syms, cdf, cfg=cfg, num_blocks=4, device=False,
                        compact=True, coder="range")


def test_sharded_compact_v2_small_message_no_tail():
    """Short messages skip the pooled-tail split (k_tail == 0) and still
    round trip through the variable-width packing."""
    rng = np.random.RandomState(22)
    probs = rng.dirichlet(np.full(30, 1.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    syms = rng.choice(30, size=900, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    cont = parallel.encode(syms, model.cdf, cfg=cfg, num_blocks=2,
                           device=False, compact=True)
    from constriction_tpu.parallel.container import unpack_sharded_v2

    assert unpack_sharded_v2(np.asarray(cont))[5] == 0
    np.testing.assert_array_equal(
        parallel.decode(cont, model.cdf, device=False), syms
    )


def test_sharded_compact_v2_checkpoints():
    """Within-block checkpoint seeks work on v2 containers (region-A
    scope; the pooled tail needs a full decode by construction)."""
    rng = np.random.RandomState(23)
    probs = rng.dirichlet(np.full(40, 1.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    p = np.diff(model.cdf.astype(np.float64)) / (1 << 12)
    n = 60_000
    syms = rng.choice(40, size=n, p=p).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    cont = parallel.encode(syms, model.cdf, cfg=cfg, num_blocks=2,
                           device=False, compact=True)
    from constriction_tpu.parallel.container import unpack_sharded_v2

    _, _, n_tot, block_len, _, k_tail, _, _ = unpack_sharded_v2(
        np.asarray(cont)
    )
    assert k_tail > 0
    n_A = n_tot - k_tail
    interval = 4
    offs, sts = parallel.build_block_checkpoints(cont, model.cdf, interval)
    start, suffix = parallel.decode_block_from_checkpoint(
        cont, model.cdf, interval, 1, 0, offs, sts
    )
    end = min(2 * block_len, n_A)
    np.testing.assert_array_equal(suffix, syms[start:end])
