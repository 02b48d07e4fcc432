"""ILANS2 encode and decode on the device, behind one interface.

Every device caller -- the facade (``tpu.encode_iid`` / ``decode_iid``),
the v1 and v2 containers, checkpoint resume and the sharded container --
goes through :func:`encode_blocks` / :func:`decode_blocks` (or their
one-block forms :func:`encode` / :func:`decode`).  They take and return
numpy arrays; the implementation is chosen by ops/route.py:

- ``"cuda"``: the Hopper kernels (``constriction_tpu.cuda``);
- ``"xla"``: the plain ``lax.scan`` coder (ops/jax_coder2.py).

Both produce exactly the host oracle's bytes (ops/interleaved2.py).  With a
``mesh``, the blocks are spread over its devices by ``shard_map``: every
device codes its share of the blocks, and the encoder's results return in
block order through an ``all_gather``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np

from . import jax_coder2 as jc2
from . import route as _route
from .interleaved import LaneConfig, _state_dtype

BLOCK_AXIS = "blocks"

# stream buffers are padded to a multiple of this many words (or to T*L,
# the most a block can hold), so that messages of similar size share one
# compiled program
_STREAM_BUCKET = 1 << 16


def supports(cfg: LaneConfig) -> bool:
    """The device coder covers the two presets the facade picks:
    W=16/S=32 and W=32/S=64, with P <= S - W."""
    return ((cfg.word_bits, cfg.state_bits) in ((16, 32), (32, 64))
            and 0 < cfg.precision <= cfg.state_bits - cfg.word_bits
            and cfg.num_lanes >= 1)


def _x64(cfg: LaneConfig):
    import jax

    return (jax.enable_x64(True) if cfg.state_bits > 32
            else contextlib.nullcontext())


def _impl(route: str, op: str):
    if route == "cuda":
        from .. import cuda

        return getattr(cuda, op)
    return getattr(jc2, op)


@functools.lru_cache(maxsize=64)
def _decode_fn(route: str, cfg: LaneConfig, T: int, mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    fn = functools.partial(_impl(route, "decode_blocks"), cfg=cfg, T=T)
    if mesh is not None:
        fn = jax.shard_map(
            fn, mesh=mesh,
            in_specs=(P(BLOCK_AXIS),) * 3 + (P(),) * 3,
            out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
            check_vma=False,
        )
    return jax.jit(fn)


@functools.lru_cache(maxsize=64)
def _encode_fn(route: str, cfg: LaneConfig, T: int, mesh):
    import jax
    from jax.sharding import PartitionSpec as P

    impl = functools.partial(_impl(route, "encode_blocks"), cfg=cfg, T=T)
    fn = impl
    if mesh is not None:
        def gathered(*args):
            return tuple(jax.lax.all_gather(x, BLOCK_AXIS, tiled=True)
                         for x in impl(*args))

        fn = jax.shard_map(
            gathered, mesh=mesh,
            in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P()),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
    return jax.jit(fn)


def _decode_table(route: str, cdf, precision: int) -> np.ndarray:
    if route == "cuda":
        from .. import cuda

        return cuda.bucket_table(cdf, precision)
    return jc2.lookup_table(cdf, precision)


def decode_blocks(states, streams, block_len: int, cdf, cfg: LaneConfig,
                  mesh=None):
    """Decode B equal-length blocks: ``states`` [B, L], ``streams`` a list
    of B word arrays.  Returns ``(symbols int32[B, block_len],
    final_states [B, L])``; after a full decode the final states equal the
    encoder's seeds."""
    states = np.asarray(states, dtype=_state_dtype(cfg))
    B, L = len(streams), cfg.num_lanes
    if states.shape != (B, L):
        raise ValueError(f"states must be [{B}, {L}], got {states.shape}")
    T = -(-block_len // L) if block_len else 0
    if T == 0:
        return np.zeros((B, 0), np.int32), states.copy()
    longest = max(len(s) for s in streams)
    cap = max(1, min(T * L, -(-longest // _STREAM_BUCKET) * _STREAM_BUCKET))
    words = np.zeros((B, cap), np.uint32)
    lens = np.zeros(B, np.int32)
    for b, s in enumerate(streams):
        k = min(len(s), cap)
        words[b, :k] = np.asarray(s[:k], np.uint32)
        lens[b] = k
    route = _route.coder_route()
    with _x64(cfg):
        syms, fin = _decode_fn(route, cfg, T, mesh)(
            states, words, lens, np.asarray(cdf, np.uint32),
            _decode_table(route, cdf, cfg.precision),
            np.array([block_len], np.int32),
        )
        return np.asarray(syms)[:, :block_len], np.asarray(fin)


def encode_blocks(symbols, cdf, cfg: LaneConfig, seeds=None, mesh=None):
    """Encode B equal-length blocks (``symbols`` [B, block_len]) from
    per-lane start states ``seeds`` [B, L] (default: the floor
    2^(S-W)).  Returns ``(init_states [B, L], streams)`` with ``streams``
    a list of B word arrays, as the host oracle returns them."""
    symbols = np.asarray(symbols)
    B, block_len = symbols.shape
    L, S, W = cfg.num_lanes, cfg.state_bits, cfg.word_bits
    dt = _state_dtype(cfg)
    if seeds is None:
        seeds = np.full((B, L), 1 << (S - W), dtype=dt)
    seeds = np.asarray(seeds, dtype=dt).reshape(B, L)
    T = -(-block_len // L) if block_len else 0
    if T == 0:
        return seeds.copy(), [np.zeros(0, np.uint32) for _ in range(B)]
    syms = np.zeros((B, T * L), np.int32)
    syms[:, :block_len] = symbols
    with _x64(cfg):
        buf, states, lens = _encode_fn(_route.coder_route(), cfg, T, mesh)(
            syms, seeds, np.asarray(cdf, np.uint32),
            np.array([block_len], np.int32),
        )
        buf, states, lens = np.asarray(buf), np.asarray(states), np.asarray(lens)
    return states, [buf[b, T * L - int(lens[b]):] for b in range(B)]


def decode(init_states, stream, num_symbols: int, cdf, cfg: LaneConfig,
           return_final_states: bool = False):
    """One-block :func:`decode_blocks` (a container's region, or a
    checkpoint's suffix)."""
    syms, fin = decode_blocks(
        np.asarray(init_states).reshape(1, -1), [np.asarray(stream)],
        num_symbols, cdf, cfg,
    )
    if return_final_states:
        return syms[0], fin[0]
    return syms[0]


def encode(symbols, cdf, cfg: LaneConfig, seeds=None):
    """One-block :func:`encode_blocks`: ``(init_states [L], stream)``."""
    symbols = np.asarray(symbols).reshape(1, -1)
    if seeds is not None:
        seeds = np.asarray(seeds).reshape(1, -1)
    states, streams = encode_blocks(symbols, cdf, cfg, seeds)
    return states[0], streams[0]
