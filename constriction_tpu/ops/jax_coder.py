"""JAX (XLA) lane-interleaved rANS encode/decode.

Jittable, static-shape implementations of the ILANS format defined in
:mod:`constriction_tpu.ops.interleaved` (same algebra as the reference's
AnsCoder, stack.rs:1014-1100, vectorized across lanes).  All arithmetic is
uint32 (state 32 bits, words 16 or 8 bits, precision <= 16), so the hot loop
maps onto native 32-bit integer ops.

The per-step control flow is branch-free: data-dependent renormalization is
handled with masked selects and per-lane cursors (no cross-lane prefix sums,
because every lane owns its own word stream).

Layout notes:
- `words` is a [L, M] u32 array (one W-bit word per element).
- the i.i.d. decode path performs 2 gathers per step (quantile -> symbol via
  the lookup table, symbol -> packed (cum | prob << 16)); both tables are
  small at the "small" preset (2^12 * 4 B = 16 KiB).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .interleaved import LaneConfig


def _u32(x):
    return jnp.asarray(x, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("cfg", "num_steps"))
def jax_init_decoder_states(
    words: jax.Array, counts: jax.Array, cfg: LaneConfig, num_steps: int = 0
) -> Tuple[jax.Array, jax.Array]:
    """Vectorized `read_initial_state` (stack.rs:440-462): pop words from the
    end of each lane's stream until state >= 2**(S-W)."""
    L = words.shape[0]
    W = cfg.word_bits
    lanes = jnp.arange(L)
    cursors = counts.astype(jnp.int32)
    states = jnp.zeros(L, dtype=jnp.uint32)

    first = cursors > 0
    word0 = jnp.take_along_axis(words, jnp.maximum(cursors - 1, 0)[:, None], axis=1)[:, 0]
    states = jnp.where(first, word0.astype(jnp.uint32), states)
    cursors = cursors - first.astype(jnp.int32)

    for _ in range(cfg.state_bits // W - 1):
        need = (states < _u32(cfg.lower_bound)) & (cursors > 0)
        nxt = jnp.take_along_axis(words, jnp.maximum(cursors - 1, 0)[:, None], axis=1)[:, 0]
        states = jnp.where(need, (states << W) | nxt.astype(jnp.uint32), states)
        cursors = cursors - need.astype(jnp.int32)
    return states, cursors


def _decode_lookup_impl(
    words: jax.Array,
    counts: jax.Array,
    lookup: jax.Array,
    packed_cdf: jax.Array,
    cfg: LaneConfig,
    num_steps: int,
    num_symbols,
) -> jax.Array:
    """Decode ``num_symbols`` i.i.d. symbols with an O(1) lookup model.

    ``lookup``: u32[2**P] quantile -> symbol index;
    ``packed_cdf``: u32[n+1] with entry ``cdf[s]`` in the low 16 bits  and we
    compute prob as the difference of adjacent entries gathered once via the
    packed table ``(cdf[s] | (prob[s] << 16))``.

    Returns i32[num_steps * L] (padded tail contains garbage beyond
    num_symbols).
    """
    L = words.shape[0]
    W, P = cfg.word_bits, cfg.precision
    qmask = _u32((1 << P) - 1)
    lower = _u32(cfg.lower_bound)
    lanes = jnp.arange(L, dtype=jnp.int32)

    states0, cursors0 = jax_init_decoder_states(words, counts, cfg)

    def step(carry, t):
        states, cursors = carry
        q = states & qmask
        sym = lookup[q].astype(jnp.int32)
        packed = packed_cdf[sym]
        cum = packed & _u32(0xFFFF)
        prob = packed >> 16
        active = (t * L + lanes) < num_symbols
        new_states = (states >> P) * prob + (q - cum)
        states = jnp.where(active, new_states, states)
        refill = active & (states < lower) & (cursors > 0)
        nxt = jnp.take_along_axis(words, jnp.maximum(cursors - 1, 0)[:, None], axis=1)[:, 0]
        states = jnp.where(refill, (states << W) | nxt.astype(jnp.uint32), states)
        cursors = cursors - refill.astype(jnp.int32)
        return (states, cursors), sym

    (_, _), syms = jax.lax.scan(step, (states0, cursors0), jnp.arange(num_steps, dtype=jnp.int32))
    return syms.reshape(-1)


@partial(jax.jit, static_argnames=("cfg", "num_steps", "num_symbols"))
def jax_decode_lookup(
    words, counts, lookup, packed_cdf, cfg: LaneConfig, num_steps: int, num_symbols: int
):
    return _decode_lookup_impl(words, counts, lookup, packed_cdf, cfg, num_steps, num_symbols)


def pack_cdf_u32(cdf: np.ndarray) -> np.ndarray:
    """Pack (cum, prob) per symbol into one u32: cum | (prob << 16).
    Requires precision <= 16."""
    cdf = np.asarray(cdf, dtype=np.uint64)
    cum = cdf[:-1]
    prob = np.diff(cdf)
    packed = (cum | (prob << np.uint64(16))).astype(np.uint32)
    # Append a sentinel so gathers at index n are safe.
    return np.concatenate([packed, np.zeros(1, np.uint32)])


def _encode_impl(
    cums: jax.Array,
    probs: jax.Array,
    cfg: LaneConfig,
    num_steps: int,
    num_symbols,
    max_words: int,
) -> Tuple[jax.Array, jax.Array]:
    """Encode per-symbol (cum, prob) tables, shaped [num_steps, L] (u32).

    Returns (words [L, max_words] u32, counts i32[L]) identical to the numpy
    host encoder `encode_interleaved`.
    """
    L = cums.shape[1]
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    wmask = _u32(cfg.word_mask)
    lanes = jnp.arange(L, dtype=jnp.int32)

    words0 = jnp.zeros((L, max_words), dtype=jnp.uint32)
    states0 = jnp.zeros(L, dtype=jnp.uint32)
    counts0 = jnp.zeros(L, dtype=jnp.int32)

    def step(carry, xs):
        states, counts, words = carry
        t, cp, pp = xs
        active = (t * L + lanes) < num_symbols
        renorm = active & ((states >> (S - P)) >= pp)
        # Masked scatter: out-of-range column index drops the write.
        col = jnp.where(renorm, counts, max_words)
        words = words.at[lanes, col].set(states & wmask, mode="drop")
        counts = counts + renorm.astype(jnp.int32)
        states = jnp.where(renorm, states >> W, states)
        new_states = ((states // pp) << P) | (cp + states % pp)
        states = jnp.where(active, new_states, states)
        return (states, counts, words), None

    ts = jnp.arange(num_steps, dtype=jnp.int32)
    (states, counts, words), _ = jax.lax.scan(
        step, (states0, counts0, words0), (ts, cums, probs), reverse=True
    )

    # Flush final states: significant W-bit chunks, least significant first.
    nbits = 32 - jax.lax.clz(states)  # bit length; 0 for state == 0
    nchunks = (nbits + (W - 1)) // W
    for k in range(S // W):
        put = k < nchunks
        chunk = (states >> (k * W)) & wmask
        col = jnp.where(put, counts, max_words)
        words = words.at[lanes, col].set(chunk, mode="drop")
        counts = counts + put.astype(jnp.int32)

    return words, counts


@partial(jax.jit, static_argnames=("cfg", "num_steps", "num_symbols", "max_words"))
def jax_encode(
    cums, probs, cfg: LaneConfig, num_steps: int, num_symbols: int, max_words: int
):
    return _encode_impl(cums, probs, cfg, num_steps, num_symbols, max_words)


def jax_decode_lookup_dynamic(
    words, counts, lookup, packed_cdf, cfg: LaneConfig, num_steps: int, num_symbols
):
    """Like :func:`jax_decode_lookup` but with a *traced* symbol count
    (needed inside shard_map where each block's length is data)."""
    return _decode_lookup_impl(words, counts, lookup, packed_cdf, cfg, num_steps, num_symbols)


def jax_encode_dynamic(cums, probs, cfg: LaneConfig, num_steps: int, num_symbols, max_words: int):
    """Like :func:`jax_encode` but with a traced symbol count."""
    return _encode_impl(cums, probs, cfg, num_steps, num_symbols, max_words)


def jax_encode_iid_categorical(
    symbols: np.ndarray, cdf: np.ndarray, cfg: LaneConfig
) -> Tuple[jax.Array, jax.Array]:
    """Host-side convenience: build [T, L] tables and call jax_encode."""
    n = len(symbols)
    L = cfg.num_lanes
    T = -(-n // L) if n else 0
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    symbols = np.asarray(symbols, dtype=np.int64)
    cums = np.zeros(T * L, dtype=np.uint32)
    probs = np.ones(T * L, dtype=np.uint32)
    cums[:n] = cdf64[symbols]
    probs[:n] = (cdf64[symbols + 1] - cdf64[symbols]).astype(np.uint32)
    max_words = T + (cfg.state_bits + cfg.word_bits - 1) // cfg.word_bits
    return jax_encode(
        jnp.asarray(cums.reshape(T, L)),
        jnp.asarray(probs.reshape(T, L)),
        cfg,
        T,
        n,
        max_words,
    )
