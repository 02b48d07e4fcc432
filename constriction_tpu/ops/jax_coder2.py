"""Plain-XLA ILANS2 coder (shared-stream interleaved rANS), width-generic.

The twin of the host oracle (ops/interleaved2.py ``encode_shared`` /
``decode_shared_cdf``) as one ``lax.scan`` over the T steps of a batch of
independent container blocks.  It runs wherever XLA runs: it is the CPU
route of the device coder (ops/device_coder.py) and the baseline that the
GPU kernels in ``constriction_tpu/cuda`` are measured against.

Both (W, S) presets are covered: W=16/S=32 with u32 lane states and
W=32/S=64 with native u64 states (the caller enables ``jax_enable_x64``).
Per step:

- decode inverts each lane's quantile through a table lookup (a 2^P table
  at P <= 16, a binary search over the CDF above that);
- the refill ranks are an exclusive integer ``cumsum`` over the refill
  mask, and the refill words one gather at ``base + rank``;
- encode is the mirror: the emission ranks are an integer ``cumsum`` and
  the words one scatter at ``end - k + rank``, walking t = T-1 .. 0.

Shapes: ``states``/``seeds`` [B, L]; symbols [B, T*L] int32 (step-major);
streams [B, cap] u32, one W-bit word per element.  ``nsym`` (int32[1]) is
the symbol count of every block; lanes at or past ``nsym - (T-1)*L`` in the
last step are inactive.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .interleaved import LaneConfig, _state_dtype


def _active(t, nsym, T: int, L: int):
    """[L] mask of the lanes that code a symbol at step ``t``."""
    last = nsym[0] - (T - 1) * L
    n_act = jnp.where(t == T - 1, last, L)
    return jnp.arange(L, dtype=jnp.int32) < n_act


def _excl_ranks(mask):
    """Exclusive prefix count of ``mask`` along the lane axis, and totals."""
    m = mask.astype(jnp.int32)
    incl = jnp.cumsum(m, axis=-1)
    return incl - m, incl[..., -1]


def decode_blocks(states, streams, lens, cdf, lut, nsym, *,
                  cfg: LaneConfig, T: int):
    """Decode B blocks.  ``lut`` is the 2^P quantile -> symbol table
    (int32) at P <= 16; above, it is ignored and each quantile is found
    by a binary search over ``cdf``.  Returns
    ``(symbols int32[B, T*L], final_states [B, L])``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    dt = _state_dtype(cfg)
    streams, lens, lut = map(jnp.asarray, (streams, lens, lut))
    B, cap = streams.shape
    lower = dt(1 << (S - W))
    qmask = dt((1 << P) - 1)
    cdf_s = jnp.asarray(cdf).astype(dt)

    def step(carry, t):
        st, base = carry
        q = st & qmask
        if P <= 16:
            sym = lut[q.astype(jnp.int32)]
        else:
            sym = jnp.searchsorted(
                cdf_s, q, side="right", method="scan_unrolled"
            ).astype(jnp.int32) - 1
        cum = cdf_s[sym]
        prob = cdf_s[sym + 1] - cum
        new = (st >> P) * prob + (q - cum)
        st = jnp.where(_active(t, nsym, T, L), new, st)
        refill = st < lower
        ranks, k = _excl_ranks(refill)
        idx = base[:, None] + ranks
        words = jnp.take_along_axis(streams, jnp.clip(idx, 0, cap - 1), axis=1)
        words = jnp.where(idx < lens[:, None], words, 0).astype(dt)
        st = jnp.where(refill, (st << W) | words, st)
        return (st, base + k), sym

    init = (jnp.asarray(states).astype(dt), jnp.zeros(B, jnp.int32))
    (fin, _), syms = jax.lax.scan(step, init, jnp.arange(T, dtype=jnp.int32))
    return jnp.swapaxes(syms, 0, 1).reshape(B, T * L), fin


def decode_shared_rows(init_states, stream, rows, cfg: LaneConfig,
                       num_steps: int, num_symbols: int):
    """Decode one block with a *different* categorical model per symbol:
    ``rows`` [T, L, K+1] holds each slot's CDF row (inactive tail slots
    need a valid row, e.g. full mass on symbol 0).  Returns int32[T*L]."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    dt = _state_dtype(cfg)
    lower = dt(1 << (S - W))
    qmask = dt((1 << P) - 1)
    stream = jnp.asarray(stream, jnp.uint32)
    cap = max(int(stream.shape[0]), 1)
    stream = jnp.pad(stream, (0, cap - stream.shape[0]))
    nsym = jnp.full((1,), num_symbols, jnp.int32)

    def step(carry, xs):
        st, base = carry
        t, row = xs
        row = row.astype(dt)
        q = st & qmask
        sym = jnp.sum(row[:, 1:-1] <= q[:, None], axis=1, dtype=jnp.int32)
        cum = jnp.take_along_axis(row, sym[:, None], axis=1)[:, 0]
        prob = jnp.take_along_axis(row, sym[:, None] + 1, axis=1)[:, 0] - cum
        new = (st >> P) * prob + (q - cum)
        st = jnp.where(_active(t, nsym, num_steps, L), new, st)
        refill = st < lower
        ranks, k = _excl_ranks(refill)
        idx = base + ranks
        words = jnp.where(idx < stream.shape[0],
                          stream[jnp.clip(idx, 0, cap - 1)], 0).astype(dt)
        st = jnp.where(refill, (st << W) | words, st)
        return (st, base + k), sym

    init = (jnp.asarray(init_states).astype(dt), jnp.int32(0))
    _, syms = jax.lax.scan(
        step, init, (jnp.arange(num_steps, dtype=jnp.int32), rows))
    return syms.reshape(-1)


def encode_blocks(syms, seeds, cdf, nsym, *, cfg: LaneConfig, T: int):
    """Encode B blocks from their encoder start states ``seeds``.  Returns
    ``(buf u32[B, T*L], init_states [B, L], lens int32[B])``; block b's
    words are ``buf[b, T*L - lens[b]:]`` (right-aligned)."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    dt = _state_dtype(cfg)
    B = seeds.shape[0]
    cap = T * L
    wmask = dt((1 << W) - 1)
    cdf_s = jnp.asarray(cdf).astype(dt)
    syms = jnp.asarray(syms)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]

    def step(carry, xs):
        st, end, buf = carry
        t, s = xs
        active = _active(t, nsym, T, L)
        cum = cdf_s[s]
        prob = jnp.where(active, cdf_s[s + 1] - cum, dt(1))
        renorm = active & ((st >> (S - P)) >= prob)
        ranks, k = _excl_ranks(renorm)
        pos = jnp.where(renorm, end[:, None] - k[:, None] + ranks, cap)
        buf = buf.at[rows, pos].set((st & wmask).astype(jnp.uint32),
                                    mode="drop")
        st = jnp.where(renorm, st >> W, st)
        new = ((st // prob) << P) | (cum + st % prob)
        st = jnp.where(active, new, st)
        return (st, end - k, buf), None

    xs = (jnp.arange(T, dtype=jnp.int32),
          jnp.swapaxes(syms.reshape(B, T, L), 0, 1))
    init = (jnp.asarray(seeds).astype(dt), jnp.full(B, cap, jnp.int32),
            jnp.zeros((B, cap), jnp.uint32))
    (st, end, buf), _ = jax.lax.scan(step, init, xs, reverse=True)
    return buf, st, cap - end


def lookup_table(cdf: np.ndarray, precision: int) -> np.ndarray:
    """The 2^P quantile -> symbol table :func:`decode_blocks` gathers from
    at P <= 16 (a one-entry placeholder above, where it searches)."""
    if precision > 16:
        return np.zeros(1, np.int32)
    qs = np.arange(1 << precision, dtype=np.uint64)
    return (np.searchsorted(np.asarray(cdf, np.uint64), qs, side="right")
            - 1).astype(np.int32)
