"""Vectorized (XLA) chain-coder decoding.

The chain coder (ops/chain.py, mirroring /root/reference/src/stream/chain.rs)
reads EXACTLY ``precision`` bits per symbol from the compressed stream — no
data-dependent renormalization — so unlike rANS/range decoding, *quantile
extraction is embarrassingly parallel*: at the default preset (W=32, P=24)
the head buffer runs a fixed 4-symbols-per-3-words cycle

    q[4k+0] = w[3k+0] & 0xFFFFFF
    q[4k+1] = w[3k+1] & 0xFFFFFF
    q[4k+2] = w[3k+2] & 0xFFFFFF
    q[4k+3] = (w[3k]>>24)<<16 | (w[3k+1]>>24)<<8 | (w[3k+2]>>24)

(w = compressed words in pop order), verified against the scalar core.  The
symbol for each quantile depends only on that symbol's own model (chain
locality, chain.rs:1-84), so the whole decode is one batched model
inversion — ideal for rank-2 / per-symbol-model workloads on a device.

This module decodes SYMBOLS only (the common "read the message" path); the
remainders stream needed to reconstruct the original bits for bits-back
round trips is maintained by the scalar core on the host.
"""

from __future__ import annotations


import numpy as np


def head_init_words(data: np.ndarray, word_bits=32, state_bits=64, precision=24):
    """Mirror ChainCoderCore._init_heads for ``from_compressed``: returns the
    number of trailing words consumed to seed the remainders head."""
    threshold = 1 << (state_bits - word_bits - precision)
    if len(data) == 0 or int(data[-1]) == 0:
        raise ValueError("Too little data provided, or data ends in zero word.")
    rem = int(data[-1])
    used = 1
    while rem < threshold:
        if used >= len(data):
            raise ValueError("Too little data provided.")
        rem = (rem << word_bits) | int(data[-1 - used])
        used += 1
    return used


def extract_quantiles(xp, pop_words, n: int):
    """Quantiles for the first ``n`` decoded symbols, given the compressed
    words in pop order (reversed storage order).  W=32, P=24.

    ``pop_words`` must hold at least ``n - n//4`` words; extra words are
    ignored.  Works with xp = numpy or jax.numpy.
    """
    groups = -(-n // 4)
    # pad groups to a multiple of 32 so the interleave is row-local
    # (a [nr, 96] -> [nr, 32, 4] lane shuffle instead of a global transpose)
    groups_p = -(-groups // 32) * 32
    need = 3 * groups_p
    w = pop_words.astype(xp.uint32)
    if int(w.shape[0]) < need:
        pad = need - int(w.shape[0])
        w = xp.concatenate([w, xp.zeros(pad, xp.uint32)])
    w3 = w[:need].reshape(-1, 96)
    a, b, c = w3[:, 0::3], w3[:, 1::3], w3[:, 2::3]  # [nr, 32] each
    mask = xp.uint32((1 << 24) - 1)
    q0 = a & mask
    q1 = b & mask
    q2 = c & mask
    q3 = ((a >> 24) << 16) | ((b >> 24) << 8) | (c >> 24)
    out = xp.stack([q0, q1, q2, q3], axis=2)
    return out.reshape(-1)[:n]


def _searchsorted_sym(xp, q, cdf: np.ndarray):
    """sym = max{s : cdf[s] <= q} via compare-sum (branch-free, no gathers).
    Plain i32 accumulation (precision 24 exceeds the packed-field budget).

    The quantiles are reshaped to [*, 128] tiles and materialized behind an
    optimization barrier first: letting XLA fuse the extraction into all K
    boundary compares would re-run it K times.
    """
    c = [int(v) for v in np.asarray(cdf)]
    K = len(c) - 1
    n = int(q.shape[0])
    if xp is not np:
        import jax

        # pad to full 128-lane tiles so EVERY n gets the barrier (letting
        # XLA refuse the extraction into the K compares was measured 300x
        # slower); the tail slice below drops the padding
        npad = -(-n // 128) * 128
        qp = q if npad == n else xp.concatenate(
            [q, xp.zeros(npad - n, q.dtype)]
        )
        qi = jax.lax.optimization_barrier(
            qp.reshape(-1, 128).astype(xp.int32)
        )
    else:
        qi = q.astype(xp.int32)
    sym = xp.zeros(qi.shape, xp.int32)
    one = xp.ones(qi.shape, xp.int32)
    zero = xp.zeros(qi.shape, xp.int32)
    for j in range(1, K):
        sym = sym + xp.where(qi >= np.int32(c[j]), one, zero)
    return sym.reshape(-1)[:n]


def chain_decode_iid(data: np.ndarray, n: int, cdf: np.ndarray, xp=None):
    """Decode ``n`` i.i.d. symbols from chain-coder data (default preset,
    ``ChainCoderCore.from_compressed`` framing) in one parallel pass.

    Returns an i32 array; matches ChainCoderCore.decode_iid_symbols exactly.
    """
    if xp is None:
        import jax.numpy as jnp

        xp = jnp
    data = np.asarray(data, dtype=np.uint32)
    used = head_init_words(data)
    pop = data[: len(data) - used][::-1].copy()
    if len(pop) < n - n // 4:
        # extract_quantiles would silently zero-pad; the scalar core raises
        from .chain import OutOfCompressedData

        raise OutOfCompressedData("out of compressed data")
    q = extract_quantiles(xp, xp.asarray(pop) if xp is not np else pop, n)
    return _searchsorted_sym(xp, q, cdf)


def chain_decode_rows(data: np.ndarray, rows, xp=None):
    """Decode with a different categorical model per symbol (rank-2
    parameterization): ``rows`` is [n, K+1] fixed-point CDFs (u32, last
    column 2^24).  Fully parallel — the chain coder's symbol-locality means
    no sequential dependency at all."""
    if xp is None:
        import jax.numpy as jnp

        xp = jnp
    rows = xp.asarray(rows)
    n, K1 = rows.shape
    data = np.asarray(data, dtype=np.uint32)
    used = head_init_words(data)
    pop = data[: len(data) - used][::-1].copy()
    if len(pop) < n - n // 4:
        from .chain import OutOfCompressedData

        raise OutOfCompressedData("out of compressed data")
    q = extract_quantiles(xp, xp.asarray(pop) if xp is not np else pop, n)
    if xp is not np:
        import jax

        # fusion barrier (shapes must stay [n] to align with the per-symbol
        # CDF rows, so no tile reshape here)
        qi = jax.lax.optimization_barrier(q.astype(xp.int32))
    else:
        qi = q.astype(xp.int32)
    sym = xp.zeros((n,), xp.int32)
    one = xp.ones((n,), xp.int32)
    zero = xp.zeros((n,), xp.int32)
    for j in range(1, K1 - 1):
        sym = sym + xp.where(qi >= rows[:, j].astype(xp.int32), one, zero)
    return sym
