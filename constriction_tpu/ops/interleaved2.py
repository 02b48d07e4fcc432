"""ILANS v2: shared-stream interleaved rANS (format definition + host oracle).

- All L lanes share ONE word stream laid out in exact decode-consumption
  order (Giesen's single-stream interleaving, arXiv:1402.3392): at decode
  step t, the lanes whose state dropped below 2**(S-W) read the next words
  from the stream, in ascending lane order.  A decoder finds lane l's word
  at ``base + rank_l``, with rank the exclusive prefix sum of the refill
  mask over the lanes -- one contiguous run of the stream per step.
- Lane states are *seeded* at exactly 2**(S-W) so the state invariant
  ``state >= 2**(S-W)`` holds from the first step; the decode refill
  condition ``state < 2**(S-W)`` then mirrors the encoder's emission schedule
  one-to-one with no per-lane word counts.  Initial decoder states are stored
  as a dense [L] header (the only rate overhead vs. a single-lane coder;
  ops/framing.py's v2 container packs them and recovers the seeds).

The device twins (ops/device_coder.py: GPU kernels, and a plain-XLA coder)
produce exactly this module's bytes.

Per-lane coding algebra is exactly the reference's rANS
(/root/reference/src/stream/stack.rs:1014-1100), so fidelity/precision
behavior matches the "small" preset family.

Container layout (u32 words):

    [0] magic 0x494C4E32 ("ILN2")  [1] version=1
    [2] word_bits | precision << 8 | state_bits << 16
    [3] num_symbols lo   [4] num_symbols hi   [5] num_lanes L
    [6] stream length (in W-bit words)
    [7 .. 7+L)        initial decoder states (u32), for state_bits <= 32;
                      for state_bits in (32, 64] (the DEFAULT preset) the
                      states occupy [7 .. 7+2L) as two u32 planes, all L
                      low words then all L high words
    [7+L .. ]         stream, W-bit words packed into u32 (little-endian)
                      (payload starts at 7+2L for state_bits > 32)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from functools import lru_cache

from .interleaved import LaneConfig

MAGIC2 = 0x494C4E32


@lru_cache(maxsize=16)
def _lookup_table_cached(cdf_bytes: bytes, precision: int) -> np.ndarray:
    """quantile -> symbol table for the native O(1) decoder, memoized so
    repeated decodes with the same model skip the O(2^P) host build."""
    cdf = np.frombuffer(cdf_bytes, dtype=np.uint32).astype(np.uint64)
    qs = np.arange(1 << precision, dtype=np.uint64)
    return (np.searchsorted(cdf, qs, side="right") - 1).astype(np.uint32)


L1_BITS = 16


@lru_cache(maxsize=16)
def _l1_table_cached(cdf_bytes: bytes, precision: int,
                     l1_bits: int) -> np.ndarray:
    """Bucket table for the native two-level CDF search (wide presets where
    the full 2^P lookup would be 64 MB): entry i is the largest symbol whose
    left cumulative is <= (i << (P - l1_bits)).  (1 << l1_bits) + 1 u32
    entries (256 KB at the default l1_bits=16), memoized per model."""
    cdf = np.frombuffer(cdf_bytes, dtype=np.uint32).astype(np.uint64)
    bases = np.arange((1 << l1_bits) + 1, dtype=np.uint64) << np.uint64(
        precision - l1_bits
    )
    return (np.searchsorted(cdf, bases, side="right") - 1).astype(np.uint32)


def encode_shared(
    cums: np.ndarray, probs: np.ndarray, cfg: LaneConfig,
    seeds: np.ndarray | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host (numpy) ILANS2 encoder.

    `cums`/`probs`: per-symbol fixed-point tables (length N).  Returns
    ``(initial_states u32[L], stream u32[num_words])`` with stream entries
    being W-bit words in decode-consumption order.

    ``seeds`` (optional, [L], state dtype) are per-lane encoder START
    states, each in ``[2**(S-W), 2**S)``; default is the floor
    ``2**(S-W)``.  A full decode's final lane states equal the seeds
    exactly, so seeds in ``[2**(S-W), 2**(S-W+1))`` carry S-W bits/lane of
    payload the decoder recovers for free (the v2 container framing,
    ops/framing.py).
    """
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-n // L) if n else 0
    seed = np.uint64(1 << (S - W))
    if seeds is not None:
        seeds = np.asarray(seeds, dtype=np.uint64).reshape(-1)
        if len(seeds) != L:
            raise ValueError(f"seeds must have num_lanes={L} entries")
        if np.any(seeds >> np.uint64(S - W) == 0) or (
            S < 64 and np.any(seeds >> np.uint64(S))
        ):
            raise ValueError("seeds must lie in [2^(S-W), 2^S)")

    from .. import native

    # the native path returns S <= 32 lane states as u32 and S in (32, 64]
    # (the reference's DEFAULT preset state size) as (lo, hi) u32 pairs
    if native.LIB is not None and n >= 256:
        wide = S > 32
        cap = T * L + 8
        buf = np.empty(cap, dtype=np.uint32)
        states_out = np.empty(2 * L if wide else L, dtype=np.uint32)
        if seeds is None:
            slen = native.LIB.ctpu_ilans2_encode(
                np.ascontiguousarray(cums, dtype=np.uint32),
                np.ascontiguousarray(probs, dtype=np.uint32),
                n, L, T, W, S, P, states_out, buf, cap,
            )
        else:
            if wide:
                seeds_w = np.empty(2 * L, dtype=np.uint32)
                seeds_w[0::2] = (seeds & np.uint64(0xFFFFFFFF)).astype(
                    np.uint32
                )
                seeds_w[1::2] = (seeds >> np.uint64(32)).astype(np.uint32)
            else:
                seeds_w = seeds.astype(np.uint32)
            slen = native.LIB.ctpu_ilans2_encode_seeded(
                np.ascontiguousarray(cums, dtype=np.uint32),
                np.ascontiguousarray(probs, dtype=np.uint32),
                n, L, T, W, S, P, seeds_w, states_out, buf, cap,
            )
        if wide:
            states_out = states_out[0::2].astype(np.uint64) | (
                states_out[1::2].astype(np.uint64) << np.uint64(32)
            )
        return states_out, buf[cap - slen :].copy()

    cums64 = np.zeros(T * L, dtype=np.uint64)
    probs64 = np.ones(T * L, dtype=np.uint64)
    cums64[:n] = cums
    probs64[:n] = probs

    states = (
        seeds.copy() if seeds is not None
        else np.full(L, seed, dtype=np.uint64)
    )
    chunks = []  # per-step emitted words; encoder walks t = T-1 .. 0
    lanes = np.arange(L)
    wmask = np.uint64(cfg.word_mask)

    for t in range(T - 1, -1, -1):
        idx = t * L + lanes
        active = idx < n
        cp = cums64[idx]
        pp = probs64[idx]
        renorm = active & ((states >> np.uint64(S - P)) >= pp)
        chunks.append((states[renorm] & wmask).astype(np.uint32))
        states = np.where(renorm, states >> np.uint64(W), states)
        new_states = ((states // pp) << np.uint64(P)) | (cp + states % pp)
        states = np.where(active, new_states, states)

    stream = (
        np.concatenate(chunks[::-1]) if chunks else np.zeros(0, dtype=np.uint32)
    )
    # S <= 32 states fit the container's u32 plane; S in (32, 64] (the
    # reference's DEFAULT preset state size) returns u64 states.
    from .interleaved import _state_dtype

    return states.astype(_state_dtype(cfg)), stream


def decode_shared_cdf(
    init_states: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
    return_final_states: bool = False,
) -> np.ndarray:
    """Host ILANS2 decoder with a CDF-table model (C++ lookup decoder when
    available, numpy twin otherwise -- identical results).

    This is the exact oracle for the JAX kernel (same schedule, table
    lookup / searchsorted instead of compare-sum).

    ``return_final_states=True`` returns ``(symbols, final_states)``; after
    a full decode the final states equal the encoder's seeds, whose low
    S-W bits are recoverable payload under the v2 framing (ops/framing.py).
    """
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if len(init_states) != L:
        raise ValueError(
            f"init_states must have num_lanes={L} entries, got {len(init_states)}"
        )
    if int(np.asarray(cdf)[-1]) != 1 << P:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << P}, got {int(np.asarray(cdf)[-1])}"
        )
    T = -(-num_symbols // L) if num_symbols else 0
    lower = np.uint64(1 << (S - W))

    from .. import native

    if native.LIB is not None and num_symbols >= 256 and S <= 32 and P <= 20:
        cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
        lookup = _lookup_table_cached(cdf32.tobytes(), P)
        # explicit copy: the native decoder writes final states back into
        # this array, and ascontiguousarray would alias the caller's input
        st32 = np.array(init_states, dtype=np.uint32, copy=True)
        stream32 = np.ascontiguousarray(stream, dtype=np.uint32)
        out = np.empty(num_symbols, dtype=np.int32)
        native.LIB.ctpu_ilans2_decode_lookup(
            st32, stream32, len(stream32), num_symbols, L, T,
            lookup, cdf32, W, S, P, out,
        )
        if return_final_states:
            return out, st32
        return out

    if native.LIB is not None and num_symbols >= 256 and 32 < S <= 64:
        # default-preset states: (lo, hi) u32 pairs + two-level CDF search
        # (a P = 24 full lookup table would be 64 MB; the bucket table is
        # 256 KB and confines the search to a span that is almost always 1)
        cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
        st = np.asarray(init_states, dtype=np.uint64)
        pairs = np.empty(2 * L, dtype=np.uint32)
        pairs[0::2] = (st & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pairs[1::2] = (st >> np.uint64(32)).astype(np.uint32)
        stream32 = np.ascontiguousarray(stream, dtype=np.uint32)
        out = np.empty(num_symbols, dtype=np.int32)
        if P > L1_BITS:
            l1 = _l1_table_cached(cdf32.tobytes(), P, L1_BITS)
            native.LIB.ctpu_ilans2_decode_cdf64_l1(
                pairs, stream32, len(stream32), num_symbols, L, T,
                cdf32, len(cdf32), l1, L1_BITS, W, S, P, out,
            )
        else:
            native.LIB.ctpu_ilans2_decode_cdf64(
                pairs, stream32, len(stream32), num_symbols, L, T,
                cdf32, len(cdf32), W, S, P, out,
            )
        if return_final_states:
            fin = pairs[0::2].astype(np.uint64) | (
                pairs[1::2].astype(np.uint64) << np.uint64(32)
            )
            return out, fin
        return out

    states = init_states.astype(np.uint64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)

    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        new_states = (states >> np.uint64(P)) * prob + (q - cum)
        states = np.where(active, new_states, states)
        m = states < lower
        k = int(m.sum())
        if k:
            # zero-fill a truncated stream (same degradation as the range
            # twin below) instead of a numpy broadcast crash
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base : base + k]
            words[: len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
        out[idx] = sym

    if return_final_states:
        from .interleaved import _state_dtype

        return out[:num_symbols], states.astype(_state_dtype(cfg))
    return out[:num_symbols]


# ---------------------------------------------------------------------------
# ILANS2-R: shared-stream interleaved RANGE coding (host paths via C++)
# ---------------------------------------------------------------------------


def encode_shared_range(
    cums: np.ndarray, probs: np.ndarray, cfg: LaneConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode per-symbol tables with per-lane range coders sharing one word
    stream in decode-consumption order (C++; see codec.cpp ILANS2-R).

    Returns ``(points u32[L], stream u32[num_words])``.
    """
    from .. import native

    if native.LIB is None:
        raise RuntimeError("native codec required for range shared-stream encode")
    n = len(cums)
    if len(probs) != n:
        raise ValueError(
            f"cums and probs must have equal length, got {n} vs {len(probs)}"
        )
    L = cfg.num_lanes
    T = -(-n // L) if n else 0
    wide = cfg.state_bits > 32
    # S > 32 points do not fit one u32: the native export writes (lo, hi)
    # u32 pairs per lane
    points = np.zeros(2 * L if wide else L, dtype=np.uint32)
    buf = np.zeros(max(T * L, 1), dtype=np.uint32)
    slen = native.LIB.ctpu_ilans2_range_encode(
        np.ascontiguousarray(cums, dtype=np.uint32),
        np.ascontiguousarray(probs, dtype=np.uint32),
        n, L, T, cfg.word_bits, cfg.state_bits, cfg.precision,
        points, buf,
    )
    if wide:
        points = points[0::2].astype(np.uint64) | (
            points[1::2].astype(np.uint64) << np.uint64(32)
        )
    return points, buf[:slen].copy()


def decode_shared_range_cdf(
    points: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
) -> np.ndarray:
    """Numpy oracle for the shared-stream range decoder (vectorized across
    lanes per step; mirrors the JAX kernel exactly)."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    if len(points) != L:
        raise ValueError(
            f"points must have num_lanes={L} entries, got {len(points)}"
        )
    if int(np.asarray(cdf)[-1]) != 1 << P:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << P}, got {int(np.asarray(cdf)[-1])}"
        )
    T = -(-num_symbols // L) if num_symbols else 0
    mask = np.uint64((1 << S) - 1)
    lower_bound = np.uint64(1 << (S - W))

    from .. import native

    if native.LIB is not None and num_symbols >= 256 and S <= 64:
        cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
        l1_bits = min(P, L1_BITS)
        l1 = _l1_table_cached(cdf32.tobytes(), P, l1_bits)
        pts64 = np.asarray(points, dtype=np.uint64)
        pairs = np.empty(2 * L, dtype=np.uint32)
        pairs[0::2] = (pts64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        pairs[1::2] = (pts64 >> np.uint64(32)).astype(np.uint32)
        stream32 = np.ascontiguousarray(stream, dtype=np.uint32)
        out = np.empty(num_symbols, dtype=np.int32)
        bad = native.LIB.ctpu_ilans2_range_decode_cdf_l1(
            pairs, stream32, len(stream32), num_symbols, L, T,
            cdf32, len(cdf32), l1, l1_bits, W, S, P, out,
        )
        if bad >= 0:
            raise ValueError(
                "Tried to decode data that is inconsistent with the entropy "
                f"model (quantile >= 2**precision at symbol {bad})."
            )
        return out

    lows = np.zeros(L, dtype=np.uint64)
    rngs = np.full(L, mask, dtype=np.uint64)
    pts = points.astype(np.uint64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)

    for t in range(T):
        idx = t * L + lanes
        active = idx < num_symbols
        scale = rngs >> np.uint64(P)
        q = ((pts - lows) & mask) // scale
        bad = active & (q >= cdf64[-1])
        if bad.any():
            raise ValueError(
                "Tried to decode data that is inconsistent with the entropy "
                f"model (quantile >= 2**precision at symbol {int(idx[bad][0])})."
            )
        # inactive (padding) lanes may hold garbage points in a corrupt
        # container; clamp them so searchsorted cannot land past the table
        q = np.where(active, q, np.uint64(0))
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        new_lows = (lows + scale * cum) & mask
        new_rngs = scale * prob
        lows = np.where(active, new_lows, lows)
        rngs = np.where(active, new_rngs, rngs)
        m = active & (rngs < lower_bound)
        k = int(m.sum())
        lows = np.where(m, (lows << np.uint64(W)) & mask, lows)
        rngs = np.where(m, rngs << np.uint64(W), rngs)
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base : base + k]
            words[: len(avail)] = avail
            pts_m = ((pts[m] << np.uint64(W)) & mask) | words
            pts[m] = pts_m
            base += k
        out[idx] = sym

    return out[:num_symbols]


def encode_iid_categorical_range(symbols, cdf, cfg: LaneConfig):
    """Host (C++) ILANS2-R encode of i.i.d. categorical symbols."""
    symbols = np.asarray(symbols, dtype=np.int64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums
    return encode_shared_range(cums, probs, cfg)


# ---------------------------------------------------------------------------
# Container
# ---------------------------------------------------------------------------


def pack_words(stream: np.ndarray, word_bits: int) -> np.ndarray:
    """Pack W-bit words (one per u32 element) into dense u32 payload
    (little-endian within each u32) -- the one shared implementation for
    every container format (single, sharded, framing v2)."""
    if word_bits == 32:
        return stream.astype(np.uint32)
    per = 32 // word_bits
    pad = (-len(stream)) % per
    if pad:
        stream = np.concatenate([stream, np.zeros(pad, np.uint32)])
    out = stream[0::per].astype(np.uint32)
    for k in range(1, per):
        out = out | (stream[k::per].astype(np.uint32) << (word_bits * k))
    return out


def unpack_words(payload: np.ndarray, word_bits: int,
                 count: int) -> np.ndarray:
    """Inverse of :func:`pack_words` (``count`` = W-bit word count)."""
    if word_bits == 32:
        return payload[:count]
    per = 32 // word_bits
    mask = np.uint32((1 << word_bits) - 1)
    out = np.empty(len(payload) * per, dtype=np.uint32)
    for k in range(per):
        out[k::per] = (payload >> np.uint32(word_bits * k)) & mask
    return out[:count]


def pack_container2(
    init_states: np.ndarray, stream: np.ndarray, num_symbols: int, cfg: LaneConfig
) -> np.ndarray:
    L = cfg.num_lanes
    W = cfg.word_bits
    header = np.array(
        [
            MAGIC2,
            1,
            cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16),
            num_symbols & 0xFFFFFFFF,
            (num_symbols >> 32) & 0xFFFFFFFF,
            L,
            len(stream),
        ],
        dtype=np.uint32,
    )
    if W == 32:
        payload = stream.astype(np.uint32)
    elif W == 16:
        flat = stream
        if len(flat) % 2:
            flat = np.concatenate([flat, np.zeros(1, np.uint32)])
        payload = (flat[0::2] | (flat[1::2] << 16)).astype(np.uint32)
    elif W == 8:
        flat = stream
        pad = (-len(flat)) % 4
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.uint32)])
        payload = (
            flat[0::4] | (flat[1::4] << 8) | (flat[2::4] << 16) | (flat[3::4] << 24)
        ).astype(np.uint32)
    else:
        raise ValueError(f"unsupported word size {W}")
    if cfg.state_bits > 32:
        # default-preset (S = 64) states: two u32 planes, lo then hi
        st = np.asarray(init_states, dtype=np.uint64)
        states_words = np.concatenate([
            (st & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (st >> np.uint64(32)).astype(np.uint32),
        ])
    else:
        states_words = init_states.astype(np.uint32)
    return np.concatenate([header, states_words, payload])


def unpack_container2(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int, LaneConfig]:
    data = np.asarray(data, dtype=np.uint32)
    if int(data[0]) != MAGIC2 or int(data[1]) != 1:
        raise ValueError("not an ILANS2 container")
    flags = int(data[2])
    word_bits = flags & 0xFF
    precision = (flags >> 8) & 0xFF
    state_bits = (flags >> 16) & 0xFF
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L = int(data[5])
    stream_len = int(data[6])
    cfg = LaneConfig(L, word_bits, state_bits, precision)
    if state_bits > 32:
        init_states = (
            data[7 : 7 + L].astype(np.uint64)
            | (data[7 + L : 7 + 2 * L].astype(np.uint64) << np.uint64(32))
        )
        payload = data[7 + 2 * L :]
    else:
        init_states = data[7 : 7 + L]
        payload = data[7 + L :]
    if word_bits == 32:
        stream = payload
    elif word_bits == 16:
        stream = np.empty(len(payload) * 2, dtype=np.uint32)
        stream[0::2] = payload & 0xFFFF
        stream[1::2] = payload >> 16
    elif word_bits == 8:
        stream = np.empty(len(payload) * 4, dtype=np.uint32)
        stream[0::4] = payload & 0xFF
        stream[1::4] = (payload >> 8) & 0xFF
        stream[2::4] = (payload >> 16) & 0xFF
        stream[3::4] = payload >> 24
    else:
        raise ValueError(f"unsupported word size {word_bits}")
    return init_states, stream[:stream_len], num_symbols, cfg


def encode_iid_categorical2(
    symbols: np.ndarray, cdf: np.ndarray, cfg: LaneConfig, device: bool = False
) -> np.ndarray:
    """Encode i.i.d. categorical symbols into an ILANS2 container.

    ``device=True`` runs the device encoder (ops/device_coder.py;
    bit-identical container); the default is the host (C++/numpy) path.
    """
    from . import device_coder

    symbols = np.asarray(symbols, dtype=np.int64)
    if device and device_coder.supports(cfg):
        states, stream = device_coder.encode(symbols, cdf, cfg)
        return pack_container2(states, stream, len(symbols), cfg)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums
    states, stream = encode_shared(cums, probs, cfg)
    return pack_container2(states, stream, len(symbols), cfg)


def decode_iid_categorical2(
    data: np.ndarray, cdf: np.ndarray, device: bool = False
) -> np.ndarray:
    """Decode an ILANS2 container; ``device=True`` uses the device decoder
    (ops/device_coder.py; identical output), the default the host oracle."""
    from . import device_coder

    init_states, stream, n, cfg = unpack_container2(data)
    if device and device_coder.supports(cfg):
        return device_coder.decode(init_states, stream, n, cdf, cfg)
    return decode_shared_cdf(init_states, stream, n, cdf, cfg)


# ---------------------------------------------------------------------------
# Random access: periodic decoder checkpoints (the interleaved analog of the
# reference's Pos/Seek jump tables, stack.rs:643-700 / lib.rs:425-580)
# ---------------------------------------------------------------------------


def build_checkpoints(
    init_states: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
    interval: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode once, capturing a (stream offset, lane states) snapshot every
    ``interval`` steps.  Snapshot c is a complete coder state for symbol
    ``c * interval * L`` on: seed :func:`decode_shared_cdf` (or the device
    decoder) with ``(states[c], stream[offsets[c]:])`` to decode the suffix
    bit-exactly without touching the prefix.

    Returns ``(offsets i64[C], states u32[C, L])`` — u64 states for
    ``state_bits > 32`` — with
    ``C = ceil(T / interval) - 1`` (the t=0 snapshot is the container header
    itself).
    """
    assert interval > 0
    from .interleaved import _state_dtype

    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    C = max(-(-T // interval) - 1, 0)
    offsets = np.zeros(C, dtype=np.int64)
    states_out = np.zeros((C, L), dtype=_state_dtype(cfg))
    if C == 0:
        return offsets, states_out

    from .. import native

    if native.LIB is not None and S <= 32 and P <= 20:
        cdf32 = np.ascontiguousarray(np.asarray(cdf), dtype=np.uint32)
        lookup = _lookup_table_cached(cdf32.tobytes(), P)
        out = np.empty(num_symbols, dtype=np.int32)
        native.LIB.ctpu_ilans2_decode_ckpt(
            np.ascontiguousarray(init_states, dtype=np.uint32),
            np.ascontiguousarray(stream, dtype=np.uint32), len(stream),
            num_symbols, L, T, lookup, cdf32, W, S, P, out,
            interval, offsets, states_out.reshape(-1),
        )
        return offsets, states_out

    # numpy twin
    states = init_states.astype(np.uint64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    base = 0
    lanes = np.arange(L)
    lower = np.uint64(1 << (S - W))
    c = 0
    for t in range(T):
        if t > 0 and t % interval == 0:
            offsets[c] = base
            states_out[c] = states.astype(states_out.dtype)
            c += 1
        idx = t * L + lanes
        active = idx < num_symbols
        q = states & np.uint64((1 << P) - 1)
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        new_states = (states >> np.uint64(P)) * prob + (q - cum)
        states = np.where(active, new_states, states)
        m = states < lower
        k = int(m.sum())
        if k:
            # zero-fill a truncated stream (same degradation as the range
            # twin below) instead of a numpy broadcast crash
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base : base + k]
            words[: len(avail)] = avail
            states[m] = (states[m] << np.uint64(W)) | words
            base += k
    return offsets, states_out


def decode_from_checkpoint(
    ckpt_index: int,
    offsets: np.ndarray,
    ckpt_states: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
    interval: int,
    device: bool = False,
) -> Tuple[int, np.ndarray]:
    """Decode the message suffix starting at checkpoint ``ckpt_index``
    (symbol ``(ckpt_index + 1) * interval * L``).  Returns
    ``(start_symbol, suffix_symbols)``; bit-exact with the corresponding
    slice of a full decode.  ``device=True`` runs the device decoder (a
    checkpoint is an ordinary (states, stream-suffix) pair)."""
    L = cfg.num_lanes
    start = (ckpt_index + 1) * interval * L
    remaining = num_symbols - start
    if remaining <= 0:
        return start, np.zeros(0, dtype=np.int64)
    sub_stream = stream[int(offsets[ckpt_index]) :]
    from . import device_coder

    if device and device_coder.supports(cfg):
        out = device_coder.decode(
            ckpt_states[ckpt_index], sub_stream, remaining, cdf, cfg
        )
    else:
        out = decode_shared_cdf(
            ckpt_states[ckpt_index], sub_stream, remaining, cdf, cfg
        )
    return start, out


def _range_oracle_loop(
    pts, lows, rngs, stream, num_symbols, cdf64, cfg, capture_interval=0,
):
    """Vectorized range-decode loop from an ARBITRARY (lows, rngs, pts)
    state (the general form of decode_shared_range_cdf's numpy oracle;
    reference algebra queue.rs:968-1035).  With ``capture_interval`` > 0,
    snapshots (stream offset, lows, rngs, pts) BEFORE every
    ``capture_interval``-th step.  Returns ``(symbols, captures)``."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0
    mask = np.uint64((1 << S) - 1) if S < 64 else np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    lower_bound = np.uint64(1 << (S - W))
    base = 0
    out = np.empty(T * L, dtype=np.int32)
    lanes = np.arange(L)
    caps = []
    for t in range(T):
        if capture_interval > 0 and t > 0 and t % capture_interval == 0:
            caps.append((base, lows.copy(), rngs.copy(), pts.copy()))
        idx = t * L + lanes
        active = idx < num_symbols
        scale = rngs >> np.uint64(P)
        q = ((pts - lows) & mask) // scale
        bad = active & (q >= cdf64[-1])
        if bad.any():
            raise ValueError(
                "Tried to decode data that is inconsistent with the entropy "
                f"model (quantile >= 2**precision at symbol {int(idx[bad][0])})."
            )
        q = np.where(active, q, np.uint64(0))
        sym = np.searchsorted(cdf64, q, side="right") - 1
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        lows = np.where(active, (lows + scale * cum) & mask, lows)
        rngs = np.where(active, scale * prob, rngs)
        m = active & (rngs < lower_bound)
        k = int(m.sum())
        lows = np.where(m, (lows << np.uint64(W)) & mask, lows)
        rngs = np.where(m, rngs << np.uint64(W), rngs)
        if k:
            words = np.zeros(k, dtype=np.uint64)
            avail = stream[base: base + k]
            words[: len(avail)] = avail
            pts[m] = ((pts[m] << np.uint64(W)) & mask) | words
            base += k
        out[idx] = sym
    return out[:num_symbols], caps


def build_checkpoints_range(
    points: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
    interval: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Range-coder twin of :func:`build_checkpoints`: decode once (numpy
    oracle), capturing the FULL decoder state -- (stream offset, lows,
    ranges, points) -- every ``interval`` grid steps.  Snapshot c resumes
    decoding at symbol ``(c + 1) * interval * L`` via
    :func:`decode_range_from_checkpoint`, bit-exact with a full decode.

    Returns ``(offsets i64[C], lows [C, L], rngs [C, L], pts [C, L])``
    with ``C = ceil(T / interval) - 1`` (t=0 is the container itself;
    reference analog of the Pos/Seek jump tables, queue.rs:911-928)."""
    assert interval > 0
    from .interleaved import _state_dtype

    L = cfg.num_lanes
    S = cfg.state_bits
    T = -(-num_symbols // L) if num_symbols else 0
    C = max(-(-T // interval) - 1, 0)
    dt = _state_dtype(cfg)
    offsets = np.zeros(C, dtype=np.int64)
    lows_out = np.zeros((C, L), dtype=dt)
    rngs_out = np.zeros((C, L), dtype=dt)
    pts_out = np.zeros((C, L), dtype=dt)
    if C == 0:
        return offsets, lows_out, rngs_out, pts_out
    mask = np.uint64((1 << S) - 1) if S < 64 else np.uint64(
        0xFFFFFFFFFFFFFFFF
    )
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    _, caps = _range_oracle_loop(
        points.astype(np.uint64), np.zeros(L, np.uint64),
        np.full(L, mask, np.uint64), stream, num_symbols, cdf64, cfg,
        capture_interval=interval,
    )
    for c, (base, lo, rn, pt) in enumerate(caps):
        offsets[c] = base
        lows_out[c] = lo.astype(dt)
        rngs_out[c] = rn.astype(dt)
        pts_out[c] = pt.astype(dt)
    return offsets, lows_out, rngs_out, pts_out


def decode_range_from_checkpoint(
    ckpt_index: int,
    offsets: np.ndarray,
    lows: np.ndarray,
    rngs: np.ndarray,
    pts: np.ndarray,
    stream: np.ndarray,
    num_symbols: int,
    cdf: np.ndarray,
    cfg: LaneConfig,
    interval: int,
) -> Tuple[int, np.ndarray]:
    """Decode a range stream's suffix from checkpoint ``ckpt_index``
    (:func:`build_checkpoints_range`); bit-exact with the corresponding
    slice of a full decode (host oracle)."""
    L = cfg.num_lanes
    start = (ckpt_index + 1) * interval * L
    remaining = num_symbols - start
    if remaining <= 0:
        return start, np.zeros(0, dtype=np.int64)
    sub_stream = stream[int(offsets[ckpt_index]):]
    lo = np.asarray(lows[ckpt_index], np.uint64)
    rn = np.asarray(rngs[ckpt_index], np.uint64)
    pt = np.asarray(pts[ckpt_index], np.uint64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    out, _ = _range_oracle_loop(
        pt.copy(), lo.copy(), rn.copy(), sub_stream, remaining, cdf64, cfg
    )
    return start, out
