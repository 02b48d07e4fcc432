"""Lane-interleaved rANS v1 ("ILANS", per-lane streams) -- SUPERSEDED.

STATUS: v1 is kept as a reference implementation and test fixture only.
The product format is ILANS v2 (ops/interleaved2.py: one shared stream)
with the device coder in ops/device_coder.py; `LaneConfig` defined here
remains the shared configuration type.

The reference's rANS coder is intrinsically sequential: each symbol's state
update depends on the previous one (/root/reference/src/stream/stack.rs:
1014-1100).  We restructure the message into L independent lanes (one
rANS state per vector lane): symbol ``i`` belongs to lane ``i % L`` at step
``i // L``.  Each lane is an honest constriction ``AnsCoder`` (same state
algebra, same framing), so every lane's stream is independently decodable by
the scalar host coder -- the interleaving is pure data layout, following the
interleaved-entropy-coder construction of Giesen (arXiv:1402.3392).

Per-lane streams (rather than one shared round-robin stream) are chosen so
that decoding needs no cross-lane prefix sums: each lane keeps its own read
cursor, and one step of the decoder is a handful of vector ops plus 2-3
gathers.

Container format (ILANS v1, little-endian u32 header):

    [0] magic 0x494C414E ("ILAN")
    [1] version (1)
    [2] word_bits | (precision << 8) | (state_bits << 16)
    [3] num_symbols low u32
    [4] num_symbols high u32
    [5] num_lanes L
    [6..6+L) per-lane word counts (in W-bit words)
    then the per-lane streams, concatenated in lane order and packed
    contiguously as W-bit words into u32s (zero-padded to a u32 boundary).

Presets: "small" (W=16, S=32, P<=16) has O(1) lookup decoding; "default" (W=32, S=64, P=24) matches the reference's default
fidelity and runs vectorized on the host / u64-capable backends.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

MAGIC = 0x494C414E


@dataclass(frozen=True)
class LaneConfig:
    num_lanes: int = 1024
    word_bits: int = 16
    state_bits: int = 32
    precision: int = 12

    def __post_init__(self):
        assert self.state_bits >= 2 * self.word_bits
        assert self.state_bits >= self.word_bits + self.precision
        assert self.precision > 0

    @property
    def word_mask(self) -> int:
        return (1 << self.word_bits) - 1

    @property
    def lower_bound(self) -> int:
        return 1 << (self.state_bits - self.word_bits)


SMALL = LaneConfig(word_bits=16, state_bits=32, precision=12)
DEFAULT = LaneConfig(word_bits=32, state_bits=64, precision=24)


def _state_dtype(cfg: LaneConfig):
    return np.uint64 if cfg.state_bits > 32 else np.uint32


# ---------------------------------------------------------------------------
# Host (numpy) encoder/decoder -- exact, vectorized across lanes.
# ---------------------------------------------------------------------------


def encode_interleaved(
    cums: np.ndarray, probs: np.ndarray, cfg: LaneConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode per-symbol (cum, prob) tables into per-lane rANS streams.

    Returns ``(words, counts)`` where ``words`` is a ``[L, max_words]`` u32
    array of W-bit words (lane streams left-aligned, natural order) and
    ``counts[l]`` is the number of valid words in lane ``l``.  Lane ``l``'s
    stream equals ``AnsCoderCore.encode + into_compressed`` of its symbols.
    """
    n = len(cums)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-n // L) if n else 0

    cums64 = np.zeros(T * L, dtype=np.uint64)
    probs64 = np.ones(T * L, dtype=np.uint64)
    cums64[:n] = cums
    probs64[:n] = probs

    states = np.zeros(L, dtype=np.uint64)
    max_words = T + (S + W - 1) // W
    words = np.zeros((L, max(max_words, S // W)), dtype=np.uint32)
    counts = np.zeros(L, dtype=np.int64)
    lanes = np.arange(L)

    for t in range(T - 1, -1, -1):
        idx = t * L + lanes
        active = idx < n
        cp = cums64[idx]
        pp = probs64[idx]

        renorm = active & ((states >> np.uint64(S - P)) >= pp)
        words[lanes[renorm], counts[renorm]] = (states[renorm] & np.uint64(cfg.word_mask)).astype(
            np.uint32
        )
        counts[renorm] += 1
        states[renorm] >>= np.uint64(W)

        new_states = ((states // pp) << np.uint64(P)) | (cp + states % pp)
        states = np.where(active, new_states, states)

    # Append the final states' words, least-significant chunk first with
    # leading zero chunks dropped (stack.rs:891-895, lib.rs:719-730).
    sig = np.zeros(L, dtype=np.int64)
    s = states.copy()
    while np.any(s > 0):
        sig[s > 0] += 1
        s >>= np.uint64(W)
    nchunks = sig  # number of significant W-bit chunks
    for k in range((S + W - 1) // W):
        mask = k < nchunks
        chunk = ((states >> np.uint64(k * W)) & np.uint64(cfg.word_mask)).astype(np.uint32)
        words[lanes[mask], counts[mask]] = chunk[mask]
        counts[mask] += 1

    return words, counts


def init_decoder_states(
    words: np.ndarray, counts: np.ndarray, cfg: LaneConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Read each lane's initial state from the end of its stream
    (stack.rs:440-462 `read_initial_state`, vectorized).

    Returns ``(states u64[L], cursors i64[L])`` where cursor is the number of
    unread bulk words remaining.
    """
    L = len(counts)
    S, W = cfg.state_bits, cfg.word_bits
    states = np.zeros(L, dtype=np.uint64)
    cursors = counts.astype(np.int64).copy()

    lanes = np.arange(L)
    first = cursors > 0
    states[first] = words[lanes[first], cursors[first] - 1]
    cursors[first] -= 1
    for _ in range(S // W - 1):
        need = (states < np.uint64(cfg.lower_bound)) & (cursors > 0)
        nxt = words[lanes[need], cursors[need] - 1]
        states[need] = (states[need] << np.uint64(W)) | nxt
        cursors[need] -= 1
    return states, cursors


def decode_interleaved_lookup(
    words: np.ndarray,
    counts: np.ndarray,
    num_symbols: int,
    lookup: np.ndarray,
    cdf: np.ndarray,
    cfg: LaneConfig,
) -> np.ndarray:
    """Decode i.i.d. symbols with an O(1) lookup model (numpy host path)."""
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision
    T = -(-num_symbols // L) if num_symbols else 0

    states, cursors = init_decoder_states(words, counts, cfg)
    lookup = lookup.astype(np.int64)
    cdf64 = cdf.astype(np.uint64)
    out = np.empty(T * L, dtype=np.int64)
    lanes = np.arange(L)

    for t in range(T):
        q = states & np.uint64((1 << P) - 1)
        sym = lookup[q]
        cum = cdf64[sym]
        prob = cdf64[sym + 1] - cum
        idx = t * L + lanes
        active = idx < num_symbols
        new_states = (states >> np.uint64(P)) * prob + (q - cum)
        states = np.where(active, new_states, states)
        refill = active & (states < np.uint64(cfg.lower_bound)) & (cursors > 0)
        nxt = words[lanes[refill], cursors[refill] - 1]
        states[refill] = (states[refill] << np.uint64(W)) | nxt
        cursors[refill] -= 1
        out[idx] = sym

    return out[:num_symbols]


# ---------------------------------------------------------------------------
# Container serialization
# ---------------------------------------------------------------------------


def pack_container(
    words: np.ndarray, counts: np.ndarray, num_symbols: int, cfg: LaneConfig
) -> np.ndarray:
    """Flatten per-lane streams into the ILANS u32 container."""
    L = cfg.num_lanes
    W = cfg.word_bits
    header = np.array(
        [
            MAGIC,
            1,
            cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16),
            num_symbols & 0xFFFFFFFF,
            (num_symbols >> 32) & 0xFFFFFFFF,
            L,
        ],
        dtype=np.uint32,
    )
    counts32 = counts.astype(np.uint32)
    # Concatenate all lane words (W-bit values) then pack into u32s.
    flat = np.concatenate([words[l, : counts[l]] for l in range(L)]) if L else np.array([], np.uint32)
    if W == 32:
        payload = flat.astype(np.uint32)
    elif W == 16:
        if len(flat) % 2:
            flat = np.concatenate([flat, np.zeros(1, np.uint32)])
        payload = (flat[0::2] | (flat[1::2] << 16)).astype(np.uint32)
    elif W == 8:
        pad = (-len(flat)) % 4
        if pad:
            flat = np.concatenate([flat, np.zeros(pad, np.uint32)])
        payload = (
            flat[0::4] | (flat[1::4] << 8) | (flat[2::4] << 16) | (flat[3::4] << 24)
        ).astype(np.uint32)
    else:
        raise ValueError(f"unsupported word size {W}")
    return np.concatenate([header, counts32, payload])


def unpack_container(data: np.ndarray) -> Tuple[np.ndarray, np.ndarray, int, LaneConfig]:
    """Inverse of :func:`pack_container`; returns (words, counts, n, cfg)."""
    data = np.asarray(data, dtype=np.uint32)
    if int(data[0]) != MAGIC or int(data[1]) != 1:
        raise ValueError("not an ILANS v1 container")
    flags = int(data[2])
    word_bits = flags & 0xFF
    precision = (flags >> 8) & 0xFF
    state_bits = (flags >> 16) & 0xFF
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L = int(data[5])
    cfg = LaneConfig(L, word_bits, state_bits, precision)
    counts = data[6 : 6 + L].astype(np.int64)
    payload = data[6 + L :]
    if word_bits == 32:
        flat = payload
    elif word_bits == 16:
        flat = np.empty(len(payload) * 2, dtype=np.uint32)
        flat[0::2] = payload & 0xFFFF
        flat[1::2] = payload >> 16
    elif word_bits == 8:
        flat = np.empty(len(payload) * 4, dtype=np.uint32)
        flat[0::4] = payload & 0xFF
        flat[1::4] = (payload >> 8) & 0xFF
        flat[2::4] = (payload >> 16) & 0xFF
        flat[3::4] = payload >> 24
    else:
        raise ValueError(f"unsupported word size {word_bits}")
    total = int(counts.sum())
    flat = flat[:total]
    max_words = int(counts.max()) if L else 0
    words = np.zeros((L, max(max_words, state_bits // word_bits)), dtype=np.uint32)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for l in range(L):
        words[l, : counts[l]] = flat[offsets[l] : offsets[l + 1]]
    return words, counts, num_symbols, cfg


# ---------------------------------------------------------------------------
# Convenience: i.i.d. categorical round trip on the host
# ---------------------------------------------------------------------------


def encode_iid_categorical(
    symbols: np.ndarray, cdf: np.ndarray, cfg: LaneConfig
) -> np.ndarray:
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    symbols = np.asarray(symbols, dtype=np.int64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums
    words, counts = encode_interleaved(cums, probs, cfg)
    return pack_container(words, counts, len(symbols), cfg)


def decode_iid_categorical(data: np.ndarray, cdf: np.ndarray) -> np.ndarray:
    words, counts, n, cfg = unpack_container(data)
    cdf = np.asarray(cdf, dtype=np.uint64)
    counts_per_sym = np.diff(cdf.astype(np.int64))
    lookup = np.repeat(np.arange(len(cdf) - 1, dtype=np.int64), counts_per_sym)
    return decode_interleaved_lookup(words, counts, n, lookup, cdf, cfg)
