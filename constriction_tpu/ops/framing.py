"""Compact container framing (v2): whole-message rate parity.

The v1 ILANS2 container ships its L lane states RAW (L*S bits -- 256 KiB at
the DEFAULT preset's L=32768/S=64), while the reference appends a few words
of final coder state to the stream (stack.rs:891-895, framing at
lib.rs:719-730) for ~0.0015% whole-message overhead.  Version 2 closes that
gap with two mechanisms, both pure host-side framing (the device kernels
and the wire coding algebra are untouched):

1. **Variable-width state packing.**  A decoder-side initial state (= the
   encoder's final state) always lies in [2^(S-W), 2^S).  Each state is
   stored as a ceil(log2(W))-bit width field plus its significant bits sans
   the implicit leading 1 -- log-uniform states average ~(S - W/2) bits
   instead of S.

2. **Recovered-seed payload.**  rANS decoding is the exact inverse of
   encoding, so after consuming the full stream the decoder's lane states
   return to the encoder's SEED states.  Seeds in [2^(S-W), 2^(S-W+1))
   therefore carry (S-W) bits/lane of payload that the decoder recovers
   for free.  The encoder splits the message: the LAST k_B symbols (region
   B) are encoded first with a small lane count L_B; region B's stream --
   plus as much of region B's packed states as fits -- rides inside region
   A's seeds.  Net framing overhead drops to ~(ceil(log2(W)) - 1) bits per
   lane plus region B's own (tiny) floor cost: ~0.1% at the DEFAULT-preset
   16.7M-symbol benchmark row versus 1.5% for v1.

Layout (u32 words; v1 layout in interleaved2.py:30-41):

    [0]  magic 0x494C4E32 ("ILN2")    [1] version = 2
    [2]  word_bits | precision << 8 | state_bits << 16
    [3]  num_symbols lo  [4] num_symbols hi   (A + B symbols)
    [5]  L_A   [6] stream_A length (W-bit words)
    [7]  k_B (region-B symbols; 0 = compact-only, no seed payload)
    [8]  L_B   [9] stream_B length (W-bit words, carried in A's seeds)
    [10] psa_bits (packed states_A)   [11] psb_bits (packed states_B)
    [12 ..]  packed states_A, ceil(psa_bits/32) words
    [..]     packed states_B remainder (the suffix of the psb blob that
             did not fit in the seed slack), ceil(rem_bits/32) words
    [..]     stream_A payload, W-bit words packed into u32 (as v1)

Bit conventions: all packed sections are MSB-first bit streams; u32 words
enter/leave the bit domain big-endian (numpy '>u4'), so the layout is
platform-independent.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .interleaved import LaneConfig
from . import interleaved2 as il2

MAGIC2 = il2.MAGIC2


# ---------------------------------------------------------------------------
# Bit-stream helpers (vectorized; MSB-first)
# ---------------------------------------------------------------------------


def _bits_from_u32(words: np.ndarray) -> np.ndarray:
    """u32 array -> uint8 bit array, MSB-first within each word."""
    return np.unpackbits(
        np.ascontiguousarray(words, dtype=np.uint32).astype(">u4").view(
            np.uint8
        )
    )


def _u32_from_bits(bits: np.ndarray) -> np.ndarray:
    """uint8 bit array -> u32 array (zero-padded to a word boundary)."""
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).view(">u4").astype(np.uint32)


def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Vectorized bit_length for u64 (0 -> 0)."""
    x = x.astype(np.uint64)
    w = np.zeros(len(x), dtype=np.int64)
    v = x.copy()
    for k in (32, 16, 8, 4, 2, 1):
        big = v >> np.uint64(k) != 0
        w += np.where(big, k, 0)
        v = np.where(big, v >> np.uint64(k), v)
    return w + (v != 0)


def _wbits(cfg: LaneConfig) -> int:
    """Width-field size: states span W distinct bit lengths [S-W+1 .. S]."""
    return (cfg.word_bits - 1).bit_length()


def _widths_cdf_from_probs(probs_q: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(probs_q.astype(np.uint64))])


_WP = 12  # fixed-point precision of the coded-widths model


def pack_states(states: np.ndarray, cfg: LaneConfig) -> Tuple[np.ndarray, int]:
    """Variable-width packing of lane states into a bit array.

    Layout: a 1-bit mode flag, then either

    - RAW (flag 0): L width fields (wbits each, value = bit_length -
      (S-W+1)), then the L value fields (bit_length - 1 bits each,
      leading 1 implicit); or
    - CODED (flag 1): a 16-bit word count, W quantized 13-bit width
      probabilities (the stored model -- both sides share it exactly),
      the host-AnsCoder-compressed width symbols, then the value fields.
      Chosen only when strictly smaller; wins big at LOW entropy, where
      states hug the floor and the width distribution collapses (the
      5-bit raw fields were most of the remaining framing cost there).

    Returns ``(bits uint8[nbits], nbits)``.
    """
    S, W = cfg.state_bits, cfg.word_bits
    L = cfg.num_lanes
    wmin = S - W + 1
    wb = _wbits(cfg)
    x = np.asarray(states, dtype=np.uint64).reshape(-1)
    if len(x) != L:
        raise ValueError(f"expected {L} states, got {len(x)}")
    w = _bit_length_u64(x)
    if np.any(w < wmin) or np.any(w > S):
        raise ValueError("state outside [2^(S-W), 2^S); corrupt coder state")
    wf = (w - wmin).astype(np.int64)
    vlen = w - 1  # value field lengths
    vo = np.zeros(L, dtype=np.int64)
    np.cumsum(vlen[:-1], out=vo[1:])
    vtotal = int(vo[-1] + vlen[-1]) if L else 0

    # --- try the coded-widths mode ---
    coded = None
    if L >= 64:
        from ..models.categorical import ContiguousCategoricalEntropyModel
        from .ans import AnsCoderCore

        hist = np.bincount(wf, minlength=W).astype(np.float64)
        model = (
            ContiguousCategoricalEntropyModel
            .from_floating_point_probabilities_fast(
                (hist + 1.0) / (L + W), _WP
            )
        )
        cdfq = model.cdf.astype(np.uint64)
        probs_q = (cdfq[1:] - cdfq[:-1]).astype(np.uint32)
        enc = AnsCoderCore(word_bits=32, state_bits=64)
        enc.encode_reverse_tables(
            cdfq[wf].astype(np.uint32), probs_q[wf], _WP
        )
        words = np.asarray(enc.get_compressed(), np.uint32)
        coded_bits = 16 + W * 13 + len(words) * 32
        if coded_bits < L * wb and len(words) < (1 << 16):
            coded = (words, probs_q, coded_bits)

    if coded is not None:
        words, probs_q, coded_bits = coded
        head = np.zeros(1 + coded_bits, dtype=np.uint8)
        head[0] = 1
        pos = 1
        for j in range(16):
            head[pos + j] = (len(words) >> (15 - j)) & 1
        pos += 16
        pq = probs_q.astype(np.uint64)
        for j in range(13):
            head[pos + np.arange(W) * 13 + j] = (
                (pq >> np.uint64(12 - j)) & np.uint64(1)
            ).astype(np.uint8)
        pos += W * 13
        head[pos:] = _bits_from_u32(words)
        width_block = head
        base = len(width_block)
    else:
        width_block = np.zeros(1 + L * wb, dtype=np.uint8)
        wfu = wf.astype(np.uint64)
        for j in range(wb):
            width_block[1 + np.arange(L) * wb + j] = (
                (wfu >> np.uint64(wb - 1 - j)) & np.uint64(1)
            ).astype(np.uint8)
        base = 1 + L * wb

    total = base + vtotal
    bits = np.zeros(total, dtype=np.uint8)
    bits[:base] = width_block
    # value block (ragged; <= S-1 vectorized passes)
    for j in range(int(vlen.max(initial=0))):
        m = vlen > j
        sh = (vlen[m] - 1 - j).astype(np.uint64)
        bits[base + vo[m] + j] = (
            (x[m] >> sh) & np.uint64(1)
        ).astype(np.uint8)
    return bits, total


def unpack_states(bits: np.ndarray, cfg: LaneConfig) -> np.ndarray:
    """Inverse of :func:`pack_states`; returns u64[L] states."""
    S, W = cfg.state_bits, cfg.word_bits
    L = cfg.num_lanes
    wmin = S - W + 1
    wb = _wbits(cfg)
    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) < 1:
        raise ValueError("empty packed-state section")
    if bits[0]:
        # coded widths
        from ..models.categorical import ContiguousCategoricalEntropyModel
        from .ans import AnsCoderCore

        pos = 1
        nwords = 0
        for j in range(16):
            nwords = (nwords << 1) | int(bits[pos + j])
        pos += 16
        pq = np.zeros(W, dtype=np.uint64)
        for j in range(13):
            pq = (pq << np.uint64(1)) | bits[
                pos + np.arange(W) * 13 + j
            ].astype(np.uint64)
        pos += W * 13
        if pq.sum() != (1 << _WP):
            raise ValueError("corrupt coded-widths model")
        words = _u32_from_bits(bits[pos: pos + nwords * 32])[:nwords]
        pos += nwords * 32
        model = ContiguousCategoricalEntropyModel(
            _widths_cdf_from_probs(pq).astype(np.uint32), _WP
        )
        dec = AnsCoderCore.from_compressed(
            np.asarray(words, np.uint32), word_bits=32, state_bits=64
        )
        wf = np.asarray(
            dec.decode_iid_symbols(L, model), np.int64
        )
        base = pos
    else:
        wfu = np.zeros(L, dtype=np.uint64)
        for j in range(wb):
            wfu = (wfu << np.uint64(1)) | bits[
                1 + np.arange(L) * wb + j
            ].astype(np.uint64)
        wf = wfu.astype(np.int64)
        base = 1 + L * wb
    w = wf + wmin
    if np.any(w < wmin) or np.any(w > S):
        raise ValueError("corrupt width fields in packed-state section")
    vlen = w - 1
    vo = np.zeros(L, dtype=np.int64)
    np.cumsum(vlen[:-1], out=vo[1:])
    if base + (int(vo[-1] + vlen[-1]) if L else 0) > len(bits):
        raise ValueError("packed-state section shorter than its widths")
    x = np.zeros(L, dtype=np.uint64)
    for j in range(int(vlen.max(initial=0))):
        m = vlen > j
        x[m] = (x[m] << np.uint64(1)) | bits[base + vo[m] + j].astype(
            np.uint64
        )
    # implicit leading 1
    return x | (np.uint64(1) << (vlen.astype(np.uint64)))


# ---------------------------------------------------------------------------
# Seed payload <-> bit stream
# ---------------------------------------------------------------------------


def _seeds_from_payload(payload_bits: np.ndarray, cfg: LaneConfig) -> np.ndarray:
    """(S-W)-bit MSB-first payload chunks -> seeds in [2^(S-W), 2^(S-W+1))."""
    S, W = cfg.state_bits, cfg.word_bits
    L = cfg.num_lanes
    F = S - W
    want = L * F
    if len(payload_bits) < want:
        payload_bits = np.concatenate(
            [payload_bits, np.zeros(want - len(payload_bits), np.uint8)]
        )
    chunk = payload_bits[:want].reshape(L, F).astype(np.uint64)
    r = np.zeros(L, dtype=np.uint64)
    for j in range(F):
        r = (r << np.uint64(1)) | chunk[:, j]
    return r | (np.uint64(1) << np.uint64(F))


def _payload_from_seeds(fin_states: np.ndarray, cfg: LaneConfig) -> np.ndarray:
    """Recover the payload bits from the decoder's final lane states."""
    S, W = cfg.state_bits, cfg.word_bits
    L = cfg.num_lanes
    F = S - W
    x = np.asarray(fin_states, dtype=np.uint64).reshape(-1)
    if len(x) != L:
        raise ValueError(f"expected {L} final states, got {len(x)}")
    if np.any(x >> np.uint64(F) != 1):
        raise ValueError(
            "final decoder states did not return to the seed band "
            "[2^(S-W), 2^(S-W+1)); the stream is inconsistent with the model"
        )
    out = np.empty((L, F), dtype=np.uint8)
    for j in range(F):
        out[:, j] = ((x >> np.uint64(F - 1 - j)) & np.uint64(1)).astype(
            np.uint8
        )
    return out.reshape(-1)


def _stream_to_bits(stream: np.ndarray, W: int) -> np.ndarray:
    """W-bit stream words -> MSB-first bit stream (W bits per word)."""
    s = np.asarray(stream, dtype=np.uint64).reshape(-1)
    out = np.empty((len(s), W), dtype=np.uint8)
    for j in range(W):
        out[:, j] = ((s >> np.uint64(W - 1 - j)) & np.uint64(1)).astype(
            np.uint8
        )
    return out.reshape(-1)


def _bits_to_stream(bits: np.ndarray, W: int, nwords: int) -> np.ndarray:
    """Inverse of :func:`_stream_to_bits`."""
    chunk = np.asarray(bits[: nwords * W], dtype=np.uint64).reshape(nwords, W)
    s = np.zeros(nwords, dtype=np.uint64)
    for j in range(W):
        s = (s << np.uint64(1)) | chunk[:, j]
    return s.astype(np.uint32)


# ---------------------------------------------------------------------------
# Container v2 encode / decode
# ---------------------------------------------------------------------------


def _pick_lb(L_A: int) -> int:
    """Region-B lane count: small enough that B's own floor cost is noise
    relative to A's seed capacity (B is a short tail, decoded on the host)."""
    return max(8, min(1024, L_A // 64))


def _pack_stream_words(stream: np.ndarray, W: int) -> np.ndarray:
    """W-bit stream words -> u32 payload (shared impl, interleaved2)."""
    return il2.pack_words(stream, W)


def _unpack_stream_words(payload: np.ndarray, W: int, n: int) -> np.ndarray:
    return il2.unpack_words(payload, W, n)


def encode_iid_v2(
    symbols: np.ndarray, cdf: np.ndarray, cfg: LaneConfig,
    device: bool = False, sym_bits: np.ndarray | None = None,
) -> np.ndarray:
    """Encode i.i.d. categorical symbols into a compact v2 container.

    The wire coding is the ordinary ILANS2 shared-stream rANS (device or
    host encoder); only the FRAMING differs from
    :func:`interleaved2.encode_iid_categorical2`: region split, seeded
    region-A encode, variable-width state packing.  Decode with
    :func:`decode_iid_v2` (or the auto-dispatching facade).

    ``sym_bits`` (optional, f64[n]) is each symbol's ideal code length in
    bits; callers that already computed it (the facade's lane sizing)
    pass it to skip a redundant O(n) log2 pass.
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    cums = cdf64[symbols]
    probs = cdf64[symbols + 1] - cums

    def encode_a(n_A, seeds):
        return _encode_region_a(
            symbols[:n_A], cums[:n_A], probs[:n_A], cdf, cfg, seeds, device
        )

    return frame_planes_v2(cums, probs, cfg, sym_bits, encode_a)


def frame_planes_v2(cums, probs, cfg: LaneConfig,
                    sym_bits: np.ndarray | None,
                    encode_a) -> np.ndarray:
    """Model-agnostic v2 framing over per-symbol (cum, prob) planes.

    Region split, region-B encode (host shared-stream coder on the
    planes), seed-payload packing, and the header layout are identical
    for every model family; the caller supplies ``encode_a(n_A, seeds)``
    -> ``(states_A, stream_A)`` -- the seeded region-A encoder (which may
    be the device encoder)."""
    n = len(cums)
    L = cfg.num_lanes
    S, W, P = cfg.state_bits, cfg.word_bits, cfg.precision

    C_bits = L * (S - W)  # seed payload capacity
    if sym_bits is not None:
        bits_per_sym = np.asarray(sym_bits, np.float64).reshape(-1)
    else:
        bits_per_sym = P - np.log2(np.asarray(probs, np.float64))
    tail_cum = np.cumsum(bits_per_sym[::-1])
    L_B = _pick_lb(L)
    # B carries its own framing floor (L_B*(S-W+1) state bits it cannot
    # recover) -- only split when the message is long enough that the
    # recovered A-floor dwarfs it
    k_B = 0
    if n >= 4 * L and tail_cum[-1] > 2.0 * C_bits:
        # B's packed states land near L_B*(wbits + S - W/2 - 1) bits for
        # log-uniform states; fill the rest of the capacity with B's stream
        psb_est = L_B * (_wbits(cfg) + S - W // 2 - 1)
        target = max(C_bits - psb_est - L_B * W // 2, 0.0)
        k_B = int(np.searchsorted(tail_cum, target))
        k_B = min(k_B, n // 2)

    states_B = np.zeros(0, np.uint64)
    stream_B = np.zeros(0, np.uint32)
    psb_bits_arr = np.zeros(0, np.uint8)
    cfg_B = LaneConfig(num_lanes=L_B, word_bits=W, state_bits=S, precision=P)
    refined = False
    while k_B > 0:
        states_B, stream_B = il2.encode_shared(
            cums[n - k_B:], probs[n - k_B:], cfg_B
        )
        psb_bits_arr, _ = pack_states(states_B, cfg_B)
        used = len(stream_B) * W + len(psb_bits_arr)
        if used > C_bits:
            # overshoot: shrink by the measured rate and re-encode
            k_B = int(k_B * 0.95 * C_bits / used)
            refined = True
            continue
        slack = C_bits - used
        if not refined and slack > L_B * W and k_B < n // 2:
            # large padding waste: grow k_B by the measured bits/symbol
            rate = used / max(k_B, 1)
            k_B = min(int(k_B + slack / rate * 0.9), n // 2)
            refined = True
            continue
        break
    if k_B == 0:
        # shrink loop may have collapsed the region: drop stale buffers
        states_B = np.zeros(0, np.uint64)
        stream_B = np.zeros(0, np.uint32)
        psb_bits_arr = np.zeros(0, np.uint8)

    n_A = n - k_B
    if k_B > 0:
        payload = np.zeros(C_bits, dtype=np.uint8)
        sb = _stream_to_bits(stream_B, W)
        payload[: len(sb)] = sb
        slack = C_bits - len(sb)
        psb_in_seed = min(len(psb_bits_arr), slack)
        if psb_in_seed:
            payload[len(sb): len(sb) + psb_in_seed] = (
                psb_bits_arr[:psb_in_seed]
            )
        seeds = _seeds_from_payload(payload, cfg)
        psb_rem = psb_bits_arr[psb_in_seed:]
    else:
        seeds = None
        psb_rem = np.zeros(0, np.uint8)

    states_A, stream_A = encode_a(n_A, seeds)
    stream_A = np.asarray(stream_A)
    psa_bits_arr, psa_bits = pack_states(np.asarray(states_A), cfg)

    for fname, fval in (
        ("stream_A length", len(stream_A)), ("k_B", k_B),
        ("stream_B length", len(stream_B)), ("psa_bits", psa_bits),
        ("psb_bits", len(psb_bits_arr)),
    ):
        if fval >> 32:
            # num_symbols has a two-word field, but the section-length
            # fields are single u32 words; split absurdly long messages
            # into blocks (parallel.encode) instead of overflowing here
            raise ValueError(
                f"v2 container field {fname} = {fval} exceeds the u32 "
                "header field; split the message (parallel.encode)"
            )
    header = np.array(
        [
            MAGIC2, 2,
            W | (P << 8) | (S << 16),
            n & 0xFFFFFFFF, (n >> 32) & 0xFFFFFFFF,
            L, len(stream_A),
            k_B, L_B if k_B else 0, len(stream_B),
            psa_bits, len(psb_bits_arr),
        ],
        dtype=np.uint32,
    )
    return np.concatenate([
        header,
        _u32_from_bits(psa_bits_arr),
        _u32_from_bits(psb_rem) if len(psb_rem) else np.zeros(0, np.uint32),
        _pack_stream_words(stream_A, W),
    ])


def _encode_region_a(symbols, cums, probs, cdf, cfg, seeds, device):
    """Region-A encode: seeded host encoder, or the device encoder
    (ops/device_coder.py) when requested and supported."""
    from . import device_coder

    if device and device_coder.supports(cfg):
        return device_coder.encode(symbols, cdf, cfg, seeds=seeds)
    return il2.encode_shared(cums, probs, cfg, seeds=seeds)


class _ParsedV2:
    """Parsed v2 container: header fields plus the unpacked region-A
    coder state and the shipped part of region B's packed states."""

    __slots__ = (
        "cfg", "n", "n_A", "k_B", "L_B", "slen_B", "psb_in_seed",
        "psb_rem", "states_A", "stream_A",
    )


def parse_v2(data: np.ndarray) -> _ParsedV2:
    """Parse a v2 container into its regions (no decoding); validates the
    header's internal consistency so corrupt or truncated containers fail
    here with a clear error instead of driving the decoder off a cliff."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 12:
        raise ValueError("truncated v2 ILANS2 container header")
    if int(data[0]) != MAGIC2 or int(data[1]) != 2:
        raise ValueError("not a v2 ILANS2 container")
    flags = int(data[2])
    W = flags & 0xFF
    P = (flags >> 8) & 0xFF
    S = (flags >> 16) & 0xFF
    if W not in (8, 16, 32) or not 0 < P <= 24 or S not in (32, 64):
        raise ValueError("invalid (W, P, S) in v2 container header")
    p = _ParsedV2()
    p.n = int(data[3]) | (int(data[4]) << 32)
    L = int(data[5])
    slen_A = int(data[6])
    p.k_B = int(data[7])
    p.L_B = int(data[8])
    p.slen_B = int(data[9])
    psa_bits = int(data[10])
    psb_bits = int(data[11])
    if L <= 0 or (p.k_B and p.L_B <= 0):
        raise ValueError("invalid lane counts in v2 container header")
    # the packed-state section's bit length pins the lane count: every
    # lane stores a width field plus (w-1) in [S-W, S-1] mantissa bits --
    # without this, a scrambled L word passes the total-length check (v2
    # has no L-sized raw section) and the unpacker allocates L-sized
    # buffers for an absurd L
    wb_chk = (W - 1).bit_length()
    # lower bound: flag + mantissa floor (coded widths can be near-free);
    # upper: flag + raw widths + max mantissas (coded is only chosen when
    # strictly smaller than raw)
    if not (1 + L * (S - W) <= psa_bits <= 1 + L * (wb_chk + S - 1)):
        raise ValueError(
            "packed-state length inconsistent with the lane count "
            "(corrupt v2 container header)"
        )
    if p.k_B and not (
        1 + p.L_B * (S - W) <= psb_bits <= 1 + p.L_B * (wb_chk + S - 1)
    ):
        raise ValueError(
            "region-B packed-state length inconsistent with its lane "
            "count (corrupt v2 container header)"
        )
    p.cfg = LaneConfig(num_lanes=L, word_bits=W, state_bits=S, precision=P)
    p.n_A = p.n - p.k_B
    if p.n_A < 0 or p.k_B < 0:
        raise ValueError("inconsistent symbol counts in v2 header")
    # total-length consistency (the v1 unpackers' `expected` check): every
    # section length is implied by the header, so a corrupt length field
    # or a truncation fails HERE
    C_bits_chk = L * (S - W)
    sb_bits_chk = p.slen_B * W
    psb_in_seed_chk = (
        min(psb_bits, max(C_bits_chk - sb_bits_chk, 0)) if p.k_B else 0
    )
    rem_bits_chk = psb_bits - psb_in_seed_chk
    per = 32 // W
    expected = (
        12 + -(-psa_bits // 32) + -(-rem_bits_chk // 32)
        + -(-slen_A // per)
    )
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized v2 container: {len(data)} u32 words, "
            f"header describes {expected}"
        )
    # a consistent container cannot declare more symbols than its stream
    # plus state content can possibly carry (leaky models cost >= 2^-P
    # bits/symbol); rejects absurd counts from scrambled headers
    cap_bits = (slen_A + p.slen_B) * W + L * S + p.L_B * S + psb_bits
    if p.n > (cap_bits << P) + (1 << P):
        raise ValueError("symbol count inconsistent with container size")

    off = 12
    psa_words = -(-psa_bits // 32)
    psa = _bits_from_u32(data[off: off + psa_words])[:psa_bits]
    off += psa_words
    C_bits = L * (S - W)
    sb_bits = p.slen_B * W
    if p.k_B and sb_bits > C_bits:
        raise ValueError(
            "v2 container header: region-B stream exceeds the seed "
            "capacity (corrupt header)"
        )
    p.psb_in_seed = min(psb_bits, C_bits - sb_bits) if p.k_B else 0
    rem_bits = psb_bits - p.psb_in_seed
    rem_words = -(-rem_bits // 32)
    p.psb_rem = _bits_from_u32(data[off: off + rem_words])[:rem_bits]
    off += rem_words
    p.stream_A = _unpack_stream_words(data[off:], W, slen_A)

    from .interleaved import _state_dtype

    p.states_A = unpack_states(psa, p.cfg).astype(_state_dtype(p.cfg))
    return p


def _decode_region_b(p: _ParsedV2, fin_states, cdf) -> np.ndarray:
    """Recover region B from region A's final lane states and decode it."""
    W, S, P = p.cfg.word_bits, p.cfg.state_bits, p.cfg.precision
    payload = _payload_from_seeds(fin_states, p.cfg)
    stream_B = _bits_to_stream(payload, W, p.slen_B)
    sb_bits = p.slen_B * W
    psb = np.concatenate([
        payload[sb_bits: sb_bits + p.psb_in_seed], p.psb_rem
    ])
    cfg_B = LaneConfig(
        num_lanes=p.L_B, word_bits=W, state_bits=S, precision=P
    )
    from .interleaved import _state_dtype

    states_B = unpack_states(psb, cfg_B).astype(_state_dtype(cfg_B))
    return il2.decode_shared_cdf(states_B, stream_B, p.k_B, cdf, cfg_B)


def decode_iid_v2(
    data: np.ndarray, cdf: np.ndarray, device: bool = False
) -> np.ndarray:
    """Decode a v2 container (twin of :func:`encode_iid_v2`)."""
    p = parse_v2(data)
    if p.n_A > 0:
        out_A, fin = _decode_region_a(
            p.states_A, p.stream_A, p.n_A, cdf, p.cfg, device
        )
        out_A = np.asarray(out_A)
    else:
        out_A, fin = np.zeros(0, np.int32), p.states_A

    if p.k_B == 0:
        return out_A
    return np.concatenate([out_A, _decode_region_b(p, fin, cdf)])


def build_checkpoints_v2(data, cdf, interval: int):
    """Periodic decoder snapshots over a v2 container's region A (region B
    is a short tail decoded from recovered seeds; seeks land in A)."""
    p = parse_v2(data)
    return il2.build_checkpoints(
        p.states_A, p.stream_A, p.n_A, cdf, p.cfg, interval
    )


def decode_from_checkpoint_v2(
    data, cdf, interval: int, ckpt_index: int, offsets, states,
    device: bool = False,
):
    """Decode a v2 container's suffix from checkpoint ``ckpt_index``
    (symbol ``(ckpt_index+1) * interval * L``); the recovered-seed tail
    (region B) is decoded and appended, so the suffix always runs to the
    true end of the message.  Bit-exact with the corresponding slice of
    :func:`decode_iid_v2`."""
    p = parse_v2(data)
    L = p.cfg.num_lanes
    start = (ckpt_index + 1) * interval * L
    remaining = p.n_A - start
    if remaining <= 0:
        raise ValueError(
            f"checkpoint {ckpt_index} starts at symbol {start}, beyond "
            f"region A ({p.n_A} symbols); decode the tail with decode_iid_v2"
        )
    sub_stream = p.stream_A[int(offsets[ckpt_index]):]
    out_A, fin = _decode_region_a(
        np.asarray(states[ckpt_index]), sub_stream, remaining, cdf, p.cfg,
        device,
    )
    out_A = np.asarray(out_A)
    if p.k_B == 0:
        return start, out_A
    return start, np.concatenate([out_A, _decode_region_b(p, fin, cdf)])


def _decode_region_a(states, stream, n, cdf, cfg, device):
    """Decode region A returning (symbols, final lane states)."""
    from . import device_coder

    if device and device_coder.supports(cfg):
        return device_coder.decode(
            states, stream, n, cdf, cfg, return_final_states=True
        )
    return il2.decode_shared_cdf(
        states, stream, n, cdf, cfg, return_final_states=True
    )


def container_version(data: np.ndarray) -> int:
    """Version of an ILANS2 container (1 or 2)."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 2 or int(data[0]) != MAGIC2:
        raise ValueError("not an ILANS2 container")
    return int(data[1])


def peek_cfg(data: np.ndarray) -> LaneConfig:
    """LaneConfig from a container header (either version), no payload
    parsing."""
    data = np.asarray(data, dtype=np.uint32)
    if len(data) < 6 or int(data[0]) != MAGIC2:
        raise ValueError("not an ILANS2 container")
    flags = int(data[2])
    return LaneConfig(
        num_lanes=int(data[5]), word_bits=flags & 0xFF,
        state_bits=(flags >> 16) & 0xFF, precision=(flags >> 8) & 0xFF,
    )
