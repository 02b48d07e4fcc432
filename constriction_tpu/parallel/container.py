"""Sharded ILANS2 container: one mesh-independent format, one-call codec.

The message is padded to ``num_blocks`` equal blocks and every block is an
ordinary ILANS2 unit (shared-stream interleaved rANS,
:mod:`constriction_tpu.ops.interleaved2`).  Because the block geometry lives
in the header -- NOT in the mesh -- a container encoded on one mesh shape
decodes bit-identically on any other (1 device, 8 devices, or the host
loop), as long as the device count divides the block count; the reference's
closest analog is the Pos/Seek jump-table design
(/root/reference/src/lib.rs:425-580): per-block (stream offset, lane states)
are exactly coder snapshots.

All blocks share one static kernel shape (the message is zero-padded to
``num_blocks * block_len`` symbols; the true length is in the header), so the
whole mesh runs a single SPMD program: `shard_map` over the block axis, each
device encoding/decoding ``num_blocks / D`` blocks with the device coder
(ops/device_coder.py), followed by an in-order `all_gather` of per-block
stream lengths, states and payloads (over NVLink between the cards of one
host) so every device (and the host, with one transfer) holds the complete
container.

Container layout (u32 words):

    [0] magic 0x494C4E53 ("ILNS")   [1] version=1
    [2] word_bits | precision << 8 | state_bits << 16 | coder << 24
        (coder: 0 = rANS stack semantics, 1 = range queue semantics;
         the byte was previously implicit zero, so all existing
         containers read back as rANS)
    [3] num_symbols lo  [4] num_symbols hi
    [5] num_lanes L     [6] num_blocks B    [7] block_len (symbols)
    [8 .. 8+B)          per-block stream length (in W-bit words)
    [8+B .. 8+B+B*L)    per-block initial lane states (u32) -- rANS lane
                        states or range-decoder point headers -- for
                        state_bits <= 32; for state_bits in (32, 64] (the
                        DEFAULT preset) the states occupy [8+B .. 8+B+2BL)
                        as two u32 planes, all B*L low words then all B*L
                        high words
    [...]               per-block payloads, each u32-aligned
                        (W-bit words packed little-endian as in ILANS2)

Version 2 (``encode(..., compact=True)``, rANS only) replaces the raw
state section with per-block VARIABLE-WIDTH packed states and adds a
POOLED-TAIL seed recovery: the last ``k_tail`` symbols are encoded first
into a nested compact container (ops/framing.py) whose bits ride inside
all blocks' seed states and are recovered from the blocks' final lane
states at decode end -- the sharded analog of the single-container v2
framing, cutting the state header from B*L*S raw bits to ~4 bits/lane
net.  Layout documented at :func:`pack_sharded_v2`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops import device_coder
from ..ops import interleaved2 as il2
from ..ops import route
from ..ops.interleaved import LaneConfig

MAGIC_S = 0x494C4E53

_HDR = 8

CODER_RANS = 0
CODER_RANGE = 1
_CODER_IDS = {"rans": CODER_RANS, "range": CODER_RANGE}


# the one shared W-bit-word <-> u32 packing lives in ops/interleaved2
_pack_words = il2.pack_words
_unpack_words = il2.unpack_words


def pack_sharded(
    states: np.ndarray,  # [B, L] u32
    streams: list,  # B arrays of W-bit words (u32 elements)
    num_symbols: int,
    block_len: int,
    cfg: LaneConfig,
    coder: int = CODER_RANS,
) -> np.ndarray:
    B = len(streams)
    L = cfg.num_lanes
    header = np.array(
        [
            MAGIC_S,
            1,
            cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16)
            | (coder << 24),
            num_symbols & 0xFFFFFFFF,
            (num_symbols >> 32) & 0xFFFFFFFF,
            L,
            B,
            block_len,
        ],
        dtype=np.uint32,
    )
    lens = np.array([len(s) for s in streams], dtype=np.uint32)
    payloads = [_pack_words(s, cfg.word_bits) for s in streams]
    if cfg.state_bits > 32:
        st = np.asarray(states, dtype=np.uint64).reshape(-1)
        states_words = np.concatenate([
            (st & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            (st >> np.uint64(32)).astype(np.uint32),
        ])
    else:
        states_words = states.astype(np.uint32).reshape(-1)
    return np.concatenate([header, lens, states_words] + payloads)


def unpack_sharded(
    data: np.ndarray,
) -> Tuple[np.ndarray, list, int, int, LaneConfig, int]:
    """-> (states [B, L], streams (list of B word arrays), num_symbols,
    block_len, cfg, coder) -- ``coder`` is CODER_RANS or CODER_RANGE;
    for range containers ``states`` holds the per-block decoder point
    headers."""
    data = np.asarray(data, dtype=np.uint32)
    if int(data[0]) != MAGIC_S or int(data[1]) != 1:
        raise ValueError("not a sharded ILANS2 container")
    flags = int(data[2])
    W = flags & 0xFF
    P = (flags >> 8) & 0xFF
    S = (flags >> 16) & 0xFF
    coder = (flags >> 24) & 0xFF
    if coder not in (CODER_RANS, CODER_RANGE):
        raise ValueError(
            f"unknown coder id {coder} in container header (corrupt data, "
            "or a container from a newer format version)"
        )
    if W not in (16, 32):
        raise ValueError(f"invalid word_bits {W} in container header")
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L, B, block_len = int(data[5]), int(data[6]), int(data[7])
    cfg = LaneConfig(L, W, S, P)
    if len(data) < _HDR + B:
        raise ValueError("truncated container header")
    lens = data[_HDR : _HDR + B].astype(np.int64)
    off = _HDR + B
    per = 32 // W
    expected = (
        off
        + (2 if S > 32 else 1) * B * L
        + int(sum(-(-int(l) // per) for l in lens))
    )
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized container: {len(data)} u32 words, "
            f"header describes {expected}"
        )
    if S > 32:
        lo = data[off : off + B * L].astype(np.uint64)
        hi = data[off + B * L : off + 2 * B * L].astype(np.uint64)
        states = (lo | (hi << np.uint64(32))).reshape(B, L)
        off += 2 * B * L
    else:
        states = data[off : off + B * L].reshape(B, L)
        off += B * L
    streams = []
    for b in range(B):
        nwords = int(lens[b])
        n_u32 = -(-nwords // per)
        streams.append(_unpack_words(data[off : off + n_u32], W, nwords))
        off += n_u32
    return states, streams, num_symbols, block_len, cfg, coder


# ---------------------------------------------------------------------------
# Sharded container v2: compact framing (opt-in, rANS only).
#
# V1 ships B*L raw lane states (15% of a 16.7M-symbol message at the
# defaults).  V2 applies the single-container framing tricks
# (ops/framing.py) at the sharded level:
#   - per-block VARIABLE-WIDTH state packing (width field + mantissa sans
#     the implicit leading 1);
#   - a POOLED-TAIL seed recovery: the last k_tail symbols are encoded
#     FIRST into a nested compact v2 container (framing.encode_iid_v2,
#     its own inner seed recovery included), and that container's bits
#     ride inside ALL blocks' seed states (B*L*(S-W) bits of capacity);
#     rANS decoding returns every block's lane states to its seeds, so
#     the tail is recovered for free at decode end.  Overflow beyond the
#     capacity is shipped raw (real payload either way, never waste).
#
# Layout (u32 words):
#   [0] MAGIC_S  [1] 2
#   [2] W | P<<8 | S<<16 | CODER_RANS<<24
#   [3] n lo  [4] n hi           (TOTAL symbols, blocks + tail)
#   [5] L  [6] B  [7] block_len  (region-A block length)
#   [8] k_tail   [9] tail_words  (nested tail container length, u32)
#   [10 .. 10+B)      per-block stream lengths (W-bit words)
#   [10+B .. 10+2B)   per-block packed-state bit lengths
#   [..]              packed states, word-aligned per block
#   [..]              tail spill: ceil(max(tail_bits - cap, 0)/32) words
#   [..]              per-block stream payloads (word-aligned, as v1)
# ---------------------------------------------------------------------------

_HDR2 = 10


def pack_sharded_v2(states, streams, num_symbols, block_len, cfg,
                    k_tail, tail_cont):
    from ..ops import framing as fr

    B = len(streams)
    S, W = cfg.state_bits, cfg.word_bits
    for fname, fval in (
        ("k_tail", k_tail), ("tail_words", len(tail_cont)),
        ("block_len", block_len),
        ("max stream length", max((len(s) for s in streams), default=0)),
    ):
        if int(fval) >> 32:
            raise ValueError(
                f"v2 sharded header field {fname} = {fval} exceeds its "
                "u32 field; raise num_blocks to shorten the blocks"
            )
    header = np.array(
        [
            MAGIC_S, 2,
            cfg.word_bits | (cfg.precision << 8) | (cfg.state_bits << 16)
            | (CODER_RANS << 24),
            num_symbols & 0xFFFFFFFF, (num_symbols >> 32) & 0xFFFFFFFF,
            cfg.num_lanes, B, block_len,
            k_tail, len(tail_cont),
        ],
        dtype=np.uint32,
    )
    lens = np.array([len(s) for s in streams], dtype=np.uint32)
    psa_words, psa_bits = [], []
    for b in range(B):
        bits, nbits = fr.pack_states(np.asarray(states[b]), cfg)
        psa_words.append(fr._u32_from_bits(bits))
        psa_bits.append(nbits)
    cap = B * cfg.num_lanes * (S - W)
    tail_bits_n = len(tail_cont) * 32
    spill_bits = max(tail_bits_n - cap, 0)
    if spill_bits:
        all_bits = fr._bits_from_u32(np.asarray(tail_cont, np.uint32))
        spill = fr._u32_from_bits(all_bits[cap:])
    else:
        spill = np.zeros(0, np.uint32)
    payloads = [_pack_words(s, W) for s in streams]
    return np.concatenate(
        [header, lens, np.asarray(psa_bits, np.uint32)]
        + psa_words + [spill] + payloads
    )


def unpack_sharded_v2(data):
    """-> (states [B, L], streams, num_symbols, block_len, cfg, k_tail,
    tail_words, spill_bits_arr)."""
    from ..ops import framing as fr

    data = np.asarray(data, dtype=np.uint32)
    if len(data) < _HDR2:
        raise ValueError("truncated v2 sharded container header")
    if int(data[0]) != MAGIC_S or int(data[1]) != 2:
        raise ValueError("not a v2 sharded container")
    flags = int(data[2])
    W = flags & 0xFF
    P = (flags >> 8) & 0xFF
    S = (flags >> 16) & 0xFF
    if W not in (16, 32) or not 0 < P <= 24 or S not in (32, 64):
        raise ValueError("invalid (W, P, S) in v2 sharded header")
    num_symbols = int(data[3]) | (int(data[4]) << 32)
    L, B, block_len = int(data[5]), int(data[6]), int(data[7])
    k_tail, tail_words = int(data[8]), int(data[9])
    if L <= 0 or B <= 0 or block_len <= 0 or len(data) < _HDR2 + 2 * B:
        raise ValueError("invalid geometry in v2 sharded header")
    cfg = LaneConfig(L, W, S, P)
    lens = data[_HDR2: _HDR2 + B].astype(np.int64)
    psa_bits = data[_HDR2 + B: _HDR2 + 2 * B].astype(np.int64)
    # the packed-state bit lengths pin L (see framing.parse_v2): without
    # this a scrambled lane-count word drives L-sized allocations
    wb_chk = (W - 1).bit_length()
    if not np.all(
        (psa_bits >= 1 + L * (S - W))
        & (psa_bits <= 1 + L * (wb_chk + S - 1))
    ):
        raise ValueError(
            "packed-state lengths inconsistent with the lane count "
            "(corrupt v2 sharded header)"
        )
    cap_chk = B * L * (S - W)
    expected = (
        _HDR2 + 2 * B
        + int(sum(-(-int(pb) // 32) for pb in psa_bits))
        + -(-max(tail_words * 32 - cap_chk, 0) // 32)
        + int(sum(-(-int(l) // (32 // W)) for l in lens))
    )
    if len(data) != expected:
        raise ValueError(
            f"truncated or oversized v2 sharded container: {len(data)} "
            f"u32 words, header describes {expected}"
        )
    off = _HDR2 + 2 * B
    from ..ops.interleaved import _state_dtype

    states = np.empty((B, L), _state_dtype(cfg))
    for b in range(B):
        nw = -(-int(psa_bits[b]) // 32)
        bits = fr._bits_from_u32(data[off: off + nw])[: int(psa_bits[b])]
        states[b] = fr.unpack_states(bits, cfg)
        off += nw
    cap = B * L * (S - W)
    spill_bits = max(tail_words * 32 - cap, 0)
    nw = -(-spill_bits // 32)
    spill = fr._bits_from_u32(data[off: off + nw])[:spill_bits]
    off += nw
    per = 32 // W
    streams = []
    for b in range(B):
        nwords = int(lens[b])
        n_u32 = -(-nwords // per)
        streams.append(_unpack_words(data[off: off + n_u32], W, nwords))
        off += n_u32
    return (states, streams, num_symbols, block_len, cfg, k_tail,
            tail_words, spill)


def _sharded_v2_tail_and_seeds(symbols, cdf, cfg, B, est_bits_per_sym):
    """Choose the pooled tail, encode it as a nested compact container,
    and spread its bits over the B*L seed states.  Returns
    ``(k_tail, tail_cont, seeds [B, L] or None)``."""
    from ..ops import framing as fr

    n = len(symbols)
    L = cfg.num_lanes
    S, W = cfg.state_bits, cfg.word_bits
    cap = B * L * (S - W)
    est_total = est_bits_per_sym * n
    if n < 4 * B * L or est_total < 2.0 * cap:
        return 0, np.zeros(0, np.uint32), None
    k = int(min(max(cap * 0.98 / max(est_bits_per_sym, 1e-9), 1), n // 2))
    L_tail = 128
    while L_tail * 2 <= min(2048, max(k // 8, 128)):
        L_tail *= 2
    cfg_tail = LaneConfig(num_lanes=L_tail, word_bits=W, state_bits=S,
                          precision=cfg.precision)
    tail_cont = fr.encode_iid_v2(symbols[n - k:], cdf, cfg_tail)
    blob = fr._bits_from_u32(np.asarray(tail_cont, np.uint32))
    payload = blob[:cap]
    if len(payload) < cap:
        payload = np.concatenate(
            [payload, np.zeros(cap - len(payload), np.uint8)]
        )
    per_block = L * (S - W)
    seeds = np.stack([
        fr._seeds_from_payload(
            payload[b * per_block: (b + 1) * per_block], cfg
        )
        for b in range(B)
    ])
    return k, tail_cont, seeds


def _sharded_v2_recover_tail(fin_states, cdf, cfg, B, k_tail, tail_words,
                             spill, device):
    """Pooled payload from all blocks' final states -> nested tail
    container -> decoded tail symbols."""
    from ..ops import framing as fr

    L, S, W = cfg.num_lanes, cfg.state_bits, cfg.word_bits
    cap = B * L * (S - W)
    chunks = [
        fr._payload_from_seeds(np.asarray(fin_states[b]), cfg)
        for b in range(B)
    ]
    payload = np.concatenate(chunks)
    tail_bits_n = tail_words * 32
    blob = np.concatenate([payload[: min(cap, tail_bits_n)], spill])
    tail_cont = fr._u32_from_bits(blob[:tail_bits_n])[:tail_words]
    return fr.decode_iid_v2(tail_cont, cdf, device=device)


def _pick_device_count(B: int, mesh=None) -> int:
    import jax

    n = len(mesh.devices.reshape(-1)) if mesh is not None else len(jax.devices())
    d = min(n, B)
    while B % d:
        d -= 1
    return d


def _block_mesh(B: int, mesh=None):
    """The mesh the B blocks are spread over: the largest device count
    that divides B (None when that is one device)."""
    from .sharding import make_mesh

    D = _pick_device_count(B, mesh)
    if D == 1:
        return None
    if mesh is None or len(mesh.devices.reshape(-1)) != D:
        mesh = make_mesh(D)
    return mesh


def _use_device(device, mesh, coder_id: int) -> bool:
    """Resolve ``device=None``: the device coder on a GPU or when a mesh is
    given, the host loop otherwise.  Range containers are host-only."""
    if coder_id == CODER_RANGE:
        if device:
            raise ValueError(
                "range containers are coded on the host; the device coder "
                "covers rANS (coder='rans')"
            )
        return False
    if device is None:
        return route.on_accelerator() or mesh is not None
    return bool(device)


def encode(
    symbols,
    cdf,
    cfg: Optional[LaneConfig] = None,
    num_blocks: int = 8,
    mesh=None,
    device: Optional[bool] = None,
    coder: str = "rans",
    compact: bool = False,
) -> np.ndarray:
    """Encode ``symbols`` into a sharded container in ONE call.

    ``device=True`` (the default on a GPU or when a mesh is given) runs the
    device encoder (ops/device_coder.py) data-parallel over the mesh with an
    in-order all_gather of the per-block results; ``device=False`` runs the
    bit-identical host loop.  The container bytes do not depend on the mesh
    shape.

    ``coder`` selects the per-block stream coder: ``"rans"`` (stack
    semantics; default) or ``"range"`` (queue semantics -- each block is an
    ILANS2-R unit whose stored states are the decoder point headers,
    queue.rs:847-868).  :func:`decode` reads the choice from the header.
    Range containers are coded on the host: ``device=True`` with
    ``coder="range"`` is rejected.

    ``compact=True`` (rANS only) emits the v2 sharded framing:
    variable-width packed block states plus a pooled-tail seed recovery
    (the nested tail container rides in ALL blocks' seed states), cutting
    the per-block state header from B*L*S raw bits to ~4 bits/lane net --
    the sharded analog of the single-container v2 (ops/framing.py).
    :func:`decode` reads the version from the header.
    """
    if coder not in _CODER_IDS:
        raise ValueError(
            f"coder must be one of {sorted(_CODER_IDS)}, got {coder!r}"
        )
    if compact and coder != "rans":
        raise ValueError(
            "compact=True covers rANS containers (range coding has no "
            "seed-recovery identity; its point headers must ship raw)"
        )
    coder_id = _CODER_IDS[coder]
    device = _use_device(device, mesh, coder_id)
    if num_blocks < 1:
        raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
    symbols = np.asarray(symbols, dtype=np.int64)
    n = len(symbols)
    if cfg is None:
        from ..tpu import _pick_cfg

        # infer the precision from the model's CDF like the tpu facade
        # does (a P=24 model must route to the S=64 sizes, not fail the
        # fixed-point check below against a pinned P=12 default)
        cfg = _pick_cfg(max(n // num_blocks, 1), None, cdf)
    K = len(cdf) - 1
    if int(np.asarray(cdf)[-1]) != 1 << cfg.precision:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << cfg.precision}, got "
            f"{int(np.asarray(cdf)[-1])} (rebuild the model at this "
            "precision or pass a matching cfg)"
        )
    if n and (int(symbols.min()) < 0 or int(symbols.max()) >= K):
        raise ValueError(
            f"symbols must be in [0, {K}), got range "
            f"[{int(symbols.min())}, {int(symbols.max())}]"
        )
    B = num_blocks
    L = cfg.num_lanes
    block_len = max(-(-n // B), 1)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    # one static kernel shape for every block: pad the message with the
    # first nonzero-probability symbol (a zero-probability pad symbol would
    # silently corrupt the stream via prob=0 division)
    pad_sym = int(np.argmax(np.diff(cdf64.astype(np.int64)) > 0))

    k_tail, tail_cont, seeds = 0, np.zeros(0, np.uint32), None
    if compact:
        p_all = (cdf64[symbols + 1] - cdf64[symbols]).astype(np.float64)
        est_bps = float(
            cfg.precision - np.log2(p_all).mean()
        ) if n else 1.0
        k_tail, tail_cont, seeds = _sharded_v2_tail_and_seeds(
            symbols, cdf, cfg, B, est_bps
        )
        n_blocks_syms = n - k_tail
        block_len = max(-(-n_blocks_syms // B), 1)
    else:
        n_blocks_syms = n
    padded = np.full(B * block_len, pad_sym, dtype=np.int64)
    padded[:n_blocks_syms] = symbols[:n_blocks_syms]

    if device and device_coder.supports(cfg):
        states, streams = device_coder.encode_blocks(
            padded.reshape(B, block_len), cdf, cfg, seeds=seeds,
            mesh=_block_mesh(B, mesh),
        )
    else:
        from ..ops.interleaved import _state_dtype

        states = np.empty((B, L), _state_dtype(cfg))
        streams = []
        enc_host = (il2.encode_shared_range if coder_id == CODER_RANGE
                    else il2.encode_shared)
        for b in range(B):
            blk = padded[b * block_len : (b + 1) * block_len]
            kw = {}
            if seeds is not None and coder_id == CODER_RANS:
                kw["seeds"] = seeds[b]
            st, sw = enc_host(
                cdf64[blk], cdf64[blk + 1] - cdf64[blk], cfg, **kw
            )
            states[b] = st
            streams.append(sw)
    if compact:
        return pack_sharded_v2(
            states, streams, n, block_len, cfg, k_tail, tail_cont
        )
    return pack_sharded(states, streams, n, block_len, cfg, coder_id)


def decode(
    container,
    cdf,
    mesh=None,
    device: Optional[bool] = None,
) -> np.ndarray:
    """Decode a sharded container in ONE call; mesh-shape independent.
    The stream coder (rANS / range) and the framing version are read from
    the container header."""
    data = np.asarray(container, dtype=np.uint32)
    if len(data) >= 2 and int(data[0]) == MAGIC_S and int(data[1]) == 2:
        return _decode_v2(data, cdf, mesh, device)
    states, streams, n, block_len, cfg, coder_id = unpack_sharded(container)
    if int(np.asarray(cdf)[-1]) != 1 << cfg.precision:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << cfg.precision} (the "
            f"container's header precision), got {int(np.asarray(cdf)[-1])}"
        )
    B = len(streams)
    device = _use_device(device, mesh, coder_id)
    if device and device_coder.supports(cfg):
        out, _ = device_coder.decode_blocks(
            states, streams, block_len, cdf, cfg, mesh=_block_mesh(B, mesh)
        )
        out = out.reshape(-1)
    elif coder_id == CODER_RANGE:
        out = np.concatenate(
            [
                il2.decode_shared_range_cdf(
                    states[b], streams[b], block_len, cdf, cfg
                )
                for b in range(B)
            ]
        )
    else:
        out = np.concatenate(
            [
                il2.decode_shared_cdf(states[b], streams[b], block_len, cdf, cfg)
                for b in range(B)
            ]
        )
    return out[:n]


def _decode_v2(data, cdf, mesh=None, device=None):
    """Decode a compact (v2) sharded container: region-A blocks with final
    lane states returned, pooled-tail recovery from the seeds, concat."""
    (states, streams, n, block_len, cfg, k_tail, tail_words,
     spill) = unpack_sharded_v2(data)
    if int(np.asarray(cdf)[-1]) != 1 << cfg.precision:
        raise ValueError(
            f"cdf[-1] must equal 2**precision = {1 << cfg.precision} (the "
            f"container's header precision), got {int(np.asarray(cdf)[-1])}"
        )
    B = len(streams)
    n_A = n - k_tail
    device = _use_device(device, mesh, CODER_RANS)
    if device and device_coder.supports(cfg):
        out, fin = device_coder.decode_blocks(
            states, streams, block_len, cdf, cfg, mesh=_block_mesh(B, mesh)
        )
        out = out.reshape(-1)
    else:
        outs, fins = [], []
        for b in range(B):
            o, f = il2.decode_shared_cdf(
                states[b], streams[b], block_len, cdf, cfg,
                return_final_states=True,
            )
            outs.append(o)
            fins.append(f)
        out = np.concatenate(outs)
        fin = np.stack(fins)
    out = out[:n_A]
    if k_tail == 0:
        return out
    tail = _sharded_v2_recover_tail(
        fin, cdf, cfg, B, k_tail, tail_words, spill, device
    )
    return np.concatenate([out, tail])


# ---------------------------------------------------------------------------
# Random access inside sharded containers (reference analog: the Pos/Seek
# jump-table design, /root/reference/src/lib.rs:425-580).  Block headers
# already give block-granular seeks for free; these helpers add
# WITHIN-block checkpoints so long blocks can be entered mid-stream
# without decoding from the block start.
# ---------------------------------------------------------------------------


def build_block_checkpoints(container, cdf, interval: int):
    """Per-block decoder snapshots every ``interval`` grid steps.

    Returns ``(offsets i64[B, C], states)`` with
    ``C = ceil(T_block / interval) - 1`` (the block header itself is the
    t=0 snapshot).  For rANS containers ``states`` is one ``[B, C, L]``
    array (the lane states); for RANGE containers it is a ``(lows, rngs,
    pts)`` triple of ``[B, C, L]`` arrays -- the full mid-stream decoder
    state (reference analog queue.rs:911-928).
    """
    container = np.asarray(container, dtype=np.uint32)
    if len(container) >= 2 and int(container[1]) == 2:
        # v2: checkpoints cover the region-A blocks (the pooled tail needs
        # EVERY block's final states, i.e. a full decode, so seeks cannot
        # reach it; decode it with decode())
        (states, streams, n_tot, block_len, cfg, k_tail, _tw,
         _sp) = unpack_sharded_v2(container)
        n = n_tot - k_tail
        coder_id = CODER_RANS
    else:
        states, streams, n, block_len, cfg, coder_id = unpack_sharded(
            container
        )
    B = len(streams)
    if coder_id == CODER_RANGE:
        offs, los, rns, pts = [], [], [], []
        for b in range(B):
            nb = min(block_len, max(n - b * block_len, 0))
            o, lo, rn, pt = il2.build_checkpoints_range(
                np.asarray(states[b]), streams[b], nb, cdf, cfg, interval
            )
            offs.append(o)
            los.append(lo)
            rns.append(rn)
            pts.append(pt)
        C = max(len(o) for o in offs) if offs else 0
        off_arr = np.zeros((B, C), dtype=np.int64)
        shape = (B, C) + los[0].shape[1:]
        lo_arr = np.zeros(shape, dtype=los[0].dtype)
        rn_arr = np.zeros(shape, dtype=rns[0].dtype)
        pt_arr = np.zeros(shape, dtype=pts[0].dtype)
        for b in range(B):
            off_arr[b, : len(offs[b])] = offs[b]
            lo_arr[b, : len(offs[b])] = los[b]
            rn_arr[b, : len(offs[b])] = rns[b]
            pt_arr[b, : len(offs[b])] = pts[b]
        return off_arr, (lo_arr, rn_arr, pt_arr)
    offs, sts = [], []
    for b in range(B):
        nb = min(block_len, max(n - b * block_len, 0))
        o, s = il2.build_checkpoints(
            states[b], streams[b], nb, cdf, cfg, interval
        )
        offs.append(o)
        sts.append(s)
    C = max(len(o) for o in offs) if offs else 0
    off_arr = np.zeros((B, C), dtype=np.int64)
    st_arr = np.zeros((B, C) + sts[0].shape[1:], dtype=sts[0].dtype)
    for b in range(B):
        off_arr[b, : len(offs[b])] = offs[b]
        st_arr[b, : len(offs[b])] = sts[b]
    return off_arr, st_arr


def decode_block_from_checkpoint(
    container, cdf, interval: int, block: int, ckpt_index: int,
    offsets, states, device: bool = False,
):
    """Decode block ``block``'s suffix starting at within-block checkpoint
    ``ckpt_index`` (from :func:`build_block_checkpoints`); bit-equal to the
    corresponding slice of a full :func:`decode`.  Returns
    ``(global_start_symbol, suffix)`` -- the suffix is clipped to the
    message length for the final block.  ``states`` is the second element
    of :func:`build_block_checkpoints`'s result: a ``[B, C, L]`` array for
    rANS containers, a ``(lows, rngs, pts)`` triple for range containers."""
    container = np.asarray(container, dtype=np.uint32)
    if len(container) >= 2 and int(container[1]) == 2:
        (blk_states, streams, n_tot, block_len, cfg, k_tail, _tw,
         _sp) = unpack_sharded_v2(container)
        n = n_tot - k_tail  # seeks cover the region-A blocks (see build)
        coder_id = CODER_RANS
    else:
        blk_states, streams, n, block_len, cfg, coder_id = unpack_sharded(
            container
        )
    if not 0 <= block < len(streams):
        raise ValueError(f"block {block} out of range")
    nb = min(block_len, max(n - block * block_len, 0))
    # offsets/states are zero-padded to the max per-block count; a stale
    # index into the shorter final block would silently decode from offset
    # 0 with zero states.  Recompute the block's REAL count (same formula
    # as il2.build_checkpoints) and reject out-of-range indices.
    T_b = -(-nb // cfg.num_lanes) if nb else 0
    real_c = max(-(-T_b // interval) - 1, 0)
    if not 0 <= ckpt_index < real_c:
        raise ValueError(
            f"ckpt_index {ckpt_index} out of range for block {block}: it "
            f"has {real_c} within-block checkpoints "
            f"({nb} symbols, interval {interval})"
        )
    if coder_id == CODER_RANGE:
        lows, rngs, pts = states
        if device:
            raise ValueError("range containers are decoded on the host")
        rel_start, suffix = il2.decode_range_from_checkpoint(
            ckpt_index, offsets[block], lows[block], rngs[block],
            pts[block], streams[block], nb, cdf, cfg, interval,
        )
        return block * block_len + rel_start, suffix
    rel_start, suffix = il2.decode_from_checkpoint(
        ckpt_index, offsets[block], states[block], streams[block], nb,
        cdf, cfg, interval, device=device,
    )
    return block * block_len + rel_start, suffix
