"""Public facade for the device paths.

The `constriction_tpu.stream.*` / `symbol.*` modules mirror the reference's
host API; this module is the discoverable entry point for what runs on the
accelerator.  All functions accept / return numpy or JAX arrays.  The
device coder runs the GPU kernels on an NVIDIA GPU and the plain-XLA coder
on the CPU (ops/route.py); other platforms are an error.

    import constriction_tpu.tpu as ctpu

    data = ctpu.encode_iid(symbols, cdf)           # ILANS2 container (u32)
    out  = ctpu.decode_iid(data, cdf)

(The module keeps its historical name; it is public API.)
"""

from __future__ import annotations

import numpy as np

from .ops import framing as _framing
from .ops import interleaved2 as _il2
from .ops import chain_jax as _cj
from .ops.interleaved import LaneConfig

DEFAULT_CFG = LaneConfig(num_lanes=32768, word_bits=16, state_bits=32, precision=12)
SMALL_CFG = LaneConfig(num_lanes=1024, word_bits=16, state_bits=32, precision=12)
# The reference's DEFAULT preset sizes on device: 32-bit words, 64-bit lane
# states, precision 24 (stack.rs:139).  The facade picks it for P > 16
# models; pass as ``cfg=`` to force it.
DEFAULT64_CFG = LaneConfig(num_lanes=32768, word_bits=32, state_bits=64, precision=24)


def _pick_cfg(n: int, cfg: LaneConfig | None,
              cdf=None, est_bits: float | None = None) -> LaneConfig:
    if cfg is not None:
        return cfg
    # lane count should not dwarf the message (the per-lane state header is
    # the only fixed overhead)
    L = 128
    while L * 2 <= min(DEFAULT_CFG.num_lanes, max(n // 8, 128)):
        L *= 2
    if est_bits is not None and est_bits > 0:
        # entropy-aware cap (v2 framing): keep the seed capacity
        # L * (S - W) under ~1/4 of the message's information.  The v2
        # residual framing cost is ~5 bits/lane (measured; the seed words
        # themselves are recovered as payload), so capacity <= info/4
        # bounds the total overhead near 5 / (4 * 32) ~ 4% while keeping
        # lane parallelism -- and stays far from the degenerate regime
        # where seed capacity rivals the payload (capacity ~ info measures
        # ~90% overhead: the pooled tail can no longer absorb the seeds).
        # Matters at low entropy, where n/8 lanes would dwarf the payload:
        # at 16.7M symbols and 0.147 bits/symbol this rule picks L=16384
        # for ~3.3% overhead (a rate figure, from the format alone).
        cap = 128
        while cap * 2 <= min(L, max(int(est_bits) // 32 // 4, 128)):
            cap *= 2
        L = cap
    # The model's fixed-point CDF determines the precision; the facade only
    # picks matching (W, S) sizes: P <= 16 rides the u32-state coder,
    # 16 < P <= 24 (including the reference's DEFAULT preset, P = 24,
    # stack.rs:139) the u64-state coder.
    P = 12
    if cdf is not None:
        top = int(np.asarray(cdf)[-1])
        if top & (top - 1) or not (1 << 2) <= top <= (1 << 24):
            raise ValueError(
                f"cdf[-1] == {top} is not a supported power of two "
                "(2^2 .. 2^24); rebuild the model with a fixed-point "
                "precision in that range"
            )
        P = top.bit_length() - 1
    if P <= 16:
        return LaneConfig(num_lanes=L, word_bits=16, state_bits=32,
                          precision=P)
    return LaneConfig(num_lanes=L, word_bits=32, state_bits=64, precision=P)


def _check_cdf(cdf, cfg: LaneConfig) -> None:
    """The device preset is precision-12 by default while the host preset is
    precision-24; a mismatched CDF would silently produce a corrupt
    container, so validate the fixed-point contract at the facade."""
    top = int(np.asarray(cdf)[-1])
    if top != 1 << cfg.precision:
        raise ValueError(
            f"cdf[-1] == {top} but the lane config uses precision "
            f"{cfg.precision} (expected {1 << cfg.precision}); rebuild the "
            f"model with precision={cfg.precision} or pass a matching "
            f"LaneConfig"
        )


def encode_iid(symbols, cdf, cfg: LaneConfig | None = None,
               alphabet=None, compact: bool = True) -> np.ndarray:
    """Encode i.i.d. categorical symbols into a self-describing ILANS2
    container (u32 array) using the device encoder.

    ``alphabet`` (optional, sorted-unique array) enables NON-CONTIGUOUS
    symbol alphabets (reference: non_contiguous.rs): symbols are mapped to
    their alphabet indices on the host (vectorized searchsorted), the
    device codes indices against ``cdf`` (one entry per alphabet slot).

    ``compact=True`` (default) emits the v2 framing (ops/framing.py):
    variable-width packed lane states plus the recovered-seed payload,
    bringing whole-message overhead to ~0.1-0.5% of the information
    content (the reference-framing rate ballpark) instead of v1's raw
    L*S-bit state header.  :func:`decode_iid` handles both versions.
    """
    symbols = np.asarray(symbols, dtype=np.int64)
    if alphabet is not None:
        alphabet = np.asarray(alphabet)
        idx = np.searchsorted(alphabet, symbols)
        bad_mask = (idx >= len(alphabet)) | (
            alphabet[np.minimum(idx, len(alphabet) - 1)] != symbols
        )
        if np.any(bad_mask):
            raise ValueError(
                f"symbol {int(symbols[bad_mask][0])} not in the alphabet"
            )
        symbols = idx.astype(np.int64)
    elif len(symbols) and (
        int(symbols.min()) < 0 or int(symbols.max()) >= len(cdf) - 1
    ):
        # out-of-range symbols would index the CDF out of bounds and
        # silently produce a corrupt container (same altitude as _check_cdf)
        raise ValueError(
            f"symbols must be in [0, {len(cdf) - 1}), got range "
            f"[{int(symbols.min())}, {int(symbols.max())}]"
        )
    est_bits = None
    sym_bits = None
    if cfg is None and len(symbols):
        cdf64 = np.asarray(cdf, dtype=np.float64)
        p = (cdf64[symbols + 1] - cdf64[symbols]) / cdf64[-1]
        sym_bits = -np.log2(p)
        est_bits = float(sym_bits.sum())
    cfg = _pick_cfg(len(symbols), cfg, cdf, est_bits=est_bits)
    _check_cdf(cdf, cfg)
    if compact:
        return _framing.encode_iid_v2(
            symbols, cdf, cfg, device=True, sym_bits=sym_bits
        )
    return _il2.encode_iid_categorical2(symbols, cdf, cfg, device=True)


def decode_iid(container, cdf, alphabet=None) -> np.ndarray:
    """Decode an ILANS2 container (either framing version) with the device
    decoder; with ``alphabet``, decoded indices map back to the
    non-contiguous symbols."""
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        out = _framing.decode_iid_v2(container, cdf, device=True)
    else:
        out = _il2.decode_iid_categorical2(container, cdf, device=True)
    if alphabet is not None:
        out = np.asarray(alphabet)[out]
    return out


def build_checkpoints(container, cdf, interval: int):
    """Periodic decoder snapshots for an ILANS2 container (either framing
    version; random access, see :func:`decode_from_checkpoint`).  Returns
    ``(offsets, states)``."""
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        return _framing.build_checkpoints_v2(container, cdf, interval)
    init_states, stream, n, cfg = _il2.unpack_container2(container)
    return _il2.build_checkpoints(init_states, stream, n, cdf, cfg, interval)


def decode_from_checkpoint(container, cdf, interval: int, ckpt_index: int,
                           offsets, states):
    """Decode an ILANS2 container's suffix starting at checkpoint
    ``ckpt_index`` (symbol ``(ckpt_index+1) * interval * num_lanes``)
    without touching the prefix; bit-exact with the full decode's tail.
    Returns ``(start_symbol, suffix)``."""
    container = np.asarray(container)
    _check_cdf(cdf, _framing.peek_cfg(container))
    if _framing.container_version(container) == 2:
        return _framing.decode_from_checkpoint_v2(
            container, cdf, interval, ckpt_index, offsets, states,
            device=True,
        )
    init_states, stream, n, cfg = _il2.unpack_container2(container)
    return _il2.decode_from_checkpoint(
        ckpt_index, offsets, states, stream, n, cdf, cfg, interval,
        device=True,
    )


def decode_chain_iid(data, num_symbols: int, cdf):
    """Fully-parallel chain-coder decode (host chain format, default
    preset); see ops/chain_jax.py."""
    return _cj.chain_decode_iid(np.asarray(data), num_symbols, cdf)


def decode_chain_rows(data, rows):
    """Chain decode with a different categorical model per symbol."""
    return _cj.chain_decode_rows(np.asarray(data), rows)
