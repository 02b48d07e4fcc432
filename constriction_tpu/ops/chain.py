"""Exact scalar chain coder (bits-back), bit-exact with the reference.

The chain coder (/root/reference/src/stream/chain.rs) keeps two word streams:
``compressed`` (read by the decoder, written by the encoder) and
``remainders`` (written by the decoder, read by the encoder), plus two heads
(chain.rs:230-258):

- ``compressed`` head: a nonzero Word whose bits above the sentinel 1-bit are
  leftover bits from previous reads (at most W-1 of them);
- ``remainders`` head: a State with
  ``2**(S - W - P) <= head < 2**(S - P)``.

Decoding pulls exactly P bits per symbol from the compressed stream
(chain.rs:1060-1101) and pushes leftover information into the remainders head
(chain.rs:1112-1119); encoding is the exact inverse (chain.rs:1140-1206).
Because each symbol consumes a fixed P bits, changing the entropy model of one
symbol only affects that symbol ("symbol-local" decoding, chain.rs:1-84) --
which also makes this the most parallel-friendly of the stream codes
(static per-symbol bit offsets; see ops.interleaved).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..models.base import EntropyModel, ModelFamily
from .ans import _dtype_for


from .ans import FractionalNumberOfWords  # noqa: E402


class OutOfCompressedData(ValueError, AssertionError):
    # the reference maps this to AssertionError (chain.rs:535); ValueError
    # kept for backward compatibility
    pass


class OutOfRemainders(ValueError, AssertionError):
    # reference: AssertionError (chain.rs:525)
    pass


class ChainCoderCore:
    def __init__(self, word_bits: int = 32, state_bits: int = 64, precision: int = 24):
        assert precision <= word_bits and state_bits >= word_bits + precision
        self.W = word_bits
        self.S = state_bits
        self.P = precision
        self.word_mask = (1 << word_bits) - 1
        from ..backends import WordBuffer

        # pluggable word buffers (growable by default; pass fixed-capacity
        # WordBuffers via with_backends for preallocated encoding)
        self.compressed = WordBuffer()  # written by encoder, popped by decoder
        self.remainders = WordBuffer()  # written by decoder, popped by encoder
        self.head_compressed = 1
        self.head_remainders = 0

    # -- constructors (chain.rs:269-303, 326-377, 430-470) ----------------------

    @classmethod
    def with_backends(
        cls, compressed_backend=None, remainders_backend=None,
        word_bits: int = 32, state_bits: int = 64, precision: int = 24,
    ) -> "ChainCoderCore":
        """Fresh coder with caller-provided word buffers (fixed-capacity
        WordBuffers for preallocated encode, CallbackSinks, ...)."""
        self = cls(word_bits, state_bits, precision)
        if compressed_backend is not None:
            self.compressed = compressed_backend
        if remainders_backend is not None:
            self.remainders = remainders_backend
        return self

    @classmethod
    def _init_heads(cls, self: "ChainCoderCore", source, push_one: bool) -> None:
        threshold = 1 << (self.S - self.W - self.P)
        if push_one:
            rem = 1
        else:
            if not source or source[len(source) - 1] == 0:
                raise ValueError("Too little data provided, or data ends in zero word.")
            rem = source.pop()
        while rem < threshold:
            if not source:
                raise ValueError("Too little data provided.")
            rem = (rem << self.W) | source.pop()
        self.head_compressed = 1
        self.head_remainders = rem

    @classmethod
    def from_binary(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        from ..backends import WordBuffer

        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        cls._init_heads(self, src, push_one=True)
        self.compressed = src
        return self

    @classmethod
    def from_compressed(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        from ..backends import WordBuffer

        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        cls._init_heads(self, src, push_one=False)
        self.compressed = src
        return self

    @classmethod
    def from_remainders(
        cls, data: Sequence[int], word_bits: int = 32, state_bits: int = 64, precision: int = 24
    ) -> "ChainCoderCore":
        from ..backends import WordBuffer

        self = cls(word_bits, state_bits, precision)
        src = WordBuffer(np.asarray(data, dtype=np.uint64))
        if not src or src[len(src) - 1] == 0:
            raise ValueError("Too little data provided, or data ends in zero word.")
        compressed_head = src.pop()
        cls._init_heads(self, src, push_one=False)
        self.head_compressed = compressed_head
        self.remainders = src
        return self

    def clone(self) -> "ChainCoderCore":
        from ..backends import WordBuffer

        out = ChainCoderCore(self.W, self.S, self.P)
        out.compressed = (self.compressed.copy()
                          if isinstance(self.compressed, WordBuffer)
                          else list(self.compressed))
        out.remainders = (self.remainders.copy()
                          if isinstance(self.remainders, WordBuffer)
                          else list(self.remainders))
        out.head_compressed = self.head_compressed
        out.head_remainders = self.head_remainders
        return out

    # -- exporters (chain.rs:406-546) ---------------------------------------------

    def is_whole(self) -> bool:
        return self.head_compressed == 1

    def into_remainders(self) -> Tuple[np.ndarray, np.ndarray]:
        """(compressed_prefix, remainders_suffix); chain.rs:406-420."""
        remainders = list(self.remainders)
        rem = self.head_remainders
        while rem != 0:
            remainders.append(rem & self.word_mask)
            rem >>= self.W
        remainders.append(self.head_compressed)
        dt = _dtype_for(self.W)
        return np.asarray(self.compressed, dtype=dt), np.array(remainders, dtype=dt)

    def into_compressed(self) -> Tuple[np.ndarray, np.ndarray]:
        """(remainders_prefix, compressed_suffix); chain.rs:487-516."""
        if not self.is_whole():
            raise FractionalNumberOfWords(
                "Fractional number of words in compressed or remainders data."
            )
        compressed = list(self.compressed)
        rem = self.head_remainders
        while rem != 0:
            compressed.append(rem & self.word_mask)
            rem >>= self.W
        dt = _dtype_for(self.W)
        return np.asarray(self.remainders, dtype=dt), np.array(compressed, dtype=dt)

    def into_binary(self) -> Tuple[np.ndarray, np.ndarray]:
        """Like into_compressed but drops the virtual seal bit (chain.rs:516-546)."""
        rem_sig = self.head_remainders.bit_length() - 1
        if not self.is_whole() or rem_sig < 0 or rem_sig % self.W != 0:
            raise FractionalNumberOfWords(
                "Fractional number of words in compressed or remainders data."
            )
        compressed = list(self.compressed)
        rem = self.head_remainders
        while rem > 1:
            compressed.append(rem & self.word_mask)
            rem >>= self.W
        dt = _dtype_for(self.W)
        return np.asarray(self.remainders, dtype=dt), np.array(compressed, dtype=dt)

    # -- coding (chain.rs:1044-1206) --------------------------------------------------

    def decode_symbol(self, model: EntropyModel) -> int:
        W, P = self.W, self.P
        if P == W or self.head_compressed < (1 << P):
            if not self.compressed:
                raise OutOfCompressedData("out of compressed data")
            word = self.compressed.pop()
            if P != W:
                self.head_compressed = (
                    (self.head_compressed << (W - P)) | (word >> P)
                ) & self.word_mask
        else:
            word = self.head_compressed
            self.head_compressed >>= P

        quantile = word if P == W else word & ((1 << P) - 1)
        symbol, cum, prob = model.qf(quantile)
        remainder = quantile - cum
        self.head_remainders = self.head_remainders * prob + remainder
        if self.head_remainders >= 1 << (self.S - P):
            self.remainders.append(self.head_remainders & self.word_mask)
            self.head_remainders >>= W
        return symbol

    def encode_symbol(self, symbol: int, model: EntropyModel) -> None:
        cum, prob = model.ecp(int(symbol))
        self._encode_cp(cum, prob)

    def _encode_cp(self, cum: int, prob: int) -> None:
        W, P = self.W, self.P
        if self.head_remainders < (prob << (self.S - W - P)):
            if not self.remainders:
                raise OutOfRemainders("out of remainders data")
            self.head_remainders = (self.head_remainders << W) | self.remainders.pop()

        remainder = self.head_remainders % prob
        quantile = cum + remainder
        self.head_remainders //= prob

        if P != W and self.head_compressed < (1 << (W - P)):
            self.head_compressed = (self.head_compressed << P) | quantile
        else:
            if P == W:
                word = quantile
            else:
                word = ((self.head_compressed << P) | quantile) & self.word_mask
                self.head_compressed >>= W - P
            self.compressed.append(word)

    # -- batched ----------------------------------------------------------------------

    def decode_iid_symbols(self, amt: int, model: EntropyModel) -> np.ndarray:
        out = self._native_decode_iid(amt, model)
        if out is not None:
            return out
        out = np.empty(amt, dtype=np.int64)
        for i in range(amt):
            out[i] = self.decode_symbol(model)
        return out

    def _native_decode_iid(self, amt: int, model: EntropyModel):
        if amt < 64 or self.W > 32 or self.S > 64 or model.precision != self.P:
            return None
        from .. import native

        if native.LIB is None:
            return None
        import ctypes

        cdf = getattr(model, "cdf", None)
        lookup = getattr(model, "lookup", None)
        if lookup is None and hasattr(model, "inner"):
            lookup = getattr(model.inner, "lookup", None)
            if cdf is None:
                cdf = getattr(model.inner, "cdf", None)
        if not isinstance(cdf, np.ndarray) or not isinstance(lookup, np.ndarray):
            return None
        if self.P > 16:
            return None
        from ..backends import WordBuffer

        if not (isinstance(self.compressed, WordBuffer)
                and isinstance(self.remainders, WordBuffer)):
            return None
        comp = np.ascontiguousarray(self.compressed.view(), dtype=np.uint32)
        rem = np.empty(len(self.remainders) + amt + 8, dtype=np.uint32)
        rem[: len(self.remainders)] = self.remainders.view()
        out = np.empty(amt, dtype=np.int32)
        st = native.ChainState(
            self.head_compressed, self.head_remainders, len(comp), len(self.remainders)
        )
        done = native.LIB.ctpu_chain_decode_lookup(
            ctypes.byref(st), comp, rem, len(rem),
            np.ascontiguousarray(lookup, dtype=np.uint32),
            np.ascontiguousarray(cdf, dtype=np.uint32),
            out, amt, self.W, self.S, self.P,
        )
        # adopt the partial state BEFORE raising, so the coder ends where
        # the per-symbol Python path would (native codec writes back its
        # progress up to the failing symbol)
        self.compressed.set_content(comp[: st.compressed_len])
        self.remainders.set_content(rem[: st.remainders_len])
        self.head_compressed = st.head_compressed
        self.head_remainders = st.head_remainders
        if done < amt:
            raise OutOfCompressedData("out of compressed data")
        symbols = getattr(model, "symbols", None)
        if symbols is not None:
            return np.asarray(symbols)[out].astype(np.int64)
        return out.astype(np.int64)

    def decode_symbols(self, family: ModelFamily) -> np.ndarray:
        out = np.empty(family.size, dtype=np.int64)
        for i in range(family.size):
            out[i] = self.decode_symbol(family.concrete(i))
        return out

    def encode_iid_symbols_reverse(self, symbols: Sequence[int], model: EntropyModel) -> None:
        cums, probs = model.ecp_array(np.asarray(symbols))
        self.encode_reverse_tables(cums, probs)

    def encode_reverse_tables(self, cums: np.ndarray, probs: np.ndarray) -> None:
        from ..backends import WordBuffer

        if (len(cums) >= 64 and self.W <= 32 and self.S <= 64
                and isinstance(self.compressed, WordBuffer)
                and isinstance(self.remainders, WordBuffer)):
            from .. import native

            if native.LIB is not None:
                import ctypes

                comp = np.empty(len(self.compressed) + len(cums) + 8, dtype=np.uint32)
                comp[: len(self.compressed)] = self.compressed.view()
                rem = np.ascontiguousarray(self.remainders.view(), dtype=np.uint32)
                st = native.ChainState(
                    self.head_compressed, self.head_remainders,
                    len(self.compressed), len(rem),
                )
                done = native.LIB.ctpu_chain_encode_reverse(
                    ctypes.byref(st), comp, len(comp), rem,
                    np.ascontiguousarray(cums, dtype=np.uint32),
                    np.ascontiguousarray(probs, dtype=np.uint32),
                    len(cums), self.W, self.S, self.P,
                )
                if done < len(cums):
                    raise OutOfRemainders("out of remainders data")
                self.compressed.set_content(comp[: st.compressed_len])
                self.remainders.set_content(rem[: st.remainders_len])
                self.head_compressed = st.head_compressed
                self.head_remainders = st.head_remainders
                return
        for i in range(len(cums) - 1, -1, -1):
            self._encode_cp(int(cums[i]), int(probs[i]))

    def encode_symbols_reverse(self, symbols: Sequence[int], family: ModelFamily) -> None:
        symbols = np.asarray(symbols)
        cums, probs = family.ecp_all(symbols)
        self.encode_reverse_tables(cums, probs)
