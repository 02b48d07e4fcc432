"""Whole-message rate parity: the compact (v2) container framing.

A reference (constriction) user's file is `stream + <= 2 flush words`.  A
parallel device format keeps L independent lane states, which naively costs
L*S header bits per message.  The v2 framing (ops/framing.py) removes
almost all of it:

- lane states are stored at their exact variable widths;
- the last k_B symbols are encoded FIRST and their compressed stream
  rides inside the main region's seed states -- rANS decoding provably
  returns the lane states to the encoder's seeds, so those bits are
  recovered payload, not header.

This example encodes one message three ways and prints the byte counts:
the raw v1 container, the compact v2 container (the facade default), and
the bit-exact host AnsCoder twin of the reference's own framing.

Runs anywhere: ``python examples/compact_framing.py``.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import constriction_tpu.tpu as ctpu
from constriction_tpu.models.categorical import (
    ContiguousCategoricalEntropyModel,
)
from constriction_tpu.ops.ans import AnsCoderCore


def main() -> None:
    rng = np.random.RandomState(0)
    P = 24
    probs = rng.dirichlet(np.full(100, 2.0))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, P
    )
    cdf = model.cdf
    p = np.diff(cdf.astype(np.float64)) / (1 << P)
    n = 1 << 20
    symbols = rng.choice(100, size=n, p=p).astype(np.int64)
    info_bytes = -np.log2(p[symbols]).sum() / 8

    v2 = np.asarray(ctpu.encode_iid(symbols, cdf))           # compact default
    v1 = np.asarray(ctpu.encode_iid(symbols, cdf, compact=False))
    assert np.array_equal(ctpu.decode_iid(v2, cdf), symbols)

    ref = AnsCoderCore(word_bits=32, state_bits=64)
    cdf64 = cdf.astype(np.uint64)
    ref.encode_reverse_tables(
        cdf64[symbols].astype(np.uint32),
        (cdf64[symbols + 1] - cdf64[symbols]).astype(np.uint32), P,
    )
    ref_bytes = len(ref.get_compressed()) * 4

    print(f"message: {n} symbols, information content {info_bytes:,.0f} B")
    for name, nbytes in [
        ("reference framing (bit-exact host twin)", ref_bytes),
        ("device container v1 (raw lane states)", len(v1) * 4),
        ("device container v2 (compact, facade default)", len(v2) * 4),
    ]:
        print(
            f"  {name:44s} {nbytes:>9,} B "
            f"(+{(nbytes - info_bytes) / info_bytes * 100:6.3f}% vs bound)"
        )
    print(
        f"  v2 vs reference file size: {len(v2) * 4 / ref_bytes:.5f}x "
        "(the residual is the ~4 bits/lane ensemble entropy of "
        "independent lane states)"
    )

    # random access still works on the compact container
    offs, sts = ctpu.build_checkpoints(v2, cdf, 16)
    start, suffix = ctpu.decode_from_checkpoint(v2, cdf, 16, len(offs) // 2,
                                                offs, sts)
    assert np.array_equal(suffix, symbols[start:])
    print(f"  checkpoint seek from symbol {start}: bit-exact suffix")


if __name__ == "__main__":
    main()
