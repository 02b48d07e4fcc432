"""Code a constriction-modeled message, then seek-decode a device container.

Two capabilities in one walkthrough:

1. REFERENCE-EXACT per-symbol families: `stream.model.QuantizedGaussian`
   builds the host f64 LeakyQuantizer tables bit-identical to what
   `constriction.stream.model.QuantizedGaussian` uses
   (quantize.rs:525-568), so a message coded with the host AnsCoder here
   is byte-for-byte the reference's file.

2. Random access (``tpu.build_checkpoints``): periodic decoder snapshots
   let any suffix of an ILANS2 container be decoded from the middle,
   bit-exactly, without touching the prefix -- the interleaved analog of
   the reference's Pos/Seek jump tables (stack.rs:643-700).  The device
   coder runs the GPU kernels on a GPU and the plain-XLA coder elsewhere.

Run: python examples/reference_exact_and_seek.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import constriction_tpu as constriction
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops.interleaved import LaneConfig

    rng = np.random.RandomState(0)

    # 1. per-symbol Gaussians, reference-exact host tables
    n = 2000
    means = rng.uniform(-60, 60, n)
    stds = np.exp(rng.uniform(np.log(0.5), np.log(8.0), n))
    symbols = np.clip(np.round(means + rng.randn(n) * stds), -100, 100).astype(
        np.int32)
    model = constriction.stream.model.QuantizedGaussian(-100, 100)
    coder = constriction.stream.stack.AnsCoder()
    coder.encode_reverse(symbols, model, means, stds)
    words = coder.get_compressed()
    decoder = constriction.stream.stack.AnsCoder(words)
    assert np.array_equal(decoder.decode(model, means, stds), symbols)
    print(f"reference-exact Gaussians: {n} symbols in {len(words)} words")

    # 2. device container + checkpoint seek
    K, n2, L = 64, 200_000, 512
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12).cdf
    msg = rng.choice(K, size=n2, p=probs)
    cfg = LaneConfig(num_lanes=L, word_bits=16, state_bits=32, precision=12)
    container = ctpu.encode_iid(msg, cdf, cfg)
    interval = 32
    offsets, states = ctpu.build_checkpoints(container, cdf, interval)
    c = len(offsets) // 2
    start, suffix = ctpu.decode_from_checkpoint(container, cdf, interval, c,
                                                offsets, states)
    assert np.array_equal(suffix, msg[start:])
    print(f"seek: decoded symbols {start}..{n2} from checkpoint {c} "
          f"of {len(offsets)} without touching the prefix")


if __name__ == "__main__":
    main()
