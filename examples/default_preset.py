"""The reference's DEFAULT preset (W=32 / S=64 / P=24) on the device.

constriction's Python API pins the "default" preset: 32-bit stream words,
64-bit coder states, 24-bit fixed-point probabilities
(/root/reference/src/stream/stack.rs:139).  The facade picks that preset
for any P=24 model: an i.i.d. categorical message against a P=24 CDF is
coded into an ILANS2-64 container on the device (u64 lane states), and
decoded back, bit-exact with the host oracle.

Run: python examples/default_preset.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    import constriction_tpu.tpu as ctpu
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops import framing

    rng = np.random.RandomState(0)
    K, n = 100, 20000
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf24 = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 24
    ).cdf
    symbols = rng.choice(K, size=n, p=probs)

    container = ctpu.encode_iid(symbols, cdf24)
    cfg = framing.peek_cfg(container)
    assert (cfg.word_bits, cfg.state_bits, cfg.precision) == (32, 64, 24)
    assert np.array_equal(ctpu.decode_iid(container, cdf24), symbols)
    host = framing.encode_iid_v2(symbols, cdf24, cfg, device=False)
    assert np.array_equal(container, host)
    info = -np.sum(np.log2(
        (cdf24.astype(np.float64)[symbols + 1] - cdf24[symbols]) / 2.0**24
    ))
    print(f"rANS default preset: {n} symbols over {cfg.num_lanes} lanes, "
          f"{len(container) * 32} container bits "
          f"({len(container) * 32 / info - 1:+.3%} vs the information bound); "
          "device bytes == host bytes")


if __name__ == "__main__":
    main()
