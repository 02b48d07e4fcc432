"""Bits-back coding with the chain coder (host API, reference parity).

A bits-back sender "decodes" a latent from side information it already
holds (borrowing its bits), then encodes data given that latent.  The
chain coder makes the borrowing exact and symbol-local: decoding with a
posterior consumes exactly ``precision`` bits per symbol, and the
remainders let the receiver rebuild the borrowed bits bit for bit
(reference: constriction.stream.chain.ChainCoder, chain.rs:1-84).

This walkthrough decodes latents from random side information with a
posterior model, re-encodes them on a fresh coder built from the
remainders, and checks that the original side information comes back.

Run: python examples/bits_back.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    import constriction_tpu as constriction

    rng = np.random.RandomState(0)
    side_info = rng.randint(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)

    # posterior over the latent: 8 categories, one model for every symbol
    probs = rng.dirichlet(np.full(8, 1.5))
    posterior = constriction.stream.model.Categorical(probs, perfect=False)

    # sender: borrow bits from the side information by decoding latents
    coder = constriction.stream.chain.ChainCoder(side_info, seal=True)
    latents = coder.decode(posterior, 100)
    remainders = np.concatenate(coder.get_remainders())
    print(f"decoded {len(latents)} latents from {len(side_info)} words of "
          f"side information ({len(remainders)} remainder words left)")

    # receiver: re-encode the latents onto the remainders -> side info back
    back = constriction.stream.chain.ChainCoder(remainders, is_remainders=True)
    back.encode_reverse(latents, posterior)
    recovered = np.concatenate(back.get_data(unseal=True))
    assert np.array_equal(recovered, side_info)
    print("bits-back round trip: side information recovered bit for bit")


if __name__ == "__main__":
    main()
