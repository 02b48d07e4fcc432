"""Data-parallel entropy coding over a device mesh.

The scaling story for an entropy coder is embarrassingly parallel: split
the message into independent blocks, give every device its share of the
blocks (one device coder per device under `shard_map`), and all-gather the
variable-length compressed blocks with a length table at the end (the only
collective; NVLink between the cards of one host).

``parallel.encode`` / ``parallel.decode`` do all of that in one call, and
the container does not depend on the mesh: bytes encoded on D devices
equal the host loop's and decode on any device count that divides the
block count.

Run anywhere: ``python examples/multichip_sharded.py`` uses every device
JAX sees (on a CPU, ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
gives four virtual ones).  Reference anchor: constriction has no
distributed path; the closest seam is its pluggable word-I/O backend
(backends.rs).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> None:
    import jax

    from constriction_tpu import parallel
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops.interleaved import LaneConfig

    D = len(jax.devices())
    print(f"mesh: {D} x {jax.devices()[0].platform}")
    rng = np.random.RandomState(0)
    K, n = 50, 200_000
    probs = rng.dirichlet(np.full(K, 2.0))
    cdf = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12).cdf
    symbols = rng.choice(K, size=n, p=probs)
    cfg = LaneConfig(num_lanes=1024, word_bits=16, state_bits=32, precision=12)
    mesh = parallel.make_mesh(D)

    for compact in (False, True):
        cont = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=2 * D,
                               mesh=mesh, compact=compact)
        host = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=2 * D,
                               device=False, compact=compact)
        assert np.array_equal(cont, host), "device bytes differ from host"
        out = parallel.decode(cont, cdf, mesh=mesh)
        assert np.array_equal(out, symbols)
        print(f"{'compact' if compact else 'raw'} container: {2 * D} blocks, "
              f"{len(cont) * 4} bytes; device == host bytes; round trip OK")


if __name__ == "__main__":
    main()
