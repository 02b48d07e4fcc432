"""Worker for the multi-process mesh test (see test_multiprocess.py).

Each process owns 4 local CPU devices; 2 processes form one 8-device global
mesh.  The sharded container decode runs as a single SPMD program whose
final `all_gather` crosses the process boundary -- the CPU analog of the
network hop between hosts of a multi-host cluster (the reference has no
distributed analog, its seam is the backend trait pair
backends.rs:200-269).

Usage: python tests/_mp_worker.py <coordinator> <process_id> <num_processes>
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    coordinator, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc
    n_global = len(jax.devices())
    assert n_global == 4 * nproc, n_global

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from constriction_tpu import parallel
    from constriction_tpu.models.categorical import (
        ContiguousCategoricalEntropyModel,
    )
    from constriction_tpu.ops import jax_coder2 as jc2
    from constriction_tpu.ops.interleaved import LaneConfig

    # identical inputs on every process (seeded)
    rng = np.random.RandomState(7)
    alphabet = 20
    probs = rng.dirichlet(np.ones(alphabet))
    model = ContiguousCategoricalEntropyModel.from_floating_point_probabilities_fast(
        probs, 12
    )
    cdf = model.cdf
    n = 3001
    symbols = rng.choice(alphabet, size=n, p=probs).astype(np.int64)
    cfg = LaneConfig(num_lanes=128, word_bits=16, state_bits=32, precision=12)
    B = n_global

    # deterministic host encode -> container bytes agree across processes
    cont = parallel.encode(symbols, cdf, cfg=cfg, num_blocks=B, device=False)
    states, streams, n_true, block_len, cfg2, _coder = parallel.unpack_sharded(cont)
    assert n_true == n

    L = cfg.num_lanes
    T = -(-block_len // L)
    cap = T * L
    streams_arr = np.zeros((B, cap), np.uint32)
    lens = np.zeros(B, np.int32)
    for b, sw in enumerate(streams):
        streams_arr[b, :len(sw)] = sw
        lens[b] = len(sw)
    cdf32 = jnp.asarray(cdf, jnp.uint32)
    lut = jnp.asarray(jc2.lookup_table(cdf, 12))
    nsym = jnp.array([block_len], jnp.int32)

    mesh = Mesh(np.array(jax.devices()), (parallel.BLOCK_AXIS,))
    sh = NamedSharding(mesh, P(parallel.BLOCK_AXIS))

    def to_global(arr):
        return jax.make_array_from_callback(
            arr.shape, sh, lambda idx: arr[idx]
        )

    st_g = to_global(states.astype(np.uint32))
    streams_g = to_global(streams_arr)
    lens_g = to_global(lens)

    def per_device(st_b, stream_b, len_b):
        syms, _ = jc2.decode_blocks(st_b, stream_b, len_b, cdf32, lut, nsym,
                                    cfg=cfg, T=T)
        # the cross-process collective: in-order gather over the global mesh
        return jax.lax.all_gather(syms[:, :block_len], parallel.BLOCK_AXIS,
                                  tiled=True)

    fn = jax.jit(
        jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(parallel.BLOCK_AXIS),) * 3,
            out_specs=P(),
            check_vma=False,
        )
    )
    out = np.asarray(fn(st_g, streams_g, lens_g)).reshape(-1)[:n]
    assert np.array_equal(out, symbols), "multi-process sharded decode mismatch"
    print(f"MP_OK pid={pid} devices={n_global}", flush=True)


if __name__ == "__main__":
    main()
