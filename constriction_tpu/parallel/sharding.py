"""Data-parallel block sharding of interleaved rANS over a device mesh.

The message is split into ``D`` independent blocks (one per device along the
``"blocks"`` mesh axis); each device encodes/decodes its block's ``L`` lanes
locally with the jittable coders of :mod:`constriction_tpu.ops.jax_coder`
(ILANS v1) or :mod:`constriction_tpu.ops.device_coder` (ILANS2).
No cross-device communication happens in the hot loop -- the only collectives
are the in-order gather of per-block word counts and payloads at the end
(``jax.lax.all_gather``, over NVLink between the cards of one host), which
replaces the reference's pluggable word-stream backend seam
(/root/reference/src/backends.rs:200-269) with a sharded device-array backend.

Bit-compatibility: a sharded container decodes to exactly the same symbols on
any mesh shape, because block boundaries are part of the container header and
each block is an ordinary ILANS unit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import jax_coder
from ..ops.interleaved import LaneConfig

BLOCK_AXIS = "blocks"


def make_mesh(num_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if num_devices is not None:
            devices = devices[:num_devices]
    return Mesh(np.array(devices), (BLOCK_AXIS,))


def shard_encode(
    mesh: Mesh,
    cums: jax.Array,  # [D, T, L] u32
    probs: jax.Array,  # [D, T, L] u32
    block_lens: jax.Array,  # i32[D] number of symbols per block
    cfg: LaneConfig,
    num_steps: int,
    max_words: int,
) -> Tuple[jax.Array, jax.Array]:
    """Encode D blocks in parallel; returns (words [D, L, max_words],
    counts [D, L]), both sharded along the block axis."""

    def per_block(cums_b, probs_b, len_b):
        # cums_b: [1, T, L] (this device's shard)
        words, counts = jax_coder.jax_encode_dynamic(
            cums_b[0], probs_b[0], cfg, num_steps, len_b[0], max_words
        )
        return words[None], counts[None]

    fn = jax.shard_map(
        per_block,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
        check_vma=False,
    )
    return fn(cums, probs, block_lens)


def shard_decode_lookup(
    mesh: Mesh,
    words: jax.Array,  # [D, L, M] u32
    counts: jax.Array,  # [D, L] i32
    block_lens: jax.Array,  # i32[D]
    lookup: jax.Array,
    packed_cdf: jax.Array,
    cfg: LaneConfig,
    num_steps: int,
) -> jax.Array:
    """Decode D blocks in parallel with a shared lookup model (replicated
    tables); returns [D, num_steps * L] i32, sharded along blocks."""

    def per_block(words_b, counts_b, len_b, lookup_r, packed_r):
        syms = jax_coder.jax_decode_lookup_dynamic(
            words_b[0], counts_b[0], lookup_r, packed_r, cfg, num_steps, len_b[0]
        )
        return syms[None]

    fn = jax.shard_map(
        per_block,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS), P(BLOCK_AXIS), P(), P()),
        out_specs=P(BLOCK_AXIS),
        check_vma=False,
    )
    return fn(words, counts, block_lens, lookup, packed_cdf)


def gather_blocks(mesh: Mesh, words: jax.Array, counts: jax.Array):
    """In-order all-gather of the per-block compressed words + length tables
    so every device (and the host) holds the full container."""

    def g(words_b, counts_b):
        return (
            jax.lax.all_gather(words_b[0], BLOCK_AXIS),
            jax.lax.all_gather(counts_b[0], BLOCK_AXIS),
        )

    fn = jax.shard_map(
        g,
        mesh=mesh,
        in_specs=(P(BLOCK_AXIS), P(BLOCK_AXIS)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(words, counts)


# ---------------------------------------------------------------------------
# ILANS v2 (shared-stream) block sharding through the device coder
# ---------------------------------------------------------------------------


def shard_encode2(mesh: Mesh, symbols, cdf: np.ndarray, cfg: LaneConfig,
                  seeds=None):
    """Encode B equal-length ILANS2 blocks (``symbols`` [B, block_len])
    over ``mesh``, B divisible by its device count.  Returns
    ``(init_states [B, L], streams)`` gathered in block order; the
    implementation is the route's (ops/route.py)."""
    from ..ops import device_coder

    return device_coder.encode_blocks(symbols, cdf, cfg, seeds=seeds,
                                      mesh=mesh)


def shard_decode2(mesh: Mesh, init_states, streams, cdf: np.ndarray,
                  cfg: LaneConfig, block_len: int):
    """Decode B equal-length ILANS2 blocks over ``mesh``.  Returns
    ``(symbols [B, block_len], final_states [B, L])``."""
    from ..ops import device_coder

    return device_coder.decode_blocks(init_states, streams, block_len, cdf,
                                      cfg, mesh=mesh)


# ---------------------------------------------------------------------------
# Host-level convenience: end-to-end sharded iid encode/decode
# ---------------------------------------------------------------------------


def prepare_blocks(
    symbols: np.ndarray, cdf: np.ndarray, num_blocks: int, cfg: LaneConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Split symbols into num_blocks equal blocks; build [D, T, L] tables."""
    n = len(symbols)
    D = num_blocks
    L = cfg.num_lanes
    block = -(-n // D)
    T = -(-block // L)
    cdf64 = np.asarray(cdf, dtype=np.uint64)
    symbols = np.asarray(symbols, dtype=np.int64)

    cums = np.zeros((D, T * L), dtype=np.uint32)
    probs = np.ones((D, T * L), dtype=np.uint32)
    lens = np.zeros(D, dtype=np.int32)
    for d in range(D):
        blk = symbols[d * block : (d + 1) * block]
        lens[d] = len(blk)
        cums[d, : len(blk)] = cdf64[blk]
        probs[d, : len(blk)] = (cdf64[blk + 1] - cdf64[blk]).astype(np.uint32)
    return (
        cums.reshape(D, T, L),
        probs.reshape(D, T, L),
        lens,
        T,
    )
