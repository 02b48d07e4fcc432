"""Multi-device parallelism: block sharding of interleaved coders over a mesh."""

from .container import (
    CODER_RANGE,
    CODER_RANS,
    build_block_checkpoints,
    decode,
    decode_block_from_checkpoint,
    encode,
    pack_sharded,
    unpack_sharded,
)
from .sharding import (
    BLOCK_AXIS,
    gather_blocks,
    make_mesh,
    prepare_blocks,
    shard_decode2,
    shard_decode_lookup,
    shard_encode,
    shard_encode2,
)

__all__ = [
    "BLOCK_AXIS",
    "CODER_RANGE",
    "CODER_RANS",
    "build_block_checkpoints",
    "decode",
    "decode_block_from_checkpoint",
    "encode",
    "pack_sharded",
    "unpack_sharded",
    "gather_blocks",
    "make_mesh",
    "prepare_blocks",
    "shard_decode2",
    "shard_decode_lookup",
    "shard_encode",
    "shard_encode2",
]
