"""On-device entropy-model table building (jnp).

Device twin of models/categorical.fast_quantized_cdf (which mirrors
/root/reference/src/stream/model/categorical.rs:16-54): quantize a float PMF
into the exactly-invertible leaky fixed-point CDF entirely on-device, so a
model computed by a neural network never round-trips to the host before
encoding.

Exactness note: the reference (and our host twin) accumulates the PMF with a
*sequential* left-to-right sum; XLA's cumsum may associate differently, so a
device-built table can differ from the host-built one in the last ulp of the
scale — both are valid leaky models, but containers are keyed to the table
that built them.  Use the host builder when bit-compatibility with
constriction is required; use this one for on-device pipelines (the table is
returned, and both encode and decode take explicit tables, so the codec is
always self-consistent).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fast_quantized_cdf_jax(probabilities: jax.Array, precision: int) -> jax.Array:
    """Length-(n+1) fixed-point CDF (uint32, last entry ``2**precision``).

    Same construction as the host fast quantizer: ``left_k = trunc(cumsum_{<k}
    * scale) + k`` with ``scale = (2^P - n) / sum``; the ``+ k`` slack makes
    every symbol leaky (prob >= 1) regardless of float rounding.
    """
    probs = jnp.asarray(probabilities)
    if probs.dtype not in (jnp.float32, jnp.bfloat16):
        probs = probs.astype(jnp.float32)
    n = int(probs.shape[0])
    if n < 2 or n >= (1 << precision) - 1:
        raise ValueError("invalid number of probabilities")
    free_weight = (1 << precision) - n
    cumsum = jnp.cumsum(probs.astype(jnp.float32))
    scale = jnp.float32(free_weight) / cumsum[-1]
    cumulative = jnp.concatenate([jnp.zeros(1, jnp.float32), cumsum[:-1]])
    left = jnp.trunc(cumulative * scale).astype(jnp.uint32) + jnp.arange(
        n, dtype=jnp.uint32
    )
    # f32 trunc can overshoot free_weight for adversarial PMFs (a raise is
    # impossible under jit, and the host twin errors there); clamp so the
    # table stays a valid leaky model: left_k <= 2^P - n + k keeps every
    # probability >= 1 while never binding on inputs the host accepts
    left = jnp.minimum(
        left,
        np.uint32((1 << precision) - n) + jnp.arange(n, dtype=jnp.uint32),
    )
    return jnp.concatenate(
        [left, jnp.full(1, np.uint32(1 << precision), jnp.uint32)]
    )


def uniform_cdf_jax(size: int, precision: int) -> jax.Array:
    """Closed-form uniform model table (reference uniform.rs:24-77): each bin
    gets ``2^P // size``, the last bin absorbs the remainder."""
    if size <= 1:
        raise ValueError("UniformModel requires range > 1")
    if size - 1 > (1 << precision) - 1:
        raise ValueError("range too large for precision")
    ppb = (1 << precision) // size
    left = jnp.arange(size, dtype=jnp.uint32) * np.uint32(ppb)
    return jnp.concatenate(
        [left, jnp.full(1, np.uint32(1 << precision), jnp.uint32)]
    )
