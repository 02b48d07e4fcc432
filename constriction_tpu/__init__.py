"""constriction_tpu: a lossless entropy-coding framework for JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
`bamler-lab/constriction` v0.5 (studied read-only at /root/reference):

- stream codes: rANS stack coding, range (queue) coding, chain coding
  (bits-back) -- `constriction_tpu.stream`;
- symbol codes: Huffman and Exp-Golomb over bit-granular stack/queue coders
  -- `constriction_tpu.symbol`;
- exactly-invertible fixed-point entropy models (LeakyQuantizer-style
  QuantizedGaussian/Laplace/Cauchy/Binomial, categorical in
  fast/perfect/lazy/lookup variants, uniform) -- `constriction_tpu.models`;
- device path: shared-stream lane-interleaved rANS (ILANS2) coded by GPU
  kernels, and data-parallel block sharding over device meshes --
  `constriction_tpu.ops` / `constriction_tpu.parallel`.

Bitstream discipline is inherited from the reference: the compat path is
bit-exact with constriction 0.5 (verified against vendored golden vectors),
and the interleaved device format is a documented superset with per-lane
constriction-compatible streams.
"""

from . import models, stream, symbol

__version__ = "0.1.0"

__all__ = ["models", "stream", "symbol", "__version__"]
