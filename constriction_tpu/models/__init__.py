"""Exactly-invertible fixed-point entropy models (rebuild of
constriction's model layer; see /root/reference/src/stream/model.rs)."""

from .base import EntropyModel, ImpossibleSymbol, ModelFamily
from .categorical import (
    ContiguousCategoricalEntropyModel,
    ContiguousLookupDecoderModel,
    LazyContiguousCategoricalEntropyModel,
    NonContiguousCategoricalDecoderModel,
    NonContiguousCategoricalEncoderModel,
    NonContiguousLookupDecoderModel,
    fast_quantized_cdf,
    perfectly_quantized_probabilities,
)
from .quantized import (
    Binomial,
    BinomialFamily,
    CallbackDistribution,
    CallbackFamily,
    Cauchy,
    Gaussian,
    Laplace,
    LeakilyQuantizedDistribution,
    LeakyQuantizer,
    QuantizedFamily,
)
from .uniform import UniformModel

__all__ = [
    "EntropyModel",
    "ImpossibleSymbol",
    "ModelFamily",
    "ContiguousCategoricalEntropyModel",
    "ContiguousLookupDecoderModel",
    "LazyContiguousCategoricalEntropyModel",
    "NonContiguousCategoricalDecoderModel",
    "NonContiguousCategoricalEncoderModel",
    "NonContiguousLookupDecoderModel",
    "fast_quantized_cdf",
    "perfectly_quantized_probabilities",
    "Binomial",
    "BinomialFamily",
    "CallbackDistribution",
    "CallbackFamily",
    "Cauchy",
    "Gaussian",
    "Laplace",
    "LeakilyQuantizedDistribution",
    "LeakyQuantizer",
    "QuantizedFamily",
    "UniformModel",
]
