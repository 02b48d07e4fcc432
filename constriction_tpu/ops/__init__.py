"""Coder cores: exact scalar state machines (host) and device coders."""

from .ans import AnsCoderCore
from .chain import ChainCoderCore
from .range import RangeDecoderCore, RangeEncoderCore

__all__ = ["AnsCoderCore", "ChainCoderCore", "RangeDecoderCore", "RangeEncoderCore"]
