"""Hashing: Poseidon2 (host numpy, torch, CUDA Merkle kernels) and the
Fiat-Shamir transcript."""

from . import poseidon2  # noqa: F401
from .transcript import Transcript  # noqa: F401
