"""Polynomial commitment: Basefold-RS over the jagged stack, NTT + Merkle."""

from . import ntt, merkle, basefold, jagged  # noqa: F401
