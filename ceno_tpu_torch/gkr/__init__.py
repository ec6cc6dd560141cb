"""GKR IOP engine: circuit DSL, tower arguments, per-chip prove/verify, mock."""

from . import tower, circuit_builder, chip, mock  # noqa: F401
from .circuit_builder import CircuitBuilder  # noqa: F401
from .chip import compile_chip, prove_chip, verify_chip  # noqa: F401
