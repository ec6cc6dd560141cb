"""Batched monomial-term sumcheck: torch round kernels, prover, host verifier."""

from . import terms, prover, verifier  # noqa: F401
from .prover import TermSpec, prove  # noqa: F401
from .verifier import verify  # noqa: F401
