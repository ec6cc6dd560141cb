"""Dense multilinear-extension ops (torch)."""

from . import ops  # noqa: F401
