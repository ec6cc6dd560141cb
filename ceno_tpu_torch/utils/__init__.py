"""Shared utilities: profiling spans, the CUDA kernel build."""

from . import spans  # noqa: F401
