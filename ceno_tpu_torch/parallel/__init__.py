"""Multi-GPU parallelism: row-sharded (sequence-parallel) sumchecks and chip
proves over ``torch.distributed``."""

from . import sharded  # noqa: F401
