"""Field arithmetic: BabyBear and its quartic extension, Goldilocks and its
quadratic extension (torch + numpy)."""

from . import babybear, ext4, ext4_host  # noqa: F401
