"""Dense multilinear-extension ops on torch tensors.

Conventions (those of ``ceno_tpu/mle/ops.py``):
  * An n-variable MLE is its evaluation table over the hypercube, index bit j
    <-> variable j (LSB-first). Base MLEs are int32 (N,) Montgomery tensors;
    ext MLEs are (4, N) (component axis leading).
  * ``fold_top`` fixes the TOP variable (n-1), so the two halves are
    contiguous; a point returned by a sumcheck of challenges [c_0, c_1, ...]
    is stored LSB-first as ``point[j] = c_{n-1-j}``.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..fields import ext4


def is_ext(m) -> bool:
    return m.dim() >= 2 and m.shape[0] == 4


def num_vars(m) -> int:
    n = m.shape[-1]
    assert n & (n - 1) == 0
    return n.bit_length() - 1


def to_ext(m):
    return m if is_ext(m) else ext4.from_base(m)


def fold_top(m, r):
    """Fix the top variable to ext scalar ``r`` (shape (4,)): N -> N/2."""
    half = m.shape[-1] // 2
    if is_ext(m):
        lo, hi = m[:, :half], m[:, half:]
        return ext4.add(lo, ext4.mul(r[:, None], ext4.sub(hi, lo)))
    lo, hi = m[:half], m[half:]
    return ext4.add(ext4.from_base(lo), ext4.mul_base(r[:, None], bb.sub(hi, lo)))


def evaluate(m, point):
    """Evaluate at ``point``: (n, 4) Montgomery ext coords, point[j] <-> var j."""
    n = num_vars(m)
    assert point.shape[0] == n
    for j in range(n - 1, -1, -1):
        m = fold_top(m, point[j])
    return to_ext(m)[:, 0]


def build_eq(point, scale=None):
    """eq(x, r) table: (4, 2^n) with eq[i] = prod_j (i_j r_j + (1-i_j)(1-r_j)).

    ``point``: (n, 4) Montgomery ext, LSB-first. Optional ext ``scale`` (4,)
    premultiplies every entry. A batch of T points is (n, 4, T) with scales
    (4, T): then the tables are (4, T, 2^n).
    """
    n = point.shape[0]
    e = ext4.ones((1,), point.device) if scale is None else scale[..., None]
    for j in range(n):
        hi = ext4.mul(e, point[j][..., None])
        lo = ext4.sub(e, hi)
        e = torch.cat([lo, hi], dim=-1)
    return e
