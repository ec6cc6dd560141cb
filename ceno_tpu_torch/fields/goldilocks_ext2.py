"""GoldilocksExt2 = F_p[x]/(x^2 - 7) on torch tensors (card and CPU).

Counterpart of ``ceno_tpu/fields/goldilocks_ext2.py``. The reference stores
(2 components, 2 limbs, batch...) uint32; the port keeps the layout of
``fields/gl2_host.py``: int64 tensors of shape (..., 2), component last, each
component a canonical Goldilocks element (fields/goldilocks.py). The base
operations broadcast, so a (2,) element scales an (N, 2) column.
"""

from __future__ import annotations

import torch

from . import goldilocks as gl

DEGREE = 2
W = 7


def from_base(a: torch.Tensor) -> torch.Tensor:
    """(...,) base -> (..., 2) ext with a zero second component."""
    return torch.stack([a, torch.zeros_like(a)], dim=-1)


def one(device) -> torch.Tensor:
    return torch.tensor([1, 0], dtype=gl.DTYPE, device=device)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gl.add(a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return gl.sub(a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return gl.neg(a)


def mul_w(x: torch.Tensor) -> torch.Tensor:
    """7 x as 8 x - x."""
    x2 = gl.add(x, x)
    x4 = gl.add(x2, x2)
    return gl.sub(gl.add(x4, x4), x)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a0 + a1 x)(b0 + b1 x) = a0 b0 + 7 a1 b1 + (a0 b1 + a1 b0) x; the four
    base products run as one :func:`gl.mul` over a stacked operand."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    m = gl.mul(torch.stack([a0, a1, a0, a1]), torch.stack([b0, b1, b1, b0]))
    return torch.stack([gl.add(m[0], mul_w(m[1])), gl.add(m[2], m[3])], dim=-1)


def mul_base(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(..., 2) ext times (...,) base."""
    return gl.mul(a, s.unsqueeze(-1))


def inv(a: torch.Tensor) -> torch.Tensor:
    """(a0 - a1 x) / (a0^2 - 7 a1^2)."""
    a0, a1 = a[..., 0], a[..., 1]
    d = gl.sub(gl.mul(a0, a0), mul_w(gl.mul(a1, a1)))
    di = gl.inv(d)
    return torch.stack([gl.mul(a0, di), gl.mul(gl.neg(a1), di)], dim=-1)


def sum_mod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum mod p along ``dim`` (not the component axis)."""
    if dim < 0:
        dim += x.dim()
    if dim == x.dim() - 1:
        raise ValueError("sum_mod: dim is the component axis")
    return gl.sum_mod(x, dim)


def to_device(x, device) -> torch.Tensor:
    return gl.to_device(x, device)


def to_host(t: torch.Tensor):
    return gl.to_host(t)
