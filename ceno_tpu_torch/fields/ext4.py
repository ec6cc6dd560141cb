"""BabyBear quartic extension F_p[x]/(x^4 - 11) on torch tensors.

Extension elements are stored component-leading, shape ``(4,) + batch_shape``
of Montgomery int32, as in ``ceno_tpu.fields.ext4``. Products widen to int64:
the 16 partial products are reduced mod p, the x^4 = W wrap is applied to the
sums, and one multiply by R^-1 returns to Montgomery form (value-equal to the
reference's 16+3 Montgomery multiplies).
"""

from __future__ import annotations

import numpy as np
import torch

from . import babybear as bb

W = 11  # x^4 = W

# Frobenius constants: (x^i)^(p^k) = x^i * FROB[k][i], FROB[k][i] = W^(i*k*(p-1)/4)
_FROB_BASE = pow(W, (bb.P - 1) // 4, bb.P)
FROB = [
    [pow(_FROB_BASE, i * k, bb.P) for i in range(4)]
    for k in range(4)
]
FROB_MONTY = [[bb.const(c) for c in row] for row in FROB]

_P = bb.P


def from_base(a):
    """Base-field tensor -> ext tensor with zero high components."""
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, z])


def zeros(shape, device=None):
    return torch.zeros((4,) + tuple(shape), dtype=bb.DTYPE, device=device)


def ones(shape, device=None):
    out = zeros(shape, device)
    out[0] = bb.MONTY_ONE
    return out


def add(a, b):
    return bb.add(a, b)


def sub(a, b):
    return bb.sub(a, b)


def neg(a):
    return bb.neg(a)


def mul_parts(a, b) -> list:
    """Ext4 product of two lists of 4 int64 coefficient tensors (Montgomery
    form, each in [0, p)), broadcasting; returns the 4 int64 coefficients.

    A product of two elements is below p^2 < 2^62, so each sum of two
    products, or of one and a reduced term, stays below 2^63."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    c0 = (a0 * b0 + W * (((a1 * b3 + a2 * b2) % _P + a3 * b1) % _P)) % _P
    c1 = ((a0 * b1 + a1 * b0) % _P + W * ((a2 * b3 + a3 * b2) % _P)) % _P
    c2 = ((a0 * b2 + a1 * b1) % _P + a2 * b0 + W * (a3 * b3 % _P)) % _P
    c3 = ((a0 * b3 + a1 * b2) % _P + a2 * b1 + a3 * b0) % _P
    return [c * bb.RINV % _P for c in (c0, c1, c2, c3)]


def mul(a, b):
    """Ext4 x Ext4 product, broadcasting over the batch axes."""
    c = mul_parts([a[i].long() for i in range(4)], [b[i].long() for i in range(4)])
    return torch.stack(c).to(bb.DTYPE)


def mul_base(a, b):
    """Ext4 x base product: ``a`` is (4, ...) ext, ``b`` base (broadcasts)."""
    return bb.mul(a, b[None])


def square(a):
    return mul(a, a)


def frobenius(a, k: int):
    """a^(p^k), componentwise scaling by precomputed constants."""
    return torch.stack(
        [bb.mul_const(a[i], FROB_MONTY[k % 4][i]) for i in range(4)]
    )


def inv(a):
    """Ext inverse via the norm map: a^{-1} = t / N(a), t = prod of conjugates."""
    f1 = frobenius(a, 1)
    f2 = frobenius(a, 2)
    f3 = frobenius(a, 3)
    t = mul(mul(f1, f2), f3)
    norm = mul(a, t)[0]  # N(a) lies in the base field
    return mul_base(t, bb.inv(norm))


# ---------------------------------------------------------------------------
# Host-side helpers
# ---------------------------------------------------------------------------

def np_to_monty(x: np.ndarray) -> np.ndarray:
    """Canonical (4, ...) numpy -> Montgomery-form uint32."""
    return bb.np_to_monty(x)


def np_from_monty(x: np.ndarray) -> np.ndarray:
    return bb.np_from_monty(x)


def py_mul(a, b):
    """Reference ext4 multiply on python-int 4-tuples (canonical form)."""
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] = (c[i + j] + a[i] * b[j]) % bb.P
    for k in range(6, 3, -1):
        c[k - 4] = (c[k - 4] + W * c[k]) % bb.P
    return tuple(c[:4])
