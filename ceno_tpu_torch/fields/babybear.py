"""BabyBear base field on torch tensors.

p = 2^31 - 2^27 + 1 = 0x78000001 (two-adicity 27).

Device tensors hold elements in **Montgomery form** (value * 2^32 mod p) as
``torch.int32``, exactly where ``ceno_tpu.fields.babybear`` keeps Montgomery
``uint32``; every stored value is below p < 2^31, so int32 loses nothing.
Additions stay in int32 (``a - (p - b)`` never overflows); products widen to
int64, which is safe because (p-1)^2 < 2^62. The Montgomery product is
computed as ``a*b mod p * R^-1 mod p``: value-equal to the reference's REDC
(``ceno_tpu/fields/babybear.py:101-108``), not the same instructions. The
CUDA kernels in ``csrc/`` use a native 32x32->64 REDC instead.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2013265921  # 0x78000001
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative generator of F_p^*
R = (1 << 32) % P          # Montgomery R mod p = 2^28 - 2
R2 = pow(1 << 32, 2, P)    # R^2 mod p
RINV = pow(R, P - 2, P)    # R^-1 mod p
PINV = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^{-1} mod 2^32 (CUDA REDC)

DTYPE = torch.int32


def const(v: int) -> int:
    """Montgomery representation of the canonical integer ``v`` (python int)."""
    return (v % P) * (1 << 32) % P


MONTY_ONE = const(1)


# ---------------------------------------------------------------------------
# Field ops (Montgomery domain). Inputs/outputs are int32 tensors in [0, p).
# ---------------------------------------------------------------------------

def add(a, b):
    d = a - (P - b)  # in (-p, p): no int32 overflow
    return torch.where(d < 0, d + P, d)


def sub(a, b):
    d = a - b
    return torch.where(d < 0, d + P, d)


def neg(a):
    return torch.where(a == 0, a, P - a)


def double(a):
    return add(a, a)


def mul(a, b):
    """Montgomery product a*b/R mod p (both operands in Montgomery form)."""
    t = torch.as_tensor(a).long() * torch.as_tensor(b).long() % P
    return (t * RINV % P).to(DTYPE)


def mul_const(a, c_monty: int):
    """Multiply by a Montgomery constant (a python int)."""
    return (a.long() * (c_monty * RINV % P) % P).to(DTYPE)


def from_monty(a):
    """Montgomery -> canonical value (int32)."""
    return (a.long() * RINV % P).to(DTYPE)


def to_monty(a):
    """Canonical value (< p, any integer dtype) -> Montgomery form (int32)."""
    return (a.long() % P * R % P).to(DTYPE)


def pow_const(a, e: int):
    """a ** e for a python-int exponent, by square and multiply."""
    result = None
    acc = a
    while e > 0:
        if e & 1:
            result = acc if result is None else mul(result, acc)
        e >>= 1
        if e:
            acc = mul(acc, acc)
    if result is None:
        return torch.full_like(a, MONTY_ONE)
    return result


def inv(a):
    """Field inverse via Fermat: a^(p-2). a must be nonzero."""
    return pow_const(a, P - 2)


def sum_mod(x, axis: int = -1):
    """Modular sum along ``axis`` (int64 accumulation: n * p < 2^63)."""
    return (x.long().sum(dim=axis) % P).to(DTYPE)


def zeros(shape, device=None):
    return torch.zeros(shape, dtype=DTYPE, device=device)


def ones(shape, device=None):
    return torch.full(shape, MONTY_ONE, dtype=DTYPE, device=device)


# ---------------------------------------------------------------------------
# Host boundary: canonical numpy <-> Montgomery tensors
# ---------------------------------------------------------------------------

def np_to_monty(x: np.ndarray) -> np.ndarray:
    """Canonical uint32/int numpy array -> Montgomery-form uint32 numpy array."""
    v = np.asarray(x, dtype=np.uint64) % P
    return ((v << 32) % P).astype(np.uint32)


def np_from_monty(x: np.ndarray) -> np.ndarray:
    v = (np.asarray(x, dtype=np.uint64) * RINV) % P
    return v.astype(np.uint32)


def to_device(x_canonical: np.ndarray, device) -> torch.Tensor:
    """Canonical numpy (values < 2^63) -> Montgomery int32 tensor on
    ``device``; the conversion runs there."""
    x = torch.from_numpy(np.ascontiguousarray(x_canonical).astype(np.int64))
    return to_monty(x.to(device))


def to_host(x_monty: torch.Tensor) -> np.ndarray:
    """Montgomery int32 tensor -> canonical numpy uint64 (the host form)."""
    return from_monty(x_monty.detach()).cpu().numpy().astype(np.uint64)


def two_adic_root(bits: int) -> int:
    """Canonical 2^bits-th root of unity (python int)."""
    assert bits <= TWO_ADICITY
    root = pow(GENERATOR, (P - 1) >> TWO_ADICITY, P)
    for _ in range(TWO_ADICITY - bits):
        root = root * root % P
    return root
