"""Goldilocks field p = 2^64 - 2^32 + 1 on torch tensors (card and CPU).

Counterpart of ``ceno_tpu/fields/goldilocks.py``. The reference stores an
element as two uint32 limbs because the TPU has no 64-bit integer path. The
port stores a canonical element (< p) as one ``torch.int64`` that holds its
uint64 bit pattern (numpy ``.view(np.int64)`` across the boundary), so a
value of 2^63 or more reads as negative.

torch has no unsigned 64-bit arithmetic. Additions and subtractions wrap
modulo 2^64 (two's complement), and unsigned compares flip the sign bit
first (``x ^ (1 << 63)``). No product of 2^63 or more is ever formed (a
signed int64 product that overflows is undefined in C++): :func:`mul` splits
one operand into 32-bit limbs and the other into 16-bit limbs, so each
partial product is below 2^48, assembles the 128-bit product in 32-bit words
and folds it with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p), as
``fields/gl_host._reduce128`` does. These are also the plain versions the
CUDA kernels (``csrc/goldilocks.cuh``) are held against.
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPS = (1 << 32) - 1  # 2^64 mod p
DTYPE = torch.int64
GENERATOR = 7
TWO_ADICITY = 32
M32 = 0xFFFFFFFF
M16 = 0xFFFF
SIGN = -(1 << 63)
P_BITS = P - (1 << 64)      # p's bit pattern as an int64
P_FLIPPED = P ^ (1 << 63)   # p with its sign bit flipped (positive)


def const(v: int) -> int:
    """The int64 holding the bit pattern of ``v mod p``."""
    v %= P
    return v - (1 << 64) if v >> 63 else v


def to_device(x, device) -> torch.Tensor:
    """Canonical uint64 values (numpy or ints) -> an int64 tensor on ``device``."""
    arr = np.ascontiguousarray(np.asarray(x, np.uint64) % np.uint64(P))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_host(t: torch.Tensor) -> np.ndarray:
    """An int64 tensor -> a new canonical numpy uint64 array."""
    return np.array(t.detach().cpu().numpy().view(np.uint64))


def full(shape, v: int, device) -> torch.Tensor:
    return torch.full(tuple(shape), const(v), dtype=DTYPE, device=device)


def canon(x: torch.Tensor) -> torch.Tensor:
    """Any uint64 bit pattern -> its canonical value (x - p = x + EPS mod 2^64)."""
    return torch.where((x ^ SIGN) >= P_FLIPPED, x + EPS, x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p for canonical a, b. The sum wraps past 2^64 (a carry) or
    lands in [p, 2^64); either way adding EPS mod 2^64 makes it canonical."""
    s = a + b
    sx = s ^ SIGN
    fix = (sx < (a ^ SIGN)) | (sx >= P_FLIPPED)
    return torch.where(fix, s + EPS, s)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p: on a borrow the wrapped difference is 2^64 too large,
    and 2^64 = EPS mod p (it stays >= 2^32, so subtracting EPS cannot borrow)."""
    d = a - b
    return torch.where((a ^ SIGN) < (b ^ SIGN), d - EPS, d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a == 0, a, P_BITS - a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod p with every intermediate below 2^63 (see the module note).

    a = a0 + a1 2^32 (32-bit limbs), b = b0 + b1 2^16 + b2 2^32 + b3 2^48
    (16-bit limbs): the eight a_i b_k < 2^48. The 128-bit product is
    c0 + c1 2^32 + c2 2^64 + c3 2^96 with the odd-16 products split across
    two words; carried to 32-bit words w0..w3 it reduces as
    (w0 + w1 2^32) + w2 (2^32 - 1) - w3."""
    a0 = a & M32
    a1 = (a >> 32) & M32
    b0 = b & M16
    b1 = (b >> 16) & M16
    b2 = (b >> 32) & M16
    b3 = (b >> 48) & M16
    q01 = a0 * b1
    q13 = a1 * b3
    o1 = a1 * b1 + a0 * b3
    c0 = a0 * b0 + ((q01 & M16) << 16)
    c1 = a1 * b0 + a0 * b2 + ((o1 & M16) << 16) + (q01 >> 16) + (c0 >> 32)
    c2 = a1 * b2 + ((q13 & M16) << 16) + (o1 >> 16) + (c1 >> 32)
    w3 = (q13 >> 16) + (c2 >> 32)
    w2 = c2 & M32
    lo = (c0 & M32) | (c1 << 32)  # the low word's bits above 32 shift out
    return sub(add(canon(lo), canon((w2 << 32) - w2)), w3)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    out = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            out = mul(out, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return out


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2): the inverse, and 0 for 0 (as ``gl_host.inv``)."""
    return pow_const(a, P - 2)


def sum_mod(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum mod p along ``dim`` (fewer than 2^31 terms): the 32-bit halves are
    summed exactly in int64, then hi 2^32 = hh 2^64 + hl 2^32 folds with
    2^64 = EPS."""
    lo = (x & M32).sum(dim)
    hi = ((x >> 32) & M32).sum(dim)
    return add(add(lo, (hi >> 32) * EPS), canon((hi & M32) << 32))


def two_adic_root(log_n: int) -> int:
    """Generator of the order-2^log_n subgroup (``gl_host.two_adic_root``)."""
    if log_n > TWO_ADICITY:
        raise ValueError("domain too large for Goldilocks")
    return pow(GENERATOR, (P - 1) >> log_n, P)


def powers(w: int, n: int, device) -> torch.Tensor:
    """(n,) tensor of w^0 .. w^(n-1), n a power of two, by doubling."""
    out = torch.full((1,), 1, dtype=DTYPE, device=device)
    step = w % P
    while out.shape[0] < n:
        out = torch.cat([out, mul(out, torch.full_like(out, const(step)))])
        step = step * step % P
    return out[:n]
