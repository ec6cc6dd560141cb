"""Host-side Goldilocks arithmetic: canonical numpy uint64, vectorized.

Copy of ``ceno_tpu/fields/gl_host.py``. The Goldilocks verifiers, the
transcript and the host reference of the `--field goldilocks` pipeline run
on it (reference: ff_ext::GoldilocksExt2, e2e.rs:103-129).

p = 2^64 - 2^32 + 1 does not fit numpy's modular tricks directly (products
are 128-bit), so `mul` splits operands into 32-bit halves and folds with
2^64 = 2^32 - 1 and 2^96 = -1 (mod p), all in uint64 lanes. The torch field
(fields/goldilocks.py) and the CUDA kernels (csrc/goldilocks.cuh) fold the
same way.
"""

from __future__ import annotations

import numpy as np

P = (1 << 64) - (1 << 32) + 1
_P = np.uint64(P)
EPS = np.uint64((1 << 32) - 1)  # 2^64 mod p
MASK32 = np.uint64(0xFFFFFFFF)
GENERATOR = 7
TWO_ADICITY = 32


def _norm(x):
    return np.asarray(x, np.uint64) % _P


def add(a, b):
    a = _norm(a)
    b = _norm(b)
    with np.errstate(over="ignore"):
        s = a + b  # may wrap past 2^64: detect with s < a
        wrapped = s < a
        # 2^64 ≡ EPS: add EPS where wrapped (cannot wrap again since s small)
        s = np.where(wrapped, s + EPS, s)
    # s may still be >= p
    return np.where(s >= _P, s - _P, s)


def sub(a, b):
    a = _norm(a)
    b = _norm(b)
    with np.errstate(over="ignore"):
        return np.where(a >= b, a - b, a + (_P - b))


def neg(a):
    a = _norm(a)
    return np.where(a == 0, a, _P - a)


def _reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(hi * 2^64 + lo) mod p, elementwise uint64."""
    # hi = hi_hi * 2^32 + hi_lo;  2^64 ≡ 2^32 - 1,  2^96 ≡ -1 (mod p)
    hi_lo = hi & MASK32
    hi_hi = hi >> np.uint64(32)
    # t = hi_lo * (2^32 - 1) = (hi_lo << 32) - hi_lo  < 2^64, no wrap since
    # hi_lo < 2^32 so hi_lo<<32 <= 2^64 - 2^32 and subtracting hi_lo is fine
    t = (hi_lo << np.uint64(32)) - hi_lo
    out = add(lo, t)
    return sub(out, hi_hi)


def mul(a, b):
    """Canonical uint64 modular product via 32-bit limb split."""
    a = _norm(a)
    b = _norm(b)
    a0 = a & MASK32
    a1 = a >> np.uint64(32)
    b0 = b & MASK32
    b1 = b >> np.uint64(32)
    ll = a0 * b0                       # < 2^64
    lh = a0 * b1                       # < 2^64
    hl = a1 * b0
    hh = a1 * b1
    # 128-bit accumulate. mid = lh + hl_lo + ll_hi <= (2^32-1)^2 + 2^33 - 2
    # = 2^64 - 1: never wraps uint64; same bound for hi below.
    mid = lh + (hl & MASK32) + (ll >> np.uint64(32))
    lo = (ll & MASK32) | (mid << np.uint64(32))
    hi = hh + (hl >> np.uint64(32)) + (mid >> np.uint64(32))
    return _reduce128(lo, hi)


def pow_int(a, e: int):
    a = np.asarray(a, np.uint64)
    out = np.full(a.shape, 1, np.uint64) if a.ndim else np.uint64(1)
    base = a
    while e:
        if e & 1:
            out = mul(out, base)
        base = mul(base, base)
        e >>= 1
    return out


def inv(a):
    return pow_int(a, P - 2)


def two_adic_root(log_n: int) -> int:
    """Generator of the order-2^log_n subgroup."""
    if log_n > TWO_ADICITY:
        raise ValueError("domain too large for Goldilocks")
    g = pow(GENERATOR, (P - 1) >> log_n, P)
    return g
