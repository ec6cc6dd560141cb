"""Host-side BabyBearExt4 arithmetic: canonical-form numpy uint64, shape (..., 4).

Copy of ``ceno_tpu/fields/ext4_host.py``. The verifiers, the transcript glue
and small prover bookkeeping run on the host; this module gives them exact
field ops. Trailing component axis (host code is not lane-limited).

Cross-checked against the reference and the torch ext4 in
tests/test_torch_fields.py.
"""

from __future__ import annotations

import numpy as np

from . import babybear as bb
from .ext4 import W, FROB

_P = np.uint64(bb.P)


def zeros(shape=()):
    return np.zeros(tuple(np.atleast_1d(shape)) + (4,), np.uint64) if shape else np.zeros(4, np.uint64)


def one():
    v = np.zeros(4, np.uint64)
    v[0] = 1
    return v


def from_base(x) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(x, np.uint64))
    out = np.zeros(arr.shape + (4,), np.uint64)
    out[..., 0] = arr % _P
    return out if np.ndim(x) else out[0]


def add(a, b):
    return (np.asarray(a, np.uint64) + np.asarray(b, np.uint64)) % _P


def sub(a, b):
    return (np.asarray(a, np.uint64) + _P - np.asarray(b, np.uint64) % _P) % _P


def neg(a):
    return (_P - np.asarray(a, np.uint64) % _P) % _P


def mul(a, b):
    """(..., 4) x (..., 4) ext product, broadcasting over leading axes."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    if a.shape == b.shape == (4,):
        # one product (the verifiers' and witness builders' common case) in
        # Python ints: the same values without numpy's per-call cost
        a0, a1, a2, a3 = a.tolist()
        b0, b1, b2, b3 = b.tolist()
        p = int(_P)
        return np.array([
            (a0 * b0 + W * (a1 * b3 + a2 * b2 + a3 * b1)) % p,
            (a0 * b1 + a1 * b0 + W * (a2 * b3 + a3 * b2)) % p,
            (a0 * b2 + a1 * b1 + a2 * b0 + W * (a3 * b3)) % p,
            (a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0) % p,
        ], np.uint64)
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    w = np.uint64(W)
    m = lambda x, y: x * y % _P
    c0 = (m(a0, b0) + w * ((m(a1, b3) + m(a2, b2) + m(a3, b1)) % _P)) % _P
    c1 = (m(a0, b1) + m(a1, b0) + w * ((m(a2, b3) + m(a3, b2)) % _P)) % _P
    c2 = (m(a0, b2) + m(a1, b1) + m(a2, b0) + w * m(a3, b3) % _P) % _P
    c3 = (m(a0, b3) + m(a1, b2) + m(a2, b1) + m(a3, b0)) % _P
    return np.stack([c0, c1, c2, c3], axis=-1)


def mul_base(a, s):
    """Ext (..., 4) times base scalar/array."""
    a = np.asarray(a, np.uint64)
    s = np.asarray(s, np.uint64) % _P
    return a * s[..., None] % _P


def frobenius(a, k: int):
    a = np.asarray(a, np.uint64)
    f = np.array(FROB[k % 4], np.uint64)
    return a * f % _P


def base_inv(x):
    return np.vectorize(lambda v: pow(int(v), bb.P - 2, bb.P), otypes=[np.uint64])(
        np.asarray(x, np.uint64)
    )


def inv(a):
    a = np.asarray(a, np.uint64)
    t = mul(mul(frobenius(a, 1), frobenius(a, 2)), frobenius(a, 3))
    norm = mul(a, t)[..., 0]
    return mul_base(t, base_inv(norm))


def pow_int(a, e: int):
    result = None
    acc = np.asarray(a, np.uint64)
    while e > 0:
        if e & 1:
            result = acc if result is None else mul(result, acc)
        e >>= 1
        if e:
            acc = mul(acc, acc)
    if result is None:
        out = np.zeros(np.asarray(a).shape, np.uint64)
        out[..., 0] = 1
        return out
    return result


def eq_eval(x, y):
    """eq(x, y) = prod_j (x_j y_j + (1-x_j)(1-y_j)) for point lists (n, 4)."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    acc = one()
    for j in range(x.shape[0]):
        t = mul(x[j], y[j])
        u = mul(sub(from_base(1), x[j]), sub(from_base(1), y[j]))
        acc = mul(acc, add(t, u))
    return acc


def dot(coeffs, vals):
    """Sum_i coeffs[i] * vals[i] over leading axis; both (n, 4)."""
    acc = np.zeros(4, np.uint64)
    for i in range(np.asarray(coeffs).shape[0]):
        acc = add(acc, mul(coeffs[i], vals[i]))
    return acc
