"""Host-side GoldilocksExt2 = F_p[x]/(x^2 - 7): canonical numpy uint64,
shape (..., 2).

Copy of ``ceno_tpu/fields/gl2_host.py`` (reference ff_ext::GoldilocksExt2,
`--field goldilocks`); the torch counterpart is fields/goldilocks_ext2.py.
"""

from __future__ import annotations

import numpy as np

from . import gl_host as gl

W = 7
DEGREE = 2
P = gl.P


def zeros(shape=()):
    return (
        np.zeros(tuple(np.atleast_1d(shape)) + (2,), np.uint64)
        if shape else np.zeros(2, np.uint64)
    )


def one():
    o = np.zeros(2, np.uint64)
    o[0] = 1
    return o


def from_base(x) -> np.ndarray:
    arr = np.asarray(x, np.uint64)
    out = np.zeros(arr.shape + (2,), np.uint64)
    out[..., 0] = arr % np.uint64(P)
    return out


def add(a, b):
    return gl.add(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def sub(a, b):
    return gl.sub(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def neg(a):
    return gl.neg(np.asarray(a, np.uint64))


def mul(a, b):
    """(..., 2) x (..., 2) ext product, broadcasting over leading axes."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    a0, a1 = a[..., 0], a[..., 1]
    b0, b1 = b[..., 0], b[..., 1]
    c0 = gl.add(gl.mul(a0, b0), gl.mul(np.uint64(W), gl.mul(a1, b1)))
    c1 = gl.add(gl.mul(a0, b1), gl.mul(a1, b0))
    return np.stack([c0, c1], axis=-1)


def mul_base(a, s):
    a = np.asarray(a, np.uint64)
    return np.stack(
        [gl.mul(a[..., 0], s), gl.mul(a[..., 1], s)], axis=-1
    )


def inv(a):
    """1 / (a0 + a1 x) = (a0 - a1 x) / (a0^2 - W a1^2)."""
    a = np.asarray(a, np.uint64)
    a0, a1 = a[..., 0], a[..., 1]
    d = gl.sub(gl.mul(a0, a0), gl.mul(np.uint64(W), gl.mul(a1, a1)))
    di = gl.inv(d)
    return np.stack([gl.mul(a0, di), gl.mul(gl.neg(a1), di)], axis=-1)


def eq_eval(x, y):
    """prod_j (x_j y_j + (1-x_j)(1-y_j)) for (n, 2) points."""
    x = np.asarray(x, np.uint64)
    y = np.asarray(y, np.uint64)
    acc = one()
    o = one()
    for j in range(x.shape[0]):
        t = add(mul(x[j], y[j]), mul(sub(o, x[j]), sub(o, y[j])))
        acc = mul(acc, t)
    return acc
