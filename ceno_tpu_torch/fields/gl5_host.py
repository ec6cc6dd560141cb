"""Goldilocks quintic extension F_p[z]/(z^5 - 3) and the GL multiset-hash
curve y^2 = x^3 + x + 13.

Copy of ``ceno_tpu/fields/gl5_host.py``: every cross-shard RAM token of a GL
shard hashes to a point on this curve over F_p[z]/(z^5 - 3), the read/write
direction is encoded in the sign half of y[4], and the per-shard EC sums
must cancel to infinity across shards (the GL counterpart of
fields/septic.py). The curve is a subfield curve (A, B in F_p) whose quintic
order has a 212-bit prime factor (~2^106 Pollard-rho collision security).

The curve constants and the Frobenius tables ``Z_POW_P`` / ``Z_POW_P2``
(z^{i p} and z^{i p^2} mod z^5 - 3) are copied as literals, not re-derived;
tests/test_torch_gl5.py holds the tables against their derivation. All
arithmetic is host numpy: elements are canonical uint64 arrays of shape
(..., 5) (batch axes leading) over fields/gl_host.py lanes; the witness
generation (hash-to-curve per token, the EC tree) and the verifier's
stitching sum run here.
"""

from __future__ import annotations

import numpy as np

from . import gl_host as gl

P = gl.P
_P = np.uint64(P)
DEGREE = 5

# curve y^2 = x^3 + A x + B (both base-field scalars; see module docstring)
A_COEFF = 1
B_COEFF = 13
# #E(F_p^5) = CURVE_ORDER = CURVE_COFACTOR * CURVE_PRIME (pinned by
# tools/find_gl5_curve.py: first (A, B) in lex order whose quintic order has
# a >= 200-bit probable-prime factor; the 212-bit prime gives ~2^106
# Pollard-rho collision security)
TRACE_FP = -5911154094  # t with #E(F_p) = p + 1 - t
CURVE_ORDER = 2135987033434293902082969833143585405490115481160768109285760545488257033408576968401793148617776
CURVE_PRIME = 4871665646826851765346027659815077121191727348468792769432326921
CURVE_COFACTOR = 438451073674476029054923383406256
assert CURVE_COFACTOR * CURVE_PRIME == CURVE_ORDER


# z^{i*p} mod (z^5 - 3), i = 0..4: diagonal, since p = 1 mod 5
Z_POW_P = np.array([
    [1, 0, 0, 0, 0],
    [0, 1041288259238279555, 0, 0, 0],
    [0, 0, 15820824984080659046, 0, 0],
    [0, 0, 0, 211587555138949697, 0],
    [0, 0, 0, 0, 1373043270956696022],
], np.uint64)
# z^{i*p^2} mod (z^5 - 3)
Z_POW_P2 = np.array([
    [1, 0, 0, 0, 0],
    [0, 15820824984080659046, 0, 0, 0],
    [0, 0, 1373043270956696022, 0, 0],
    [0, 0, 0, 1041288259238279555, 0],
    [0, 0, 0, 0, 211587555138949697],
], np.uint64)


# ---------------------------------------------------------------------------
# Field ops (batched canonical numpy, shape (..., 5))
# ---------------------------------------------------------------------------

def zeros(shape=()):
    return np.zeros(tuple(shape) + (5,), np.uint64)


def one(shape=()):
    out = zeros(shape)
    out[..., 0] = 1
    return out


def from_base(v):
    v = np.asarray(v, np.uint64) % _P
    out = np.zeros(v.shape + (5,), np.uint64)
    out[..., 0] = v
    return out


def add(a, b):
    return gl.add(a, b)


def sub(a, b):
    return gl.sub(a, b)


def neg(a):
    return gl.neg(a)


def mul(a, b):
    """Schoolbook product with z^5 = 3 reduction."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    c = np.zeros(shape + (9,), np.uint64)
    for i in range(5):
        for j in range(5):
            c[..., i + j] = gl.add(c[..., i + j], gl.mul(a[..., i], b[..., j]))
    for k in range(8, 4, -1):
        hi = c[..., k]
        c[..., k - 5] = gl.add(c[..., k - 5], gl.mul(np.uint64(3), hi))
    return np.ascontiguousarray(c[..., :5])


def mul_base(a, s):
    s = np.asarray(s, np.uint64) % _P
    return gl.mul(a, s[..., None])


def square(a):
    return mul(a, a)


def pow_int(a, e: int):
    result = one(np.shape(a)[:-1])
    acc = np.asarray(a, np.uint64)
    while e > 0:
        if e & 1:
            result = mul(result, acc)
        e >>= 1
        if e:
            acc = mul(acc, acc)
    return result


def _pow_base(v, e: int):
    result = np.ones(np.shape(v), np.uint64)
    acc = np.asarray(v, np.uint64) % _P
    while e > 0:
        if e & 1:
            result = gl.mul(result, acc)
        e >>= 1
        if e:
            acc = gl.mul(acc, acc)
    return result


def _frob(a, table):
    a = np.asarray(a, np.uint64) % _P
    out = np.zeros(a.shape, np.uint64)
    for i in range(5):
        out = gl.add(out, gl.mul(a[..., i : i + 1], table[i]))
    return out


def frobenius(a):
    """a^p = sum_i a_i * z^{i*p}."""
    return _frob(a, Z_POW_P)


def double_frobenius(a):
    """a^(p^2)."""
    return _frob(a, Z_POW_P2)


def norm_sub(a):
    """a^(p + p^2 + p^3 + p^4)."""
    x1 = frobenius(a)          # a^p
    x2 = double_frobenius(a)   # a^{p^2}
    x3 = double_frobenius(x1)  # a^{p^3}
    x4 = double_frobenius(x2)  # a^{p^4}
    return mul(mul(x1, x2), mul(x3, x4))


def norm(a):
    """a^(1 + p + ... + p^4) in F_p (the field norm)."""
    return mul(norm_sub(a), a)[..., 0]


def is_square(a):
    """Euler criterion via the norm: a^((p^5-1)/2) = norm(a)^((p-1)/2)."""
    n = norm(a)
    leg = _pow_base(n, (P - 1) // 2)
    return (leg == 1) | (n == 0)


def inv(a):
    """a^{-1} = norm(a)^{-1} * a^(p + p^2 + p^3 + p^4)."""
    x = norm_sub(a)
    nrm = mul(a, x)[..., 0]
    nrm_inv = _pow_base(nrm, P - 2)
    return mul_base(x, nrm_inv)


def sqrt(a):
    """Batched Cipolla sqrt (structure of septic_curve.rs:289-345, quintic
    frobenius chain). Returns (root, ok): ok[i] False where a[i] is a
    non-residue (root entries there are 0)."""
    a = np.asarray(a, np.uint64) % _P
    batch = a.shape[:-1]
    nrm = norm(a)
    leg = _pow_base(nrm, (P - 1) // 2)
    ok = (leg == 1) | np.all(a == 0, axis=-1)

    # d = a^((p^4+p^3+p^2+p)/2) * a ; with x^2 = 1/norm, (d*x)^2 = a
    n_power = pow_int(a, (P + 1) // 2)          # a^((p+1)/2)
    n_frob = frobenius(n_power)                 # a^((p^2+p)/2)
    denominator = n_frob
    n_frob = double_frobenius(n_frob)           # a^((p^4+p^3)/2)
    denominator = mul(denominator, n_frob)
    denominator = mul(denominator, a)

    base = _pow_base(nrm, P - 2)  # norm^{-1} (0 -> 0)
    g = np.uint64(gl.GENERATOR)   # GL multiplicative generator: non-residue
    av = np.ones(batch, np.uint64)
    non_residue = gl.sub(gl.mul(av, av), base)
    # per-element a with a^2 - 1/norm a non-residue
    for _ in range(64):
        legr = _pow_base(non_residue, (P - 1) // 2)
        unfinished = (legr == 1) & ok
        if not unfinished.any():
            break
        av = np.where(unfinished, gl.mul(av, g), av)
        non_residue = np.where(
            unfinished, gl.sub(gl.mul(av, av), base), non_residue
        )
    else:
        raise RuntimeError("cipolla: no quadratic non-residue found")

    # x = (a + i)^((p+1)/2) in F_p[i]/(i^2 - non_residue); x^2 = 1/norm
    real = av.copy()
    imag = np.ones(batch, np.uint64)
    rr, ri = np.ones(batch, np.uint64), np.zeros(batch, np.uint64)
    e = (P + 1) // 2
    bits = []
    while e:
        bits.append(e & 1)
        e >>= 1
    for bit in reversed(bits):
        rr, ri = (
            gl.add(gl.mul(rr, rr), gl.mul(non_residue, gl.mul(ri, ri))),
            gl.mul(np.uint64(2), gl.mul(rr, ri)),
        )
        if bit:
            rr, ri = (
                gl.add(gl.mul(rr, real), gl.mul(non_residue, gl.mul(ri, imag))),
                gl.add(gl.mul(rr, imag), gl.mul(ri, real)),
            )
    root = mul_base(denominator, rr)
    root = np.where(ok[..., None], root, np.uint64(0))
    return root, ok


# ---------------------------------------------------------------------------
# Curve ops: y^2 = x^3 + A x + B (affine, infinity = (0, 0))
# ---------------------------------------------------------------------------

def curve_rhs(x):
    """x^3 + A x + B."""
    x3 = mul(square(x), x)
    out = add(x3, mul_base(x, np.full(np.shape(x)[:-1], A_COEFF, np.uint64)))
    out[..., 0] = gl.add(out[..., 0], np.uint64(B_COEFF))
    return out


def from_x(x):
    """(y, ok): one square root of the curve RHS per batch element."""
    return sqrt(curve_rhs(x))


def is_on_curve(x, y):
    return np.all(square(y) == curve_rhs(x), axis=-1)


def is_infinity(x, y):
    return np.all(x == 0, axis=-1) & np.all(y == 0, axis=-1)


def point_neg(x, y):
    return x, np.where(is_infinity(x, y)[..., None], y, neg(y))


def point_add_batch(x1, y1, x2, y2):
    """Batched affine addition for DISTINCT x (the EC-tree hot path).

    Raises if any pair shares an x coordinate without being the infinity
    bypass — multiset-hash points are hash-derived, so x collisions are
    negligible and indicate a bookkeeping bug. Infinity operands
    short-circuit. Returns (x3, y3, slope)."""
    inf1 = is_infinity(x1, y1)
    inf2 = is_infinity(x2, y2)
    dx = sub(x2, x1)
    deg_mask = np.all(dx == 0, axis=-1) & ~inf1 & ~inf2
    if deg_mask.any():
        raise ValueError("point_add_batch: equal x coordinates")
    safe_dx = np.where((inf1 | inf2)[..., None], one(dx.shape[:-1]), dx)
    lam = mul(sub(y2, y1), inv(safe_dx))
    x3 = sub(sub(square(lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    x3 = np.where(inf1[..., None], x2, np.where(inf2[..., None], x1, x3))
    y3 = np.where(inf1[..., None], y2, np.where(inf2[..., None], y1, y3))
    lam = np.where((inf1 | inf2)[..., None], np.uint64(0), lam)
    return x3, y3, lam


def point_add(p1, p2):
    """General single-point addition (host stitching verifier): p = (x, y)
    arrays of shape (5,); handles infinity, doubling, and inverse pairs."""
    x1, y1 = p1
    x2, y2 = p2
    if is_infinity(x1, y1):
        return (x2.copy(), y2.copy())
    if is_infinity(x2, y2):
        return (x1.copy(), y1.copy())
    if np.array_equal(x1, x2):
        if np.array_equal(y1, y2):
            # double: slope = (3x^2 + A) / (2y)
            num = add(
                mul_base(square(x1), np.uint64(3)),
                from_base(np.uint64(A_COEFF)),
            )
            lam = mul(num, inv(add(y1, y1)))
            x3 = sub(sub(square(lam), x1), x1)
            y3 = sub(mul(lam, sub(x1, x3)), y1)
            return (x3, y3)
        return (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(square(lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    return (x3, y3)
