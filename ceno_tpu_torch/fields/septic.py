"""BabyBear septic extension F_p[z]/(z^7 - 2z - 5) and the multiset-hash curve.

Parameter-set mirror of the reference's ``SepticExtension``/``SepticPoint``
(ceno_zkvm/src/scheme/septic_curve.rs:45-1140 — SURVEY.md §2.3), used for the
cross-shard RAM multiset hash: every cross-shard RAM token hashes to a point
on   y^2 = x^3 + 2x + 26 z^5   over F_p[z]/(z^7 - 2z - 5)  (cofactor 1, prime
order of ~31*7 bits per the reference), read/write direction encoded in the
sign half of y[6], and the per-shard EC sums must cancel to infinity across
shards.  The z^{i*p} / z^{i*p^2} Frobenius tables below are the reference's
public parameter constants (septic_curve.rs:104-167, derived by the sage
scripts quoted there); sqrt is Cipolla's algorithm exactly as
septic_curve.rs:289-345.

All arithmetic is host-side numpy: elements are canonical uint64 arrays of
shape (..., 7) (batch axes leading), products are reduced mod p pairwise so
uint64 never overflows. Witness generation (hash-to-curve per token, EC tree
build) and the verifier's stitching sum both live here; the in-circuit
mirrors are zkvm/chips/shard_ram.py.

Copy of ``ceno_tpu/fields/septic.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import numpy as np

from . import babybear as bb

P = np.uint64(bb.P)
DEGREE = 7

# curve: y^2 = x^3 + A*x + B, A = 2 (base scalar), B = 26 z^5
A_COEFF = 2
B_POLY = np.array([0, 0, 0, 0, 0, 26, 0], np.uint64)

# z^{i*p} mod (z^7 - 2z - 5), i = 0..6 (septic_curve.rs:104-133)
Z_POW_P = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0],
        [954599710, 1359279693, 566669999, 1982781815, 1735718361, 1174868538, 1120871770],
        [862825265, 597046311, 978840770, 1790138282, 1044777201, 835869808, 1342179023],
        [596273169, 658837454, 1515468261, 367059247, 781278880, 1544222616, 155490465],
        [557608863, 1173670028, 1749546888, 1086464137, 803900099, 1288818584, 1184677604],
        [763416381, 1252567168, 628856225, 1771903394, 650712211, 19417363, 57990258],
        [1734711039, 1749813853, 1227235221, 1707730636, 424560395, 1007029514, 498034669],
    ],
    np.uint64,
)

# z^{i*p^2} mod (z^7 - 2z - 5), i = 0..6 (septic_curve.rs:138-167)
Z_POW_P2 = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0],
        [1013489358, 1619071628, 304593143, 1949397349, 1564307636, 327761151, 415430835],
        [209824426, 1313900768, 38410482, 256593180, 1708830551, 1244995038, 1555324019],
        [1475628651, 777565847, 704492386, 1218528120, 1245363405, 475884575, 649166061],
        [550038364, 948935655, 68722023, 1251345762, 1692456177, 1177958698, 350232928],
        [882720258, 821925756, 199955840, 812002876, 1484951277, 1063138035, 491712810],
        [738287111, 1955364991, 552724293, 1175775744, 341623997, 1454022463, 408193320],
    ],
    np.uint64,
)


# ---------------------------------------------------------------------------
# Field ops (batched canonical numpy, shape (..., 7))
# ---------------------------------------------------------------------------

def zeros(shape=()):
    return np.zeros(tuple(shape) + (7,), np.uint64)


def one(shape=()):
    out = zeros(shape)
    out[..., 0] = 1
    return out


def from_base(v):
    v = np.asarray(v, np.uint64) % P
    out = np.zeros(v.shape + (7,), np.uint64)
    out[..., 0] = v
    return out


def add(a, b):
    return (a + b) % P


def sub(a, b):
    return (a + P - b % P) % P


def neg(a):
    return (P - a % P) % P


def mul(a, b):
    """Schoolbook product with z^7 = 2z + 5 reduction."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    shape = np.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    c = np.zeros(shape + (13,), np.uint64)
    for i in range(7):
        for j in range(7):
            c[..., i + j] = (c[..., i + j] + a[..., i] * b[..., j] % P) % P
    for k in range(12, 6, -1):
        hi = c[..., k]
        c[..., k - 7] = (c[..., k - 7] + 5 * hi) % P
        c[..., k - 6] = (c[..., k - 6] + 2 * hi) % P
    return np.ascontiguousarray(c[..., :7])


def mul_base(a, s):
    s = np.asarray(s, np.uint64) % P
    return a * s[..., None] % P


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
    """Batched base-field pow: v (...,) canonical, fixed int exponent."""
    result = np.ones(np.shape(v), np.uint64)
    acc = np.asarray(v, np.uint64) % P
    while e > 0:
        if e & 1:
            result = result * acc % P
        e >>= 1
        if e:
            acc = acc * acc % P
    return result


def frobenius(a):
    """a^p = sum_i a_i * z^{i*p} (septic_curve.rs:170-178)."""
    return _frob(a, Z_POW_P)


def _frob(a, table):
    a = np.asarray(a, np.uint64) % P
    out = np.zeros(a.shape, np.uint64)
    for i in range(7):
        out = (out + a[..., i : i + 1] * table[i] % P) % P
    return out


def double_frobenius(a):
    """a^(p^2)."""
    return _frob(a, Z_POW_P2)


def norm_sub(a):
    """a^(p + p^2 + ... + p^6) (septic_curve.rs:193-199)."""
    x = mul(frobenius(a), double_frobenius(a))
    y = double_frobenius(x)
    z = double_frobenius(y)
    return mul(mul(x, y), z)


def norm(a):
    """a^(1 + p + ... + p^6) in F_p (the field norm)."""
    return mul(norm_sub(a), a)[..., 0]


def is_square(a):
    """Euler criterion via the norm: a^((p^7-1)/2) = norm(a)^((p-1)/2)."""
    n = norm(a)
    leg = _pow_base(n, (bb.P - 1) // 2)
    return (leg == 1) | (n == 0)


def inv(a):
    """a^{-1} = norm(a)^{-1} * a^(p + ... + p^6) (septic_curve.rs:219-230)."""
    x = norm_sub(a)
    nrm = mul(a, x)[..., 0]
    nrm_inv = _pow_base(nrm, bb.P - 2)
    return mul_base(x, nrm_inv)


def sqrt(a):
    """Batched Cipolla sqrt (septic_curve.rs:289-345). Returns (root, ok):
    ok[i] False where a[i] is a non-residue (root entries there are 0)."""
    a = np.asarray(a, np.uint64) % P
    batch = a.shape[:-1]
    nrm = norm(a)
    leg = _pow_base(nrm, (bb.P - 1) // 2)
    ok = (leg == 1) | np.all(a == 0, axis=-1)

    # n^((p+1)/2), then d = n^((p^6+p^5+...+p)/2) * n so that (x*d)^2 = n
    n_power = pow_int(a, (bb.P + 1) // 2)
    n_frob = frobenius(n_power)
    denominator = n_frob
    n_frob = double_frobenius(n_frob)
    denominator = mul(denominator, n_frob)
    n_frob = double_frobenius(n_frob)
    denominator = mul(denominator, n_frob)
    denominator = mul(denominator, a)

    base = _pow_base(nrm, bb.P - 2)  # norm^{-1} (0 -> 0)
    g = 31  # BabyBear multiplicative generator (p3 BabyBear GENERATOR)
    av = np.ones(batch, np.uint64)
    non_residue = (av * av % P + P - base) % P
    # find per-element a with a^2 - 1/norm a non-residue
    for _ in range(64):
        legr = _pow_base(non_residue, (bb.P - 1) // 2)
        unfinished = (legr == 1) & ok
        if not unfinished.any():
            break
        av = np.where(unfinished, av * np.uint64(g) % P, av)
        non_residue = np.where(unfinished, (av * av % P + P - base) % P, non_residue)
    else:
        raise RuntimeError("cipolla: no quadratic non-residue found")

    # x = (a + i)^((p+1)/2) in F_p[i]/(i^2 - non_residue); x^2 = 1/norm
    real = av.copy()
    imag = np.ones(batch, np.uint64)
    rr, ri = np.ones(batch, np.uint64), np.zeros(batch, np.uint64)
    e = (bb.P + 1) // 2
    bits = []
    while e:
        bits.append(e & 1)
        e >>= 1
    for bit in reversed(bits):
        rr, ri = (
            (rr * rr % P + non_residue * (ri * ri % P) % P) % P,
            2 * (rr * ri % P) % P,
        )
        if bit:
            rr, ri = (
                (rr * real % P + non_residue * (ri * imag % P) % P) % P,
                (rr * imag % P + ri * real % P) % P,
            )
    root = mul_base(denominator, rr)
    root = np.where(ok[..., None], root, np.uint64(0))
    return root, ok


# ---------------------------------------------------------------------------
# Curve ops: y^2 = x^3 + 2x + 26 z^5 (affine, infinity = (0, 0))
# ---------------------------------------------------------------------------

def curve_rhs(x):
    """x^3 + 2x + B."""
    x3 = mul(square(x), x)
    return add(add(x3, mul_base(x, np.full(np.shape(x)[:-1], 2, np.uint64))), B_POLY)


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
    bypass — the multiset-hash points are hash-derived, so x collisions are
    negligible and indicate a bookkeeping bug. Infinity operands short-circuit.
    Returns (x3, y3, slope)."""
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
    arrays of shape (7,); handles infinity, doubling, and inverse pairs."""
    x1, y1 = p1
    x2, y2 = p2
    if is_infinity(x1, y1):
        return (x2.copy(), y2.copy())
    if is_infinity(x2, y2):
        return (x1.copy(), y1.copy())
    if np.array_equal(x1, x2):
        if np.array_equal(y1, y2):
            # double: slope = (3x^2 + 2) / (2y)
            num = add(mul_base(square(x1), np.uint64(3)), from_base(np.uint64(2)))
            lam = mul(num, inv(add(y1, y1)))
            x3 = sub(sub(square(lam), x1), x1)
            y3 = sub(mul(lam, sub(x1, x3)), y1)
            return (x3, y3)
        return (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    lam = mul(sub(y2, y1), inv(sub(x2, x1)))
    x3 = sub(sub(square(lam), x1), x2)
    y3 = sub(mul(lam, sub(x1, x3)), y1)
    return (x3, y3)
