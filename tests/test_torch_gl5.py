"""The port's quintic Goldilocks extension and multiset-hash curve
(ceno_tpu_torch/fields/gl5_host.py) against the reference's, case by case as
tests/test_gl5.py runs them: the same numpy-seeded inputs go through both
packages and every result must be equal, and must have the property the
reference test checks. Also the Frobenius tables, which the port copies as
literals, against the reference's derivation, and Cipolla's square root of
zero, which raises in both. All comparisons are exact."""

import numpy as np
import pytest
import torch

from ceno_tpu.fields import gl5_host as R
from ceno_tpu_torch.fields import gl5_host as F

torch.set_num_threads(1)
P = F.P


def rand_elems(rng, n):
    return (rng.integers(0, 1 << 63, (n, 5), dtype=np.uint64) * 2
            + rng.integers(0, 2, (n, 5), dtype=np.uint64)) % np.uint64(P)


def ref_mul(a, b):
    """Python-int schoolbook product, z^5 = 3."""
    out = [0] * 9
    for i in range(5):
        for j in range(5):
            out[i + j] += int(a[i]) * int(b[j])
    for k in range(8, 4, -1):
        out[k - 5] += 3 * out[k]
    return np.array([v % P for v in out[:5]], np.uint64)


def both(name, *args):
    """``name`` through both packages; the results must be equal."""
    got, want = getattr(F, name)(*args), getattr(R, name)(*args)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), name
    else:
        assert np.array_equal(got, want), name
    return got


def curve_point(rng, pkg):
    while True:
        x = rand_elems(rng, 1)
        y, ok = pkg.from_x(x)
        if ok[0]:
            return x[0], y[0]


def test_constants_copied():
    for name in ("P", "DEGREE", "A_COEFF", "B_COEFF", "TRACE_FP", "CURVE_ORDER", "CURVE_PRIME",
                 "CURVE_COFACTOR"):
        assert getattr(F, name) == getattr(R, name), name


def test_frobenius_tables_against_the_derivation():
    for table, e in ((F.Z_POW_P, P), (F.Z_POW_P2, P * P)):
        assert table.dtype == np.uint64
        assert np.array_equal(table, R._z_pow_table(e))
    assert np.array_equal(F.Z_POW_P, R.Z_POW_P) and np.array_equal(F.Z_POW_P2, R.Z_POW_P2)


def test_mul_matches_reference():
    rng = np.random.default_rng(7)
    a, b = rand_elems(rng, 20), rand_elems(rng, 20)
    got = both("mul", a, b)
    for i in range(20):
        assert np.array_equal(got[i], ref_mul(a[i], b[i]))


def test_ring_axioms():
    rng = np.random.default_rng(8)
    a, b, c = rand_elems(rng, 8), rand_elems(rng, 8), rand_elems(rng, 8)
    assert np.array_equal(both("mul", a, b), both("mul", b, a))
    assert np.array_equal(F.mul(F.mul(a, b), c), F.mul(a, F.mul(b, c)))
    assert np.array_equal(F.mul(a, both("add", b, c)), both("add", F.mul(a, b), F.mul(a, c)))
    assert np.array_equal(both("sub", a, b), F.add(a, both("neg", b)))
    assert np.array_equal(F.mul(a, both("one", (8,))), a)
    assert np.array_equal(both("mul_base", a, b[:, 0]), R.mul_base(a, b[:, 0]))
    assert np.array_equal(both("from_base", b[:, 1]), R.from_base(b[:, 1]))
    assert np.array_equal(both("pow_int", a, 12345), R.pow_int(a, 12345))


def test_frobenius_is_pow_p():
    a = rand_elems(np.random.default_rng(9), 4)
    assert np.array_equal(both("frobenius", a), F.pow_int(a, P))
    assert np.array_equal(both("double_frobenius", a), F.pow_int(a, P * P))


def test_norm_lands_in_base_and_inv():
    a = rand_elems(np.random.default_rng(10), 6)
    ns = F.mul(both("norm_sub", a), a)
    assert not ns[..., 1:].any()
    assert np.array_equal(both("norm", a), ns[..., 0])
    assert np.array_equal(F.mul(a, both("inv", a)), F.one((6,)))


def test_sqrt_roundtrip():
    a = rand_elems(np.random.default_rng(11), 16)
    root, ok = both("sqrt", F.square(a))
    assert ok.all()
    same = np.all(root == a, axis=-1) | np.all(root == F.neg(a), axis=-1)
    assert same.all()


def test_is_square_euler():
    sq = F.square(rand_elems(np.random.default_rng(12), 10))
    assert both("is_square", sq).all()
    z = F.zeros((10,))
    z[:, 1] = 1
    cand = F.mul(sq, z)
    _, ok = both("sqrt", cand)
    assert np.array_equal(both("is_square", cand), ok)


def test_sqrt_of_zero_raises_in_both():
    """Cipolla's search for a non-residue a^2 - 1/norm never ends for zero
    (its norm is 0, so every candidate is a square): both packages raise
    after 64 tries (ceno_tpu/fields/gl5_host.py:224, :257)."""
    for pkg in (F, R):
        with pytest.raises(RuntimeError, match="non-residue"):
            pkg.sqrt(pkg.zeros((1,)))


def test_curve_point_from_x_on_curve():
    xs = rand_elems(np.random.default_rng(13), 32)
    y, ok = both("from_x", xs)
    assert ok.any()
    good = np.nonzero(ok)[0]
    assert both("is_on_curve", xs[good], y[good]).all()
    assert np.array_equal(both("curve_rhs", xs), R.curve_rhs(xs))


def test_point_add_group_laws():
    rng = np.random.default_rng(14)
    p1, p2, p3 = (curve_point(rng, F) for _ in range(3))
    s12 = both("point_add", p1, p2)
    s21 = both("point_add", p2, p1)
    assert np.array_equal(s12[0], s21[0]) and np.array_equal(s12[1], s21[1])
    lhs = F.point_add(F.point_add(p1, p2), p3)
    rhs = F.point_add(p1, F.point_add(p2, p3))
    assert np.array_equal(lhs[0], rhs[0]) and np.array_equal(lhs[1], rhs[1])
    negp = both("point_neg", p1[0], p1[1])
    s = both("point_add", p1, negp)
    assert both("is_infinity", s[0][None], s[1][None])[0]
    inf = (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    s = both("point_add", p1, inf)
    assert np.array_equal(s[0], p1[0]) and np.array_equal(s[1], p1[1])
    both("point_add", p1, p1)  # doubling


def _scalar_mul(k, pt):
    acc = (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    dbl = pt
    while k:
        if k & 1:
            acc = F.point_add(acc, dbl)
        dbl = F.point_add(dbl, dbl)
        k >>= 1
    return acc


def test_pinned_group_order_kills_points():
    """CURVE_ORDER * P is infinity and CURVE_PRIME * P is not, through the
    port's point arithmetic (each step of which the tests above hold to the
    reference's)."""
    pt = curve_point(np.random.default_rng(100), F)
    for k, dies in ((F.CURVE_ORDER, True), (F.CURVE_PRIME, False)):
        s = _scalar_mul(k, pt)
        assert bool(F.is_infinity(s[0][None], s[1][None])[0]) == dies


def test_point_add_batch_matches_single():
    rng = np.random.default_rng(15)
    pts = [curve_point(rng, F) for _ in range(6)]
    x1, y1 = np.stack([p[0] for p in pts[:3]]), np.stack([p[1] for p in pts[:3]])
    x2, y2 = np.stack([p[0] for p in pts[3:]]), np.stack([p[1] for p in pts[3:]])
    x3, y3, lam = both("point_add_batch", x1, y1, x2, y2)
    for i in range(3):
        ref = F.point_add((x1[i], y1[i]), (x2[i], y2[i]))
        assert np.array_equal(x3[i], ref[0]) and np.array_equal(y3[i], ref[1])
        assert np.array_equal(F.mul(lam[i], F.sub(x2[i], x1[i])), F.sub(y2[i], y1[i]))
    for pkg in (F, R):  # equal x coordinates: a bookkeeping bug, raised
        with pytest.raises(ValueError):
            pkg.point_add_batch(x1, y1, x1, y2)
