"""Port parity: BabyBear and ext4 in ceno_tpu_torch against ceno_tpu.fields.

Inputs come from numpy; both packages get the same canonical values and every
result is compared exactly, on random arrays and on the edge values 0, 1 and
p - 1.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.fields import ext4 as rext
from ceno_tpu.fields import ext4_host as rexth
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.fields import ext4
from ceno_tpu_torch.fields import ext4_host as exth

torch.set_num_threads(1)
P = rbb.P
EDGES = np.array([0, 1, P - 1], np.uint64)


def _base(seed, n=61):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, P, size=n, dtype=np.uint64)])


def _ext(seed, n=61):
    rng = np.random.default_rng(seed)
    edges = np.stack([np.repeat(EDGES, 3), np.tile(EDGES, 3), np.zeros(9, np.uint64),
                      np.full(9, P - 1, np.uint64)])
    return np.concatenate([edges, rng.integers(0, P, size=(4, n), dtype=np.uint64)], axis=1)


def _ref(f, *xs):
    """Run a reference device op on canonical inputs; canonical result."""
    args = [jnp.asarray(rbb.np_to_monty(x)) for x in xs]
    return rbb.np_from_monty(np.asarray(f(*args))).astype(np.uint64)


def _port(f, *xs):
    return bb.to_host(f(*[bb.to_device(x, "cpu") for x in xs]))


def test_constants_match_reference():
    assert (bb.P, bb.R, bb.R2, bb.PINV, bb.GENERATOR) == (P, rbb.R, rbb.R2, rbb.PINV, rbb.GENERATOR)
    assert bb.MONTY_ONE == rbb.MONTY_ONE
    assert ext4.W == rext.W and ext4.FROB == rext.FROB and ext4.FROB_MONTY == rext.FROB_MONTY
    for bits in (0, 1, 5, 22, 27):
        assert bb.two_adic_root(bits) == rbb.two_adic_root(bits)


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_base_binary_ops(op):
    a, b = _base(1), _base(2)
    a, b = np.concatenate([a, np.repeat(EDGES, 3)]), np.concatenate([b, np.tile(EDGES, 3)])
    np.testing.assert_array_equal(_port(getattr(bb, op), a, b), _ref(getattr(rbb, op), a, b))


@pytest.mark.parametrize("op", ["neg", "double", "inv", "square"])
def test_base_unary_ops(op):
    a = _base(3)
    if op == "inv":
        a = a[a != 0]
    if op == "square":
        np.testing.assert_array_equal(
            _port(lambda x: bb.pow_const(x, 2), a), _ref(lambda x: rbb.pow_const(x, 2), a))
        return
    np.testing.assert_array_equal(_port(getattr(bb, op), a), _ref(getattr(rbb, op), a))


def test_monty_conversions_and_sum():
    a = _base(4, n=297)
    dev = bb.to_device(a, "cpu")
    np.testing.assert_array_equal(dev.numpy().astype(np.uint32), rbb.np_to_monty(a))
    got_monty = bb.to_monty(torch.from_numpy(a.astype(np.int64)))
    want_monty = np.asarray(rbb.to_monty(jnp.asarray(a.astype(np.uint32))))
    np.testing.assert_array_equal(got_monty.numpy().astype(np.uint32), want_monty)
    np.testing.assert_array_equal(
        bb.from_monty(got_monty).numpy().astype(np.uint32),
        np.asarray(rbb.from_monty(jnp.asarray(want_monty))))
    np.testing.assert_array_equal(bb.np_from_monty(bb.np_to_monty(a)), rbb.np_from_monty(rbb.np_to_monty(a)))
    x = a.reshape(3, 100)  # 3 edges + 297 random
    np.testing.assert_array_equal(_port(lambda t: bb.sum_mod(t, axis=1), x),
                                  _ref(lambda t: rbb.sum_mod(t, axis=1), x))
    assert int(bb.mul_const(bb.to_device(a, "cpu"), bb.const(7))[5]) == int(
        rbb.mul_const(jnp.asarray(rbb.np_to_monty(a)), rbb.const(7))[5])


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ext_binary_ops(op):
    a, b = _ext(5), _ext(6)
    np.testing.assert_array_equal(_port(getattr(ext4, op), a, b), _ref(getattr(rext, op), a, b))


def test_ext_unary_ops():
    a = _ext(7)
    s = _base(8, n=a.shape[1] - 3)
    np.testing.assert_array_equal(_port(ext4.mul_base, a, s), _ref(rext.mul_base, a, s))
    np.testing.assert_array_equal(_port(ext4.square, a), _ref(rext.square, a))
    np.testing.assert_array_equal(_port(ext4.neg, a), _ref(rext.neg, a))
    for k in range(4):
        np.testing.assert_array_equal(_port(lambda x: ext4.frobenius(x, k), a),
                                      _ref(lambda x: rext.frobenius(x, k), a))
    nz = a[:, a.any(axis=0)]
    np.testing.assert_array_equal(_port(ext4.inv, nz), _ref(rext.inv, nz))
    one = _port(lambda x: ext4.mul(x, ext4.inv(x)), nz)
    np.testing.assert_array_equal(one, np.tile(np.array([[1], [0], [0], [0]], np.uint64), nz.shape[1]))


@pytest.mark.parametrize("fill", ["random", 0, 1, P - 1])
def test_ext_host_mul_single_equals_broadcast_path(fill):
    # two (4,) elements take the Python-int path, (..., 4) arrays the numpy one
    rng = np.random.default_rng(12)
    a = rng.integers(0, P, size=(6, 4), dtype=np.uint64) if fill == "random" else \
        np.full((6, 4), fill, np.uint64)
    b = rng.integers(0, P, size=(6, 4), dtype=np.uint64)
    want = exth.mul(a, b)
    for i in range(a.shape[0]):
        np.testing.assert_array_equal(exth.mul(a[i], b[i]), want[i])
        np.testing.assert_array_equal(exth.mul(b[i], a[i]), want[i])
    np.testing.assert_array_equal(exth.mul(a[0], b), exth.mul(a[:1], b))


def test_ext_host_mirror_and_py_mul():
    rng = np.random.default_rng(9)
    a = rng.integers(0, P, size=(20, 4), dtype=np.uint64)
    b = rng.integers(0, P, size=(20, 4), dtype=np.uint64)
    s = rng.integers(0, P, size=20, dtype=np.uint64)
    for name in ("add", "sub", "mul"):
        np.testing.assert_array_equal(getattr(exth, name)(a, b), getattr(rexth, name)(a, b))
    np.testing.assert_array_equal(exth.neg(a), rexth.neg(a))
    np.testing.assert_array_equal(exth.mul_base(a, s), rexth.mul_base(a, s))
    np.testing.assert_array_equal(exth.inv(a), rexth.inv(a))
    np.testing.assert_array_equal(exth.pow_int(a[0], 12345), rexth.pow_int(a[0], 12345))
    np.testing.assert_array_equal(exth.eq_eval(a[:5], b[:5]), rexth.eq_eval(a[:5], b[:5]))
    np.testing.assert_array_equal(exth.dot(a, b), rexth.dot(a, b))
    for k in range(4):
        np.testing.assert_array_equal(exth.frobenius(a, k), rexth.frobenius(a, k))
    x, y = tuple(int(v) for v in a[1]), tuple(int(v) for v in b[1])
    assert ext4.py_mul(x, y) == rext.py_mul(x, y)
    # torch ext mul agrees with the host mirror (component-leading vs trailing)
    np.testing.assert_array_equal(_port(ext4.mul, a.T, b.T).T, exth.mul(a, b))
