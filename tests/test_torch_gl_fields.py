"""The port's Goldilocks fields (fields/goldilocks.py, goldilocks_ext2.py on
torch tensors; the host copies gl_host.py, gl2_host.py), its Poseidon2-GL
(gl/poseidon2.py: numpy, single-state Python ints, torch) and its GL
transcript, held against the reference's host modules on seeded and edge
values. All comparisons are exact."""

import numpy as np
import pytest
import torch

from ceno_tpu.fields import gl2_host as rg2
from ceno_tpu.fields import gl_host as rgl
from ceno_tpu.gl import poseidon2 as rp2
from ceno_tpu.gl.transcript import GlTranscript as RefTranscript
from ceno_tpu_torch.fields import gl2_host as g2
from ceno_tpu_torch.fields import gl_host as gl
from ceno_tpu_torch.fields import goldilocks as gld
from ceno_tpu_torch.fields import goldilocks_ext2 as gx
from ceno_tpu_torch.gl import poseidon2 as p2
from ceno_tpu_torch.gl import transcript as gtr

torch.set_num_threads(1)
P = gld.P
EDGES = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, P - (1 << 32), (1 << 63) - 1,
         1 << 63, (1 << 63) + 1, (1 << 64) - (1 << 33)]


def _pairs(seed: int, n: int = 500) -> tuple:
    """Seeded values crossed with every edge value, and edge x edge."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, P, size=n, dtype=np.uint64)
    e = np.array(EDGES, np.uint64)
    a = np.concatenate([np.repeat(r, len(e)), np.repeat(e, len(e)), r])
    b = np.concatenate([np.tile(e, n), np.tile(e, len(e)), rng.permutation(r)])
    return a, b


def _t(x):
    return gld.to_device(x, "cpu")


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_base_binary_ops_match_gl_host(op):
    a, b = _pairs(1)
    want = getattr(rgl, op)(a, b)
    assert np.array_equal(gld.to_host(getattr(gld, op)(_t(a), _t(b))), want)
    assert np.array_equal(getattr(gl, op)(a, b), want)


def test_base_unary_ops_and_sums_match_gl_host():
    a, _ = _pairs(2, 200)
    assert np.array_equal(gld.to_host(gld.neg(_t(a))), rgl.neg(a))
    assert np.array_equal(gld.to_host(gld.inv(_t(a[:64]))), rgl.inv(a[:64]))
    assert np.array_equal(gld.to_host(gld.pow_const(_t(a[:64]), 7)), rgl.pow_int(a[:64], 7))
    assert int(gld.to_host(gld.sum_mod(_t(a), 0))) == sum(int(x) for x in a) % P
    full = gld.full((1 << 12,), P - 1, "cpu")
    assert int(gld.to_host(gld.sum_mod(full, 0))) == (P - 1) * (1 << 12) % P
    for log_n in (1, 5, 12):
        w = gld.two_adic_root(log_n)
        assert w == rgl.two_adic_root(log_n)
        assert gld.to_host(gld.powers(w, 1 << log_n, "cpu")).tolist() == \
            [pow(w, k, P) for k in range(1 << log_n)]


def test_canon_takes_any_bit_pattern():
    x = np.array([0, 1, P - 1, P, P + 1, (1 << 64) - 1, 1 << 63], np.uint64)
    assert gld.to_host(gld.canon(torch.from_numpy(x.view(np.int64)))).tolist() == \
        [int(v) % P for v in x]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_ext2_binary_ops_match_gl2_host(op):
    a, b = _pairs(3, 200)
    a2, b2 = a.reshape(-1, 2), b.reshape(-1, 2)
    want = getattr(rg2, op)(a2, b2)
    assert np.array_equal(gx.to_host(getattr(gx, op)(_t(a2), _t(b2))), want)
    assert np.array_equal(getattr(g2, op)(a2, b2), want)
    # a (2,) element against a column broadcasts as the host's does
    assert np.array_equal(gx.to_host(getattr(gx, op)(_t(a2[0]), _t(b2))),
                          getattr(rg2, op)(a2[0], b2))


def test_ext2_mul_base_inv_and_from_base_match_gl2_host():
    a, b = _pairs(4, 100)
    a2 = a.reshape(-1, 2)
    s = b[: a2.shape[0]]
    assert np.array_equal(gx.to_host(gx.mul_base(_t(a2), _t(s))), rg2.mul_base(a2, s))
    assert np.array_equal(gx.to_host(gx.inv(_t(a2[:40]))), rg2.inv(a2[:40]))
    assert np.array_equal(gx.to_host(gx.from_base(_t(s))), rg2.from_base(s))
    assert np.array_equal(gx.to_host(gx.neg(_t(a2))), rg2.neg(a2))
    assert np.array_equal(gx.to_host(gx.sum_mod(_t(a2), 0)), _host_sum(a2))
    with pytest.raises(ValueError):
        gx.sum_mod(_t(a2), -1)


def _host_sum(a2: np.ndarray) -> np.ndarray:
    return np.array([sum(int(x) for x in a2[:, i]) % P for i in range(2)], np.uint64)


def test_host_copies_match_reference():
    a, b = _pairs(5, 100)
    for op in ("add", "sub", "mul"):
        assert np.array_equal(getattr(gl, op)(a, b), getattr(rgl, op)(a, b))
    assert np.array_equal(gl.inv(a[:20]), rgl.inv(a[:20]))
    x, y = a[:64].reshape(-1, 2), b[:64].reshape(-1, 2)
    assert np.array_equal(g2.eq_eval(x, y), rg2.eq_eval(x, y))
    assert np.array_equal(g2.inv(x), rg2.inv(x))


def test_poseidon2_tables_are_the_reference_tables():
    assert p2.RC_EXTERNAL == rp2.RC_EXTERNAL
    assert p2.RC_INTERNAL == rp2.RC_INTERNAL
    assert p2.INTERNAL_DIAG == rp2.INTERNAL_DIAG
    assert (p2.WIDTH, p2.RATE, p2.CAPACITY, p2.ROUNDS_F, p2.ROUNDS_P) == \
        (rp2.WIDTH, rp2.RATE, rp2.CAPACITY, rp2.ROUNDS_F, rp2.ROUNDS_P)


def test_single_state_permute_matches_vector_path():
    rng = np.random.default_rng(6)
    st = rng.integers(0, P, size=(8, 12), dtype=np.uint64)
    st[:, 0] = 0
    st[:, 1] = P - 1
    vector = p2.permute_host(st)
    assert np.array_equal(vector, rp2.permute_host(st))
    for i in range(st.shape[1]):
        assert np.array_equal(p2.permute_host(st[:, i]), vector[:, i])
    assert np.array_equal(gld.to_host(p2.permute(_t(st))), vector)
    assert np.array_equal(p2.hash_elements(st[:, 2]), rp2.hash_elements(st[:, 2]))
    assert np.array_equal(p2.compress(st[:4], st[4:]), rp2.compress(st[:4], st[4:]))


def test_transcript_matches_reference():
    rng = np.random.default_rng(7)
    ours, ref = gtr.GlTranscript(b"gl-test/v1"), RefTranscript(b"gl-test/v1")
    for n in (1, 3, 4, 9, 0, 17):
        words = rng.integers(0, P, size=n, dtype=np.uint64)
        ours.append(words)
        ref.append(words)
        assert ours.sample_base() == ref.sample_base()
        assert np.array_equal(ours.sample_ext(), ref.sample_ext())
        assert np.array_equal(ours.sample_ext_pows(5), ref.sample_ext_pows(5))
    assert ours.grind(6) == ref.grind(6)
    assert np.array_equal(ours.state, ref.state)
    assert np.array_equal(ours.sample_exts(3), ref.sample_exts(3))


def test_grind_is_bounded(monkeypatch):
    """The port's grind raises where the reference would loop on: here no
    nonce among the 16 it may try reaches a 24-bit threshold."""
    t = gtr.GlTranscript(b"gl-test/grind")
    monkeypatch.setattr(gtr, "GRIND_SLACK_BITS", -20)
    with pytest.raises(RuntimeError, match="no nonce"):
        t.grind(24)


@pytest.mark.parametrize("seed,threads", [(0, 1), (1, 3), (2, 8)])
def test_native_grind_matches_reference(monkeypatch, seed, threads):
    """The C++ scan (gl/native/poseidon2_gl.cpp) on 1, 3 or 8 threads finds
    the reference's nonce at 10 and 14 bits (the latter past its first
    chunks), from states whose rate is part-filled or full."""
    monkeypatch.setattr(gtr.p2, "GRIND_THREADS", threads)
    words = np.arange(seed, seed + 9 + seed, dtype=np.uint64)
    ours, ref = gtr.GlTranscript(b"gl-test/native"), RefTranscript(b"gl-test/native")
    for bits in (10, 14):
        ours.append(words)
        ref.append(words)
        assert ours.grind(bits) == ref.grind(bits)
        assert np.array_equal(ours.state, ref.state)
        assert ours.sample_base() == ref.sample_base()


def test_single_state_words_past_p():
    """The C++ single-state permutation reduces words at or above p (a
    proof's sibling digests are not checked canonical) as the reference's
    int arithmetic does."""
    from ceno_tpu.gl import poseidon2 as rp2

    words = [2**64 - 1, P, P + 1, 3, 2**63, 0, 7, P - 1]
    assert gtr.p2._permute_one(words) == rp2.permute_host(np.array(words, np.uint64)).tolist()
