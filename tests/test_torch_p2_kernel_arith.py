"""The integer steps of the Poseidon2 core in csrc/poseidon2_merkle.cu, on the CPU.

No CUDA runs here, so each step the kernels take is transcribed into Python
integers with the kernel's 32-bit wraps made explicit (``& M32``): the modular
add as min(s, s - p), the reduction of [0, 2p), the subtractive Montgomery
REDC in its canonical and lazy forms, the S-box with x^4 and x^6 left in
[0, 2p), the 11-addition M4, and the internal rounds that keep st[1..15] in
[0, 2p) and carry their sum as sum(products) + 15 s. Each step is held against
exact modular arithmetic and its stated output range, on boundary operands
and seeded random ones; the whole permutation, built from the steps in the
kernel's order, against the port's ``permute_canonical`` and the reference's
``permute_host``. All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from ceno_tpu.hash import poseidon2 as rp2
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2 as p2

P = bb.P
M32 = 0xFFFFFFFF
R = 1 << 32
RINV = pow(R, -1, P)
PINV_POS = pow(P, -1, R)  # the source's PINV_POS
MONTY_15 = bb.const(15)   # the source's MONTY_15
RC_EXT = [[int(v) for v in row] for row in p2.RC_EXTERNAL_M]
RC_INT = [int(v) for v in p2.RC_INTERNAL_M]
DIAG = [int(v) for v in p2.DIAG_M]

BOUNDARY = [0, 1, P - 2, P - 1]
LAZY_BOUNDARY = BOUNDARY + [P, P + 1, 2 * P - 2, 2 * P - 1]  # [0, 2p)


# --- the kernel's steps, 32-bit words --------------------------------------

def add(a, b):
    s = (a + b) & M32
    return min(s, (s - P) & M32)


def dbl(a):
    return add(a, a)


def reduce(a):
    return min(a, (a - P) & M32)


def _redc(a, b):
    t = a * b  # IMAD.WIDE: the full 64-bit product
    m = (t & M32) * PINV_POS & M32
    return ((t >> 32) - (m * P >> 32)) & M32  # hi(a*b) - __umulhi(m, P), in (-p, p)


def mmul_lazy(a, b):
    return (_redc(a, b) + P) & M32


def mmul(a, b):
    r = _redc(a, b)
    return min(r, (r + P) & M32)


def sbox(x):
    x2 = mmul(x, x)
    x4 = mmul_lazy(x2, x2)
    x6 = mmul_lazy(x4, x2)
    return mmul(x6, x)


def mat4(x):
    t01 = add(x[0], x[1])
    t23 = add(x[2], x[3])
    t0123 = add(t01, t23)
    t01123 = add(t0123, x[1])
    t01233 = add(t0123, x[3])
    return [add(t01123, t01), add(t01123, dbl(x[2])),
            add(t01233, t23), add(t01233, dbl(x[0]))]


def external_linear(st):
    st = [v for b in range(4) for v in mat4(st[4 * b:4 * b + 4])]
    for j in range(4):
        t = add(add(st[j], st[4 + j]), add(st[8 + j], st[12 + j]))
        for b in range(4):
            st[4 * b + j] = add(st[4 * b + j], t)
    return st


def external_round(st, r):
    return external_linear([sbox(add(v, RC_EXT[r][i])) for i, v in enumerate(st)])


def internal_round(st, rest, r):
    x = sbox(add(st[0], RC_INT[r]))
    s = add(x, rest)
    out = [add(mmul(x, DIAG[0]), s)]
    prod = [mmul(st[i], DIAG[i]) for i in range(1, 16)]
    out += [(v + s) & M32 for v in prod]
    a = add(add(prod[0], prod[1]), add(prod[2], prod[3]))
    b = add(add(prod[4], prod[5]), add(prod[6], prod[7]))
    c = add(add(prod[8], prod[9]), add(prod[10], prod[11]))
    d = add(add(prod[12], prod[13]), prod[14])
    return out, add(add(add(a, b), add(c, d)), mmul(s, MONTY_15))


def permute(st, check_ranges=False):
    """The kernel's permute on 16 Montgomery words in [0, p)."""
    st = external_linear(list(st))
    for r in range(4):
        st = external_round(st, r)
    rest = st[1]
    for v in st[2:]:
        rest = add(rest, v)
    for r in range(13):
        st, rest = internal_round(st, rest, r)
        if check_ranges:
            assert st[0] < P and rest < P and all(v < 2 * P for v in st)
            assert rest == sum(v for v in st[1:]) % P
    st = [st[0]] + [reduce(v) for v in st[1:]]
    for r in range(4, 8):
        st = external_round(st, r)
    return st


# --- each step against exact arithmetic -------------------------------------

def _pairs(lhs, rhs, seed, n=2000, hi_a=P, hi_b=P):
    rng = np.random.default_rng(seed)
    pairs = [(a, b) for a in lhs for b in rhs]
    pairs += zip(rng.integers(0, hi_a, n).tolist(), rng.integers(0, hi_b, n).tolist())
    return pairs


def test_field_constants():
    assert P * PINV_POS % R == 1
    assert (PINV_POS + bb.PINV) % R == 0
    assert MONTY_15 * RINV % P == 15
    assert 2 * P < R < 3 * P  # two reduced values add without a wrap, three may not
    assert 2 * P * P < P * R  # a [0, 2p) operand times a [0, p) one fits the REDC


def test_add():
    for a, b in _pairs(BOUNDARY, BOUNDARY, 1):
        got = add(a, b)
        assert got == (a + b) % P and 0 <= got < P, (a, b)


def test_reduce():
    rng = np.random.default_rng(2)
    for a in LAZY_BOUNDARY + rng.integers(0, 2 * P, 2000).tolist():
        assert reduce(a) == a % P, a


@pytest.mark.parametrize("lazy", [False, True], ids=["canonical", "lazy"])
@pytest.mark.parametrize("b_range", ["p", "2p", "2^32"])
def test_montgomery_product(lazy, b_range):
    """a in [0, p) times b in [0, p), [0, 2p) or [0, 2^32): a*b < p*2^32, so
    the REDC is exact; mmul gives [0, p), mmul_lazy (0, 2p)."""
    hi_b = {"p": P, "2p": 2 * P, "2^32": R}[b_range]
    rhs = [b for b in LAZY_BOUNDARY + [R - 2, R - 1] if b < hi_b]
    fn = mmul_lazy if lazy else mmul
    for a, b in _pairs(BOUNDARY, rhs, 3, hi_b=hi_b):
        got = fn(a, b)
        assert got % P == a * b * RINV % P, (a, b)
        assert (0 < got < 2 * P) if lazy else (0 <= got < P), (a, b)


def test_lazy_times_canonical_commutes():
    """The kernel's lazy operand sits on either side (x4 * x2, x6 * x)."""
    for a, b in _pairs(LAZY_BOUNDARY, BOUNDARY, 4, hi_a=2 * P):
        assert mmul(a, b) == mmul(b, a) == a * b * RINV % P, (a, b)
        assert mmul_lazy(a, b) % P == a * b * RINV % P and mmul_lazy(a, b) < 2 * P


def test_sbox_is_x7():
    rng = np.random.default_rng(5)
    for x in BOUNDARY + rng.integers(0, P, 2000).tolist():
        c = x * RINV % P  # canonical value of the Montgomery word x
        assert sbox(x) == bb.const(pow(c, 7, P)), x


def test_mat4_and_external_linear():
    rng = np.random.default_rng(6)
    m4 = np.array([[2, 3, 1, 1], [1, 2, 3, 1], [1, 1, 2, 3], [3, 1, 1, 2]], dtype=object)
    for x in [[P - 1] * 4, [0, P - 1, 0, P - 1]] + rng.integers(0, P, (200, 4)).tolist():
        assert mat4(x) == [int(v) % P for v in m4.dot(np.array(x, dtype=object))]
    for st in [[P - 1] * 16] + rng.integers(0, P, (50, 16)).tolist():
        want = p2._h_external_linear(np.array(st, np.uint64))  # linear: same map on words
        assert external_linear(st) == want.tolist()


def test_internal_lazy_state_stays_in_range():
    """The largest lazy word, prod + s with both p - 1, is below 2p and takes
    no wrap; a diagonal product on it is exact."""
    assert (P - 1) + (P - 1) < 2 * P <= R
    for d in DIAG:
        assert mmul(2 * P - 2, d) == (2 * P - 2) * d * RINV % P


# --- the whole permutation ---------------------------------------------------

def _states():
    rng = np.random.default_rng(7)
    return {
        "zeros": np.zeros(16, np.uint64),
        "all_p-1": np.full(16, P - 1, np.uint64),
        "alternating": np.array([0, P - 1] * 8, np.uint64),
        "boundary": np.array(BOUNDARY * 4, np.uint64),
        "seeded0": rng.integers(0, P, 16, dtype=np.uint64),
        "seeded1": rng.integers(0, P, 16, dtype=np.uint64),
        "seeded2": rng.integers(0, P, 16, dtype=np.uint64),
    }


@pytest.mark.parametrize("name", list(_states()))
def test_permutation_in_kernel_order(name):
    canonical = _states()[name]
    words = [bb.const(int(v)) for v in canonical]
    got = [v * RINV % P for v in permute(words, check_ranges=True)]
    assert all(v < P for v in permute(words))
    st = torch.from_numpy(canonical.astype(np.int64))[:, None]
    assert got == p2.permute_canonical(st)[:, 0].tolist()
    assert got == rp2.permute_host(canonical).tolist()


@pytest.mark.parametrize("name", ["all_p-1", "alternating"])
def test_permutation_on_raw_edge_words(name):
    """The words p - 1 and 0 as the kernel reads them (Montgomery words, not
    canonical values), as chip_smoke feeds them to K1 and K2."""
    words = _states()[name].tolist()
    canonical = np.array([v * RINV % P for v in words], np.uint64)
    got = [v * RINV % P for v in permute(words, check_ranges=True)]
    assert got == rp2.permute_host(canonical).tolist()
