"""Quark-style one-layer EC summation proof over the GL quintic curve.

Counterpart of ``ceno_tpu/gl/eccquark.py``: the GL configuration of
gkr/eccquark.py (reference ``CpuEccProver::create_ecc_proof`` /
``EccVerifier::verify_ecc_proof``, ceno_zkvm scheme/cpu/mod.rs:72-340).
N = 2^n points on the GL multiset-hash curve y^2 = x^3 + x + 13 over
F_p[z]/(z^5 - 3) (fields/gl5_host.py) are accumulated in one zerocheck over
the binary-tree witness layout (x_c, y_c, s_c columns over 2N rows, node b's
output in row N+b, the final sum at row 2N-2).

The constraint groups are the BabyBear quark's, 5 components each; the GL
sumcheck (gl/sumcheck.py) binds the top variable each round with points in
round order, so the extended opening points are
  even-child view  x0: rt ++ [0]
  odd-child view   x1: rt ++ [1]
  second-half view x3: [1] ++ rt
and the analytic selector recursions run over the reversed (LSB-first)
point arrays.

:func:`prove_ec_sum` runs its zerocheck on the witness's device: the 35
base columns (strided views of the tree columns) and the three selector
vectors are tensors there. The tree witness (:func:`build_tree_witness`),
the selector vectors, the analytic selector evaluations and
:func:`verify_ec_sum` stay host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import goldilocks as gld
from ..fields import gl2_host as g2
from ..fields import gl5_host as G5
from . import sumcheck as gsc

DEG = 5  # quintic extension degree

# (i, k) -> list of (component, coeff) from z^i * z^k mod (z^5 - 3)
_MUL_TABLE: list[list[list[tuple[int, int]]]] = []
for _i in range(DEG):
    row = []
    for _k in range(DEG):
        idx = _i + _k
        row.append([(idx, 1)] if idx < DEG else [(idx - DEG, 3)])
    _MUL_TABLE.append(row)


class GlEccError(Exception):
    pass


@dataclass
class GlEccQuarkProof:
    num_instances: int
    n_vars: int              # node-space vars n (chip rows = 2^(n+1))
    round_msgs: np.ndarray   # (n, 4, 2) canonical (degree-3 zerocheck)
    col_evals: np.ndarray    # (35, 2): s, x0, y0, x1, y1, x3, y3 (5 each)
    final_sum: np.ndarray    # (2, 5) canonical affine sum ((0,0) = infinity)


def pair_counts(num_instances: int, n_vars: int) -> list[int]:
    out = []
    cnt = num_instances
    for _ in range(n_vars):
        out.append(cnt // 2)
        cnt = (cnt + 1) // 2
    return out


def build_tree_witness(points_x: np.ndarray, points_y: np.ndarray,
                       n_rows: int):
    """Fill the binary-tree witness from leaf points.

    points_*: (n_pts, 5) canonical; n_rows = 2^(n+1) chip height.
    Returns (x, y, s) of shape (5, n_rows) plus the final sum (2, 5)."""
    n_pts = points_x.shape[0]
    half = n_rows // 2
    assert 1 <= n_pts <= half
    n = half.bit_length() - 1
    x = np.zeros((n_rows, 5), np.uint64)
    y = np.zeros((n_rows, 5), np.uint64)
    s = np.zeros((n_rows, 5), np.uint64)
    x[:n_pts] = points_x
    y[:n_pts] = points_y
    counts = pair_counts(n_pts, n)
    start = 0
    length = half // 2
    for layer in range(n):
        pairs = min(counts[layer], length)
        b = np.arange(start, start + length)
        if pairs:
            ba = b[:pairs]
            x3, y3, lam = G5.point_add_batch(
                x[2 * ba], y[2 * ba], x[2 * ba + 1], y[2 * ba + 1]
            )
            x[half + ba] = x3
            y[half + ba] = y3
            s[half + ba] = lam
        byp = b[pairs:]
        x[half + byp] = x[2 * byp]
        y[half + byp] = y[2 * byp]
        start += length
        length //= 2
    final = np.stack([x[n_rows - 2], y[n_rows - 2]])
    return x.T.copy(), y.T.copy(), s.T.copy(), final


def _selector_vectors(out_rt: np.ndarray, num_instances: int, n: int):
    """(sel_add, sel_bypass, sel_export) (2^n, 2) ext vectors."""
    eqv = gsc.build_eq_host(out_rt)  # (2^n, 2), natural node index
    size = 1 << n
    sel_add = np.zeros_like(eqv)
    sel_bypass = eqv.copy()
    counts = pair_counts(num_instances, n)
    start = 0
    length = size // 2
    layer = 0
    while length > 0:
        pairs = min(counts[layer], length)
        sel_add[start : start + pairs] = eqv[start : start + pairs]
        sel_bypass[start : start + pairs] = 0
        start += length
        length //= 2
        layer += 1
    sel_bypass[size - 1] = 0
    sel_export = np.zeros_like(eqv)
    sel_export[size - 2] = eqv[size - 2]
    return sel_add, sel_bypass, sel_export


def _term_schedule():
    """(alpha_index, base_coeff_sign, base_cols, selector, fsum_ref) table —
    the same schedule shape as the BabyBear quark with DEG = 5; coeffs are
    ints mod gl.P."""
    S0, X0, Y0, X1, Y1, X3, Y3 = (0, 5, 10, 15, 20, 25, 30)
    SEL_ADD, SEL_BYP, SEL_EXP = 0, 1, 2
    sched = []
    ai = [0]

    def alpha():
        a = ai[0]
        ai[0] += 1
        return a

    def t(a, coeff, cols, sel, fsum_ref=None):
        sched.append((a, coeff % gl.P, tuple(cols), sel, fsum_ref))

    neg1 = gl.P - 1
    # add group 1: s*(x0-x1) - (y0-y1), component c
    for c in range(DEG):
        a = alpha()
        for i in range(DEG):
            for k in range(DEG):
                for comp, cf in _MUL_TABLE[i][k]:
                    if comp != c:
                        continue
                    t(a, cf, (S0 + i, X0 + k), SEL_ADD)
                    t(a, cf * neg1, (S0 + i, X1 + k), SEL_ADD)
        t(a, neg1, (Y0 + c,), SEL_ADD)
        t(a, 1, (Y1 + c,), SEL_ADD)
    # add group 2: s^2 - x0 - x1 - x3
    for c in range(DEG):
        a = alpha()
        for i in range(DEG):
            for k in range(DEG):
                for comp, cf in _MUL_TABLE[i][k]:
                    if comp == c:
                        t(a, cf, (S0 + i, S0 + k), SEL_ADD)
        for col in (X0 + c, X1 + c, X3 + c):
            t(a, neg1, (col,), SEL_ADD)
    # add group 3: s*(x0-x3) - (y0+y3)
    for c in range(DEG):
        a = alpha()
        for i in range(DEG):
            for k in range(DEG):
                for comp, cf in _MUL_TABLE[i][k]:
                    if comp != c:
                        continue
                    t(a, cf, (S0 + i, X0 + k), SEL_ADD)
                    t(a, cf * neg1, (S0 + i, X3 + k), SEL_ADD)
        t(a, neg1, (Y0 + c,), SEL_ADD)
        t(a, neg1, (Y3 + c,), SEL_ADD)
    # bypass: x3 - x0, y3 - y0
    for base_out, base_in in ((X3, X0), (Y3, Y0)):
        for c in range(DEG):
            a = alpha()
            t(a, 1, (base_out + c,), SEL_BYP)
            t(a, neg1, (base_in + c,), SEL_BYP)
    # export: x3 - sum.x, y3 - sum.y
    for row, base_out in ((0, X3), (1, Y3)):
        for c in range(DEG):
            a = alpha()
            t(a, 1, (base_out + c,), SEL_EXP)
            t(a, neg1, (), SEL_EXP, (row, c))
    return sched, ai[0]


N_ALPHAS = DEG * 7  # 3 add groups + 2 bypass + 2 export, DEG comps each


def _build_terms(alphas: np.ndarray, final_sum: np.ndarray):
    """gl/sumcheck term tuples over base cols [s(5), x0(5), y0(5), x1(5),
    y1(5), x3(5), y3(5)] and ext cols [sel_add, sel_bypass, sel_export]."""
    sched, n_alpha = _term_schedule()
    assert n_alpha == alphas.shape[0]
    terms = []
    for a, coeff, cols, sel, fref in sched:
        cf = coeff
        if fref is not None:
            cf = cf * int(final_sum[fref[0], fref[1]]) % gl.P
        terms.append(
            (g2.mul_base(alphas[a], np.uint64(cf)), cols, (sel,))
        )
    return terms


def _views(cols: np.ndarray):
    half = cols.shape[1] // 2
    return cols[:, 0::2], cols[:, 1::2], cols[:, half:]


def extended_points(rt: np.ndarray):
    """The three (n+1, 2) opening points in the GL top-first convention."""
    zero = np.zeros((1, 2), np.uint64)
    one = np.zeros((1, 2), np.uint64)
    one[0] = g2.one()
    return {
        "even": np.concatenate([rt, zero]),
        "odd": np.concatenate([rt, one]),
        "half": np.concatenate([one, rt]),
    }


# (point name, [(col_evals offset, chip col base)]): which quark col_evals
# bind to which chip columns (x cols 0..4, y cols 5..9, s cols 10..14) at
# which extended point
EC_POINTS = [
    ("even", [(5, 0), (10, 5)]),     # x0 -> x cols, y0 -> y cols
    ("odd", [(15, 0), (20, 5)]),     # x1, y1
    ("half", [(25, 0), (30, 5), (0, 10)]),  # x3, y3, s
]


def prove_ec_sum(x, y, s, num_instances: int, final_sum, transcript,
                 device=None):
    """x/y/s: (5, 2N) canonical witness columns, int64 tensors (which stay
    on their device) or numpy (which goes to ``device``, the card when
    None). Returns (proof, rt)."""
    if not isinstance(x, torch.Tensor):
        dev = "cuda" if device is None else device
        x, y, s = (gld.to_device(np.asarray(c, np.uint64), dev) for c in (x, y, s))
    n_rows = x.shape[1]
    n = (n_rows // 2).bit_length() - 1
    out_rt = transcript.sample_exts(n)
    alphas = transcript.sample_ext_pows(N_ALPHAS)
    sel_add, sel_byp, sel_exp = _selector_vectors(out_rt, num_instances, n)
    x0, x1, x3 = _views(x)
    y0, y1, y3 = _views(y)
    _, _, s3 = _views(s)
    base_cols = (
        [s3[c] for c in range(DEG)]
        + [x0[c] for c in range(DEG)]
        + [y0[c] for c in range(DEG)]
        + [x1[c] for c in range(DEG)]
        + [y1[c] for c in range(DEG)]
        + [x3[c] for c in range(DEG)]
        + [y3[c] for c in range(DEG)]
    )
    terms = _build_terms(alphas, np.asarray(final_sum, np.uint64))
    out = gsc.prove(base_cols, [sel_add, sel_byp, sel_exp], terms, n,
                    transcript, device=x.device)
    transcript.append(out.final_base.ravel())
    proof = GlEccQuarkProof(
        num_instances, n, out.round_msgs, out.final_base,
        np.asarray(final_sum, np.uint64),
    )
    return proof, out.point


def _sel_add_eval(out_rt_l, rt_l, num_instances: int, n: int):
    """Analytic QuarkBinaryTreeLessThan evaluation over LSB-first points."""
    one = g2.one()
    seq = pair_counts(num_instances, n)[::-1]  # top layer first
    if seq[0] == 0:
        res = np.zeros(2, np.uint64)
    else:
        res = g2.mul(g2.sub(one, out_rt_l[0]), g2.sub(one, rt_l[0]))
    for i in range(1, n):
        m = seq[i]
        if m == 0:
            lhs = np.zeros(2, np.uint64)
        else:
            lhs = g2.mul(
                g2.mul(g2.sub(one, out_rt_l[i]), g2.sub(one, rt_l[i])),
                _sel_eq_eval_gl(out_rt_l[:i], rt_l[:i], m),
            )
        rhs = g2.mul(g2.mul(out_rt_l[i], rt_l[i]), res)
        res = g2.add(lhs, rhs)
    return res


def _sel_eq_eval_gl(out_pt_l, pt_l, k: int):
    """sum_{b<k} eq(out_pt, b) eq(pt, b) over LSB-first partial points —
    exact GL-ext2 mirror of gkr/chip.sel_eq_eval (incl. the free-lower-bit
    products ``lower[j]``)."""
    n = out_pt_l.shape[0]
    one = g2.one()
    a = [
        g2.add(
            g2.mul(out_pt_l[j], pt_l[j]),
            g2.mul(g2.sub(one, out_pt_l[j]), g2.sub(one, pt_l[j])),
        )
        for j in range(n)
    ]
    if k >= (1 << n):
        acc = one
        for v in a:
            acc = g2.mul(acc, v)
        return acc
    lower = [one]
    for j in range(n):
        lower.append(g2.mul(lower[-1], a[j]))  # lower[j] = prod_{l<j} a_l
    result = np.zeros(2, np.uint64)
    prefix = one
    for j in range(n - 1, -1, -1):
        b0 = g2.mul(g2.sub(one, out_pt_l[j]), g2.sub(one, pt_l[j]))
        b1 = g2.mul(out_pt_l[j], pt_l[j])
        if (k >> j) & 1:
            result = g2.add(result, g2.mul(g2.mul(prefix, b0), lower[j]))
            prefix = g2.mul(prefix, b1)
        else:
            prefix = g2.mul(prefix, b0)
    return result


def _onehot_eval(point_topfirst, bits_lsb):
    """eq(point, fixed index) for an LSB-first bit vector, point top-first."""
    one = g2.one()
    n = point_topfirst.shape[0]
    acc = one
    for j, b in enumerate(bits_lsb):
        pj = point_topfirst[n - 1 - j]
        acc = g2.mul(acc, pj if b else g2.sub(one, pj))
    return acc


def verify_ec_sum(proof: GlEccQuarkProof, final_sum, transcript):
    """Replays the zerocheck; returns (rt, col_evals) for the PCS stage."""
    n = proof.n_vars
    if not (1 <= proof.num_instances <= (1 << n)):
        raise GlEccError("num_instances out of range")
    if not np.array_equal(
        np.asarray(proof.final_sum, np.uint64) % np.uint64(gl.P),
        np.asarray(final_sum, np.uint64) % np.uint64(gl.P),
    ):
        raise GlEccError("final sum does not match public values")
    out_rt = transcript.sample_exts(n)
    alphas = transcript.sample_ext_pows(N_ALPHAS)
    rt, final_claim = gsc.verify(
        np.zeros(2, np.uint64), proof.round_msgs, n, transcript, deg=3
    )
    transcript.append(np.asarray(proof.col_evals, np.uint64).ravel())
    rt = rt.astype(np.uint64)

    # analytic selector evaluations over LSB-first reversals
    out_l = out_rt[::-1].copy()
    rt_l = rt[::-1].copy()
    sel_add = _sel_add_eval(out_l, rt_l, proof.num_instances, n)
    ones_eval = _onehot_eval(rt, [1] * n)
    out_ones = _onehot_eval(out_rt, [1] * n)
    sel_byp = g2.sub(
        g2.sub(_eq_eval_points(out_rt, rt), sel_add),
        g2.mul(out_ones, ones_eval),
    )
    lsi = [0] + [1] * (n - 1)
    sel_exp = g2.mul(_onehot_eval(out_rt, lsi), _onehot_eval(rt, lsi))

    evals = np.asarray(proof.col_evals, np.uint64)
    if evals.shape != (7 * DEG, 2):
        raise GlEccError("bad col_evals shape")
    sel_vals = [sel_add, sel_byp, sel_exp]
    terms = _build_terms(alphas, np.asarray(final_sum, np.uint64))
    acc = np.zeros(2, np.uint64)
    for scalar, bidx, eidx in terms:
        v = np.asarray(scalar, np.uint64)
        for c in bidx:
            v = g2.mul(v, evals[c])
        v = g2.mul(v, sel_vals[eidx[0]])
        acc = g2.add(acc, v)
    if not np.array_equal(acc, final_claim):
        raise GlEccError("ec zerocheck recombination mismatch")
    return rt, evals


def _eq_eval_points(a, b):
    one = g2.one()
    acc = one
    for j in range(a.shape[0]):
        acc = g2.mul(
            acc,
            g2.add(g2.mul(a[j], b[j]),
                   g2.mul(g2.sub(one, a[j]), g2.sub(one, b[j]))),
        )
    return acc
