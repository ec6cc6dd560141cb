"""Quark-style one-layer EC summation proof for the cross-shard multiset hash.

Role mirror of the reference's ``CpuEccProver::create_ecc_proof`` /
``EccVerifier::verify_ecc_proof`` (ceno_zkvm scheme/cpu/mod.rs:72-340,
scheme/verifier.rs:1714 — SURVEY.md §2.2/§3.2): N = 2^n EC points (septic
extension, curve y^2 = x^3 + 2x + 26 z^5) are accumulated in ONE zerocheck
over a binary-tree witness layout, following the Quark paper's trick:

  columns x_c, y_c, s_c (c = 0..6) over 2N rows; leaves in rows [0, N);
  node b's output in row N+b with children in rows 2b, 2b+1; the final sum
  sits at row 2N-2 (node index N-2 = [0,1,...,1] LSB-first).

Constraint groups over the node space b in [0, N) (views of the columns:
x[b,0] = even rows, x[b,1] = odd rows, x[1,b] = second half):
  sel_add    * [ s*(x0-x1) - (y0-y1);  s^2 - x0 - x1 - x3;
                 s*(x0-x3) - (y0+y3) ]     (affine addition, distinct x)
  sel_bypass * [ x3 - x0;  y3 - y0 ]       (odd leftovers + padding copy-up)
  sel_export * [ x3 - sum.x;  y3 - sum.y ] (bind row 2N-2 to the public sum)

sel_add is the reference's QuarkBinaryTreeLessThan selector (prefix of active
addition pairs per tree layer), evaluated analytically by the verifier via
the same recursion as gkr_iop/src/selector.rs:419-456; sel_bypass =
eq - sel_add - onehot(last); sel_export is a one-hot at [0,1,..,1].

The 49 column-view evaluations at the zerocheck point rt reduce to PCS
opening claims on the committed x/y/s columns at three extended points:
[0]++rt (even view), [1]++rt (odd view), rt++[1] (second-half view).

Counterpart of ``ceno_tpu/gkr/eccquark.py``, with the same relative imports.
The tree witness, the selectors and the verifier are host numpy, as in the
reference; ``prove_ec_sum`` runs its zerocheck through the port's
``sumcheck.prover.prove`` on ``device`` (the card unless the caller names
another), fused by default, with no host route. The reference's replay
waiver in ``verify_ec_sum`` (``utils.replay``, aggregation) is left out: the
port's verifier always checks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..fields import septic as S
from ..hash.transcript import Transcript
from ..sumcheck import prover as sc_prover
from ..sumcheck import verifier as sc_verifier
from ..sumcheck import host_impl as H
from ..sumcheck.prover import TermSpec
from .chip import sel_eq_eval

DEG = 7  # septic extension degree

# (i, k) -> list of (component, coeff) from z^i * z^k mod (z^7 - 2z - 5)
_MUL_TABLE: list[list[list[tuple[int, int]]]] = []
for _i in range(DEG):
    row = []
    for _k in range(DEG):
        idx = _i + _k
        if idx < DEG:
            row.append([(idx, 1)])
        else:
            row.append([(idx - DEG, 5), (idx - DEG + 1, 2)])
    _MUL_TABLE.append(row)


class EccError(Exception):
    pass


@dataclass
class EccQuarkProof:
    num_instances: int
    n_vars: int              # node-space vars n (chip rows = 2^(n+1))
    round_msgs: np.ndarray   # (n, 4, 4) canonical (degree-3 zerocheck)
    col_evals: np.ndarray    # (49, 4): s, x0, y0, x1, y1, x3, y3 (7 each)
    final_sum: np.ndarray    # (2, 7) canonical affine sum ((0,0) = infinity)


def pair_counts(num_instances: int, n_vars: int) -> list[int]:
    """Active addition pairs per tree layer (leaves first) — the reference's
    num_instances_sequence scan (selector.rs:197-206)."""
    out = []
    cnt = num_instances
    for _ in range(n_vars):
        out.append(cnt // 2)
        cnt = (cnt + 1) // 2
    return out


def build_tree_witness(points_x: np.ndarray, points_y: np.ndarray, n_rows: int):
    """Fill the binary-tree witness from leaf points.

    points_*: (n_pts, 7) canonical; n_rows = 2^(n+1) chip height.
    Returns (x, y, s) arrays of shape (7, n_rows) plus the final sum (2, 7)."""
    n_pts = points_x.shape[0]
    half = n_rows // 2
    assert n_pts <= half and n_pts >= 1
    n = half.bit_length() - 1
    x = np.zeros((n_rows, 7), np.uint64)
    y = np.zeros((n_rows, 7), np.uint64)
    s = np.zeros((n_rows, 7), np.uint64)
    x[:n_pts] = points_x
    y[:n_pts] = points_y
    counts = pair_counts(n_pts, n)
    start = 0
    length = half // 2
    for layer in range(n):
        pairs = min(counts[layer], length)
        b = np.arange(start, start + length)
        # addition region [start, start+pairs): out = add(child0, child1)
        if pairs:
            ba = b[:pairs]
            x3, y3, lam = S.point_add_batch(
                x[2 * ba], y[2 * ba], x[2 * ba + 1], y[2 * ba + 1]
            )
            x[half + ba] = x3
            y[half + ba] = y3
            s[half + ba] = lam
        # bypass region: out = child0
        bb_ = b[pairs:]
        x[half + bb_] = x[2 * bb_]
        y[half + bb_] = y[2 * bb_]
        start += length
        length //= 2
    final = np.stack([x[n_rows - 2], y[n_rows - 2]])
    return x.T.copy(), y.T.copy(), s.T.copy(), final


def _selector_vectors(out_rt: np.ndarray, num_instances: int, n: int):
    """(sel_add, sel_bypass, sel_export) host ext vectors of length 2^n."""
    eqv = H.build_eq_host(out_rt)  # (2^n, 4)
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
    """The batched-constraint term table as pure STRUCTURE:
    (alpha_index, base_coeff, base_cols, selector, fsum_ref) — fsum_ref is
    (row, c) for the export constants, whose scalar is
    alphas[ai] * coeff * final_sum[row][c]. _build_terms materializes
    TermSpecs from this; the recursion EC-verify chips consume it as key
    schedule (gkr/ec_verify.py)."""
    S0, X0, Y0, X1, Y1, X3, Y3 = (0, 7, 14, 21, 28, 35, 42)
    SEL_ADD, SEL_BYP, SEL_EXP = 0, 1, 2
    sched = []
    ai = [0]

    def alpha():
        a = ai[0]
        ai[0] += 1
        return a

    def t(a, coeff, cols, sel, fsum_ref=None):
        sched.append((a, coeff % bb.P, tuple(cols), sel, fsum_ref))

    neg1 = bb.P - 1
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


def _build_terms(alphas: np.ndarray, final_sum: np.ndarray):
    """TermSpec list over base cols [s(7), x0(7), y0(7), x1(7), y1(7),
    x3(7), y3(7)] and ext cols [sel_add, sel_bypass, sel_export]."""
    sched, n_alpha = _term_schedule()
    assert n_alpha == alphas.shape[0]
    terms: list[TermSpec] = []
    for a, coeff, cols, sel, fref in sched:
        cf = coeff
        if fref is not None:
            cf = cf * int(final_sum[fref[0], fref[1]]) % bb.P
        terms.append(TermSpec(exth.mul_base(alphas[a], np.uint64(cf)),
                              bidx=cols, eidx=(sel,)))
    return terms


def _views(cols: np.ndarray):
    """(7, 2N) column matrix -> even / odd / second-half views, (7, N) each."""
    half = cols.shape[1] // 2
    return cols[:, 0::2], cols[:, 1::2], cols[:, half:]


def prove_ec_sum(
    x: np.ndarray,  # (7, 2N) canonical witness columns
    y: np.ndarray,
    s: np.ndarray,
    num_instances: int,
    final_sum: np.ndarray,  # (2, 7)
    transcript: Transcript,
    device=None,
):
    """The zerocheck over the tree witness on ``device`` (the card by
    default). Returns (proof, the sumcheck's point rt, LSB-first), the point
    at which the verifier binds the column views to the PCS openings."""
    device = device or DEFAULT_DEVICE
    n_rows = x.shape[1]
    n = (n_rows // 2).bit_length() - 1
    out_rt = transcript.sample_exts(n)
    alphas = transcript.sample_ext_pows(DEG * 3 + DEG * 2 + DEG * 2)
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
    terms = _build_terms(alphas, final_sum)
    base = bb.to_device(np.stack(base_cols), device)
    ext = bb.to_device(np.stack([sel_add.T, sel_byp.T, sel_exp.T], axis=1), device)
    out = sc_prover.prove(list(base), [ext], terms, n, transcript)
    transcript.append(out.final_base.ravel())
    proof = EccQuarkProof(
        num_instances, n, out.proof.round_msgs, out.final_base,
        np.asarray(final_sum, np.uint64),
    )
    return proof, out.point


def _sel_add_eval(out_rt, rt, num_instances: int, n: int):
    """Analytic QuarkBinaryTreeLessThan evaluation (selector.rs:419-456)."""
    one = exth.one()
    seq = pair_counts(num_instances, n)[::-1]  # top layer first
    if seq[0] == 0:
        res = np.zeros(4, np.uint64)
    else:
        res = exth.mul(exth.sub(one, out_rt[0]), exth.sub(one, rt[0]))
    for i in range(1, n):
        m = seq[i]
        if m == 0:
            lhs = np.zeros(4, np.uint64)
        else:
            lhs = exth.mul(
                exth.mul(exth.sub(one, out_rt[i]), exth.sub(one, rt[i])),
                sel_eq_eval(out_rt[:i], rt[:i], m),
            )
        rhs = exth.mul(exth.mul(out_rt[i], rt[i]), res)
        res = exth.add(lhs, rhs)
    return res


def _onehot_eval(point, index_bits):
    """eq(point, fixed index) for an LSB-first bit vector."""
    one = exth.one()
    acc = one
    for j, b in enumerate(index_bits):
        pj = point[j].astype(np.uint64)
        acc = exth.mul(acc, pj if b else exth.sub(one, pj))
    return acc


def verify_ec_sum(
    proof: EccQuarkProof,
    final_sum: np.ndarray,
    transcript: Transcript,
):
    """Replays the zerocheck; returns (rt, col_evals) for the PCS stage.

    col_evals order: s, x0, y0, x1, y1, x3, y3 (7 each) at rt — to be bound
    against the committed columns at [0]++rt / [1]++rt / rt++[1]."""
    n = proof.n_vars
    if not (1 <= proof.num_instances <= (1 << n)):
        raise EccError("num_instances out of range")
    from ..utils import replay

    _chk = not replay.structure_only()
    if _chk and not np.array_equal(
        np.asarray(proof.final_sum, np.uint64) % np.uint64(bb.P),
        np.asarray(final_sum, np.uint64) % np.uint64(bb.P),
    ):
        raise EccError("final sum does not match public values")
    out_rt = transcript.sample_exts(n)
    alphas = transcript.sample_ext_pows(DEG * 7)
    rt, final_claim = sc_verifier.verify(
        np.zeros(4, np.uint64), proof.round_msgs, n, transcript, deg=3
    )
    transcript.append(np.asarray(proof.col_evals, np.uint64).ravel())
    rt = rt.astype(np.uint64)

    # analytic selector evaluations (rt is LSB-first, matching the prover's
    # eq-vector index convention)
    sel_add = _sel_add_eval(out_rt, rt, proof.num_instances, n)
    ones_eval = _onehot_eval(rt, [1] * n)
    out_ones = _onehot_eval(out_rt, [1] * n)
    sel_byp = exth.sub(
        exth.sub(exth.eq_eval(out_rt.astype(np.uint64), rt.astype(np.uint64)), sel_add),
        exth.mul(out_ones, ones_eval),
    )
    lsi = [0] + [1] * (n - 1)
    sel_exp = exth.mul(_onehot_eval(out_rt, lsi), _onehot_eval(rt, lsi))

    # recombine the batched expression at rt
    evals = np.asarray(proof.col_evals, np.uint64)
    sel_vals = [sel_add, sel_byp, sel_exp]
    terms = _build_terms(alphas, np.asarray(final_sum, np.uint64))
    acc = np.zeros(4, np.uint64)
    for t in terms:
        v = np.asarray(t.scalar, np.uint64)
        for c in t.bidx:
            v = exth.mul(v, evals[c])
        v = exth.mul(v, sel_vals[t.eidx[0]])
        acc = exth.add(acc, v)
    if _chk and not np.array_equal(acc, final_claim):
        raise EccError("ec zerocheck recombination mismatch")
    return rt, evals
