"""MockProver: row-by-row constraint debugging on host.

Role mirror of the reference's ``MockProver`` (ceno_zkvm scheme/mock_prover.rs:
351, SURVEY.md §2.3/§4): evaluates every named zero constraint over the
assigned witness with exact numpy arithmetic and reports the failing rows and
values; additionally balances read/write record multisets and lookup
multiplicities across a set of chips. This is the workhorse harness for
developing opcode circuits — run it before any real proving.

Copy of ``ceno_tpu/gkr/mock.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..mle import expression as E
from .chip import CompiledChip, structural_table

_P = np.uint64(bb.P)


def eval_expr_host(expr, wit, fixed, structural, instances, challenges, memo=None):
    """Evaluate over canonical host banks -> ('b', (N,)) or ('e', (N, 4))."""
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    if isinstance(expr, E.Wit):
        out = ("b", wit[expr.idx])
    elif isinstance(expr, E.Fix):
        out = ("b", fixed[expr.idx])
    elif isinstance(expr, E.Structural):
        out = ("b", structural[expr.idx])
    elif isinstance(expr, E.Const):
        out = ("b", np.uint64(expr.value))
    elif isinstance(expr, E.ExtConst):
        out = ("e", np.array(expr.value, np.uint64))
    elif isinstance(expr, E.Challenge):
        out = ("e", np.asarray(challenges[expr.cid], np.uint64))
    elif isinstance(expr, E.ChallengePow):
        out = ("e", exth.pow_int(np.asarray(challenges[expr.cid], np.uint64), expr.power))
    elif isinstance(expr, E.Instance):
        out = ("b", np.uint64(int(instances[expr.idx]) % bb.P))
    elif isinstance(expr, E.Neg):
        k, v = eval_expr_host(expr.inner, wit, fixed, structural, instances, challenges, memo)
        out = (k, (_P - v % _P) % _P)
    elif isinstance(expr, E.Sum):
        k, v = eval_expr_host(expr.terms[0], wit, fixed, structural, instances, challenges, memo)
        for t in expr.terms[1:]:
            k2, v2 = eval_expr_host(t, wit, fixed, structural, instances, challenges, memo)
            k, v = _add(k, v, k2, v2)
        out = (k, v)
    elif isinstance(expr, E.Prod):
        k, v = eval_expr_host(expr.factors[0], wit, fixed, structural, instances, challenges, memo)
        for f in expr.factors[1:]:
            k2, v2 = eval_expr_host(f, wit, fixed, structural, instances, challenges, memo)
            k, v = _mul(k, v, k2, v2)
        out = (k, v)
    else:
        raise TypeError(type(expr))
    memo[key] = out
    return out


def _to_e(v):
    v = np.atleast_1d(np.asarray(v, np.uint64))
    out = np.zeros(v.shape + (4,), np.uint64)
    out[..., 0] = v
    return out


def _add(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", (v1 + v2) % _P
    a = _to_e(v1) if k1 == "b" else np.atleast_2d(v1)
    b = _to_e(v2) if k2 == "b" else np.atleast_2d(v2)
    return "e", exth.add(a, b)


def _mul(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", v1 * v2 % _P
    if k1 == "b":
        return "e", exth.mul_base(np.atleast_2d(v2), v1)
    if k2 == "b":
        return "e", exth.mul_base(np.atleast_2d(v1), v2)
    return "e", exth.mul(np.atleast_2d(v1), np.atleast_2d(v2))


@dataclass
class MockError:
    chip: str
    constraint: str
    row: int
    value: tuple


class MockProver:
    """Evaluate constraints + balance records for a set of assigned chips."""

    @staticmethod
    def assert_satisfied(
        chips: list,  # list of (CompiledChip, cb, wit (W,N) canonical, fixed, instances, num_instances)
        raise_on_error: bool = True,
    ):
        errors = []
        reads, writes = Counter(), Counter()
        lk_used, lk_provided = Counter(), Counter()
        # mock challenges: small fixed values make record multisets comparable
        chal = np.array([[5, 7, 11, 13], [17, 19, 23, 29]], np.uint64)
        for compiled, cb, wit, fixed, instances, k in chips:
            n = wit.shape[1] if compiled.n_wit else 1
            structural = np.stack(
                [structural_table(s, n, instances) for s in compiled.structural]
            ) if compiled.structural else np.zeros((0, n), np.uint64)
            memo = {}
            for name, expr in cb.zeros:
                kind, v = eval_expr_host(expr, wit, fixed, structural, instances, chal, memo)
                v = np.atleast_1d(np.asarray(v, np.uint64))
                if kind == "b":
                    bad = np.nonzero(v[:k])[0] if v.ndim else ([0] if v else [])
                else:
                    bad = np.nonzero(v[:k].any(axis=-1))[0]
                for row in bad[:5]:
                    val = v[row] if v.ndim else v
                    errors.append(
                        MockError(compiled.name, name, int(row), tuple(np.atleast_1d(val).ravel()))
                    )
            def bump(counter, rec, mults=None):
                _, v = eval_expr_host(rec, wit, fixed, structural, instances, chal, memo)
                v = np.atleast_2d(np.asarray(v, np.uint64))
                if v.shape[0] == 1:
                    v = np.broadcast_to(v, (n, v.shape[1]))
                v = v[:k]
                if mults is None:
                    uniq, cnt = np.unique(v, axis=0, return_counts=True)
                    for row, c in zip(uniq, cnt):
                        counter[tuple(row)] += int(c)
                else:
                    nz = np.nonzero(mults[:k])[0]
                    for row in nz:
                        counter[tuple(v[row])] += int(mults[row])

            for rec in cb.r_records:
                bump(reads, rec)
            for rec in cb.w_records:
                bump(writes, rec)
            for rec in cb.lk_records:
                bump(lk_used, rec)
            for mult, rec in cb.lk_table:
                km, mv = eval_expr_host(mult, wit, fixed, structural, instances, chal, memo)
                mv = np.broadcast_to(np.atleast_1d(np.asarray(mv, np.uint64)), (n,))
                bump(lk_provided, rec, mults=mv)
        if reads != writes:
            diff = (reads - writes) + (writes - reads)
            errors.append(MockError("<global>", "read/write multiset", -1, tuple(list(diff)[:2])))
        if lk_used != lk_provided:
            diff = (lk_used - lk_provided) + (lk_provided - lk_used)
            errors.append(MockError("<global>", "lookup multiplicity", -1, tuple(list(diff)[:2])))
        if errors and raise_on_error:
            lines = [f"{e.chip}/{e.constraint} row {e.row}: {e.value}" for e in errors[:20]]
            raise AssertionError("MockProver failures:\n" + "\n".join(lines))
        return errors
