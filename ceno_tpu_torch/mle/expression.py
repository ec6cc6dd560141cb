"""Constraint-expression AST with monomial expansion.

Role mirror of the reference's ``Expression<E>`` (multilinear_extensions crate,
SURVEY.md §2.9) and of ``Layer::main_sumcheck_expression_monomial_terms``
(gkr_iop/src/gkr/layer.rs:112): circuits build expressions over witness/fixed/
structural columns, instance values, and transcript challenges; the prover
expands them ONCE per circuit into monomial terms (scalar x product-of-columns)
that drive the generic term-evaluation kernels in sumcheck/terms.py.

Scalars (challenge/instance/constant subtrees) are evaluated host-side per
proof with fields/ext4_host; column products are evaluated on device.

Copy of ``ceno_tpu/mle/expression.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth

# Column kinds
WIT = "w"
FIXED = "f"
STRUCTURAL = "s"

ColRef = tuple  # (kind, index)


class Expr:
    def __add__(self, other):
        return Sum([self, _lift(other)])

    __radd__ = __add__

    def __sub__(self, other):
        return Sum([self, Neg(_lift(other))])

    def __rsub__(self, other):
        return Sum([_lift(other), Neg(self)])

    def __mul__(self, other):
        return Prod([self, _lift(other)])

    __rmul__ = __mul__

    def __neg__(self):
        return Neg(self)

    def degree(self) -> int:
        raise NotImplementedError


def _lift(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, np.integer)):
        return Const(int(x) % bb.P)
    if isinstance(x, (tuple, list, np.ndarray)) and len(x) == 4:
        return ExtConst(tuple(int(v) % bb.P for v in x))
    raise TypeError(f"cannot lift {type(x)} into Expr")


@dataclass(frozen=True)
class Wit(Expr):
    idx: int

    def degree(self):
        return 1

    def ref(self):
        return (WIT, self.idx)


@dataclass(frozen=True)
class Fix(Expr):
    idx: int

    def degree(self):
        return 1

    def ref(self):
        return (FIXED, self.idx)


@dataclass(frozen=True)
class Structural(Expr):
    idx: int

    def degree(self):
        return 1

    def ref(self):
        return (STRUCTURAL, self.idx)


@dataclass(frozen=True)
class Instance(Expr):
    """A public-value scalar, resolved per proof (reference: Expression::Instance)."""

    idx: int

    def degree(self):
        return 0


@dataclass(frozen=True)
class Challenge(Expr):
    """Transcript challenge by id (0 = alpha, 1 = beta, 2.. = per-layer)."""

    cid: int

    def degree(self):
        return 0


@dataclass(frozen=True)
class ChallengePow(Expr):
    """challenge[cid] ** power as a single leaf.

    Keeps record-RLC expressions flat: evaluators compute powers once per
    (cid, power) instead of re-tracing a chain of ext multiplications for
    every record (load-bearing for jax tracing time in the record builder)."""

    cid: int
    power: int

    def degree(self):
        return 0


@dataclass(frozen=True)
class Const(Expr):
    value: int  # canonical base-field value

    def degree(self):
        return 0


@dataclass(frozen=True)
class ExtConst(Expr):
    value: tuple  # canonical 4-tuple

    def degree(self):
        return 0


class Sum(Expr):
    def __init__(self, terms):
        flat = []
        for t in terms:
            if isinstance(t, Sum):
                flat.extend(t.terms)
            else:
                flat.append(t)
        self.terms = flat

    def degree(self):
        return max(t.degree() for t in self.terms)

    def __repr__(self):
        # deterministic structural repr: expression reprs key content
        # digests (gkr.chip.chip_digest -> AggKey binding, AOT cache keys);
        # the default object repr embeds the id()
        return f"Sum({self.terms!r})"


class Prod(Expr):
    def __init__(self, factors):
        flat = []
        for f in factors:
            if isinstance(f, Prod):
                flat.extend(f.factors)
            else:
                flat.append(f)
        self.factors = flat

    def degree(self):
        return sum(f.degree() for f in self.factors)

    def __repr__(self):
        return f"Prod({self.factors!r})"


class Neg(Expr):
    def __init__(self, inner):
        self.inner = inner

    def degree(self):
        return self.inner.degree()

    def __repr__(self):
        return f"Neg({self.inner!r})"


ZERO = Const(0)
ONE = Const(1)


# ---------------------------------------------------------------------------
# Monomial expansion
# ---------------------------------------------------------------------------

@dataclass
class Term:
    """scalar * prod(cols). ``scalar`` is a column-free Expr."""

    scalar: Expr
    cols: tuple  # sorted tuple of ColRef

    @property
    def degree(self):
        return len(self.cols)


def to_terms(expr: Expr) -> list[Term]:
    """Expand into monomial terms, merging identical column products."""
    raw = _expand(expr)
    merged: dict[tuple, list[Expr]] = {}
    for scalar, cols in raw:
        merged.setdefault(cols, []).append(scalar)
    out = []
    for cols, scalars in merged.items():
        s = scalars[0] if len(scalars) == 1 else Sum(scalars)
        out.append(Term(s, cols))
    return out


def _expand(expr: Expr) -> list[tuple[Expr, tuple]]:
    if isinstance(expr, (Wit, Fix, Structural)):
        return [(ONE, (expr.ref(),))]
    if isinstance(expr, (Const, ExtConst, Challenge, ChallengePow, Instance)):
        return [(expr, ())]
    if isinstance(expr, Neg):
        # keep negation SYMBOLIC (evaluated mod whichever field evaluates
        # the scalar): baking Const(p-1) here would hardwire BabyBear into
        # every compiled slot, breaking the Goldilocks path (gl/zkvm.py)
        return [(Neg(s), c) for s, c in _expand(expr.inner)]
    if isinstance(expr, Sum):
        out = []
        for t in expr.terms:
            out.extend(_expand(t))
        return out
    if isinstance(expr, Prod):
        parts = [_expand(f) for f in expr.factors]

        def combine(acc, nxt):
            return [
                (Prod([s1, s2]), tuple(sorted(c1 + c2)))
                for s1, c1 in acc
                for s2, c2 in nxt
            ]

        return reduce(combine, parts, [(ONE, ())])
    raise TypeError(f"unknown expr node {type(expr)}")


# ---------------------------------------------------------------------------
# Host-side scalar evaluation (challenges / instances / constants)
# ---------------------------------------------------------------------------

def eval_scalar(expr: Expr, challenges: np.ndarray, instances=None) -> np.ndarray:
    """Evaluate a column-free expression to a canonical (4,) ext value.

    ``challenges``: (n_challenges, 4) canonical; ``instances``: 1-D canonical
    base values (public-value slots).
    """
    if isinstance(expr, Const):
        return exth.from_base(expr.value)
    if isinstance(expr, ExtConst):
        return np.array(expr.value, np.uint64)
    if isinstance(expr, Challenge):
        return np.asarray(challenges[expr.cid], np.uint64)
    if isinstance(expr, ChallengePow):
        return exth.pow_int(np.asarray(challenges[expr.cid], np.uint64), expr.power)
    if isinstance(expr, Instance):
        assert instances is not None, "instance values required"
        return exth.from_base(int(instances[expr.idx]))
    if isinstance(expr, Neg):
        return exth.neg(eval_scalar(expr.inner, challenges, instances))
    if isinstance(expr, Sum):
        acc = np.zeros(4, np.uint64)
        for t in expr.terms:
            acc = exth.add(acc, eval_scalar(t, challenges, instances))
        return acc
    if isinstance(expr, Prod):
        acc = exth.one()
        for f in expr.factors:
            acc = exth.mul(acc, eval_scalar(f, challenges, instances))
        return acc
    raise TypeError(f"expression contains columns: {type(expr)}")


def collect_cols(expr: Expr) -> set:
    """All column refs appearing in an expression."""
    out = set()

    def walk(e):
        if isinstance(e, (Wit, Fix, Structural)):
            out.add(e.ref())
        elif isinstance(e, Neg):
            walk(e.inner)
        elif isinstance(e, Sum):
            for t in e.terms:
                walk(t)
        elif isinstance(e, Prod):
            for f in e.factors:
                walk(f)

    walk(expr)
    return out
