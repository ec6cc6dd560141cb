"""zkVM chips over Goldilocks: prove and verify one compiled rv32im chip with
the GL pipeline (reference `--field goldilocks`: the SAME circuits over
GoldilocksExt2; the Expression AST carries integer coefficients and
eval-time negation, so compiled chips are field-generic).

Counterpart of ``ceno_tpu/gl/zkvm.py`` (top-first sumcheck rounds,
round-order points):

  commit(wit)  ->  challenges alpha, beta (gl2)
  records      ->  per-record towers (sel*(rec-1)+1 padding; chip-side
                   logup p = sel, table-side p = -mult*sel), ONE grouped
                   tower prove with a shared final point rt
  main         ->  one batched zerocheck: every slot's monomial terms
                   weighted by a per-slot alpha, summed against the
                   masked eq(rt) selector column
  open         ->  GL Basefold batch-open of the witness columns at the
                   main point (fold oracles + PoW grinding, gl/pcs.py)

:func:`eval_expr_gl`, :func:`build_records_gl`, the tower layers,
:func:`prove_towers_gl`, :func:`_sel_eq_masked` and :func:`prove_chip_gl`
run on the tensors' device (the card unless the caller passes
``device="cpu"``); the transcript, the challenges and the claims stay on the
host. :func:`verify_towers_gl` and :func:`verify_chip_gl` stay host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import gl2_host as g2
from ..fields import goldilocks as gld
from ..fields import goldilocks_ext2 as gx
from ..mle import expression as E
from ..utils import spans
from . import pcs as gpcs
from . import sumcheck as gsc
from .transcript import GlTranscript

_P = np.uint64(gl.P)
LABEL = b"ceno-gl/chip/v1"


class GlZkvmError(Exception):
    pass


# -- expression evaluation over GL --------------------------------------------

def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(gld.const(v), dtype=gld.DTYPE, device=device)


def eval_expr_gl(expr, wit, fixed, structural, instances, challenges,
                 memo=None):
    """('b', (N,) or ()) or ('e', (N, 2) or (2,)) tensors over canonical GL
    banks (int64 tensors on one device; ``challenges`` a (2, 2) tensor)."""
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    dev = challenges.device
    if isinstance(expr, E.Wit):
        out = ("b", wit[expr.idx])
    elif isinstance(expr, E.Fix):
        out = ("b", fixed[expr.idx])
    elif isinstance(expr, E.Structural):
        out = ("b", structural[expr.idx])
    elif isinstance(expr, E.Const):
        out = ("b", _scalar(expr.value, dev))
    elif isinstance(expr, E.ExtConst):
        # ext constants are written as base-coefficient tuples; only the
        # base component is meaningful field-generically
        v = np.asarray(expr.value, np.uint64)
        if v.shape[-1] == 4 and int(v[..., 1:].max(initial=0)) != 0:
            raise GlZkvmError("BabyBear-specific ext constant in circuit")
        out = ("e", gx.from_base(gld.to_device(v[..., 0], dev)))
    elif isinstance(expr, E.Challenge):
        out = ("e", challenges[expr.cid])
    elif isinstance(expr, E.ChallengePow):
        c = challenges[expr.cid]
        acc = gx.one(dev)
        for _ in range(expr.power):
            acc = gx.mul(acc, c)
        out = ("e", acc)
    elif isinstance(expr, E.Instance):
        out = ("b", _scalar(int(instances[expr.idx]), dev))
    elif isinstance(expr, E.Neg):
        k, v = eval_expr_gl(expr.inner, wit, fixed, structural, instances,
                            challenges, memo)
        out = (k, gld.neg(v) if k == "b" else gx.neg(v))
    elif isinstance(expr, E.Sum):
        k, v = eval_expr_gl(expr.terms[0], wit, fixed, structural, instances,
                            challenges, memo)
        for t in expr.terms[1:]:
            k2, v2 = eval_expr_gl(t, wit, fixed, structural, instances,
                                  challenges, memo)
            k, v = _add(k, v, k2, v2)
        out = (k, v)
    elif isinstance(expr, E.Prod):
        k, v = eval_expr_gl(expr.factors[0], wit, fixed, structural,
                            instances, challenges, memo)
        for f in expr.factors[1:]:
            k2, v2 = eval_expr_gl(f, wit, fixed, structural, instances,
                                  challenges, memo)
            k, v = _mul(k, v, k2, v2)
        out = (k, v)
    else:
        raise TypeError(type(expr))
    memo[key] = out
    return out


def _add(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", gld.add(v1, v2)
    a = gx.from_base(v1) if k1 == "b" else v1
    b = gx.from_base(v2) if k2 == "b" else v2
    return "e", gx.add(a, b)


def _mul(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", gld.mul(v1, v2)
    if k1 == "b":
        return "e", gx.mul_base(v2, v1)
    if k2 == "b":
        return "e", gx.mul_base(v1, v2)
    return "e", gx.mul(v1, v2)


# -- records -------------------------------------------------------------------

def _as_ext_n(k, v, n):
    """A value as an (n, 2) ext column."""
    v = gx.from_base(v) if k == "b" else v
    return v.expand(n, 2) if v.dim() == 1 else v


def build_records_gl(compiled, wit, fixed, structural, instances,
                     challenges, k):
    """Per-record towers (no interleave) on the banks' device: returns
    (prods [(N, 2)], logups [(p, q)]). Padding: sel*(rec-1)+1 for products
    and logup q; logup p = sel (chip lk) or -mult*sel (table)."""
    n = wit.shape[1] if compiled.n_wit else structural.shape[1]
    dev = wit.device
    challenges = gx.to_device(challenges, dev) if not isinstance(challenges, torch.Tensor) \
        else challenges
    sel = torch.zeros(n, dtype=gld.DTYPE, device=dev)
    sel[:k] = 1
    sel_e = gx.from_base(sel)
    one = gx.one(dev)
    memo = {}

    def padded(expr):
        kk, v = eval_expr_gl(expr, wit, fixed, structural, instances,
                             challenges, memo)
        v = _as_ext_n(kk, v, n)
        return gx.add(gx.mul(gx.sub(v, one), sel_e), one)

    prods = [padded(e) for e in compiled.r_exprs] + [
        padded(e) for e in compiled.w_exprs
    ]
    logups = []
    for e in compiled.lk_exprs:
        logups.append((sel_e.clone(), padded(e)))
    # hold the Neg temps alive: the eval memo is id()-keyed (gkr/chip.py)
    neg_mults = [E.Neg(mult) for mult, _ in compiled.lk_table]
    for nm, (mult, rec) in zip(neg_mults, compiled.lk_table):
        kk, v = eval_expr_gl(nm, wit, fixed, structural, instances,
                             challenges, memo)
        v = _as_ext_n(kk, v, n)
        logups.append((gx.mul(v, sel_e), padded(rec)))
    return prods, logups


# -- towers (gl mirror of gkr/tower.py) ----------------------------------------

@dataclass
class GlTowerProof:
    prod_out: np.ndarray     # (S_p, 2, 2)
    logup_out: np.ndarray    # (S_l, 2, 2, 2)
    round_msgs: list = field(default_factory=list)
    level_evals: list = field(default_factory=list)


def _fold_two(a, b, r):
    return g2.add(a, g2.mul(g2.sub(b, a), r))


def _prod_layers(v):
    layers = [v]
    while v.shape[0] > 2:
        half = v.shape[0] // 2
        v = gx.mul(v[:half], v[half:])
        layers.append(v)
    return list(reversed(layers))


def _logup_layers(p, q):
    ps, qs = [p], [q]
    while p.shape[0] > 2:
        half = p.shape[0] // 2
        pl, pr, ql, qr = p[:half], p[half:], q[:half], q[half:]
        p = gx.add(gx.mul(pl, qr), gx.mul(pr, ql))
        q = gx.mul(ql, qr)
        ps.append(p)
        qs.append(q)
    return list(reversed(ps)), list(reversed(qs))


def prove_towers_gl(prods, logups, transcript):
    """The grouped tower prove on the layers' device; the outputs, claims
    and points are host numpy."""
    n_vars = (prods[0] if prods else logups[0][0]).shape[0].bit_length() - 1
    prod_lys = [_prod_layers(v) for v in prods]
    logup_lys = [_logup_layers(p, q) for p, q in logups]
    prod_out = (gx.to_host(torch.stack([ls[0] for ls in prod_lys]))
                if prod_lys else np.zeros((0, 2, 2), np.uint64))
    logup_out = (gx.to_host(torch.stack([torch.stack([pl[0], ql[0]]) for pl, ql in logup_lys]))
                 if logup_lys else np.zeros((0, 2, 2, 2), np.uint64))
    proof = GlTowerProof(prod_out, logup_out)
    for s in range(len(prod_lys)):
        transcript.append(prod_out[s].ravel())
    for s in range(len(logup_lys)):
        transcript.append(logup_out[s].ravel())
    rt = transcript.sample_ext()[None, :]  # (1, 2), round order (top first)
    prod_claims = [_fold_two(prod_out[s][0], prod_out[s][1], rt[0])
                   for s in range(len(prod_lys))]
    logup_claims = [
        [_fold_two(logup_out[s][0][0], logup_out[s][0][1], rt[0]),
         _fold_two(logup_out[s][1][0], logup_out[s][1][1], rt[0])]
        for s in range(len(logup_lys))
    ]
    dev = (prods[0] if prods else logups[0][0]).device
    for level in range(1, n_vars):
        n_claims = len(prod_claims) + 2 * len(logup_claims)
        alphas = transcript.sample_ext_pows(n_claims)
        half = 1 << level
        eq_col = gsc.build_eq(rt, dev)
        ext_cols = [eq_col]
        terms = []
        a = 0
        for s in range(len(prod_lys)):
            nxt = prod_lys[s][level]
            li = len(ext_cols)
            ext_cols.extend([nxt[:half], nxt[half:]])
            terms.append((alphas[a], (), (0, li, li + 1)))
            a += 1
        for s in range(len(logup_lys)):
            pl_, ql_ = logup_lys[s][0][level], logup_lys[s][1][level]
            i0 = len(ext_cols)
            ext_cols.extend([pl_[:half], pl_[half:], ql_[:half], ql_[half:]])
            pL, pR, qL, qR = i0, i0 + 1, i0 + 2, i0 + 3
            terms.append((alphas[a], (), (0, pL, qR)))
            terms.append((alphas[a], (), (0, pR, qL)))
            terms.append((alphas[a + 1], (), (0, qL, qR)))
            a += 2
        out = gsc.prove([], ext_cols, terms, level, transcript)
        proof.round_msgs.append(out.round_msgs)
        evals = out.final_ext[1:]
        proof.level_evals.append(evals.copy())
        transcript.append(evals.ravel())
        mu = transcript.sample_ext()
        # round-order points put the NEW (top) variable FIRST
        rt = np.concatenate([mu[None, :], out.point], axis=0)
        e = 0
        new_prod, new_logup = [], []
        for s in range(len(prod_lys)):
            new_prod.append(_fold_two(evals[e], evals[e + 1], mu))
            e += 2
        for s in range(len(logup_lys)):
            new_logup.append([
                _fold_two(evals[e], evals[e + 1], mu),
                _fold_two(evals[e + 2], evals[e + 3], mu),
            ])
            e += 4
        prod_claims, logup_claims = new_prod, new_logup
    return proof, rt, (prod_claims, logup_claims)


def verify_towers_gl(proof: GlTowerProof, n_vars: int, transcript):
    s_p = proof.prod_out.shape[0]
    s_l = proof.logup_out.shape[0]
    for s in range(s_p):
        transcript.append(proof.prod_out[s].ravel())
    for s in range(s_l):
        transcript.append(proof.logup_out[s].ravel())
    prod_values = (np.stack([g2.mul(proof.prod_out[s][0], proof.prod_out[s][1])
                             for s in range(s_p)])
                   if s_p else np.zeros((0, 2), np.uint64))
    logup_fracs = []
    for s in range(s_l):
        p0, p1 = proof.logup_out[s][0]
        q0, q1 = proof.logup_out[s][1]
        logup_fracs.append(np.stack([
            g2.add(g2.mul(p0, q1), g2.mul(p1, q0)), g2.mul(q0, q1),
        ]))
    logup_fracs = (np.stack(logup_fracs)
                   if s_l else np.zeros((0, 2, 2), np.uint64))
    rt = transcript.sample_ext()[None, :]
    prod_claims = [_fold_two(proof.prod_out[s][0], proof.prod_out[s][1], rt[0])
                   for s in range(s_p)]
    logup_claims = [
        [_fold_two(proof.logup_out[s][0][0], proof.logup_out[s][0][1], rt[0]),
         _fold_two(proof.logup_out[s][1][0], proof.logup_out[s][1][1], rt[0])]
        for s in range(s_l)
    ]
    for level in range(1, n_vars):
        n_claims = s_p + 2 * s_l
        alphas = transcript.sample_ext_pows(n_claims)
        batched = np.zeros(2, np.uint64)
        a = 0
        for s in range(s_p):
            batched = g2.add(batched, g2.mul(alphas[a], prod_claims[s]))
            a += 1
        for s in range(s_l):
            batched = g2.add(batched, g2.mul(alphas[a], logup_claims[s][0]))
            batched = g2.add(batched, g2.mul(alphas[a + 1], logup_claims[s][1]))
            a += 2
        point, final_claim = gsc.verify(
            batched, proof.round_msgs[level - 1], level, transcript, deg=3
        )
        evals = np.asarray(proof.level_evals[level - 1], np.uint64)
        eq_v = g2.eq_eval(rt, point)
        acc = np.zeros(2, np.uint64)
        e = 0
        a = 0
        for s in range(s_p):
            acc = g2.add(acc, g2.mul(alphas[a], g2.mul(evals[e], evals[e + 1])))
            e += 2
            a += 1
        for s in range(s_l):
            pLv, pRv, qLv, qRv = (evals[e], evals[e + 1], evals[e + 2],
                                  evals[e + 3])
            num = g2.add(g2.mul(pLv, qRv), g2.mul(pRv, qLv))
            acc = g2.add(acc, g2.mul(alphas[a], num))
            acc = g2.add(acc, g2.mul(alphas[a + 1], g2.mul(qLv, qRv)))
            e += 4
            a += 2
        if not np.array_equal(g2.mul(eq_v, acc), final_claim):
            raise GlZkvmError(f"tower level {level}: recombination mismatch")
        transcript.append(evals.ravel())
        mu = transcript.sample_ext()
        rt = np.concatenate([mu[None, :], point], axis=0)
        e = 0
        new_prod, new_logup = [], []
        for s in range(s_p):
            new_prod.append(_fold_two(evals[e], evals[e + 1], mu))
            e += 2
        for s in range(s_l):
            new_logup.append([
                _fold_two(evals[e], evals[e + 1], mu),
                _fold_two(evals[e + 2], evals[e + 3], mu),
            ])
            e += 4
        prod_claims, logup_claims = new_prod, new_logup
    return rt, prod_claims, logup_claims, prod_values, logup_fracs


# -- chip prove / verify -------------------------------------------------------

@dataclass
class GlChipProof:
    num_instances: int
    n_vars: int
    root: np.ndarray
    tower: GlTowerProof
    main_msgs: np.ndarray
    wit_evals: np.ndarray       # (n_wit, 2) at the main point
    opening: object             # gpcs.GlOpening


def _eval_scalar_gl(expr, challenges, instances):
    """A column-free expression's value, (2,) host numpy (evaluated on CPU
    tensors)."""
    empty = torch.zeros((0, 1), dtype=gld.DTYPE)
    k, v = eval_expr_gl(expr, empty, empty, empty, instances,
                        gx.to_device(challenges, "cpu"))
    v = gld.to_host(v)
    if k == "b":
        return g2.from_base(v.reshape(-1)[0])
    return v.reshape(-1, 2)[0]


def _sel_eq_masked(rt, k, n, device):
    eq = gsc.build_eq(rt, device)
    eq[k:] = 0
    return eq


def _gl2_sum(arr: np.ndarray) -> np.ndarray:
    """Exact mod-p sum of a (n, 2) GL2 array by log-depth vectorized
    halving (wrap-safe via g2.add)."""
    arr = np.asarray(arr, np.uint64)
    if arr.shape[0] == 0:
        return np.zeros(2, np.uint64)
    while arr.shape[0] > 1:
        if arr.shape[0] & 1:
            arr = np.concatenate([arr, np.zeros((1, 2), np.uint64)])
        half = arr.shape[0] // 2
        arr = g2.add(arr[:half], arr[half:])
    return np.ascontiguousarray(arr[0])


def _sel_prefix_eval(rt, k):
    """sum_{x < k} eq(rt, x) (host)."""
    eq = gsc.build_eq_host(rt)
    return _gl2_sum(eq[:k])


def _sel_eq_eval(rt, point, k):
    """MLE of the masked eq column evaluated at ``point`` (host)."""
    eq_rt = gsc.build_eq_host(rt)
    eq_pt = gsc.build_eq_host(point)
    return _gl2_sum(g2.mul(eq_rt[:k], eq_pt[:k]))


def _slot_targets(compiled, prod_claims, logup_claims):
    """Per-slot (claim - pad) targets; chip-side lk p claims are returned
    separately for the analytic prefix check."""
    one = g2.one()
    targets = []
    n_r = len(compiled.r_exprs)
    for s in compiled.slots:
        if s.kind == "prod_r":
            targets.append(g2.sub(prod_claims[s.rec], one))
        elif s.kind == "prod_w":
            targets.append(g2.sub(prod_claims[n_r + s.rec], one))
        elif s.kind == "lkq":
            targets.append(g2.sub(logup_claims[s.rec][1], one))
        elif s.kind == "lkp_table":
            targets.append(logup_claims[s.rec][0])
        else:  # zero constraint
            targets.append(np.zeros(2, np.uint64))
    return targets


def _col_index(ref, n_wit, n_fixed):
    kind, idx = ref
    if kind == E.WIT:
        return idx
    if kind == E.FIXED:
        return n_wit + idx
    return n_wit + n_fixed + idx


def prove_chip_gl(compiled, wit, instances, k, params=None, device=None):
    """Prove one (fixed/structural-free) compiled chip over Goldilocks on
    ``device`` (the card when None); ``wit`` is (n_wit, N) numpy or an int64
    tensor of canonical values (which stays on its device)."""
    params = params or gpcs.GlParams()
    if compiled.n_fixed or compiled.structural:
        raise GlZkvmError("GL demo path covers fixed/structural-free chips")
    if not isinstance(wit, torch.Tensor):
        wit = gld.to_device(np.asarray(wit, np.uint64) % _P, "cuda" if device is None else device)
    dev = wit.device
    n = wit.shape[1]
    n_vars = n.bit_length() - 1
    t = GlTranscript(LABEL)
    with spans.span("gl/commit"):
        committed = gpcs.commit(wit, params)
        t.append(committed.root)
    t.append([k % gl.P])
    challenges = np.stack([t.sample_ext(), t.sample_ext()])
    fixed = torch.zeros((0, n), dtype=gld.DTYPE, device=dev)
    structural = torch.zeros((0, n), dtype=gld.DTYPE, device=dev)
    with spans.span("gl/records"):
        prods, logups = build_records_gl(
            compiled, wit, fixed, structural, instances, challenges, k
        )
    with spans.span("gl/towers"):
        tower_proof, rt, (prod_claims, logup_claims) = prove_towers_gl(
            prods, logups, t
        )
    del prods, logups
    with spans.span("gl/main"):
        alphas = t.sample_ext_pows(len(compiled.slots))
        sel_eq = _sel_eq_masked(rt, k, n, dev)
        terms = []
        for si, slot in enumerate(compiled.slots):
            for tm in slot.terms:
                sc_ = g2.mul(alphas[si], _eval_scalar_gl(tm.scalar, challenges,
                                                         instances))
                bidx = tuple(_col_index(c, compiled.n_wit, 0) for c in tm.cols)
                terms.append((sc_, bidx, (0,)))
        out = gsc.prove([wit[i] for i in range(compiled.n_wit)], [sel_eq],
                        terms, n_vars, t)
    wit_evals = out.final_base
    t.append(wit_evals.ravel())
    with spans.span("gl/open"):
        opening = gpcs.open_batch(committed, out.point, wit_evals, t, params)
    return GlChipProof(k, n_vars, committed.root, tower_proof,
                       out.round_msgs, wit_evals, opening)


def verify_chip_gl(compiled, proof: GlChipProof, instances, params=None):
    params = params or gpcs.GlParams()
    k = proof.num_instances
    n_vars = proof.n_vars
    t = GlTranscript(LABEL)
    t.append(np.asarray(proof.root, np.uint64))
    t.append([k % gl.P])
    challenges = np.stack([t.sample_ext(), t.sample_ext()])
    rt, prod_claims, logup_claims, prod_values, logup_fracs = verify_towers_gl(
        proof.tower, n_vars, t
    )
    # chip-side lookup p claims ARE the selector prefix (p = sel)
    n_lk = len(compiled.lk_exprs)
    sel_v = _sel_prefix_eval(rt, k)
    for i in range(n_lk):
        if not np.array_equal(logup_claims[i][0], sel_v):
            raise GlZkvmError(f"lk {i}: p claim != selector prefix")
    alphas = t.sample_ext_pows(len(compiled.slots))
    targets = _slot_targets(compiled, prod_claims, logup_claims)
    batched = np.zeros(2, np.uint64)
    for si in range(len(compiled.slots)):
        batched = g2.add(batched, g2.mul(alphas[si], targets[si]))
    deg = max((len(tm.cols) + 1 for s in compiled.slots for tm in s.terms),
              default=1)
    point, final_claim = gsc.verify(batched, proof.main_msgs, n_vars, t,
                                    deg=deg)
    wit_evals = np.asarray(proof.wit_evals, np.uint64)
    if wit_evals.shape != (compiled.n_wit, 2):
        raise GlZkvmError("bad witness eval shape")
    t.append(wit_evals.ravel())
    # recombination: sum_slots alpha * sel_eq(pt) * slot_terms(evals)
    s_eq = _sel_eq_eval(rt, point, k)
    acc = np.zeros(2, np.uint64)
    for si, slot in enumerate(compiled.slots):
        slot_val = np.zeros(2, np.uint64)
        for tm in slot.terms:
            val = _eval_scalar_gl(tm.scalar, challenges, instances)
            for c in tm.cols:
                val = g2.mul(val, wit_evals[_col_index(c, compiled.n_wit, 0)])
            slot_val = g2.add(slot_val, val)
        acc = g2.add(acc, g2.mul(alphas[si], slot_val))
    if not np.array_equal(g2.mul(s_eq, acc), final_claim):
        raise GlZkvmError("main recombination mismatch")
    gpcs.verify_batch(proof.root, n_vars, compiled.n_wit, point, wit_evals,
                      proof.opening, t, params)
    return prod_values, logup_fracs
