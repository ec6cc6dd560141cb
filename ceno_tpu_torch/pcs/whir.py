"""WHIR: a super-charged-query multilinear PCS (reference's PcsKind::Whir).

Counterpart of ``ceno_tpu/pcs/whir.py``, the role mirror of the reference's
third PCS option (`whir` crate, SURVEY.md §2.9, e2e.rs:103-129). WHIR is an
IOP of proximity for CONSTRAINED Reed-Solomon codes: the opening claim
f(z) = y is the weighted-sum statement sum_x f(x)*eq(z,x) = y, and each
iteration (i) runs k sumcheck rounds on the statement, (ii) RE-ENCODES the
k-fold-smaller function on a domain only 2x smaller — so the rate improves
by 2^{k-1} per iteration and later rounds need fewer queries, (iii) binds
the new oracle with an out-of-domain evaluation, and (iv) folds shift
queries on the OLD oracle into new eq-constraints on the new function via a
gamma-combination. The recursion ends with the function in clear.

Single-point BATCH interface matching the jagged pipeline's inner opening:
columns are gamma_0-combined up front; base-oracle queries open the
committed per-column rows so the combination is spot-checked.

Index/domain correspondence (pcs/ntt.py contract): the committed codeword
is the NTT of the variable-reversed multilinear in natural domain order, so
cw[i] = f_canonical evaluated at x_j = w^{2^{m-1-j} * i}; folding pairs
(i, i + M/2) with twiddle w^{-i} and binds the sumcheck's top variable.
After k folds the value at index i is the (m-k)-var function at
phi = w^{2^k * i}, i.e. the eq-constraint point has components
phi^{2^{m-k-1-j}}.

The prover runs on the committed's device (the reference's runs on the
host): g and the weight table live there as (4, N) Montgomery tensors; each
round is K6a (degree 2, one term g*w) then K6b (ext mode) over the bank
[g, w, ones]; each new oracle is ``ntt.encode`` of g's four components as
four rows, hashed by K1 and K2 (``merkle.hash_and_tree``); the query cosets
are gathered there. Only the round messages, the roots, the OOD values, the
final function and the opened cosets and paths cross to the host, where the
transcript is. The reference's prover also keeps a running claim and
evaluates g at every query point; neither reaches the transcript or the
proof, so the port does not compute them. The verifier is host numpy, a
copy of the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..mle import ops
from ..sumcheck import host_impl as H
from ..sumcheck import terms
from ..sumcheck import verifier as sc_verifier
from ..utils import spans
from . import ntt
from .basefold import combine_columns
from .merkle import MerkleTree, gather_rows, hash_and_tree, verify_paths

_P = np.uint64(bb.P)


@dataclass
class WhirParams:
    k: int = 3              # sumcheck/fold rounds per iteration
    stop_vars: int = 5      # send the function in clear at/below this size
    security_bits: int = 100
    pow_bits: int = 0       # per-query-set proof-of-work grinding bits


@dataclass
class WhirQuerySet:
    """Shift queries against one oracle (2^k-leaf cosets)."""

    indices: list           # folded-domain indices
    leaves: np.ndarray      # (Q, 2^k, C) base or (Q, 2^k, 4) ext canonical
    paths: np.ndarray       # (Q * 2^k, depth, 8)
    pow_nonce: int = 0      # grinding nonce consumed before the indices


@dataclass
class WhirIter:
    sumcheck_msgs: np.ndarray   # (k, 3, 4)
    root: np.ndarray            # (8,) new oracle root
    y_ood: np.ndarray           # (4,)
    queries: WhirQuerySet       # on the PREVIOUS oracle


@dataclass
class WhirProof:
    iters: list
    final_msgs: np.ndarray      # (k_last, 3, 4) last partial sumcheck
    final_g: np.ndarray         # (2^stop, 4) in-clear function
    final_queries: WhirQuerySet


# ---------------------------------------------------------------------------
# Host arithmetic (the verifier's and the constraint points')
# ---------------------------------------------------------------------------

def _fold_top(g: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    half = g.shape[0] // 2
    lo, hi = g[:half], g[half:]
    diff = (hi + _P - lo) % _P
    return exth.add(lo, exth.mul(diff, np.asarray(alpha, np.uint64)[None, :]))


def _mle_eval(g: np.ndarray, point: np.ndarray) -> np.ndarray:
    cur = g
    for j in range(point.shape[0] - 1, -1, -1):
        cur = _fold_top(cur, point[j])
    return cur[0]


def _eq1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    one = exth.one()
    return exth.add(
        exth.mul(a, b), exth.mul(exth.sub(one, a), exth.sub(one, b))
    )


def _sum_ext(v: np.ndarray) -> np.ndarray:
    return (v.astype(object).sum(axis=0) % int(bb.P)).astype(np.uint64)


def _w_dense(points: list, n: int) -> np.ndarray:
    acc = np.zeros((n, 4), np.uint64)
    for pt, scalar in points:
        acc = exth.add(acc, exth.mul(H.build_eq_host(pt), scalar))
    return acc


def _fold_points(points: list, alpha: np.ndarray) -> list:
    out = []
    for pt, scalar in points:
        out.append((pt[:-1], exth.mul(scalar, _eq1(pt[-1], alpha))))
    return out


def _query_point(idx: int, log_m: int, m_vars: int) -> np.ndarray:
    """eq-constraint point for folded-domain index ``idx`` (base coords)."""
    w = bb.two_adic_root(log_m)
    phi = pow(int(w), idx, bb.P)
    pt = np.zeros((m_vars, 4), np.uint64)
    for j in range(m_vars):
        pt[j][0] = pow(phi, 1 << (m_vars - 1 - j), bb.P)
    return pt


def _fold_query(leaves: np.ndarray, idx: int, log_m: int, alphas: list):
    """Verifier-side fold of a 2^k-leaf coset down to one value.

    leaves: (2^k, 4) canonical ext values at old-oracle indices
    idx + j*M/2^k; alphas in sumcheck round order."""
    k = len(alphas)
    vals = leaves
    inv2 = pow(2, bb.P - 2, bb.P)
    for t, alpha in enumerate(alphas):
        m_t = 1 << (log_m - t)
        half_cnt = vals.shape[0] // 2
        w_inv = pow(int(bb.two_adic_root(log_m - t)), bb.P - 2, bb.P)
        nxt = np.zeros((half_cnt, 4), np.uint64)
        for j in range(half_cnt):
            pos = idx + j * (m_t >> (k - t))
            tw = np.uint64(pow(w_inv, pos, bb.P) * inv2 % bb.P)
            a, b_ = vals[j], vals[j + half_cnt]
            s = exth.mul_base(exth.add(a, b_), np.uint64(inv2))
            d = exth.mul_base(exth.sub(a, b_), tw)
            nxt[j] = exth.add(s, exth.mul(d, alpha))
        vals = nxt
    return vals[0]


def _n_queries(blowup_log: int, sec_bits: int) -> int:
    return max(1, -(-sec_bits // max(1, blowup_log)))


def _gamma_pows(gamma: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n, 4), np.uint64)
    cur = exth.one()
    for i in range(n):
        out[i] = cur
        cur = exth.mul(cur, gamma)
    return out


# ---------------------------------------------------------------------------
# Prover (on the committed's device)
# ---------------------------------------------------------------------------

def _weights(points: list, device) -> torch.Tensor:
    """sum_t scalar_t * eq(pt_t, .) over the constraint points, all of one
    length m: (4, 2^m) Montgomery on ``device``, the T tables built as one
    batch."""
    pts = bb.to_device(np.stack([pt for pt, _ in points], axis=-1), device)  # (m, 4, T)
    scales = bb.to_device(np.stack([s for _, s in points], axis=-1), device)  # (4, T)
    return bb.sum_mod(ops.build_eq(pts, scales), 1)


def _rounds(g, w, k: int, transcript: Transcript) -> tuple:
    """k rounds of the degree-2 sumcheck of sum_x g(x) w(x), top variable
    first: per round K6a over the bank [g, w, ones] (one term g*w), the
    message to the transcript, then K6b folds the bank by the sampled alpha.
    Returns (folded g (4, N >> k), msgs (k, 3, 4) canonical, [alpha])."""
    dev = g.device
    _, bank = terms.make_banks([], [g, w], g.shape[1])
    idx = torch.tensor([[0, 1]], dtype=torch.int32, device=dev)
    one = ext4.ones((1,), dev)
    msgs = np.zeros((k, 3, 4), np.uint64)
    alphas = []
    for r in range(k):
        ev = terms.round_evals_ext(bank, idx, one, deg=2, check_indices=r == 0)
        msgs[r] = bb.to_host(ev)
        transcript.append(msgs[r].ravel())
        alpha = np.array(transcript.sample_ext(), np.uint64)
        alphas.append(alpha)
        bank = terms.fold_ext_bank(bank, bb.to_device(alpha, dev))
    return bank[:, 0].contiguous(), msgs, alphas


def _new_oracle(g, blowup_log: int) -> tuple:
    """g (4, N) re-encoded at ``blowup_log``, its four components as four
    rows, and the Merkle tree over its columns (K1 with C = 4, then K2):
    ((4, N << blowup_log) Montgomery codeword, MerkleTree)."""
    with spans.span("whir/encode"):
        cw = ntt.encode(g, blowup_log=blowup_log)
    with spans.span("whir/tree"):
        tree = MerkleTree.from_device(*hash_and_tree(cw))
    return cw, tree


def _prove_queries(tree: MerkleTree, oracle, transcript: Transcript, log_m: int, k: int,
                   n_q: int, pow_bits: int = 0) -> WhirQuerySet:
    """Sample indices and open the 2^k-leaf cosets of one oracle: ``oracle``
    is its (C, M) codeword (the committed base columns, or a new oracle's
    four ext components), leaf i its column i."""
    step = (1 << log_m) >> k
    with spans.span("whir/grind"):
        nonce = transcript.grind(pow_bits)
    idxs = [transcript.sample_base() % step for _ in range(n_q)]
    with spans.span("whir/queries"):
        rows = np.array([idx + j * step for idx in idxs for j in range(1 << k)], np.int64)
        vals = bb.to_host(gather_rows(oracle, rows))                       # (C, Q * 2^k)
        leaves = np.ascontiguousarray(vals.T.reshape(n_q, 1 << k, -1))
        paths = tree.open_paths(rows)
    return WhirQuerySet(idxs, leaves, paths, nonce)


def open_whir(committed, point: np.ndarray, values: np.ndarray,
              transcript: Transcript, blowup_log: int,
              params: WhirParams = WhirParams()) -> WhirProof:
    """Open every column of ``committed`` (``basefold.commit``'s, on its
    device) at one shared point.

    ``values`` (C, 4) are the claimed evals; the verifier recomputes the
    claim from them, the prover does not need them."""
    dev = committed.cols.device
    c, n = committed.cols.shape
    m_vars = committed.n_vars
    log_m = m_vars + blowup_log

    gamma0 = np.array(transcript.sample_ext(), np.uint64)
    gpows = _gamma_pows(gamma0, c)
    g = combine_columns(committed.cols, bb.to_device(gpows.T, dev))          # (4, N)
    w_points = [(np.asarray(point, np.uint64), exth.one())]

    oracle = committed.codeword   # base oracle: per-column CODEWORD rows
    oracle_tree = committed.tree
    cur_blowup = blowup_log

    iters = []
    while True:
        m = m_vars
        k = min(params.k, max(1, m - params.stop_vars))
        final = (m - k) <= params.stop_vars
        with spans.span("whir/rounds"):
            g, msgs, alphas = _rounds(g, _weights(w_points, dev), k, transcript)
        for alpha in alphas:
            w_points = _fold_points(w_points, alpha)
        m_vars = m - k
        n_q = _n_queries(cur_blowup, params.security_bits)

        if final:
            final_g = np.ascontiguousarray(bb.to_host(g).T)                 # (2^m, 4)
            transcript.append(final_g.ravel())
            qs = _prove_queries(oracle_tree, oracle, transcript, log_m, k, n_q,
                                params.pow_bits)
            return WhirProof(iters, msgs, final_g, qs)

        # new oracle: re-encode on a domain HALF the old size
        new_log_m = log_m - 1
        new_blowup = new_log_m - m_vars
        cw_g, tree = _new_oracle(g, new_blowup)
        transcript.append(tree.root)
        r_ood = transcript.sample_exts(m_vars)
        y_ood = bb.to_host(ops.evaluate(g, bb.to_device(r_ood, dev)))
        transcript.append(y_ood)

        qs = _prove_queries(oracle_tree, oracle, transcript, log_m, k, n_q, params.pow_bits)
        gamma = np.array(transcript.sample_ext(), np.uint64)
        iters.append(WhirIter(msgs, tree.root, y_ood, qs))

        # constraint points for the next iteration: the OOD point and every
        # queried index, weighted by consecutive powers of gamma
        cur = gamma.copy()
        w_points.append((r_ood, cur))
        for idx in qs.indices:
            cur = exth.mul(cur, gamma)
            w_points.append((_query_point(idx, new_log_m - (k - 1), m_vars), cur))

        oracle = cw_g
        oracle_tree = tree
        log_m = new_log_m
        cur_blowup = new_blowup


# ---------------------------------------------------------------------------
# Verify (numpy, a copy of the reference's)
# ---------------------------------------------------------------------------

class WhirError(Exception):
    pass


def verify_whir(root: np.ndarray, n_vars: int, n_cols: int,
                point: np.ndarray, values: np.ndarray, proof: WhirProof,
                transcript: Transcript, blowup_log: int,
                params: WhirParams = WhirParams()) -> None:
    gamma0 = np.array(transcript.sample_ext(), np.uint64)
    gpows = _gamma_pows(gamma0, n_cols)
    sigma = np.zeros(4, np.uint64)
    for j in range(n_cols):
        sigma = exth.add(sigma, exth.mul(gpows[j], np.asarray(values[j], np.uint64)))
    w_points = [(np.asarray(point, np.uint64), exth.one())]

    m_vars = n_vars
    log_m = n_vars + blowup_log
    cur_blowup = blowup_log
    oracle_root = np.asarray(root, np.uint64)
    oracle_is_base = True

    def check_queries(qs: WhirQuerySet, alphas, k, expect_fn):
        n_q = _n_queries(cur_blowup, params.security_bits)
        if len(qs.indices) != n_q:
            raise WhirError("bad query count")
        m = 1 << log_m
        step = m >> k
        if not transcript.check_grind(qs.pow_nonce, params.pow_bits):
            raise WhirError("proof-of-work grinding check failed")
        expect_idx = [transcript.sample_base() % step for _ in range(n_q)]
        if list(qs.indices) != expect_idx:
            raise WhirError("query indices do not match the transcript")
        rows = []
        flat_vals = []
        for qi, idx in enumerate(qs.indices):
            rows += [idx + j * step for j in range(1 << k)]
            for j in range(1 << k):
                flat_vals.append(qs.leaves[qi][j])
        flat_vals = np.stack(flat_vals)
        # base and ext oracles' leaf rows alike, as ceno_tpu/pcs/whir.py:342
        if not verify_paths(oracle_root, rows, flat_vals, qs.paths):
            raise WhirError("query path verification failed")
        out = []
        for qi, idx in enumerate(qs.indices):
            if oracle_is_base:
                coset = np.zeros((1 << k, 4), np.uint64)
                for j in range(1 << k):
                    acc = np.zeros(4, np.uint64)
                    for cc in range(n_cols):
                        acc = exth.add(
                            acc, exth.mul_base(gpows[cc],
                                               np.uint64(qs.leaves[qi][j][cc]))
                        )
                    coset[j] = acc
            else:
                coset = np.asarray(qs.leaves[qi], np.uint64)
            v = _fold_query(coset, idx, log_m, alphas)
            if expect_fn is not None:
                if not np.array_equal(v, expect_fn(idx)):
                    raise WhirError("query fold mismatch")
            out.append((idx, v))
        return out

    it = 0
    while True:
        m = m_vars
        k = min(params.k, max(1, m - params.stop_vars))
        final = (m - k) <= params.stop_vars
        msgs = proof.final_msgs if final else proof.iters[it].sumcheck_msgs
        pt_rev, claim = sc_verifier.verify(sigma, np.asarray(msgs, np.uint64),
                                           k, transcript, deg=2)
        alphas = [pt_rev[k - 1 - r].astype(np.uint64) for r in range(k)]
        for alpha in alphas:
            w_points = _fold_points(w_points, alpha)
        m_vars = m - k

        if final:
            g = np.asarray(proof.final_g, np.uint64)
            if g.shape != (1 << m_vars, 4):
                raise WhirError("bad final function shape")
            transcript.append(g.ravel())
            # weighted-sum check against the running claim
            if not np.array_equal(
                _sum_ext(exth.mul(g, _w_dense(w_points, 1 << m_vars))), claim
            ):
                raise WhirError("final weighted-sum mismatch")
            check_queries(
                proof.final_queries, alphas, k,
                lambda idx: _mle_eval(
                    g, _query_point(idx, log_m - k, m_vars)
                ),
            )
            return

        itp = proof.iters[it]
        transcript.append(np.asarray(itp.root, np.uint64))
        r_ood = transcript.sample_exts(m_vars)
        y_ood = np.asarray(itp.y_ood, np.uint64)
        transcript.append(y_ood)

        new_log_m = log_m - 1
        qres = check_queries(itp.queries, alphas, k, None)
        gamma = np.array(transcript.sample_ext(), np.uint64)

        sigma = claim
        cur = gamma.copy()
        w_points.append((r_ood, cur))
        sigma = exth.add(sigma, exth.mul(cur, y_ood))
        for idx, v in qres:
            cur = exth.mul(cur, gamma)
            pt = _query_point(idx, new_log_m - (k - 1), m_vars)
            w_points.append((pt, cur))
            sigma = exth.add(sigma, exth.mul(cur, v))

        oracle_root = np.asarray(itp.root, np.uint64)
        oracle_is_base = False
        log_m = new_log_m
        cur_blowup = new_log_m - m_vars
        it += 1
