"""Basefold-RS multilinear PCS: batch commit, batched multi-point open, verify.

Counterpart of ``ceno_tpu/pcs/basefold.py`` (itself the role mirror of the
reference's ``mpcs::Basefold``, SURVEY.md §2.9). The prover runs on the
tensors' device with no size crossover: every commit and every fold-level
tree goes through the Merkle kernels K1/K2. The verifier is numpy.
 Commit = column-wise RS encode (pcs/ntt.py) + Poseidon2 Merkle over
rows; open = the classic Basefold interleaving of an eq-weighted batching
sumcheck with codeword folding; verify = transcript replay + fold-consistency
spot checks at sampled query positions.

Batched opening protocol (one height class, C columns, K points):
  1. gamma <- transcript; per CLAIMED (point k, column j) pair a weight
     c_jk = gamma^t (t = running claim index). Unclaimed pairs weigh 0.
  2. Prover combines per point: F_k = sum_j c_jk f_j (ONE ext column per
     point), and K fold oracles U_0^(k) = sum_j c_jk cw_j — one PER POINT,
     all folded with the shared challenges, committed together (one Merkle
     tree per fold level over the concatenated K-tuple rows).
  3. Sumcheck over sum_x sum_k eq(x, z_k) F_k(x) = sum c_jk y_jk, degree 2,
     K terms. After each challenge r_t the prover folds every oracle
     U_{t+1}^k[i] = ((U_t^k[i]+U_t^k[i+M/2]) + r_t w_M^{-i}(U_t^k[i]-U_t^k[i+M/2]))/2
     and absorbs the Merkle root of the level (so r_{t+1} binds it); once the
     codewords are <= STOP_SIZE they are sent in full instead.
  4. F_k(point) final evals are absorbed; queries sampled; each query opens
     the base leaf pair and every committed fold level's K-tuple pair, and
     the verifier replays each of the K fold chains down to the in-clear
     tail; tail k's own folds must collapse to the CONSTANT F_k(point),
     binding every per-point eval individually.

Per-point oracles are the soundness fix for the round-1 scheme, which folded
only the single combined oracle sum_k U^(k): that bound just sum_k F_k(point),
leaving K>=2 point evals under-constrained (a cheating prover could shift the
sumcheck messages by a constant and pick point_evals offsets d_k with
sum d_k = 0, sum eq_k(point) d_k = Delta — both checks passed while forging
arbitrary opening values). With one fold chain per point, each F_k(point) is
forced by its own chain's random spot checks (standard single-point Basefold
soundness applied K times with shared challenges).

The domain/variable-order trick that makes codeword folding bind the SAME
variable as a top-variable sumcheck round is documented in pcs/ntt.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..mle import ops
from ..sumcheck import prover as sc_prover
from ..sumcheck import verifier as sc_verifier
from ..sumcheck.prover import TermSpec
from ..utils import spans
from . import ntt
from .merkle import MerkleTree, hash_and_tree, gather_rows, verify_paths


@dataclass
class BasefoldParams:
    blowup_log: int = 3
    # conjectured security ~= n_queries * blowup_log + pow_bits (103 bits)
    n_queries: int = 29
    pow_bits: int = 16    # query-phase proof-of-work grinding bits
    stop_size: int = 256  # codeword sent in clear below this
    # PcsKind mirror: True = one stacked commitment per shard (pcs/jagged.py)
    jagged: bool = True
    # inner opening of the jagged batch: "basefold" or "whir" (pcs/whir.py)
    pcs_kind: str = "basefold"

    @property
    def blowup(self) -> int:
        return 1 << self.blowup_log


@dataclass
class Committed:
    """Prover-side commitment: evals, codeword and tree stay on the device."""

    cols: torch.Tensor      # (C, N) Montgomery evals
    codeword: torch.Tensor  # (C, M) Montgomery
    tree: MerkleTree
    n_vars: int

    @property
    def root(self) -> np.ndarray:
        return self.tree.root


@dataclass
class Claim:
    point_idx: int
    col_idx: int
    value: np.ndarray  # (4,) canonical


@dataclass
class QueryProof:
    index: int
    base_rows: np.ndarray   # (C, 2) canonical: rows (i, i+M/2)
    base_paths: np.ndarray  # (2, depth, 8)
    u_rows: list            # per committed fold level: (2, K, 4) canonical
    u_paths: list           # per committed fold level: (2, depth_t, 8)


@dataclass
class OpeningProof:
    sumcheck_msgs: np.ndarray  # (n, 3, 4) canonical
    fold_roots: list           # [(8,) canonical] for committed U_t levels
    tail: np.ndarray           # (K, S, 4) canonical in-clear codewords
    point_evals: np.ndarray    # (K, 4): F_k(point)
    queries: list = field(default_factory=list)
    pow_nonce: int = 0         # query-phase grinding nonce


_INV2 = bb.const(pow(2, bb.P - 2, bb.P))


@functools.lru_cache(maxsize=32)
def _invw_dev(log_m: int, device: str):
    """Device fold twiddles w_M^{-i} (Montgomery), cached per size."""
    return bb.to_device(ntt.domain_pow_inv(log_m), device)


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def combine_columns(cols, weights):
    """sum_j weights[:, j] * cols[j]: (C, N) x (4, C) Montgomery -> (4, N).

    A Montgomery column times a canonical weight, reduced mod p, is the
    Montgomery product, so each column costs one reduction."""
    w = bb.from_monty(weights).long()  # (4, C) canonical
    acc = torch.zeros((4, cols.shape[1]), dtype=torch.int64, device=cols.device)
    for j in range(cols.shape[0]):
        acc = (acc + cols[j].long()[None, :] * w[:, j : j + 1]) % bb.P
    return acc.to(bb.DTYPE)


def fold_codeword(u, r, invw):
    """One Basefold fold: (4, M) -> (4, M/2). invw (M/2,) Montgomery."""
    half = u.shape[-1] // 2
    a, b = u[..., :half], u[..., half:]
    s = ext4.add(a, b)
    d = ext4.mul_base(ext4.sub(a, b), invw)
    shape = (4,) + (1,) * (u.dim() - 1)
    out = ext4.add(s, ext4.mul(r.view(shape), d))
    return bb.mul_const(out, _INV2)


def fold_codewords(us, r, invw):
    """us (K, 4, M) -> (K, 4, M/2)."""
    return fold_codeword(us.transpose(0, 1), r, invw).transpose(0, 1).contiguous()


def fold_codewords_and_tree(us, r, invw):
    """Fold the K per-point oracles, then the Merkle tree over the
    concatenated (4K, M/2) rows (leaf i commits the K-tuple at position i):
    K1 with C = 4K rows, then K2 per level."""
    folded = fold_codewords(us, r, invw)
    k, _, m = folded.shape
    leaves, levels = hash_and_tree(folded.view(k * 4, m))
    return folded, leaves, levels


def _fold_host(u: np.ndarray, r: np.ndarray, invw: np.ndarray) -> np.ndarray:
    """Host fold on canonical (M, 4) arrays (the verifier's)."""
    half = u.shape[0] // 2
    a, b = u[:half], u[half:]
    s = exth.add(a, b)
    d = exth.mul_base(exth.sub(a, b), invw)
    out = exth.add(s, exth.mul(d, r[None, :]))
    return exth.mul_base(out, np.uint64(pow(2, bb.P - 2, bb.P)))


# ---------------------------------------------------------------------------
# Commit
# ---------------------------------------------------------------------------

def commit(cols, params: BasefoldParams = BasefoldParams(), device=None) -> Committed:
    """cols: (C, N) evals, a Montgomery int32 tensor (committed on its device)
    or a canonical numpy array (moved to ``device``, the card by default)."""
    if isinstance(cols, np.ndarray):
        cols = bb.to_device(cols, device or DEFAULT_DEVICE)
    n_vars = cols.shape[1].bit_length() - 1
    with spans.span("encode"):
        cw = ntt.encode(cols, blowup_log=params.blowup_log)
    with spans.span("merkle"):
        leaves, levels = hash_and_tree(cw)
        tree = MerkleTree.from_device(leaves, levels)
    return Committed(cols, cw, tree, n_vars)


# ---------------------------------------------------------------------------
# Open
# ---------------------------------------------------------------------------

def _claim_weights(claims: list[Claim], n_points: int, n_cols: int, gamma):
    """c_jk weight matrix (K, C, 4) canonical; batched claim value."""
    w = np.zeros((n_points, n_cols, 4), np.uint64)
    batched = np.zeros(4, np.uint64)
    cur = exth.one()
    for cl in claims:
        w[cl.point_idx, cl.col_idx] = cur
        batched = exth.add(batched, exth.mul(cur, np.asarray(cl.value, np.uint64)))
        cur = exth.mul(cur, gamma)
    return w, batched


def open_batch(
    committed: Committed,
    points: np.ndarray,  # (K, n, 4) canonical, LSB-first
    claims: list[Claim],
    transcript: Transcript,
    params: BasefoldParams = BasefoldParams(),
) -> OpeningProof:
    n_vars = committed.n_vars
    n = 1 << n_vars
    m = n << params.blowup_log
    n_cols = committed.cols.shape[0]
    k = points.shape[0]
    dev = committed.cols.device

    gamma = np.array(transcript.sample_ext(), np.uint64)
    w, _ = _claim_weights(claims, k, n_cols, gamma)

    # per-point eq columns, combined columns F_k and fold oracles U_0^(k)
    with spans.span("open-combine"):
        ext_cols = [ops.build_eq(bb.to_device(points[kk], dev)) for kk in range(k)]
        w_dev = [bb.to_device(w[kk].T, dev) for kk in range(k)]  # (4, C)
        ext_cols += [combine_columns(committed.cols, w_dev[kk]) for kk in range(k)]
        u = torch.stack(
            [combine_columns(committed.codeword, w_dev[kk]) for kk in range(k)]
        )  # (K, 4, M)
    term_list = [TermSpec(exth.one(), eidx=(kk, k + kk)) for kk in range(k)]

    fold_state = {
        "u": u,
        "log_m": n_vars + params.blowup_log,
        "levels": [],  # device (K, 4, M_t) oracles of the committed levels
        "trees": [],
        "tail": None,
    }

    def hook(rnd, ch):
        cur_log = fold_state["log_m"]
        invw = _invw_dev(cur_log, str(dev))
        new_m = 1 << (cur_log - 1)
        r = bb.to_device(ch, dev)
        fold_state["log_m"] = cur_log - 1
        if fold_state["tail"] is not None:
            fold_state["u"] = fold_codewords(fold_state["u"], r, invw)
            return  # already in clear; nothing to absorb
        if new_m <= params.stop_size or rnd == n_vars - 1:
            fold_state["u"] = fold_codewords(fold_state["u"], r, invw)
            # (K, 4, S) device -> (K, S, 4) canonical in-clear tail
            fold_state["tail"] = np.ascontiguousarray(
                bb.to_host(fold_state["u"]).transpose(0, 2, 1))
            transcript.append(fold_state["tail"].ravel())
            return
        with spans.span("fold-tree"):
            nu, leaves, levels = fold_codewords_and_tree(fold_state["u"], r, invw)
            tree = MerkleTree.from_device(leaves, levels)
        fold_state["u"] = nu
        fold_state["levels"].append(nu)
        fold_state["trees"].append(tree)
        transcript.append(tree.root)

    with spans.span("open-sumcheck+folds"):
        out = sc_prover.prove(
            [], ext_cols, term_list, n_vars, transcript, round_hook=hook
        )
    point_evals = out.final_ext[k : 2 * k]
    transcript.append(point_evals.ravel())

    # query phase (PoW grinding first: attacker pays 2^pow_bits sponge
    # permutations per query-set attempt)
    with spans.span("grind"):
        pow_nonce = transcript.grind(params.pow_bits)
    n_committed = len(fold_state["trees"])
    idxs = [transcript.sample_base() % (m // 2) for _ in range(params.n_queries)]

    with spans.span("query-open"):
        base_pairs = np.array([[i, i + m // 2] for i in idxs], np.int64).ravel()
        base_rows = bb.to_host(gather_rows(committed.codeword, base_pairs))  # (C, 2Q)
        base_paths_all = committed.tree.open_paths(base_pairs)  # (2Q, d, 8)
        level_rows, tree_paths = [], []
        for t in range(n_committed):
            mt = m >> (t + 1)
            pair_idx = np.array(
                [[i % (mt // 2), i % (mt // 2) + mt // 2] for i in idxs], np.int64
            ).ravel()
            lv = fold_state["levels"][t]  # (K, 4, mt)
            vals = bb.to_host(gather_rows(lv.view(k * 4, mt), pair_idx))
            level_rows.append(vals.reshape(k, 4, -1).transpose(2, 0, 1))  # (2Q, K, 4)
            tree_paths.append(fold_state["trees"][t].open_paths(pair_idx))
    queries = []
    for qi, i in enumerate(idxs):
        queries.append(
            QueryProof(
                i, base_rows[:, 2 * qi : 2 * qi + 2],
                base_paths_all[2 * qi : 2 * qi + 2],
                [level_rows[t][2 * qi : 2 * qi + 2] for t in range(n_committed)],
                [tree_paths[t][2 * qi : 2 * qi + 2] for t in range(n_committed)],
            )
        )

    return OpeningProof(
        out.proof.round_msgs,
        [t.root for t in fold_state["trees"]],
        fold_state["tail"],
        point_evals,
        queries,
        pow_nonce,
    )


# ---------------------------------------------------------------------------
# Verify (numpy, a copy of the reference's)
# ---------------------------------------------------------------------------

class PCSError(Exception):
    pass


def verify_batch(
    root: np.ndarray,
    n_vars: int,
    n_cols: int,
    points: np.ndarray,
    claims: list[Claim],
    proof: OpeningProof,
    transcript: Transcript,
    params: BasefoldParams = BasefoldParams(),
):
    from ..utils import replay

    _chk = not replay.structure_only()
    n = 1 << n_vars
    m = n << params.blowup_log
    k = points.shape[0]
    gamma = np.array(transcript.sample_ext(), np.uint64)
    w, batched_claim = _claim_weights(claims, k, n_cols, gamma)

    n_committed = len(proof.fold_roots)
    state = {"next_root": 0, "tail_seen": False, "chals": []}

    def hook(rnd, ch):
        state["chals"].append(ch)
        new_m = m >> (rnd + 1)
        if state["tail_seen"]:
            return
        if new_m <= params.stop_size or rnd == n_vars - 1:
            transcript.append(np.asarray(proof.tail, np.uint64).ravel())
            state["tail_seen"] = True
        else:
            transcript.append(proof.fold_roots[state["next_root"]])
            state["next_root"] += 1

    point, final_claim = sc_verifier.verify(
        batched_claim, proof.sumcheck_msgs, n_vars, transcript, deg=2,
        round_hook=hook,
    )
    if state["next_root"] != n_committed:
        raise PCSError("fold root count mismatch")
    chals = state["chals"]

    # sumcheck recombination: sum_k eq_k(point) * F_k(point)
    acc = np.zeros(4, np.uint64)
    for kk in range(k):
        eq_v = exth.eq_eval(points[kk].astype(np.uint64), point.astype(np.uint64))
        acc = exth.add(acc, exth.mul(eq_v, proof.point_evals[kk]))
    if _chk and not np.array_equal(acc, final_claim):
        raise PCSError("opening sumcheck recombination mismatch")
    transcript.append(np.asarray(proof.point_evals, np.uint64).ravel())

    # each tail k folds to the CONSTANT F_k(point) — binds every point eval
    tail = np.asarray(proof.tail, np.uint64)
    tail_rounds_done = n_committed + 1  # folds before the tail was emitted
    tail_log = (m.bit_length() - 1) - tail_rounds_done
    if tail.ndim != 3 or tail.shape != (k, 1 << tail_log, 4):
        raise PCSError("tail shape mismatch")
    for kk in range(k):
        cur = tail[kk]
        tl = tail_log
        for t in range(tail_rounds_done, n_vars):
            cur = _fold_host(cur, chals[t], ntt.domain_pow_inv(tl))
            tl -= 1
        pe = np.asarray(proof.point_evals[kk], np.uint64)
        if _chk and not all(np.array_equal(cur[i], pe) for i in range(cur.shape[0])):
            raise PCSError(f"tail {kk} is not the constant F_k(point)")

    # query phase
    # check_grind ALWAYS runs (it absorbs the nonce + samples — part of the
    # transcript sequence); only the bound check is waived in replay
    if not transcript.check_grind(proof.pow_nonce, params.pow_bits) and _chk:
        raise PCSError("proof-of-work grinding check failed")
    idxs = [transcript.sample_base() % (m // 2) for _ in range(params.n_queries)]
    if [q.index for q in proof.queries] != idxs:
        raise PCSError("query indices do not match transcript")
    inv2 = np.uint64(pow(2, bb.P - 2, bb.P))

    # batched Merkle membership (one Poseidon2 batch per tree level)
    base_idx = [q.index for q in proof.queries] + [
        q.index + m // 2 for q in proof.queries
    ]
    base_vals = np.concatenate(
        [
            np.stack([q.base_rows[:, 0] for q in proof.queries]),
            np.stack([q.base_rows[:, 1] for q in proof.queries]),
        ]
    )
    base_paths = np.concatenate(
        [
            np.stack([q.base_paths[0] for q in proof.queries]),
            np.stack([q.base_paths[1] for q in proof.queries]),
        ]
    )
    if _chk and not verify_paths(root, base_idx, base_vals, base_paths):
        raise PCSError("base Merkle paths invalid")
    for t in range(n_committed):
        mt = m >> (t + 1)
        pos = [q.index % (mt // 2) for q in proof.queries]
        lvl_idx = pos + [p + mt // 2 for p in pos]
        rows_t = [np.asarray(q.u_rows[t], np.uint64) for q in proof.queries]
        for rt in rows_t:
            if rt.shape != (2, k, 4):
                raise PCSError(f"fold level {t} row shape mismatch")
        lvl_vals = np.concatenate(
            [
                np.stack([rt[0].reshape(-1) for rt in rows_t]),
                np.stack([rt[1].reshape(-1) for rt in rows_t]),
            ]
        )
        lvl_paths = np.concatenate(
            [
                np.stack([q.u_paths[t][0] for q in proof.queries]),
                np.stack([q.u_paths[t][1] for q in proof.queries]),
            ]
        )
        if _chk and not verify_paths(proof.fold_roots[t], lvl_idx, lvl_vals, lvl_paths):
            raise PCSError(f"fold level {t} Merkle paths invalid")

    for q in proof.queries:
        i = q.index
        # per-point U_0^(k) pairs from base rows
        pairs = []
        for kk in range(k):
            pair = []
            for s in range(2):
                v = np.zeros(4, np.uint64)
                for j in range(n_cols):
                    v = exth.add(v, exth.mul_base(w[kk, j], int(q.base_rows[j, s])))
                pair.append(v)
            pairs.append(pair)
        cur_log = m.bit_length() - 1
        p = i
        for t in range(tail_rounds_done):
            invw = ntt.domain_pow_inv(cur_log)[p]
            folded = []
            for kk in range(k):
                a, b = pairs[kk]
                folded.append(
                    exth.mul_base(
                        exth.add(
                            exth.add(a, b),
                            exth.mul(exth.mul_base(exth.sub(a, b), invw), chals[t]),
                        ),
                        inv2,
                    )
                )
            if t < n_committed:
                # membership of rows was verified in the batched pass above
                rows = np.asarray(q.u_rows[t], np.uint64)  # (2, K, 4)
                mt = 1 << (cur_log - 1)
                pnext = p % (mt // 2)
                slot = 0 if p < mt // 2 else 1
                for kk in range(k):
                    if _chk and not np.array_equal(folded[kk], rows[slot, kk]):
                        raise PCSError(
                            f"query {i}: fold level {t} value mismatch (point {kk})"
                        )
                pairs = [[rows[0, kk], rows[1, kk]] for kk in range(k)]
                p = pnext
                cur_log -= 1
            else:
                # folded lands in the in-clear tails
                for kk in range(k):
                    if _chk and not np.array_equal(folded[kk], tail[kk, p]):
                        raise PCSError(f"query {i}: tail value mismatch (point {kk})")
                break
    return True
