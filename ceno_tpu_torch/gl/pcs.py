"""Basefold PCS over Goldilocks: commit, batch-open and verify.

Counterpart of ``ceno_tpu/gl/pcs.py`` for the `--field goldilocks`
configuration, restricted to the single-point multi-column batch: commit C
columns of height N = 2^n, open every column at one shared point z.

Same domain contract as pcs/ntt.py: the committed codeword is the NTT of
the VARIABLE-REVERSED multilinear in natural domain order, so the
contiguous-halves fold (pairs i, i + M/2, twiddle w^{-i}) binds the same
variable as a top-variable sumcheck round. Rounds interleave:

  sum_x F(x) * eq(z, x) = sum_c gamma^c y_c     with F = sum_c gamma^c f_c

each round folds the F-codeword with the sampled alpha; folded levels are
Merkle-committed until ``stop_size``, then sent in clear; the query phase
(after PoW grinding) spot-checks every fold against the base commitment.

:func:`encode`, :class:`GlTree`, :func:`commit` and :func:`open_batch` run
on the tensors' device: the encode is K14a, every tree (the commitment's
and the opening's fold trees, whose leaves are the (2, M) ext codeword) is
K14b then K14c (gl/device.py); the gamma combination and the folds are
plain torch. The reference's ``CENO_GL_DEVICE`` / ``CENO_GL_HOST_N`` gate
(``_use_device``) is gone: the port has no crossover. :func:`verify_batch`
stays host numpy, with single-state Poseidon2 in Python ints.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import gl2_host as g2
from ..fields import goldilocks as gld
from ..fields import goldilocks_ext2 as gx
from ..utils import spans
from . import device as gdev
from . import poseidon2 as p2
from . import sumcheck as sc

_INV2 = pow(2, gl.P - 2, gl.P)
_CHUNK = 1 << 24  # elements of a gamma combination's intermediates


class GlPCSError(Exception):
    pass


@dataclass
class GlParams:
    blowup_log: int = 3
    n_queries: int = 29
    pow_bits: int = 16
    stop_size: int = 64


def fold_twiddle(log_m: int, i: int) -> int:
    """w_M^{-i} / 2: the fold twiddle of pair i (host)."""
    w_inv = pow(gl.two_adic_root(log_m), gl.P - 2, gl.P)
    return pow(w_inv, i, gl.P) * _INV2 % gl.P


@functools.lru_cache(maxsize=None)
def _fold_twiddles(log_m: int, device: torch.device) -> torch.Tensor:
    """(M/2,) w_M^{-i} / 2 on ``device``."""
    w_inv = pow(gl.two_adic_root(log_m), gl.P - 2, gl.P)
    tw = gld.powers(w_inv, 1 << (log_m - 1), device)
    return gld.mul(tw, torch.full_like(tw, gld.const(_INV2)))


def encode(evals: torch.Tensor, blowup_log: int) -> torch.Tensor:
    """(C, N) canonical -> (C, N << blowup) codewords (K14a)."""
    return gdev.encode(evals, blowup_log)


# -- Merkle (Poseidon2-GL, 4-element digests) --------------------------------

@dataclass
class GlTree:
    levels: list  # levels[0] = (4, M) leaf digests, ..., last = (4, 1) root; tensors

    @property
    def root(self) -> np.ndarray:
        return gld.to_host(self.levels[-1][:, 0])

    @staticmethod
    def build(leaf_cols: torch.Tensor) -> "GlTree":
        """leaf_cols: (C, M) canonical; leaf i hashes the column slice [:, i]."""
        return GlTree(gdev.tree_levels(leaf_cols.contiguous()))

    def open_paths(self, idxs) -> np.ndarray:
        """(len(idxs), depth, 4) sibling digests of each leaf index, one
        gather a level and one copy to the host."""
        idx = torch.as_tensor(np.asarray(idxs, np.int64), device=self.levels[0].device)
        depth = len(self.levels) - 1
        if depth == 0:
            return np.zeros((len(idxs), 0, 4), np.uint64)
        sib = torch.stack([lvl[:, (idx >> l) ^ 1] for l, lvl in enumerate(self.levels[:-1])])
        return gld.to_host(sib).transpose(2, 0, 1).copy()

    def open_path(self, idx: int) -> np.ndarray:
        """(depth, 4) sibling digests."""
        return self.open_paths([idx])[0]


def _leaf_digest(col_vals: np.ndarray) -> np.ndarray:
    """(C,) canonical leaf values -> (4,) digest (single leaf, host)."""
    st = [0] * p2.WIDTH
    vals = [int(v) for v in np.asarray(col_vals, np.uint64)]
    for i in range(0, len(vals), p2.RATE):
        for j, v in enumerate(vals[i: i + p2.RATE]):
            st[j] = (st[j] + v) % gl.P
        st = p2._permute_one(st)
    return np.array(st[: p2.CAPACITY], np.uint64)


def _verify_path(root, idx: int, leaf_digest: np.ndarray, path: np.ndarray) -> bool:
    cur = [int(x) for x in np.asarray(leaf_digest, np.uint64)]
    i = idx
    for sib in np.asarray(path, np.uint64):
        sib = [int(x) for x in sib]
        cur = p2._permute_one(sib + cur if i & 1 else cur + sib)[: p2.CAPACITY]
        i >>= 1
    return bool(np.array_equal(np.array(cur, np.uint64), np.asarray(root, np.uint64)))


# -- commit / open / verify ---------------------------------------------------

@dataclass
class GlCommitted:
    cols: torch.Tensor       # (C, N) canonical
    codeword: torch.Tensor   # (C, M)
    tree: GlTree
    n_vars: int

    @property
    def root(self):
        return self.tree.root


@dataclass
class GlQuery:
    index: int
    base_col_vals: np.ndarray  # (2, C) rows at idx, idx + M/2
    base_paths: np.ndarray     # (2, depth, 4)
    level_vals: list           # per committed fold level: (2, 2) ext pair
    level_paths: list          # per committed fold level: (2, depth, 4)


@dataclass
class GlOpening:
    round_msgs: np.ndarray     # (n, 3, 2) translation sumcheck messages
    fold_roots: list           # [(4,)] committed fold levels
    tail: np.ndarray           # (S, 2) in-clear final codeword
    queries: list = field(default_factory=list)
    pow_nonce: int = 0


def commit(cols, params: GlParams, device=None) -> GlCommitted:
    """Commit (C, N) canonical columns: a tensor stays on its device, numpy
    goes to ``device`` (the card when None)."""
    if not isinstance(cols, torch.Tensor):
        cols = gld.to_device(cols, "cuda" if device is None else device)
    cols = cols.contiguous()
    cw, tree = gdev.commit_device(cols, params.blowup_log)
    return GlCommitted(cols, cw, tree, cols.shape[1].bit_length() - 1)


def _fold_cw(u: torch.Tensor, alpha: torch.Tensor, log_m: int) -> torch.Tensor:
    """(M, 2) ext codeword -> (M/2, 2): pairs (i, i+M/2), twiddle w^{-i}."""
    half = u.shape[0] // 2
    a, b = u[:half], u[half:]
    s = gx.mul_base(gx.add(a, b), torch.full_like(a[:, 0], gld.const(_INV2)))
    d = gx.mul_base(gx.sub(a, b), _fold_twiddles(log_m, u.device))
    return gx.add(s, gx.mul(d, alpha))


def gamma_combine(gammas: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """sum_j gammas[j] * mat[j]: (C, 2) ext weights over (C, L) base rows ->
    (L, 2), a chunk of rows at a time."""
    c, length = mat.shape
    step = max(1, _CHUNK // max(length, 1))
    acc = None
    for j in range(0, c, step):
        part = gx.sum_mod(gx.mul_base(gammas[j: j + step, None, :], mat[j: j + step]), 0)
        acc = part if acc is None else gx.add(acc, part)
    return acc


def open_batch(committed: GlCommitted, z: np.ndarray, values: np.ndarray,
               transcript, params: GlParams) -> GlOpening:
    """Open every column at z (round-order point, (n, 2)); values (C, 2)."""
    c, n = committed.cols.shape
    n_vars = committed.n_vars
    log_m0 = n_vars + params.blowup_log
    dev = committed.cols.device
    if params.stop_size < (1 << params.blowup_log):
        raise GlPCSError("stop_size must be >= the blowup")
    gammas = gx.to_device(transcript.sample_ext_pows(c), dev)

    f = gamma_combine(gammas, committed.cols)
    cw = gamma_combine(gammas, committed.codeword)
    eq = sc.build_eq(np.asarray(z, np.uint64), dev)

    fold_trees: list = []
    fold_levels: list = []
    state = {"cw": cw, "log_m": log_m0, "tail": None}

    def hook(r, alpha):
        state["cw"] = _fold_cw(state["cw"], gx.to_device(alpha, dev), state["log_m"])
        state["log_m"] -= 1
        if state["tail"] is not None:
            return
        cur = state["cw"]
        if cur.shape[0] <= params.stop_size:
            state["tail"] = gx.to_host(cur)
            transcript.append(state["tail"].ravel())
        else:
            with spans.span("fold-tree"):
                tree = GlTree.build(cur.T)
            fold_trees.append(tree)
            fold_levels.append(cur)
            transcript.append(tree.root)

    out = sc.prove([], [f, eq], [(g2.one(), (), (0, 1))], n_vars,
                   transcript, round_hook=hook)
    if state["tail"] is None:
        state["tail"] = gx.to_host(state["cw"])
        transcript.append(state["tail"].ravel())

    with spans.span("grind"):
        pow_nonce = transcript.grind(params.pow_bits)
    m0 = 1 << log_m0
    idxs = [transcript.sample_base() % (m0 // 2) for _ in range(params.n_queries)]
    with spans.span("queries"):
        queries = _queries(committed, fold_trees, fold_levels, idxs, m0)
    return GlOpening(out.round_msgs, [t_.root for t_ in fold_trees],
                     state["tail"], queries, pow_nonce)


def _queries(committed, fold_trees, fold_levels, idxs, m0) -> list:
    """Every query's rows, values and paths, each gathered for all queries
    at once on the device."""
    dev = committed.codeword.device
    pairs = [p for i in idxs for p in (i, i + m0 // 2)]
    base_vals = gld.to_host(committed.codeword[:, torch.as_tensor(pairs, device=dev)]).T
    base_paths = committed.tree.open_paths(pairs)
    lvl_vals, lvl_paths = [], []
    for t, tree in enumerate(fold_trees):
        mt = m0 >> (t + 1)
        pos = [p for i in idxs for p in (i % (mt // 2), i % (mt // 2) + mt // 2)]
        lvl_vals.append(gx.to_host(fold_levels[t][torch.as_tensor(pos, device=dev)]))
        lvl_paths.append(tree.open_paths(pos))
    queries = []
    for q, i in enumerate(idxs):
        rows = slice(2 * q, 2 * q + 2)
        queries.append(GlQuery(i, base_vals[rows].copy(), base_paths[rows].copy(),
                               [v[rows].copy() for v in lvl_vals],
                               [p[rows].copy() for p in lvl_paths]))
    return queries


def _fold_pair_host(pair: np.ndarray, log_m: int, p0: int, alpha: np.ndarray) -> np.ndarray:
    tw = np.uint64(fold_twiddle(log_m, p0))
    s_ = g2.mul_base(g2.add(pair[0], pair[1]), np.uint64(_INV2))
    d_ = g2.mul_base(g2.sub(pair[0], pair[1]), tw)
    return g2.add(s_, g2.mul(d_, alpha))


def _fold_cw_host(u: np.ndarray, alpha: np.ndarray, log_m: int) -> np.ndarray:
    """Host fold of a short (M, 2) codeword (the verifier's tail)."""
    half = u.shape[0] // 2
    return np.stack([_fold_pair_host(np.stack([u[i], u[i + half]]), log_m, i, alpha)
                     for i in range(half)])


def verify_batch(root: np.ndarray, n_vars: int, n_cols: int, z: np.ndarray,
                 values: np.ndarray, proof: GlOpening, transcript,
                 params: GlParams) -> None:
    log_m0 = n_vars + params.blowup_log
    m0 = 1 << log_m0
    gammas = transcript.sample_ext_pows(n_cols)
    claim = np.zeros(2, np.uint64)
    for j in range(n_cols):
        claim = g2.add(claim, g2.mul(gammas[j], np.asarray(values[j], np.uint64)))

    # expected number of committed fold levels from PUBLIC sizes only (a
    # prover must not get to choose where the in-clear tail starts); the
    # stop_size >= blowup guard means the tail appears by round n_vars - 1
    if params.stop_size < (1 << params.blowup_log):
        raise GlPCSError("stop_size must be >= the blowup")
    n_committed = 0
    while (m0 >> (n_committed + 1)) > params.stop_size:
        n_committed += 1
    if n_committed >= n_vars:
        raise GlPCSError("stop_size too small for this height")
    if len(proof.fold_roots) != n_committed:
        raise GlPCSError("fold level count mismatch")
    tail = np.asarray(proof.tail, np.uint64)
    if tail.shape != (m0 >> (n_committed + 1), 2):
        raise GlPCSError("bad tail shape")

    # replay rounds, absorbing fold roots / tail at the same positions
    msgs = np.asarray(proof.round_msgs, np.uint64)
    if msgs.shape != (n_vars, 3, 2):
        raise GlPCSError("bad round message shape")
    cur = claim
    point = np.zeros((n_vars, 2), np.uint64)
    tail_at = n_committed
    for r in range(n_vars):
        if not np.array_equal(g2.add(msgs[r, 0], msgs[r, 1]), cur):
            raise GlPCSError(f"round {r}: g(0)+g(1) != claim")
        transcript.append(msgs[r].ravel())
        point[r] = transcript.sample_ext()
        cur = sc.lagrange_extrapolate(msgs[r], point[r])
        if r < n_committed:
            transcript.append(np.asarray(proof.fold_roots[r], np.uint64))
        elif r == n_committed:
            transcript.append(tail.ravel())

    # final claim: F(point) * eq(z, point) where F(point) comes from folding
    # the in-clear tail with the remaining challenges
    cur_cw = tail
    log_mt = log_m0 - (tail_at + 1)
    for r in range(tail_at + 1, n_vars):
        cur_cw = _fold_cw_host(cur_cw, point[r], log_mt)
        log_mt -= 1
    # after all n_vars folds the codeword is the constant F(point), blown up
    f_pt = cur_cw[0]
    if not all(np.array_equal(cur_cw[i], f_pt) for i in range(cur_cw.shape[0])):
        raise GlPCSError("tail does not fold to a constant")
    eq_zp = g2.eq_eval(np.asarray(z, np.uint64), point)
    if not np.array_equal(g2.mul(f_pt, eq_zp), cur):
        raise GlPCSError("final claim mismatch")

    # queries
    if not transcript.check_grind(proof.pow_nonce, params.pow_bits):
        raise GlPCSError("proof-of-work grinding check failed")
    idxs = [transcript.sample_base() % (m0 // 2) for _ in range(params.n_queries)]
    if [q.index for q in proof.queries] != idxs:
        raise GlPCSError("query indices do not match transcript")
    for q in proof.queries:
        pair = [q.index, q.index + m0 // 2]
        vals = np.asarray(q.base_col_vals, np.uint64)
        if vals.shape != (2, n_cols):
            raise GlPCSError("bad base row shape")
        for s in range(2):
            if not _verify_path(root, pair[s], _leaf_digest(vals[s]),
                                q.base_paths[s]):
                raise GlPCSError(f"query {q.index}: base path invalid")
        # gamma-combine, then walk the folds
        cur_pair = np.stack([
            _gamma_combine(gammas, vals[0]), _gamma_combine(gammas, vals[1])
        ])
        i = q.index
        log_mt = log_m0
        for t in range(n_vars):
            mt = 1 << log_mt
            p0 = i % (mt // 2)
            nxt = _fold_pair_host(cur_pair, log_mt, p0, point[t])
            mt2 = mt // 2
            if t == tail_at:
                if not np.array_equal(nxt, tail[p0]):
                    raise GlPCSError(f"query {q.index}: tail value mismatch")
                break
            # committed level t: fetch the pair for the NEXT fold
            lv = np.asarray(q.level_vals[t], np.uint64)
            p1 = p0 % (mt2 // 2)
            pos_in_pair = 0 if p0 < mt2 // 2 else 1
            if not np.array_equal(nxt, lv[pos_in_pair]):
                raise GlPCSError(f"query {q.index}: fold level {t} mismatch")
            lroot = np.asarray(proof.fold_roots[t], np.uint64)
            for s in range(2):
                leaf = _leaf_digest(lv[s])
                pos = p1 + s * (mt2 // 2)
                if not _verify_path(lroot, pos, leaf, q.level_paths[t][s]):
                    raise GlPCSError(f"query {q.index}: level {t} path invalid")
            cur_pair = lv
            i = p1
            log_mt -= 1


def _gamma_combine(gammas: np.ndarray, base_vals: np.ndarray) -> np.ndarray:
    acc = np.zeros(2, np.uint64)
    for j in range(base_vals.shape[0]):
        acc = g2.add(acc, g2.mul(gammas[j], g2.from_base(base_vals[j])))
    return acc
