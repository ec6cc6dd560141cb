"""Tower arguments: grand products and LogUp fraction sums over record MLEs.

Counterpart of ``ceno_tpu/gkr/tower.py``, its per-level path: the layers are
built as plain torch on the records' device, every level's batched degree-3
sumcheck runs through :func:`ceno_tpu_torch.sumcheck.prover.prove` on that
device, and the verifier replays the transcript on the host in numpy. The
reference's size crossover (``_TOWER_HOST_N`` and its host mirrors of small
layers) has no counterpart: the 2-entry levels run on the device too. Its
fused all-levels branch (``_prove_levels_fused``) gives the same bytes and is
not ported yet.

Protocol (this framework's convention — halves split instead of the
reference's interleave, matching our top-variable fold):
  * layer k has 2^k entries; parent entries pair the two contiguous halves of
    layer k+1: prod: v_k = L*R; logup: p_k = pL*qR + pR*qL, q_k = qL*qR where
    L/R = first/second half.
  * The proof starts from layer 1 (2 values per spec, absorbed as out_evals);
    the verifier computes the total product / fraction itself.
  * Level k proves layer-k claims at point rt from layer k+1 via ONE batched
    degree-3 sumcheck over k vars: fresh alpha-powers batch all specs' claims,
    a single shared eq(rt, .) column, then evals (L_s, R_s / pL,pR,qL,qR per
    spec) are absorbed and one mu challenge extends the point: rt' = r ++ [mu].
  * After the last level the per-spec claims are the *record MLE* evaluations
    at the final point — handed to the main constraint sumcheck, which relates
    records to committed witness columns.

Transcript order (fixed contract, see verify_towers):
  out_evals (prod then logup) -> rt -> per level: alpha-pows, round msgs,
  evals, mu.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..mle import ops
from ..sumcheck import prover as sc_prover
from ..sumcheck import verifier as sc_verifier
from ..sumcheck.prover import TermSpec


# ---------------------------------------------------------------------------
# Witness layer inference (device)
# ---------------------------------------------------------------------------

def product_layers(v):
    """All layers of the product tree, input (4, N) ext -> [layer1, ..., input].

    layers[k-1] has 2^k entries (k = 1..n)."""
    layers = [v]
    while v.shape[-1] > 2:
        half = v.shape[-1] // 2
        v = ext4.mul(v[:, :half], v[:, half:])
        layers.append(v)
    return tuple(reversed(layers))


def logup_layers(p, q):
    """Fraction-sum tree: returns (p_layers, q_layers) tuples, layer1 first."""
    ps, qs = [p], [q]
    while p.shape[-1] > 2:
        half = p.shape[-1] // 2
        pl, pr = p[:, :half], p[:, half:]
        ql, qr = q[:, :half], q[:, half:]
        p = ext4.add(ext4.mul(pl, qr), ext4.mul(pr, ql))
        q = ext4.mul(ql, qr)
        ps.append(p)
        qs.append(q)
    return tuple(reversed(ps)), tuple(reversed(qs))


def split_specs(layers):
    """Split each (4, 2h) layer into contiguous halves, returned as ONE
    (4, 2*S, h) block (cols ordered [lo_0, hi_0, lo_1, hi_1, ...]); the
    sumcheck banks accept (4, k, N) blocks."""
    half = layers[0].shape[-1] // 2
    return torch.stack(
        [part for l in layers for part in (l[:, :half], l[:, half:])], dim=1
    )


# ---------------------------------------------------------------------------
# Proof container
# ---------------------------------------------------------------------------

@dataclass
class TowerProof:
    prod_out: np.ndarray    # (S_p, 2, 4) canonical layer-1 values
    logup_out: np.ndarray   # (S_l, 2, 2, 4): [spec][p|q][slot] canonical
    round_msgs: list = field(default_factory=list)  # per level (k, deg+1, 4)
    level_evals: list = field(default_factory=list)  # per level (n_evals, 4)


def _fold_two(v0, v1, r):
    """(1-r)*v0 + r*v1 on host canonical ext values."""
    return exth.add(v0, exth.mul(r, exth.sub(v1, v0)))


def _fold_claims(evals, mu, n_prod: int, n_logup: int):
    """Next level's claims from this level's evals: each (L, R) pair folded
    by mu, in the order the evals were absorbed."""
    e = 0
    prod, logup = [], []
    for _ in range(n_prod):
        prod.append(_fold_two(evals[e], evals[e + 1], mu))
        e += 2
    for _ in range(n_logup):
        logup.append(
            [_fold_two(evals[e], evals[e + 1], mu), _fold_two(evals[e + 2], evals[e + 3], mu)]
        )
        e += 4
    return prod, logup


def _stack_claims(prod_claims, logup_claims):
    return (
        np.stack(prod_claims) if prod_claims else np.zeros((0, 4), np.uint64),
        np.stack([np.stack(c) for c in logup_claims])
        if logup_claims else np.zeros((0, 2, 4), np.uint64),
    )


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------

def prove_towers(
    prod_records: list,
    logup_records: list,
    transcript: Transcript,
):
    """Prove grand products / logup sums of ext record MLEs (device Monty).

    ``prod_records``: list of (4, N) tensors. ``logup_records``: list of
    (p, q) pairs of (4, N). All must share the same N = 2^n, n >= 1, and one
    device, where every layer and level runs.
    Returns (TowerProof, final_point (n,4) canonical, record_claims) where
    record_claims = (prod_claims (S_p, 4), logup_claims (S_l, 2, 4)).
    """
    n_vars = ops.num_vars(prod_records[0] if prod_records else logup_records[0][0])
    dev = (prod_records[0] if prod_records else logup_records[0][0]).device
    prod_lys = [product_layers(v) for v in prod_records]
    logup_lys = [logup_layers(p, q) for p, q in logup_records]

    def canon2(x):  # (4, k) device -> (k, 4) canonical host
        return bb.to_host(x).T

    prod_out = (
        np.stack([canon2(ls[0]) for ls in prod_lys])
        if prod_lys else np.zeros((0, 2, 4), np.uint64)
    )
    logup_out = (
        np.stack([np.stack([canon2(pl[0]), canon2(ql[0])]) for pl, ql in logup_lys])
        if logup_lys else np.zeros((0, 2, 2, 4), np.uint64)
    )
    proof = TowerProof(prod_out, logup_out)

    for s in range(len(prod_lys)):
        transcript.append(prod_out[s].ravel())
    for s in range(len(logup_lys)):
        transcript.append(logup_out[s].ravel())

    rt = np.array([transcript.sample_ext()], np.uint64)  # (1, 4) point
    # initial claims at layer 1
    prod_claims = [_fold_two(prod_out[s][0], prod_out[s][1], rt[0]) for s in range(len(prod_lys))]
    logup_claims = [
        [
            _fold_two(logup_out[s][0][0], logup_out[s][0][1], rt[0]),
            _fold_two(logup_out[s][1][0], logup_out[s][1][1], rt[0]),
        ]
        for s in range(len(logup_lys))
    ]

    for level in range(1, n_vars):
        n_claims = len(prod_claims) + 2 * len(logup_claims)
        alphas = transcript.sample_ext_pows(n_claims)
        level_layers = [ls[level] for ls in prod_lys] + [
            lys[i][level] for lys in logup_lys for i in (0, 1)
        ]
        # ext bank: eq at 0, then 2 half-columns per layer in layer order, as
        # one stacked block; the column positions fix the terms and so the
        # proof bytes
        ext_cols = [ops.build_eq(bb.to_device(rt, dev)), split_specs(level_layers)]
        term_list = []
        a = 0
        li = 1
        for s in range(len(prod_lys)):
            term_list.append(TermSpec(alphas[a], eidx=(0, li, li + 1)))
            li += 2
            a += 1
        for s in range(len(logup_lys)):
            pL, pR, qL, qR = li, li + 1, li + 2, li + 3
            li += 4
            term_list.append(TermSpec(alphas[a], eidx=(0, pL, qR)))
            term_list.append(TermSpec(alphas[a], eidx=(0, pR, qL)))
            term_list.append(TermSpec(alphas[a + 1], eidx=(0, qL, qR)))
            a += 2
        out = sc_prover.prove([], ext_cols, term_list, level, transcript)
        proof.round_msgs.append(out.proof.round_msgs)
        # evals: per spec the half evaluations at the sumcheck point
        evals = out.final_ext[1:]  # drop eq
        proof.level_evals.append(evals.copy())
        transcript.append(evals.ravel())
        mu = np.array(transcript.sample_ext(), np.uint64)
        # fold claims and extend point: rt' = point ++ [mu] (mu binds top var)
        rt = np.concatenate([out.point, mu[None, :]], axis=0)
        prod_claims, logup_claims = _fold_claims(evals, mu, len(prod_lys), len(logup_lys))

    return proof, rt, _stack_claims(prod_claims, logup_claims)


# ---------------------------------------------------------------------------
# Verifier (host)
# ---------------------------------------------------------------------------

class TowerError(Exception):
    pass


def verify_towers(
    proof: TowerProof,
    n_vars: int,
    transcript: Transcript,
):
    """Replays the prover's transcript; returns (final_point, prod_claims,
    logup_claims, prod_values (S_p,4), logup_fractions (S_l, 2, 4)).

    prod_values[s] is the claimed total product; logup_fractions[s] = (p, q)
    of the claimed total fraction sum. Raises TowerError on any mismatch.
    """
    s_p = proof.prod_out.shape[0]
    s_l = proof.logup_out.shape[0]
    for s in range(s_p):
        transcript.append(proof.prod_out[s].ravel())
    for s in range(s_l):
        transcript.append(proof.logup_out[s].ravel())

    # totals from layer-1 outs
    prod_values = np.stack(
        [exth.mul(proof.prod_out[s][0], proof.prod_out[s][1]) for s in range(s_p)]
    ) if s_p else np.zeros((0, 4), np.uint64)
    logup_fracs = []
    for s in range(s_l):
        p0, p1 = proof.logup_out[s][0]
        q0, q1 = proof.logup_out[s][1]
        logup_fracs.append(
            np.stack([
                exth.add(exth.mul(p0, q1), exth.mul(p1, q0)),
                exth.mul(q0, q1),
            ])
        )
    logup_fracs = np.stack(logup_fracs) if s_l else np.zeros((0, 2, 4), np.uint64)

    rt = np.array([transcript.sample_ext()], np.uint64)
    prod_claims = [
        _fold_two(proof.prod_out[s][0], proof.prod_out[s][1], rt[0]) for s in range(s_p)
    ]
    logup_claims = [
        [
            _fold_two(proof.logup_out[s][0][0], proof.logup_out[s][0][1], rt[0]),
            _fold_two(proof.logup_out[s][1][0], proof.logup_out[s][1][1], rt[0]),
        ]
        for s in range(s_l)
    ]
    if len(proof.round_msgs) != n_vars - 1 or len(proof.level_evals) != n_vars - 1:
        raise TowerError(f"expected {n_vars - 1} levels, the proof has "
                         f"{len(proof.round_msgs)} / {len(proof.level_evals)}")

    for level in range(1, n_vars):
        n_claims = s_p + 2 * s_l
        alphas = transcript.sample_ext_pows(n_claims)
        batched = np.zeros(4, np.uint64)
        a = 0
        for s in range(s_p):
            batched = exth.add(batched, exth.mul(alphas[a], prod_claims[s]))
            a += 1
        for s in range(s_l):
            batched = exth.add(batched, exth.mul(alphas[a], logup_claims[s][0]))
            batched = exth.add(batched, exth.mul(alphas[a + 1], logup_claims[s][1]))
            a += 2
        point, final_claim = sc_verifier.verify(
            batched, proof.round_msgs[level - 1], level, transcript, deg=3
        )
        evals = np.asarray(proof.level_evals[level - 1], np.uint64)
        if evals.shape != (2 * s_p + 4 * s_l, 4):
            raise TowerError(f"level {level}: eval shape {evals.shape}")
        # recombination check: final_claim == eq(rt, point) * sum alpha_i * rel_i
        eq_v = exth.eq_eval(rt.astype(np.uint64), point)
        acc = np.zeros(4, np.uint64)
        e = 0
        a = 0
        for s in range(s_p):
            acc = exth.add(acc, exth.mul(alphas[a], exth.mul(evals[e], evals[e + 1])))
            e += 2
            a += 1
        for s in range(s_l):
            pLv, pRv, qLv, qRv = evals[e], evals[e + 1], evals[e + 2], evals[e + 3]
            num = exth.add(exth.mul(pLv, qRv), exth.mul(pRv, qLv))
            acc = exth.add(acc, exth.mul(alphas[a], num))
            acc = exth.add(acc, exth.mul(alphas[a + 1], exth.mul(qLv, qRv)))
            e += 4
            a += 2
        if not np.array_equal(exth.mul(eq_v, acc), final_claim):
            raise TowerError(f"level {level}: eval recombination mismatch")
        transcript.append(evals.ravel())
        mu = np.array(transcript.sample_ext(), np.uint64)
        rt = np.concatenate([point, mu[None, :]], axis=0)
        prod_claims, logup_claims = _fold_claims(evals, mu, s_p, s_l)

    prod_claims, logup_claims = _stack_claims(prod_claims, logup_claims)
    return rt, prod_claims, logup_claims, prod_values, logup_fracs
