"""Tower arguments: grand products and LogUp fraction sums over record MLEs.

Counterpart of ``ceno_tpu/gkr/tower.py``: the layers are built as plain
torch on the records' device, and the levels' batched degree-3 sumchecks run
on that device in one of two ways that give the same bytes:

  * fused (the default, as in the reference; ``CENO_TPU_TORCH_FUSED_TOWER=0``
    turns it off): :func:`_fused_tower_levels` runs every level of the group
    on the device with the on-device duplex (``sumcheck/fused.py``): alpha
    and its powers, the scalars, eq(rt), the banks, the rounds, the level's
    evals and mu, each sampled or absorbed on the card; the host fetches one
    buffer and replays it (:func:`_prove_levels_fused`);
  * per level: each level's sumcheck through
    :func:`ceno_tpu_torch.sumcheck.prover.prove`, with the host sampling
    alpha and mu.

The verifier replays the transcript on the host in numpy. The reference's
size crossover (``_TOWER_HOST_N`` and its host mirrors of small layers) has
no counterpart: the 2-entry levels run on the device too; nor has its
chunking of the fused levels into programs of at most
``CENO_TPU_FUSED_TOWER_LEVELS`` (an XLA program-size limit): a group runs all
its levels in one pass.

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

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..mle import ops
from ..sumcheck import fused as F
from ..sumcheck import prover as sc_prover
from ..sumcheck import terms as T
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


def _level_terms(n_prod: int, n_logup: int) -> tuple:
    """A level's terms over its ext bank [eq, L_0, R_0, ...]: (the alpha
    power each term takes, its eidx), products first, then per LogUp spec
    pL*qR, pR*qL (both alpha_a) and qL*qR (alpha_{a+1})."""
    alpha_idx, eidx = [], []
    li, a = 1, 0
    for _ in range(n_prod):
        alpha_idx.append(a)
        eidx.append((0, li, li + 1))
        li += 2
        a += 1
    for _ in range(n_logup):
        pL, pR, qL, qR = li, li + 1, li + 2, li + 3
        alpha_idx += [a, a, a + 1]
        eidx += [(0, pL, qR), (0, pR, qL), (0, qL, qR)]
        li += 4
        a += 2
    return alpha_idx, eidx


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

    if n_vars > 1 and fused_tower_enabled():
        rt, prod_claims, logup_claims = _prove_levels_fused(proof, prod_lys, logup_lys, rt,
                                                            transcript)
        return proof, rt, _stack_claims(prod_claims, logup_claims)
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
        term_list = [TermSpec(alphas[a], eidx=e)
                     for a, e in zip(*_level_terms(len(prod_lys), len(logup_lys)))]
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
# Fused levels: every level of a group on the device
# ---------------------------------------------------------------------------

def fused_tower_enabled() -> bool:
    """The fused levels' switch: on unless CENO_TPU_TORCH_FUSED_TOWER is "0"."""
    return os.environ.get("CENO_TPU_TORCH_FUSED_TOWER", "1") != "0"


def _level_static(n_prod: int, n_logup: int):
    """A level's term tables, the same at every level: (bidx, eidx, midx,
    alpha_idx, deg). compile_terms pads the term count to a power of two with
    zero-scalar terms; they weigh zero, so they are dropped here (the
    reference's fused tower evaluates them) and every term's alpha_idx is
    one of the n_claims powers. deg is compile_terms', made before the
    padding."""
    alpha_idx, eidx = _level_terms(n_prod, n_logup)
    n_ext = 1 + 2 * n_prod + 4 * n_logup  # eq + the split columns
    one = np.array([1, 0, 0, 0], np.uint64)
    bidx, eidx, _, deg = sc_prover.compile_terms(
        [TermSpec(one, eidx=e) for e in eidx], 0, n_ext)
    live = len(alpha_idx)
    bidx, eidx = bidx[:live], eidx[:live]
    midx = T.merge_indices(bidx, eidx, 0, n_ext)
    return bidx, eidx, midx, np.asarray(alpha_idx, np.int64), deg


def _fused_tower_levels(prod_lys, logup_lys, state, rt, *, pos: int, sq_pos: int,
                        absorbed: bool):
    """Levels 1 .. n_vars-1 of one group on the layers' device, with the
    duplex started from ``state`` ((16,) Montgomery) and the host's (pos,
    sq_pos, absorbed); ``rt`` is the (1, 4) Montgomery layer-1 point. Per
    level: sample alpha with its powers, gather the terms' scalars, eq(rt),
    the banks from the split layers, the rounds (K6a, K5/K7, K6b), absorb the
    level's evals and sample mu into the next point, all without a host
    synchronisation. Returns (one flat buffer: per level the (level, deg+1,
    4) messages then the (S_e, 4) evals, the sponge's end state)."""
    n_prod, n_logup = len(prod_lys), len(logup_lys)
    n_vars = len(prod_lys[0] if prod_lys else logup_lys[0][0])
    n_claims, s_e = n_prod + 2 * n_logup, 2 * n_prod + 4 * n_logup
    bidx_np, eidx_np, midx_np, alpha_idx_np, deg = _level_static(n_prod, n_logup)
    dev = rt.device
    tables = [torch.from_numpy(a) for a in (bidx_np, eidx_np, midx_np)]
    F.check_tables(*tables, 1, s_e + 2)  # on the host: no synchronisation
    bidx, eidx, midx = (a.to(dev) for a in tables)
    alpha_idx = torch.from_numpy(alpha_idx_np).to(dev)
    sizes = [(level * (deg + 1) * 4, s_e * 4) for level in range(1, n_vars)]
    flat = torch.empty(sum(a + b for a, b in sizes), dtype=bb.DTYPE, device=dev)
    pows = torch.empty((4, n_claims), dtype=bb.DTYPE, device=dev)
    alpha = torch.empty(4, dtype=bb.DTYPE, device=dev)
    dpx = F._DeviceDuplex(state.clone(), pos, sq_pos, absorbed)
    off = 0
    for level, (n_m, n_e) in zip(range(1, n_vars), sizes):
        dpx.sample_ext(alpha, pows=pows)
        scalars = pows[:, alpha_idx]
        layers = [ls[level] for ls in prod_lys] + [
            lys[i][level] for lys in logup_lys for i in (0, 1)]
        base_bank, ext_bank = T.make_banks([], [ops.build_eq(rt), split_specs(layers)],
                                           1 << level)
        msgs = flat[off : off + n_m].view(level, deg + 1, 4)
        rt_next = torch.empty((level + 1, 4), dtype=bb.DTYPE, device=dev)
        # round r's challenge binds variable level-1-r: the point is LSB-first
        merged = F.run_rounds(base_bank, ext_bank, bidx, eidx, midx, scalars, dpx, msgs,
                              [rt_next[level - 1 - r] for r in range(level)], deg=deg)
        del base_bank, ext_bank
        evals = flat[off + n_m : off + n_m + n_e].view(s_e, 4)
        evals.copy_(merged[:, 1:-1, 0].T)  # drop eq and the sentinel
        dpx.sample_ext(rt_next[level], absorb=evals.view(-1))
        rt = rt_next
        off += n_m + n_e
    return flat, dpx.state


def _prove_levels_fused(proof, prod_lys, logup_lys, rt, transcript):
    """Every level of the group through :func:`_fused_tower_levels`, then
    the same absorbs and samples on the host transcript from the fetched
    buffer: the proof's round messages and level evals, the next claims and
    point. Raises RuntimeError if the device's sponge ends elsewhere than the
    host's. Returns (rt (n_vars, 4), prod_claims, logup_claims)."""
    n_prod, n_logup = len(prod_lys), len(logup_lys)
    n_vars = len(prod_lys[0] if prod_lys else logup_lys[0][0])
    n_claims, s_e = n_prod + 2 * n_logup, 2 * n_prod + 4 * n_logup
    dev = (prod_lys[0] if prod_lys else logup_lys[0][0])[0].device
    st, pos, sq_pos, absorbed = transcript.export_state()
    flat_dev, end_state = _fused_tower_levels(
        prod_lys, logup_lys, bb.to_device(st, dev), bb.to_device(rt, dev),
        pos=pos, sq_pos=sq_pos, absorbed=absorbed)
    flat = bb.to_host(torch.cat([flat_dev, end_state]))  # the one copy to the host
    deg = _level_static(n_prod, n_logup)[4]
    off = 0
    for level in range(1, n_vars):
        transcript.sample_ext_pows(n_claims)  # alpha: its powers were used on the device
        n_m = level * (deg + 1) * 4
        msgs = flat[off : off + n_m].reshape(level, deg + 1, 4).copy()
        evals = flat[off + n_m : off + n_m + s_e * 4].reshape(s_e, 4).copy()
        off += n_m + s_e * 4
        chs = []
        for r in range(level):
            transcript.append(msgs[r].ravel())
            chs.append(np.array(transcript.sample_ext(), np.uint64))
        proof.round_msgs.append(msgs)
        proof.level_evals.append(evals)
        transcript.append(evals.ravel())
        mu = np.array(transcript.sample_ext(), np.uint64)
        rt = np.stack(chs[::-1] + [mu])
        prod_claims, logup_claims = _fold_claims(evals, mu, n_prod, n_logup)
    if not np.array_equal(flat[off:], transcript.state):
        raise RuntimeError(
            f"prove_towers ({n_vars} vars, {n_prod} product and {n_logup} LogUp specs): the "
            "device duplex ended in another sponge state than the host transcript's replay")
    return rt, prod_claims, logup_claims


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
            from ..utils import replay

            if not replay.structure_only():
                raise TowerError(f"level {level}: eval recombination mismatch")
        transcript.append(evals.ravel())
        mu = np.array(transcript.sample_ext(), np.uint64)
        rt = np.concatenate([point, mu[None, :]], axis=0)
        prod_claims, logup_claims = _fold_claims(evals, mu, s_p, s_l)

    prod_claims, logup_claims = _stack_claims(prod_claims, logup_claims)
    return rt, prod_claims, logup_claims, prod_values, logup_fracs
