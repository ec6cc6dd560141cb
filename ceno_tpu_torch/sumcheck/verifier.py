"""Sumcheck verifier (host, numpy canonical arithmetic).

Copy of ``ceno_tpu/sumcheck/verifier.py`` (which mirrors
``IOPVerifierState::verify``, SURVEY.md §2.9): per round, check
g(0) + g(1) == claim, absorb the message, sample the challenge, and reduce the
claim to g(r) by Lagrange extrapolation over nodes 0..deg. Returns the opening
point (LSB-first) and the final reduced claim, which the caller must check
against the column opening evaluations.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript


class SumcheckError(Exception):
    pass


def lagrange_extrapolate(ys: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Evaluate the degree-d poly through (k, ys[k]) for k = 0..d at ext r."""
    d = ys.shape[0] - 1
    # denominators prod_{j != k} (k - j) mod p
    dens = []
    for k in range(d + 1):
        den = 1
        for j in range(d + 1):
            if j != k:
                den = den * ((k - j) % bb.P) % bb.P
        dens.append(pow(den, bb.P - 2, bb.P))
    # numerators via prefix/suffix products of (r - j)
    diffs = [exth.sub(r, exth.from_base(j)) for j in range(d + 1)]
    prefix = [exth.one()]
    for k in range(d + 1):
        prefix.append(exth.mul(prefix[-1], diffs[k]))
    suffix = [exth.one()]
    for k in range(d, -1, -1):
        suffix.append(exth.mul(suffix[-1], diffs[k]))
    suffix.reverse()  # suffix[k] = prod_{j>k-1...}; align below
    acc = np.zeros(4, np.uint64)
    for k in range(d + 1):
        num = exth.mul(prefix[k], suffix[k + 1])
        lk = exth.mul_base(num, dens[k])
        acc = exth.add(acc, exth.mul(lk, ys[k]))
    return acc


def verify(
    claim: np.ndarray,
    round_msgs: np.ndarray,
    n_vars: int,
    transcript: Transcript,
    deg: int | None = None,
    round_hook=None,
):
    """Returns (point (n,4) LSB-first, final_claim (4,)). Raises on mismatch.

    ``deg`` is the expected max monomial degree; round messages whose node
    count differs from deg+1 are rejected (inflated-degree messages add
    soundness slack and quadratic Lagrange cost — a DoS vector).

    ``round_hook(rnd, challenge)`` replays any prover-side per-round transcript
    absorption (e.g. Basefold fold-oracle roots)."""
    claim = np.asarray(claim, np.uint64)
    round_msgs = np.asarray(round_msgs, np.uint64)
    if round_msgs.shape[0] != n_vars:
        raise SumcheckError(
            f"expected {n_vars} round messages, got {round_msgs.shape[0]}"
        )
    if deg is not None and n_vars > 0 and round_msgs.shape[1] != deg + 1:
        raise SumcheckError(
            f"round message has {round_msgs.shape[1]} nodes, expected {deg + 1}"
        )
    from ..utils import replay

    chals = np.zeros((n_vars, 4), np.uint64)
    for rnd in range(n_vars):
        msg = np.asarray(round_msgs[rnd], np.uint64)
        s = exth.add(msg[0], msg[1])
        if not np.array_equal(s, claim) and not replay.structure_only():
            raise SumcheckError(
                f"round {rnd}: g(0)+g(1) = {s} != claim {claim}"
            )
        transcript.append(msg.ravel())
        ch = np.array(transcript.sample_ext(), np.uint64)
        chals[rnd] = ch
        if round_hook is not None:
            round_hook(rnd, ch)
        claim = lagrange_extrapolate(msg, ch)
    return chals[::-1].copy(), claim
