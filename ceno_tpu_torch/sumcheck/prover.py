"""Sumcheck prover: a host round loop over the torch term kernels.

Counterpart of ``ceno_tpu/sumcheck/prover.py`` with its per-round loop only:
per round, evaluate the batched univariate at t = 0..deg on the device, absorb
it into the transcript, sample one ext challenge, fold. The reference's fused
all-rounds program (``sumcheck/fused.py``) is an optimisation whose messages
and end state equal this loop's; it is not ported yet. Every round runs on the
columns' own device: there is no host tail.

Variable order: round k binds the current TOP variable; the returned opening
point is LSB-first (point[j] <-> var j), i.e. challenges reversed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..hash.transcript import Transcript
from . import terms as T


@dataclass
class TermSpec:
    """One monomial term: scalar (canonical (4,)), base/ext column indices."""

    scalar: np.ndarray
    bidx: tuple = ()
    eidx: tuple = ()


@dataclass
class SumcheckProof:
    round_msgs: np.ndarray  # (n_rounds, deg+1, 4) canonical uint64


@dataclass
class SumcheckOutput:
    proof: SumcheckProof
    point: np.ndarray       # (n_vars, 4) canonical, LSB-first
    final_base: np.ndarray  # (Cb, 4) canonical: base cols evaluated at point
    final_ext: np.ndarray   # (Ce, 4) canonical: ext cols evaluated at point


def _pad_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def compile_terms(term_list: list[TermSpec], n_base: int, n_ext: int):
    """Pad terms into dense index matrices (T padded to pow2, sentinel cols)."""
    db = max((len(t.bidx) for t in term_list), default=0)
    de = max((len(t.eidx) for t in term_list), default=0)
    deg = max((len(t.bidx) + len(t.eidx) for t in term_list), default=0)
    tcount = _pad_pow2(len(term_list))
    bidx = np.full((tcount, db), n_base, np.int32)
    eidx = np.full((tcount, de), n_ext, np.int32)
    scal = np.zeros((tcount, 4), np.uint64)
    for i, t in enumerate(term_list):
        bidx[i, : len(t.bidx)] = t.bidx
        eidx[i, : len(t.eidx)] = t.eidx
        scal[i] = np.asarray(t.scalar, np.uint64)
    return bidx, eidx, scal, deg


def prove(
    base_cols,
    ext_cols,
    term_list: list[TermSpec],
    n_vars: int,
    transcript: Transcript,
    round_hook=None,
) -> SumcheckOutput:
    """Run the sumcheck over Montgomery MLE columns of size 2^n_vars.

    ``base_cols`` are (N,) tensors; ``ext_cols`` are (4, N) tensors or
    (4, k, N) blocks of k columns. ``round_hook(rnd, challenge)`` runs after
    each challenge is sampled (Basefold folds its oracles there)."""
    n_base = len(base_cols)
    n_ext = sum(c.shape[1] if c.dim() == 3 else 1 for c in ext_cols)
    n = 1 << n_vars
    bidx_np, eidx_np, scal_np, deg = compile_terms(term_list, n_base, n_ext)
    midx_np = T.merge_indices(bidx_np, eidx_np, n_base, n_ext)
    live = np.nonzero(scal_np.any(axis=1))[0]  # padding terms weigh zero
    base_bank, ext_bank = T.make_banks(base_cols, ext_cols, n)
    dev = base_bank.device
    idx = lambda a: torch.from_numpy(a[live].astype(np.int64)).to(dev)  # noqa: E731
    bidx, eidx, midx = idx(bidx_np), idx(eidx_np), idx(midx_np)
    scalars = bb.to_device(scal_np[live].T, dev)  # (4, T)

    msgs = np.zeros((n_vars, deg + 1, 4), np.uint64)
    chals = np.zeros((n_vars, 4), np.uint64)
    merged = None
    for rnd in range(n_vars):
        if merged is None:
            ev = T.round_evals(base_bank, ext_bank, bidx, eidx, scalars, deg=deg)
        else:
            ev = T.round_evals_ext(merged, midx, scalars, deg=deg)
        ev_h = bb.to_host(ev)
        msgs[rnd] = ev_h
        transcript.append(ev_h.ravel())
        ch = np.array(transcript.sample_ext(), np.uint64)
        chals[rnd] = ch
        if round_hook is not None:
            round_hook(rnd, ch)
        r = bb.to_device(ch, dev)
        if merged is None:
            merged = T.fold_banks(base_bank, ext_bank, r)
            base_bank = ext_bank = None
        else:
            merged = T.fold_ext_bank(merged, r)

    if merged is None:  # 0-var polys are scalars
        fin = torch.cat([ext4.from_base(base_bank[:n_base, 0]), ext_bank[:, :n_ext, 0]], dim=1)
    else:
        fin = T.final_evals(merged)  # (4, C)
    fin = bb.to_host(fin).T  # (C, 4)
    final_base = fin[:n_base]
    final_ext = fin[n_base : n_base + n_ext]
    point = chals[::-1].copy()  # LSB-first
    return SumcheckOutput(SumcheckProof(msgs), point, final_base, final_ext)

