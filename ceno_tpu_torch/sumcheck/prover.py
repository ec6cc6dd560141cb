"""Sumcheck prover over the term kernels K6a and K6b (``sumcheck/terms.py``).

Counterpart of ``ceno_tpu/sumcheck/prover.py``. Two paths give the same
messages, point, final evals and transcript state:

  * fused (the default, as in the reference; ``CENO_TPU_TORCH_FUSED=0``
    turns it off): every round on the device with the on-device duplex
    (``sumcheck/fused.py``), one copy to the host at the end, then the host
    replays the absorbs and samples and checks that both sponges end in the
    same state;
  * per round: evaluate the batched univariate at t = 0..deg on the device,
    absorb it into the host transcript, sample one ext challenge, fold. It is
    the path of a caller with a ``round_hook`` (Basefold folds its oracles
    there) and the tests' oracle.

Every round runs on the columns' own device: there is no host tail.

Variable order: round k binds the current TOP variable; the returned opening
point is LSB-first (point[j] <-> var j), i.e. challenges reversed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..hash.transcript import Transcript
from . import fused as F
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


def fused_enabled() -> bool:
    """The fused path's switch: on unless CENO_TPU_TORCH_FUSED is "0"."""
    return os.environ.get("CENO_TPU_TORCH_FUSED", "1") != "0"


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
    each challenge is sampled (Basefold folds its oracles there); without
    one the fused path runs unless it is switched off."""
    n_base = len(base_cols)
    n_ext = sum(c.shape[1] if c.dim() == 3 else 1 for c in ext_cols)
    n = 1 << n_vars
    bidx_np, eidx_np, scal_np, deg = compile_terms(term_list, n_base, n_ext)
    midx_np = T.merge_indices(bidx_np, eidx_np, n_base, n_ext)
    live = np.nonzero(scal_np.any(axis=1))[0]  # padding terms weigh zero
    base_bank, ext_bank = T.make_banks(base_cols, ext_cols, n)
    dev = base_bank.device
    idx = lambda a: torch.from_numpy(a[live].astype(np.int32)).to(dev)  # noqa: E731
    bidx, eidx, midx = idx(bidx_np), idx(eidx_np), idx(midx_np)
    scalars = bb.to_device(scal_np[live].T, dev)  # (4, T)

    msgs = np.zeros((n_vars, deg + 1, 4), np.uint64)
    chals = np.zeros((n_vars, 4), np.uint64)
    if round_hook is None and n_vars > 0 and fused_enabled():
        st, pos, sq_pos, absorbed = transcript.export_state()
        msgs_dev, end_state, merged = F.fused_rounds(
            base_bank, ext_bank, bidx, eidx, midx, scalars, bb.to_device(st, dev),
            deg=deg, k=n_vars, pos=pos, sq_pos=sq_pos, absorbed=absorbed)
        # one copy to the host: the messages, the sponge's end state, the final evals
        flat = bb.to_host(torch.cat([msgs_dev.view(-1), end_state,
                                     T.final_evals(merged).reshape(-1)]))
        m = msgs.size
        msgs[:] = flat[:m].reshape(msgs.shape)
        for rnd in range(n_vars):
            transcript.append(msgs[rnd].ravel())
            chals[rnd] = transcript.sample_ext()
        if not np.array_equal(flat[m : m + 16], transcript.state):
            raise RuntimeError(
                f"sumcheck.prove ({n_vars} rounds, deg {deg}): the device duplex ended in "
                "another sponge state than the host transcript's replay")
        fin = flat[m + 16 :].reshape(4, -1).T  # (C, 4)
        return _output(msgs, chals, fin, n_base, n_ext)

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
    return _output(msgs, chals, bb.to_host(fin).T, n_base, n_ext)


def _output(msgs, chals, fin, n_base: int, n_ext: int) -> SumcheckOutput:
    """The proof, the LSB-first point (the challenges reversed) and the final
    evals, split from ``fin`` (C, 4) canonical."""
    return SumcheckOutput(SumcheckProof(msgs), chals[::-1].copy(), fin[:n_base],
                          fin[n_base : n_base + n_ext])
