"""Fused device sumcheck: every round on the card, with an on-device
Fiat-Shamir duplex (kernel K5/K7).

Counterpart of ``ceno_tpu/sumcheck/fused.py``. The per-round prover copies
each round's message to the host, absorbs it and sends the challenge back
before it can fold. Here the rounds chain on the card with no host
synchronisation: K6a writes the message into a device buffer, K5/K7 absorbs it
into a sponge state that stays in device memory and samples the challenge
into a device slot, and K6b folds by that slot. The host then replays the
same absorbs and samples on its own transcript from the fetched messages,
which gives it the challenges, and checks that both end in the same sponge
state (``sumcheck/prover.py``, ``gkr/tower.py``).

The duplex's position bookkeeping (``pos``, ``sq_pos``, ``absorbed``) lives on
the host: the absorb and sample sequence of a call is fixed, so only the 16
sponge words are device data. On a CUDA state :func:`duplex` launches the
kernel in ``csrc/sumcheck.cu``; on a CPU state it runs the plain torch
version beside it, built on ``hash/poseidon2.permute``. Every launch adds one
to ``LAUNCHES["duplex"]``.

The reference runs its later rounds under one ``lax.scan`` at a fixed size
(the bank repeated to its first width, each message scaled by inv(2^j)) to
bound the size of its XLA program; this eager loop halves the bank each
round and gives the same messages.
"""

from __future__ import annotations

import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..hash import poseidon2 as p2
from ..utils import cuda_build
from . import terms as T

LAUNCHES = {"duplex": 0}


def reset_launches() -> None:
    LAUNCHES["duplex"] = 0


def advance(pos: int, sq_pos: int, absorbed: bool, n_absorb: int, sample: bool) -> tuple:
    """The host's (pos, sq_pos, absorbed) after absorbing ``n_absorb`` words
    and, when ``sample``, sampling one ext challenge: the rules of
    ``hash/transcript.Transcript.append`` and ``sample_base``."""
    for _ in range(n_absorb):
        if pos == p2.RATE:
            pos = 0
        pos += 1
        absorbed = True
    if sample:
        for _ in range(4):
            if absorbed or sq_pos == p2.RATE:
                pos, sq_pos, absorbed = 0, 0, False
            sq_pos += 1
    return pos, sq_pos, absorbed


def _permute_in_place(state: torch.Tensor) -> None:
    state.copy_(p2.permute(state.view(p2.WIDTH, 1)).view(p2.WIDTH))


def duplex_plain(state, absorb, out, pows, pos: int, sq_pos: int, absorbed: bool) -> None:
    """K5/K7's plain version, in place on ``state``'s device: absorb the
    words of ``absorb`` (1-D Montgomery, or None), then, when ``out`` is
    given, sample one ext challenge into it and, when ``pows`` (4, k) is
    given, write its powers alpha^0 .. alpha^(k-1) there."""
    n = 0 if absorb is None else absorb.shape[0]
    j = 0
    while j < n:
        if pos == p2.RATE:
            _permute_in_place(state)
            pos = 0
        m = min(p2.RATE - pos, n - j)
        state[pos : pos + m] = bb.add(state[pos : pos + m], absorb[j : j + m])
        pos += m
        j += m
        absorbed = True
    if out is None:
        return
    for q in range(4):
        if absorbed or sq_pos == p2.RATE:
            _permute_in_place(state)
            sq_pos, absorbed = 0, False
        out[q] = state[sq_pos]
        sq_pos += 1
    if pows is not None:
        cur = ext4.ones((), state.device)
        for i in range(pows.shape[1]):
            pows[:, i] = cur
            cur = ext4.mul(cur, out)


def launch_duplex(lib, stream, state, absorb, out, pows, pos: int, sq_pos: int,
                  absorbed: bool) -> None:
    """K5/K7 through ``lib`` on ``stream``: checks, one C call."""
    dev = state.device
    T.check_words(state, "duplex: state", 1, dev)
    if state.shape[0] != p2.WIDTH:
        raise ValueError(f"duplex: state {tuple(state.shape)}, expected ({p2.WIDTH},)")
    if absorb is not None:
        T.check_words(absorb, "duplex: absorbed words", 1, dev)
    if out is not None:
        T.check_words(out, "duplex: challenge", 1, dev)
        if out.shape[0] != 4:
            raise ValueError(f"duplex: challenge slot {tuple(out.shape)}, expected (4,)")
    if pows is not None:
        if out is None or pows.device != dev or pows.dtype != bb.DTYPE or pows.dim() != 2 or \
                pows.shape[0] != 4 or (pows.shape[1] > 1 and pows.stride(1) != 1):
            raise ValueError(f"duplex: powers {pows.dtype} {tuple(pows.shape)} "
                             f"strides {pows.stride()}, expected (4, k) rows of int32 words")
    rc = lib.sc_duplex(
        state.data_ptr(), absorb.data_ptr() if absorb is not None else None,
        0 if absorb is None else absorb.shape[0], out.data_ptr() if out is not None else None,
        pows.data_ptr() if pows is not None else None, 0 if pows is None else pows.shape[1],
        0 if pows is None else pows.stride(0), pos, sq_pos, int(absorbed), stream)
    cuda_build.raise_on(rc, "duplex")


def duplex(state, absorb, out, pows=None, *, pos: int, sq_pos: int, absorbed: bool) -> tuple:
    """K5/K7: one duplex step on the (16,) Montgomery sponge ``state``, in
    place: absorb ``absorb``, then sample one ext challenge into ``out`` (and
    its powers into ``pows``) when given. Returns the new (pos, sq_pos,
    absorbed)."""
    if state.device.type == "cpu":
        duplex_plain(state, absorb, out, pows, pos, sq_pos, absorbed)
    elif state.device.type == "cuda":
        with cuda_build.launch_stream(state) as stream:
            launch_duplex(T._lib(), stream, state, absorb, out, pows, pos, sq_pos, absorbed)
        LAUNCHES["duplex"] += 1
    else:
        raise ValueError(f"duplex: expected a CUDA or CPU tensor, got {state.device}")
    n = 0 if absorb is None else absorb.shape[0]
    return advance(pos, sq_pos, absorbed, n, out is not None)


class _DeviceDuplex:
    """Mirror of ``hash/transcript.Transcript`` on the tensors' device: a
    (16,) Montgomery state tensor, and the host's pos, sq_pos and absorbed."""

    def __init__(self, state: torch.Tensor, pos: int, sq_pos: int, absorbed: bool):
        self.state = state
        self.pos, self.sq_pos, self.absorbed = pos, sq_pos, absorbed

    def sample_ext(self, out, absorb=None, pows=None) -> None:
        """Absorb ``absorb`` (1-D Montgomery words, or None), then sample one
        ext challenge into ``out`` (4,) and, when given, its powers into
        ``pows`` (4, k): one launch on the card."""
        self.pos, self.sq_pos, self.absorbed = duplex(
            self.state, absorb, out, pows, pos=self.pos, sq_pos=self.sq_pos,
            absorbed=self.absorbed)


def check_tables(bidx, eidx, midx, n_base_cols: int, n_ext_cols: int) -> None:
    """The term tables of a fused run index their banks: bidx the base bank's
    columns, eidx the ext bank's, midx the merged bank's. On the card this
    reads the tables' bounds back, so it runs once, before the rounds."""
    T.check_index_range(bidx, n_base_cols, "fused rounds: bidx")
    T.check_index_range(eidx, n_ext_cols, "fused rounds: eidx")
    T.check_index_range(midx, n_base_cols - 1 + n_ext_cols, "fused rounds: midx")


def run_rounds(base_bank, ext_bank, bidx, eidx, midx, scalars, dpx: _DeviceDuplex, msgs, chals,
               *, deg: int):
    """Every round of one sumcheck on the banks' device: K6a into ``msgs[r]``
    ((k, deg+1, 4) buffer), K5/K7 absorbing it and sampling into
    ``chals[r]`` (k tensors of shape (4,)), K6b by that challenge; no host
    synchronisation. The tables must have been checked (:func:`check_tables`).
    Returns the merged bank of length 1, (4, C, 1)."""
    merged = None
    for rnd in range(msgs.shape[0]):
        if merged is None:
            T.round_evals(base_bank, ext_bank, bidx, eidx, scalars, deg=deg, out=msgs[rnd],
                          check_indices=False)
        else:
            T.round_evals_ext(merged, midx, scalars, deg=deg, out=msgs[rnd], check_indices=False)
        dpx.sample_ext(chals[rnd], absorb=msgs[rnd].view(-1))
        if merged is None:
            merged = T.fold_banks(base_bank, ext_bank, chals[rnd])
            base_bank = ext_bank = None
        else:
            merged = T.fold_ext_bank(merged, chals[rnd])
    return merged


def fused_rounds(base_bank, ext_bank, bidx, eidx, midx, scalars, state, *, deg: int, k: int,
                 pos: int, sq_pos: int, absorbed: bool):
    """All k >= 1 rounds of a sumcheck over banks of length 2^k on their
    device, with the duplex started from ``state`` ((16,) Montgomery, not
    changed) and the host's (pos, sq_pos, absorbed).

    Returns (messages (k, deg+1, 4) Montgomery, the sponge's end state (16,),
    the merged bank of length 1, (4, Cb+Ce+1, 1))."""
    if k < 1 or ext_bank.shape[2] != 1 << k:
        raise ValueError(f"fused_rounds: k = {k} rounds over banks of length {ext_bank.shape[2]}")
    check_tables(bidx, eidx, midx, base_bank.shape[0], ext_bank.shape[1])
    dev = ext_bank.device
    msgs = torch.empty((k, deg + 1, 4), dtype=bb.DTYPE, device=dev)
    chals = torch.empty((k, 4), dtype=bb.DTYPE, device=dev)
    dpx = _DeviceDuplex(state.clone(), pos, sq_pos, absorbed)
    merged = run_rounds(base_bank, ext_bank, bidx, eidx, midx, scalars, dpx, msgs, chals, deg=deg)
    return msgs, dpx.state, merged
