"""Monomial-term evaluation for sumcheck rounds, as plain torch on the device.

Counterpart of ``ceno_tpu/sumcheck/terms.py`` (whose functions are XLA-jitted,
not Pallas). A virtual polynomial is a list of terms
``scalar_i * prod_k col_{idx[i,k]}`` over two banks of MLE columns: base
int32 (Cb+1, N) and ext int32 (4, Ce+1, N), both Montgomery, each with a
constant-one sentinel column last. Each round evaluates the batched
univariate g(t) at t = 0..deg over the half-cube, then every column is folded
by the sampled challenge (top variable first).

Terms are processed in chunks that bound the working set; the per-term
scalar multiplies the already-summed (deg+1, 4) vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4

# elements (nodes x terms x half x 4) of one chunk's int64 products
_CHUNK_ELEMS = 1 << 24


def make_banks(base_cols, ext_cols, n: int, device=None):
    """Stack column lists into banks with the ones sentinel appended.

    Ext items are (4, N) single columns or (4, k, N) pre-stacked blocks."""
    if device is None:
        device = (list(base_cols) + list(ext_cols))[0].device
    base = torch.stack(list(base_cols)) if base_cols else bb.zeros((0, n), device)
    base = torch.cat([base, bb.ones((1, n), device)])
    parts = [c[:, None, :] if c.dim() == 2 else c for c in ext_cols]
    ext = torch.cat(parts + [ext4.ones((1, n), device)], dim=1)
    return base, ext


def _split(bank, axis: int):
    half = bank.shape[axis] // 2
    lo, hi = bank.narrow(axis, 0, half), bank.narrow(axis, half, half)
    return lo, bb.sub(hi, lo)


def _nodes(lo, diff, deg: int):
    """lo + t*diff for t = 0..deg, stacked on a new leading axis."""
    outs = [lo]
    for _ in range(deg):
        outs.append(bb.add(outs[-1], diff))
    return torch.stack(outs)


def round_evals(base_bank, ext_bank, bidx, eidx, scalars, *, deg: int):
    """Batched univariate evals, (deg+1, 4) Montgomery.

    bidx (T, DB) and eidx (T, DE) int64 tensors index the banks; scalars
    (4, T) Montgomery."""
    blo, bdiff = _split(base_bank, 1)
    elo, ediff = _split(ext_bank, 2)
    half = blo.shape[1]
    bn = _nodes(blo, bdiff, deg)                      # (deg+1, Cb+1, half)
    en = _nodes(elo, ediff, deg).transpose(0, 1)      # (4, deg+1, Ce+1, half)
    t_total, db = bidx.shape
    de = eidx.shape[1]
    acc = torch.zeros((4, deg + 1), dtype=torch.int64, device=base_bank.device)
    chunk = max(1, _CHUNK_ELEMS // (4 * (deg + 1) * max(half, 1)))
    for s0 in range(0, t_total, chunk):
        bi, ei = bidx[s0 : s0 + chunk], eidx[s0 : s0 + chunk]
        pb = None
        for k in range(db):
            col = bn[:, bi[:, k]]                     # (deg+1, t, half)
            pb = col if pb is None else bb.mul(pb, col)
        if de:
            pe = None
            for k in range(de):
                col = en[:, :, ei[:, k]]              # (4, deg+1, t, half)
                pe = col if pe is None else ext4.mul(pe, col)
            if pb is not None:
                pe = ext4.mul_base(pe, pb)
            s = bb.sum_mod(pe, -1)                    # (4, deg+1, t)
        else:
            s = ext4.from_base(bb.sum_mod(pb, -1))
        sc = scalars[:, None, s0 : s0 + chunk]        # (4, 1, t)
        acc += ext4.mul(sc, s).long().sum(dim=-1)
    return (acc % bb.P).to(bb.DTYPE).T.contiguous()


def round_evals_ext(ext_bank, idx, scalars, *, deg: int):
    """Round evals when every column is ext (rounds >= 1)."""
    empty_base = bb.zeros((1, ext_bank.shape[2]), ext_bank.device)
    empty_bidx = torch.zeros((idx.shape[0], 0), dtype=torch.int64, device=idx.device)
    return round_evals(empty_base, ext_bank, empty_bidx, idx, scalars, deg=deg)


def fold_banks(base_bank, ext_bank, r):
    """Fold every column by ext challenge r (4,): the merged ext bank
    (4, Cb+Ce+1, N/2) ordered [base cols..., ext cols..., ones]."""
    blo, bdiff = _split(base_bank, 1)
    elo, ediff = _split(ext_bank, 2)
    folded_base = torch.stack([
        bb.add(blo, bb.mul(r[0], bdiff)),
        bb.mul(r[1], bdiff),
        bb.mul(r[2], bdiff),
        bb.mul(r[3], bdiff),
    ])  # (4, Cb+1, half); the base sentinel is dropped, the ext one kept
    folded_ext = ext4.add(elo, ext4.mul(r[:, None, None], ediff))
    return torch.cat([folded_base[:, :-1], folded_ext], dim=1)


def fold_ext_bank(ext_bank, r):
    """Fold an all-ext bank (4, C, N) -> (4, C, N/2)."""
    elo, ediff = _split(ext_bank, 2)
    return ext4.add(elo, ext4.mul(r[:, None, None], ediff))


def merge_indices(bidx: np.ndarray, eidx: np.ndarray, n_base: int, n_ext: int):
    """Index remap after the first fold: base j -> j, ext k -> n_base + k;
    sentinels (n_base, n_ext) both -> n_base + n_ext."""
    b = np.where(bidx == n_base, n_base + n_ext, bidx)
    e = eidx + n_base
    return np.concatenate([b, e], axis=1).astype(np.int32)


def final_evals(ext_bank):
    """After all rounds each column has length 1: (4, C) opening evals."""
    return ext_bank[..., 0]
