"""Batched sumcheck over GoldilocksExt2.

Counterpart of ``ceno_tpu/gl/sumcheck.py``: prove sum_x sum_t scalar_t *
prod(cols_t(x)) with per-round univariate messages at nodes 0..deg, binding
the TOP variable each round (contiguous halves, the convention of the PCS
codeword fold, so gl/pcs.py interleaves folds with rounds).

:func:`build_eq` and :func:`prove` run on the tensors' device: the columns
sit in one (C + 1, N, 2) ext bank whose last column is all ones, each live
term is a row of column indices padded with that ones column, and a round
evaluates every term at every node with a few batched field operations.
Each round's message comes to the host for the transcript, as in the
reference, which has no fused Goldilocks loop. A term of degree dt < deg is
evaluated at all deg + 1 nodes directly; the reference evaluates it at
dt + 1 nodes and extends by Lagrange interpolation, which gives the same
field values. :func:`verify`, :func:`lagrange_extrapolate` and
:func:`build_eq_host` stay host numpy (copies of the reference).

Columns: base columns are (N,) canonical, ext columns (N, 2); numpy arrays
go to ``device``, tensors stay where they are. Terms: (scalar (2,), bidx
tuple into base cols, eidx tuple into ext cols).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import gl2_host as g2
from ..fields import goldilocks as gld
from ..fields import goldilocks_ext2 as gx


NODE_BATCH = 1 << 22  # gathered factor elements above which a round goes node by node


class GlSumcheckError(Exception):
    pass


@dataclass
class GlSumcheckOutput:
    round_msgs: np.ndarray    # (n_vars, deg+1, 2)
    point: np.ndarray         # (n_vars, 2) LSB-last (round order = top-first)
    final_base: np.ndarray    # (n_base, 2) column evals at the point
    final_ext: np.ndarray     # (n_ext, 2)


def ext_tensor(x, device) -> torch.Tensor:
    """An ext value or column as an int64 tensor: numpy goes to ``device``
    (the card when None), a tensor stays where it is."""
    if isinstance(x, torch.Tensor):
        return x
    return gx.to_device(x, "cuda" if device is None else device)


def build_eq(point, device=None) -> torch.Tensor:
    """(n, 2) point -> (2^n, 2) eq table in ROUND order on the point's device
    (``device`` for a numpy point): point[0] is the TOP row-index bit (the
    variable round 0 binds), point[n-1] the bottom."""
    pt = ext_tensor(point, device)
    table = gx.one(pt.device)[None]
    one = gx.one(pt.device)
    for j in range(pt.shape[0] - 1, -1, -1):
        r = pt[j]
        table = torch.cat([gx.mul(table, gx.sub(one, r)), gx.mul(table, r)])
    return table


def build_eq_host(point: np.ndarray) -> np.ndarray:
    """Host numpy :func:`build_eq` (the reference's ``build_eq``)."""
    n = point.shape[0]
    table = np.zeros((1, 2), np.uint64)
    table[0] = g2.one()
    one = g2.one()
    for j in range(n - 1, -1, -1):
        r = point[j]
        lo = g2.mul(table, g2.sub(one, r))
        hi = g2.mul(table, r)
        table = np.concatenate([lo, hi], axis=0)
    return table


def _bank(base_cols, ext_cols, device) -> torch.Tensor:
    """(C + 1, N, 2): the base columns lifted to ext, the ext columns, then a
    column of ones."""
    cols = [gx.from_base(c if isinstance(c, torch.Tensor) else gld.to_device(c, device))
            for c in base_cols]
    cols += [ext_tensor(c, device) for c in ext_cols]
    if not cols:
        raise GlSumcheckError("a sumcheck needs at least one column")
    ones = gx.from_base(torch.ones_like(cols[0][..., 0]))
    return torch.stack(cols + [ones])


def _term_table(terms, n_base: int, n_cols: int, device) -> tuple:
    """(idx (T, D) column indices padded with the ones column n_cols,
    scalars (T, 2)) of the live terms (degree > 0; the reference skips the
    rest), D the largest degree."""
    live = [(s, list(b) + [n_base + e for e in ei]) for s, b, ei in terms if len(b) + len(ei)]
    if not live:
        return None, None
    width = max(len(ix) for _, ix in live)
    idx = torch.tensor([ix + [n_cols] * (width - len(ix)) for _, ix in live],
                       dtype=torch.long, device=device)
    scalars = gx.to_device(np.stack([np.asarray(s, np.uint64) for s, _ in live]), device)
    return idx, scalars


def _node_sums(v, idx, scalars) -> torch.Tensor:
    """sum over the terms and the half-cube of scalar * prod(factors), for
    column values v (..., C + 1, half, 2) -> (..., 2)."""
    prod = v[..., idx[:, 0], :, :]
    for f in range(1, idx.shape[1]):
        prod = gx.mul(prod, v[..., idx[:, f], :, :])
    return gx.sum_mod(gx.mul(scalars, gx.sum_mod(prod, -2)), -2)


def round_message(lo, diff, idx, scalars, deg: int) -> torch.Tensor:
    """(deg + 1, 2): sum over the live terms and the half-cube of scalar *
    prod(factors) at nodes 0..deg, the factors lo + t diff. All nodes go
    through one set of operations while the gathered factors stay under
    NODE_BATCH elements, one node at a time above that (a round's cost is
    its operation count when small, its bytes when large)."""
    nodes = [lo]
    for _ in range(deg):
        nodes.append(gx.add(nodes[-1], diff))
    if (deg + 1) * idx.shape[0] * lo.shape[1] <= NODE_BATCH:
        return _node_sums(torch.stack(nodes), idx, scalars)
    return torch.stack([_node_sums(v, idx, scalars) for v in nodes])


def prove(base_cols: list, ext_cols: list, terms: list, n_vars: int,
          transcript, round_hook=None, device=None) -> GlSumcheckOutput:
    """The reference's ``prove`` on the columns' device (``device`` for numpy
    columns, the card when None)."""
    if device is None:
        first = next((c for c in [*base_cols, *ext_cols] if isinstance(c, torch.Tensor)), None)
        device = first.device if first is not None else "cuda"
    bank = _bank(base_cols, ext_cols, device)
    n_base = len(base_cols)
    n_cols = bank.shape[0] - 1
    deg = max((len(b) + len(e) for _, b, e in terms), default=1)
    idx, scalars = _term_table(terms, n_base, n_cols, bank.device)
    msgs = np.zeros((n_vars, deg + 1, 2), np.uint64)
    point = np.zeros((n_vars, 2), np.uint64)
    for r in range(n_vars):
        half = bank.shape[1] // 2
        lo, hi = bank[:, :half], bank[:, half:]
        diff = gx.sub(hi, lo)
        if idx is not None:
            msgs[r] = gx.to_host(round_message(lo, diff, idx, scalars, deg))
        transcript.append(msgs[r].ravel())
        alpha = transcript.sample_ext()
        point[r] = alpha
        bank = gx.add(lo, gx.mul(diff, gx.to_device(alpha, bank.device)))
        if round_hook is not None:
            round_hook(r, alpha)
    final = gx.to_host(bank[:n_cols, 0])
    return GlSumcheckOutput(msgs, point, final[:n_base], final[n_base:])


def _fold_top(c: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Host fold of an (N, 2) column by its top variable (reference helper)."""
    half = c.shape[0] // 2
    lo, hi = c[:half], c[half:]
    return g2.add(lo, g2.mul(g2.sub(hi, lo), np.asarray(alpha, np.uint64)))


@functools.lru_cache(maxsize=None)
def _lagrange_dens(d: int) -> tuple:
    dens = []
    for k in range(d + 1):
        den = 1
        for j in range(d + 1):
            if j != k:
                den = den * ((k - j) % gl.P) % gl.P
        dens.append(pow(den, gl.P - 2, gl.P))
    return tuple(dens)


def lagrange_extrapolate(ys: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Evaluate the degree-d poly through (k, ys[k]) at ext point r."""
    d = ys.shape[0] - 1
    dens = _lagrange_dens(d)
    out = np.zeros(2, np.uint64)
    for k in range(d + 1):
        num = g2.one()
        for j in range(d + 1):
            if j != k:
                num = g2.mul(num, g2.sub(r, g2.from_base(j)))
        term = g2.mul_base(g2.mul(num, np.asarray(ys[k], np.uint64)),
                           np.uint64(dens[k]))
        out = g2.add(out, term)
    return out


def verify(claim: np.ndarray, round_msgs: np.ndarray, n_vars: int,
           transcript, deg: int):
    """Replay the rounds; returns (point (n,2), final reduced claim)."""
    msgs = np.asarray(round_msgs, np.uint64)
    if msgs.shape != (n_vars, deg + 1, 2):
        raise GlSumcheckError("bad round message shape")
    cur = np.asarray(claim, np.uint64)
    point = np.zeros((n_vars, 2), np.uint64)
    for r in range(n_vars):
        g0_g1 = g2.add(msgs[r, 0], msgs[r, 1])
        if not np.array_equal(g0_g1, cur):
            raise GlSumcheckError(f"round {r}: g(0)+g(1) != claim")
        transcript.append(msgs[r].ravel())
        alpha = transcript.sample_ext()
        point[r] = alpha
        cur = lagrange_extrapolate(msgs[r], alpha)
    return point, cur
