"""Batched radix-2 NTT and multilinear coefficient transforms (torch).

Counterpart of ``ceno_tpu/pcs/ntt.py`` (XLA-jitted there, plain torch here).
The trace matrix (C columns x N rows) is encoded column-wise: Möbius transform
(evals -> multilinear coefficients), zero-pad by the blowup, bit-reversal
gather, then the log2(M)-stage butterfly chain.

Domain/variable-order contract (load-bearing, see pcs/basefold.py): the
committed codeword belongs to the variable-REVERSED multilinear, so the
Basefold fold of (i, i + M/2) pairs binds the same variable as a
top-variable sumcheck round. Codewords are in natural domain order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import babybear as bb


@functools.lru_cache(maxsize=None)
def bitrev_perm(n_bits: int) -> np.ndarray:
    n = 1 << n_bits
    idx = np.arange(n)
    rev = np.zeros(n, np.int32)
    for b in range(n_bits):
        rev |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return rev


def _powers(w: int, count: int) -> np.ndarray:
    """Canonical w^0..w^{count-1} (uint64) by vectorized doubling."""
    p = np.uint64(bb.P)
    out = np.ones(1, np.uint64)
    step = np.uint64(w)
    while len(out) < count:
        out = np.concatenate([out, out * step % p])
        step = step * step % p
    return out[:count]


@functools.lru_cache(maxsize=8)
def _twiddles(log_m: int, device: str) -> tuple:
    """Per-stage CANONICAL twiddles on ``device``: stage s uses w_{2^{s+1}}^k.

    A Montgomery value times a canonical constant, reduced mod p, is the
    Montgomery form of the product, so one reduction per butterfly suffices."""
    if log_m == 0:
        return ()
    top = _powers(bb.two_adic_root(log_m), 1 << (log_m - 1))
    full = torch.from_numpy(top.astype(np.int64)).to(device)
    return tuple(full[:: 1 << (log_m - 1 - s)] for s in range(log_m))


@functools.lru_cache(maxsize=None)
def domain_pow_inv(log_m: int) -> np.ndarray:
    """Canonical w_M^{-i} for i in [0, M/2) (host, for fold twiddles)."""
    m = 1 << log_m
    w_inv = pow(bb.two_adic_root(log_m), bb.P - 2, bb.P)
    return _powers(w_inv, m // 2)


def mobius(x):
    """Evals -> multilinear coefficients, batched (C, N): for each variable,
    coeff_hi -= coeff_lo over contiguous halves."""
    c, n = x.shape
    x = x.clone()
    for j in range(n.bit_length() - 1):
        blk = 1 << j
        v = x.view(c, n // (2 * blk), 2, blk)
        v[:, :, 1, :] = bb.sub(v[:, :, 1, :], v[:, :, 0, :])
    return x


def ntt_natural(x):
    """DIT NTT: input coeffs in NATURAL order (bit-reversed internally),
    output evals in natural domain order. Batched (C, M)."""
    c, m = x.shape
    log_m = m.bit_length() - 1
    x = x[:, torch.from_numpy(bitrev_perm(log_m).astype(np.int64)).to(x.device)]
    tws = _twiddles(log_m, str(x.device))
    for s in range(log_m):
        half = 1 << s
        v = x.view(c, m // (2 * half), 2 * half)
        lo, hi = v[:, :, :half], v[:, :, half:]
        thi = (hi.long() * tws[s] % bb.P).to(bb.DTYPE)
        x = torch.cat([bb.add(lo, thi), bb.sub(lo, thi)], dim=2).view(c, m)
    return x


def np_encode(evals: np.ndarray, *, blowup_log: int) -> np.ndarray:
    """Host numpy mirror of :func:`encode` on canonical uint64 (C, N) arrays."""
    p = np.uint64(bb.P)
    c, n = evals.shape
    log_n = n.bit_length() - 1
    x = evals[:, bitrev_perm(log_n)].astype(np.uint64)
    for j in range(log_n):  # mobius
        blk = 1 << j
        x = x.reshape(c, n // (2 * blk), 2, blk)
        x[:, :, 1, :] = (x[:, :, 1, :] + p - x[:, :, 0, :]) % p
        x = x.reshape(c, n)
    m = n << blowup_log
    padded = np.zeros((c, m), np.uint64)
    padded[:, :n] = x
    log_m = m.bit_length() - 1
    x = padded[:, bitrev_perm(log_m)]
    for s in range(log_m):
        blk = 1 << (s + 1)
        half = 1 << s
        x = x.reshape(c, m // blk, blk)
        lo = x[:, :, :half]
        hi = x[:, :, half:]
        tw = _powers(bb.two_adic_root(s + 1), half)
        thi = hi * tw[None, None, :] % p
        x = np.concatenate([(lo + thi) % p, (lo + p - thi) % p], axis=2)
        x = x.reshape(c, m)
    return x


def encode(evals, *, blowup_log: int, reverse_vars: bool = True):
    """Full Basefold encoding: (C, N) Montgomery evals -> (C, N << blowup_log)
    codewords. ``reverse_vars`` commits the variable-reversed multilinear."""
    c, n = evals.shape
    log_n = n.bit_length() - 1
    if reverse_vars:
        evals = evals[:, torch.from_numpy(bitrev_perm(log_n).astype(np.int64)).to(evals.device)]
    coeffs = mobius(evals)
    padded = bb.zeros((c, n << blowup_log), evals.device)
    padded[:, :n] = coeffs
    return ntt_natural(padded)
