"""Host (numpy) sumcheck rounds: exact canonical arithmetic.

Copy of ``ceno_tpu/sumcheck/host_impl.py`` without its size crossover: the
port's prover runs every round on the tensors' own device (the card, or the
CPU in the tests), so nothing here is switched in by size. These functions
are the numpy statement of what ``sumcheck/terms.py`` computes, and the tests
hold the torch kernels against them.

Host banks are canonical uint64: base (Cb+1, N), ext (Ce+1, N, 4), with the
same sentinel-ones last column convention as sumcheck/terms.py.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth

_P = np.uint64(bb.P)


def make_banks_host(base_cols, ext_cols, n: int):
    """base_cols: list of (N,) canonical; ext_cols: list of (N, 4) canonical."""
    base = np.ones((len(base_cols) + 1, n), np.uint64)
    for i, c in enumerate(base_cols):
        base[i] = c
    ext = np.zeros((len(ext_cols) + 1, n, 4), np.uint64)
    ext[-1, :, 0] = 1
    for i, c in enumerate(ext_cols):
        ext[i] = c
    return base, ext


def build_eq_host(point: np.ndarray, scale=None) -> np.ndarray:
    """eq table (N, 4) canonical; point (n, 4) LSB-first."""
    e = np.zeros((1, 4), np.uint64)
    e[0] = scale if scale is not None else exth.one()
    for j in range(point.shape[0]):
        hi = exth.mul(e, point[j][None, :])
        lo = exth.sub(e, hi)
        e = np.concatenate([lo, hi], axis=0)
    return e


def round_evals_host(base, ext, bidx, eidx, scalars, deg: int) -> np.ndarray:
    """(deg+1, 4) canonical univariate evals over the half-cube.

    Vectorized over TERMS (the keccak core chip batches ~6k monomials into
    one zerocheck; a python per-term loop was the whole prove wall). Terms
    are processed in chunks sized to a bounded working set."""
    half = base.shape[1] // 2
    blo, bdiff = base[:, :half], (base[:, half:] + _P - base[:, :half]) % _P
    elo = ext[:, :half]
    ediff = (ext[:, half:] + _P - elo) % _P
    out = np.zeros((deg + 1, 4), np.uint64)
    nz = np.nonzero(scalars.any(axis=1))[0]
    if nz.size == 0:
        return out
    db, de = bidx.shape[1], eidx.shape[1]
    per_t = max(1, (db + 4 * de) * max(half, 1))
    chunk = max(1, (1 << 23) // per_t)
    for s0 in range(0, nz.size, chunk):
        idx = nz[s0 : s0 + chunk]
        sc = scalars[idx]                     # (t, 4)
        bcur = blo[bidx[idx]] if db else None  # (t, db, half)
        bd = bdiff[bidx[idx]] if db else None
        ecur = elo[eidx[idx]] if de else None  # (t, de, half, 4)
        ed = ediff[eidx[idx]] if de else None
        for t in range(deg + 1):
            if t > 0:
                if db:
                    bcur = (bcur + bd) % _P
                if de:
                    ecur = (ecur + ed) % _P
            pb = None
            if db:
                pb = bcur[:, 0]
                for k in range(1, db):
                    pb = pb * bcur[:, k] % _P  # (t, half)
            if de:
                pe = ecur[:, 0]
                for k in range(1, de):
                    pe = exth.mul(pe, ecur[:, k])
                if pb is not None:
                    pe = pe * pb[:, :, None] % _P
                s = pe.sum(axis=1) % _P        # (t, 4); half * p < 2^64 safe
            else:
                s = np.zeros((idx.size, 4), np.uint64)
                s[:, 0] = pb.sum(axis=1) % _P
            v = exth.mul(sc, s)                # (t, 4); values < p
            out[t] = exth.add(out[t], v.sum(axis=0) % _P)
    return out


def fold_banks_host(base, ext, r):
    """Merged ext bank after folding by r: (Cb+Ce+1, N/2, 4)."""
    half = base.shape[1] // 2
    blo = base[:, :half]
    bdiff = (base[:, half:] + _P - blo) % _P
    fb = np.zeros((base.shape[0], half, 4), np.uint64)
    for c in range(base.shape[0]):
        prod = bdiff[c][:, None] * r[None, :] % _P
        prod[:, 0] = (prod[:, 0] + blo[c]) % _P
        fb[c] = prod
    elo = ext[:, :half]
    ediff = (ext[:, half:] + _P - elo) % _P
    fe = exth.add(elo, exth.mul(ediff, r[None, None, :]))
    return np.concatenate([fb[:-1], fe], axis=0)


def fold_ext_bank_host(ext, r):
    half = ext.shape[1] // 2
    elo = ext[:, :half]
    ediff = (ext[:, half:] + _P - elo) % _P
    return exth.add(elo, exth.mul(ediff, r[None, None, :]))
