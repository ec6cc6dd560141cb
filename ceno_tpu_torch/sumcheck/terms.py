"""Monomial-term evaluation for sumcheck rounds: kernels K6a and K6b.

Counterpart of ``ceno_tpu/sumcheck/terms.py`` (whose functions are XLA-jitted,
not Pallas). A virtual polynomial is a list of terms
``scalar_i * prod_k col_{idx[i,k]}`` over two banks of MLE columns: base
int32 (Cb+1, N) and ext int32 (4, Ce+1, N), both Montgomery, each with a
constant-one sentinel column last. Each round evaluates the batched
univariate g(t) at t = 0..deg over the half-cube, then every column is folded
by the sampled challenge (top variable first).

:func:`round_evals` / :func:`round_evals_ext` (K6a) and :func:`fold_banks` /
:func:`fold_ext_bank` (K6b) are wrappers of the hand-written CUDA kernels in
``csrc/sumcheck.cu``, built by ``utils/cuda_build.py``. On a CUDA tensor each
launches its kernel on the current stream, or raises; on a CPU tensor it runs
the plain torch version beside it (``*_plain``), which is also what the
kernels are compared with on the card. Every call that launches a kernel adds
one to ``LAUNCHES[name]`` (a K6a call is two launches: the per-block sums and
their reduction). :func:`round_evals_plan` chooses K6a's grid of term chunks
by element ranges. The fold reads its challenge from a (4,) tensor and never
brings it to the host, so the fused rounds (``sumcheck/fused.py``) can chain
evals, duplex and folds on the card.

The plain versions process terms in chunks that bound the working set; the
per-term scalar multiplies the already-summed (deg+1, 4) vector.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..utils import cuda_build

# elements (nodes x terms x half x 4) of one chunk's int64 products
_CHUNK_ELEMS = 1 << 24

LAUNCHES = {"round_evals": 0, "fold": 0}

# csrc/sumcheck.cu's limits: K6a's threads a block, its largest degree (a
# template parameter), factors a term (DB + DE), words of a chunk's factor
# table, and element ranges (its grid's second axis); K6b's most output
# columns (its grid's second axis)
THREADS = 256
MAX_DEG = 8
MAX_FACTORS = 16
TABLE_WORDS = 2048
MAX_RANGES = 65535
MAX_FOLD_COLS = 65535

# K6a's plan: threads a term at least (a warp's loads of one column take
# whole 128-byte lines), blocks to aim for (8 a streaming multiprocessor of
# the H100's 132), elements a thread at least before the range is split
# further
MIN_E_LANES = 32
TARGET_BLOCKS = 132 * 8
MIN_ELEMS = 8


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library with its C signatures declared (first use
    builds it)."""
    return declare(cuda_build.load("sumcheck"))


def declare(lib):
    """Declare the C signatures of csrc/sumcheck.cu's entry points on ``lib``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sc_round_evals.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32,
                                   i32, i32, i32, i32, i32, vp]
    lib.sc_fold.argtypes = [vp, vp, vp, vp, i64, i32, i32, vp]
    lib.sc_duplex.argtypes = [vp, vp, i32, vp, vp, i32, i64, i32, i32, i32, vp]
    for fn in (lib.sc_round_evals, lib.sc_fold, lib.sc_duplex):
        fn.restype = ctypes.c_int
    return lib


def check_words(x: torch.Tensor, what: str, dim: int, device) -> None:
    """A kernel operand: a contiguous int32 tensor of ``dim`` axes on ``device``."""
    if x.device != device:
        raise ValueError(f"{what}: on {x.device}, the kernel's operands on {device}")
    if x.dtype != bb.DTYPE or x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-D {bb.DTYPE} tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


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


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the card-side comparison)
# ---------------------------------------------------------------------------

def round_evals_plain(base_bank, ext_bank, bidx, eidx, scalars, *, deg: int):
    """K6a's plain version: batched univariate evals, (deg+1, 4) Montgomery.

    bidx (T, DB) and eidx (T, DE) integer tensors index the banks (the base
    bank may be None when DB is 0); scalars (4, T) Montgomery."""
    if base_bank is None:
        base_bank = bb.zeros((1, ext_bank.shape[2]), ext_bank.device)
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


def round_evals_ext_plain(ext_bank, idx, scalars, *, deg: int):
    """Round evals when every column is ext (rounds >= 1), plain."""
    empty_bidx = torch.zeros((idx.shape[0], 0), dtype=torch.int64, device=idx.device)
    return round_evals_plain(None, ext_bank, empty_bidx, idx, scalars, deg=deg)


def fold_banks_plain(base_bank, ext_bank, r):
    """K6b's plain version: fold every column by ext challenge r (4,): the
    merged ext bank (4, Cb+Ce+1, N/2) ordered [base cols..., ext cols..., ones]."""
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


def fold_ext_bank_plain(ext_bank, r):
    """Fold an all-ext bank (4, C, N) -> (4, C, N/2), plain."""
    elo, ediff = _split(ext_bank, 2)
    return ext4.add(elo, ext4.mul(r[:, None, None], ediff))


# ---------------------------------------------------------------------------
# K6a's launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EvalPlan:
    """K6a's launch: ``chunks`` x ``ranges`` blocks of THREADS threads. Block
    (x, y) takes the terms x * t_lanes .. (x + 1) * t_lanes - 1 and the y-th
    of ``ranges`` equal ranges of the half-cube; each term has ``e_lanes``
    threads, each of which sums its term over every e_lanes-th element of
    the range."""
    t_lanes: int
    e_lanes: int
    chunks: int
    ranges: int

    @property
    def blocks(self) -> int:
        return self.chunks * self.ranges


@functools.lru_cache(maxsize=4096)
def round_evals_plan(half: int, t: int, db: int, de: int, *, t_lanes: int | None = None,
                     ranges: int | None = None) -> EvalPlan:
    """K6a's plan for ``t`` terms of ``db`` base and ``de`` ext factors over
    a half-cube of ``half`` elements.

    Terms fill the block first, as many as leave MIN_E_LANES threads a term
    (a short bank's width is in its terms), in chunks of equal size; the
    threads left over go to the elements. Element ranges then bring the
    blocks to TARGET_BLOCKS while each thread keeps MIN_ELEMS elements.
    ``t_lanes`` and ``ranges`` override the choice (the tests force many
    chunks and ranges at small sizes)."""
    t1 = max(t, 1)
    if t_lanes is None:
        t_lanes = min(t1, THREADS // min(MIN_E_LANES, half), TABLE_WORDS // max(db + de, 1))
        t_lanes = -(-t1 // -(-t1 // t_lanes))  # chunks of equal size
    chunks = -(-t1 // t_lanes)
    e_lanes = max(1, min(THREADS // t_lanes, half))
    if ranges is None:
        ranges = max(1, min(-(-TARGET_BLOCKS // chunks), half // (e_lanes * MIN_ELEMS),
                            MAX_RANGES))
        ranges = -(-half // -(-half // ranges))  # no range left empty
    return EvalPlan(t_lanes, e_lanes, chunks, ranges)


def eval_plan(ext_bank, bidx, eidx, **overrides) -> EvalPlan:
    """The plan :func:`round_evals` takes for this bank length and these tables."""
    return round_evals_plan(ext_bank.shape[2] // 2, bidx.shape[0], bidx.shape[1], eidx.shape[1],
                            **overrides)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _index_table(idx, rows: int, what: str, device) -> torch.Tensor:
    """An index table as K6a takes it: contiguous int32 (T, D) on ``device``."""
    if idx.device != device or idx.dim() != 2 or idx.shape[0] != rows or \
            idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what}: expected ({rows}, D) int32 or int64 indices on {device}, "
                         f"got {idx.dtype} {tuple(idx.shape)} on {idx.device}")
    return idx.to(torch.int32).contiguous()


def check_index_range(idx: torch.Tensor, cols: int, what: str) -> None:
    """Every entry of ``idx`` names one of ``cols`` columns (on the card this
    reads the table's bounds back: one synchronisation)."""
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= cols:
            raise ValueError(f"{what}: indices in [{lo}, {hi}], the bank has {cols} columns")


def launch_round_evals(lib, stream, base_bank, ext_bank, bidx, eidx, scalars, deg: int, out,
                       check_indices: bool = True, plan: EvalPlan | None = None) -> None:
    """K6a through ``lib`` on ``stream``: checks, scratch, one C call.

    ``base_bank`` may be None (no base factors); ``out`` is a contiguous
    (deg+1, 4) int32 tensor on the banks' device; ``plan`` is
    :func:`eval_plan`'s unless given."""
    dev = ext_bank.device
    check_words(ext_bank, "round_evals: ext bank", 3, dev)
    if ext_bank.shape[0] != 4:
        raise ValueError(f"round_evals: ext bank {tuple(ext_bank.shape)}, expected (4, Ce+1, N)")
    n = ext_bank.shape[2]
    if n < 2 or n % 2:
        raise ValueError(f"round_evals: bank length {n} is not even")
    if base_bank is not None:
        check_words(base_bank, "round_evals: base bank", 2, dev)
        if base_bank.shape[1] != n:
            raise ValueError(f"round_evals: base bank {tuple(base_bank.shape)}, ext length {n}")
    check_words(scalars, "round_evals: scalars", 2, dev)
    t = scalars.shape[1]
    if scalars.shape[0] != 4:
        raise ValueError(f"round_evals: scalars {tuple(scalars.shape)}, expected (4, T)")
    bi = _index_table(bidx, t, "round_evals: bidx", dev)
    ei = _index_table(eidx, t, "round_evals: eidx", dev)
    db, de = bi.shape[1], ei.shape[1]
    if not 0 <= deg <= MAX_DEG or not 1 <= db + de <= MAX_FACTORS or t * (db + de) >= 1 << 31:
        raise ValueError(f"round_evals: deg {deg}, DB {db}, DE {de}, T {t} outside the kernel's "
                         f"limits (deg <= {MAX_DEG}, 1 <= DB + DE <= {MAX_FACTORS})")
    if db and base_bank is None:
        raise ValueError("round_evals: base factors without a base bank")
    check_words(out, "round_evals: out", 2, dev)
    if tuple(out.shape) != (deg + 1, 4):
        raise ValueError(f"round_evals: out {tuple(out.shape)}, expected ({deg + 1}, 4)")
    if check_indices:
        check_index_range(bi, base_bank.shape[0] if base_bank is not None else 0,
                          "round_evals: bidx")
        check_index_range(ei, ext_bank.shape[1], "round_evals: eidx")
    if plan is None:
        plan = eval_plan(ext_bank, bi, ei)
    # scratch (and the int32 tables) may be freed before the kernel has run:
    # the caching allocator hands their memory only to later work on this stream
    partial = torch.empty(plan.blocks * (deg + 1) * 4, dtype=bb.DTYPE, device=dev)
    rc = lib.sc_round_evals(
        base_bank.data_ptr() if base_bank is not None else None, ext_bank.data_ptr(),
        bi.data_ptr(), ei.data_ptr(), scalars.data_ptr(), partial.data_ptr(), out.data_ptr(),
        n, base_bank.shape[0] if base_bank is not None else 0, ext_bank.shape[1], t, db, de,
        deg, plan.t_lanes, plan.e_lanes, plan.chunks, plan.ranges, stream)
    cuda_build.raise_on(rc, "round_evals")


def round_evals(base_bank, ext_bank, bidx, eidx, scalars, *, deg: int, out=None,
                check_indices: bool = True):
    """K6a: batched univariate evals, (deg+1, 4) Montgomery (written into
    ``out`` when given).

    bidx (T, DB) and eidx (T, DE) int32 or int64 tensors index the banks,
    whose last column must be the ones sentinel (:func:`make_banks` appends
    it): the kernel takes a factor that names it as one without reading it.
    scalars (4, T) Montgomery. ``check_indices=False`` skips the index range
    check, for a caller that has checked the same tables before."""
    if ext_bank.device.type == "cpu":
        ev = round_evals_plain(base_bank, ext_bank, bidx, eidx, scalars, deg=deg)
        return ev if out is None else out.copy_(ev)
    if ext_bank.device.type != "cuda":
        raise ValueError(f"round_evals: expected CUDA or CPU tensors, got {ext_bank.device}")
    if out is None:
        out = torch.empty((deg + 1, 4), dtype=bb.DTYPE, device=ext_bank.device)
    with cuda_build.launch_stream(ext_bank) as stream:
        launch_round_evals(_lib(), stream, base_bank, ext_bank, bidx, eidx, scalars, deg, out,
                           check_indices)
    LAUNCHES["round_evals"] += 1
    return out


def round_evals_ext(ext_bank, idx, scalars, *, deg: int, out=None, check_indices: bool = True):
    """K6a when every column is ext (rounds >= 1)."""
    if ext_bank.device.type == "cpu":
        ev = round_evals_ext_plain(ext_bank, idx, scalars, deg=deg)
        return ev if out is None else out.copy_(ev)
    empty = torch.zeros((idx.shape[0], 0), dtype=torch.int32, device=idx.device)
    return round_evals(None, ext_bank, empty, idx, scalars, deg=deg, out=out,
                       check_indices=check_indices)


def launch_fold(lib, stream, base_bank, ext_bank, r, out) -> None:
    """K6b through ``lib`` on ``stream``. Mixed mode when ``base_bank`` is
    given: out (4, Cb + Ce + 1, N/2); else ext mode: out (4, C, N/2)."""
    dev = ext_bank.device
    check_words(ext_bank, "fold: ext bank", 3, dev)
    n, ce1 = ext_bank.shape[2], ext_bank.shape[1]
    if ext_bank.shape[0] != 4 or n < 2 or n % 2:
        raise ValueError(f"fold: ext bank {tuple(ext_bank.shape)}, expected (4, C, N), N even")
    cb = 0
    if base_bank is not None:
        check_words(base_bank, "fold: base bank", 2, dev)
        if base_bank.shape[1] != n or base_bank.shape[0] < 1:
            raise ValueError(f"fold: base bank {tuple(base_bank.shape)}, ext length {n}")
        cb = base_bank.shape[0] - 1
    check_words(r, "fold: challenge", 1, dev)
    if r.shape[0] != 4:
        raise ValueError(f"fold: challenge {tuple(r.shape)}, expected (4,)")
    check_words(out, "fold: out", 3, dev)
    if tuple(out.shape) != (4, cb + ce1, n // 2) or not 1 <= cb + ce1 <= MAX_FOLD_COLS:
        raise ValueError(f"fold: out {tuple(out.shape)}, expected (4, {cb + ce1}, {n // 2}) "
                         f"with at most {MAX_FOLD_COLS} columns")
    rc = lib.sc_fold(base_bank.data_ptr() if base_bank is not None else None,
                     ext_bank.data_ptr(), r.data_ptr(), out.data_ptr(), n, cb, ce1, stream)
    cuda_build.raise_on(rc, "fold")


def _fold(base_bank, ext_bank, r):
    if ext_bank.device.type != "cuda":
        raise ValueError(f"fold: expected CUDA or CPU tensors, got {ext_bank.device}")
    cb = base_bank.shape[0] - 1 if base_bank is not None else 0
    out = torch.empty((4, cb + ext_bank.shape[1], ext_bank.shape[2] // 2), dtype=bb.DTYPE,
                      device=ext_bank.device)
    with cuda_build.launch_stream(ext_bank) as stream:
        launch_fold(_lib(), stream, base_bank, ext_bank, r, out)
    LAUNCHES["fold"] += 1
    return out


def fold_banks(base_bank, ext_bank, r):
    """K6b, mixed mode: fold every column by the ext challenge r (4,) on the
    banks' device: the merged ext bank (4, Cb+Ce+1, N/2) ordered
    [base cols..., ext cols..., ones]."""
    if ext_bank.device.type == "cpu":
        return fold_banks_plain(base_bank, ext_bank, r)
    return _fold(base_bank, ext_bank, r)


def fold_ext_bank(ext_bank, r):
    """K6b, ext mode: fold an all-ext bank (4, C, N) -> (4, C, N/2)."""
    if ext_bank.device.type == "cpu":
        return fold_ext_bank_plain(ext_bank, r)
    return _fold(None, ext_bank, r)


def merge_indices(bidx: np.ndarray, eidx: np.ndarray, n_base: int, n_ext: int):
    """Index remap after the first fold: base j -> j, ext k -> n_base + k;
    sentinels (n_base, n_ext) both -> n_base + n_ext."""
    b = np.where(bidx == n_base, n_base + n_ext, bidx)
    e = eidx + n_base
    return np.concatenate([b, e], axis=1).astype(np.int32)


def final_evals(ext_bank):
    """After all rounds each column has length 1: (4, C) opening evals."""
    return ext_bank[..., 0]
