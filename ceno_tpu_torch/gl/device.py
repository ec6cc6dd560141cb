"""Goldilocks commit kernels K14a (encode), K14b (leaf sponge), K14c (Merkle
levels).

Counterpart of ``ceno_tpu/gl/device.py``: its XLA functions ``encode_dev``
(:54), ``permute_device`` (:126) and ``hash_and_tree_dev`` (:162) over
2-limb uint32 words become CUDA C++ kernels written for Hopper's 64-bit
integer multiply (``csrc/gl_commit.cu``, built by ``utils/cuda_build.py``),
over int64 tensors that hold canonical uint64 words (fields/goldilocks.py).
:func:`commit_device` (:183) drives them.

On a CUDA tensor each wrapper launches its kernels on the current stream,
or raises. On a CPU tensor it runs the plain torch version beside it, which
is also what the kernels are compared with on the card. Every kernel launch
adds one to ``LAUNCHES[name]`` (K14a: the gather, each Moebius stage, the
spread, each DIT stage, and the twiddle table once per size and card).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import goldilocks as gld
from ..utils import cuda_build
from . import poseidon2 as p2

LAUNCHES = {"gl_encode": 0, "gl_leaf_sponge": 0, "gl_merkle_levels": 0}
K14C_TOP = 512  # the source's K14C_TOP: one block takes the levels from here


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def declare(lib):
    """Declare the C signatures of csrc/gl_commit.cu's entry points on ``lib``."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gl_twiddles.argtypes = [vp, i32, ctypes.c_uint64, vp]
    lib.gl_encode.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
    lib.gl_leaf_sponge.argtypes = [vp, vp, i32, i64, vp]
    lib.gl_merkle_levels.argtypes = [vp, vp, i64, vp]
    for fn in (lib.gl_twiddles, lib.gl_encode, lib.gl_leaf_sponge, lib.gl_merkle_levels):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library with its C signatures declared (the first
    call builds it)."""
    return declare(cuda_build.load("gl_commit"))


def _check(x: torch.Tensor, what: str, dim: int = 2) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype != gld.DTYPE or x.dim() != dim or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {dim}-D {gld.DTYPE} tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: {n} is not a power of two")
    return n.bit_length() - 1


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the card-side comparison)
# ---------------------------------------------------------------------------

def bitrev(n_bits: int, device) -> torch.Tensor:
    idx = torch.arange(1 << n_bits, device=device)
    rev = torch.zeros_like(idx)
    for b in range(n_bits):
        rev |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return rev


def top_twiddles_plain(log_m: int, device) -> torch.Tensor:
    """(2^(log_m - 1),): w^k for w the generator of the order-2^log_m
    subgroup; DIT stage s uses entry k << (log_m - 1 - s)."""
    if log_m == 0:
        return torch.zeros(0, dtype=gld.DTYPE, device=device)
    return gld.powers(gld.two_adic_root(log_m), 1 << (log_m - 1), device)


def encode_plain(evals: torch.Tensor, blowup_log: int) -> torch.Tensor:
    """(C, N) -> (C, N << blowup_log): gl/pcs.py::encode on tensors."""
    c, n = evals.shape
    log_n = _log2(n, "encode")
    x = evals[:, bitrev(log_n, evals.device)]
    for j in range(log_n):  # Moebius: evals -> multilinear coefficients
        blk = 1 << j
        x = x.reshape(c, n // (2 * blk), 2, blk)
        x = torch.stack([x[:, :, 0], gld.sub(x[:, :, 1], x[:, :, 0])], dim=2).reshape(c, n)
    log_m = log_n + blowup_log
    m = 1 << log_m
    padded = torch.zeros((c, m), dtype=gld.DTYPE, device=evals.device)
    padded[:, :n] = x
    x = padded[:, bitrev(log_m, evals.device)]
    tw = top_twiddles_plain(log_m, evals.device)
    for s in range(log_m):
        half = 1 << s
        x = x.reshape(c, m // (2 * half), 2 * half)
        lo, hi = x[:, :, :half], x[:, :, half:]
        thi = gld.mul(hi, tw[:: 1 << (log_m - 1 - s)][:half])
        x = torch.cat([gld.add(lo, thi), gld.sub(lo, thi)], dim=2).reshape(c, m)
    return x.contiguous()


def leaf_sponge_plain(cols: torch.Tensor) -> torch.Tensor:
    """(C, M) -> (4, M) leaf digests (GlTree.build's leaf sponge)."""
    c, m = cols.shape
    st = torch.zeros((p2.WIDTH, m), dtype=gld.DTYPE, device=cols.device)
    for off in range(0, c, p2.RATE):
        chunk = cols[off: off + p2.RATE]
        k = chunk.shape[0]
        st = torch.cat([gld.add(st[:k], chunk), st[k:]])
        st = p2.permute(st)
    return st[: p2.CAPACITY].contiguous()


def compress_level_plain(level: torch.Tensor) -> torch.Tensor:
    """(4, m) digests -> (4, m/2) parents: permute(2i || 2i+1)[:4]."""
    return p2.permute(torch.cat([level[:, 0::2], level[:, 1::2]]))[: p2.CAPACITY].contiguous()


@functools.lru_cache(maxsize=None)
def _level_layout(m: int) -> tuple:
    """(shape, stride, offset) of each level of an m-leaf tree in its buffer."""
    layout, off = [], 0
    for k in range(1, m.bit_length()):
        w = m >> k
        layout.append(((p2.CAPACITY, w), (w, 1), off))
        off += p2.CAPACITY * w
    return tuple(layout)


def level_views(buf: torch.Tensor, m: int) -> tuple:
    """The (4, m/2), ..., (4, 1) levels of an m-leaf tree, as contiguous views
    of one buffer of 4 (m - 1) words, one after another."""
    return tuple(buf.as_strided(*spec) for spec in _level_layout(m))


def merkle_levels_plain(leaves: torch.Tensor) -> tuple:
    """Every level above (4, m) leaves, level after level, laid out as
    :func:`merkle_levels` lays them out."""
    m = leaves.shape[1]
    views = level_views(torch.empty(p2.CAPACITY * (m - 1), dtype=gld.DTYPE,
                                    device=leaves.device), m)
    cur = leaves
    for v in views:
        cur = compress_level_plain(cur)
        v.copy_(cur)
    return views


def merkle_launches(m: int) -> int:
    """K14c's launches for a tree of m leaves: one per level while the level
    below has more than K14C_TOP digests, then one for the rest."""
    log_m = _log2(m, "merkle_launches")
    top = K14C_TOP.bit_length() - 1
    return max(0, log_m - top) + (1 if min(log_m, top) > 0 else 0)


def encode_launches(log_n: int, log_m: int) -> int:
    """K14a's launches for one encode (the twiddle table not included)."""
    return 2 + log_n + log_m


# ---------------------------------------------------------------------------
# Launchers (shared by the wrappers and the host-compiled tests)
# ---------------------------------------------------------------------------

def launch_twiddles(lib, stream, tw: torch.Tensor, log_m: int) -> None:
    rc = lib.gl_twiddles(tw.data_ptr(), log_m, gld.two_adic_root(log_m), stream)
    cuda_build.raise_on(rc, "gl_twiddles")


def launch_encode(lib, stream, evals, tw, out, blowup_log: int) -> None:
    c, n = evals.shape
    log_n = _log2(n, "encode")
    scratch = torch.empty_like(evals)
    rc = lib.gl_encode(evals.data_ptr(), scratch.data_ptr(), out.data_ptr(), tw.data_ptr(), c,
                       log_n, log_n + blowup_log, stream)
    cuda_build.raise_on(rc, "gl_encode")


def launch_leaf_sponge(lib, stream, cols, out) -> None:
    rc = lib.gl_leaf_sponge(cols.data_ptr(), out.data_ptr(), cols.shape[0], cols.shape[1], stream)
    cuda_build.raise_on(rc, "gl_leaf_sponge")


def launch_merkle_levels(lib, stream, leaves, out) -> None:
    rc = lib.gl_merkle_levels(leaves.data_ptr(), out.data_ptr(), leaves.shape[1], stream)
    cuda_build.raise_on(rc, "gl_merkle_levels")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _top_twiddles(log_m: int, device: torch.device) -> torch.Tensor:
    tw = torch.empty(max(1, 1 << max(log_m - 1, 0)), dtype=gld.DTYPE, device=device)
    if log_m:
        with cuda_build.launch_stream(tw) as stream:
            launch_twiddles(_lib(), stream, tw, log_m)
        LAUNCHES["gl_encode"] += 1
    return tw


def encode(evals: torch.Tensor, blowup_log: int) -> torch.Tensor:
    """K14a: (C, N) evals, N a power of two -> (C, N << blowup_log) codeword
    (the variable-reversed multilinear in natural domain order)."""
    _check(evals, "encode")
    if evals.device.type == "cpu":
        return encode_plain(evals, blowup_log)
    c, n = evals.shape
    log_n = _log2(n, "encode")
    log_m = log_n + blowup_log
    out = torch.empty((c, n << blowup_log), dtype=gld.DTYPE, device=evals.device)
    if c == 0:
        return out
    tw = _top_twiddles(log_m, evals.device)
    with cuda_build.launch_stream(evals) as stream:
        launch_encode(_lib(), stream, evals, tw, out, blowup_log)
    LAUNCHES["gl_encode"] += encode_launches(log_n, log_m)
    return out


def leaf_sponge(cols: torch.Tensor) -> torch.Tensor:
    """K14b: (C, M) -> (4, M) leaf digests."""
    _check(cols, "leaf_sponge")
    if cols.device.type == "cpu":
        return leaf_sponge_plain(cols)
    out = torch.empty((p2.CAPACITY, cols.shape[1]), dtype=gld.DTYPE, device=cols.device)
    with cuda_build.launch_stream(cols) as stream:
        launch_leaf_sponge(_lib(), stream, cols, out)
    LAUNCHES["gl_leaf_sponge"] += 1
    return out


def merkle_levels(leaves: torch.Tensor) -> tuple:
    """K14c: (4, m) leaf digests, m a power of two -> the levels ((4, m/2),
    ..., (4, 1)), contiguous views of one buffer of 4 (m - 1) words."""
    _check(leaves, "merkle_levels")
    if leaves.shape[0] != p2.CAPACITY:
        raise ValueError(f"merkle_levels: expected (4, m) digests, got {tuple(leaves.shape)}")
    m = leaves.shape[1]
    _log2(m, "merkle_levels")
    if leaves.device.type == "cpu":
        return merkle_levels_plain(leaves)
    out = torch.empty(p2.CAPACITY * (m - 1), dtype=gld.DTYPE, device=leaves.device)
    if m > 1:
        with cuda_build.launch_stream(leaves) as stream:
            launch_merkle_levels(_lib(), stream, leaves, out)
        LAUNCHES["gl_merkle_levels"] += merkle_launches(m)
    return level_views(out, m)


def tree_levels(leaf_cols: torch.Tensor) -> list:
    """K14b then K14c: (C, M) leaf columns -> [leaves (4, M), ..., root (4, 1)]."""
    leaves = leaf_sponge(leaf_cols)
    return [leaves, *merkle_levels(leaves)]


def commit_device(cols: torch.Tensor, blowup_log: int) -> tuple:
    """(C, N) canonical evals -> (codeword (C, M), GlTree), all on the
    columns' device."""
    from .pcs import GlTree

    cw = encode(cols, blowup_log)
    return cw, GlTree(tree_levels(cw))
