"""Poseidon2 Merkle kernels K1 (leaf sponge) and K2 (level compression).

Counterpart of ``ceno_tpu/hash/poseidon2_pallas.py``: K1 replaces
``leaf_sponge`` and K2 ``compress_level``, both written by hand in CUDA C++
for Hopper (``csrc/poseidon2_merkle.cu``, built by ``utils/cuda_build.py``).
K2 computes every level of a tree in one host call (:func:`merkle_levels`),
a few levels per launch; :func:`compress_level` runs the same kernel for one
level.

On a CUDA tensor each wrapper launches its kernel on the current stream, or
raises. On a CPU tensor it runs the plain torch version beside it, which is
also what the kernels are compared with on the card. Every kernel launch adds
one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import babybear as bb
from ..utils import cuda_build
from . import poseidon2 as p2

LAUNCHES = {"leaf_sponge": 0, "compress_level": 0}

# K2's launch plan (merkle_plan; csrc/poseidon2_merkle.cu has the timings
# behind it).
K2_THREADS = 256
K2_LEVELS = 2
K2_SPLIT = 1 << 14
K2_SPLIT_THREADS = 512
K2_SPLIT_LEVELS = 8
K2_TOP = 1 << 7
K2_MAX_THREADS = 512  # the source's K2_MAX_THREADS


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library with its C signatures declared (first use
    builds it)."""
    lib = cuda_build.load("poseidon2_merkle")
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.p2_leaf_sponge.argtypes = [vp, vp, ctypes.c_int, i64, vp]
    lib.p2_leaf_sponge.restype = ctypes.c_int
    lib.p2_merkle_levels.argtypes = [vp, vp, i64, vp, ctypes.c_int, vp]
    lib.p2_merkle_levels.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype != bb.DTYPE or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous 2-D {bb.DTYPE} tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def _check_digests(x: torch.Tensor, what: str, power_of_two: bool) -> None:
    """K2's input: (8, m) with m even (a power of two for a whole tree)."""
    m = x.shape[-1] if x.dim() == 2 else 0
    if x.dim() != 2 or x.shape[0] != p2.DIGEST_ELEMS or m < 1 or \
            (power_of_two and m & (m - 1)) or (not power_of_two and m % 2):
        kind = "a power of two" if power_of_two else "even"
        raise ValueError(f"{what}: expected (8, m) digests with m {kind}, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Plain torch versions (CPU path and the card-side comparison)
# ---------------------------------------------------------------------------

def leaf_sponge_plain(cols: torch.Tensor) -> torch.Tensor:
    """(C, M) Montgomery int32 -> (8, M) Montgomery leaf digests."""
    c, m = cols.shape
    st = torch.zeros((p2.WIDTH, m), dtype=torch.int64, device=cols.device)
    for off in range(0, max(c, 1), p2.RATE):
        chunk = bb.from_monty(cols[off : off + p2.RATE]).long()
        k = chunk.shape[0]
        st[:k] = (st[:k] + chunk) % bb.P
        st = p2.permute_canonical(st)
    return bb.to_monty(st[: p2.DIGEST_ELEMS]).contiguous()


def compress_level_plain(level: torch.Tensor) -> torch.Tensor:
    """(8, m) Montgomery digests -> (8, m/2) parents: permute(2i || 2i+1)[:8]."""
    pairs = level.reshape(p2.DIGEST_ELEMS, -1, 2)
    st = bb.from_monty(torch.cat([pairs[:, :, 0], pairs[:, :, 1]])).long()
    return bb.to_monty(p2.permute_canonical(st)[: p2.DIGEST_ELEMS]).contiguous()


@functools.lru_cache(maxsize=None)
def _level_layout(m: int) -> tuple:
    """(shape, stride, offset) of each level of an m-leaf tree in its buffer."""
    layout, off = [], 0
    for k in range(1, m.bit_length()):
        w = m >> k
        layout.append(((p2.DIGEST_ELEMS, w), (w, 1), off))
        off += p2.DIGEST_ELEMS * w
    return tuple(layout)


def level_views(buf: torch.Tensor, m: int) -> tuple:
    """The (8, m/2), (8, m/4), ..., (8, 1) levels of an m-leaf tree, as
    contiguous views of one buffer of 8 (m - 1) words, one after another."""
    return tuple(buf.as_strided(*spec) for spec in _level_layout(m))


def merkle_levels_plain(leaves: torch.Tensor) -> tuple:
    """Every level above (8, m) leaves, by :func:`compress_level_plain` level
    after level, laid out as :func:`merkle_levels` lays them out."""
    m = leaves.shape[1]
    views = level_views(
        torch.empty(p2.DIGEST_ELEMS * (m - 1), dtype=bb.DTYPE, device=leaves.device), m)
    cur = leaves
    for v in views:
        cur = compress_level_plain(cur)
        v.copy_(cur)
    return views


def merkle_plan(m: int) -> tuple:
    """K2's launches for a tree of m leaves (a power of two): triples (levels,
    threads per block, threads per parent), bottom up, covering each of the
    log2(m) levels once.

    Levels of more than K2_SPLIT parents: one thread per parent, K2_THREADS
    a block, up to K2_LEVELS levels a launch. Smaller levels: four threads
    per parent, K2_SPLIT_THREADS / 4 parents a block (fewer where the level
    has fewer), up to K2_SPLIT_LEVELS levels a launch. No launch ends below
    K2_TOP digests; one block then takes the digests left down to the root,
    four threads per parent."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"merkle_plan: m = {m} is not a power of two")
    plan = []
    while m > K2_TOP:
        half = m // 2
        if half > K2_SPLIT:
            n = min(K2_LEVELS, (half // K2_SPLIT).bit_length() - 1)
            plan.append((n, K2_THREADS, 1))
        else:
            per_block = min(K2_SPLIT_THREADS // 4, half)
            n = min(K2_SPLIT_LEVELS, (m // K2_TOP).bit_length() - 1, per_block.bit_length())
            plan.append((n, 4 * per_block, 4))
        m >>= n
    if m > 1:
        plan.append((m.bit_length() - 1, 2 * m, 4))
    return tuple(plan)


@functools.lru_cache(maxsize=None)
def _plan_args(m: int) -> tuple:
    """(int32 array of the plan's triples, number of launches) for the C call."""
    return c_plan(merkle_plan(m))


def c_plan(plan) -> tuple:
    """A plan as the C entry point takes it: (int32 array, number of launches)."""
    return (ctypes.c_int32 * (3 * len(plan)))(*[v for step in plan for v in step]), len(plan)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def leaf_sponge(cols: torch.Tensor) -> torch.Tensor:
    """K1: (C, M) Montgomery codeword -> (8, M) Montgomery leaf digests."""
    if cols.device.type == "cpu":
        return leaf_sponge_plain(cols)
    _check(cols, "leaf_sponge")
    c, m = cols.shape
    out = torch.empty((p2.DIGEST_ELEMS, m), dtype=bb.DTYPE, device=cols.device)
    with cuda_build.launch_stream(cols) as stream:
        rc = _lib().p2_leaf_sponge(cols.data_ptr(), out.data_ptr(), c, m, stream)
    cuda_build.raise_on(rc, "leaf_sponge")
    LAUNCHES["leaf_sponge"] += 1
    return out


def _launch_k2(leaves: torch.Tensor, out: torch.Tensor, plan, n_launches: int,
               what: str) -> None:
    if leaves.data_ptr() % 8:  # the kernel reads children in 8-byte pairs
        raise ValueError(f"{what}: the digests' address is not 8-byte aligned")
    with cuda_build.launch_stream(leaves) as stream:
        rc = _lib().p2_merkle_levels(leaves.data_ptr(), out.data_ptr(), leaves.shape[1],
                                     plan, n_launches, stream)
    cuda_build.raise_on(rc, what)
    LAUNCHES["compress_level"] += n_launches


def merkle_levels(leaves: torch.Tensor) -> tuple:
    """K2 over a whole tree: (8, m) leaf digests, m a power of two, -> the
    levels ((8, m/2), ..., (8, 1)), contiguous views of one buffer of
    8 (m - 1) words; one host call and len(merkle_plan(m)) launches."""
    _check_digests(leaves, "merkle_levels", power_of_two=True)
    if leaves.device.type == "cpu":
        return merkle_levels_plain(leaves)
    _check(leaves, "merkle_levels")
    m = leaves.shape[1]
    out = torch.empty(p2.DIGEST_ELEMS * (m - 1), dtype=bb.DTYPE, device=leaves.device)
    if m > 1:
        _launch_k2(leaves, out, *_plan_args(m), "merkle_levels")
    return level_views(out, m)


def compress_level(level: torch.Tensor) -> torch.Tensor:
    """K2 for one Merkle level, (8, m) -> (8, m/2), for any even m >= 2: one
    launch of the tree kernel covering one level."""
    _check_digests(level, "compress_level", power_of_two=False)
    if level.device.type == "cpu":
        return compress_level_plain(level)
    _check(level, "compress_level")
    half = level.shape[1] // 2
    out = torch.empty((p2.DIGEST_ELEMS, half), dtype=bb.DTYPE, device=level.device)
    _launch_k2(level, out, *c_plan(((1, min(K2_THREADS, half), 1),)), "compress_level")
    return out
