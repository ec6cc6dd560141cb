"""Poseidon2 Merkle kernels K1 (leaf sponge) and K2 (level compression).

Counterpart of ``ceno_tpu/hash/poseidon2_pallas.py``: K1 replaces
``leaf_sponge`` and K2 ``compress_level``, both written by hand in CUDA C++
for Hopper (``csrc/poseidon2_merkle.cu``, built by ``utils/cuda_build.py``).

On a CUDA tensor each wrapper launches its kernel on the current stream, or
raises. On a CPU tensor it runs the plain torch version beside it, which is
also what the kernels are compared with on the card. Every launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..fields import babybear as bb
from ..utils import cuda_build
from . import poseidon2 as p2

LAUNCHES = {"leaf_sponge": 0, "compress_level": 0}


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
    lib.p2_compress_level.argtypes = [vp, vp, i64, vp]
    lib.p2_compress_level.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype != bb.DTYPE or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous 2-D {bb.DTYPE} tensor, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


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
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_lib().p2_leaf_sponge(cols.data_ptr(), out.data_ptr(), c, m, stream),
                  "leaf_sponge")
    LAUNCHES["leaf_sponge"] += 1
    return out


def compress_level(level: torch.Tensor) -> torch.Tensor:
    """K2: one Merkle level, (8, m) -> (8, m/2), for any even m >= 2."""
    if level.shape[0] != p2.DIGEST_ELEMS or level.shape[-1] % 2:
        raise ValueError(f"compress_level: bad level shape {tuple(level.shape)}")
    if level.device.type == "cpu":
        return compress_level_plain(level)
    _check(level, "compress_level")
    half = level.shape[1] // 2
    out = torch.empty((p2.DIGEST_ELEMS, half), dtype=bb.DTYPE, device=level.device)
    with torch.cuda.device(level.device):
        stream = torch.cuda.current_stream().cuda_stream
        _raise_on(_lib().p2_compress_level(level.data_ptr(), out.data_ptr(), half, stream),
                  "compress_level")
    LAUNCHES["compress_level"] += 1
    return out
