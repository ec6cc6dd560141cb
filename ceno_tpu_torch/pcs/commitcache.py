"""Content-addressed cache for Basefold commitments of KEY material.

keygen's only device work is the Basefold commit of the stacked fixed
columns — deterministic data that never changes unless the tables change.
Cached, it costs one file read and the copies to the device.

The cache key is a digest of the MATRIX CONTENT + the commitment-relevant
params (blowup), so it is immune to unrelated source edits and can never
serve a stale commitment: different fixed tables -> different key.

Counterpart of ``ceno_tpu/pcs/commitcache.py``: the same key (``_key``) and
the same npz layout (canonical ``uint32`` ``cw`` and ``leaves``, ``n_vars``,
``n_levels``, ``level{i}``), so each package reads the other's files. A
loaded commitment is a :class:`basefold.Committed` on ``device``: cols and
codeword as Montgomery int32 tensors, the tree a :class:`MerkleTree` with
its leaves and levels on the device and its root canonical on the host, so
the openings run exactly as after a fresh commit (the reference restores a
host tree). The switch is ``CENO_TPU_TORCH_COMMIT_CACHE``. The port has no
size crossover, so it caches at every size (the reference skips sizes up to
``HOST_COMMIT_N``); a WHIR key is committed without the cache, as in the
reference.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
import zlib

import numpy as np

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from . import basefold
from .merkle import MerkleTree

ENV = "CENO_TPU_TORCH_COMMIT_CACHE"


def _key(mat: np.ndarray, params) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(mat, np.uint64).tobytes())
    h.update(repr((mat.shape, int(params.blowup_log))).encode())
    return h.hexdigest()[:32]


def cache_path(cache_dir: str, mat: np.ndarray, params) -> str:
    """The file that holds ``mat``'s commitment under ``cache_dir``."""
    return os.path.join(cache_dir, f"commit-{_key(mat, params)}.npz")


def commit_cached(mat: np.ndarray, params, cache_dir: str | None = None, device=None):
    """basefold.commit(mat) on ``device`` with an on-disk cache (see module doc).

    ``mat`` is a host canonical (C, N) matrix. With no ``cache_dir`` and the
    switch unset, or for a WHIR key, this is a plain commit."""
    device = device or DEFAULT_DEVICE
    cache_dir = cache_dir or os.environ.get(ENV)
    if not cache_dir or params.pcs_kind == "whir":
        return basefold.commit(mat, params, device=device)
    os.makedirs(cache_dir, exist_ok=True)
    path = cache_path(cache_dir, mat, params)
    if os.path.exists(path):
        try:
            return _load(path, mat, device)
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error):
            # a truncated or foreign file: drop it and commit afresh
            try:
                os.unlink(path)
            except OSError:
                pass
    committed = basefold.commit(mat, params, device=device)
    try:
        _save(path, committed)
    except OSError:
        pass  # a read-only cache still serves its hits
    return committed


def _save(path: str, committed) -> None:
    tree = committed.tree
    payload = {
        "cw": bb.to_host(committed.codeword).astype(np.uint32),
        "leaves": bb.to_host(tree.leaves).astype(np.uint32),
        "n_vars": np.int64(committed.n_vars),
        "n_levels": np.int64(len(tree.levels)),
    }
    for i, lv in enumerate(tree.levels):
        payload[f"level{i}"] = bb.to_host(lv).astype(np.uint32)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(path: str, mat: np.ndarray, device):
    with np.load(path) as z:
        cw = z["cw"].astype(np.uint64)
        leaves = z["leaves"].astype(np.uint64)
        n_vars = int(z["n_vars"])
        levels = [z[f"level{i}"].astype(np.uint64) for i in range(int(z["n_levels"]))]
    if cw.shape[0] != mat.shape[0] or n_vars != mat.shape[1].bit_length() - 1:
        raise ValueError(f"{path}: a codeword {cw.shape} of {n_vars} variables for a "
                         f"{mat.shape} matrix")
    tree = MerkleTree.from_device(bb.to_device(leaves, device),
                                  [bb.to_device(lv, device) for lv in levels])
    return basefold.Committed(bb.to_device(mat, device), bb.to_device(cw, device), tree, n_vars)
