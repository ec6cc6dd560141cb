"""Poseidon2 Merkle trees over codeword matrices (torch + CUDA kernels).

Counterpart of ``ceno_tpu/pcs/merkle.py``. :func:`hash_and_tree` builds the
leaf digests with K1 and every level with one call of K2's tree entry point
(``hash/poseidon2_merkle.py``), on the codeword's device; a tree keeps its
levels there and only the root and the query paths cross to the host. The
verifier side is numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import babybear as bb
from ..hash import poseidon2 as p2
from ..hash import poseidon2_merkle as pm


def hash_and_tree(cols):
    """cols (C, M) Montgomery, M a power of two -> (leaf_digests (8, M),
    levels tuple of (8, m)).

    K1 once, then K2 once for every level down to the (8, 1) root: one host
    call, one buffer; M = 1 has no levels."""
    leaves = pm.leaf_sponge(cols.contiguous())
    return leaves, pm.merkle_levels(leaves)


def gather_rows(cols, idx):
    """cols (C, M), idx (Q,) -> (C, Q) Montgomery values."""
    idx = torch.as_tensor(np.asarray(idx, np.int64), device=cols.device)
    return cols[:, idx]


def host_hash_leaves(cols: np.ndarray) -> np.ndarray:
    """Host mirror: cols (C, M) canonical -> (8, M) canonical digests."""
    c, m = cols.shape
    state = np.zeros((p2.WIDTH, m), np.uint64)
    for off in range(0, max(c, 1), p2.RATE):
        chunk = cols[off : off + p2.RATE]
        state[: chunk.shape[0]] = (state[: chunk.shape[0]] + chunk) % np.uint64(bb.P)
        state = p2.permute_host(state)
    return state[: p2.DIGEST_ELEMS]


def host_build_levels(leaves: np.ndarray) -> list:
    levels = []
    cur = leaves
    while cur.shape[1] > 1:
        half = cur.shape[1] // 2
        pairs = cur.reshape(p2.DIGEST_ELEMS, half, 2)
        st = np.concatenate([pairs[:, :, 0], pairs[:, :, 1]], axis=0)
        cur = p2.permute_host(st)[: p2.DIGEST_ELEMS]
        levels.append(cur)
    return levels


@dataclass
class MerkleTree:
    """Digest levels of one committed matrix, kept on the device (Montgomery);
    the root is canonical on the host."""

    leaves: torch.Tensor      # (8, M)
    levels: tuple             # ((8, M/2), ..., (8, 1))
    root: np.ndarray          # (8,) canonical

    @staticmethod
    def from_device(leaves, levels) -> "MerkleTree":
        top = levels[-1] if levels else leaves
        return MerkleTree(leaves, tuple(levels), bb.to_host(top[:, 0]))

    def open_paths(self, indices) -> np.ndarray:
        """Batched sibling extraction: (Q, depth, 8) canonical, one gather per
        level."""
        arrs = [self.leaves] + list(self.levels[:-1]) if self.levels else []
        idx = np.asarray(indices, np.int64)
        sibs = []
        for arr in arrs:
            sibs.append(gather_rows(arr, idx ^ 1))
            idx = idx >> 1
        if not sibs:
            return np.zeros((len(indices), 0, 8), np.uint64)
        vals = bb.to_host(torch.stack(sibs))  # (depth, 8, Q)
        return np.ascontiguousarray(vals.transpose(2, 0, 1))


def verify_paths(
    root: np.ndarray,
    indices,
    leaf_values: np.ndarray,
    paths: np.ndarray,
) -> bool:
    """Batched membership check, one Poseidon2 batch per tree level.

    indices: (Q,) leaf positions; leaf_values: (Q, C) canonical row values;
    paths: (Q, depth, 8) sibling digests bottom-up."""
    q = len(indices)
    if q == 0:
        return True
    cur = host_hash_leaves(np.asarray(leaf_values, np.uint64).T)  # (8, Q)
    idx = np.asarray(indices, np.int64).copy()
    depth = paths.shape[1]
    for lvl in range(depth):
        sib = np.asarray(paths[:, lvl, :], np.uint64).T  # (8, Q)
        is_right = (idx & 1)[None, :] == 1
        left = np.where(is_right, sib, cur)
        right = np.where(is_right, cur, sib)
        state = np.concatenate([left, right], axis=0)  # (16, Q)
        cur = p2.permute_host(state)[: p2.DIGEST_ELEMS]
        idx >>= 1
    return bool((cur == np.asarray(root, np.uint64)[:, None]).all())

