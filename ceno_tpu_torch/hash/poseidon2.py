"""Poseidon2 permutation over BabyBear, width 16 — host numpy and torch.

Structure follows the Poseidon2 design (external rounds with the M4-block MDS
``circ(2*M4, M4, M4, M4)``, internal rounds with a diagonal-plus-ones matrix,
x^7 S-box), as in ``ceno_tpu/hash/poseidon2.py``.

The tables below are COPIED from the reference, not re-derived: the reference
generates them from a SHA-256 counter stream labelled
``ceno-tpu/poseidon2/babybear/w16/v1`` (``ceno_tpu/hash/poseidon2.py:40-74``).
They are protocol constants; the CUDA kernels in ``csrc/poseidon2_merkle.cu``
carry their Montgomery forms, checked against these lists by
tests/test_torch_poseidon2.py.

Two backends with one parameter set:
  * host: numpy uint64 canonical arithmetic (transcript, verifier);
  * torch: :func:`permute` on a (16, B) Montgomery int32 tensor, the
    counterpart of the reference's ``permute_device``. Internally it works on
    canonical int64 values (the permutation is the same field map), which is
    also the plain version the CUDA Merkle kernels are held against.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb

WIDTH = 16
RATE = 8  # the last 8 words are the capacity
ROUNDS_F = 8  # external rounds (half before, half after internal)
ROUNDS_P = 13  # internal rounds
DIGEST_ELEMS = 8

RC_EXTERNAL = [
    [1591209863, 546145332, 979273071, 27037379, 446331235, 211031299, 499032436, 400602670,
     708938637, 523998150, 1524477673, 1672007471, 658358935, 1483512121, 1370266681, 319988270],
    [1997824824, 860008821, 1647723572, 274041542, 179322828, 1039397330, 1449384967, 1228253041,
     1478205004, 1731555570, 939576506, 1183163681, 347964627, 557310453, 1624365036, 276215160],
    [1675695301, 1142225540, 599578159, 584140997, 1781659765, 1121889868, 930739810, 1111031281,
     1197207084, 138745893, 26372340, 789300637, 1535374848, 129661206, 113124448, 167262860],
    [1115327038, 1344317696, 1996967936, 1407500675, 1724048304, 1634789171, 1073812894, 144717617,
     1145609219, 688692446, 1116882268, 1291102371, 1633455951, 617676409, 28784065, 456051436],
    [1634338769, 55263412, 626489528, 818187835, 1405616251, 1017841344, 1536688316, 1925146069,
     1489317983, 1661291967, 1225397337, 774621415, 1010118578, 908142501, 1271674568, 1865907986],
    [1444458453, 1919494684, 1890675095, 1835035837, 531627932, 968414785, 1056330477, 608456192,
     1077468867, 1867205740, 1523271724, 838270938, 1821262573, 1354637551, 1905881331, 1845887699],
    [545816520, 1613585328, 112113159, 1287279698, 778216378, 271556200, 1483312711, 1859361021,
     710800823, 1358014568, 1592699856, 1984528753, 962492392, 1877407638, 1414963227, 808481843],
    [1043228824, 1253328242, 757119205, 379598127, 1304111975, 617015429, 1207013935, 7310047,
     1649929481, 758718956, 189929457, 103134375, 648731370, 947401654, 737555125, 562464210],
]
RC_INTERNAL = [
    1795869561, 1869173789, 1123470841, 132192889, 695014322, 1477944681, 1057298876,
    1150349197, 836107182, 1737861208, 185060530, 739181146, 188947808,
]
INTERNAL_DIAG = [
    385322901, 801401774, 1654446802, 1556271657, 1225056795, 1849882241, 1453491152,
    557409368, 496775698, 1514946786, 492117667, 556340949, 394310843, 338528175,
    1687539194, 8491249,
]

# Montgomery-form copies (the CUDA kernels' __constant__ tables)
RC_EXTERNAL_M = np.array([[bb.const(c) for c in row] for row in RC_EXTERNAL], np.uint32)
RC_INTERNAL_M = np.array([bb.const(c) for c in RC_INTERNAL], np.uint32)
DIAG_M = np.array([bb.const(c) for c in INTERNAL_DIAG], np.uint32)


# ---------------------------------------------------------------------------
# Host backend: numpy uint64, canonical form. state shape (16,) or (16, N).
# ---------------------------------------------------------------------------

_P64 = np.uint64(bb.P)


def _h_sbox(x):
    x2 = x * x % _P64
    x4 = x2 * x2 % _P64
    return x4 * x2 % _P64 * x % _P64


def _h_m4(v):
    """Apply M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] to 4 rows of v."""
    v0, v1, v2, v3 = v
    s = (v0 + v1 + v2 + v3) % _P64
    return np.stack([
        (s + v0 + 2 * v1) % _P64,
        (s + v1 + 2 * v2) % _P64,
        (s + v2 + 2 * v3) % _P64,
        (s + v3 + 2 * v0) % _P64,
    ])


def _h_external_linear(state):
    """M_E = circ(2*M4, M4, M4, M4): y_i = M4 @ (x_i + sum_j x_j)."""
    blocks = state.reshape(4, 4, *state.shape[1:])
    t = blocks.sum(axis=0) % _P64
    out = np.empty_like(blocks)
    for i in range(4):
        out[i] = _h_m4((blocks[i] + t) % _P64)
    return out.reshape(state.shape)


def _h_internal_linear(state):
    s = state.sum(axis=0) % _P64
    diag = np.array(INTERNAL_DIAG, np.uint64).reshape((WIDTH,) + (1,) * (state.ndim - 1))
    return (state * diag % _P64 + s) % _P64


def permute_host(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation; ``state`` is canonical uint64 (16,) or (16, N)."""
    st = np.asarray(state, np.uint64) % _P64
    st = _h_external_linear(st)
    half = ROUNDS_F // 2
    for r in range(half):
        st = (st + np.array(RC_EXTERNAL[r], np.uint64).reshape(
            (WIDTH,) + (1,) * (st.ndim - 1))) % _P64
        st = _h_sbox(st)
        st = _h_external_linear(st)
    for r in range(ROUNDS_P):
        st[0] = (st[0] + np.uint64(RC_INTERNAL[r])) % _P64
        st[0] = _h_sbox(st[0])
        st = _h_internal_linear(st)
    for r in range(half, ROUNDS_F):
        st = (st + np.array(RC_EXTERNAL[r], np.uint64).reshape(
            (WIDTH,) + (1,) * (st.ndim - 1))) % _P64
        st = _h_sbox(st)
        st = _h_external_linear(st)
    return st


def hash_elements_host(elems) -> np.ndarray:
    """Sponge hash of a flat list of canonical field elements -> 8-elem digest."""
    state = np.zeros(WIDTH, np.uint64)
    elems = np.asarray(elems, np.uint64)
    n = len(elems)
    for off in range(0, max(n, 1), RATE):
        chunk = elems[off : off + RATE]
        state[: len(chunk)] = (state[: len(chunk)] + chunk) % _P64
        state = permute_host(state)
    return state[:DIGEST_ELEMS].copy()


def compress_host(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """2-to-1 compression: permute(left || right)[:8]. Inputs are 8-elem digests."""
    state = np.concatenate([np.asarray(left, np.uint64), np.asarray(right, np.uint64)])
    return permute_host(state)[:DIGEST_ELEMS].copy()


# ---------------------------------------------------------------------------
# Torch backend: canonical int64 internally, (16, B) state.
# ---------------------------------------------------------------------------

def _t_sbox(x):
    x2 = x * x % bb.P
    x4 = x2 * x2 % bb.P
    return x4 * x2 % bb.P * x % bb.P


def _t_external_linear(st):
    """circ(2*M4, M4, M4, M4) on a canonical int64 (16, B) state."""
    blocks = st.view(4, 4, -1)
    x = (blocks + blocks.sum(dim=0, keepdim=True)) % bb.P  # (4 blocks, 4, B)
    v0, v1, v2, v3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    s = v0 + v1 + v2 + v3
    out = torch.stack([s + v0 + 2 * v1, s + v1 + 2 * v2,
                       s + v2 + 2 * v3, s + v3 + 2 * v0], dim=1)
    return (out % bb.P).view(WIDTH, -1)


def permute_canonical(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2 on a canonical int64 (16, B) tensor (values in [0, p))."""
    dev = st.device
    rc_ext = torch.tensor(RC_EXTERNAL, dtype=torch.int64, device=dev)[:, :, None]
    rc_int = RC_INTERNAL
    diag = torch.tensor(INTERNAL_DIAG, dtype=torch.int64, device=dev)[:, None]
    half = ROUNDS_F // 2
    st = _t_external_linear(st)
    for r in range(half):
        st = _t_external_linear(_t_sbox((st + rc_ext[r]) % bb.P))
    for r in range(ROUNDS_P):
        s0 = _t_sbox((st[0] + rc_int[r]) % bb.P)
        st = torch.cat([s0[None], st[1:]])
        st = (st * diag + st.sum(dim=0)) % bb.P
    for r in range(half, ROUNDS_F):
        st = _t_external_linear(_t_sbox((st + rc_ext[r]) % bb.P))
    return st


def permute(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation on a Montgomery int32 (16, B) tensor.

    Counterpart of ``ceno_tpu.hash.poseidon2.permute_device``."""
    shape = state.shape
    st = bb.from_monty(state.reshape(WIDTH, -1)).long()
    return bb.to_monty(permute_canonical(st)).reshape(shape)
