"""Poseidon2 permutation over Goldilocks, width 8 (host numpy, Python ints
and torch).

Counterpart of ``ceno_tpu/gl/poseidon2.py``: the Poseidon2 structure of
hash/poseidon2.py (external rounds with the circ(2*M4, M4) MDS, internal
rounds with diagonal-plus-ones), sized for the 64-bit field: width 8, rate 4,
x^7 S-box, 8 external + 22 internal rounds.

The tables below are COPIED from the reference, not re-derived: the reference
generates them from a SHA-256 counter stream labelled
``ceno-tpu/poseidon2/goldilocks/w8/v1`` (``ceno_tpu/gl/poseidon2.py:29-56``).
They are protocol constants; ``csrc/poseidon2_gl.cuh`` carries the same
words, checked against these lists by tests/test_torch_gl_device.py.

Three backends with one parameter set:
  * host numpy (:func:`permute_host` on an (8, N) state: the shard chips'
    hash-to-curve);
  * host C++ (``native/poseidon2_gl.cpp``, built on first use by
    utils/host_build.py and given these tables): :func:`permute_host` on one
    (8,) state (the transcript and the verifiers, which permute one state
    thousands of times; tests/test_torch_gl_fields.py holds it to the vector
    path) and the PoW grind's scan (:func:`grind`);
  * torch (:func:`permute` on an (8, B) int64 tensor): the plain version the
    CUDA kernels of ``csrc/gl_commit.cu`` are held against.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import goldilocks as gld
from ..utils import host_build

WIDTH = 8
RATE = 4
CAPACITY = 4
ROUNDS_F = 8
ROUNDS_P = 22
SBOX_DEGREE = 7

RC_EXTERNAL = [
    [2031618593185754869, 3432403489611380916, 7987981663259121864, 4329806497336793805,
     14532812965463370848, 15468315482880103813, 13676642445056557418, 12030359105841636824],
    [18054184706103121699, 7776881267572101256, 4336974057242069992, 394122017315624982,
     4766137497220347152, 17170435619912427379, 14355018161940117601, 9959515110619415947],
    [12691290039017386401, 9774484827601984687, 7649336873885655821, 17177950959366173308,
     7706453437383322178, 8034672918903526054, 3065169286445416160, 15653851988684666802],
    [12334716657015038703, 16585971878836938271, 11818239487840594525, 11947305106885870077,
     12087595350717736206, 3544608484366662498, 6646316618649036804, 4792662842545322661],
    [17517054407668691764, 6187142605856211298, 900556042832486369, 18307488334969235434,
     6971369863102743761, 14022477157501343651, 11888990774238475598, 8054082509075348818],
    [4349310624728270901, 11269156142279079542, 11279534862112194162, 4227475082586583656,
     7907722037507996608, 9675175281794624498, 13673992326596094255, 13732443186617952130],
    [11553875438160352273, 16757417920895115246, 12730601915365982496, 15150726534746373001,
     9941295895590585863, 4268113738361564171, 16734529883680710515, 2993505548631775780],
    [9375514792243972148, 16508536793478191554, 4594630832469944209, 18145076214701435545,
     17450601215507939202, 17873767526322263854, 613216202137069285, 6925253037763991501],
]
RC_INTERNAL = [
    4672119760297350206, 15297052316536637781, 1683634138780411170,
    11816063636541864053, 2284981639534042247, 5250148516861925264,
    3314869896890716714, 5537627734649403782, 3122857012456384725,
    16478668656320918980, 593133105910486182, 1634008322912293316,
    4944951602155960337, 11522685126174571361, 6465205421732433158,
    9878850147319710672, 12591435048983553772, 6165907533577937877,
    5857944589097134819, 12160634824122445462, 5099134678994234294,
    395765264303742840,
]
INTERNAL_DIAG = [
    4815815279470530832, 4438287559686119854, 5799073506019671573,
    5735567024940043041, 17348056572778980552, 10513472783766323601,
    8236634590262862694, 8909240513944936432,
]

_RC_EXTERNAL = [np.array(row, np.uint64) for row in RC_EXTERNAL]
_RC_INTERNAL = np.array(RC_INTERNAL, np.uint64)
_DIAG = np.array(INTERNAL_DIAG, np.uint64)


# ---------------------------------------------------------------------------
# Host numpy backend (copy of the reference)
# ---------------------------------------------------------------------------

def _sbox(x):
    x2 = gl.mul(x, x)
    x4 = gl.mul(x2, x2)
    return gl.mul(gl.mul(x4, x2), x)


def _m4(v):
    """M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on 4 rows of v."""
    v0, v1, v2, v3 = v
    s = gl.add(gl.add(v0, v1), gl.add(v2, v3))
    two = np.uint64(2)
    return np.stack([
        gl.add(s, gl.add(v0, gl.mul(two, v1))),
        gl.add(s, gl.add(v1, gl.mul(two, v2))),
        gl.add(s, gl.add(v2, gl.mul(two, v3))),
        gl.add(s, gl.add(v3, gl.mul(two, v0))),
    ])


def _external_linear(state):
    """M_E = circ(2*M4, M4): y_i = M4 @ (x_i + sum_j x_j) per 4-block."""
    blocks = state.reshape(2, 4, *state.shape[1:])
    t = gl.add(blocks[0], blocks[1])
    out = np.stack([_m4(gl.add(blocks[0], t)), _m4(gl.add(blocks[1], t))])
    return out.reshape(state.shape)


def _internal_linear(state):
    s = state[0]
    for i in range(1, WIDTH):
        s = gl.add(s, state[i])
    diag = _DIAG.reshape((WIDTH,) + (1,) * (state.ndim - 1))
    return gl.add(gl.mul(state, diag), np.broadcast_to(s, state.shape))


_NATIVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                           "poseidon2_gl.cpp")
_NATIVE: list = []  # (the library, the tables it takes), loaded on first use
GRIND_THREADS = min(8, len(os.sched_getaffinity(0)))


def _native() -> tuple:
    """The library of ``native/poseidon2_gl.cpp`` (built on first use) and
    the addresses of the round-constant arrays its functions take (the
    arrays are kept alive here)."""
    if not _NATIVE:
        lib = ctypes.CDLL(host_build.build(_NATIVE_SRC, "libgl_poseidon2"))
        ptr = ctypes.c_void_p
        lib.gl_permute.restype = None
        lib.gl_permute.argtypes = [ptr] * 4
        lib.gl_grind.restype = ctypes.c_uint64
        lib.gl_grind.argtypes = [ptr, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
                                 ptr, ptr, ptr, ctypes.c_int]
        tables = [np.array(t, np.uint64).ravel()
                  for t in (RC_EXTERNAL, RC_INTERNAL, INTERNAL_DIAG)]
        _NATIVE.append((lib, tables, tuple(t.ctypes.data for t in tables)))
    return _NATIVE[0][0], _NATIVE[0][2]


def _permute_one(v: list) -> list:
    """One state (a list of ints below 2^64, reduced mod p here, as the
    reference's int arithmetic reduces them) through the C++ rounds."""
    lib, tables = _native()
    st = np.array(v, np.uint64) % np.uint64(gl.P)
    lib.gl_permute(st.ctypes.data, *tables)
    return st.tolist()


def grind(pre: np.ndarray, pos: int, threshold: int, limit: int) -> int:
    """The smallest nonce below ``limit`` that, added to word ``pos`` of the
    state ``pre``, permutes to a first word below ``threshold``; ``limit`` if
    none does (``native/poseidon2_gl.cpp``'s scan, on up to GRIND_THREADS
    host threads)."""
    lib, tables = _native()
    pre = np.ascontiguousarray(pre, np.uint64)
    return min(limit, int(lib.gl_grind(pre.ctypes.data, pos, threshold, limit, *tables,
                                       GRIND_THREADS)))


def permute_host(state: np.ndarray) -> np.ndarray:
    """Poseidon2-GL permutation; state canonical uint64 (8,) or (8, N)."""
    st = np.asarray(state, np.uint64) % np.uint64(gl.P)
    if st.ndim == 1:
        return np.array(_permute_one([int(x) for x in st]), np.uint64)
    st = _external_linear(st)
    half = ROUNDS_F // 2
    for r in range(half):
        rc = _RC_EXTERNAL[r].reshape((WIDTH,) + (1,) * (st.ndim - 1))
        st = _sbox(gl.add(st, rc))
        st = _external_linear(st)
    for r in range(ROUNDS_P):
        st = st.copy()
        st[0] = _sbox(gl.add(st[0], _RC_INTERNAL[r]))
        st = _internal_linear(st)
    for r in range(half, ROUNDS_F):
        rc = _RC_EXTERNAL[r].reshape((WIDTH,) + (1,) * (st.ndim - 1))
        st = _sbox(gl.add(st, rc))
        st = _external_linear(st)
    return st


def hash_elements(elems) -> np.ndarray:
    """Sponge-hash canonical elements to a (4,) digest."""
    arr = np.atleast_1d(np.asarray(elems, np.uint64)).ravel() % np.uint64(gl.P)
    st = [0] * WIDTH
    for i in range(0, len(arr), RATE):
        for j, e in enumerate(arr[i : i + RATE]):
            st[j] = (st[j] + int(e)) % gl.P
        st = _permute_one(st)
    return np.array(st[:CAPACITY], np.uint64)


def compress(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Two (4,) digests -> one (4,) digest (Merkle inner nodes).
    Batched: (4, N) x (4, N) -> (4, N)."""
    st = np.concatenate([np.asarray(left, np.uint64),
                         np.asarray(right, np.uint64)])
    return permute_host(st)[:CAPACITY]


# ---------------------------------------------------------------------------
# Torch backend: (8, B) int64 canonical states
# ---------------------------------------------------------------------------

def _t_sbox(x):
    x2 = gld.mul(x, x)
    x4 = gld.mul(x2, x2)
    return gld.mul(gld.mul(x4, x2), x)


def _t_m4(v):
    """M4 on a (4, ..., B) block."""
    v0, v1, v2, v3 = v[0], v[1], v[2], v[3]
    s = gld.add(gld.add(v0, v1), gld.add(v2, v3))
    return torch.stack([
        gld.add(s, gld.add(v0, gld.add(v1, v1))),
        gld.add(s, gld.add(v1, gld.add(v2, v2))),
        gld.add(s, gld.add(v2, gld.add(v3, v3))),
        gld.add(s, gld.add(v3, gld.add(v0, v0))),
    ])


def _t_external_linear(st):
    b0, b1 = st[:4], st[4:]
    t = gld.add(b0, b1)
    return torch.cat([_t_m4(gld.add(b0, t)), _t_m4(gld.add(b1, t))])


def _consts(device) -> tuple:
    rc_ext = torch.tensor([[gld.const(c) for c in row] for row in RC_EXTERNAL],
                          dtype=gld.DTYPE, device=device)
    diag = torch.tensor([gld.const(c) for c in INTERNAL_DIAG], dtype=gld.DTYPE, device=device)
    return rc_ext, diag


def permute(st: torch.Tensor) -> torch.Tensor:
    """Poseidon2-GL on a canonical int64 (8, B) tensor."""
    rc_ext, diag = _consts(st.device)
    diag = diag.reshape((WIDTH,) + (1,) * (st.dim() - 1))
    half = ROUNDS_F // 2
    st = _t_external_linear(st)
    for r in range(half):
        rc = rc_ext[r].reshape((WIDTH,) + (1,) * (st.dim() - 1))
        st = _t_external_linear(_t_sbox(gld.add(st, rc)))
    for c in RC_INTERNAL:
        s0 = _t_sbox(gld.add(st[0], gld.const(c)))
        st = torch.cat([s0[None], st[1:]])
        s = st[0]
        for i in range(1, WIDTH):
            s = gld.add(s, st[i])
        st = gld.add(gld.mul(st, diag), s)
    for r in range(half, ROUNDS_F):
        rc = rc_ext[r].reshape((WIDTH,) + (1,) * (st.dim() - 1))
        st = _t_external_linear(_t_sbox(gld.add(st, rc)))
    return st
