"""Keccak-f[1600] host implementations for the KECCAK_PERMUTE syscall.

Role mirror of the reference's keccak syscall backend
(ceno_emul/src/syscalls/keccak_permute.rs: 25 u64 lanes, lane i =
words[2i] | words[2i+1] << 32, sp1-compatible layout). Two forms:

  * ``keccakf(lanes)`` — one permutation over python ints (emulator step).
  * ``keccakf_rounds_np(states)`` — numpy batched, returns the state at
    EVERY round boundary: shape (n_instances, 25) uint64 in, (25 rounds
    incl. input, n, 25) out. Witgen for the keccak core chip needs all
    intermediate round states, not just the output.

The implementation is validated end-to-end against hashlib's SHA3-256 in
tests/test_keccak.py (SHA3 = sponge over this exact permutation).

Copy of ``ceno_tpu/emulator/keccak.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1
ROUNDS = 24

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offset for lane A[x, y] (flat index x + 5y)
ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & MASK64


def keccak_round(a: list, rnd: int) -> list:
    """One keccak-f round over 25 python-int lanes (A[x,y] = a[x + 5y])."""
    c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
    d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
    b = [0] * 25
    for x in range(5):
        for y in range(5):
            b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(
                a[x + 5 * y] ^ d[x], ROT[x][y]
            )
    out = [
        b[x + 5 * y] ^ ((b[(x + 1) % 5 + 5 * y] ^ MASK64) & b[(x + 2) % 5 + 5 * y])
        for y in range(5)
        for x in range(5)
    ]
    out[0] ^= RC[rnd]
    return out


def keccakf(lanes: list) -> list:
    """Full 24-round permutation over 25 python-int lanes."""
    a = [v & MASK64 for v in lanes]
    for rnd in range(ROUNDS):
        a = keccak_round(a, rnd)
    return a


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256 (pad 0x01, rate 136) — the PUB_IO_COMMIT digest
    (ceno_zkvm e2e.rs public_io_words_to_digest_words uses tiny-keccak
    Keccak::v256)."""
    state = [0] * 25
    rate = 136
    msg = bytearray(data)
    msg.append(0x01)
    while len(msg) % rate:
        msg.append(0)
    msg[-1] |= 0x80
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(msg[off + 8 * i : off + 8 * i + 8], "little")
        state = keccakf(state)
    return b"".join(s.to_bytes(8, "little") for s in state[:4])


# Keccak-256("") as 8 little-endian u32 words (e2e.rs KECCAK_EMPTY_WORDS)
KECCAK_EMPTY_WORDS = [
    0x0146D2C5, 0x3C23F786, 0xB27D7E92, 0xC003C7DC,
    0x53B600E5, 0x3B2782CA, 0x04D8FA7B, 0x70A4855D,
]


def public_io_digest_words(words: list) -> list:
    """Digest of the guest's public-output u32 words, as 8 u32 words."""
    if not words:
        return list(KECCAK_EMPTY_WORDS)
    data = b"".join(int(w).to_bytes(4, "little") for w in words)
    d = keccak256(data)
    return [int.from_bytes(d[4 * i : 4 * i + 4], "little") for i in range(8)]


def words_to_lanes(words: list) -> list:
    """50 u32 words -> 25 u64 lanes (keccak_permute.rs layout)."""
    return [
        (words[2 * i] | (words[2 * i + 1] << 32)) & MASK64 for i in range(25)
    ]


def lanes_to_words(lanes: list) -> list:
    out = []
    for v in lanes:
        out.append(v & 0xFFFFFFFF)
        out.append((v >> 32) & 0xFFFFFFFF)
    return out


# ---------------------------------------------------------------------------
# Batched numpy path (witgen)
# ---------------------------------------------------------------------------

def _rotl_np(v: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return v
    return (v << np.uint64(r)) | (v >> np.uint64(64 - r))


def keccak_round_np(a: np.ndarray, rnd: int) -> np.ndarray:
    """One round over (n, 25) uint64 states."""
    c = [
        a[:, x] ^ a[:, x + 5] ^ a[:, x + 10] ^ a[:, x + 15] ^ a[:, x + 20]
        for x in range(5)
    ]
    d = [c[(x + 4) % 5] ^ _rotl_np(c[(x + 1) % 5], 1) for x in range(5)]
    b = [np.zeros_like(a[:, 0])] * 25
    for x in range(5):
        for y in range(5):
            b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl_np(
                a[:, x + 5 * y] ^ d[x], ROT[x][y]
            )
    out = np.empty_like(a)
    full = np.uint64(MASK64)
    for y in range(5):
        for x in range(5):
            out[:, x + 5 * y] = b[x + 5 * y] ^ (
                (b[(x + 1) % 5 + 5 * y] ^ full) & b[(x + 2) % 5 + 5 * y]
            )
    out[:, 0] ^= np.uint64(RC[rnd])
    return out


def keccakf_rounds_np(states: np.ndarray) -> np.ndarray:
    """(n, 25) input states -> (ROUNDS + 1, n, 25): state before each round
    r (index r) and the final output (index ROUNDS)."""
    n = states.shape[0]
    out = np.zeros((ROUNDS + 1, n, 25), np.uint64)
    out[0] = states
    for rnd in range(ROUNDS):
        out[rnd + 1] = keccak_round_np(out[rnd], rnd)
    return out
