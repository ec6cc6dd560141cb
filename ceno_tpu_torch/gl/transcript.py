"""Fiat-Shamir transcript over Goldilocks: Poseidon2-GL duplex sponge (host).

Copy of ``ceno_tpu/gl/transcript.py``, the same duplex semantics as
hash/transcript.py: absorb into rate slots, permute on demand, squeeze
consecutive slots; ext challenges read DEGREE consecutive base samples.
Includes the PoW grinding used by the PCS query phase.

Three deliberate differences, with the same values: absorbs add in Python
ints and permute a single state through ``poseidon2.permute_host``'s C++
path; :meth:`GlTranscript.grind` raises after
``2^(pow_bits + GRIND_SLACK_BITS)`` candidates where the reference loops on
(as the BabyBear port's ``Transcript.grind``); and the grind's scan runs in
C++ on the host (``poseidon2.grind``), one candidate after another from 0
as the reference's chunked numpy scan goes, so it finds the same nonce,
about ten times faster.
"""

from __future__ import annotations

import numpy as np

from ..fields import gl_host as gl
from ..fields import gl2_host as g2
from . import poseidon2 as p2

# A nonce below P >> pow_bits turns up within 2^pow_bits candidates on
# average; 2^10 times that many without one means the permutation is broken.
GRIND_SLACK_BITS = 10


class GlTranscript:
    __slots__ = ("state", "_pos", "_sq_pos", "_absorbed")

    def __init__(self, label: bytes | None = None):
        self.state = np.zeros(p2.WIDTH, np.uint64)
        self._pos = 0
        self._sq_pos = p2.RATE
        self._absorbed = False
        if label is not None:
            words = [
                int.from_bytes(label[i : i + 8], "little") % gl.P
                for i in range(0, len(label), 8)
            ]
            self.append(p2.hash_elements(words or [0]))

    def append(self, elems) -> None:
        arr = np.atleast_1d(np.asarray(elems, np.uint64))
        for e in arr.ravel().tolist():
            if self._pos == p2.RATE:
                self.state = p2.permute_host(self.state)
                self._pos = 0
            self.state[self._pos] = (int(self.state[self._pos]) + e) % gl.P
            self._pos += 1
            self._absorbed = True

    def sample_base(self) -> int:
        if self._absorbed or self._sq_pos == p2.RATE:
            self.state = p2.permute_host(self.state)
            self._pos = 0
            self._sq_pos = 0
            self._absorbed = False
        v = int(self.state[self._sq_pos])
        self._sq_pos += 1
        return v

    def sample_ext(self) -> np.ndarray:
        return np.array([self.sample_base(), self.sample_base()], np.uint64)

    def sample_exts(self, n: int) -> np.ndarray:
        return np.stack([self.sample_ext() for _ in range(n)]) if n else \
            np.zeros((0, 2), np.uint64)

    def sample_ext_pows(self, n: int) -> np.ndarray:
        out = np.zeros((n, 2), np.uint64)
        if n == 0:
            return out
        a = self.sample_ext()
        out[0] = g2.one()
        for i in range(1, n):
            out[i] = g2.mul(out[i - 1], a)
        return out

    def grind(self, pow_bits: int) -> int:
        """Find and absorb the smallest nonce that makes the next sample fall
        below ``P >> pow_bits`` (the PoW protocol of the BabyBear transcript).
        Raises RuntimeError after ``2^(pow_bits + GRIND_SLACK_BITS)``
        candidates without a hit."""
        if pow_bits <= 0:
            return 0
        threshold = np.uint64(gl.P >> pow_bits)
        pre = self.state.copy()
        pos = self._pos
        if pos == p2.RATE:
            pre = p2.permute_host(pre)
            pos = 0
        limit = 1 << (pow_bits + GRIND_SLACK_BITS)
        nonce = p2.grind(pre, pos, int(threshold), limit)
        if nonce >= limit:
            raise RuntimeError(
                f"PoW grind found no nonce in {limit} candidates at "
                f"pow_bits={pow_bits}: the Poseidon2-GL permutation is broken"
            )
        self.append([nonce])
        got = self.sample_base()
        if got >= int(threshold):
            raise RuntimeError("PoW grind simulation diverged from sponge")
        return nonce

    def check_grind(self, nonce: int, pow_bits: int) -> bool:
        if pow_bits <= 0:
            return True
        self.append([int(nonce) % gl.P])
        return self.sample_base() < (gl.P >> pow_bits)
