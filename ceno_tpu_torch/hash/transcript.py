"""Fiat–Shamir transcript: a Poseidon2 duplex sponge over BabyBear (host-side).

Copy of ``ceno_tpu/hash/transcript.py`` with the same semantics ("v1", fixed
once proofs are serialized):
  * state = 16 BabyBear elements, rate = first 8, capacity = last 8;
  * new transcript absorbs the 8-element Poseidon2 hash of its byte label;
  * append adds elements into consecutive rate slots, permuting when full;
  * sampling first permutes iff anything was absorbed since the last permute
    (or the squeeze window is exhausted), then reads consecutive rate slots;
  * ext challenges read 4 consecutive base samples (coefficient order);
  * ``fork(i)`` clones the state and absorbs the fork index.

One difference: :meth:`Transcript.grind` gives up after
``2^(pow_bits + GRIND_SLACK_BITS)`` candidates (the expected count is
2^pow_bits), so a broken hash fails instead of spinning. Whenever the
reference's unbounded search would end within that bound, the nonce is the
same.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4
from . import poseidon2 as p2

GRIND_SLACK_BITS = 10


class Transcript:
    __slots__ = ("state", "_pos", "_sq_pos", "_absorbed")

    def __init__(self, label: bytes | None = None):
        self.state = np.zeros(p2.WIDTH, np.uint64)
        self._pos = 0
        self._sq_pos = p2.RATE  # force a permute before first sample
        self._absorbed = False
        if label is not None:
            # domain-separate by absorbing the label's field-digest
            words = [
                int.from_bytes(label[i : i + 4], "little") % bb.P
                for i in range(0, len(label), 4)
            ]
            self.append(p2.hash_elements_host(words or [0]))

    # -- absorbing ----------------------------------------------------------

    def append(self, elems) -> None:
        """Absorb canonical base-field elements (int, list, or ndarray)."""
        arr = np.atleast_1d(np.asarray(elems, np.uint64))
        for e in arr.ravel():
            if self._pos == p2.RATE:
                self.state = p2.permute_host(self.state)
                self._pos = 0
            self.state[self._pos] = (self.state[self._pos] + e) % bb.P
            self._pos += 1
            self._absorbed = True

    def append_ext(self, ext) -> None:
        """Absorb an ext element given as 4 canonical coefficients."""
        arr = np.asarray(ext, np.uint64)
        assert arr.shape[-1] == 4 or arr.shape[0] == 4
        self.append(arr.ravel())

    # -- sampling -----------------------------------------------------------

    def sample_base(self) -> int:
        if self._absorbed or self._sq_pos == p2.RATE:
            self.state = p2.permute_host(self.state)
            self._pos = 0
            self._sq_pos = 0
            self._absorbed = False
        v = int(self.state[self._sq_pos])
        self._sq_pos += 1
        return v

    def sample_ext(self) -> tuple[int, int, int, int]:
        return tuple(self.sample_base() for _ in range(4))  # type: ignore

    def sample_exts(self, n: int) -> np.ndarray:
        """(n, 4) canonical ext challenges."""
        return np.array([self.sample_ext() for _ in range(n)], np.uint64)

    def sample_ext_pows(self, n: int) -> np.ndarray:
        """Powers alpha^0..alpha^{n-1} of one sampled ext challenge, (n, 4)."""
        a = self.sample_ext()
        out = np.zeros((n, 4), np.uint64)
        if n == 0:
            return out
        out[0, 0] = 1
        for i in range(1, n):
            out[i] = ext4.py_mul(tuple(int(x) for x in out[i - 1]), a)
        return out

    # -- proof-of-work grinding ----------------------------------------------

    def grind(self, pow_bits: int) -> int:
        """Find and absorb a nonce such that the next sampled base element
        falls below ``P >> pow_bits``; consumes the qualifying sample and
        returns the nonce. Raises RuntimeError after
        ``2^(pow_bits + GRIND_SLACK_BITS)`` candidates without a hit."""
        if pow_bits <= 0:
            return 0
        threshold = np.uint64(bb.P >> pow_bits)
        # vectorized candidate search on a simulated (append -> sample) step
        pre = self.state.copy()
        pos = self._pos
        if pos == p2.RATE:
            pre = p2.permute_host(pre)
            pos = 0
        chunk = 4096
        limit = 1 << (pow_bits + GRIND_SLACK_BITS)
        nonce = None
        for base in range(0, limit, chunk):
            lanes = np.tile(pre[:, None], (1, chunk))
            cand = np.arange(base, base + chunk, dtype=np.uint64) % np.uint64(bb.P)
            lanes[pos] = (lanes[pos] + cand) % np.uint64(bb.P)
            out = p2.permute_host(lanes)
            hits = np.nonzero(out[0] < threshold)[0]
            if hits.size:
                nonce = int(cand[int(hits[0])])
                break
        if nonce is None:
            raise RuntimeError(
                f"PoW grind found no nonce in {limit} candidates at "
                f"pow_bits={pow_bits}: the Poseidon2 permutation is broken"
            )
        self.append([nonce])
        got = self.sample_base()
        if got >= int(threshold):
            raise RuntimeError("PoW grind simulation diverged from sponge")
        return nonce

    def check_grind(self, nonce: int, pow_bits: int) -> bool:
        """Verifier side: absorb the claimed nonce, sample, check the bound.
        Replays the identical transcript interaction as :meth:`grind`."""
        if pow_bits <= 0:
            return True
        self.append([int(nonce) % bb.P])
        return self.sample_base() < (bb.P >> pow_bits)

    # -- forking ------------------------------------------------------------

    def fork(self, index: int) -> "Transcript":
        t = self.clone()
        t.append([index % bb.P])
        return t

    def clone(self) -> "Transcript":
        return Transcript.from_state(self.export_state())

    def export_state(self):
        """(state copy, pos, sq_pos, absorbed)."""
        return self.state.copy(), self._pos, self._sq_pos, self._absorbed

    @staticmethod
    def from_state(exported) -> "Transcript":
        """Inverse of :meth:`export_state` (also takes the reference's tuple)."""
        state, pos, sq_pos, absorbed = exported
        t = Transcript()
        t.state = np.asarray(state, np.uint64).copy()
        t._pos = int(pos)
        t._sq_pos = int(sq_pos)
        t._absorbed = bool(absorbed)
        return t
