"""Witgen field context: the proving field used by ASSIGN-TIME arithmetic.

Compiled circuits are field-generic (the Expression AST carries integer
coefficients and eval-time negation), but witness GENERATION computes a few
field-dependent column values: modular inverses (is-zero gadgets) and
wraparound encodings of negative differences / immediates. Those sites read
``P`` from here instead of hard-coding BabyBear, so `--field goldilocks`
witgen (gl/scheme.py) produces GL-correct columns by switching the context.

Default: BabyBear. ``use(p)`` is a context manager that swaps the modulus
for the duration of one generate_witness call. NOT thread-safe (witgen is
single-threaded; the P4 pipeline forks witgen into its own worker which
inherits the value at call time).

Copy of ``ceno_tpu/zkvm/chips/field_ctx.py``: the port keeps its own, with the same
relative imports.
"""

from contextlib import contextmanager

import numpy as np

from ...fields import babybear as bb

P = int(bb.P)
INV = None   # vectorized batch-inverse override for non-BabyBear fields


def enc_signed(v) -> np.ndarray:
    """Field-encode SMALL signed integers (|v| < P) without int64-modulus
    overflow (GL P exceeds int64): negatives map to P + v. Inputs >= P are
    rejected rather than silently left non-canonical (callers pass
    immediates / 16-bit limb differences; a full 32-bit quantity under
    BabyBear would need an explicit reduction at the call site)."""
    a = np.asarray(v, np.int64)
    assert np.all(np.abs(a) < P), "enc_signed input magnitude >= field modulus"
    return np.where(a < 0, np.uint64(P) + a.astype(np.uint64),
                    a.astype(np.uint64))


@contextmanager
def use(p: int, inv=None):
    """``inv``: vectorized canonical-inverse fn (0 -> anything; callers
    mask zeros) — REQUIRED for fields whose products overflow uint64 in
    the BabyBear fast path (e.g. Goldilocks)."""
    global P, INV
    old, old_inv = P, INV
    P, INV = int(p), inv
    try:
        yield
    finally:
        P, INV = old, old_inv
