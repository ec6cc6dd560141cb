"""Structure-only verifier replay mode (aggregation key reconstruction).

The aggregation trust anchor (zkvm/aggregate.py::expected_agg_key) rebuilds
the verifier-circuit chip set from (vk, params, proof GEOMETRY) alone: it
runs the REAL shard verifier over a synthesized proof skeleton whose values
are random, so every transcript interaction, capture record and chip/fixed
schedule comes out exactly as for a real proof of that geometry — but the
value-equality checks would all fail. Inside ``structure_only()`` those
checks are suppressed; geometry/shape checks stay live (a shape mismatch in
replay is a skeleton bug, not an expected event).

This is a *verifier-side* mode: nothing in the proving path reads it, and
the default is off, so normal verification is unaffected.

Copy of ``ceno_tpu/utils/replay.py``. The flag is thread-local, so a
structure replay on one thread leaves a verifier on another (the sharded
prover's witgen thread, say) checking.
"""

from __future__ import annotations

import contextlib
import threading

_STATE = threading.local()


def structure_only() -> bool:
    return getattr(_STATE, "on", False)


def check(cond, msg: str = "") -> None:
    """assert ``cond`` unless in structure replay (witgen-mirror re-verify
    sanity checks: they hold for real proofs, not for skeletons)."""
    if not structure_only():
        assert cond, msg


@contextlib.contextmanager
def structure_replay():
    prev = getattr(_STATE, "on", False)
    _STATE.on = True
    try:
        yield
    finally:
        _STATE.on = prev
