"""Goldilocks proving pipeline (`--field goldilocks`).

Counterpart of ``ceno_tpu/gl/``: the Poseidon2-GL transcript, the batched
sumcheck and the Basefold PCS over GoldilocksExt2, and the single-chip
prover and verifier (gl/zkvm.py). The commit runs the hand-written kernels
K14a-c (gl/device.py over csrc/gl_commit.cu); the rounds, towers and records
run in plain torch on the tensors' device; the verifiers are host numpy.
The multi-chip GL scheme and its continuations (the reference's
gl/{scheme,gadget,shard_chips,eccquark,shard}.py) are not ported yet.
"""

from . import poseidon2  # noqa: F401
from . import transcript  # noqa: F401
from . import sumcheck  # noqa: F401
from . import pcs  # noqa: F401
