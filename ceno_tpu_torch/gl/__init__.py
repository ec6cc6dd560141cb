"""Goldilocks proving pipeline (`--field goldilocks`).

Counterpart of ``ceno_tpu/gl/``: the Poseidon2-GL transcript, the batched
sumcheck and the Basefold PCS over GoldilocksExt2, and the single-chip
prover and verifier (gl/zkvm.py), the multi-chip zkVM scheme over the full
chip set (gl/scheme.py: ``keygen_gl``, ``prove_gl``, ``verify_gl``) and its
continuations on the quintic multiset-hash curve (gl/shard.py over
gl/shard_chips.py, gl/gadget.py, gl/eccquark.py and fields/gl5_host.py).
The commit runs the hand-written kernels K14a-c (gl/device.py over
csrc/gl_commit.cu); the rounds, towers, records and the EC-sum quark run in
plain torch on the tensors' device; the witgen, the transcript and the
verifiers are host numpy.
"""

from . import poseidon2  # noqa: F401
from . import transcript  # noqa: F401
from . import sumcheck  # noqa: F401
from . import pcs  # noqa: F401
