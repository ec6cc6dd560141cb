#!/usr/bin/env python3
"""Reference digests of a whole zkVM proof, for the port's check on the card.

    JAX_PLATFORMS=cpu python3 tools/torch_e2e_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU: ``run_e2e`` of
``fibonacci_vm(100)`` with ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)`` and
the default ``BasefoldParams()`` (jagged PCS, blowup 8, 29 queries, 16 PoW
bits), about 80 s on a 4-core host. It writes the setup, the SHA-256 and
length of the proof's ``proof_to_bytes`` and the SHA-256 of the verifying
key's ``digest_elems()`` to ``ceno_tpu_torch/golden/e2e_fibonacci.json``;
with ``--check`` it compares instead of writing. The card has no JAX, so
``chip_smoke.py`` holds the port's proof of the same setup against these
bytes there.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the reference's host paths at these sizes, as tests/conftest.py pins them;
# its device paths give the same bytes
os.environ.setdefault("CENO_TPU_HOST_N", str(1 << 17))

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "e2e_fibonacci.json")
ITERS = 100
CFG = {"shl_x_bits": 6, "mem_words_log": 7}


def setup() -> dict:
    """The setup the golden proof is made at, as the file names it."""
    from ceno_tpu.pcs.basefold import BasefoldParams

    return {"program": f"fibonacci_vm({ITERS})", "cfg": CFG,
            "params": dataclasses.asdict(BasefoldParams())}


def proof_digests(proof_bytes: bytes, digest_elems: np.ndarray) -> dict:
    return {"proof_sha256": hashlib.sha256(proof_bytes).hexdigest(),
            "proof_bytes": len(proof_bytes),
            "vk_digest_sha256": hashlib.sha256(
                np.ascontiguousarray(digest_elems, np.uint64).tobytes()).hexdigest()}


def reference_golden() -> dict:
    from ceno_tpu.emulator import programs
    from ceno_tpu.pcs.basefold import BasefoldParams
    from ceno_tpu.zkvm.e2e import run_e2e
    from ceno_tpu.zkvm.serialize import proof_to_bytes
    from ceno_tpu.zkvm.tables import ZKVMConfig

    res = run_e2e(programs.fibonacci_vm(ITERS), ZKVMConfig(**CFG), BasefoldParams())
    data = proof_to_bytes(res.proof, res.public_values, res.pk.cfg, res.pk.params)
    return {**setup(), **proof_digests(data, res.pk.vk.digest_elems())}


def main() -> int:
    got = reference_golden()
    if "--check" in sys.argv[1:]:
        with open(OUT) as f:
            want = json.load(f)
        print("equal" if want == got else f"differ: {got} against {want}")
        return 0 if want == got else 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(got, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.relpath(OUT, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
