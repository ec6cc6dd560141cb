#!/usr/bin/env python3
"""Reference digests of WHIR openings and proofs, for the port's check on the
card.

    JAX_PLATFORMS=cpu python3 tools/torch_whir_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU at ``chip_smoke.py``'s
golden WHIR setups: ``open_whir`` of tests/test_whir.py's seeded case
(``chip_smoke.WHIR_OPEN_CASE``, the first draw of its RNG; the digest is
``interop.digest`` of the proof's plain form, and the transcript's end state
is kept), and ``run_e2e`` of each of ``chip_smoke.WHIR_GOLDEN_PROOFS``
(``fibonacci_vm(8)`` at tests/test_whir.py::test_whir_zkvm_e2e's params,
``fibonacci_vm(100)`` at ``BasefoldParams(pcs_kind="whir")``): the SHA-256
and length of ``proof_to_bytes`` and the SHA-256 of the key's
``digest_elems()``. It writes them to
``ceno_tpu_torch/golden/whir_fibonacci.json``; with ``--check`` it compares
instead of writing. The card has no JAX, so this file is how
``chip_smoke.whir_golden_check`` holds the port's WHIR against the
reference's there. About 2.5 minutes on a 4-core host (the defaults proof
about 100 s of it).
"""

from __future__ import annotations

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

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "whir_fibonacci.json")


def reference_open_whir() -> dict:
    """The reference's ``open_whir`` of WHIR_OPEN_CASE: its setup, proof
    digest and transcript end state."""
    import chip_smoke as cs
    from ceno_tpu.hash.transcript import Transcript
    from ceno_tpu.pcs import basefold, whir
    from ceno_tpu_torch import interop

    c = cs.WHIR_OPEN_CASE
    cols, z, values = cs.whir_open_inputs()
    committed = basefold.commit(cols, basefold.BasefoldParams(blowup_log=c["blowup_log"]))
    tr = Transcript(c["label"].encode())
    proof = whir.open_whir(committed, z, values, tr, c["blowup_log"],
                           whir.WhirParams(**c["params"]))
    return {"setup": c, "proof_digest": interop.digest(interop.whir_proof_to_dict(proof)),
            "transcript": cs.transcript_state(tr)}


def reference_proof(setup: dict) -> dict:
    """The reference's proof of one of WHIR_GOLDEN_PROOFS: setup and digests."""
    import chip_smoke as cs
    from ceno_tpu.emulator import programs
    from ceno_tpu.pcs.basefold import BasefoldParams
    from ceno_tpu.zkvm.e2e import run_e2e
    from ceno_tpu.zkvm.serialize import proof_to_bytes
    from ceno_tpu.zkvm.tables import ZKVMConfig

    res = run_e2e(programs.fibonacci_vm(setup["iters"]), ZKVMConfig(**setup["cfg"]),
                  BasefoldParams(**setup["params"]))
    data = proof_to_bytes(res.proof, res.public_values, res.pk.cfg, res.pk.params)
    elems = np.ascontiguousarray(res.pk.vk.digest_elems(), np.uint64)
    return {"setup": cs.whir_setup(setup), "proof_sha256": hashlib.sha256(data).hexdigest(),
            "proof_bytes": len(data), "vk_digest_sha256": hashlib.sha256(elems.tobytes()).hexdigest()}


def reference_golden() -> dict:
    import chip_smoke as cs

    out = {"open_whir": reference_open_whir()}
    for name, setup in cs.WHIR_GOLDEN_PROOFS.items():
        out[name] = reference_proof(setup)
    return out


def main() -> int:
    got = json.loads(json.dumps(reference_golden()))
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
