#!/usr/bin/env python3
"""Reference digests of a sharded zkVM proof, for the port's check on the card.

    JAX_PLATFORMS=cpu python3 tools/torch_shard_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU at ``tests/test_shard.py``'s
setup: ``fibonacci_vm(12)``, ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``,
``BasefoldParams(blowup_log=1, n_queries=4, stop_size=32)`` and at most 40
steps a shard, proved by ``prove_shards`` (about 90 s on a 4-core host). It
writes the setup, the shard count, and the SHA-256 and length of each
shard's ``proof_to_bytes`` to ``ceno_tpu_torch/golden/shard_fibonacci.json``;
with ``--check`` it compares instead of writing. The card has no JAX, so
``chip_smoke.py`` holds the port's sharded proof of the same setup against
these bytes there.
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

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "shard_fibonacci.json")
ITERS = 12
CFG = {"shl_x_bits": 6, "mem_words_log": 7}
PARAMS = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}
MAX_STEPS_PER_SHARD = 40


def setup() -> dict:
    """The setup the golden proof is made at, as the file names it."""
    return {"program": f"fibonacci_vm({ITERS})", "cfg": CFG, "params": PARAMS,
            "max_steps_per_shard": MAX_STEPS_PER_SHARD}


def shard_digests(blobs: list) -> dict:
    """The shard count and each shard's proof bytes' SHA-256 and length."""
    return {"n_shards": len(blobs),
            "shards": [{"proof_sha256": hashlib.sha256(b).hexdigest(), "proof_bytes": len(b)}
                       for b in blobs]}


def reference_blobs() -> list:
    """Each shard's ``proof_to_bytes`` from the reference's ``prove_shards``."""
    from ceno_tpu.emulator import programs
    from ceno_tpu.pcs.basefold import BasefoldParams
    from ceno_tpu.zkvm.scheme import keygen
    from ceno_tpu.zkvm.serialize import proof_to_bytes
    from ceno_tpu.zkvm.shard import prove_shards
    from ceno_tpu.zkvm.tables import ZKVMConfig

    vm = programs.fibonacci_vm(ITERS)
    records = vm.run()
    pk = keygen(vm.program, ZKVMConfig(**CFG), BasefoldParams(**PARAMS))
    sproof = prove_shards(pk, vm, records, MAX_STEPS_PER_SHARD)
    return [proof_to_bytes(p, p.public_values, pk.cfg, pk.params) for p in sproof.proofs]


def main() -> int:
    got = {**setup(), **shard_digests(reference_blobs())}
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
