#!/usr/bin/env python3
"""Reference digests of the Goldilocks zkVM scheme, for the port's check on
the card.

    JAX_PLATFORMS=cpu python3 tools/torch_gl_scheme_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU at ``chip_smoke.py``'s golden
GL scheme setup, ``fibonacci_vm(8)`` at ``ZKVMConfig(shl_x_bits=6,
mem_words_log=7)`` and the small ``GlParams`` of
tests/test_gl_continuation.py:154, in two processes at once:

- ``standalone``: ``ceno_tpu/gl/scheme.prove_gl`` of the whole trace as one
  shard (tests/test_gl_scheme.py's setup): its ``interop.gl_zkvm_proof_digest``
  and ``num_instances``, and the ``interop.gl_vk_summary`` of ``keygen_gl``;
- ``shards``: ``ceno_tpu/gl/shard.prove_shards_gl`` of the trace as two
  shards (tests/test_gl_continuation.py:138's setup): each shard's digest and
  public values.

Each proof is verified by the reference before it is written. It writes
``ceno_tpu_torch/golden/gl_scheme.json``; with ``--check`` it compares
instead of writing. The card has no JAX, so this file is how
``chip_smoke.gl_scheme_golden_check`` holds the port's GL scheme proofs
against the reference's there. About 10 minutes (the two-shard prove).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the reference's host paths, as tests/conftest.py pins them (the BabyBear keygen)
os.environ.setdefault("CENO_TPU_HOST_N", str(1 << 17))

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gl_scheme.json")


def _setup():
    import chip_smoke as cs
    from ceno_tpu.emulator import programs
    from ceno_tpu.gl.pcs import GlParams
    from ceno_tpu.zkvm.scheme import keygen
    from ceno_tpu.zkvm.tables import ZKVMConfig

    cfg = ZKVMConfig(**cs.GL_SCHEME_GOLDEN_CFG)
    vm = programs.fibonacci_vm(cs.GL_SCHEME_GOLDEN_ITERS)
    records = vm.run()
    return cs, cfg, vm, records, keygen(vm.program, cfg), GlParams(**cs.GL_SCHEME_GOLDEN_PARAMS)


def standalone_values() -> dict:
    """The reference's standalone GL shard proof: digest, instance counts and
    the GL key's summary."""
    import numpy as np
    from ceno_tpu.gl import scheme as gls
    from ceno_tpu.zkvm.e2e import public_values_from_vm
    from ceno_tpu_torch import interop

    _, cfg, vm, records, pk, params = _setup()
    pv = public_values_from_vm(vm, cfg)
    proof = gls.prove_gl(pk, vm, records, pv, params=params)
    vk = gls.keygen_gl(pk)
    gls.verify_gl(vk, proof, params=params)
    return {"steps": len(records), "digest": interop.gl_zkvm_proof_digest(proof),
            "num_instances": [int(k) for k in proof.num_instances],
            "public_values": np.asarray(proof.public_values, np.uint64).tolist(),
            "vk": interop.gl_vk_summary(vk)}


def shards_values() -> dict:
    """The reference's two-shard GL proof: each shard's digest and public
    values."""
    import numpy as np
    from ceno_tpu.gl import scheme as gls
    from ceno_tpu.gl.shard import prove_shards_gl, verify_shards_gl
    from ceno_tpu_torch import interop

    cs, _, vm, records, pk, params = _setup()
    steps = cs.gl_golden_shard_steps(len(records))
    sp = prove_shards_gl(pk, vm, records, max_steps_per_shard=steps, params=params)
    verify_shards_gl(gls.keygen_gl(pk), sp, params=params)
    return {"max_steps_per_shard": steps,
            "shards": [{"digest": interop.gl_zkvm_proof_digest(p),
                        "num_instances": [int(k) for k in p.num_instances],
                        "public_values": np.asarray(p.public_values, np.uint64).tolist()}
                       for p in sp.proofs]}


def _part(name: str) -> dict:
    return {"standalone": standalone_values, "shards": shards_values}[name]()


def reference_values() -> dict:
    """Both parts, each in a process of its own."""
    import chip_smoke as cs

    with ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn")) as ex:
        standalone, shards = ex.map(_part, ["standalone", "shards"])
    return {"program": f"fibonacci_vm({cs.GL_SCHEME_GOLDEN_ITERS})",
            "cfg": cs.GL_SCHEME_GOLDEN_CFG, "params": cs.GL_SCHEME_GOLDEN_PARAMS,
            "standalone": standalone, "two_shards": shards}


def main() -> int:
    got = reference_values()
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
