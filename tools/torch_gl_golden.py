#!/usr/bin/env python3
"""Reference digests of the Goldilocks pipeline, for the port's check on the
card.

    JAX_PLATFORMS=cpu python3 tools/torch_gl_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU over ``chip_smoke.py``'s
golden GL inputs: the commit roots of the seeded matrices
``chip_smoke.GL_GOLDEN_COMMITS`` (``ceno_tpu/gl/pcs.commit``), the digest of
the seeded sumcheck ``chip_smoke.gl_golden_sumcheck_inputs``
(``ceno_tpu/gl/sumcheck.prove``), and the digest of the GlChipProof of
``fibonacci_vm(40)``'s add chip at tests/test_gl_pipeline.py's params, its
``rd_idinv`` the GL inverse as that test sets it
(``ceno_tpu/gl/zkvm.prove_chip_gl``). The digests are ``interop.digest`` of
the plain forms (``interop.gl_sumcheck_output_to_dict``,
``interop.gl_chip_proof_digest``). It writes them to
``ceno_tpu_torch/golden/gl_pipeline.json``; with ``--check`` it compares
instead of writing. The card has no JAX, so this file is how
``chip_smoke.gl_golden_check`` holds the port's GL outputs against the
reference's there. About a minute.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gl_pipeline.json")


def reference_values() -> dict:
    """The reference's roots and digests at chip_smoke's golden GL inputs."""
    import chip_smoke as cs
    from ceno_tpu.emulator import native, programs
    from ceno_tpu.fields import gl_host as gl
    from ceno_tpu.gl import pcs, sumcheck, zkvm
    from ceno_tpu.gl.transcript import GlTranscript
    from ceno_tpu.zkvm.chips.opcodes import build_opcode_chips
    from ceno_tpu.zkvm.e2e import public_values_from_vm
    from ceno_tpu.zkvm.tables import ZKVMConfig
    from ceno_tpu.zkvm.witgen import assign_opcode_chips
    from ceno_tpu_torch import interop

    roots = {name: pcs.commit(cols, pcs.GlParams(blowup_log=b)).root.tolist()
             for name, cols, b in cs.gl_golden_commit_inputs()}
    base, ext, terms, n_vars = cs.gl_golden_sumcheck_inputs()
    out = sumcheck.prove(base, ext, terms, n_vars, GlTranscript(b"gl-golden-sc"))
    vm = programs.fibonacci_vm(cs.GL_GOLDEN_ITERS)
    assigned = assign_opcode_chips(native.run_trace(vm), build_opcode_chips())
    add = next(a for a in assigned if a.name == "add")
    wn = add.cb.wit_names
    wit = np.asarray(add.wit, np.uint64).copy()
    wit[wn.index("rd_idinv")] = gl.inv(wit[wn.index("rd_id")])
    pv = public_values_from_vm(vm, ZKVMConfig(**cs.GL_GOLDEN_CFG))
    params = pcs.GlParams(**cs.GL_GOLDEN_PARAMS)
    proof = zkvm.prove_chip_gl(add.compiled, wit, pv, add.num_instances, params)
    zkvm.verify_chip_gl(add.compiled, proof, pv, params)
    return {"commit_roots": roots,
            "sumcheck": interop.digest(interop.gl_sumcheck_output_to_dict(out)),
            "chip": {"rows": add.num_instances, "n_vars": proof.n_vars,
                     "digest": interop.gl_chip_proof_digest(proof)}}


def main() -> int:
    import chip_smoke as cs

    got = {"program": f"fibonacci_vm({cs.GL_GOLDEN_ITERS})", "params": cs.GL_GOLDEN_PARAMS,
           **reference_values()}
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
