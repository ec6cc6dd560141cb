#!/usr/bin/env python3
"""Reference digests of the GKR slice, for the port's check on the card.

    JAX_PLATFORMS=cpu python3 tools/torch_gkr_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU over ``fibonacci_vm(100)``
through the GKR stages of ``zkvm/scheme.prove`` as ``chip_smoke.py``'s GKR
phase drives the port: the opcode chips' witness, the public values the
opcode chips read, the transcript (label, public values, two RLC
challenges), records per chip, one tower per tower size and one main
zerocheck per height class. It writes the SHA-256 digests of each group's
TowerProof, each class's ClassMainProof and the final transcript state
(``chip_smoke.gkr_digests``: ``interop.digest`` of their plain forms) to
``ceno_tpu_torch/golden/gkr_fibonacci.json``; with ``--check`` it compares
instead of writing. The card has no JAX, so these digests are how
``chip_smoke.py`` holds the port's proofs against the reference's there.
"""

from __future__ import annotations

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

GOLDEN_ITERS = 100
OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gkr_fibonacci.json")


def reference_run(n: int) -> dict:
    """The reference's proofs at fibonacci_vm(n) and what led to them: towers
    per N_t, class mains and openings per height, the final transcript, the
    public values, challenges, assigned chips, tower inputs and contexts."""
    from ceno_tpu.emulator import native, programs
    from ceno_tpu.emulator.state import CYCLE_START
    from ceno_tpu.gkr import chip as rchip
    from ceno_tpu.hash.transcript import Transcript
    from ceno_tpu.zkvm import layout
    from ceno_tpu.zkvm.chips.opcodes import build_opcode_chips
    from ceno_tpu.zkvm.scheme import LABEL
    from ceno_tpu.zkvm.witgen import assign_opcode_chips

    vm = programs.fibonacci_vm(n)
    assigned = assign_opcode_chips(native.run_trace(vm), build_opcode_chips())
    pv = np.zeros(layout.N_PUBLIC_VALUES, np.uint64)
    pv[layout.PV_INIT_PC] = vm.entry
    pv[layout.PV_INIT_CYCLE] = CYCLE_START
    pv[layout.PV_END_PC] = vm.pc
    pv[layout.PV_END_CYCLE] = vm.cycle
    pv[layout.PV_EXIT_CODE_LO] = vm.exit_code & 0xFFFF
    pv[layout.PV_EXIT_CODE_HI] = (vm.exit_code >> 16) & 0xFFFF
    t = Transcript(LABEL)
    t.append(pv)
    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)
    active = [a for a in assigned if a.num_instances > 0]
    inputs = {
        a.name: rchip.build_tower_inputs(
            a.compiled, a.wit, np.zeros((0, a.n_rows), np.uint64),
            np.zeros((0, a.n_rows), np.uint64), pv, a.num_instances, challenges)
        for a in active
    }
    groups, towers, ctxs = {}, {}, {}
    for a in active:
        groups.setdefault(inputs[a.name].n_tower, []).append(a.name)
    for n_t in sorted(groups):
        towers[n_t], gctxs = rchip.prove_group_towers([inputs[nm] for nm in groups[n_t]], t)
        ctxs.update(zip(groups[n_t], gctxs))
    classes, mains, openings = {}, {}, {}
    for a in active:
        classes.setdefault(a.n_rows, []).append(a.name)
    for h in sorted(classes):
        mains[h], openings[h] = rchip.prove_class_main(
            [ctxs[nm] for nm in classes[h]], pv, challenges, t)
    return dict(towers=towers, mains=mains, openings=openings, groups=groups,
                classes=classes, transcript=t, pv=pv, assigned=assigned,
                challenges=challenges, inputs=inputs, ctxs=ctxs)


def main() -> int:
    from chip_smoke import gkr_digests

    got = {"program": f"fibonacci_vm({GOLDEN_ITERS})",
           "digests": gkr_digests(reference_run(GOLDEN_ITERS))}
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
