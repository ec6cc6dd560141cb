#!/usr/bin/env python3
"""Reference digests of the precompile and guest-I/O proofs, for the port's
check on the card.

    JAX_PLATFORMS=cpu python3 tools/torch_precompile_golden.py [--check]

Runs the JAX reference (``ceno_tpu``) on the CPU: ``run_e2e`` of each guest
of ``chip_smoke.PRECOMPILE_GUESTS`` (``examples/precompile_torture.s``,
``examples/hashing.s`` with its hints written by the port's ``CenoStdin``,
``tests/test_curves.py``'s secp guest and ``tests/test_messages.py``'s
println guest, as ``chip_smoke.precompile_guest`` gives them) at
``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``, once at the reference tests'
params (``fast``: blowup 2, 4 queries, stop size 32) and once at the default
``BasefoldParams()`` (``default``), about 10 minutes on a 4-core host. It
writes the setup, each guest's program digest and step count, and each
proof's SHA-256 and length and the verifying key's digest to
``ceno_tpu_torch/golden/precompile_guests.json``; with ``--check`` it
compares instead of writing. The card has no JAX, so ``chip_smoke.py``
holds the port's ``default`` proofs against these bytes there; the Tier-1
tests hold the ``fast`` ones, proving each guest with both packages.
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

import chip_smoke  # noqa: E402

OUT = chip_smoke.PRECOMPILE_GOLDEN


def setup() -> dict:
    """The setup the golden proofs are made at, as the file names it."""
    from ceno_tpu.pcs.basefold import BasefoldParams

    return {"cfg": chip_smoke.PRECOMPILE_CFG,
            "params": {"fast": dataclasses.asdict(BasefoldParams(**chip_smoke.FAST_PARAMS)),
                       "default": dataclasses.asdict(BasefoldParams())}}


def proof_digests(proof_bytes: bytes, digest_elems: np.ndarray) -> dict:
    return {"proof_sha256": hashlib.sha256(proof_bytes).hexdigest(),
            "proof_bytes": len(proof_bytes),
            "vk_digest_sha256": hashlib.sha256(
                np.ascontiguousarray(digest_elems, np.uint64).tobytes()).hexdigest()}


def reference_vm(name: str):
    """The guest's VM built with the reference's assembler and VM."""
    from ceno_tpu.emulator.rv32im import assemble
    from ceno_tpu.emulator.state import Platform, VMState, make_program

    src, hints, _ = chip_smoke.precompile_guest(name)
    vm = VMState(make_program(assemble(src, Platform.rom_start), Platform.rom_start),
                 Platform.rom_start)
    for i, w in enumerate(hints):
        vm.init_memory(Platform.hints_start + 4 * i, w)
    return vm


def reference_proof(name: str, params) -> tuple:
    """(vm, the E2EResult, proof bytes) of the reference's ``run_e2e``."""
    from ceno_tpu.zkvm.e2e import run_e2e
    from ceno_tpu.zkvm.serialize import proof_to_bytes
    from ceno_tpu.zkvm.tables import ZKVMConfig

    vm = reference_vm(name)
    res = run_e2e(vm, ZKVMConfig(**chip_smoke.PRECOMPILE_CFG), params)
    return vm, res, proof_to_bytes(res.proof, res.public_values, res.pk.cfg, res.pk.params)


def reference_golden() -> dict:
    from ceno_tpu.pcs.basefold import BasefoldParams

    guests = {}
    for name in chip_smoke.PRECOMPILE_GUESTS:
        entry = {"program_sha256": chip_smoke.program_digest(reference_vm(name))}
        for key, params in (("fast", BasefoldParams(**chip_smoke.FAST_PARAMS)),
                            ("default", BasefoldParams())):
            _, res, data = reference_proof(name, params)
            entry["steps"] = res.n_steps
            entry[key] = proof_digests(data, res.pk.vk.digest_elems())
            print(f"{name} ({key}): {entry[key]['proof_bytes']} bytes", flush=True)
        guests[name] = entry
    return {**setup(), "guests": guests}


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
