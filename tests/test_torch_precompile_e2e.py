"""Port parity of whole proofs of the precompile and guest-I/O guests: the
port's ``proof_to_bytes`` (``run_e2e``, ``device="cpu"``) equals the
reference's byte for byte at the reference tests' config and params, each
verifier accepts the other's proof (read through its own decoder), and both
equal the ``fast`` entries of ``ceno_tpu_torch/golden/precompile_guests.json``,
which ``chip_smoke.py`` holds the card's ``BasefoldParams()`` proofs against.

Guests (``chip_smoke.precompile_guest``): ``examples/precompile_torture.s``
(keccak-f, SHA extend, uint256 mul and PUB_IO_COMMIT chained),
``examples/hashing.s`` with a hints buffer written by the port's ``CenoStdin``
(its committed digest is keccak-f of the hinted state) and
``tests/test_messages.py``'s println guest (its messages read back with the
port's ``read_all_messages``). ``tests/test_torch_curves_e2e.py`` holds the
secp guest. Each case runs the reference and the port once, one to two
minutes on one CPU thread."""

import dataclasses
import json

import pytest
import torch

from ceno_tpu.emulator.rv32im import assemble as rassemble
from ceno_tpu.emulator.state import VMState as RVMState, make_program as rmake_program
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu_torch.emulator.state import Platform
from ceno_tpu_torch.host import read_all_messages
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import e2e, layout, scheme, serialize
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)
ROM = Platform.rom_start


def golden() -> dict:
    with open(chip_smoke.PRECOMPILE_GOLDEN) as f:
        return json.load(f)


def proof_parity(guest: str):
    """Prove ``guest`` with both packages at the fast params; check the bytes
    against each other and the golden file, and cross-verify. Returns the
    port's vm, E2EResult and the first rounds of its sumchecks."""
    src, hints, _ = chip_smoke.precompile_guest(guest)
    vm = chip_smoke.guest_vm(src, hints)
    rvm = RVMState(rmake_program(rassemble(src, ROM), ROM), ROM)
    for i, w in enumerate(hints):
        rvm.init_memory(Platform.hints_start + 4 * i, w)
    cfg, fast = chip_smoke.PRECOMPILE_CFG, chip_smoke.FAST_PARAMS
    ref = re2e.run_e2e(rvm, RConfig(**cfg), RParams(**fast))
    with chip_smoke.sumcheck_calls() as calls:
        port = e2e.run_e2e(vm, ZKVMConfig(**cfg), BasefoldParams(**fast), device="cpu")
        shapes = chip_smoke.first_rounds(calls)
    rbytes = rserialize.proof_to_bytes(ref.proof, ref.public_values, ref.pk.cfg, ref.pk.params)
    pbytes = serialize.proof_to_bytes(port.proof, port.public_values, port.pk.cfg, port.pk.params)
    assert pbytes == rbytes
    want = golden()["guests"][guest]
    assert chip_smoke.program_digest(vm) == chip_smoke.program_digest(rvm) == \
        want["program_sha256"]
    assert port.n_steps == ref.n_steps == want["steps"]
    assert chip_smoke.proof_digests(pbytes, port.pk) == want["fast"]
    assert scheme.verify(port.pk.vk, serialize.proof_from_bytes(rbytes)[0]) is True
    assert rscheme.verify(ref.pk.vk, rserialize.proof_from_bytes(pbytes)[0]) is True
    return vm, port, shapes


def test_golden_file_names_chip_smokes_setup():
    """The file's setup is chip_smoke's: config, both params, the guests and
    their programs (the card checks the ``default`` entries' bytes)."""
    want = golden()
    assert want["cfg"] == chip_smoke.PRECOMPILE_CFG
    assert want["params"] == {
        "fast": dataclasses.asdict(BasefoldParams(**chip_smoke.FAST_PARAMS)),
        "default": dataclasses.asdict(BasefoldParams())}
    assert tuple(want["guests"]) == chip_smoke.PRECOMPILE_GUESTS
    for name, entry in want["guests"].items():
        vm = chip_smoke.guest_vm(*chip_smoke.precompile_guest(name)[:2])
        assert chip_smoke.program_digest(vm) == entry["program_sha256"]
        for key in ("fast", "default"):
            assert set(entry[key]) == {"proof_sha256", "proof_bytes", "vk_digest_sha256"}
        assert entry["default"]["proof_bytes"] > entry["fast"]["proof_bytes"]


@pytest.mark.parametrize("guest", ["precompile_torture", "hashing", "println"])
def test_proof_bytes_equal_golden_and_cross_verified(guest):
    vm, port, _ = proof_parity(guest)
    pv = port.public_values
    chip_smoke.guest_output_check(guest, vm, pv)
    if guest == "println":
        assert read_all_messages(vm) == chip_smoke.PRINTLN_MESSAGES
        assert int(pv[layout.PV_INFO_WORDS]) == 4
    else:
        active = {m.name for m, k in zip(port.pk.metas, port.proof.num_instances) if k}
        assert {"keccak_ecall", "keccak_core", "pubio_commit"} <= active
        if guest == "precompile_torture":
            assert {"sha_extend", "uint256_mul"} <= active
