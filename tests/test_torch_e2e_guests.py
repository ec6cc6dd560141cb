"""Port parity of whole proofs of the guests and modes that
``tests/test_zkvm_e2e.py`` and ``tests/test_prog_data.py`` prove: the port's
``proof_to_bytes`` (``device="cpu"``) equals the reference's byte for byte,
and each verifier accepts the other's proof, read through its own decoder.

Cases: the memsum guest (loads, stores and the RAM tables), the hinted
fibonacci (hint reads), the per-class PCS mode (``jagged=False``: one
commitment and one opening per height class) and an ELF guest whose static
data reaches keygen and witgen through ``data_image``. Each case runs the
reference and the port once, about a minute on one CPU thread."""

import pytest
import torch

from ceno_tpu.emulator import elf as relf
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu_torch.emulator import elf, programs
from ceno_tpu_torch.emulator.rv32im import assemble
from ceno_tpu_torch.emulator.state import Platform
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import e2e, scheme, serialize
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

torch.set_num_threads(1)
CFG = dict(shl_x_bits=6, mem_words_log=7)
FAST = dict(blowup_log=1, n_queries=4, stop_size=32)

ROM = 0x0800_0000
DATA = 0x0900_0000
# tests/test_prog_data.py's guest: sums 4 .rodata words, stores the sum into
# .data scratch, reads it back
PROG_DATA_SRC = f"""
    li t1, {DATA}
    lw a0, 0(t1)
    lw t2, 4(t1)
    add a0, a0, t2
    lw t2, 8(t1)
    add a0, a0, t2
    lw t2, 12(t1)
    add a0, a0, t2
    sw a0, 16(t1)
    lw a1, 16(t1)
    li t0, 0
    ecall
"""


def _prog_data_guest(elf_mod):
    """(vm, data_image) of the program-data guest, loaded from its ELF."""
    blob = elf_mod.write_elf(
        assemble(PROG_DATA_SRC, ROM), ROM,
        data={DATA + 4 * i: v for i, v in enumerate([3, 5, 7, 11, 0])},
        sheap=Platform.heap_start, bss_words=2)
    return elf_mod.load_elf_vm(blob), elf_mod.load_elf(blob).data_image()


GUESTS = {
    "memsum": lambda progs, _: (progs.memsum_vm(5), None),
    "hinted": lambda progs, _: (progs.fibonacci_hinted_vm(9), None),
    "fibonacci": lambda progs, _: (progs.fibonacci_vm(8), None),
    "prog_data": lambda _, elf_mod: _prog_data_guest(elf_mod),
}


@pytest.mark.parametrize("guest, params, n_bytes", [
    ("memsum", FAST, 129143),
    ("hinted", FAST, 128173),
    ("fibonacci", dict(FAST, jagged=False), 210622),
    ("prog_data", FAST, 125371),
], ids=["memsum", "hinted", "class_pcs", "prog_data"])
def test_proof_bytes_equal_and_cross_verified(guest, params, n_bytes):
    rvm, rimage = GUESTS[guest](rprograms, relf)
    pvm, pimage = GUESTS[guest](programs, elf)
    assert pimage == rimage
    ref = re2e.run_e2e(rvm, RConfig(**CFG), RParams(**params), data_image=rimage)
    port = e2e.run_e2e(pvm, ZKVMConfig(**CFG), BasefoldParams(**params),
                       data_image=pimage, device="cpu")
    rbytes = rserialize.proof_to_bytes(ref.proof, ref.public_values, ref.pk.cfg, ref.pk.params)
    pbytes = serialize.proof_to_bytes(port.proof, port.public_values, port.pk.cfg, port.pk.params)
    assert len(rbytes) == n_bytes
    assert pbytes == rbytes
    assert scheme.verify(port.pk.vk, serialize.proof_from_bytes(rbytes)[0]) is True
    assert rscheme.verify(ref.pk.vk, rserialize.proof_from_bytes(pbytes)[0]) is True
