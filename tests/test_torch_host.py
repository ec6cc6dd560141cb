"""Port parity of the guest I/O modules, ``ceno_tpu_torch/host``: the hints
serializer (``CenoStdin``) and the println reader (``read_all_messages``,
``run``), against ``ceno_tpu/host`` on the items and guests of
``tests/test_stdin.py`` and ``tests/test_messages.py``."""

import numpy as np
import pytest
import torch

from ceno_tpu.host import stdin as rstdin
from ceno_tpu.host import read_all_messages as rread_all_messages
from ceno_tpu.emulator.rv32im import assemble as rassemble
from ceno_tpu.emulator.state import VMState as RVMState, make_program as rmake_program
from ceno_tpu_torch.emulator import native
from ceno_tpu_torch.emulator.rv32im import assemble
from ceno_tpu_torch.emulator.state import Platform, VMState, make_program
from ceno_tpu_torch.host import stdin
from ceno_tpu_torch.host import read_all_messages, run

import chip_smoke
from test_messages import GUEST as PRINTLN_GUEST

torch.set_num_threads(1)
ROM = Platform.rom_start


def _items(mod, rng):
    """Every item kind ``to_item_words`` writes, in ``mod``'s own wrappers,
    with seeded values."""
    u32, u64 = (int(x) for x in rng.integers(0, 1 << 32, size=2, dtype=np.uint64))
    big = int(rng.integers(1 << 32, 1 << 63, dtype=np.uint64)) << 1 | 1
    text = "".join(chr(int(c)) for c in rng.integers(0x20, 0x7F, size=11))
    blob = bytes(int(b) for b in rng.integers(0, 256, size=7))
    return [
        (u32, "u32"), (True, "bool"), (-int(rng.integers(1, 1 << 31)), "u32"),
        (big, "u64"), (mod.U64(u64), "u64"), (mod.I32(-5), "u32"), (mod.I64(-(1 << 40)), "u64"),
        (text, "str"), ("", "str"), (blob, "bytes"), (bytearray(blob[:4]), "bytes"),
        ([u32, 1, 2], ("list", "u32")), ([], ("list", "u32")),
        ((u32, "ab", [3]), ("tuple", ["u32", "str", ("list", "u32")])),
        (mod.Some(7), ("option", "u32")), (mod.NONE, ("option", "u32")),
        ([mod.Some("x"), mod.NONE], ("list", ("option", "str"))),
    ]


def _expected(value, mod):
    """What ``from_words`` gives back for an item written as ``value``."""
    if value is mod.NONE:
        return None
    if isinstance(value, mod.Some):
        return _expected(value.value, mod)
    if isinstance(value, (mod.U64, mod.I32, mod.I64)):
        bits = 32 if isinstance(value, mod.I32) else 64
        return value.value & ((1 << bits) - 1)
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return value & 0xFFFFFFFF if value < 0 else value
    if isinstance(value, bytearray):
        return bytes(value)
    if isinstance(value, list):
        return [_expected(v, mod) for v in value]
    if isinstance(value, tuple):
        return tuple(_expected(v, mod) for v in value)
    return value


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stdin_words_equal_reference_for_every_item_kind(seed):
    port_items = _items(stdin, np.random.default_rng(seed))
    ref_items = _items(rstdin, np.random.default_rng(seed))
    port, ref = stdin.CenoStdin(), rstdin.CenoStdin()
    for (pv, _), (rv, _) in zip(port_items, ref_items):
        assert stdin.to_item_words(pv) == rstdin.to_item_words(rv)
        port.write(pv)
        ref.write(rv)
    assert port.to_words() == ref.to_words()
    assert port.to_bytes() == ref.to_bytes()
    schema = [s for _, s in port_items]
    got = stdin.from_words(port.to_words(), schema)
    assert got == rstdin.from_words(ref.to_words(), schema)
    assert got == [_expected(v, stdin) for v, _ in port_items]


def test_stdin_refuses_what_the_reference_refuses():
    for mod in (stdin, rstdin):
        with pytest.raises(ValueError):
            mod.to_item_words(1 << 64)
        with pytest.raises(TypeError):
            mod.to_item_words(1.5)
        words = mod.CenoStdin().write(1).to_words()
        words[1] = 8
        with pytest.raises(ValueError):
            mod.from_words(words, ["u32"])


def test_header_layout():
    """[data_offset, alignment, byte length of each item], then the items."""
    s = stdin.CenoStdin().write(7).write([1, 2]).write("abcde")
    words = s.to_words()
    assert words[:5] == [5 * 4, 4, 4, 12, 12]
    assert words[5:] == [7, 2, 1, 2, 5, int.from_bytes(b"abcd", "little"), ord("e")]
    assert words == rstdin.CenoStdin().write(7).write([1, 2]).write("abcde").to_words()


HINT_GUEST = f"""
    li t1, {Platform.hints_start}
    lw t2, 0(t1)
    add t2, t2, t1
    lw a1, 0(t2)
    lw a2, 4(t2)
    li t0, 0
    li a0, 0
    ecall
"""


@pytest.mark.parametrize("runner", ["python", "native"])
def test_guest_reads_its_hint(runner):
    """The guest walks the header to the first item (a u64: two words)."""
    value = 0x1234_5678_9ABC_DEF0
    words = stdin.CenoStdin().write(stdin.U64(value)).write(5).to_words()
    vm = VMState(make_program(assemble(HINT_GUEST, ROM), ROM), ROM)
    for i, w in enumerate(words):
        vm.init_memory(Platform.hints_start + 4 * i, w)
    if runner == "native":
        native.run_trace_native(vm)
    else:
        vm.run()
    assert vm.halted
    assert vm.regs[11] | vm.regs[12] << 32 == value


def _println_vms():
    return (VMState(make_program(assemble(PRINTLN_GUEST, ROM), ROM), ROM),
            RVMState(rmake_program(rassemble(PRINTLN_GUEST, ROM), ROM), ROM))


def test_read_all_messages_of_the_println_guest():
    assert chip_smoke.PRINTLN_SRC == PRINTLN_GUEST
    vm, rvm = _println_vms()
    vm.run()
    rvm.run()
    assert read_all_messages(vm) == rread_all_messages(rvm) == chip_smoke.PRINTLN_MESSAGES


def test_run_emulates_and_reads_the_messages():
    vm, _ = _println_vms()
    assert run(vm) == [b"hi!", b"ceno"]
    assert vm.halted and vm.exit_code == 0
    native_vm, _ = _println_vms()
    native.run_trace_native(native_vm)
    assert read_all_messages(native_vm) == [b"hi!", b"ceno"]
