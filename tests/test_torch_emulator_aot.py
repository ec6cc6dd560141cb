"""Port parity: the AOT preflight backend (``emulator/aotgen.py`` and
``emulator/native.run_preflight``), mirroring ``tests/test_emulator_aot.py``.

The preflight runs the guest through its basic blocks compiled to native
code, without step rows. Against the port's tracing core it must give the
same final machine state and per-kind step counts, and the same shard
boundaries as ``zkvm/shard.plan_boundaries`` over the trace, which must in
turn equal the reference's ``plan_boundaries`` over the reference's trace.
The per-program libraries are built into ``ceno_tpu_torch/_build/aot/``.
"""

import numpy as np
import pytest

from ceno_tpu.emulator import native as rnative
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.zkvm.chips import build_all_chips as rbuild_all_chips
from ceno_tpu.zkvm.shard import plan_boundaries as rplan_boundaries
from ceno_tpu_torch.emulator import aotgen, native, programs, rv32im
from ceno_tpu_torch.emulator.rv32im import KINDS
from ceno_tpu_torch.emulator.state import Platform, VMState, make_program
from ceno_tpu_torch.zkvm.chips import build_all_chips
from ceno_tpu_torch.zkvm.shard import _cost_by_kind, plan_boundaries, plan_boundaries_preflight

pytestmark = pytest.mark.skipif(not native.native_available(), reason="no C++ toolchain")

PLANS = [{"max_cells_per_shard": 20_000}, {"max_steps_per_shard": 700},
         {"max_cells_per_shard": 50_000, "max_steps_per_shard": 450}]


def _counts_of(view):
    return np.bincount(np.asarray(view.kind, np.int64), minlength=len(KINDS))


def _assert_equivalent(make_vm, **plan_kwargs):
    vm = make_vm()
    bounds, counts, steps, state = native.run_preflight(vm, **plan_kwargs)
    vm2 = make_vm()
    view = native.run_trace(vm2)
    assert steps == view.n
    assert state["halted"] and vm2.halted
    assert state["pc"] == vm2.pc
    assert state["cycle"] == vm2.cycle
    assert state["exit_code"] == vm2.exit_code
    np.testing.assert_array_equal(state["regs"], np.asarray(vm2.regs, np.uint32))
    np.testing.assert_array_equal(counts, _counts_of(view))
    return view


@pytest.fixture(scope="module")
def fib500():
    chips = build_all_chips()
    view = _assert_equivalent(lambda: programs.fibonacci_vm(500))
    rview = rnative.run_trace(rprograms.fibonacci_vm(500))
    return chips, view, rbuild_all_chips(), rview


@pytest.mark.parametrize("kwargs", PLANS, ids=["cells", "steps", "both"])
def test_preflight_fibonacci_bounds(fib500, kwargs):
    chips, view, rchips, rview = fib500
    want = plan_boundaries(view, chips, **kwargs)
    assert want == rplan_boundaries(rview, rchips, **kwargs)
    got, _, _, _ = native.run_preflight(
        programs.fibonacci_vm(500), _cost_by_kind(chips),
        kwargs.get("max_cells_per_shard"), kwargs.get("max_steps_per_shard"))
    assert got == want and len(got) > 2


def test_plan_boundaries_preflight_entry_point():
    chips = build_all_chips()
    view = native.run_trace(programs.fibonacci_vm(300))
    want = plan_boundaries(view, chips, max_cells_per_shard=30_000)
    got = plan_boundaries_preflight(programs.fibonacci_vm(300), chips, max_cells_per_shard=30_000)
    assert want == got


def test_preflight_torture_guest_equivalence():
    """Full rv32im coverage incl. M extension, loads/stores of every width,
    jalr returns, and the keccak syscall (do_ecall is shared with the tracing
    core, so memory effects must match exactly); the preflight bounds equal
    the traced ones."""
    from tests.test_zkvm_extended import TORTURE

    rom = 0x0800_0000

    def make_vm():
        src = TORTURE.format(heap=Platform.heap_start)
        return VMState(make_program(rv32im.assemble(src, rom), rom), rom)

    view = _assert_equivalent(make_vm)
    chips = build_all_chips()
    want = plan_boundaries(view, chips, max_steps_per_shard=7)
    got = plan_boundaries_preflight(make_vm(), chips, max_steps_per_shard=7)
    assert got == want and len(got) > 2


def test_preflight_memory_effects_match():
    """The keccak ecall re-kinds to SYS_KECCAK for costs and counts."""
    from tests.test_keccak import GUEST, ROM

    def make_vm():
        return VMState(make_program(rv32im.assemble(GUEST, ROM), ROM), ROM)

    view = _assert_equivalent(make_vm)
    assert _counts_of(view)[rv32im.K["SYS_KECCAK"]] >= 1


def test_library_built_outside_the_source_tree():
    vm = programs.fibonacci_vm(5)
    so = aotgen.build(vm.program, vm.entry)
    assert so.parent == aotgen._AOT_DIR and so.parent.parent.name == "_build"
    assert f'#include "{aotgen._EMU_SRC}"' in so.with_suffix(".cpp").read_text()
    assert aotgen.build(vm.program, vm.entry) == so  # cached by digest
