"""Port parity: the emulator glue and the opcode chips' witness.

The port's native core (its own copy of ``emulator.cpp``, built into
``ceno_tpu_torch/_build/``) and its Python interpreter each give the same
TraceView columns and final VM state as the reference's ``run_trace`` on
fibonacci guests, and ``assign_opcode_chips`` gives equal matrices. All
comparisons are exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import native as rnative
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.zkvm.chips.opcodes import build_opcode_chips as rbuild_opcode_chips
from ceno_tpu.zkvm.witgen import assign_opcode_chips as rassign
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.zkvm.chips.opcodes import TraceView, build_opcode_chips
from ceno_tpu_torch.zkvm.witgen import assign_opcode_chips

import chip_smoke

torch.set_num_threads(1)
SIZES = [8, 200]
BACKENDS = {
    "native": lambda vm: native.run_trace_native(vm),
    "python": lambda vm: TraceView.from_records(vm.run(1 << 24)),
}


def _vm_state(vm):
    return (vm.pc, vm.cycle, vm.halted, vm.exit_code, list(vm.regs), list(vm.reg_ts),
            dict(vm.mem), dict(vm.mem_ts))


def _assert_views_equal(got, want):
    assert got.n == want.n
    for f in dataclasses.fields(want):
        if f.name != "n":
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                          err_msg=f.name)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("n", SIZES)
def test_run_trace_matches_reference(n, backend):
    rvm = rprograms.fibonacci_vm(n)
    want = rnative.run_trace(rvm)
    vm = programs.fibonacci_vm(n)
    got = BACKENDS[backend](vm)
    _assert_views_equal(got, want)
    assert _vm_state(vm) == _vm_state(rvm)
    assert vm.regs[10] == programs.fib_expected(n)
    # the plain form carries a view across unchanged
    _assert_views_equal(interop.trace_view_from_dict(dataclasses.asdict(got)), want)


@pytest.mark.parametrize("n", SIZES)
def test_run_native_and_run_vm_match_the_interpreter(n):
    """The StepRecords of the native core (whose decoded instructions carry
    no raw word) give the interpreter's trace columns and final state."""
    want = programs.fibonacci_vm(n)
    records = want.run(1 << 24)
    for run in (native.run_native, native.run_vm):
        vm = programs.fibonacci_vm(n)
        got = run(vm, 1 << 24)
        _assert_views_equal(TraceView.from_records(got), TraceView.from_records(records))
        assert [(r.cycle, r.pc, r.next_pc, r.rs1, r.rs2, r.rd, r.mem) for r in got] == [
            (r.cycle, r.pc, r.next_pc, r.rs1, r.rs2, r.rd, r.mem) for r in records]
        assert _vm_state(vm) == _vm_state(want)


@pytest.mark.parametrize("n", SIZES)
def test_assign_opcode_chips_matches_reference(n):
    want = rassign(rnative.run_trace(rprograms.fibonacci_vm(n)), rbuild_opcode_chips())
    got = assign_opcode_chips(native.run_trace(programs.fibonacci_vm(n)), build_opcode_chips())
    assert [a.name for a in got] == [a.name for a in want]
    for g, w in zip(got, want):
        assert (g.num_instances, g.n_rows, g.is_table, g.kind) == (
            w.num_instances, w.n_rows, w.is_table, w.kind), g.name
        assert g.wit.dtype == w.wit.dtype == np.uint64
        np.testing.assert_array_equal(g.wit, w.wit, err_msg=g.name)


@pytest.mark.parametrize("n", [8, 40, 2047, 2048, 3000])
def test_fib_rows_counts_the_trace(n):
    """chip_smoke's row counts per chip, derived from FIBONACCI, against the
    reference emulator's trace (n >= 2048 needs lui for li a0, n)."""
    vm = rprograms.fibonacci_vm(n)
    assigned = rassign(rnative.run_trace(vm), rbuild_opcode_chips())
    assert {a.name: a.num_instances for a in assigned} == chip_smoke.fib_rows(n)


def test_native_core_builds_into_the_build_dir_keyed_by_its_source():
    src, lib = native._target()
    assert os.path.dirname(lib) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("ceno_tpu_torch", "_build"))
    assert os.path.basename(lib).startswith("libceno_emu-")
    assert native._build() == lib and os.path.exists(lib)
    with open(src) as f, open(os.path.join(os.path.dirname(rnative.__file__), "native",
                                           "emulator.cpp")) as g:
        ours, theirs = f.read().splitlines(), g.read().splitlines()
    # the same code; only the header comment on how it is built differs
    assert [ln for ln in ours if not ln.startswith("//")] == [
        ln for ln in theirs if not ln.startswith("//")]


def test_without_a_compiler_the_native_runner_raises(monkeypatch, tmp_path):
    """No C++ compiler: ``run_trace_native`` (chip_smoke's only runner) raises
    instead of running the Python interpreter; ``run_trace`` falls back to it,
    as the reference's does."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no C\\+\\+ toolchain"):
        native.run_trace_native(programs.fibonacci_vm(8))
    assert not native.native_available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ toolchain"):
        chip_smoke.emulate_and_assign(8)
    vm = programs.fibonacci_vm(8)
    assert native.run_trace(vm).n == 59 and vm.regs[10] == programs.fib_expected(8)
