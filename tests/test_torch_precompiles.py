"""Port parity of the precompile chips with instances.

For each precompile guest of ``tests/test_{keccak,sha256,uint256,curves,
pubio}.py`` and ``examples/precompile_torture.s``, the port against the
reference (``ceno_tpu``), exactly:

- the native core's trace columns and final VM state equal the Python
  interpreter's and the reference's, for the guests whose syscalls the core
  has (keccak-f, SHA extend, uint256 mul, PUB_IO_COMMIT); the curve guests
  make the core stop (``UnsupportedSyscall``) and ``run_trace`` falls back to
  the interpreter in both packages;
- the AOT preflight's step, kind and state counts equal the trace's and the
  reference's;
- ``generate_witness`` gives every chip's witness columns, instance count and
  height equal to the reference's: the precompile chips with instances and
  the table chips' multiplicities;
- the port's mock prover accepts each guest's witness, and rejects the
  forged ones the reference's tests forge (a keccak output bit, a SHA-extend
  write, a uint256 result word, the public-io digest), as the reference's
  does;
- the Poseidon2 gadget equals the host permutation, as
  ``tests/test_poseidon2_gadget.py`` holds it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import native as rnative
from ceno_tpu.emulator.rv32im import assemble as rassemble
from ceno_tpu.emulator.state import VMState as RVMState, make_program as rmake_program
from ceno_tpu.gkr.mock import MockProver as RMockProver
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm.chips import build_all_chips as rbuild_all_chips
from ceno_tpu.zkvm.chips.dyn_ram import build_dyn_ram_chips as rbuild_dyn_ram_chips
from ceno_tpu.zkvm.chips.opcodes import TraceView as RTraceView
from ceno_tpu.zkvm.chips.shard_ram import build_shard_chips as rbuild_shard_chips
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig, build_tables as rbuild_tables
from ceno_tpu.zkvm.witgen import generate_witness as rgenerate_witness
from ceno_tpu_torch.emulator import native
from ceno_tpu_torch.emulator.keccak import public_io_digest_words
from ceno_tpu_torch.emulator.rv32im import K
from ceno_tpu_torch.emulator.state import Platform
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr.chip import compile_chip
from ceno_tpu_torch.gkr.circuit_builder import CircuitBuilder
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.hash import poseidon2 as p2
from ceno_tpu_torch.zkvm import e2e, layout, scheme
from ceno_tpu_torch.zkvm.chips.opcodes import TraceView
from ceno_tpu_torch.zkvm.chips.poseidon2_gadget import Lin, assign_poseidon2, build_poseidon2
from ceno_tpu_torch.zkvm.tables import ZKVMConfig
from ceno_tpu_torch.zkvm.witgen import generate_witness

import chip_smoke
import test_curves
import test_keccak
import test_pubio
import test_sha256
import test_uint256
from test_poseidon2_gadget import _build as rbuild_gadget, _witness as rgadget_witness

torch.set_num_threads(1)
CFG = dict(shl_x_bits=6, mem_words_log=7)
ROM = Platform.rom_start
PUBIO_HINTS = public_io_digest_words(test_pubio.PUBLIC_WORDS)
# guest -> (source, hint words, the syscall kinds it makes, runs on the native core)
GUESTS = {
    "keccak": (test_keccak.GUEST, [], ["SYS_KECCAK"], True),
    "sha256": (test_sha256.GUEST, [], ["SYS_SHA_EXTEND"], True),
    "uint256": (test_uint256.GUEST, [], ["SYS_UINT256_MUL"], True),
    "pubio": (test_pubio.GUEST, PUBIO_HINTS, ["SYS_COMMIT"], True),
    "torture": (*chip_smoke.precompile_guest("precompile_torture")[:2],
                ["SYS_KECCAK", "SYS_SHA_EXTEND", "SYS_UINT256_MUL", "SYS_COMMIT"], True),
    "secp": (test_curves.SECP_GUEST, [],
             ["SYS_SECP256K1_ADD", "SYS_SECP256K1_DOUBLE", "SYS_SECP256K1_SCALAR_INVERT",
              "SYS_SECP256K1_DECOMPRESS"], False),
    "bn254": (test_curves.BN254_GUEST, [],
              ["SYS_BN254_DOUBLE", "SYS_BN254_FP2_MUL", "SYS_BN254_FP_ADD", "SYS_BN254_FP_MUL"],
              False),
}
NATIVE = sorted(g for g, spec in GUESTS.items() if spec[3])


def _vms(guest):
    """(port vm, reference vm) of the guest, hints loaded."""
    src, hints, _, _ = GUESTS[guest]
    vm = chip_smoke.guest_vm(src, hints)
    rvm = RVMState(rmake_program(rassemble(src, ROM), ROM), ROM)
    for i, w in enumerate(hints):
        rvm.init_memory(Platform.hints_start + 4 * i, w)
    return vm, rvm


def _vm_state(vm):
    return (vm.pc, vm.cycle, vm.halted, vm.exit_code, list(vm.regs), list(vm.reg_ts),
            dict(vm.mem), dict(vm.mem_ts), vm.pubio_digest)


def _assert_views_equal(got, want):
    assert got.n == want.n
    for f in dataclasses.fields(want):
        if f.name != "n":
            np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                          err_msg=f.name)


@pytest.fixture(scope="module")
def traces():
    """guest -> (port vm, port trace, reference vm, reference trace), each
    through ``run_trace`` (the native core where it runs the guest)."""
    out = {}
    for guest in GUESTS:
        vm, rvm = _vms(guest)
        out[guest] = (vm, native.run_trace(vm), rvm, rnative.run_trace(rvm))
    return out


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_trace_equals_reference_and_interpreter(guest, traces):
    vm, view, rvm, rview = traces[guest]
    _assert_views_equal(view, rview)
    assert _vm_state(vm) == _vm_state(rvm) and vm.halted
    interp_vm, _ = _vms(guest)
    _assert_views_equal(TraceView.from_records(interp_vm.run()), view)
    assert _vm_state(interp_vm) == _vm_state(vm)
    kinds = set(np.asarray(view.kind).tolist())
    assert {K[k] for k in GUESTS[guest][2]} <= kinds


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_native_core_runs_only_its_syscalls(guest, traces):
    vm, _ = _vms(guest)
    if GUESTS[guest][3]:
        _assert_views_equal(native.run_trace_native(vm), traces[guest][1])
    else:
        with pytest.raises(native.UnsupportedSyscall):
            native.run_trace_native(vm)


@pytest.mark.parametrize("guest", NATIVE)
def test_preflight_counts_equal_the_trace(guest, traces):
    vm, rvm = _vms(guest)
    bounds, counts, steps, state = native.run_preflight(vm)
    rbounds, rcounts, rsteps, rstate = rnative.run_preflight(rvm)
    _, view, _, _ = traces[guest]
    assert steps == rsteps == view.n and bounds == rbounds == [0, view.n]
    np.testing.assert_array_equal(counts, rcounts)
    np.testing.assert_array_equal(
        counts, np.bincount(np.asarray(view.kind, np.int64), minlength=len(counts)))
    assert {k: v for k, v in state.items() if k != "regs"} == \
        {k: v for k, v in rstate.items() if k != "regs"}
    np.testing.assert_array_equal(state["regs"], rstate["regs"])
    assert state["halted"] and state["exit_code"] == traces[guest][0].exit_code


@pytest.fixture(scope="module")
def chips():
    """(port registry, reference chips) at CFG, with an empty program (the
    program table is built per guest)."""
    cfg = ZKVMConfig(**CFG)
    return (cfg, scheme.registry({}, cfg)[:3],
            (rbuild_all_chips(), rbuild_shard_chips(), rbuild_dyn_ram_chips(RConfig(**CFG))))


def _witness(guest, traces, chips, view=None, rview=None, pv=None):
    """(port assigned, reference assigned, port tables, public values)."""
    vm, pview, rvm, rtrace = traces[guest]
    cfg, (oc, sc, dc), (roc, rsc, rdc) = chips
    tables = scheme.registry(vm.program, cfg)[3]
    rtables = rbuild_tables(rvm.program, RConfig(**CFG))
    if pv is None:
        pv = e2e.public_values_from_vm(vm, cfg)
        np.testing.assert_array_equal(pv, re2e.public_values_from_vm(rvm, RConfig(**CFG)))
    got = generate_witness(pview if view is None else view, oc, tables, vm, pv, cfg,
                           shard_chips=sc, dyn_chips=dc)
    want = rgenerate_witness(rtrace if rview is None else rview, roc, rtables, rvm, pv,
                             RConfig(**CFG), shard_chips=rsc, dyn_chips=rdc)
    return got, want, tables, pv


def _mock_chips(assigned, tables, pv):
    """MockProver's (compiled, cb, wit, fixed, pv, k) per chip, the tables'
    fixed columns padded to their height (as the reference's tests do)."""
    fixed_by_name = {t.name: t for t in tables if t.cb.fixed_names}
    out = []
    for a in assigned:
        fixed = np.zeros((0, a.n_rows), np.uint64)
        if a.name in fixed_by_name:
            fx = np.asarray(fixed_by_name[a.name].fixed_fn(), np.uint64)
            fixed = np.pad(fx, ((0, 0), (0, a.n_rows - fx.shape[1])))
        out.append((a.compiled, a.cb, a.wit, fixed, pv, a.num_instances))
    return out


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_witness_equals_reference(guest, traces, chips):
    got, want, _, _ = _witness(guest, traces, chips)
    assert [a.name for a in got] == [a.name for a in want]
    for a, w in zip(got, want):
        assert (a.num_instances, a.n_rows, a.is_table, a.kind) == \
            (w.num_instances, w.n_rows, w.is_table, w.kind), a.name
        assert a.wit.dtype == np.uint64, a.name
        np.testing.assert_array_equal(a.wit, w.wit, err_msg=a.name)
    active = {a.name for a in got if a.num_instances}
    precompiles = {a.name for a in got if a.name in chip_smoke.PRECOMPILE_CHIPS
                   or a.name.startswith("bn254")}
    assert active & precompiles, active
    assert {"and8", "xor8", "range16"} <= active


@pytest.mark.parametrize("guest", sorted(GUESTS))
def test_mock_prover_accepts(guest, traces, chips):
    got, _, tables, pv = _witness(guest, traces, chips)
    errs = MockProver.assert_satisfied(_mock_chips(got, tables, pv), raise_on_error=False)
    assert errs == [], errs[:5]


def _forged_view(view, entry):
    bad = dataclasses.replace(view, sys_val=view.sys_val.copy())
    bad.sys_val[entry] ^= 1
    return bad


@pytest.mark.parametrize("guest, entry", [("keccak", (0, 3))])
def test_forged_keccak_output_rejected_by_the_mock(guest, entry, traces, chips):
    """A changed output bit of the keccak syscall breaks the Custom bus, in
    both packages' mock provers."""
    _, view, _, rview = traces[guest]
    bad = _forged_view(view, entry)
    rbad = dataclasses.replace(rview, sys_val=bad.sys_val.copy())
    got, want, tables, pv = _witness(guest, traces, chips, view=bad, rview=rbad)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.wit, w.wit, err_msg=a.name)
    errs = MockProver.assert_satisfied(_mock_chips(got, tables, pv), raise_on_error=False)
    rerrs = RMockProver.assert_satisfied(_mock_chips(want, tables, pv), raise_on_error=False)
    assert errs and rerrs
    assert [(e.chip, e.row) for e in errs] == [(e.chip, e.row) for e in rerrs]


@pytest.mark.parametrize("guest, entry", [("sha256", (0, 4)), ("uint256", (0, 0))],
                         ids=["sha_extend_write", "uint256_result"])
def test_forged_syscall_write_refused_by_witgen(guest, entry, traces, chips):
    """A forged SHA-extend write or uint256 result word fails witgen's own
    consistency check, in both packages (the reference's tests expect the
    same AssertionError)."""
    _, view, _, rview = traces[guest]
    bad = _forged_view(view, entry)
    rbad = dataclasses.replace(rview, sys_val=bad.sys_val.copy())
    with pytest.raises(AssertionError):
        _witness(guest, traces, chips, view=bad)
    with pytest.raises(AssertionError):
        _witness(guest, traces, chips, rview=rbad)


def test_forged_pubio_digest_rejected_by_the_mock(traces, chips):
    """A public-io digest limb changed in the public values breaks the
    commit chip's binding, in both packages' mock provers."""
    vm, _, _, _ = traces["pubio"]
    pv = e2e.public_values_from_vm(vm, ZKVMConfig(**CFG))
    pv[layout.PV_PUBIO_DIGEST] ^= 1
    got, want, tables, _ = _witness("pubio", traces, chips, pv=pv)
    errs = MockProver.assert_satisfied(_mock_chips(got, tables, pv), raise_on_error=False)
    rerrs = RMockProver.assert_satisfied(_mock_chips(want, tables, pv), raise_on_error=False)
    assert errs and rerrs
    assert {e.chip for e in errs} == {e.chip for e in rerrs}


def _gadget():
    cb = CircuitBuilder("p2test")
    ins = [cb.create_witin(f"in{i}") for i in range(16)]
    outs = build_poseidon2(cb, "p2", [Lin.col(c) for c in ins])
    xcols = [cb.create_witin(f"x{i}") for i in range(7)]
    for i in range(7):
        cb.require_zero(f"x{i}_tie", xcols[i] - outs[i].to_expr())
    return cb, compile_chip(cb)


def _gadget_witness(cb, inputs):
    u_vals, w_vals, final = assign_poseidon2(inputs)
    cols = {f"in{i}": inputs[:, i] for i in range(16)}
    site = 0
    for name in cb.wit_names:
        if name.endswith("_u"):
            cols[name] = u_vals[site]
        elif name.endswith("_w"):
            cols[name] = w_vals[site]
            site += 1
    cols.update({f"x{i}": final[:, i] for i in range(7)})
    wit = np.stack([np.asarray(cols[name], np.uint64) for name in cb.wit_names])
    return wit, final


@pytest.mark.parametrize("seed", [0, 1])
def test_poseidon2_gadget_equals_the_host_permutation(seed):
    inputs = np.random.default_rng(seed).integers(0, bb.P, size=(4, 16), dtype=np.uint64)
    cb, compiled = _gadget()
    rcb, _ = rbuild_gadget()
    wit, final = _gadget_witness(cb, inputs)
    rwit, rfinal = rgadget_witness(rcb, inputs)
    assert cb.wit_names == rcb.wit_names
    np.testing.assert_array_equal(wit, rwit)
    np.testing.assert_array_equal(final, rfinal)
    np.testing.assert_array_equal(final.T, p2.permute_host(inputs.T.copy()))
    n = inputs.shape[0]
    ok = [(compiled, cb, wit, np.zeros((0, n), np.uint64), np.zeros(6, np.uint64), n)]
    assert [e for e in MockProver.assert_satisfied(ok, raise_on_error=False) if e.row >= 0] == []
    wit[cb.wit_names.index("p2_i5_w"), 0] = (wit[cb.wit_names.index("p2_i5_w"), 0] + 1) % bb.P
    bad = [(compiled, cb, wit, np.zeros((0, n), np.uint64), np.zeros(6, np.uint64), n)]
    assert any(e.row >= 0 for e in MockProver.assert_satisfied(bad, raise_on_error=False))
