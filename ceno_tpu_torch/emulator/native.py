"""ctypes binding for the native C++ rv32im emulator.

Counterpart of ``ceno_tpu/emulator/native.py``, with its AOT preflight
backend (:func:`run_preflight` over ``aotgen``'s per-program libraries, built
into ``ceno_tpu_torch/_build/aot/``). Builds ``native/emulator.cpp`` on
first use (utils/host_build.py: ``c++ -O2 -shared -fPIC -pthread``) into the git-ignored
``ceno_tpu_torch/_build/``, keyed by a hash of the source, runs
the guest at native speed and reconstructs the same VMState + StepRecord
structures (or TraceView columns) the Python interpreter produces — witgen is
agnostic to which backend ran. :func:`run_vm` and :func:`run_trace` fall back
to the Python interpreter where the core does not build;
:func:`run_trace_native` never does. The reference's backend switch
(``CENO_EMULATOR_BACKEND``) has no counterpart.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from ..utils import host_build
from .rv32im import DecodedInsn, KINDS
from .state import VMState, StepRecord, Platform

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native", "emulator.cpp")
BUILD_DIR = host_build.BUILD_DIR
_LIB = None


class _StepRow(ctypes.Structure):
    _fields_ = [
        ("pc", ctypes.c_uint32), ("next_pc", ctypes.c_uint32),
        ("cycle", ctypes.c_uint32), ("kind", ctypes.c_int32),
        ("rd", ctypes.c_int32), ("rs1", ctypes.c_int32), ("rs2", ctypes.c_int32),
        ("imm", ctypes.c_int32),
        ("rs1_val", ctypes.c_uint32), ("rs2_val", ctypes.c_uint32),
        ("rd_prev", ctypes.c_uint32), ("rd_val", ctypes.c_uint32),
        ("rs1_prev_ts", ctypes.c_uint32), ("rs2_prev_ts", ctypes.c_uint32),
        ("rd_prev_ts", ctypes.c_uint32),
        ("sys_idx", ctypes.c_int32),
        ("mem_waddr", ctypes.c_int64),
        ("mem_prev", ctypes.c_uint32), ("mem_val", ctypes.c_uint32),
        ("mem_prev_ts", ctypes.c_uint32),
    ]


def _target() -> tuple:
    """(source, library) paths; the library is keyed by a hash of the source
    and the flags, so an edited source is rebuilt."""
    return _SRC, host_build.target(_SRC, "libceno_emu", BUILD_DIR)


def _build() -> str:
    """Build the core unless it is built; returns the library's path. Raises
    RuntimeError when no C++ compiler can build it."""
    return host_build.build(_SRC, "libceno_emu", BUILD_DIR)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        lib.emu_new.restype = ctypes.c_void_p
        lib.emu_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
        lib.emu_free.argtypes = [ctypes.c_void_p]
        lib.emu_load_program.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64,
        ]
        lib.emu_init_memory.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64,
        ]
        lib.emu_run.restype = ctypes.c_int64
        lib.emu_run.argtypes = [ctypes.c_void_p, ctypes.POINTER(_StepRow), ctypes.c_int64]
        lib.emu_state.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_uint32)] * 2 + [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32)
        ]
        lib.emu_regs.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint32),
        ]
        lib.emu_mem_count.restype = ctypes.c_int64
        lib.emu_mem_count.argtypes = [ctypes.c_void_p]
        lib.emu_mem_dump.argtypes = [
            ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint32),
            np.ctypeslib.ndpointer(np.uint32), np.ctypeslib.ndpointer(np.uint32),
        ]
        lib.emu_sys_count.restype = ctypes.c_int64
        lib.emu_sys_count.argtypes = [ctypes.c_void_p]
        lib.emu_sys_dump.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(np.uint32)
        ] * 4
        lib.emu_pubio.restype = ctypes.c_int
        lib.emu_pubio.argtypes = [ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint32)]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    try:
        _lib()
        return True
    except RuntimeError:
        return False


class UnsupportedSyscall(RuntimeError):
    """The native core hit a syscall it does not implement; callers fall
    back to the python emulator (vm is left unmutated)."""


def _check_run(got: int) -> None:
    if got == -2:
        raise UnsupportedSyscall("native core: unsupported ecall")
    if got < 0:
        raise RuntimeError(f"native emulator error {got}")


def run_native(vm: VMState, max_steps: int = 1 << 24):
    """Execute ``vm`` with the native core; mutates vm to the final state and
    returns StepRecords equivalent to vm.run()."""
    lib = _lib()
    h = lib.emu_new(vm.entry, vm.regs[2])
    try:
        prog_items = sorted(vm.program.items())
        base_w = prog_items[0][0]
        words = np.zeros(prog_items[-1][0] - base_w + 1, np.uint32)
        for w, word in prog_items:
            words[w - base_w] = word
        lib.emu_load_program(h, base_w << 2, words, len(words))
        if vm.mem_init:
            for waddr, val in sorted(vm.mem_init.items()):
                lib.emu_init_memory(h, waddr << 2, np.array([val], np.uint32), 1)
        # chunked execution: bounded buffer regardless of max_steps
        chunk = 1 << 20
        all_rows = []
        remaining = max_steps
        n = 0
        while remaining > 0:
            buf = (_StepRow * min(chunk, remaining))()
            got = lib.emu_run(h, buf, len(buf))
            _check_run(got)
            all_rows.append((buf, got))
            n += got
            remaining -= len(buf)
            if got < len(buf):
                break
        pc = ctypes.c_uint32()
        cycle = ctypes.c_uint32()
        halted = ctypes.c_int()
        exit_code = ctypes.c_uint32()
        lib.emu_state(h, ctypes.byref(pc), ctypes.byref(cycle),
                      ctypes.byref(halted), ctypes.byref(exit_code))
        regs = np.zeros(32, np.uint32)
        reg_ts = np.zeros(32, np.uint32)
        lib.emu_regs(h, regs, reg_ts)
        m = lib.emu_mem_count(h)
        waddrs = np.zeros(max(m, 1), np.uint32)
        vals = np.zeros(max(m, 1), np.uint32)
        tss = np.zeros(max(m, 1), np.uint32)
        if m:
            lib.emu_mem_dump(h, waddrs, vals, tss)

        # fold results back into the VMState
        vm.pc = pc.value
        vm.cycle = cycle.value
        vm.halted = bool(halted.value)
        vm.exit_code = exit_code.value
        vm.regs = [int(x) for x in regs]
        vm.reg_ts = [int(x) for x in reg_ts]
        for i in range(m):
            vm.mem[int(waddrs[i])] = int(vals[i])
            vm.mem_ts[int(waddrs[i])] = int(tss[i])
            vm.touched.add(int(waddrs[i]))
        digest = np.zeros(8, np.uint32)
        if lib.emu_pubio(h, digest):
            vm.pubio_digest = [int(x) for x in digest]

        sys_blocks = _fetch_sys_blocks(lib, h)

        # reconstruct via numpy structured views (ctypes per-field access is
        # ~20x slower than tolist() over a structured array)
        ecall_kind = KINDS.index("ECALL")
        unsigned_imm = {KINDS.index("LUI"), KINDS.index("AUIPC")}
        records = []
        for buf, got in all_rows:
            if not got:
                continue
            arr = np.frombuffer(
                memoryview(buf), dtype=_ROW_DTYPE, count=got
            )
            rows = arr.tolist()
            for row in rows:
                (pc, next_pc, cycle, kind, rd, rs1, rs2, imm, rs1_val, rs2_val,
                 rd_prev, rd_val, rs1_pts, rs2_pts, rd_pts, sys_idx,
                 mem_waddr, mem_prev, mem_val, mem_pts, _pad2) = row
                if kind == ecall_kind:
                    insn = DecodedInsn(kind, 0, 0, 0, 0, 0)
                else:
                    if kind in unsigned_imm:
                        imm &= 0xFFFFFFFF
                    insn = DecodedInsn(kind, max(rd, 0), max(rs1, 0), max(rs2, 0), imm, 0)
                rec = StepRecord(cycle, pc, next_pc, insn)
                if rs1 >= 0:
                    rec.rs1 = (rs1, rs1_val, rs1_pts)
                if rs2 >= 0:
                    rec.rs2 = (rs2, rs2_val, rs2_pts)
                if rd >= 0:
                    rec.rd = (rd, rd_prev, rd_val, rd_pts)
                if mem_waddr >= 0:
                    rec.mem = (mem_waddr, mem_prev, mem_val, mem_pts)
                if sys_idx >= 0:
                    n_ops = 8 if rs1_val == Platform.ECALL_COMMIT else 50
                    blk = sys_blocks[sys_idx]
                    rec.sys_mem = [
                        (int(blk[0][i]), int(blk[1][i]), int(blk[2][i]),
                         int(blk[3][i]))
                        for i in range(n_ops)
                    ]
                records.append(rec)
        return records
    finally:
        lib.emu_free(h)


_ROW_DTYPE = np.dtype(
    [
        ("pc", "<u4"), ("next_pc", "<u4"), ("cycle", "<u4"), ("kind", "<i4"),
        ("rd", "<i4"), ("rs1", "<i4"), ("rs2", "<i4"), ("imm", "<i4"),
        ("rs1_val", "<u4"), ("rs2_val", "<u4"), ("rd_prev", "<u4"), ("rd_val", "<u4"),
        ("rs1_prev_ts", "<u4"), ("rs2_prev_ts", "<u4"), ("rd_prev_ts", "<u4"),
        ("sys_idx", "<i4"),
        ("mem_waddr", "<i8"), ("mem_prev", "<u4"), ("mem_val", "<u4"),
        ("mem_prev_ts", "<u4"), ("_pad2", "<u4"),
    ]
)


def run_vm(vm: VMState, max_steps: int = 1 << 24):
    """Run with the native core where it builds, else the Python interpreter
    (also on a syscall the core does not implement)."""
    if native_available():
        try:
            return run_native(vm, max_steps)
        except UnsupportedSyscall:
            pass  # vm not yet mutated (sync happens after the run loop)
    return vm.run(max_steps)


def run_trace(vm: VMState, max_steps: int = 1 << 24):
    """Run and return the witgen-ready columnar TraceView — the fast path:
    the native core's flat arrays become numpy columns with no per-step
    python objects at all. Falls back to python records where the core does
    not build or hits a syscall it does not implement; callers that must not
    fall back call :func:`run_trace_native`."""
    from ..zkvm.chips.opcodes import TraceView

    if not native_available():
        return TraceView.from_records(vm.run(max_steps))
    try:
        return run_trace_native(vm, max_steps)
    except UnsupportedSyscall:
        return TraceView.from_records(vm.run(max_steps))


def run_trace_native(vm: VMState, max_steps: int = 1 << 24):
    """:func:`run_trace` on the native core only: raises RuntimeError when the
    core does not build and UnsupportedSyscall where it stops."""
    from ..zkvm.chips.opcodes import TraceView

    # run natively, then build columns straight from the row buffers
    lib = _lib()
    h = lib.emu_new(vm.entry, vm.regs[2])
    try:
        prog_items = sorted(vm.program.items())
        base_w = prog_items[0][0]
        words = np.zeros(prog_items[-1][0] - base_w + 1, np.uint32)
        for w, word in prog_items:
            words[w - base_w] = word
        lib.emu_load_program(h, base_w << 2, words, len(words))
        for waddr, val in sorted(vm.mem_init.items()):
            lib.emu_init_memory(h, waddr << 2, np.array([val], np.uint32), 1)
        chunk = 1 << 20
        arrays = []
        remaining = max_steps
        while remaining > 0:
            buf = (_StepRow * min(chunk, remaining))()
            got = lib.emu_run(h, buf, len(buf))
            _check_run(got)
            if got:
                arrays.append(
                    np.frombuffer(memoryview(buf), dtype=_ROW_DTYPE, count=got).copy()
                )
            remaining -= len(buf)
            if got < len(buf):
                break
        _sync_vm_state(lib, h, vm)
        arr = np.concatenate(arrays) if arrays else np.zeros(0, _ROW_DTYPE)
        imm = arr["imm"].astype(np.int64)
        unsigned = np.isin(arr["kind"], np.array(
            [KINDS.index("LUI"), KINDS.index("AUIPC")], np.int32
        ))
        imm = np.where(unsigned, imm & 0xFFFFFFFF, imm)
        kind = arr["kind"].astype(np.int64)
        sys_idx = arr["sys_idx"].astype(np.int64)
        has_sys = sys_idx >= 0
        if has_sys.any():
            from .state import SYSCALL_KIND_NAMES

            kind = np.where(has_sys, KINDS.index("SYS_KECCAK"), kind)
            for code, kname in SYSCALL_KIND_NAMES.items():
                kind = np.where(
                    has_sys & (arr["rs1_val"] == code), KINDS.index(kname), kind
                )
            nb = lib.emu_sys_count(h)
            size = nb * 50
            s_addr = np.zeros(size, np.uint32)
            s_prev = np.zeros(size, np.uint32)
            s_val = np.zeros(size, np.uint32)
            s_pts = np.zeros(size, np.uint32)
            lib.emu_sys_dump(h, s_addr, s_prev, s_val, s_pts)
            sys_arrays = dict(
                sys_addr=s_addr.reshape(nb, 50).astype(np.int64),
                sys_prev=s_prev.reshape(nb, 50).astype(np.int64),
                sys_val=s_val.reshape(nb, 50).astype(np.int64),
                sys_pts=s_pts.reshape(nb, 50).astype(np.int64),
            )
        else:
            sys_arrays = {}
        return TraceView(
            sys_idx=sys_idx,
            **sys_arrays,
            n=len(arr),
            pc=arr["pc"].astype(np.int64),
            ts=arr["cycle"].astype(np.int64),
            rs1_id=np.maximum(arr["rs1"], 0).astype(np.int64),
            rs1_val=arr["rs1_val"].astype(np.int64),
            rs1_pts=arr["rs1_prev_ts"].astype(np.int64),
            rs2_id=np.maximum(arr["rs2"], 0).astype(np.int64),
            rs2_val=arr["rs2_val"].astype(np.int64),
            rs2_pts=arr["rs2_prev_ts"].astype(np.int64),
            rd_id=np.maximum(arr["rd"], 0).astype(np.int64),
            rd_prev=arr["rd_prev"].astype(np.int64),
            rd_val=arr["rd_val"].astype(np.int64),
            rd_pts=arr["rd_prev_ts"].astype(np.int64),
            mem_waddr=arr["mem_waddr"].astype(np.int64),
            mem_prev=arr["mem_prev"].astype(np.int64),
            mem_val=arr["mem_val"].astype(np.int64),
            mem_pts=arr["mem_prev_ts"].astype(np.int64),
            imm=imm,
            kind=kind,
        )
    finally:
        lib.emu_free(h)


def _fetch_sys_blocks(lib, h):
    """[(addr, prev, val, pts) arrays of width 50] per bulk-syscall block."""
    nb = lib.emu_sys_count(h)
    if not nb:
        return []
    size = nb * 50
    addr = np.zeros(size, np.uint32)
    prev = np.zeros(size, np.uint32)
    val = np.zeros(size, np.uint32)
    pts = np.zeros(size, np.uint32)
    lib.emu_sys_dump(h, addr, prev, val, pts)
    return [
        (addr[i * 50:(i + 1) * 50], prev[i * 50:(i + 1) * 50],
         val[i * 50:(i + 1) * 50], pts[i * 50:(i + 1) * 50])
        for i in range(nb)
    ]


def _sync_vm_state(lib, h, vm: VMState) -> None:
    pc = ctypes.c_uint32()
    cycle = ctypes.c_uint32()
    halted = ctypes.c_int()
    exit_code = ctypes.c_uint32()
    lib.emu_state(h, ctypes.byref(pc), ctypes.byref(cycle),
                  ctypes.byref(halted), ctypes.byref(exit_code))
    regs = np.zeros(32, np.uint32)
    reg_ts = np.zeros(32, np.uint32)
    lib.emu_regs(h, regs, reg_ts)
    m = lib.emu_mem_count(h)
    waddrs = np.zeros(max(m, 1), np.uint32)
    vals = np.zeros(max(m, 1), np.uint32)
    tss = np.zeros(max(m, 1), np.uint32)
    if m:
        lib.emu_mem_dump(h, waddrs, vals, tss)
    vm.pc = pc.value
    vm.cycle = cycle.value
    vm.halted = bool(halted.value)
    vm.exit_code = exit_code.value
    vm.regs = [int(x) for x in regs]
    vm.reg_ts = [int(x) for x in reg_ts]
    for i in range(m):
        vm.mem[int(waddrs[i])] = int(vals[i])
        vm.mem_ts[int(waddrs[i])] = int(tss[i])
        vm.touched.add(int(waddrs[i]))
    digest = np.zeros(8, np.uint32)
    if lib.emu_pubio(h, digest):
        vm.pubio_digest = [int(x) for x in digest]


# ---------------------------------------------------------------------------
# AOT preflight backend (emulator/aotgen.py codegen; ceno_emul/src/aot.rs
# role): guest basic blocks compiled to native code, executed WITHOUT step
# rows to produce the shard plan (boundaries), per-kind step counts and the
# final machine state at interpreter-equivalent semantics.
# ---------------------------------------------------------------------------

_AOT_LIBS: dict = {}


def _aot_lib(vm: VMState):
    from . import aotgen

    digest = hashlib.sha256(repr(sorted(vm.program.items())).encode()).hexdigest()
    lib = _AOT_LIBS.get(digest)
    if lib is not None:
        return lib
    so = aotgen.build(vm.program, vm.entry)
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.emu_new.restype = ctypes.c_void_p
    lib.emu_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    lib.emu_free.argtypes = [ctypes.c_void_p]
    lib.emu_load_program.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64,
    ]
    lib.emu_init_memory.argtypes = [
        ctypes.c_void_p, ctypes.c_uint32,
        np.ctypeslib.ndpointer(np.uint32), ctypes.c_int64,
    ]
    lib.emu_state.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint32)
    ] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint32)]
    lib.emu_regs.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.uint32),
        np.ctypeslib.ndpointer(np.uint32),
    ]
    lib.aot_preflight.restype = ctypes.c_int64
    lib.aot_preflight.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64),                 # cost
        np.ctypeslib.ndpointer(np.uint32),                # sys codes
        np.ctypeslib.ndpointer(np.int32), ctypes.c_int64,  # sys kinds, n
        ctypes.c_int64, ctypes.c_int64,                   # max_cells, max_sps
        np.ctypeslib.ndpointer(np.int64), ctypes.c_int64,  # bounds, cap
        ctypes.POINTER(ctypes.c_int64),                   # n_bounds_out
        np.ctypeslib.ndpointer(np.int64),                 # kind counts
    ]
    _AOT_LIBS[digest] = lib
    return lib


def aot_available(vm: VMState) -> bool:
    try:
        return _aot_lib(vm) is not None
    except Exception:
        return False


def run_preflight(vm: VMState, cost_by_kind: dict | None = None,
                  max_cells_per_shard: int | None = None,
                  max_steps_per_shard: int | None = None,
                  max_steps: int = 1 << 24):
    """Execute the guest through the compiled AOT blocks. Returns
    (bounds, kind_counts (len KINDS), n_steps, state dict). ``bounds``
    replicates zkvm/shard.py::plan_boundaries exactly (leading 0 and
    trailing n included)."""
    lib = _aot_lib(vm)
    if lib is None:
        raise RuntimeError("no C++ toolchain for the AOT preflight")
    from .state import SYSCALL_KIND_NAMES

    cost = np.full(len(KINDS), 32, np.int64)
    for k, c in (cost_by_kind or {}).items():
        cost[int(k)] = int(c)
    codes = np.array(sorted(SYSCALL_KIND_NAMES), np.uint32)
    skinds = np.array(
        [KINDS.index(SYSCALL_KIND_NAMES[c]) for c in sorted(SYSCALL_KIND_NAMES)],
        np.int32,
    )
    h = lib.emu_new(vm.entry, vm.regs[2])
    try:
        prog_items = sorted(vm.program.items())
        base_w = prog_items[0][0]
        words = np.zeros(prog_items[-1][0] - base_w + 1, np.uint32)
        for w, word in prog_items:
            words[w - base_w] = word
        lib.emu_load_program(h, base_w << 2, words, len(words))
        for waddr, val in sorted(vm.mem_init.items()):
            lib.emu_init_memory(h, waddr << 2, np.array([val], np.uint32), 1)
        cap = 1 << 20
        bounds = np.zeros(cap, np.int64)
        counts = np.zeros(len(KINDS), np.int64)
        nb = ctypes.c_int64(0)
        got = lib.aot_preflight(
            h, max_steps, cost, codes, skinds, len(codes),
            -1 if max_cells_per_shard is None else int(max_cells_per_shard),
            -1 if max_steps_per_shard is None else int(max_steps_per_shard),
            bounds, cap, ctypes.byref(nb), counts,
        )
        if got == -2:
            raise UnsupportedSyscall("preflight: unsupported syscall")
        if got < 0:
            raise RuntimeError(f"aot preflight failed (code {got})")
        if nb.value > cap:
            # the C side keeps counting past the buffer; truncated
            # boundaries would be silently WRONG — refuse instead
            # (callers fall back to the trace planner)
            raise RuntimeError(
                f"preflight produced {nb.value} boundaries (> buffer {cap})"
            )
        pc = ctypes.c_uint32(); cyc = ctypes.c_uint32()
        halted = ctypes.c_int(); exit_code = ctypes.c_uint32()
        lib.emu_state(h, ctypes.byref(pc), ctypes.byref(cyc),
                      ctypes.byref(halted), ctypes.byref(exit_code))
        regs = np.zeros(32, np.uint32)
        reg_ts = np.zeros(32, np.uint32)
        lib.emu_regs(h, regs, reg_ts)
        state = {
            "pc": int(pc.value), "cycle": int(cyc.value),
            "halted": bool(halted.value), "exit_code": int(exit_code.value),
            "regs": regs,
        }
        all_bounds = [0] + [int(b) for b in bounds[: nb.value]] + [int(got)]
        return all_bounds, counts, int(got), state
    finally:
        lib.emu_free(h)
