"""Table circuits: program ROM, range/shift lookup tables, RAM init/final,
and the GlobalState bootstrap chip.

Role mirror of the reference's table circuits (ceno_zkvm src/tables/,
SURVEY.md §2.3): lookup tables provide multiplicities against chip-side
lk_records; the register/memory tables implement RAM init/final set equality
(NonVolatileTable mirror — round 1 uses a static memory window, the dynamic
jagged tables come with rotation support); the GlobalChip emits the
bootstrap write / final read of the GlobalState chain bound to public values.

Copy of ``ceno_tpu/zkvm/tables.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fields import babybear as bb
from .chips import field_ctx
from ..gkr.circuit_builder import (
    CircuitBuilder,
    StructuralSpec,
    RAM_GLOBAL_STATE,
    RAM_REGISTER,
    RAM_MEMORY,
    LK_RANGE16,
    LK_RANGE12,
    LK_RANGE8,
    LK_RANGE5,
    LK_RANGE4,
    LK_INSTRUCTION,
    LK_SHL,
    LK_SRL,
    LK_POW2,
    LK_AND8,
    LK_OR8,
    LK_XOR8,
)
from ..gkr.chip import compile_chip, CompiledChip
from ..mle import expression as E
from ..emulator.state import Platform
from ..emulator.rv32im import decode
from .layout import PV_INIT_PC, PV_INIT_CYCLE, PV_END_PC, PV_END_CYCLE
from .chips.opcodes import encode_imm

MASK16 = 0xFFFF


@dataclass
class ZKVMConfig:
    """Table sizing knobs (shrunk in CPU tests, full-size in production)."""

    shl_x_bits: int = 16        # SHL table covers x < 2^shl_x_bits, s < 16
    mem_words_log: int = 10     # unused since the dynamic heap (kept for API compat)
    hints_words_log: int = 8    # private-input (hints) window size (words)
    stack_words_log: int = 8    # unused since the dynamic stack (kept for API compat)
    platform: Platform = field(default_factory=Platform)


@dataclass
class TableDef:
    name: str
    cb: CircuitBuilder
    compiled: CompiledChip
    n_rows: int                 # power of two; num_instances for the chip
    fixed_fn: object            # () -> (n_fixed, n_rows) canonical
    assign_fn: object           # (ctx) -> dict[str, np.ndarray]
    gate: str = "always"        # 'always' | 'first' | 'last' (shard gating:
    # RAM init tables only run in the first shard, final tables in the last
    # — the reference's with/without one-time-init pk split, keygen.rs:19-49)

    def assign(self, ctx) -> np.ndarray:
        cols = self.assign_fn(ctx)
        out = np.zeros((len(self.cb.wit_names), self.n_rows), np.uint64)
        for i, name in enumerate(self.cb.wit_names):
            out[i] = np.asarray(cols[name], np.uint64) % np.uint64(field_ctx.P)
        return out


@dataclass
class WitgenCtx:
    """Everything table witgen needs: lookup counts + final VM state."""

    lk_counts: dict             # tag -> {tuple: count}
    vm: object                  # final VMState
    program_words: dict         # word_addr -> insn word
    config: ZKVMConfig


def _range_table(name: str, tag: int, bits: int) -> TableDef:
    cb = CircuitBuilder(name)
    mult = cb.create_witin("mult")
    val = cb.create_structural(StructuralSpec("incremental", start=0, step=1))
    cb.lk_table_record(tag, mult, [val])

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(tag, {})
        m = np.zeros(1 << bits, np.uint64)
        for key, c in counts.items():
            v = int(key[0])
            assert v < (1 << bits), f"{name}: lookup value {v} out of range"
            m[v] = c
        return {"mult": m}

    return TableDef(name, cb, compile_chip(cb), 1 << bits, lambda: np.zeros((0, 1 << bits), np.uint64), assign)


def _shl_table(cfg: ZKVMConfig) -> TableDef:
    xb = cfg.shl_x_bits
    n = 1 << (xb + 4)
    cb = CircuitBuilder("shl_table")
    mult = cb.create_witin("mult")
    x = cb.create_fixed("x")
    s = cb.create_fixed("s")
    lo = cb.create_fixed("lo")
    hi = cb.create_fixed("hi")
    cb.lk_table_record(LK_SHL, mult, [x, s, lo, hi])

    def fixed():
        idx = np.arange(n, dtype=np.uint64)
        xv = idx >> 4
        sv = idx & 15
        prod = xv << sv
        return np.stack([xv, sv, prod & MASK16, (prod >> 16) & MASK16])

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(LK_SHL, {})
        m = np.zeros(n, np.uint64)
        for key, c in counts.items():
            xv, sv = int(key[0]), int(key[1])
            assert xv < (1 << xb), f"shl: x {xv} exceeds table"
            m[(xv << 4) | sv] = c
        return {"mult": m}

    return TableDef("shl_table", cb, compile_chip(cb), n, fixed, assign)


def _srl_table(cfg: ZKVMConfig) -> TableDef:
    """(x u16, s<16) -> (x >> s, x mod 2^s): right shifts + remainders."""
    xb = cfg.shl_x_bits
    n = 1 << (xb + 4)
    cb = CircuitBuilder("srl_table")
    mult = cb.create_witin("mult")
    x = cb.create_fixed("x")
    s = cb.create_fixed("s")
    q = cb.create_fixed("q")
    r = cb.create_fixed("r")
    cb.lk_table_record(LK_SRL, mult, [x, s, q, r])

    def fixed():
        idx = np.arange(n, dtype=np.uint64)
        xv = idx >> 4
        sv = idx & 15
        return np.stack([xv, sv, xv >> sv, xv & ((np.uint64(1) << sv) - 1)])

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(LK_SRL, {})
        m = np.zeros(n, np.uint64)
        for key, c in counts.items():
            xv, sv = int(key[0]), int(key[1])
            assert xv < (1 << xb), f"srl: x {xv} exceeds table"
            m[(xv << 4) | sv] = c
        return {"mult": m}

    return TableDef("srl_table", cb, compile_chip(cb), n, fixed, assign)


def _pow2_table() -> TableDef:
    """s in [0, 16] -> 2^s."""
    n = 32
    cb = CircuitBuilder("pow2_table")
    mult = cb.create_witin("mult")
    s = cb.create_structural(StructuralSpec("incremental", start=0, step=1))
    p2v = cb.create_fixed("pow")
    cb.lk_table_record(LK_POW2, mult, [s, p2v])

    def fixed():
        out = np.zeros((1, n), np.uint64)
        for i in range(17):
            out[0, i] = 1 << i
        return out

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(LK_POW2, {})
        m = np.zeros(n, np.uint64)
        for key, c in counts.items():
            sv = int(key[0])
            assert sv <= 16
            m[sv] = c
        return {"mult": m}

    return TableDef("pow2_table", cb, compile_chip(cb), n, fixed, assign)


def _byte_pair_table(name: str, tag: int, op) -> TableDef:
    """(a u8, b u8) -> op(a, b): AND/OR/XOR byte tables (2^16 rows)."""
    n = 1 << 16
    cb = CircuitBuilder(name)
    mult = cb.create_witin("mult")
    a = cb.create_fixed("a")
    b = cb.create_fixed("b")
    o = cb.create_fixed("o")
    cb.lk_table_record(tag, mult, [a, b, o])

    def fixed():
        idx = np.arange(n, dtype=np.uint64)
        av = idx >> 8
        bv = idx & 0xFF
        return np.stack([av, bv, op(av, bv)])

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(tag, {})
        m = np.zeros(n, np.uint64)
        for key, c in counts.items():
            m[(int(key[0]) << 8) | int(key[1])] = c
        return {"mult": m}

    return TableDef(name, cb, compile_chip(cb), n, fixed, assign)


def _program_table(program_words: dict) -> TableDef:
    entries = sorted(program_words.items())
    n = max(2, 1 << (len(entries) - 1).bit_length())
    cb = CircuitBuilder("program")
    mult = cb.create_witin("mult")
    cols = [cb.create_fixed(nm) for nm in
            ("pc", "kind", "rd", "rs1", "rs2", "imm_lo", "imm_hi", "imm_f")]
    cb.lk_table_record(LK_INSTRUCTION, mult, cols)

    def fixed():
        out = np.zeros((8, n), np.uint64)
        for i, (waddr, word) in enumerate(entries):
            d = decode(word)
            il, ih, iff = encode_imm(d.kind, d.imm)
            if d.name == "ECALL":
                il = ih = iff = 0
            out[:, i] = [waddr * 4, d.kind, d.rd, d.rs1, d.rs2, il, ih, iff]
        return out

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(LK_INSTRUCTION, {})
        m = np.zeros(n, np.uint64)
        fx = fixed()
        key_to_row = {tuple(int(v) for v in fx[:, i]): i for i in range(len(entries))}
        for key, c in counts.items():
            row = key_to_row.get(tuple(int(v) for v in key))
            assert row is not None, f"fetch of unknown instruction {key}"
            m[row] = c
        return {"mult": m}

    return TableDef("program", cb, compile_chip(cb), n, fixed, assign)


def _register_init_table(cfg: ZKVMConfig) -> TableDef:
    cb = CircuitBuilder("reg_init")
    rid = cb.create_structural(StructuralSpec("incremental", start=0, step=1))
    init_lo = cb.create_fixed("init_lo")
    init_hi = cb.create_fixed("init_hi")
    unused = cb.create_witin("unused")
    cb.require_zero("unused_zero", unused)
    cb.write_record([E.Const(RAM_REGISTER), rid, init_lo, init_hi, E.Const(0)])

    def fixed():
        out = np.zeros((2, 32), np.uint64)
        sp = cfg.platform.stack_top - 0x100
        out[0, 2] = sp & MASK16
        out[1, 2] = sp >> 16
        return out

    def assign(ctx: WitgenCtx):
        return {"unused": np.zeros(32, np.uint64)}

    return TableDef(
        "reg_init", cb, compile_chip(cb), 32, fixed, assign, gate="first"
    )


def _register_final_table(cfg: ZKVMConfig) -> TableDef:
    cb = CircuitBuilder("reg_final")
    rid = cb.create_structural(StructuralSpec("incremental", start=0, step=1))
    f_lo = cb.create_witin("final_lo")
    f_hi = cb.create_witin("final_hi")
    f_ts = cb.create_witin("final_ts")
    cb.read_record([E.Const(RAM_REGISTER), rid, f_lo, f_hi, f_ts])

    def assign(ctx: WitgenCtx):
        vm = ctx.vm
        vals = np.array(vm.regs, np.uint64)
        ts = np.array(vm.reg_ts, np.uint64)
        return {
            "final_lo": vals & MASK16,
            "final_hi": vals >> 16,
            "final_ts": ts,
        }

    return TableDef(
        "reg_final", cb, compile_chip(cb), 32,
        lambda: np.zeros((0, 32), np.uint64), assign, gate="last",
    )


def _memory_init_table(
    name: str, base_word: int, words_log: int, private_init: bool
) -> TableDef:
    """RAM init half over a static word-address window (first shard only).

    ``private_init``: init values are witness columns (the hints region — the
    guest's private input, ceno_rt MMIO mirror) instead of fixed columns."""
    n = 1 << words_log
    cb = CircuitBuilder(name)
    addr = cb.create_structural(StructuralSpec("incremental", start=base_word, step=1))
    if private_init:
        init_lo = cb.create_witin("init_lo")
        init_hi = cb.create_witin("init_hi")
    else:
        init_lo = cb.create_fixed("init_lo")
        init_hi = cb.create_fixed("init_hi")
        unused = cb.create_witin("unused")
        cb.require_zero("unused_zero", unused)
    cb.write_record([E.Const(RAM_MEMORY), addr, init_lo, init_hi, E.Const(0)])

    def fixed():
        return np.zeros((0 if private_init else 2, n), np.uint64)

    def assign(ctx: WitgenCtx):
        vm = ctx.vm
        cols = {}
        if private_init:
            cols["init_lo"] = np.zeros(n, np.uint64)
            cols["init_hi"] = np.zeros(n, np.uint64)
            for waddr, v0 in vm.mem_init.items():
                i = waddr - base_word
                if 0 <= i < n:
                    cols["init_lo"][i] = v0 & MASK16
                    cols["init_hi"][i] = v0 >> 16
        else:
            cols["unused"] = np.zeros(n, np.uint64)
            for waddr in vm.mem_init:
                i = waddr - base_word
                assert not 0 <= i < n, (
                    f"{name}: pre-initialized data at {waddr << 2:#x} needs a "
                    "private-init window (program-image fixed data: TODO)"
                )
        return cols

    return TableDef(
        name, cb, compile_chip(cb), n, fixed, assign, gate="first"
    )


def _memory_final_table(name: str, base_word: int, words_log: int) -> TableDef:
    """RAM final half over a static window (last shard only)."""
    n = 1 << words_log
    cb = CircuitBuilder(name)
    addr = cb.create_structural(StructuralSpec("incremental", start=base_word, step=1))
    f_lo = cb.create_witin("final_lo")
    f_hi = cb.create_witin("final_hi")
    f_ts = cb.create_witin("final_ts")
    cb.read_record([E.Const(RAM_MEMORY), addr, f_lo, f_hi, f_ts])

    def assign(ctx: WitgenCtx):
        vm = ctx.vm
        cols = {
            "final_lo": np.zeros(n, np.uint64),
            "final_hi": np.zeros(n, np.uint64),
            "final_ts": np.zeros(n, np.uint64),
        }
        for waddr, v0 in vm.mem_init.items():
            i = waddr - base_word
            if 0 <= i < n:
                cols["final_lo"][i] = v0 & MASK16
                cols["final_hi"][i] = v0 >> 16
        for waddr in vm.touched:
            i = waddr - base_word
            if not 0 <= i < n:
                continue
            v = vm.mem.get(waddr, 0)
            cols["final_lo"][i] = v & MASK16
            cols["final_hi"][i] = v >> 16
            cols["final_ts"][i] = vm.mem_ts.get(waddr, 0)
        return cols

    return TableDef(
        name, cb, compile_chip(cb), n,
        lambda: np.zeros((0, n), np.uint64), assign, gate="last",
    )


def _prog_data_tables(data_image: dict) -> list:
    """Program-image RAM tables: the guest ELF's static data (.rodata/.data/
    .bss, elf.rs:206-240 "static program data") as FIXED init columns.

    Unlike the window tables the addresses are arbitrary (one row per image
    word, possibly with gaps between segments), so ``addr`` is itself a fixed
    column committed at keygen — the image is part of the program identity."""
    addrs = np.array(sorted(data_image), np.uint64)
    n = 1 << max(1, int(addrs.shape[0] - 1).bit_length())
    pad_addrs = np.zeros(n, np.uint64)
    pad_addrs[: addrs.shape[0]] = addrs
    if addrs.shape[0] < n:
        # pad rows continue past the last address (distinct addrs keep the
        # init-write multiset collision-free)
        pad_addrs[addrs.shape[0]:] = addrs[-1] + np.arange(
            1, n - addrs.shape[0] + 1, dtype=np.uint64
        )
    vals = np.array([data_image[int(a)] for a in addrs], np.uint64)
    pad_vals = np.zeros(n, np.uint64)
    pad_vals[: addrs.shape[0]] = vals

    cb_i = CircuitBuilder("prog_data_init")
    addr_i = cb_i.create_fixed("addr")
    init_lo = cb_i.create_fixed("init_lo")
    init_hi = cb_i.create_fixed("init_hi")
    unused = cb_i.create_witin("unused")
    cb_i.require_zero("unused_zero", unused)
    cb_i.write_record([E.Const(RAM_MEMORY), addr_i, init_lo, init_hi, E.Const(0)])

    def fixed_i():
        return np.stack([pad_addrs, pad_vals & MASK16, pad_vals >> np.uint64(16)])

    cb_f = CircuitBuilder("prog_data_final")
    addr_f = cb_f.create_fixed("addr")
    f_lo = cb_f.create_witin("final_lo")
    f_hi = cb_f.create_witin("final_hi")
    f_ts = cb_f.create_witin("final_ts")
    cb_f.read_record([E.Const(RAM_MEMORY), addr_f, f_lo, f_hi, f_ts])

    def assign_f(ctx: WitgenCtx):
        vm = ctx.vm
        lo, hi, ts = pad_vals & MASK16, pad_vals >> np.uint64(16), np.zeros(n, np.uint64)
        lo, hi = lo.copy(), hi.copy()
        for i, a in enumerate(pad_addrs.tolist()):
            if a in vm.touched:
                v = vm.mem.get(a, 0)
                lo[i], hi[i] = v & MASK16, v >> 16
                ts[i] = vm.mem_ts.get(a, 0)
        return {"final_lo": lo, "final_hi": hi, "final_ts": ts}

    return [
        TableDef("prog_data_init", cb_i, compile_chip(cb_i), n, fixed_i,
                 lambda ctx: {"unused": np.zeros(n, np.uint64)}, gate="first"),
        TableDef("prog_data_final", cb_f, compile_chip(cb_f), n,
                 lambda: np.stack([pad_addrs]), assign_f, gate="last"),
    ]


def _keccak_rc_table() -> TableDef:
    """Round-constant bytes keyed by round index (also range-binds the
    keccak core chip's round column to [0, 24))."""
    from ..emulator.keccak import RC, ROUNDS
    from .chips.keccak import LK_KECCAK_RC

    n = 32
    cb = CircuitBuilder("keccak_rc")
    mult = cb.create_witin("mult")
    rnd = cb.create_fixed("round")
    rcs = [cb.create_fixed(f"rc{k}") for k in range(8)]
    cb.lk_table_record(LK_KECCAK_RC, mult, [rnd] + rcs)

    def fixed():
        rows = np.zeros((9, n), np.uint64)
        rows[0] = np.arange(n, dtype=np.uint64)
        for r in range(ROUNDS):
            for k in range(8):
                rows[1 + k, r] = (RC[r] >> (8 * k)) & 0xFF
        # pad rows keep distinct round keys (24..31) with rc = 0: a zero
        # multiplicity row can never satisfy a real round's lookup
        return rows

    def assign(ctx: WitgenCtx):
        counts = ctx.lk_counts.get(LK_KECCAK_RC, {})
        m = np.zeros(n, np.uint64)
        for key, c in counts.items():
            m[int(key[0])] = c
        return {"mult": m}

    return TableDef("keccak_rc", cb, compile_chip(cb), n, fixed, assign)


def _global_chip() -> TableDef:
    cb = CircuitBuilder("global")
    unused = cb.create_witin("unused")
    cb.require_zero("unused_zero", unused)
    cb.write_record([
        E.Const(RAM_GLOBAL_STATE), E.Instance(PV_INIT_PC), E.Instance(PV_INIT_CYCLE)
    ])
    cb.read_record([
        E.Const(RAM_GLOBAL_STATE), E.Instance(PV_END_PC), E.Instance(PV_END_CYCLE)
    ])

    def assign(ctx: WitgenCtx):
        return {"unused": np.zeros(1, np.uint64)}

    return TableDef("global", cb, compile_chip(cb), 1, lambda: np.zeros((0, 1), np.uint64), assign)


def build_tables(
    program_words: dict, cfg: ZKVMConfig, data_image: dict | None = None
) -> list[TableDef]:
    if data_image:
        from .chips.dyn_ram import dyn_regions

        windows = memory_windows(cfg) + [
            (lo, hi - lo) for lo, hi, _ in dyn_regions(cfg)
        ]
        count = len(data_image)
        n_pad = (1 << max(1, (count - 1).bit_length())) - count
        check = set(data_image) | {
            max(data_image) + i for i in range(1, n_pad + 1)
        }
        for waddr in check:
            if any(b <= waddr < b + sz for b, sz in windows):
                raise ValueError(
                    f"program image word {waddr << 2:#x} overlaps a RAM window"
                )
    return (_prog_data_tables(data_image) if data_image else []) + [
        _program_table(program_words),
        _range_table("range16", LK_RANGE16, 16),
        _range_table("range12", LK_RANGE12, 12),
        _range_table("range8", LK_RANGE8, 8),
        _range_table("range5", LK_RANGE5, 5),
        _range_table("range4", LK_RANGE4, 4),
        _shl_table(cfg),
        _srl_table(cfg),
        _pow2_table(),
        _keccak_rc_table(),
        _byte_pair_table("and8", LK_AND8, lambda a, b: a & b),
        _byte_pair_table("or8", LK_OR8, lambda a, b: a | b),
        _byte_pair_table("xor8", LK_XOR8, lambda a, b: a ^ b),
        _register_init_table(cfg),
        _register_final_table(cfg),
        _memory_init_table(
            "hints_init", cfg.platform.hints_start >> 2, cfg.hints_words_log, True
        ),
        _memory_final_table(
            "hints_final", cfg.platform.hints_start >> 2, cfg.hints_words_log
        ),
        _global_chip(),
    ]


def memory_windows(cfg: ZKVMConfig) -> list:
    """[(base_word, n_words)] covered by STATIC RAM tables (hints only —
    heap and stack are dynamic, chips/dyn_ram.py)."""
    return [
        (cfg.platform.hints_start >> 2, 1 << cfg.hints_words_log),
    ]
