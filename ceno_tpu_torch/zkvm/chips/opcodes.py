"""Opcode chips: one circuit + witgen per rv32im opcode family.

Role mirror of the reference's instruction circuits (ceno_zkvm
src/instructions/riscv/, SURVEY.md §2.3): each chip constrains one opcode's
semantics over the shared record conventions (GlobalState chain, register
RAM, program-fetch lookup), and its witgen fills rows from StepRecords.

Round-1 coverage: ADD SUB ADDI LUI BEQ BNE JAL SLLI LW SW ECALL-HALT —
the set exercised by the fibonacci and memsum guests. The remaining rv32im
opcodes follow the same templates (tracked as framework TODO).

Copy of ``ceno_tpu/zkvm/chips/opcodes.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...fields import babybear as bb
from . import field_ctx
from ...gkr.circuit_builder import CircuitBuilder, LK_SHL, LK_RANGE4
from ...gkr.chip import compile_chip, CompiledChip
from ...mle import expression as E
from ...emulator.rv32im import K
from ...emulator.state import Platform
from ..layout import (
    PV_END_PC, PV_END_CYCLE, PV_EXIT_CODE_LO, PV_EXIT_CODE_HI,
)
from . import common as C

MASK16 = 0xFFFF


@dataclass
class TraceView:
    """Columnar slice of the step trace for one chip (its rows only).

    Witgen is vectorized end-to-end: one pass builds the global columns (or
    the native emulator emits them directly); chips see numpy views. This is
    the rayon-parallel assign_instances mirror (instructions.rs:135-204)."""

    n: int
    pc: np.ndarray
    ts: np.ndarray
    rs1_id: np.ndarray
    rs1_val: np.ndarray
    rs1_pts: np.ndarray
    rs2_id: np.ndarray
    rs2_val: np.ndarray
    rs2_pts: np.ndarray
    rd_id: np.ndarray
    rd_prev: np.ndarray
    rd_val: np.ndarray
    rd_pts: np.ndarray
    mem_waddr: np.ndarray
    mem_prev: np.ndarray
    mem_val: np.ndarray
    mem_pts: np.ndarray
    imm: np.ndarray        # int64, sign-extended (unsigned for LUI/AUIPC)
    kind: np.ndarray
    # syscall bulk memory ops: sys_idx[i] = row into the (n_sys, 50) block
    # arrays for step i (-1 = no block). Keccak steps are re-kinded to
    # K["SYS_KECCAK"] so they route to the keccak ecall chip.
    sys_idx: np.ndarray = None
    sys_addr: np.ndarray = None   # (n_sys, 50) word addresses
    sys_prev: np.ndarray = None   # (n_sys, 50) values before
    sys_val: np.ndarray = None    # (n_sys, 50) values after
    sys_pts: np.ndarray = None    # (n_sys, 50) prev timestamps

    def __post_init__(self):
        if self.sys_idx is None:
            self.sys_idx = np.full(self.n, -1, np.int64)
        if self.sys_addr is None:
            z = np.zeros((0, 50), np.int64)
            self.sys_addr, self.sys_prev = z, z.copy()
            self.sys_val, self.sys_pts = z.copy(), z.copy()

    @staticmethod
    def from_records(records) -> "TraceView":
        from ...emulator.rv32im import K as _K

        n = len(records)
        cols = {f: np.zeros(n, np.int64) for f in (
            "pc", "ts", "rs1_id", "rs1_val", "rs1_pts", "rs2_id", "rs2_val",
            "rs2_pts", "rd_id", "rd_prev", "rd_val", "rd_pts", "mem_waddr",
            "mem_prev", "mem_val", "mem_pts", "imm", "kind",
        )}
        cols["mem_waddr"] -= 1
        sys_idx = np.full(n, -1, np.int64)
        sys_rows = []
        for i, s in enumerate(records):
            cols["pc"][i] = s.pc
            cols["ts"][i] = s.cycle
            cols["kind"][i] = s.insn.kind
            cols["imm"][i] = s.insn.imm
            if s.rs1:
                cols["rs1_id"][i], cols["rs1_val"][i], cols["rs1_pts"][i] = s.rs1
            if s.rs2:
                cols["rs2_id"][i], cols["rs2_val"][i], cols["rs2_pts"][i] = s.rs2
            if s.rd:
                (cols["rd_id"][i], cols["rd_prev"][i], cols["rd_val"][i],
                 cols["rd_pts"][i]) = s.rd
            if s.mem:
                (cols["mem_waddr"][i], cols["mem_prev"][i], cols["mem_val"][i],
                 cols["mem_pts"][i]) = s.mem
            if s.sys_mem is not None:
                from ...emulator.state import SYSCALL_KIND_NAMES

                code = s.rs1[1] if s.rs1 else 0
                cols["kind"][i] = _K[
                    SYSCALL_KIND_NAMES.get(code, "SYS_KECCAK")
                ]
                sys_idx[i] = len(sys_rows)
                # block arrays are fixed-width 50; shorter syscalls pad
                pad = [(0, 0, 0, 0)] * (50 - len(s.sys_mem))
                sys_rows.append(list(s.sys_mem) + pad)
        view = TraceView(n=n, sys_idx=sys_idx, **{k: v for k, v in cols.items()})
        if sys_rows:
            block = np.array(sys_rows, np.int64)  # (n_sys, 50, 4)
            view.sys_addr = block[:, :, 0]
            view.sys_prev = block[:, :, 1]
            view.sys_val = block[:, :, 2]
            view.sys_pts = block[:, :, 3]
        return view

    def select(self, idx: np.ndarray) -> "TraceView":
        sub = TraceView(
            n=len(idx),
            **{
                f: getattr(self, f)[idx]
                for f in self.__dataclass_fields__
                if f not in ("n", "sys_idx", "sys_addr", "sys_prev",
                             "sys_val", "sys_pts")
            },
        )
        old = self.sys_idx[idx]
        have = old >= 0
        sub.sys_idx = np.where(have, np.cumsum(have) - 1, -1)
        keep = old[have]
        sub.sys_addr = self.sys_addr[keep]
        sub.sys_prev = self.sys_prev[keep]
        sub.sys_val = self.sys_val[keep]
        sub.sys_pts = self.sys_pts[keep]
        return sub


@dataclass
class ChipDef:
    name: str
    kinds: tuple
    cb: CircuitBuilder
    compiled: CompiledChip
    assign_fn: object  # callable(view: TraceView) -> dict[str, np.ndarray]
    rows_per_step: int = 1  # witness rows per selected step (keccak core: 24)

    def assign(self, view: TraceView, pad_to: int = 0) -> np.ndarray:
        """Fill the chip matrix; ``pad_to`` allocates the (pow2-padded)
        final width up front so witgen skips a second full copy."""
        cols = self.assign_fn(view)
        n = view.n * self.rows_per_step
        out = np.zeros((len(self.cb.wit_names), max(pad_to, n)), np.uint64)
        for i, name in enumerate(self.cb.wit_names):
            if name in cols:
                out[i, :n] = np.asarray(cols[name], np.uint64) % np.uint64(
                    field_ctx.P)
        missing = set(self.cb.wit_names) - set(cols)
        extra = set(cols) - set(self.cb.wit_names)
        assert not missing, f"{self.name}: unassigned cols {missing}"
        assert not extra, f"{self.name}: unknown cols {extra}"
        return out


# ---------------------------------------------------------------------------
# witgen helpers (fill the columns created by the common.py builders)
# ---------------------------------------------------------------------------

def _limbs(v):
    v = np.asarray(v, np.uint64)
    return v & MASK16, v >> 16


def _batch_inv(v: np.ndarray) -> np.ndarray:
    """Vectorized field inverses (0 -> 0): Montgomery batch inversion with
    log-doubling prefix/suffix product scans (values < 2^31, so uint64
    products never overflow) and ONE modular pow for the running total."""
    v = np.asarray(v, np.uint64)
    n = len(v)
    if n == 0:
        return np.zeros(0, np.uint64)
    p = np.uint64(field_ctx.P)
    if field_ctx.INV is not None:
        # non-BabyBear field: uint64 products below would overflow
        w = np.where(v == 0, np.uint64(1), v % p)
        return np.where(v == 0, np.uint64(0), field_ctx.INV(w))
    w = np.where(v == 0, np.uint64(1), v % p)

    def _scan(x):  # inclusive prefix products mod p, O(log n) passes
        acc = x.copy()
        shift = 1
        while shift < n:
            acc[shift:] = acc[shift:] * acc[:-shift] % p
            shift <<= 1
        return acc

    pref = _scan(w)
    suff = _scan(w[::-1])[::-1]
    total_inv = np.uint64(pow(int(pref[-1]), field_ctx.P - 2, field_ctx.P))
    left = np.concatenate([np.ones(1, np.uint64), pref[:-1]])
    right = np.concatenate([suff[1:], np.ones(1, np.uint64)])
    out = left * right % p * total_inv % p
    return np.where(v == 0, np.uint64(0), out)


def _ts_cols(name, prev, cur):
    d = np.asarray(cur, np.int64) - np.asarray(prev, np.int64) - 1
    assert (d >= 0).all(), f"{name}: ts order violated"
    return {f"{name}_dlo": d & MASK16, f"{name}_dhi": d >> 16}


def _state_cols(v: TraceView):
    return {
        "pc": v.pc.astype(np.uint64),
        "ts": v.ts.astype(np.uint64),
    }


def _reg_read_cols(name, which, v: TraceView, slot_ts, with_id=True):
    """which: 'rs1' or 'rs2' (the trace slot to read from)."""
    ids = getattr(v, f"{which}_id").astype(np.uint64)
    vals = getattr(v, f"{which}_val").astype(np.uint64)
    pts = getattr(v, f"{which}_pts").astype(np.uint64)
    lo, hi = _limbs(vals)
    out = {f"{name}_lo": lo, f"{name}_hi": hi, f"{name}_pts": pts}
    if with_id:
        out[f"{name}_id"] = ids
    out.update(_ts_cols(name, pts, slot_ts))
    return out


def _rd_cols(v: TraceView, slot_ts):
    ids = v.rd_id.astype(np.uint64)
    prev = v.rd_prev.astype(np.uint64)
    new = v.rd_val.astype(np.uint64)
    pts = v.rd_pts.astype(np.uint64)
    lo, hi = _limbs(new)
    plo, phi = _limbs(prev)
    z = (ids == 0).astype(np.uint64)
    zinv = _batch_inv(ids)
    out = {
        "rd_id": ids, "rd_lo": lo, "rd_hi": hi, "rd_plo": plo, "rd_phi": phi,
        "rd_pts": pts, "rd_iszero": z, "rd_idinv": zinv,
    }
    out.update(_ts_cols("rd", pts, slot_ts))
    return out


def encode_imm_vec(kind: int, imm: np.ndarray):
    """Vectorized encode_imm for one instruction kind."""
    if kind == K["LUI"]:
        v = (imm.astype(np.int64) >> 12) & 0xFFFFF
        return (v & MASK16).astype(np.uint64), (v >> 16).astype(np.uint64), v.astype(np.uint64)
    u32 = imm.astype(np.int64) & 0xFFFFFFFF
    field = field_ctx.enc_signed(imm)
    return (
        (u32 & MASK16).astype(np.uint64),
        ((u32 >> 16) & MASK16).astype(np.uint64),
        field.astype(np.uint64),
    )


def encode_imm(kind, imm):
    if kind == K["LUI"]:
        v = (imm >> 12) & 0xFFFFF
        return v & MASK16, v >> 16, v
    u32 = imm & 0xFFFFFFFF
    field = imm % field_ctx.P
    return u32 & MASK16, (u32 >> 16) & MASK16, field


# ---------------------------------------------------------------------------
# Chip constructors
# ---------------------------------------------------------------------------

def _add_sub_chip(name: str, kind: int, is_sub: bool) -> ChipDef:
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    rd = C.write_rd(cb, st)
    if is_sub:
        # rs1 - rs2 = rd  <=>  rd + rs2 = rs1 (borrows become carries)
        C.limb_add(cb, "sub", rd.lo, rd.hi, rs2.lo, rs2.hi, rs1.lo, rs1.hi,
                   gate=rd.gate())
    else:
        C.limb_add(cb, "add", rs1.lo, rs1.hi, rs2.lo, rs2.hi, rd.lo, rd.hi,
                   gate=rd.gate())
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, kind, rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        cols.update(_rd_cols(v, ts + 2))
        a = v.rs1_val.astype(np.uint64)
        b = v.rs2_val.astype(np.uint64)
        a_lo, _ = _limbs(a)
        b_lo, _ = _limbs(b)
        if is_sub:
            # carries of rd + rs2 = rs1
            r_lo = cols["rd_lo"]
            c0 = ((r_lo + b_lo) >> 16) & 1
            c1 = ((cols["rd_hi"] + (b >> 16) + c0) >> 16) & 1
            cols.update({"sub_c0": c0, "sub_c1": c1})
        else:
            c0 = ((a_lo + b_lo) >> 16) & 1
            c1 = (((a >> 16) + (b >> 16) + c0) >> 16) & 1
            cols.update({"add_c0": c0, "add_c1": c1})
        return cols

    return ChipDef(name, (kind,), cb, compile_chip(cb), assign)


def _addi_chip() -> ChipDef:
    cb = CircuitBuilder("addi")
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    C.limb_add(cb, "addi", rs1.lo, rs1.hi, imm_lo, imm_hi, rd.lo, rd.hi,
               gate=rd.gate())
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["ADDI"], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_rd_cols(v, ts + 2))
        il, ih, iff = encode_imm_vec(K["ADDI"], v.imm)
        cols.update({"imm_lo": il, "imm_hi": ih, "imm_f": iff})
        a = v.rs1_val.astype(np.uint64)
        c0 = (((a & MASK16) + il) >> 16) & 1
        c1 = (((a >> 16) + ih + c0) >> 16) & 1
        cols.update({"addi_c0": c0, "addi_c1": c1})
        return cols

    return ChipDef("addi", (K["ADDI"],), cb, compile_chip(cb), assign)


def _lui_chip() -> ChipDef:
    cb = CircuitBuilder("lui")
    st = C.make_state(cb)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")   # limbs of imm20 (= insn imm >> 12)
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    # rd = imm20 << 12: imm20 = l4 + h16*2^4; rd_lo = l4 << 12, rd_hi = h16
    l4 = cb.create_witin("imm_l4")
    h16 = cb.create_witin("imm_h16")
    cb.require_zero("lui_imm_split", imm_f - l4 - h16 * 16)
    cb.assert_u4(l4)
    cb.assert_u16(h16)
    cb.require_zero("lui_lo", rd.gate() * (rd.lo - l4 * (1 << 12)))
    cb.require_zero("lui_hi", rd.gate() * (rd.hi - h16))
    cb.require_zero("lui_imm_limbs", imm_f - imm_lo - imm_hi * (1 << 16))
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["LUI"], rd.reg_id, 0, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_rd_cols(v, ts + 2))
        il, ih, iff = encode_imm_vec(K["LUI"], v.imm)
        cols.update({
            "imm_lo": il, "imm_hi": ih,
            "imm_f": iff, "imm_l4": iff & 0xF, "imm_h16": iff >> 4,
        })
        return cols

    return ChipDef("lui", (K["LUI"],), cb, compile_chip(cb), assign)


def _branch_chip(name: str, kind: int, on_eq: bool) -> ChipDef:
    """BEQ / BNE via limb-pair equality."""
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    z_lo = C.is_zero(cb, "eq_lo", rs1.lo - rs2.lo)
    z_hi = C.is_zero(cb, "eq_hi", rs1.hi - rs2.hi)
    eq = z_lo * z_hi
    taken = eq if on_eq else (1 - eq)
    next_pc = st.pc + 4 + taken * (imm_f - 4)
    C.gs_chain(cb, st, next_pc)
    C.fetch(cb, st, kind, 0, rs1.reg_id, rs2.reg_id, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        il, ih, iff = encode_imm_vec(kind, v.imm)
        cols.update({"imm_lo": il, "imm_hi": ih, "imm_f": iff})
        a = v.rs1_val.astype(np.uint64)
        b = v.rs2_val.astype(np.uint64)
        for nm, d in (("eq_lo", (a & MASK16) + field_ctx.P - (b & MASK16)),
                      ("eq_hi", (a >> 16) + field_ctx.P - (b >> 16))):
            d = d % np.uint64(field_ctx.P)
            cols[f"{nm}_z"] = (d == 0).astype(np.uint64)
            cols[f"{nm}_inv"] = _batch_inv(d)
        return cols

    return ChipDef(name, (kind,), cb, compile_chip(cb), assign)


def _jal_chip() -> ChipDef:
    cb = CircuitBuilder("jal")
    st = C.make_state(cb)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    # rd = pc + 4 (< 2^28): field equality is sound because rd_hi is u16 and
    # rd value < 2^32 while pc+4 < 2^28 — enforce rd_hi < 2^12 to keep the
    # recomposition below p
    cb.assert_u12(rd.hi)
    cb.require_zero("jal_link", rd.gate() * (rd.lo + rd.hi * (1 << 16) - st.pc - 4))
    C.gs_chain(cb, st, st.pc + imm_f)
    C.fetch(cb, st, K["JAL"], rd.reg_id, 0, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_rd_cols(v, ts + 2))
        il, ih, iff = encode_imm_vec(K["JAL"], v.imm)
        cols.update({"imm_lo": il, "imm_hi": ih, "imm_f": iff})
        return cols

    return ChipDef("jal", (K["JAL"],), cb, compile_chip(cb), assign)


def _slli_chip() -> ChipDef:
    """SLLI via the SHL table: (x u16, s<16) -> limbs of x*2^s."""
    cb = CircuitBuilder("slli")
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    s_low = cb.create_witin("sh_low")
    s_flag = cb.create_witin("sh_ge16")
    cb.assert_bit("slli_flag", s_flag)
    cb.assert_u4(s_low)
    cb.require_zero("slli_sh", imm_f - s_low - s_flag * 16)
    ll = cb.create_witin("shl_ll")
    lh = cb.create_witin("shl_lh")
    hl = cb.create_witin("shl_hl")
    hh = cb.create_witin("shl_hh")
    cb.lk_record(LK_SHL, [rs1.lo, s_low, ll, lh])
    cb.lk_record(LK_SHL, [rs1.hi, s_low, hl, hh])
    # r1 = lh + hl < 2^17: split
    r1l = cb.create_witin("shl_r1l")
    r1c = cb.create_witin("shl_r1c")
    cb.assert_bit("slli_r1c", r1c)
    cb.assert_u16(r1l)
    cb.require_zero("slli_r1", lh + hl - r1l - r1c * (1 << 16))
    # before the >=16 shift: res = (ll, r1l); after: (0, ll)
    cb.require_zero("slli_lo", rd.gate() * (rd.lo - (1 - s_flag) * ll))
    cb.require_zero(
        "slli_hi", rd.gate() * (rd.hi - (1 - s_flag) * r1l - s_flag * ll)
    )
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["SLLI"], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_rd_cols(v, ts + 2))
        il, ih, sh = encode_imm_vec(K["SLLI"], v.imm)
        cols.update({
            "imm_lo": il, "imm_hi": ih,
            "imm_f": sh, "sh_low": sh & 15, "sh_ge16": sh >> 4,
        })
        a = v.rs1_val.astype(np.uint64)
        slow = sh & 15
        pl = (a & MASK16) << slow
        ph = (a >> 16) << slow
        ll, lh = pl & MASK16, pl >> 16
        hl, hh = ph & MASK16, ph >> 16
        r1 = lh + hl
        cols.update({
            "shl_ll": ll, "shl_lh": lh, "shl_hl": hl, "shl_hh": hh,
            "shl_r1l": r1 & MASK16, "shl_r1c": r1 >> 16,
        })
        return cols

    return ChipDef("slli", (K["SLLI"],), cb, compile_chip(cb), assign)


def _mem_chip(name: str, kind: int, is_store: bool) -> ChipDef:
    from ...gkr.circuit_builder import RAM_MEMORY

    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    waddr = C.mem_word_addr(cb, rs1.value(), imm_f)
    mp_lo = cb.create_witin("mem_plo")
    mp_hi = cb.create_witin("mem_phi")
    mem_pts = cb.create_witin("mem_pts")
    if is_store:
        rs2 = C.read_reg(cb, "rs2", st, 1)
        cb.ram_write(RAM_MEMORY, waddr, [mp_lo, mp_hi], [rs2.lo, rs2.hi],
                     mem_pts, st.ts + 3)
        C.ts_lt_check(cb, "mem", mem_pts, st.ts + 3)
        C.gs_chain(cb, st, st.pc + 4)
        C.fetch(cb, st, kind, 0, rs1.reg_id, rs2.reg_id, imm_lo, imm_hi, imm_f)
    else:
        rd = C.write_rd(cb, st)
        cb.ram_read(RAM_MEMORY, waddr, [mp_lo, mp_hi], mem_pts, st.ts + 3)
        C.ts_lt_check(cb, "mem", mem_pts, st.ts + 3)
        cb.require_zero("lw_lo", rd.gate() * (rd.lo - mp_lo))
        cb.require_zero("lw_hi", rd.gate() * (rd.hi - mp_hi))
        C.gs_chain(cb, st, st.pc + 4)
        C.fetch(cb, st, kind, rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        il, ih, iff = encode_imm_vec(kind, v.imm)
        cols.update({"imm_lo": il, "imm_hi": ih, "imm_f": iff})
        waddr = v.mem_waddr.astype(np.uint64)
        prev_v = v.mem_prev.astype(np.uint64)
        pts = v.mem_pts.astype(np.uint64)
        plo, phi = _limbs(prev_v)
        cols.update({
            "mem_waddr": waddr, "mem_walo": waddr & MASK16, "mem_wahi": waddr >> 16,
            "mem_plo": plo, "mem_phi": phi, "mem_pts": pts,
        })
        cols.update(_ts_cols("mem", pts, ts + 3))
        if is_store:
            cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        else:
            cols.update(_rd_cols(v, ts + 2))
        return cols

    return ChipDef(name, (kind,), cb, compile_chip(cb), assign)


def _halt_chip() -> ChipDef:
    cb = CircuitBuilder("halt")
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    cb.require_zero("halt_code_lo", t0.lo)
    cb.require_zero("halt_code_hi", t0.hi)
    cb.require_zero("halt_exit_lo", a0.lo - E.Instance(PV_EXIT_CODE_LO))
    cb.require_zero("halt_exit_hi", a0.hi - E.Instance(PV_EXIT_CODE_HI))
    cb.require_zero("halt_end_pc", st.pc - E.Instance(PV_END_PC))
    cb.require_zero("halt_end_cycle", st.ts + 4 - E.Instance(PV_END_CYCLE))
    C.gs_chain(cb, st, st.pc)  # halt's GS write carries pc (consumed by GlobalChip)
    C.fetch(cb, st, K["ECALL"], 0, 0, 0, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("t0", "rs1", v, ts + 0, with_id=False))
        cols.update(_reg_read_cols("a0", "rs2", v, ts + 1, with_id=False))
        return cols

    return ChipDef("halt", (K["ECALL"],), cb, compile_chip(cb), assign)


def build_opcode_chips() -> list[ChipDef]:
    """The registry, in canonical proving order (Rv32imConfig mirror)."""
    return [
        _add_sub_chip("add", K["ADD"], False),
        _add_sub_chip("sub", K["SUB"], True),
        _addi_chip(),
        _lui_chip(),
        _branch_chip("beq", K["BEQ"], True),
        _branch_chip("bne", K["BNE"], False),
        _jal_chip(),
        _slli_chip(),
        _mem_chip("lw", K["LW"], False),
        _mem_chip("sw", K["SW"], True),
        _halt_chip(),
    ]
