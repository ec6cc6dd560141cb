"""Extended opcode chips: logic, comparisons, branches, right shifts,
JALR/AUIPC, byte/halfword memory — completing RV32I coverage.

Same templates as opcodes.py (reference mirror: instructions/riscv/{logic,
slt,branch,shift,jump,memory} — SURVEY.md §2.3). The M extension (MUL/DIV
family) is tracked as a framework TODO: sound multiplication needs the u8-limb
product decomposition (u16 x u16 partial products exceed p).

Copy of ``ceno_tpu/zkvm/chips/opcodes2.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...fields import babybear as bb
from . import field_ctx
from ...gkr.circuit_builder import (
    CircuitBuilder, LK_SHL, LK_SRL, LK_POW2, LK_AND8, LK_OR8, LK_XOR8,
    RAM_MEMORY,
)
from ...gkr.chip import compile_chip
from ...mle import expression as E
from ...emulator.rv32im import K
from . import common as C
from .opcodes import (
    ChipDef, MASK16, _state_cols, _reg_read_cols, _rd_cols, _ts_cols,
    encode_imm_vec, _batch_inv,
)


@dataclass
class ImmOperand:
    lo: object
    hi: object


def _imm_cols_witgen(kind, v):
    il, ih, iff = encode_imm_vec(kind, v.imm)
    return {"imm_lo": il, "imm_hi": ih, "imm_f": iff}


# ---------------------------------------------------------------------------
# Logic: AND/OR/XOR (+ immediate variants) via byte-pair tables
# ---------------------------------------------------------------------------

_LOGIC_TAG = {"and": LK_AND8, "or": LK_OR8, "xor": LK_XOR8}
_LOGIC_NP = {
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "xor": lambda a, b: a ^ b,
}


def _logic_chip(opname: str, kind_name: str, immediate: bool) -> ChipDef:
    name = kind_name.lower()
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    if immediate:
        imm_lo = cb.create_witin("imm_lo")
        imm_hi = cb.create_witin("imm_hi")
        imm_f = cb.create_witin("imm_f")
        b_src = ImmOperand(imm_lo, imm_hi)
    else:
        rs2 = C.read_reg(cb, "rs2", st, 1)
        b_src = rs2
    rd = C.write_rd(cb, st)
    a_bytes = C.byte_decompose(cb, "a", rs1.lo, rs1.hi)
    b_bytes = C.byte_decompose(cb, "b", b_src.lo, b_src.hi)
    o_bytes = [cb.create_witin(f"o_b{i}") for i in range(4)]
    tag = _LOGIC_TAG[opname]
    for i in range(4):
        cb.lk_record(tag, [a_bytes[i], b_bytes[i], o_bytes[i]])
    cb.require_zero("out_lo", rd.gate() * (rd.lo - o_bytes[0] - o_bytes[1] * 256))
    cb.require_zero("out_hi", rd.gate() * (rd.hi - o_bytes[2] - o_bytes[3] * 256))
    C.gs_chain(cb, st, st.pc + 4)
    if immediate:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)
    else:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        a = v.rs1_val.astype(np.uint64)
        if immediate:
            cols.update(_imm_cols_witgen(K[kind_name], v))
            b = (v.imm & 0xFFFFFFFF).astype(np.uint64)
        else:
            cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
            b = v.rs2_val.astype(np.uint64)
        cols.update(_rd_cols(v, ts + 2))
        o = _LOGIC_NP[opname](a, b)
        for i in range(4):
            cols[f"a_b{i}"] = (a >> (8 * i)) & 0xFF
            cols[f"b_b{i}"] = (b >> (8 * i)) & 0xFF
            cols[f"o_b{i}"] = (o >> (8 * i)) & 0xFF
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# Comparisons: SLT/SLTU/SLTI/SLTIU
# ---------------------------------------------------------------------------

def _slt_chip(kind_name: str, signed: bool, immediate: bool) -> ChipDef:
    name = kind_name.lower()
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    if immediate:
        imm_lo = cb.create_witin("imm_lo")
        imm_hi = cb.create_witin("imm_hi")
        imm_f = cb.create_witin("imm_f")
        b_src = ImmOperand(imm_lo, imm_hi)
    else:
        rs2 = C.read_reg(cb, "rs2", st, 1)
        b_src = rs2
    rd = C.write_rd(cb, st)
    lt = C.u32_lts(cb, "cmp", rs1, b_src) if signed else C.u32_ltu(cb, "cmp", rs1, b_src)
    cb.require_zero("slt_lo", rd.gate() * (rd.lo - lt))
    cb.require_zero("slt_hi", rd.gate() * rd.hi)
    C.gs_chain(cb, st, st.pc + 4)
    if immediate:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)
    else:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        a = v.rs1_val.astype(np.uint64)
        if immediate:
            cols.update(_imm_cols_witgen(K[kind_name], v))
            b = (v.imm & 0xFFFFFFFF).astype(np.uint64)
        else:
            cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
            b = v.rs2_val.astype(np.uint64)
        cols.update(_rd_cols(v, ts + 2))
        cols.update(_cmp_witgen("cmp", a, b, signed))
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


def _cmp_witgen(name, a, b, signed):
    """Witness for u32_ltu / u32_lts gadget columns."""
    cols = {}
    a_lo, a_hi = a & MASK16, a >> 16
    b_lo, b_hi = b & MASK16, b >> 16
    if signed:
        a_top, a_rest = a_hi >> 15, a_hi & 0x7FFF
        b_top, b_rest = b_hi >> 15, b_hi & 0x7FFF
        cols.update({
            f"{name}_a_top": a_top, f"{name}_a_rest": a_rest,
            f"{name}_b_top": b_top, f"{name}_b_rest": b_rest,
        })
        adj_a = a_rest + (1 - a_top) * (1 << 15)
        adj_b = b_rest + (1 - b_top) * (1 << 15)
    else:
        adj_a, adj_b = a_hi, b_hi
    cols[f"{name}_hi_lt"] = (adj_a < adj_b).astype(np.uint64)
    cols[f"{name}_lo_lt"] = (a_lo < b_lo).astype(np.uint64)
    d = field_ctx.enc_signed(adj_a.astype(np.int64) - adj_b.astype(np.int64))
    cols[f"{name}_eqhi_z"] = (d == 0).astype(np.uint64)
    cols[f"{name}_eqhi_inv"] = _batch_inv(d.astype(np.uint64))
    return cols


# ---------------------------------------------------------------------------
# Compare branches: BLT/BGE/BLTU/BGEU
# ---------------------------------------------------------------------------

def _branch_cmp_chip(kind_name: str, signed: bool, on_ge: bool) -> ChipDef:
    name = kind_name.lower()
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    lt = C.u32_lts(cb, "cmp", rs1, rs2) if signed else C.u32_ltu(cb, "cmp", rs1, rs2)
    taken = (1 - lt) if on_ge else lt
    C.gs_chain(cb, st, st.pc + 4 + taken * (imm_f - 4))
    C.fetch(cb, st, K[kind_name], 0, rs1.reg_id, rs2.reg_id, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        cols.update(_imm_cols_witgen(K[kind_name], v))
        a = v.rs1_val.astype(np.uint64)
        b = v.rs2_val.astype(np.uint64)
        cols.update(_cmp_witgen("cmp", a, b, signed))
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# Right shifts: SRLI/SRAI (+ register-operand SRL/SRA/SLL) via SRL/SHL tables
# ---------------------------------------------------------------------------

def _shift_amount_from_rs2(cb, rs2):
    """sh = rs2 & 31: rs2_lo = sh5 + rest11 * 2^5, sh5 = s_low + 16*flag."""
    rest11 = cb.create_witin("sh_rest11")
    s_low = cb.create_witin("sh_low")
    s_flag = cb.create_witin("sh_ge16")
    cb.assert_bit("sh_flag", s_flag)
    cb.assert_u4(s_low)
    cb.assert_u12(rest11)
    cb.require_zero(
        "sh_from_rs2", rs2.lo - s_low - s_flag * 16 - rest11 * 32
    )
    return s_low, s_flag


def _shift_right_chip(kind_name: str, arith: bool, from_reg: bool = False) -> ChipDef:
    name = kind_name.lower()
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    if from_reg:
        rs2 = C.read_reg(cb, "rs2", st, 1)
    rd = C.write_rd(cb, st)
    if from_reg:
        s_low, s_flag = _shift_amount_from_rs2(cb, rs2)
    else:
        imm_lo = cb.create_witin("imm_lo")
        imm_hi = cb.create_witin("imm_hi")
        imm_f = cb.create_witin("imm_f")
        s_low = cb.create_witin("sh_low")
        s_flag = cb.create_witin("sh_ge16")
        cb.assert_bit("sh_flag", s_flag)
        cb.assert_u4(s_low)
        cb.require_zero("sh_split", imm_f - s_low - s_flag * 16)
    qh = cb.create_witin("srl_qh")
    rh = cb.create_witin("srl_rh")
    ql = cb.create_witin("srl_ql")
    rl = cb.create_witin("srl_rl")
    cb.lk_record(LK_SRL, [rs1.hi, s_low, qh, rh])
    cb.lk_record(LK_SRL, [rs1.lo, s_low, ql, rl])
    pw = cb.create_witin("pow16ms")  # 2^(16 - s_low)
    cb.lk_record(LK_POW2, [16 - s_low, pw])
    if arith:
        top, rest = C.sign_split(cb, "sign", rs1.hi)
        fill = top * (E.Const(1 << 16) - pw)  # sign fill for the shifted-in bits
        lo_no = rh * pw + ql
        lo_fl = qh + fill
        hi_no = qh + fill
        hi_fl = top * 0xFFFF
    else:
        lo_no = rh * pw + ql
        lo_fl = qh
        hi_no = qh
        hi_fl = E.Const(0)
    cb.require_zero(
        "sr_lo", rd.gate() * (rd.lo - (1 - s_flag) * lo_no - s_flag * lo_fl)
    )
    cb.require_zero(
        "sr_hi", rd.gate() * (rd.hi - (1 - s_flag) * hi_no - s_flag * hi_fl)
    )
    C.gs_chain(cb, st, st.pc + 4)
    if from_reg:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)
    else:
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_rd_cols(v, ts + 2))
        if from_reg:
            cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
            rs2_lo = v.rs2_val.astype(np.uint64) & MASK16
            sh = rs2_lo & 31
            cols["sh_rest11"] = rs2_lo >> 5
        else:
            cols.update(_imm_cols_witgen(K[kind_name], v))
            sh = cols["imm_f"]
        slow = sh & 15
        a = v.rs1_val.astype(np.uint64)
        a_lo, a_hi = a & MASK16, a >> 16
        cols.update({
            "sh_low": slow, "sh_ge16": sh >> 4,
            "srl_qh": a_hi >> slow, "srl_rh": a_hi & ((np.uint64(1) << slow) - 1),
            "srl_ql": a_lo >> slow, "srl_rl": a_lo & ((np.uint64(1) << slow) - 1),
            "pow16ms": np.uint64(1) << (16 - slow),
        })
        if arith:
            cols.update({"sign_top": a_hi >> 15, "sign_rest": a_hi & 0x7FFF})
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


def _shift_left_reg_chip() -> ChipDef:
    """SLL: register-operand left shift via the SHL table."""
    cb = CircuitBuilder("sll")
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    rd = C.write_rd(cb, st)
    s_low, s_flag = _shift_amount_from_rs2(cb, rs2)
    ll = cb.create_witin("shl_ll")
    lh = cb.create_witin("shl_lh")
    hl = cb.create_witin("shl_hl")
    hh = cb.create_witin("shl_hh")
    cb.lk_record(LK_SHL, [rs1.lo, s_low, ll, lh])
    cb.lk_record(LK_SHL, [rs1.hi, s_low, hl, hh])
    r1l = cb.create_witin("shl_r1l")
    r1c = cb.create_witin("shl_r1c")
    cb.assert_bit("sll_r1c", r1c)
    cb.assert_u16(r1l)
    cb.require_zero("sll_r1", lh + hl - r1l - r1c * (1 << 16))
    cb.require_zero("sll_lo", rd.gate() * (rd.lo - (1 - s_flag) * ll))
    cb.require_zero(
        "sll_hi", rd.gate() * (rd.hi - (1 - s_flag) * r1l - s_flag * ll)
    )
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["SLL"], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        cols.update(_rd_cols(v, ts + 2))
        rs2_lo = v.rs2_val.astype(np.uint64) & MASK16
        sh = rs2_lo & 31
        cols["sh_rest11"] = rs2_lo >> 5
        slow = sh & 15
        cols.update({"sh_low": slow, "sh_ge16": sh >> 4})
        a = v.rs1_val.astype(np.uint64)
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

    return ChipDef("sll", (K["SLL"],), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# JALR / AUIPC
# ---------------------------------------------------------------------------

def _jalr_chip() -> ChipDef:
    cb = CircuitBuilder("jalr")
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    cb.assert_u12(rd.hi)
    cb.require_zero("jalr_link", rd.gate() * (rd.lo + rd.hi * (1 << 16) - st.pc - 4))
    # target = (rs1 + imm) & ~1, target < 2^28 (valid code addresses)
    tgt_lo = cb.create_witin("tgt_lo")
    tgt_hi = cb.create_witin("tgt_hi")
    lsb = cb.create_witin("tgt_lsb")
    cb.assert_bit("jalr_lsb", lsb)
    cb.assert_u16(tgt_lo)
    cb.assert_u12(tgt_hi)
    target = tgt_lo * 2 + tgt_hi * (1 << 17)  # even value < 2^29
    cb.require_zero("jalr_target", target + lsb - rs1.value() - imm_f)
    C.gs_chain(cb, st, target)
    C.fetch(cb, st, K["JALR"], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_rd_cols(v, ts + 2))
        cols.update(_imm_cols_witgen(K["JALR"], v))
        a = v.rs1_val.astype(np.uint64)
        imm = v.imm.astype(np.int64)
        raw = (a.astype(np.int64) + imm) & 0xFFFFFFFF
        tgt = raw & ~np.int64(1)
        cols.update({
            "tgt_lo": (tgt >> 1) & MASK16, "tgt_hi": tgt >> 17,
            "tgt_lsb": raw & 1,
        })
        return cols

    return ChipDef("jalr", (K["JALR"],), cb, compile_chip(cb), assign)


def _auipc_chip() -> ChipDef:
    cb = CircuitBuilder("auipc")
    st = C.make_state(cb)
    rd = C.write_rd(cb, st)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    pc_lo, pc_hi = C.pc_decompose(cb, st)
    C.limb_add(cb, "auipc", pc_lo, pc_hi, imm_lo, imm_hi, rd.lo, rd.hi, gate=rd.gate())
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["AUIPC"], rd.reg_id, 0, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_rd_cols(v, ts + 2))
        cols.update(_imm_cols_witgen(K["AUIPC"], v))
        pc = cols["pc"]
        cols.update({"pc_lo": pc & MASK16, "pc_hi": pc >> 16})
        a_lo = pc & MASK16
        c0 = ((a_lo + cols["imm_lo"]) >> 16) & 1
        c1 = (((pc >> 16) + cols["imm_hi"] + c0) >> 16) & 1
        cols.update({"auipc_c0": c0, "auipc_c1": c1})
        return cols

    return ChipDef("auipc", (K["AUIPC"],), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# Byte / halfword memory ops
# ---------------------------------------------------------------------------

def _byte_mem_chip(kind_name: str) -> ChipDef:
    """LB/LBU/LH/LHU/SB/SH: unaligned-offset access within one word."""
    name = kind_name.lower()
    is_store = kind_name in ("SB", "SH")
    is_half = kind_name in ("LH", "LHU", "SH")
    is_signed = kind_name in ("LB", "LH")
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    imm_lo = cb.create_witin("imm_lo")
    imm_hi = cb.create_witin("imm_hi")
    imm_f = cb.create_witin("imm_f")
    # addr = 4*waddr + off
    waddr = cb.create_witin("mem_waddr")
    wlo = cb.create_witin("mem_walo")
    whi = cb.create_witin("mem_wahi")
    o0 = cb.create_witin("off0")
    o1 = cb.create_witin("off1")
    cb.assert_bit("off0_b", o0)
    cb.assert_bit("off1_b", o1)
    if is_half:
        cb.require_zero("half_align", o0)
    off = o0 + o1 * 2
    cb.require_zero("mem_addr", rs1.value() + imm_f - waddr * 4 - off)
    cb.require_zero("mem_waddr_limbs", waddr - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)
    mp_lo = cb.create_witin("mem_plo")
    mp_hi = cb.create_witin("mem_phi")
    mem_pts = cb.create_witin("mem_pts")
    pbytes = C.byte_decompose(cb, "pw", mp_lo, mp_hi)
    ind = [
        (1 - o0) * (1 - o1), o0 * (1 - o1), (1 - o0) * o1, o0 * o1,
    ]  # byte-offset indicators
    if is_store:
        rs2 = C.read_reg(cb, "rs2", st, 1)
        sbytes = C.byte_decompose(cb, "sv", rs2.lo, rs2.hi)
        nbytes = [cb.create_witin(f"nw_b{i}") for i in range(4)]
        if is_half:
            ih = [1 - o1, E.Const(0), o1, E.Const(0)]  # low byte of half at off
            for i in range(4):
                src = sbytes[0] if i in (0, 2) else sbytes[1]
                sel = ih[i - (i % 2)]
                cb.require_zero(
                    f"nw{i}", nbytes[i] - sel * src - (1 - sel) * pbytes[i]
                )
        else:
            for i in range(4):
                cb.require_zero(
                    f"nw{i}", nbytes[i] - ind[i] * sbytes[0] - (1 - ind[i]) * pbytes[i]
                )
        for b in nbytes:
            cb.assert_u8(b)
        new_lo = nbytes[0] + nbytes[1] * 256
        new_hi = nbytes[2] + nbytes[3] * 256
        cb.ram_write(RAM_MEMORY, waddr, [mp_lo, mp_hi], [new_lo, new_hi],
                     mem_pts, st.ts + 3)
        C.ts_lt_check(cb, "mem", mem_pts, st.ts + 3)
        C.gs_chain(cb, st, st.pc + 4)
        C.fetch(cb, st, K[kind_name], 0, rs1.reg_id, rs2.reg_id, imm_lo, imm_hi, imm_f)
    else:
        rd = C.write_rd(cb, st)
        cb.ram_read(RAM_MEMORY, waddr, [mp_lo, mp_hi], mem_pts, st.ts + 3)
        C.ts_lt_check(cb, "mem", mem_pts, st.ts + 3)
        if is_half:
            half_lo = (1 - o1) * pbytes[0] + o1 * pbytes[2]
            half_hi = (1 - o1) * pbytes[1] + o1 * pbytes[3]
            if is_signed:
                top = cb.create_witin("sx_top")
                rest = cb.create_witin("sx_rest")
                cb.assert_bit("sx_topb", top)
                cb.require_zero("sx_split", half_hi - top * 128 - rest)
                cb.assert_u8(rest * 2)
                cb.require_zero(
                    "ld_lo", rd.gate() * (rd.lo - half_lo - half_hi * 256)
                )
                cb.require_zero("ld_hi", rd.gate() * (rd.hi - top * 0xFFFF))
            else:
                cb.require_zero("ld_lo", rd.gate() * (rd.lo - half_lo - half_hi * 256))
                cb.require_zero("ld_hi", rd.gate() * rd.hi)
        else:
            byte = sum((ind[i] * pbytes[i] for i in range(1, 4)), ind[0] * pbytes[0])
            if is_signed:
                top = cb.create_witin("sx_top")
                rest = cb.create_witin("sx_rest")
                cb.assert_bit("sx_topb", top)
                cb.require_zero("sx_split", byte - top * 128 - rest)
                cb.assert_u8(rest * 2)
                cb.require_zero(
                    "ld_lo", rd.gate() * (rd.lo - byte - top * 0xFF00)
                )
                cb.require_zero("ld_hi", rd.gate() * (rd.hi - top * 0xFFFF))
            else:
                cb.require_zero("ld_lo", rd.gate() * (rd.lo - byte))
                cb.require_zero("ld_hi", rd.gate() * rd.hi)
        C.gs_chain(cb, st, st.pc + 4)
        C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, 0, imm_lo, imm_hi, imm_f)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_imm_cols_witgen(K[kind_name], v))
        a = v.rs1_val.astype(np.uint64)
        imm = v.imm.astype(np.int64)
        addr = (a.astype(np.int64) + imm) & 0xFFFFFFFF
        off = addr & 3
        waddr = v.mem_waddr.astype(np.uint64)
        prev_v = v.mem_prev.astype(np.uint64)
        pts = v.mem_pts.astype(np.uint64)
        cols.update({
            "mem_waddr": waddr, "mem_walo": waddr & MASK16, "mem_wahi": waddr >> 16,
            "off0": off & 1, "off1": off >> 1,
            "mem_plo": prev_v & MASK16, "mem_phi": prev_v >> 16, "mem_pts": pts,
        })
        cols.update(_ts_cols("mem", pts, ts + 3))
        for i in range(4):
            cols[f"pw_b{i}"] = (prev_v >> (8 * i)) & 0xFF
        if is_store:
            cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
            sv = v.rs2_val.astype(np.uint64)
            for i in range(4):
                cols[f"sv_b{i}"] = (sv >> (8 * i)) & 0xFF
            new_v = v.mem_val.astype(np.uint64)
            for i in range(4):
                cols[f"nw_b{i}"] = (new_v >> (8 * i)) & 0xFF
        else:
            cols.update(_rd_cols(v, ts + 2))
            if is_half:
                half = np.where(off >> 1 == 0, prev_v & 0xFFFF, prev_v >> 16)
                if is_signed:
                    hh = half >> 8
                    cols.update({"sx_top": hh >> 7, "sx_rest": hh & 0x7F})
            else:
                byte = (prev_v >> (8 * off.astype(np.uint64))) & 0xFF
                if is_signed:
                    cols.update({"sx_top": byte >> 7, "sx_rest": byte & 0x7F})
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


def build_extended_chips() -> list:
    return [
        _logic_chip("and", "AND", False),
        _logic_chip("and", "ANDI", True),
        _logic_chip("or", "OR", False),
        _logic_chip("or", "ORI", True),
        _logic_chip("xor", "XOR", False),
        _logic_chip("xor", "XORI", True),
        _slt_chip("SLT", True, False),
        _slt_chip("SLTU", False, False),
        _slt_chip("SLTI", True, True),
        _slt_chip("SLTIU", False, True),
        _branch_cmp_chip("BLT", True, False),
        _branch_cmp_chip("BGE", True, True),
        _branch_cmp_chip("BLTU", False, False),
        _branch_cmp_chip("BGEU", False, True),
        _shift_right_chip("SRLI", False),
        _shift_right_chip("SRAI", True),
        _shift_right_chip("SRL", False, from_reg=True),
        _shift_right_chip("SRA", True, from_reg=True),
        _shift_left_reg_chip(),
        _jalr_chip(),
        _auipc_chip(),
        _byte_mem_chip("LB"),
        _byte_mem_chip("LBU"),
        _byte_mem_chip("LH"),
        _byte_mem_chip("LHU"),
        _byte_mem_chip("SB"),
        _byte_mem_chip("SH"),
    ]
