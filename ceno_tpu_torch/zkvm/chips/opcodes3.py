"""M-extension chips: MUL/MULH/MULHU/MULHSU, DIV/DIVU/REM/REMU.

Multiplication uses the sound u8-limb schoolbook core: byte products are
< 2^16 and every column equation's integer magnitude stays < 2^19 < p, so
there is no mod-p wrap ambiguity (the reason u16-limb products cannot be
constrained directly on BabyBear). Division is proven multiplicatively:
a = q*b + r with r < b and q*b's high word forced to zero, with signed
variants running the unsigned core on absolute values.

Reference mirror: instructions/riscv/{mul,divu,div}.rs (SURVEY.md §2.3).

Copy of ``ceno_tpu/zkvm/chips/opcodes3.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from . import field_ctx
from ...gkr.circuit_builder import CircuitBuilder
from ...gkr.chip import compile_chip
from ...mle import expression as E
from ...emulator.rv32im import K
from . import common as C
from .opcodes import ChipDef, MASK16, _state_cols, _reg_read_cols, _rd_cols, _batch_inv

WORD = 0xFFFFFFFF


def _u8_mul_core(cb: CircuitBuilder, name: str, a_bytes, b_bytes):
    """8 result bytes of the 64-bit product, with u12-checked column carries."""
    r = [cb.create_witin(f"{name}_r{k}") for k in range(8)]
    t = [cb.create_witin(f"{name}_t{k}") for k in range(7)]
    for x in r:
        cb.assert_u8(x)
    for x in t:
        cb.assert_u12(x)
    for k in range(8):
        col = E.Const(0)
        for i in range(4):
            j = k - i
            if 0 <= j < 4:
                col = col + a_bytes[i] * b_bytes[j]
        if k > 0:
            col = col + t[k - 1]
        if k < 7:
            cb.require_zero(f"{name}_col{k}", col - r[k] - t[k] * 256)
        else:
            cb.require_zero(f"{name}_col{k}", col - r[k])
    return r


def _mul_witgen(name, a, b):
    """Witness for the u8 core columns."""
    cols = {}
    full = a.astype(np.object_) * b.astype(np.object_)
    prev_t = np.zeros(len(a), dtype=np.object_)
    ab = [(a >> (8 * i)) & 0xFF for i in range(4)]
    bby = [(b >> (8 * i)) & 0xFF for i in range(4)]
    for k in range(8):
        col = prev_t
        for i in range(4):
            j = k - i
            if 0 <= j < 4:
                col = col + ab[i].astype(np.object_) * bby[j].astype(np.object_)
        rk = col % 256 if k < 7 else col
        tk = col // 256
        cols[f"{name}_r{k}"] = np.array(rk, dtype=np.uint64)
        if k < 7:
            cols[f"{name}_t{k}"] = np.array(tk, dtype=np.uint64)
            prev_t = tk
    return cols


def _neg_flags_witgen(name, v):
    hi = v >> 16
    return {f"{name}_top": hi >> 15, f"{name}_rest": hi & 0x7FFF}


def _mul_chip(kind_name: str) -> ChipDef:
    """MUL / MULHU / MULH / MULHSU."""
    name = kind_name.lower()
    low = kind_name == "MUL"
    a_signed = kind_name in ("MULH", "MULHSU")
    b_signed = kind_name == "MULH"
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    rd = C.write_rd(cb, st)
    a_bytes = C.byte_decompose(cb, "a", rs1.lo, rs1.hi)
    b_bytes = C.byte_decompose(cb, "b", rs2.lo, rs2.hi)
    r = _u8_mul_core(cb, "m", a_bytes, b_bytes)
    if low:
        cb.require_zero("mul_lo", rd.gate() * (rd.lo - r[0] - r[1] * 256))
        cb.require_zero("mul_hi", rd.gate() * (rd.hi - r[2] - r[3] * 256))
    else:
        hu_lo = r[4] + r[5] * 256
        hu_hi = r[6] + r[7] * 256
        sub_lo = E.Const(0)
        sub_hi = E.Const(0)
        if a_signed:
            a_top, _ = C.sign_split(cb, "an", rs1.hi)
            sub_lo = sub_lo + a_top * rs2.lo
            sub_hi = sub_hi + a_top * rs2.hi
        if b_signed:
            b_top, _ = C.sign_split(cb, "bn", rs2.hi)
            sub_lo = sub_lo + b_top * rs1.lo
            sub_hi = sub_hi + b_top * rs1.hi
        # H_s = H_u - sub (mod 2^32), borrows in {0,1,2}
        brw0 = cb.create_witin("brw0")
        brw1 = cb.create_witin("brw1")
        for nm, brw in (("brw0", brw0), ("brw1", brw1)):
            cb.require_zero(f"{nm}_range", brw * (brw - 1) * (brw - 2))
        cb.require_zero(
            "mulh_lo", rd.gate() * (rd.lo - hu_lo + sub_lo - brw0 * (1 << 16))
        )
        cb.require_zero(
            "mulh_hi", rd.gate() * (rd.hi - hu_hi + sub_hi + brw0 - brw1 * (1 << 16))
        )
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        cols.update(_rd_cols(v, ts + 2))
        a = v.rs1_val.astype(np.uint64)
        b = v.rs2_val.astype(np.uint64)
        for i in range(4):
            cols[f"a_b{i}"] = (a >> (8 * i)) & 0xFF
            cols[f"b_b{i}"] = (b >> (8 * i)) & 0xFF
        cols.update(_mul_witgen("m", a, b))
        if not low:
            full = a.astype(np.object_) * b.astype(np.object_)
            hu = np.array([int(x) >> 32 for x in full], np.uint64)
            sub_lo = np.zeros(len(a), np.int64)
            sub_hi = np.zeros(len(a), np.int64)
            if a_signed:
                cols.update(_neg_flags_witgen("an", a))
                at = (a >> 31).astype(np.int64)
                sub_lo += at * (b & MASK16).astype(np.int64)
                sub_hi += at * (b >> 16).astype(np.int64)
            if b_signed:
                cols.update(_neg_flags_witgen("bn", b))
                bt = (b >> 31).astype(np.int64)
                sub_lo += bt * (a & MASK16).astype(np.int64)
                sub_hi += bt * (a >> 16).astype(np.int64)
            rd_v = v.rd_val.astype(np.uint64)
            rd_lo = (rd_v & MASK16).astype(np.int64)
            rd_hi = (rd_v >> 16).astype(np.int64)
            hu_lo = (hu & MASK16).astype(np.int64)
            hu_hi = (hu >> 16).astype(np.int64)
            x0 = v.rd_id == 0
            brw0 = np.where(x0, 0, -((hu_lo - sub_lo - rd_lo) // (1 << 16)))
            brw1 = np.where(
                x0, 0, -((hu_hi - sub_hi - brw0 - rd_hi) // (1 << 16))
            )
            cols["brw0"] = brw0.astype(np.uint64)
            cols["brw1"] = brw1.astype(np.uint64)
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


def _abs_gadget(cb: CircuitBuilder, name: str, src):
    """(abs_lo, abs_hi, neg_bit): two's-complement absolute value in limbs."""
    top, _ = C.sign_split(cb, f"{name}_sgn", src.hi)
    alo = cb.create_witin(f"{name}_alo")
    ahi = cb.create_witin(f"{name}_ahi")
    cb.assert_u16(alo)
    cb.assert_u16(ahi)
    # neg: abs = 2^32 - v (v != 0); pos: abs = v. Handle v == 0 (abs = 0) too:
    # top*(2^32 - v - abs - z32*2^32) + (1-top)*(v - abs) == 0 per limb with
    # borrow handling; use value-level split: abs + v = 2^32 when top & v != 0.
    # Limb form: neg case: alo + v_lo = c0*2^16 + 0?? -> use: (2^32 - v) limbs:
    #   lo: (0x10000 - v_lo - brw... ) Simpler: v + abs == 2^32 * [v != 0]
    # in limbs: lo: v_lo + alo = s0 + c0*2^16 with s0 == 0; hi: v_hi + ahi + c0
    #   = 2^16 * nz  (nz = [v != 0])
    c0 = cb.create_witin(f"{name}_c0")
    cb.assert_bit(f"{name}_c0b", c0)
    zlo = C.is_zero(cb, f"{name}_zl", src.lo)
    zhi = C.is_zero(cb, f"{name}_zh", src.hi)
    nz = 1 - zlo * zhi
    cb.require_zero(
        f"{name}_neg_lo", top * (src.lo + alo - c0 * (1 << 16))
    )
    cb.require_zero(
        f"{name}_neg_hi", top * (src.hi + ahi + c0 - nz * (1 << 16))
    )
    cb.require_zero(f"{name}_pos_lo", (1 - top) * (src.lo - alo))
    cb.require_zero(f"{name}_pos_hi", (1 - top) * (src.hi - ahi))
    return alo, ahi, top


def _abs_witgen(name, v):
    neg = (v >> 31) & 1
    av = np.where(neg == 1, ((1 << 32) - v) & WORD, v)
    out = {
        f"{name}_alo": av & MASK16, f"{name}_ahi": av >> 16,
        f"{name}_c0": np.where((neg == 1) & ((v & MASK16) != 0), 1, 0).astype(np.uint64),
    }
    out.update({f"{name}_sgn_top": neg, f"{name}_sgn_rest": (v >> 16) & 0x7FFF})
    for nm, limb in ((f"{name}_zl", v & MASK16), (f"{name}_zh", v >> 16)):
        out[f"{nm}_z"] = (limb == 0).astype(np.uint64)
        out[f"{nm}_inv"] = _batch_inv(limb)
    return out


class _Operand:
    def __init__(self, lo, hi):
        self.lo = lo
        self.hi = hi

    def value(self):
        return self.lo + self.hi * (1 << 16)


def _div_chip(kind_name: str) -> ChipDef:
    """DIV/DIVU/REM/REMU: prove a = q*b + r, r < b, with b=0 and sign cases."""
    name = kind_name.lower()
    signed = kind_name in ("DIV", "REM")
    want_rem = kind_name in ("REM", "REMU")
    cb = CircuitBuilder(name)
    st = C.make_state(cb)
    rs1 = C.read_reg(cb, "rs1", st, 0)
    rs2 = C.read_reg(cb, "rs2", st, 1)
    rd = C.write_rd(cb, st)
    if signed:
        a_lo, a_hi, a_neg = _abs_gadget(cb, "absa", rs1)
        b_lo, b_hi, b_neg = _abs_gadget(cb, "absb", rs2)
    else:
        a_lo, a_hi = rs1.lo, rs1.hi
        b_lo, b_hi = rs2.lo, rs2.hi
    # witness unsigned quotient/remainder of |a| / |b|
    q_lo = cb.create_witin("q_lo")
    q_hi = cb.create_witin("q_hi")
    r_lo = cb.create_witin("r_lo")
    r_hi = cb.create_witin("r_hi")
    for x in (q_lo, q_hi, r_lo, r_hi):
        cb.assert_u16(x)
    q_bytes = C.byte_decompose(cb, "qb", q_lo, q_hi)
    b_bytes = C.byte_decompose(cb, "bb", b_lo, b_hi)
    pr = _u8_mul_core(cb, "qb_mul", q_bytes, b_bytes)
    bz_lo = C.is_zero(cb, "bz_l", b_lo)
    bz_hi = C.is_zero(cb, "bz_h", b_hi)
    bz = bz_lo * bz_hi  # [b == 0]
    # q*b + r = a (64-bit: high product bytes must vanish when b != 0)
    for k in range(4, 8):
        cb.require_zero(f"div_hi{k}", (1 - bz) * pr[k])
    c0 = cb.create_witin("div_c0")
    c1 = cb.create_witin("div_c1")
    cb.assert_bit("div_c0b", c0)
    cb.assert_bit("div_c1b", c1)
    p_lo = pr[0] + pr[1] * 256
    p_hi = pr[2] + pr[3] * 256
    cb.require_zero("div_lo", (1 - bz) * (p_lo + r_lo - a_lo - c0 * (1 << 16)))
    cb.require_zero("div_hi", (1 - bz) * (p_hi + r_hi + c0 - a_hi - c1 * (1 << 16)))
    # r < b (b != 0)
    lt = C.u32_ltu(cb, "rb", _Operand(r_lo, r_hi), _Operand(b_lo, b_hi))
    cb.require_zero("div_rem_lt", (1 - bz) * (1 - lt))
    # b == 0: q = 0xFFFFFFFF, r = a
    cb.require_zero("div0_q_lo", bz * (q_lo - 0xFFFF))
    cb.require_zero("div0_q_hi", bz * (q_hi - 0xFFFF))
    cb.require_zero("div0_r_lo", bz * (r_lo - a_lo))
    cb.require_zero("div0_r_hi", bz * (r_hi - a_hi))
    # select + re-sign the result
    if signed:
        if want_rem:
            # rem sign = sign of a (zero stays zero via the nz factor below)
            res_neg = a_neg
            sel_lo, sel_hi = r_lo, r_hi
        else:
            # quotient sign = a_neg XOR b_neg (b != 0); b == 0 -> q = -1 (abs 1... )
            res_neg = a_neg + b_neg - 2 * a_neg * b_neg
            sel_lo, sel_hi = q_lo, q_hi
        # rd = res_neg ? 2^32 - sel : sel  (sel == 0 -> rd = 0)
        szl = C.is_zero(cb, "sz_l", sel_lo)
        szh = C.is_zero(cb, "sz_h", sel_hi)
        nz = 1 - szl * szh
        cc = cb.create_witin("sgn_c0")
        cb.assert_bit("sgn_c0b", cc)
        if not want_rem:
            # b == 0: result q = 0xFFFFFFFF already (two's comp of 1? no:
            # unsigned q = 0xFFFFFFFF and res_neg must be 0 in that case)
            res_neg = (1 - bz) * res_neg
        cb.require_zero(
            "sgn_lo", rd.gate() * (res_neg * (sel_lo + rd.lo - cc * (1 << 16))
                                   + (1 - res_neg) * (rd.lo - sel_lo))
        )
        cb.require_zero(
            "sgn_hi", rd.gate() * (res_neg * (sel_hi + rd.hi + cc - nz * (1 << 16))
                                   + (1 - res_neg) * (rd.hi - sel_hi))
        )
    else:
        sel_lo, sel_hi = (r_lo, r_hi) if want_rem else (q_lo, q_hi)
        cb.require_zero("sel_lo", rd.gate() * (rd.lo - sel_lo))
        cb.require_zero("sel_hi", rd.gate() * (rd.hi - sel_hi))
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K[kind_name], rd.reg_id, rs1.reg_id, rs2.reg_id, 0, 0, 0)

    def assign(v):
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("rs1", "rs1", v, ts + 0))
        cols.update(_reg_read_cols("rs2", "rs2", v, ts + 1))
        cols.update(_rd_cols(v, ts + 2))
        a = v.rs1_val.astype(np.uint64)
        b = v.rs2_val.astype(np.uint64)
        if signed:
            cols.update(_abs_witgen("absa", a))
            cols.update(_abs_witgen("absb", b))
            aa = np.where((a >> 31) == 1, ((1 << 32) - a) & WORD, a)
            ab = np.where((b >> 31) == 1, ((1 << 32) - b) & WORD, b)
        else:
            aa, ab = a, b
        q = np.where(ab != 0, aa // np.where(ab == 0, 1, ab), WORD).astype(np.uint64)
        r = np.where(ab != 0, aa % np.where(ab == 0, 1, ab), aa).astype(np.uint64)
        cols.update({
            "q_lo": q & MASK16, "q_hi": q >> 16,
            "r_lo": r & MASK16, "r_hi": r >> 16,
        })
        for i in range(4):
            cols[f"qb_b{i}"] = (q >> (8 * i)) & 0xFF
            cols[f"bb_b{i}"] = (ab >> (8 * i)) & 0xFF
        cols.update(_mul_witgen("qb_mul", q, ab))
        for nm, limb in (("bz_l", ab & MASK16), ("bz_h", ab >> 16)):
            cols[f"{nm}_z"] = (limb == 0).astype(np.uint64)
            cols[f"{nm}_inv"] = _batch_inv(limb)
        # carries of q*b + r = a (b != 0 rows; gated off otherwise)
        p_v = (q * ab) & np.uint64(WORD)
        c0v = ((p_v & MASK16) + (r & MASK16)) >> 16
        c1v = (((p_v >> 16) & MASK16) + (r >> 16) + c0v) >> 16
        cols["div_c0"] = c0v.astype(np.uint64) & 1
        cols["div_c1"] = c1v.astype(np.uint64) & 1
        # r < b gadget cols
        r_lo_, r_hi_ = r & MASK16, r >> 16
        b_lo_, b_hi_ = ab & MASK16, ab >> 16
        cols["rb_hi_lt"] = (r_hi_ < b_hi_).astype(np.uint64)
        cols["rb_lo_lt"] = (r_lo_ < b_lo_).astype(np.uint64)
        d = field_ctx.enc_signed(r_hi_.astype(np.int64) - b_hi_.astype(np.int64))
        cols["rb_eqhi_z"] = (d == 0).astype(np.uint64)
        cols["rb_eqhi_inv"] = _batch_inv(d.astype(np.uint64))
        if signed:
            sel = r if want_rem else q
            cols["sz_l_z"] = ((sel & MASK16) == 0).astype(np.uint64)
            cols["sz_l_inv"] = _batch_inv(sel & MASK16)
            cols["sz_h_z"] = ((sel >> 16) == 0).astype(np.uint64)
            cols["sz_h_inv"] = _batch_inv(sel >> 16)
            cols["sgn_c0"] = np.where(
                ((sel & MASK16) != 0), 1, 0
            ).astype(np.uint64) * np.where(_result_neg(a, b, ab, want_rem) == 1, 1, 0)
        return cols

    return ChipDef(name, (K[kind_name],), cb, compile_chip(cb), assign)


def _result_neg(a, b, ab, want_rem):
    a_neg = (a >> 31) & 1
    b_neg = (b >> 31) & 1
    if want_rem:
        return a_neg
    return np.where(ab != 0, a_neg ^ b_neg, 0).astype(np.uint64)


def build_mul_chips() -> list:
    return [
        _mul_chip("MUL"),
        _mul_chip("MULHU"),
        _mul_chip("MULH"),
        _mul_chip("MULHSU"),
        _div_chip("DIVU"),
        _div_chip("REMU"),
        _div_chip("DIV"),
        _div_chip("REM"),
    ]
