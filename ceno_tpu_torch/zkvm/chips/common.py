"""Shared opcode-circuit scaffolding.

Role mirror of the reference's per-format scaffolding (insn_base.rs:26-685,
SURVEY.md §2.3): StateInOut (GlobalState pc/ts chain), ReadRS1/ReadRS2,
WriteRD (with the rd=x0 special case via an is-zero gadget), memory address
decomposition, timestamp lt-checks, and the program-fetch lookup. Register
and memory values travel as 2 x u16 limbs (UIntLimbs<32,16> mirror,
constants.rs:24-37).

Soundness conventions (BabyBear p < 2^31): every arithmetic constraint is
limb-level with integer magnitude < p — u32 values are never recomposed into
a single field element inside a constraint unless the quantity is known
< 2^28 (pc-like values), in which case the limbs carry a u16+u12 range pair.

Each helper allocates witness columns on a CircuitBuilder and returns the
refs; the witgen in opcodes.py fills the same columns by name.

Copy of ``ceno_tpu/zkvm/chips/common.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...gkr.circuit_builder import (
    CircuitBuilder,
    RAM_GLOBAL_STATE,
    RAM_REGISTER,
    RAM_MEMORY,
    LK_INSTRUCTION,
)
from ...mle import expression as E


@dataclass
class StateCols:
    pc: E.Wit
    ts: E.Wit


def make_state(cb: CircuitBuilder) -> StateCols:
    return StateCols(cb.create_witin("pc"), cb.create_witin("ts"))


def gs_chain(cb: CircuitBuilder, state: StateCols, next_pc_expr) -> None:
    """GlobalState chain: read (GS, pc, ts), write (GS, next_pc, ts+4)."""
    cb.read_record([E.Const(RAM_GLOBAL_STATE), state.pc, state.ts])
    cb.write_record([E.Const(RAM_GLOBAL_STATE), next_pc_expr, state.ts + 4])


def ts_lt_check(cb: CircuitBuilder, name: str, prev_ts, cur_ts_expr):
    """prev_ts < cur_ts via cur - prev - 1 = lo + hi*2^16, lo u16, hi u12
    (28-bit timestamps; AssertLt mirror, gkr_iop circuit_builder/ram.rs)."""
    lo = cb.create_witin(f"{name}_dlo")
    hi = cb.create_witin(f"{name}_dhi")
    cb.require_zero(f"{name}_diff", cur_ts_expr - prev_ts - 1 - lo - hi * (1 << 16))
    cb.assert_u16(lo)
    cb.assert_u12(hi)


@dataclass
class RegRead:
    reg_id: object  # E.Wit or E.Const
    lo: E.Wit
    hi: E.Wit

    def value(self):
        return self.lo + self.hi * (1 << 16)


def read_reg(cb: CircuitBuilder, name: str, state: StateCols, subcycle: int,
             const_id: int | None = None) -> RegRead:
    rid = E.Const(const_id) if const_id is not None else cb.create_witin(f"{name}_id")
    lo = cb.create_witin(f"{name}_lo")
    hi = cb.create_witin(f"{name}_hi")
    prev_ts = cb.create_witin(f"{name}_pts")
    cb.ram_read(RAM_REGISTER, rid, [lo, hi], prev_ts, state.ts + subcycle)
    ts_lt_check(cb, name, prev_ts, state.ts + subcycle)
    return RegRead(rid, lo, hi)


@dataclass
class RdWrite:
    reg_id: E.Wit
    lo: E.Wit
    hi: E.Wit
    z: E.Wit  # 1 when rd is x0

    def gate(self):
        """Factor that disables semantic constraints when rd = x0."""
        return 1 - self.z


def write_rd(cb: CircuitBuilder, state: StateCols, subcycle: int = 2) -> RdWrite:
    """Allocate the rd write: limbs u16-checked, RAM record, ts check, and
    the x0 gadget (z = [rd == 0], limbs forced 0 when z). The chip must add
    its own (1 - z)-gated limb constraints tying (lo, hi) to the semantics."""
    rid = cb.create_witin("rd_id")
    lo = cb.create_witin("rd_lo")
    hi = cb.create_witin("rd_hi")
    plo = cb.create_witin("rd_plo")
    phi = cb.create_witin("rd_phi")
    prev_ts = cb.create_witin("rd_pts")
    z = cb.create_witin("rd_iszero")
    zinv = cb.create_witin("rd_idinv")
    cb.require_zero("rd_z_def", z - 1 + rid * zinv)
    cb.require_zero("rd_z_mul", z * rid)
    cb.require_zero("rd_zero_lo", z * lo)
    cb.require_zero("rd_zero_hi", z * hi)
    cb.assert_u16(lo)
    cb.assert_u16(hi)
    cb.ram_write(RAM_REGISTER, rid, [plo, phi], [lo, hi], prev_ts, state.ts + subcycle)
    ts_lt_check(cb, "rd", prev_ts, state.ts + subcycle)
    return RdWrite(rid, lo, hi, z)


def fetch(cb: CircuitBuilder, state: StateCols, kind: int, rd, rs1, rs2,
          imm_lo, imm_hi, imm_field):
    """Program-ROM fetch lookup. imm is carried in three encodings (the fixed
    program table stores all three): u16 limbs of the 32-bit two's-complement
    value, and the signed field encoding (for pc arithmetic)."""
    cb.lk_record(
        LK_INSTRUCTION,
        [state.pc, E.Const(kind), rd, rs1, rs2, imm_lo, imm_hi, imm_field],
    )


def is_zero(cb: CircuitBuilder, name: str, expr):
    """z = [expr == 0] via inverse witness."""
    z = cb.create_witin(f"{name}_z")
    inv = cb.create_witin(f"{name}_inv")
    cb.require_zero(f"{name}_zdef", z - 1 + expr * inv)
    cb.require_zero(f"{name}_zmul", z * expr)
    return z


def mem_word_addr(cb: CircuitBuilder, base_value_expr, imm_field_expr):
    """base + imm = 4*waddr with waddr < 2^28 (u16+u12 limbs). Requires the
    platform address-space < p (true for the reference memory map)."""
    waddr = cb.create_witin("mem_waddr")
    wlo = cb.create_witin("mem_walo")
    whi = cb.create_witin("mem_wahi")
    cb.require_zero("mem_align", base_value_expr + imm_field_expr - waddr * 4)
    cb.require_zero("mem_waddr_limbs", waddr - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)
    return waddr


def byte_decompose(cb: CircuitBuilder, name: str, lo, hi):
    """Split u16 limbs (lo, hi) into 4 u8 bytes b0..b3 (le order)."""
    bs = [cb.create_witin(f"{name}_b{i}") for i in range(4)]
    cb.require_zero(f"{name}_lo_bytes", lo - bs[0] - bs[1] * 256)
    cb.require_zero(f"{name}_hi_bytes", hi - bs[2] - bs[3] * 256)
    for b in bs:
        cb.assert_u8(b)
    return bs


def limb_ltu(cb: CircuitBuilder, name: str, a, b):
    """[a < b] for u16-limb values a, b: bit witness + gated range lookup.

    The looked-up value is lt*(b-a-1) + (1-lt)*(a-b): in [0, 2^16) only for
    the correct bit (magnitudes < 2^17 < p, so no field-wrap ambiguity)."""
    lt = cb.create_witin(f"{name}_lt")
    cb.assert_bit(f"{name}_ltb", lt)
    cb.assert_u16(lt * (b - a - 1) + (1 - lt) * (a - b))
    return lt


def u32_ltu(cb: CircuitBuilder, name: str, a: RegRead, b: RegRead):
    """[a < b] unsigned over limb pairs."""
    lt_hi = limb_ltu(cb, f"{name}_hi", a.hi, b.hi)
    lt_lo = limb_ltu(cb, f"{name}_lo", a.lo, b.lo)
    eq_hi = is_zero(cb, f"{name}_eqhi", a.hi - b.hi)
    return lt_hi + eq_hi * lt_lo  # disjoint cases


def sign_split(cb: CircuitBuilder, name: str, hi):
    """hi = top*2^15 + rest, top bit, rest < 2^15 (checked via 2*rest u16)."""
    top = cb.create_witin(f"{name}_top")
    rest = cb.create_witin(f"{name}_rest")
    cb.assert_bit(f"{name}_topb", top)
    cb.require_zero(f"{name}_split", hi - top * (1 << 15) - rest)
    cb.assert_u16(rest * 2)
    return top, rest


def u32_lts(cb: CircuitBuilder, name: str, a: RegRead, b: RegRead):
    """[a < b] signed: flip the sign bits and compare unsigned."""
    a_top, a_rest = sign_split(cb, f"{name}_a", a.hi)
    b_top, b_rest = sign_split(cb, f"{name}_b", b.hi)
    adj_a = a_rest + (1 - a_top) * (1 << 15)
    adj_b = b_rest + (1 - b_top) * (1 << 15)
    lt_hi = limb_ltu(cb, f"{name}_hi", adj_a, adj_b)
    eq_hi = is_zero(cb, f"{name}_eqhi", adj_a - adj_b)
    lt_lo = limb_ltu(cb, f"{name}_lo", a.lo, b.lo)
    return lt_hi + eq_hi * lt_lo


def pc_decompose(cb: CircuitBuilder, state: StateCols):
    """pc = lo + hi*2^16 with hi u12 (pc < 2^28: unique, below p)."""
    lo = cb.create_witin("pc_lo")
    hi = cb.create_witin("pc_hi")
    cb.require_zero("pc_limbs", state.pc - lo - hi * (1 << 16))
    cb.assert_u16(lo)
    cb.assert_u12(hi)
    return lo, hi


def limb_add(cb: CircuitBuilder, name: str, a_lo, a_hi, b_lo, b_hi, out_lo, out_hi, gate=None):
    """u32 add mod 2^32 in limbs with bit carries; all magnitudes < 2^17 < p."""
    c0 = cb.create_witin(f"{name}_c0")
    c1 = cb.create_witin(f"{name}_c1")
    cb.assert_bit(f"{name}_c0b", c0)
    cb.assert_bit(f"{name}_c1b", c1)
    e_lo = a_lo + b_lo - out_lo - c0 * (1 << 16)
    e_hi = a_hi + b_hi + c0 - out_hi - c1 * (1 << 16)
    if gate is not None:
        e_lo = gate * e_lo
        e_hi = gate * e_hi
    cb.require_zero(f"{name}_lo", e_lo)
    cb.require_zero(f"{name}_hi", e_hi)
    return c0, c1
