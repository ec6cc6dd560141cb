"""SHA-256 message-schedule precompile (SHA_EXTEND syscall).

Role mirror of the reference's sha256 precompile (SURVEY.md §2.3:
ceno_emul/src/syscalls/sha256.rs:37-99 and ceno_zkvm precompiles
sha256/extend.rs): one syscall = one w-extension round,

    w[i] = w[i-16] + s0 + w[i-7] + s1  (mod 2^32)
    s0 = ror(w[i-15], 7) ^ ror(w[i-15], 18) ^ (w[i-15] >> 3)
    s1 = ror(w[i-2], 17) ^ ror(w[i-2], 19) ^ (w[i-2] >> 10)

Unlike keccak (24 chained round rows over the Custom bus), the whole
computation fits in ONE uniform row, so no bus is needed: the chip carries
the vm-state chain, the t0/a0 register reads, four preserving memory reads
and the w[i] write, with the bitwise core arithmetized exactly like the
keccak core — per-rotation bit-splits of each byte make the rotated/shifted
bytes linear expressions, and two xor8 lookups per output byte build s0/s1.

Bit-split convention for ror32(w, r), r = 8q + s: each byte b_k of w is
split as b_k = hi_k * 2^s + lo_k (lo_k < 2^s, hi_k < 2^{8-s}); byte j of the
rotation is hi_m + 2^{8-s} * lo_{(m+1)%4} with m = (j+q)%4. Plain shifts use
the same split with the wrapped sources replaced by 0. The split halves are
bound to the committed u16 memory limbs by two linear constraints per split,
so no separate byte witnesses exist.

Copy of ``ceno_tpu/zkvm/chips/sha256.py``: the port keeps its own, with the same
relative imports.
Only the circuit definition and its compile are on the main path (every
key registers this chip); the witgen for nonzero instances is copied but
not yet held against the reference (ROADMAP Queue 1, M10).
"""

from __future__ import annotations

import numpy as np

from ...emulator.rv32im import K
from ...emulator.state import Platform
from ...gkr.chip import compile_chip
from ...gkr.circuit_builder import CircuitBuilder, RAM_MEMORY
from ...mle import expression as E
from . import common as C
from .opcodes import (
    ChipDef,
    TraceView,
    MASK16,
    _limbs,
    _reg_read_cols,
    _state_cols,
    _ts_cols,
)

# (name, word offset below a0) for the four preserving reads; the write goes
# at offset 0. sys_mem block order contract with the emulator.
_READS = (("w2", 2), ("w7", 7), ("w15", 15), ("w16", 16))


def _split_word(cb: CircuitBuilder, name: str, lo_limb, hi_limb, s: int):
    """Split each byte of the word (given as u16 limbs) at bit s.

    Returns (lo, hi): lists of 4 expressions each, lo[k] < 2^s the low s
    bits of byte k, hi[k] < 2^{8-s} the high bits. Binds them to the limbs
    and range-checks every half."""
    lo = [cb.create_witin(f"{name}_l{k}") for k in range(4)]
    hi = [cb.create_witin(f"{name}_h{k}") for k in range(4)]
    for k in range(4):
        if s == 1:
            cb.assert_bit(f"{name}_lb{k}", lo[k])
        else:
            cb.assert_u8(lo[k] * (1 << (8 - s)))
        if s == 7:
            cb.assert_bit(f"{name}_hb{k}", hi[k])
        else:
            cb.assert_u8(hi[k] * (1 << s))
    byte = [lo[k] + hi[k] * (1 << s) for k in range(4)]
    cb.require_zero(f"{name}_lo", lo_limb - byte[0] - byte[1] * 256)
    cb.require_zero(f"{name}_hi", hi_limb - byte[2] - byte[3] * 256)
    return lo, hi


def _ror_bytes(split, q: int, s: int):
    """Byte expressions of ror32(w, 8q+s) from w's s-split halves."""
    lo, hi = split
    out = []
    for j in range(4):
        m = (j + q) % 4
        out.append(hi[m] + lo[(m + 1) % 4] * (1 << (8 - s)))
    return out


def _shr_bytes(split, q: int, s: int):
    """Byte expressions of (w >> (8q+s)) — like ror but without wrap."""
    lo, hi = split
    out = []
    for j in range(4):
        m = j + q
        if m > 3:
            out.append(E.Const(0))
            continue
        e = hi[m]
        if m + 1 <= 3:
            e = e + lo[m + 1] * (1 << (8 - s))
        out.append(e)
    return out


def _xor3(cb: CircuitBuilder, name: str, a, b, c):
    """Byte-wise t = a ^ b, out = t ^ c over 4-byte words of expressions."""
    out = []
    for k in range(4):
        t = cb.create_witin(f"{name}_t{k}")
        cb.lk_xor8(a[k], b[k], t)
        if isinstance(c[k], E.Const) and c[k].value == 0:
            out.append(t)
            continue
        o = cb.create_witin(f"{name}_o{k}")
        cb.lk_xor8(t, c[k], o)
        out.append(o)
    return out


def build_sha_extend_chip() -> ChipDef:
    cb = CircuitBuilder("sha_extend")
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    code = Platform.ECALL_SHA_EXTEND
    cb.require_zero("code_lo", t0.lo - (code & MASK16))
    cb.require_zero("code_hi", t0.hi - (code >> 16))
    # state_ptr = 4 * w, w < 2^28 (platform address space < p, common.py)
    w = cb.create_witin("sp_w")
    wlo = cb.create_witin("sp_wlo")
    whi = cb.create_witin("sp_whi")
    cb.require_zero("sp_align", a0.lo + a0.hi * (1 << 16) - w * 4)
    cb.require_zero("sp_limbs", w - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)

    # four preserving reads (value kept; fresh limbs are the same witins)
    limbs = {}
    for name, off in _READS:
        lo = cb.create_witin(f"{name}_mlo")
        hi = cb.create_witin(f"{name}_mhi")
        pts = cb.create_witin(f"{name}_mpts")
        cb.assert_u16(lo)
        cb.assert_u16(hi)
        cb.ram_write(RAM_MEMORY, w - off, [lo, hi], [lo, hi], pts, st.ts + 3)
        C.ts_lt_check(cb, f"{name}_m", pts, st.ts + 3)
        limbs[name] = (lo, hi)

    # bit-splits: w15 at s=7 (ror 7), s=2 (ror 18), s=3 (shr 3);
    #             w2 at s=1 (ror 17), s=3 (ror 19), s=2 (shr 10)
    w15 = limbs["w15"]
    w2 = limbs["w2"]
    sp15_7 = _split_word(cb, "s15a", w15[0], w15[1], 7)
    sp15_2 = _split_word(cb, "s15b", w15[0], w15[1], 2)
    sp15_3 = _split_word(cb, "s15c", w15[0], w15[1], 3)
    sp2_1 = _split_word(cb, "s2a", w2[0], w2[1], 1)
    sp2_3 = _split_word(cb, "s2b", w2[0], w2[1], 3)
    sp2_2 = _split_word(cb, "s2c", w2[0], w2[1], 2)

    s0 = _xor3(
        cb, "s0",
        _ror_bytes(sp15_7, 0, 7),   # ror 7  = 8*0 + 7
        _ror_bytes(sp15_2, 2, 2),   # ror 18 = 8*2 + 2
        _shr_bytes(sp15_3, 0, 3),   # shr 3
    )
    s1 = _xor3(
        cb, "s1",
        _ror_bytes(sp2_1, 2, 1),    # ror 17 = 8*2 + 1
        _ror_bytes(sp2_3, 2, 3),    # ror 19 = 8*2 + 3
        _shr_bytes(sp2_2, 1, 2),    # shr 10 = 8*1 + 2
    )
    s0_lo, s0_hi = s0[0] + s0[1] * 256, s0[2] + s0[3] * 256
    s1_lo, s1_hi = s1[0] + s1[1] * 256, s1[2] + s1[3] * 256

    # w[i] = w16 + s0 + w7 + s1 (mod 2^32), u16-limb carries
    new_lo = cb.create_witin("new_lo")
    new_hi = cb.create_witin("new_hi")
    c0 = cb.create_witin("add_c0")
    c1 = cb.create_witin("add_c1")
    cb.assert_u16(new_lo)
    cb.assert_u16(new_hi)
    cb.assert_u4(c0)
    cb.assert_u4(c1)
    w7, w16 = limbs["w7"], limbs["w16"]
    cb.require_zero(
        "add_lo", w16[0] + s0_lo + w7[0] + s1_lo - new_lo - c0 * (1 << 16)
    )
    cb.require_zero(
        "add_hi", w16[1] + s0_hi + w7[1] + s1_hi + c0 - new_hi - c1 * (1 << 16)
    )

    # the write at a0: previous value unconstrained, new value = w[i]
    wp_lo = cb.create_witin("wi_plo")
    wp_hi = cb.create_witin("wi_phi")
    wp_ts = cb.create_witin("wi_pts")
    cb.ram_write(RAM_MEMORY, w, [wp_lo, wp_hi], [new_lo, new_hi], wp_ts, st.ts + 3)
    C.ts_lt_check(cb, "wi", wp_ts, st.ts + 3)

    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["ECALL"], 0, 0, 0, 0, 0, 0)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("t0", "rs1", v, ts + 0, with_id=False))
        cols.update(_reg_read_cols("a0", "rs2", v, ts + 1, with_id=False))
        ptr = v.rs2_val.astype(np.uint64)
        wv = ptr >> 2
        cols.update({"sp_w": wv, "sp_wlo": wv & MASK16, "sp_whi": wv >> 16})
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        pts = v.sys_pts[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        words = {}
        for j, (name, _off) in enumerate(_READS):
            lo, hi = _limbs(prev[:, j])
            cols.update({f"{name}_mlo": lo, f"{name}_mhi": hi,
                         f"{name}_mpts": pts[:, j]})
            cols.update(_ts_cols(f"{name}_m", pts[:, j], ts + 3))
            words[name] = prev[:, j]

        def fill_split(name, word, s):
            for k in range(4):
                byte = (word >> (8 * k)) & 0xFF
                cols[f"{name}_l{k}"] = byte & ((1 << s) - 1)
                cols[f"{name}_h{k}"] = byte >> s

        fill_split("s15a", words["w15"], 7)
        fill_split("s15b", words["w15"], 2)
        fill_split("s15c", words["w15"], 3)
        fill_split("s2a", words["w2"], 1)
        fill_split("s2b", words["w2"], 3)
        fill_split("s2c", words["w2"], 2)

        def ror(vv, r):
            return ((vv >> r) | (vv << (32 - r))) & 0xFFFFFFFF

        s0w = ror(words["w15"], 7) ^ ror(words["w15"], 18) ^ (words["w15"] >> 3)
        s1w = ror(words["w2"], 17) ^ ror(words["w2"], 19) ^ (words["w2"] >> 10)

        def fill_xor3(name, a, b, cw):
            for k in range(4):
                ab = ((a >> (8 * k)) ^ (b >> (8 * k))) & 0xFF
                cols[f"{name}_t{k}"] = ab
                ck = (cw >> (8 * k)) & 0xFF
                okey = f"{name}_o{k}"
                cols[okey] = ab ^ ck

        fill_xor3("s0", ror(words["w15"], 7), ror(words["w15"], 18),
                  words["w15"] >> 3)
        fill_xor3("s1", ror(words["w2"], 17), ror(words["w2"], 19),
                  words["w2"] >> 10)
        # s1 byte 3 of the shift operand is 0 -> no o3 witness exists
        cols.pop("s1_o3", None)

        total = (words["w16"] + s0w + words["w7"] + s1w)
        nlo, nhi = _limbs(total & 0xFFFFFFFF)
        lo_sum = (words["w16"] & MASK16) + (s0w & MASK16) + \
            (words["w7"] & MASK16) + (s1w & MASK16)
        c0v = lo_sum >> 16
        hi_sum = (words["w16"] >> 16) + (s0w >> 16) + (words["w7"] >> 16) + \
            (s1w >> 16) + c0v
        cols.update({"new_lo": nlo, "new_hi": nhi,
                     "add_c0": c0v, "add_c1": hi_sum >> 16})
        plo, phi = _limbs(prev[:, 4])
        cols.update({"wi_plo": plo, "wi_phi": phi, "wi_pts": pts[:, 4]})
        cols.update(_ts_cols("wi", pts[:, 4], ts + 3))
        # sanity: emulator and circuit agree on the written word
        assert np.array_equal(newv[:, 4], total & 0xFFFFFFFF)
        return cols

    return ChipDef(
        "sha_extend", (K["SYS_SHA_EXTEND"],), cb, compile_chip(cb), assign
    )
