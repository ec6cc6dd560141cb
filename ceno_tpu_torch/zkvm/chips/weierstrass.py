"""Short-Weierstrass curve precompiles: secp256k1, secp256r1, bn254.

Role mirror of the reference's weierstrass + fptower precompiles
(ceno_emul/src/syscalls/{secp256k1,secp256r1,bn254/*}.rs and the sp1-derived
circuits ceno_zkvm/src/precompiles/weierstrass/*.rs, fptower/*.rs): each
syscall is one uniform row proving a group/field operation over a 256-bit
prime field with the positional carry-chain gadgets from u256.py
(mul_expr_chain / add_mod_chain / lt_const_chain).

Operand convention (matches the reference memory layout): a point is 16
words — x then y, both little-endian 8-word coordinates. ADD overwrites P
(at a0) with P+Q (Q at a1, read-only); DOUBLE overwrites P in place;
DECOMPRESS reads x at a0 and writes y at a0+32 with parity from a1;
SCALAR_INVERT inverts an 8-word scalar mod the curve ORDER in place.
BN254_FP/FP2 ops overwrite x (at a0) with x op y (y at a1).

Circuit shape per ADD (chord rule, guest contract x1 != x2 — the emulator
rejects P = +-Q like the sp1 patches route doubling separately):
    m1: lambda * (x2 + p - x1) + 2p == (y2 + p - y1)   (mod p)
    m2: lambda * lambda + 2p == (x1 + x2 + x3)         (mod p)
    m3: lambda * (x1 + p - x3) + 2p == (y1 + y3)       (mod p)
with x3, y3 canonicality enforced by lt_const_chain; input coordinates are
also range-checked below p (the emulator's point parser rejects
non-canonical encodings, so a valid trace cannot contain them). On-curve
membership of inputs is NOT checked, matching the reference circuits.
The b/r operands of the chains are byte EXPRESSIONS (coefficients <= ~765),
so no difference witnesses exist — only lambda, quotients, and carries.

Copy of ``ceno_tpu/zkvm/chips/weierstrass.py``: the port keeps its own, with the same
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
from ...gkr.circuit_builder import CircuitBuilder, RAM_MEMORY, RAM_REGISTER
from ...mle import expression as E
from . import common as C
from .opcodes import (
    ChipDef,
    TraceView,
    MASK16,
    _reg_read_cols,
    _state_cols,
    _ts_cols,
)
from .u256 import (
    make_bytes,
    limb_exprs,
    fill_bytes,
    mul_expr_chain,
    fill_mul_expr_chain,
    add_mod_chain,
    fill_add_mod_chain,
    lt_const_chain,
    fill_lt_const_chain,
)

# curve registry (public parameter sets; shared with the emulator)
from ...emulator.curves import CURVES


def _bytes_of_const(v: int, n: int = 33):
    return [(v >> (8 * k)) & 0xFF for k in range(n)]


def _pos_sub_with_p(hi, lo, p: int):
    """Byte expressions of (HI + p - LO) per position (coeff <= 765)."""
    pb = _bytes_of_const(p, 32)
    return [hi[j] + pb[j] - lo[j] for j in range(32)]


def _pos_vals(v: int, n: int = 32):
    return [(v >> (8 * k)) & 0xFF for k in range(n)]


def _pos_sub_vals(hi: int, lo: int, p: int):
    return [
        ((hi >> (8 * j)) & 0xFF) + ((p >> (8 * j)) & 0xFF)
        - ((lo >> (8 * j)) & 0xFF)
        for j in range(32)
    ]


# ---------------------------------------------------------------------------
# shared ecall scaffolding
# ---------------------------------------------------------------------------

def _ecall_head(cb: CircuitBuilder, code: int, with_a1: bool):
    """state + t0 code check + a0 pointer (+ optional a1 via the rd slot).
    Returns (state, xw_word_expr, a1 handle or None)."""
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    cb.require_zero("code_lo", t0.lo - (code & MASK16))
    cb.require_zero("code_hi", t0.hi - (code >> 16))
    w = cb.create_witin("xp_w")
    wlo = cb.create_witin("xp_wlo")
    whi = cb.create_witin("xp_whi")
    cb.require_zero("xp_align", a0.lo + a0.hi * (1 << 16) - w * 4)
    cb.require_zero("xp_limbs", w - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)
    a1 = None
    if with_a1:
        a1_lo = cb.create_witin("a1_lo")
        a1_hi = cb.create_witin("a1_hi")
        a1_pts = cb.create_witin("a1_pts")
        cb.ram_write(RAM_REGISTER, E.Const(11), [a1_lo, a1_hi],
                     [a1_lo, a1_hi], a1_pts, st.ts + 2)
        C.ts_lt_check(cb, "a1", a1_pts, st.ts + 2)
        a1 = (a1_lo, a1_hi)
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["ECALL"], 0, 0, 0, 0, 0, 0)
    return st, w, a1


def _a1_word(cb: CircuitBuilder, a1):
    w = cb.create_witin("yp_w")
    wlo = cb.create_witin("yp_wlo")
    whi = cb.create_witin("yp_whi")
    cb.require_zero("yp_align", a1[0] + a1[1] * (1 << 16) - w * 4)
    cb.require_zero("yp_limbs", w - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)
    return w


def _mem_value(cb: CircuitBuilder, st, prefix: str, base_w, word_off: int,
               prev_exprs, new_exprs, n_words: int = 8):
    """n_words memory ops at base_w+word_off+i with limb expressions."""
    for i in range(n_words):
        pts = cb.create_witin(f"{prefix}{i}_pts")
        cb.ram_write(RAM_MEMORY, base_w + (word_off + i),
                     list(prev_exprs[i]), list(new_exprs[i]), pts, st.ts + 3)
        C.ts_lt_check(cb, f"{prefix}{i}", pts, st.ts + 3)


def _fill_head(cols, v, with_a1: bool):
    ts = cols["ts"]
    cols.update(_reg_read_cols("t0", "rs1", v, ts + 0, with_id=False))
    cols.update(_reg_read_cols("a0", "rs2", v, ts + 1, with_id=False))
    wv = v.rs2_val.astype(np.uint64) >> 2
    cols.update({"xp_w": wv, "xp_wlo": wv & MASK16, "xp_whi": wv >> 16})
    if with_a1:
        a1v = v.rd_val.astype(np.uint64)
        cols.update({"a1_lo": a1v & MASK16, "a1_hi": a1v >> 16,
                     "a1_pts": v.rd_pts})
        cols.update(_ts_cols("a1", v.rd_pts, ts + 2))
        yw = a1v >> 2
        cols.update({"yp_w": yw, "yp_wlo": yw & MASK16, "yp_whi": yw >> 16})


def _fill_mem_ts(cols, v, prefix: str, start: int, n_words: int = 8):
    ts = cols["ts"]
    pts = v.sys_pts[v.sys_idx].astype(np.uint64)
    for i in range(n_words):
        cols[f"{prefix}{i}_pts"] = pts[:, start + i]
        cols.update(_ts_cols(f"{prefix}{i}", pts[:, start + i], ts + 3))


def _val256(words):
    """(rows, 8) word array -> list of python ints."""
    return [sum(int(r[i]) << (32 * i) for i in range(8)) for r in words]


# ---------------------------------------------------------------------------
# curve point add / double
# ---------------------------------------------------------------------------

def build_ec_add_chip(curve: str) -> ChipDef:
    cfg = CURVES[curve]
    p = cfg["p"]
    code = getattr(Platform, f"ECALL_{curve.upper()}_ADD")
    kind = K[f"SYS_{curve.upper()}_ADD"]
    cb = CircuitBuilder(f"{curve}_add")
    st, xw, a1 = _ecall_head(cb, code, with_a1=True)
    yw = _a1_word(cb, a1)

    x1 = make_bytes(cb, "x1")
    y1 = make_bytes(cb, "y1")
    x2 = make_bytes(cb, "x2")
    y2 = make_bytes(cb, "y2")
    x3 = make_bytes(cb, "x3")
    y3 = make_bytes(cb, "y3")
    lam = make_bytes(cb, "lam")

    for nm, arr in (("x1", x1), ("y1", y1), ("x2", x2), ("y2", y2),
                    ("x3", x3), ("y3", y3)):
        lt_const_chain(cb, f"lt_{nm}", arr, p)

    mul_expr_chain(cb, "m1", lam, _pos_sub_with_p(x2, x1, p),
                   _pos_sub_with_p(y2, y1, p), p, lhs_const=2 * p)
    mul_expr_chain(cb, "m2", lam, lam,
                   [x1[j] + x2[j] + x3[j] for j in range(32)], p,
                   lhs_const=2 * p)
    mul_expr_chain(cb, "m3", lam, _pos_sub_with_p(x1, x3, p),
                   [y1[j] + y3[j] for j in range(32)], p, lhs_const=2 * p)

    _mem_value(cb, st, "mp", xw, 0,
               limb_exprs(x1) + limb_exprs(y1),
               limb_exprs(x3) + limb_exprs(y3), 16)
    _mem_value(cb, st, "mq", yw, 0,
               limb_exprs(x2) + limb_exprs(y2),
               limb_exprs(x2) + limb_exprs(y2), 16)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=True)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        x1s, y1s = _val256(prev[:, 0:8]), _val256(prev[:, 8:16])
        x2s, y2s = _val256(prev[:, 16:24]), _val256(prev[:, 24:32])
        x3s, y3s = _val256(newv[:, 0:8]), _val256(newv[:, 8:16])
        lams = [
            (y2 - y1) * pow(x2 - x1, p - 2, p) % p
            for x1_, y1, x2, y2 in zip(x1s, y1s, x2s, y2s)
            for x1 in [x1_]
        ]
        for nm, vals in (("x1", x1s), ("y1", y1s), ("x2", x2s), ("y2", y2s),
                         ("x3", x3s), ("y3", y3s), ("lam", lams)):
            fill_bytes(cols, nm, vals)
        for nm, vals in (("x1", x1s), ("y1", y1s), ("x2", x2s), ("y2", y2s),
                         ("x3", x3s), ("y3", y3s)):
            fill_lt_const_chain(cols, f"lt_{nm}", vals, p)
        fill_mul_expr_chain(
            cols, "m1",
            [(l, _pos_sub_vals(x2, x1, p), _pos_sub_vals(y2, y1, p))
             for l, x1, x2, y2, y1 in zip(lams, x1s, x2s, y2s, y1s)],
            p, lhs_const=2 * p,
        )
        fill_mul_expr_chain(
            cols, "m2",
            [(l, _pos_vals(l), [a + b_ + c_ for a, b_, c_ in
              zip(_pos_vals(x1), _pos_vals(x2), _pos_vals(x3))])
             for l, x1, x2, x3 in zip(lams, x1s, x2s, x3s)],
            p, lhs_const=2 * p,
        )
        fill_mul_expr_chain(
            cols, "m3",
            [(l, _pos_sub_vals(x1, x3, p), [a + b_ for a, b_ in
              zip(_pos_vals(y1), _pos_vals(y3))])
             for l, x1, x3, y1, y3 in zip(lams, x1s, x3s, y1s, y3s)],
            p, lhs_const=2 * p,
        )
        _fill_mem_ts(cols, v, "mp", 0, 16)
        _fill_mem_ts(cols, v, "mq", 16, 16)
        return cols

    return ChipDef(f"{curve}_add", (kind,), cb, compile_chip(cb), assign)


def build_ec_double_chip(curve: str) -> ChipDef:
    cfg = CURVES[curve]
    p, a = cfg["p"], cfg["a"] % cfg["p"]
    code = getattr(Platform, f"ECALL_{curve.upper()}_DOUBLE")
    kind = K[f"SYS_{curve.upper()}_DOUBLE"]
    cb = CircuitBuilder(f"{curve}_double")
    st, xw, _ = _ecall_head(cb, code, with_a1=False)

    x1 = make_bytes(cb, "x1")
    y1 = make_bytes(cb, "y1")
    x3 = make_bytes(cb, "x3")
    y3 = make_bytes(cb, "y3")
    t = make_bytes(cb, "t")      # x1^2 mod p
    lam = make_bytes(cb, "lam")

    for nm, arr in (("x1", x1), ("y1", y1), ("x3", x3), ("y3", y3),
                    ("t", t)):
        lt_const_chain(cb, f"lt_{nm}", arr, p)

    ab = _bytes_of_const(a, 32)
    mul_expr_chain(cb, "ma", x1, x1, [t[j] for j in range(32)], p)
    # lambda * 2y == 3t + a  (mod p); R < 4p so 4p on the left
    mul_expr_chain(cb, "mb", lam, [y1[j] * 2 for j in range(32)],
                   [t[j] * 3 + ab[j] for j in range(32)], p, lhs_const=4 * p)
    mul_expr_chain(cb, "mc", lam, lam,
                   [x1[j] * 2 + x3[j] for j in range(32)], p, lhs_const=2 * p)
    mul_expr_chain(cb, "md", lam, _pos_sub_with_p(x1, x3, p),
                   [y1[j] + y3[j] for j in range(32)], p, lhs_const=2 * p)

    _mem_value(cb, st, "mp", xw, 0,
               limb_exprs(x1) + limb_exprs(y1),
               limb_exprs(x3) + limb_exprs(y3), 16)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=False)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        x1s, y1s = _val256(prev[:, 0:8]), _val256(prev[:, 8:16])
        x3s, y3s = _val256(newv[:, 0:8]), _val256(newv[:, 8:16])
        ts_ = [x * x % p for x in x1s]
        lams = [
            (3 * t_ + a) * pow(2 * y, p - 2, p) % p
            for t_, y in zip(ts_, y1s)
        ]
        for nm, vals in (("x1", x1s), ("y1", y1s), ("x3", x3s),
                         ("y3", y3s), ("t", ts_), ("lam", lams)):
            fill_bytes(cols, nm, vals)
        for nm, vals in (("x1", x1s), ("y1", y1s), ("x3", x3s),
                         ("y3", y3s), ("t", ts_)):
            fill_lt_const_chain(cols, f"lt_{nm}", vals, p)
        fill_mul_expr_chain(
            cols, "ma",
            [(x, _pos_vals(x), _pos_vals(t_)) for x, t_ in zip(x1s, ts_)],
            p,
        )
        apos = _pos_vals(a)
        fill_mul_expr_chain(
            cols, "mb",
            [(l, [2 * b_ for b_ in _pos_vals(y)],
              [3 * tv + av for tv, av in zip(_pos_vals(t_), apos)])
             for l, y, t_ in zip(lams, y1s, ts_)],
            p, lhs_const=4 * p,
        )
        fill_mul_expr_chain(
            cols, "mc",
            [(l, _pos_vals(l), [2 * xa + xb for xa, xb in
              zip(_pos_vals(x1), _pos_vals(x3))])
             for l, x1, x3 in zip(lams, x1s, x3s)],
            p, lhs_const=2 * p,
        )
        fill_mul_expr_chain(
            cols, "md",
            [(l, _pos_sub_vals(x1, x3, p), [ya + yb for ya, yb in
              zip(_pos_vals(y1), _pos_vals(y3))])
             for l, x1, x3, y1, y3 in zip(lams, x1s, x3s, y1s, y3s)],
            p, lhs_const=2 * p,
        )
        _fill_mem_ts(cols, v, "mp", 0, 16)
        return cols

    return ChipDef(f"{curve}_double", (kind,), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# decompress + scalar invert
# ---------------------------------------------------------------------------

def build_ec_decompress_chip(curve: str) -> ChipDef:
    cfg = CURVES[curve]
    p, a, b = cfg["p"], cfg["a"] % cfg["p"], cfg["b"]
    code = getattr(Platform, f"ECALL_{curve.upper()}_DECOMPRESS")
    kind = K[f"SYS_{curve.upper()}_DECOMPRESS"]
    cb = CircuitBuilder(f"{curve}_decompress")
    st, xw, a1 = _ecall_head(cb, code, with_a1=True)
    # a1 is the parity flag (0/1), not a pointer
    cb.require_zero("parity_hi", a1[1])
    cb.require_zero("parity_bit", E.Prod([a1[0], a1[0] - 1]))

    x = make_bytes(cb, "x")
    y = make_bytes(cb, "y")
    t = make_bytes(cb, "t")   # x^2 mod p
    u = make_bytes(cb, "u")   # x^3 mod p
    yprev = [
        (cb.create_witin(f"yp{i}_plo"), cb.create_witin(f"yp{i}_phi"))
        for i in range(8)
    ]
    for nm, arr in (("x", x), ("y", y), ("t", t), ("u", u)):
        lt_const_chain(cb, f"lt_{nm}", arr, p)
    # parity: y mod 2 == a1
    yhalf = cb.create_witin("y_half")
    cb.assert_u8(yhalf * 2)
    cb.require_zero("y_parity", y[0] - a1[0] - yhalf * 2)

    bb_ = _bytes_of_const(b, 32)
    mul_expr_chain(cb, "ma", x, x, [t[j] for j in range(32)], p)
    mul_expr_chain(cb, "mb", t, x, [u[j] for j in range(32)], p)
    if a == 0:
        # y^2 + 2p == u + b  (mod p)
        mul_expr_chain(cb, "mc", y, y,
                       [u[j] + bb_[j] for j in range(32)], p,
                       lhs_const=2 * p)
    else:
        # nonzero a needs the extra product ax = a*x mod p, then
        # y^2 + 2p == u + ax + b  (mod p)
        ax = make_bytes(cb, "ax")
        lt_const_chain(cb, "lt_ax", ax, p)
        mul_expr_chain(cb, "mx", x, _bytes_of_const(a, 32),
                       [ax[j] for j in range(32)], p)
        mul_expr_chain(cb, "mc", y, y,
                       [u[j] + ax[j] + bb_[j] for j in range(32)], p,
                       lhs_const=2 * p)

    _mem_value(cb, st, "mx", xw, 0, limb_exprs(x), limb_exprs(x), 8)
    _mem_value(cb, st, "my", xw, 8, yprev, limb_exprs(y), 8)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=True)
        # a1 here is the parity word, not a pointer: drop the derived cols
        for k_ in ("yp_w", "yp_wlo", "yp_whi"):
            cols.pop(k_, None)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        xs = _val256(prev[:, 0:8])
        ys = _val256(newv[:, 8:16])
        ts_ = [x_ * x_ % p for x_ in xs]
        us = [t_ * x_ % p for t_, x_ in zip(ts_, xs)]
        for nm, vals in (("x", xs), ("y", ys), ("t", ts_), ("u", us)):
            fill_bytes(cols, nm, vals)
            fill_lt_const_chain(cols, f"lt_{nm}", vals, p)
        cols["y_half"] = np.array(
            [((y_ & 0xFF) >> 1) for y_ in ys], np.uint64
        )
        fill_mul_expr_chain(
            cols, "ma", [(x_, _pos_vals(x_), _pos_vals(t_))
                         for x_, t_ in zip(xs, ts_)], p)
        fill_mul_expr_chain(
            cols, "mb", [(t_, _pos_vals(x_), _pos_vals(u_))
                         for t_, x_, u_ in zip(ts_, xs, us)], p)
        bpos = _pos_vals(b)
        if a == 0:
            fill_mul_expr_chain(
                cols, "mc",
                [(y_, _pos_vals(y_), [uv + bv for uv, bv in
                  zip(_pos_vals(u_), bpos)]) for y_, u_ in zip(ys, us)],
                p, lhs_const=2 * p)
        else:
            axs = [a * x_ % p for x_ in xs]
            fill_bytes(cols, "ax", axs)
            fill_lt_const_chain(cols, "lt_ax", axs, p)
            fill_mul_expr_chain(
                cols, "mx", [(x_, _pos_vals(a), _pos_vals(ax_))
                             for x_, ax_ in zip(xs, axs)], p)
            fill_mul_expr_chain(
                cols, "mc",
                [(y_, _pos_vals(y_), [uv + av + bv for uv, av, bv in
                  zip(_pos_vals(u_), _pos_vals(ax_), bpos)])
                 for y_, u_, ax_ in zip(ys, us, axs)],
                p, lhs_const=2 * p)
        for i in range(8):
            yp = prev[:, 8 + i]
            cols[f"yp{i}_plo"] = yp & MASK16
            cols[f"yp{i}_phi"] = yp >> 16
        _fill_mem_ts(cols, v, "mx", 0, 8)
        _fill_mem_ts(cols, v, "my", 8, 8)
        return cols

    return ChipDef(
        f"{curve}_decompress", (kind,), cb, compile_chip(cb), assign
    )


def build_ec_invert_chip(curve: str) -> ChipDef:
    n = CURVES[curve]["order"]
    code = getattr(Platform, f"ECALL_{curve.upper()}_SCALAR_INVERT")
    kind = K[f"SYS_{curve.upper()}_SCALAR_INVERT"]
    cb = CircuitBuilder(f"{curve}_invert")
    st, xw, _ = _ecall_head(cb, code, with_a1=False)
    s = make_bytes(cb, "s")
    w_ = make_bytes(cb, "w")
    lt_const_chain(cb, "lt_s", s, n)
    lt_const_chain(cb, "lt_w", w_, n)
    mul_expr_chain(cb, "mi", s, [w_[j] for j in range(32)], [E.Const(1)], n)
    _mem_value(cb, st, "ms", xw, 0, limb_exprs(s), limb_exprs(w_), 8)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=False)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        ss, ws = _val256(prev[:, 0:8]), _val256(newv[:, 0:8])
        fill_bytes(cols, "s", ss)
        fill_bytes(cols, "w", ws)
        fill_lt_const_chain(cols, "lt_s", ss, n)
        fill_lt_const_chain(cols, "lt_w", ws, n)
        fill_mul_expr_chain(
            cols, "mi", [(s_, _pos_vals(w__), [1]) for s_, w__ in
                         zip(ss, ws)], n)
        _fill_mem_ts(cols, v, "ms", 0, 8)
        return cols

    return ChipDef(f"{curve}_invert", (kind,), cb, compile_chip(cb), assign)


# ---------------------------------------------------------------------------
# bn254 base-field tower ops
# ---------------------------------------------------------------------------

def build_bn254_fp_chip(op: str) -> ChipDef:
    """FP_ADD / FP_MUL: x (at a0, overwritten) op y (at a1)."""
    p = CURVES["bn254"]["p"]
    code = getattr(Platform, f"ECALL_BN254_FP_{op.upper()}")
    kind = K[f"SYS_BN254_FP_{op.upper()}"]
    cb = CircuitBuilder(f"bn254_fp_{op}")
    st, xw, a1 = _ecall_head(cb, code, with_a1=True)
    yw = _a1_word(cb, a1)
    x = make_bytes(cb, "x")
    y = make_bytes(cb, "y")
    r = make_bytes(cb, "r")
    for nm, arr in (("x", x), ("y", y), ("r", r)):
        lt_const_chain(cb, f"lt_{nm}", arr, p)
    if op == "add":
        add_mod_chain(cb, "fa", x, y, r, p, n_e=1)
    else:
        mul_expr_chain(cb, "fm", x, [y[j] for j in range(32)],
                       [r[j] for j in range(32)], p)
    _mem_value(cb, st, "mx", xw, 0, limb_exprs(x), limb_exprs(r), 8)
    _mem_value(cb, st, "my", yw, 0, limb_exprs(y), limb_exprs(y), 8)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=True)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        xs, ys = _val256(prev[:, 0:8]), _val256(prev[:, 8:16])
        rs = _val256(newv[:, 0:8])
        for nm, vals in (("x", xs), ("y", ys), ("r", rs)):
            fill_bytes(cols, nm, vals)
            fill_lt_const_chain(cols, f"lt_{nm}", vals, p)
        if op == "add":
            fill_add_mod_chain(cols, "fa", xs, ys, rs, p, n_e=1)
        else:
            fill_mul_expr_chain(
                cols, "fm", [(x_, _pos_vals(y_), _pos_vals(r_))
                             for x_, y_, r_ in zip(xs, ys, rs)], p)
        _fill_mem_ts(cols, v, "mx", 0, 8)
        _fill_mem_ts(cols, v, "my", 8, 8)
        return cols

    return ChipDef(f"bn254_fp_{op}", (kind,), cb, compile_chip(cb), assign)


def build_bn254_fp2_chip(op: str) -> ChipDef:
    """FP2_ADD / FP2_MUL over Fp[u]/(u^2+1): 16-word operands (c0 || c1)."""
    p = CURVES["bn254"]["p"]
    code = getattr(Platform, f"ECALL_BN254_FP2_{op.upper()}")
    kind = K[f"SYS_BN254_FP2_{op.upper()}"]
    cb = CircuitBuilder(f"bn254_fp2_{op}")
    st, xw, a1 = _ecall_head(cb, code, with_a1=True)
    yw = _a1_word(cb, a1)
    a0c = make_bytes(cb, "a0c")
    a1c = make_bytes(cb, "a1c")
    b0c = make_bytes(cb, "b0c")
    b1c = make_bytes(cb, "b1c")
    r0c = make_bytes(cb, "r0c")
    r1c = make_bytes(cb, "r1c")
    for nm, arr in (("a0c", a0c), ("a1c", a1c), ("b0c", b0c),
                    ("b1c", b1c), ("r0c", r0c), ("r1c", r1c)):
        lt_const_chain(cb, f"lt_{nm}", arr, p)
    if op == "add":
        add_mod_chain(cb, "f0", a0c, b0c, r0c, p, n_e=1)
        add_mod_chain(cb, "f1", a1c, b1c, r1c, p, n_e=1)
    else:
        # r0 = a0*b0 - a1*b1, r1 = a0*b1 + a1*b0  (mod p, u^2 = -1)
        t1 = make_bytes(cb, "t1")   # a1*b1 mod p
        t2 = make_bytes(cb, "t2")   # a0*b1 mod p
        lt_const_chain(cb, "lt_t1", t1, p)
        lt_const_chain(cb, "lt_t2", t2, p)
        mul_expr_chain(cb, "fA", a1c, [b1c[j] for j in range(32)],
                       [t1[j] for j in range(32)], p)
        mul_expr_chain(cb, "fB", a0c, [b0c[j] for j in range(32)],
                       [r0c[j] + t1[j] for j in range(32)], p,
                       lhs_const=2 * p)
        mul_expr_chain(cb, "fC", a0c, [b1c[j] for j in range(32)],
                       [t2[j] for j in range(32)], p)
        mul_expr_chain(cb, "fD", a1c, [b0c[j] for j in range(32)],
                       [r1c[j] - t2[j] for j in range(32)], p,
                       lhs_const=2 * p)
    _mem_value(cb, st, "mx", xw, 0,
               limb_exprs(a0c) + limb_exprs(a1c),
               limb_exprs(r0c) + limb_exprs(r1c), 16)
    _mem_value(cb, st, "my", yw, 0,
               limb_exprs(b0c) + limb_exprs(b1c),
               limb_exprs(b0c) + limb_exprs(b1c), 16)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        _fill_head(cols, v, with_a1=True)
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        a0s, a1s = _val256(prev[:, 0:8]), _val256(prev[:, 8:16])
        b0s, b1s = _val256(prev[:, 16:24]), _val256(prev[:, 24:32])
        r0s, r1s = _val256(newv[:, 0:8]), _val256(newv[:, 8:16])
        for nm, vals in (("a0c", a0s), ("a1c", a1s), ("b0c", b0s),
                         ("b1c", b1s), ("r0c", r0s), ("r1c", r1s)):
            fill_bytes(cols, nm, vals)
            fill_lt_const_chain(cols, f"lt_{nm}", vals, p)
        if op == "add":
            fill_add_mod_chain(cols, "f0", a0s, b0s, r0s, p, n_e=1)
            fill_add_mod_chain(cols, "f1", a1s, b1s, r1s, p, n_e=1)
        else:
            t1s = [a1_ * b1_ % p for a1_, b1_ in zip(a1s, b1s)]
            t2s = [a0_ * b1_ % p for a0_, b1_ in zip(a0s, b1s)]
            fill_bytes(cols, "t1", t1s)
            fill_bytes(cols, "t2", t2s)
            fill_lt_const_chain(cols, "lt_t1", t1s, p)
            fill_lt_const_chain(cols, "lt_t2", t2s, p)
            fill_mul_expr_chain(
                cols, "fA", [(a1_, _pos_vals(b1_), _pos_vals(t1_))
                             for a1_, b1_, t1_ in zip(a1s, b1s, t1s)], p)
            fill_mul_expr_chain(
                cols, "fB",
                [(a0_, _pos_vals(b0_),
                  [rv + tv for rv, tv in zip(_pos_vals(r0_), _pos_vals(t1_))])
                 for a0_, b0_, r0_, t1_ in zip(a0s, b0s, r0s, t1s)],
                p, lhs_const=2 * p)
            fill_mul_expr_chain(
                cols, "fC", [(a0_, _pos_vals(b1_), _pos_vals(t2_))
                             for a0_, b1_, t2_ in zip(a0s, b1s, t2s)], p)
            fill_mul_expr_chain(
                cols, "fD",
                [(a1_, _pos_vals(b0_),
                  [rv - tv for rv, tv in zip(_pos_vals(r1_), _pos_vals(t2_))])
                 for a1_, b0_, r1_, t2_ in zip(a1s, b0s, r1s, t2s)],
                p, lhs_const=2 * p)
        _fill_mem_ts(cols, v, "mx", 0, 16)
        _fill_mem_ts(cols, v, "my", 16, 16)
        return cols

    return ChipDef(f"bn254_fp2_{op}", (kind,), cb, compile_chip(cb), assign)


def build_curve_chips() -> list:
    """All curve/fptower precompile chips in registry order."""
    chips = []
    for curve in ("secp256k1", "secp256r1"):
        chips += [
            build_ec_add_chip(curve),
            build_ec_double_chip(curve),
            build_ec_decompress_chip(curve),
            build_ec_invert_chip(curve),
        ]
    chips += [
        build_ec_add_chip("bn254"),
        build_ec_double_chip("bn254"),
        build_bn254_fp_chip("add"),
        build_bn254_fp_chip("mul"),
        build_bn254_fp2_chip("add"),
        build_bn254_fp2_chip("mul"),
    ]
    return chips
