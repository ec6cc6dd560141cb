"""256-bit modular arithmetic gadgets + the UINT256_MUL precompile chip.

Role mirror of the reference's uint256 precompile
(ceno_emul/src/syscalls/uint256.rs:28-80, ceno_zkvm precompiles uint256.rs —
itself an sp1-derived FieldOpCols circuit): one syscall computes
x*y mod m over 256-bit operands (m == 0 means mod 2^256), overwriting x.

Arithmetization (u8-limb schoolbook — u16 x u16 products are forbidden by
the BabyBear magnitude budget: an integer constraint stays below p):

  * every 256-bit value is 32 u8-checked byte witnesses; the memory-record
    u16 limbs are byte expressions (b_{2i} + 256*b_{2i+1}), so no separate
    limb columns exist;
  * the integer identity x*y = q*m_eff + r is enforced position-by-position
    in radix 2^8 with a signed carry chain: at byte position k,
      sum_{i+j=k} x_i*y_j - sum_{i+j=k} q_i*m_j - z*q_{k-32} - r_k
        + (c_k - 2^15) - 256*(c_{k+1} - 2^15) = 0
    where z = [m == 0] makes m_eff = 2^256, the carries c_k are u16-checked
    (|carry| < 2^15 by the position-sum bound 33*255^2 ~ 2^21), c_0 and
    c_64 are pinned to zero, and q is a 32-byte quotient witness. Like the
    reference's 32-limb carry (uint256.rs FieldOpCols), this is exact for
    every in-spec guest (reference debug-asserts quotient < modulus; here
    witgen asserts quotient < 2^256, a strictly weaker requirement);
  * canonicality r < m (for m != 0) is a byte borrow chain gated by (1-z):
    r + 1 + d = m with d a 32-byte witness and boolean chain carries.

Copy of ``ceno_tpu/zkvm/chips/u256.py``: the port keeps its own, with the same
relative imports.
Only the circuit definition and its compile are on the main path (every
key registers this chip); the witgen for nonzero instances is copied but
not yet held against the reference (ROADMAP Queue 1, M10).
"""

from __future__ import annotations

import numpy as np

from ...emulator.rv32im import K
from ...emulator.state import Platform
from ...fields import babybear as bb
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

N_BYTES = 32
CARRY_OFF = 1 << 15


def make_bytes(cb: CircuitBuilder, name: str, n: int = N_BYTES):
    """n u8-checked byte witnesses (LE)."""
    bs = [cb.create_witin(f"{name}_b{k}") for k in range(n)]
    for b in bs:
        cb.assert_u8(b)
    return bs


def limb_exprs(bs):
    """u16-limb expressions [(lo, hi) per word] of a 32-byte value."""
    out = []
    for i in range(len(bs) // 4):
        out.append((bs[4 * i] + bs[4 * i + 1] * 256,
                    bs[4 * i + 2] + bs[4 * i + 3] * 256))
    return out


def mul_mod_chain(cb: CircuitBuilder, name: str, xb, yb, qb, mb, rb, z=None):
    """Positional carry chain for x*y = q*m_eff + r over 32-byte values.

    m_eff = m + z*2^256 (pass z = [m == 0] to get the reference's m=0 =>
    mod 2^256 semantics; z=None means m is never zero, e.g. a constant
    curve modulus)."""
    carries = [cb.create_witin(f"{name}_c{k}") for k in range(1, 64)]
    for c in carries:
        cb.assert_u16(c)

    def carry(k):  # signed carry INTO position k
        if k == 0 or k == 64:
            return None
        return carries[k - 1]

    for k in range(64):
        terms = []
        for i in range(max(0, k - 31), min(32, k + 1)):
            terms.append(E.Prod([xb[i], yb[k - i]]))
            terms.append(E.Neg(E.Prod([qb[i], mb[k - i]])))
        if z is not None and 32 <= k < 64:
            terms.append(E.Neg(E.Prod([z, qb[k - 32]])))
        if k < 32:
            terms.append(E.Neg(rb[k]))
        cin, cout = carry(k), carry(k + 1)
        const = 0
        if cin is not None:
            terms.append(cin)
            const -= CARRY_OFF
        if cout is not None:
            terms.append(E.Prod([E.Const(bb.P - 256), cout]))
            const += 256 * CARRY_OFF
        terms.append(E.Const(const % bb.P))
        cb.require_zero(f"{name}_p{k}", E.Sum(terms))
    return carries


def mul_expr_chain(cb: CircuitBuilder, name: str, a_bytes, b_exprs, r_exprs,
                   modulus: int, lhs_const: int = 0, n_q: int = 33):
    """Positional carry chain for A*B + lhs_const = q*modulus + R over a
    CONSTANT modulus (the curve-op workhorse; reference mirror is the
    sp1-derived FieldOpCols polynomial identity, gadgets/field/field_op.rs).

    ``a_bytes``: 32 byte witnesses. ``b_exprs``: 32 byte-expressions with
    small coefficients (each |value| <= ~1020 so position sums stay below
    the carry range). ``r_exprs``: byte-expressions (any length <= n_q+32).
    ``lhs_const``: nonnegative constant added to A*B (choose k*modulus large
    enough that the integer quotient is nonnegative). q is an ``n_q``-byte
    witness. Returns (q_bytes, carries)."""
    mb = [(modulus >> (8 * k)) & 0xFF for k in range(64)]
    lc = [(lhs_const >> (8 * k)) & 0xFF for k in range(80)]
    qb = make_bytes(cb, f"{name}_q", n_q)
    n_pos = n_q + 32
    carries = [cb.create_witin(f"{name}_c{k}") for k in range(1, n_pos)]
    for c in carries:
        cb.assert_u16(c)

    def carry(k):
        if k == 0 or k == n_pos:
            return None
        return carries[k - 1]

    b_lifted = [
        None if isinstance(b_, int) and b_ == 0 else E._lift(b_)
        for b_ in b_exprs
    ]
    for k in range(n_pos):
        terms = []
        for i in range(max(0, k - 31), min(len(a_bytes), k + 1)):
            j = k - i
            if j < len(b_lifted) and b_lifted[j] is not None:
                terms.append(E.Prod([a_bytes[i], b_lifted[j]]))
        for i in range(max(0, k - 63), min(n_q, k + 1)):
            j = k - i
            if mb[j]:
                terms.append(E.Prod([E.Const(bb.P - mb[j]), qb[i]]))
        if k < len(r_exprs):
            terms.append(E.Neg(E._lift(r_exprs[k])))
        cin, cout = carry(k), carry(k + 1)
        const = lc[k]
        if cin is not None:
            terms.append(cin)
            const -= CARRY_OFF
        if cout is not None:
            terms.append(E.Prod([E.Const(bb.P - 256), cout]))
            const += 256 * CARRY_OFF
        if const % bb.P:
            terms.append(E.Const(const % bb.P))
        cb.require_zero(f"{name}_p{k}", E.Sum(terms))
    return qb, carries


def fill_mul_expr_chain(cols: dict, name: str, rows, modulus: int,
                        lhs_const: int = 0, n_q: int = 33):
    """Witgen for mul_expr_chain. ``rows``: per row (a_int, b_pos, r_pos)
    where b_pos/r_pos are the PER-POSITION values of the circuit's byte
    expressions (possibly negative or > 255 — the carries are defined by
    the positional partial sums, not by canonical byte decompositions)."""
    n_pos = n_q + 32
    n_rows = len(rows)
    qs = []
    for a, b_pos, r_pos in rows:
        b_int = sum(v << (8 * j) for j, v in enumerate(b_pos))
        r_int = sum(v << (8 * j) for j, v in enumerate(r_pos))
        num = a * b_int + lhs_const - r_int
        assert num % modulus == 0, f"{name}: mod identity broken"
        q = num // modulus
        assert 0 <= q < (1 << (8 * n_q)), f"{name}: quotient out of range"
        qs.append(q)
    fill_bytes(cols, f"{name}_q", qs, n_q)
    carr = np.zeros((n_pos - 1, n_rows), np.int64)
    mb = [(modulus >> (8 * k)) & 0xFF for k in range(64)]
    for ri, ((a, b_pos, r_pos), q) in enumerate(zip(rows, qs)):
        av = [(a >> (8 * i)) & 0xFF for i in range(32)]
        qv = [(q >> (8 * i)) & 0xFF for i in range(n_q)]
        c = 0
        for k in range(n_pos - 1):
            s = c + ((lhs_const >> (8 * k)) & 0xFF)
            for i in range(max(0, k - 31), min(32, k + 1)):
                if k - i < len(b_pos):
                    s += av[i] * b_pos[k - i]
            for i in range(max(0, k - 63), min(n_q, k + 1)):
                s -= qv[i] * mb[k - i]
            if k < len(r_pos):
                s -= r_pos[k]
            assert s % 256 == 0, f"{name}: carry chain broke at {k}"
            c = s // 256
            carr[k][ri] = c
    for k in range(n_pos - 1):
        cols[f"{name}_c{k + 1}"] = (carr[k] + CARRY_OFF).astype(np.uint64)


def add_mod_chain(cb: CircuitBuilder, name: str, a_exprs, b_exprs, r_exprs,
                  modulus: int, n_e: int = 2):
    """A + B = R + e*modulus positionwise (e in [0, 2^n_e), bit witnesses).

    Returns the e bits. Use for canonical modular additions where R is the
    canonical representative (witgen supplies e = (A+B-R)/modulus)."""
    mb = [(modulus >> (8 * k)) & 0xFF for k in range(40)]
    ebits = [cb.create_witin(f"{name}_e{t}") for t in range(n_e)]
    for t, e in enumerate(ebits):
        cb.assert_bit(f"{name}_eb{t}", e)
    carries = [cb.create_witin(f"{name}_c{k}") for k in range(1, 33)]
    for c in carries:
        cb.assert_u16(c)
    for k in range(33):
        terms = []
        if k < len(a_exprs):
            terms.append(E._lift(a_exprs[k]))
        if k < len(b_exprs):
            terms.append(E._lift(b_exprs[k]))
        if k < len(r_exprs):
            terms.append(E.Neg(E._lift(r_exprs[k])))
        if mb[k]:
            for t, e in enumerate(ebits):
                terms.append(
                    E.Prod([E.Const((bb.P - mb[k]) * (1 << t) % bb.P), e])
                )
        cin = carries[k - 1] if 1 <= k <= 32 else None
        cout = carries[k] if k < 32 else None
        const = 0
        if cin is not None:
            terms.append(cin)
            const -= CARRY_OFF
        if cout is not None:
            terms.append(E.Prod([E.Const(bb.P - 256), cout]))
            const += 256 * CARRY_OFF
        if const % bb.P:
            terms.append(E.Const(const % bb.P))
        if not terms:
            continue
        cb.require_zero(f"{name}_p{k}", E.Sum(terms))
    return ebits


def fill_add_mod_chain(cols: dict, name: str, a_vals, b_vals, r_vals,
                       modulus: int, n_e: int = 2):
    n_rows = len(a_vals)
    carr = np.zeros((32, n_rows), np.int64)
    es = np.zeros((n_e, n_rows), np.uint64)
    mb = [(modulus >> (8 * k)) & 0xFF for k in range(40)]
    for ri, (a, b_, r) in enumerate(zip(a_vals, b_vals, r_vals)):
        e = (a + b_ - r) // modulus
        assert a + b_ - r == e * modulus and 0 <= e < (1 << n_e), (
            f"{name}: add-mod identity broken"
        )
        for t in range(n_e):
            es[t][ri] = (e >> t) & 1
        c = 0
        for k in range(32):
            s = c + ((a >> (8 * k)) & 0xFF) + ((b_ >> (8 * k)) & 0xFF) \
                - ((r >> (8 * k)) & 0xFF) - e * mb[k]
            assert s % 256 == 0
            c = s // 256
            carr[k][ri] = c
    for t in range(n_e):
        cols[f"{name}_e{t}"] = es[t]
    for k in range(32):
        cols[f"{name}_c{k + 1}"] = (carr[k] + CARRY_OFF).astype(np.uint64)


def lt_const_chain(cb: CircuitBuilder, name: str, rb, modulus: int):
    """r < modulus (constant) via r + 1 + d = modulus byte borrow chain."""
    db = make_bytes(cb, f"{name}_d")
    mb = [(modulus >> (8 * k)) & 0xFF for k in range(32)]
    brs = [cb.create_witin(f"{name}_br{k}") for k in range(1, 32)]
    for k, b in enumerate(brs):
        cb.assert_bit(f"{name}_brb{k + 1}", b)
    for k in range(32):
        expr = rb[k] + db[k] - mb[k]
        if k == 0:
            expr = expr + 1
        if 1 <= k:
            expr = expr + brs[k - 1]
        if k < 31:
            expr = expr + E.Prod([E.Const(bb.P - 256), brs[k]])
        cb.require_zero(f"{name}_s{k}", expr)
    return db, brs


def fill_lt_const_chain(cols: dict, name: str, r_vals, modulus: int):
    n_rows = len(r_vals)
    ds = [modulus - 1 - r for r in r_vals]
    assert all(d >= 0 for d in ds), f"{name}: value not below modulus"
    fill_bytes(cols, f"{name}_d", ds)
    borr = np.zeros((31, n_rows), np.uint64)
    for ri, (r, d) in enumerate(zip(r_vals, ds)):
        c = 0
        for k in range(31):
            t = ((r >> (8 * k)) & 0xFF) + ((d >> (8 * k)) & 0xFF) + c
            if k == 0:
                t += 1
            c = 1 if t >= 256 else 0
            borr[k][ri] = c
    for k in range(31):
        cols[f"{name}_br{k + 1}"] = borr[k]


def lt_chain(cb: CircuitBuilder, name: str, rb, mb, gate=None):
    """r < m via r + 1 + d = m byte chain; constraints gated by ``gate``."""
    db = make_bytes(cb, f"{name}_d")
    brs = [cb.create_witin(f"{name}_br{k}") for k in range(1, 32)]
    for k, b in enumerate(brs):
        cb.assert_bit(f"{name}_brb{k + 1}", b)

    def br(k):
        if k == 0 or k == 32:
            return None
        return brs[k - 1]

    for k in range(32):
        expr = rb[k] + db[k] - mb[k]
        if k == 0:
            expr = expr + 1
        cin, cout = br(k), br(k + 1)
        if cin is not None:
            expr = expr + cin
        if cout is not None:
            expr = expr + E.Prod([E.Const(bb.P - 256), cout])
        if gate is not None:
            expr = E.Prod([gate, expr])
        cb.require_zero(f"{name}_s{k}", expr)
    return db, brs


def fill_bytes(cols: dict, name: str, vals, n: int = N_BYTES):
    """Witgen: per-row python ints -> byte columns."""
    for k in range(n):
        cols[f"{name}_b{k}"] = np.array(
            [(v >> (8 * k)) & 0xFF for v in vals], np.uint64
        )


def build_uint256_mul_chip() -> ChipDef:
    cb = CircuitBuilder("uint256_mul")
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    code = Platform.ECALL_UINT256_MUL
    cb.require_zero("code_lo", t0.lo - (code & MASK16))
    cb.require_zero("code_hi", t0.hi - (code >> 16))
    # a1 (y_ptr) rides the rd record slot as a preserving register write
    a1_lo = cb.create_witin("a1_lo")
    a1_hi = cb.create_witin("a1_hi")
    a1_pts = cb.create_witin("a1_pts")
    cb.ram_write(RAM_REGISTER, E.Const(11), [a1_lo, a1_hi], [a1_lo, a1_hi],
                 a1_pts, st.ts + 2)
    C.ts_lt_check(cb, "a1", a1_pts, st.ts + 2)

    ptrs = {}
    for pname, reg in (("xp", a0), ("yp", (a1_lo, a1_hi))):
        w = cb.create_witin(f"{pname}_w")
        wlo = cb.create_witin(f"{pname}_wlo")
        whi = cb.create_witin(f"{pname}_whi")
        lo, hi = (reg.lo, reg.hi) if pname == "xp" else reg
        cb.require_zero(f"{pname}_align", lo + hi * (1 << 16) - w * 4)
        cb.require_zero(f"{pname}_limbs", w - wlo - whi * (1 << 16))
        cb.assert_u16(wlo)
        cb.assert_u12(whi)
        ptrs[pname] = w

    xb = make_bytes(cb, "x")
    yb = make_bytes(cb, "y")
    mb = make_bytes(cb, "m")
    qb = make_bytes(cb, "q")
    rb = make_bytes(cb, "r")

    # z = [m == 0]: the byte sum vanishes iff every u8-checked byte does
    z = C.is_zero(cb, "mz", E.Sum(mb))

    mul_mod_chain(cb, "mm", xb, yb, qb, mb, rb, z=z)
    lt_chain(cb, "lt", rb, mb, gate=1 - z)

    # memory records: x words rewritten with r, y and m preserved
    x_limbs, y_limbs, m_limbs, r_limbs = (
        limb_exprs(xb), limb_exprs(yb), limb_exprs(mb), limb_exprs(rb)
    )
    xw, yw = ptrs["xp"], ptrs["yp"]
    for i in range(8):
        pts = cb.create_witin(f"mx{i}_pts")
        cb.ram_write(RAM_MEMORY, xw + i, list(x_limbs[i]), list(r_limbs[i]),
                     pts, st.ts + 3)
        C.ts_lt_check(cb, f"mx{i}", pts, st.ts + 3)
    for i in range(8):
        pts = cb.create_witin(f"my{i}_pts")
        cb.ram_write(RAM_MEMORY, yw + i, list(y_limbs[i]), list(y_limbs[i]),
                     pts, st.ts + 3)
        C.ts_lt_check(cb, f"my{i}", pts, st.ts + 3)
    for i in range(8):
        pts = cb.create_witin(f"mm{i}_pts")
        cb.ram_write(RAM_MEMORY, yw + 8 + i, list(m_limbs[i]),
                     list(m_limbs[i]), pts, st.ts + 3)
        C.ts_lt_check(cb, f"mm{i}", pts, st.ts + 3)

    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["ECALL"], 0, 0, 0, 0, 0, 0)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("t0", "rs1", v, ts + 0, with_id=False))
        cols.update(_reg_read_cols("a0", "rs2", v, ts + 1, with_id=False))
        a1v = v.rd_val.astype(np.uint64)
        cols.update({"a1_lo": a1v & MASK16, "a1_hi": a1v >> 16,
                     "a1_pts": v.rd_pts})
        cols.update(_ts_cols("a1", v.rd_pts, ts + 2))
        for pname, ptr in (("xp", v.rs2_val), ("yp", v.rd_val)):
            wv = ptr.astype(np.uint64) >> 2
            cols.update({f"{pname}_w": wv, f"{pname}_wlo": wv & MASK16,
                         f"{pname}_whi": wv >> 16})
        prev = v.sys_prev[v.sys_idx].astype(np.uint64)
        newv = v.sys_val[v.sys_idx].astype(np.uint64)
        pts = v.sys_pts[v.sys_idx].astype(np.uint64)

        def val256(words):  # (rows, 8) -> list of python ints
            return [
                sum(int(row[i]) << (32 * i) for i in range(8)) for row in words
            ]

        xs = val256(prev[:, 0:8])
        ys = val256(prev[:, 8:16])
        ms = val256(prev[:, 16:24])
        rs = val256(newv[:, 0:8])
        qs, ds, zs = [], [], []
        for x, y, m, r in zip(xs, ys, ms, rs):
            meff = m if m else 1 << 256
            assert (x * y) % meff == r, "uint256 witness does not match"
            q = (x * y - r) // meff
            assert q < (1 << 256), (
                "uint256 quotient overflow (inputs not reduced; same "
                "restriction as the reference's 32-limb carry)"
            )
            qs.append(q)
            ds.append(m - 1 - r if m else 0)
            zs.append(1 if m == 0 else 0)
        fill_bytes(cols, "x", xs)
        fill_bytes(cols, "y", ys)
        fill_bytes(cols, "m", ms)
        fill_bytes(cols, "q", qs)
        fill_bytes(cols, "r", rs)
        fill_bytes(cols, "lt_d", ds)
        zarr = np.array(zs, np.uint64)
        msum = np.array([sum((m >> (8 * k)) & 0xFF for k in range(32))
                         for m in ms], np.uint64)
        from .opcodes import _batch_inv

        cols["mz_z"] = zarr
        cols["mz_inv"] = _batch_inv(msum)
        # mul carry chain (positional, python ints per row)
        n_rows = len(xs)
        carr = np.zeros((63, n_rows), np.int64)
        for ri, (x, y, m, r, q, zv) in enumerate(
            zip(xs, ys, ms, rs, qs, zs)
        ):
            xv = [(x >> (8 * i)) & 0xFF for i in range(32)]
            yv = [(y >> (8 * i)) & 0xFF for i in range(32)]
            mv = [(m >> (8 * i)) & 0xFF for i in range(32)]
            qv = [(q >> (8 * i)) & 0xFF for i in range(32)]
            rv = [(r >> (8 * i)) & 0xFF for i in range(32)]
            c = 0
            for k in range(63):
                s = c
                for i in range(max(0, k - 31), min(32, k + 1)):
                    s += xv[i] * yv[k - i] - qv[i] * mv[k - i]
                if zv and k >= 32:
                    s -= qv[k - 32]
                if k < 32:
                    s -= rv[k]
                assert s % 256 == 0, "uint256 carry chain broke"
                c = s // 256
                carr[k][ri] = c
        for k in range(63):
            cols[f"mm_c{k + 1}"] = (carr[k] + CARRY_OFF).astype(np.uint64)
        # lt borrow chain
        borr = np.zeros((31, n_rows), np.uint64)
        for ri, (m, r, d, zv) in enumerate(zip(ms, rs, ds, zs)):
            if zv:
                continue
            c = 0
            for k in range(31):
                t = ((r >> (8 * k)) & 0xFF) + ((d >> (8 * k)) & 0xFF) + c
                if k == 0:
                    t += 1
                c = 1 if t >= 256 else 0
                borr[k][ri] = c
        for k in range(31):
            cols[f"lt_br{k + 1}"] = borr[k]
        for i in range(8):
            cols[f"mx{i}_pts"] = pts[:, i]
            cols.update(_ts_cols(f"mx{i}", pts[:, i], ts + 3))
            cols[f"my{i}_pts"] = pts[:, 8 + i]
            cols.update(_ts_cols(f"my{i}", pts[:, 8 + i], ts + 3))
            cols[f"mm{i}_pts"] = pts[:, 16 + i]
            cols.update(_ts_cols(f"mm{i}", pts[:, 16 + i], ts + 3))
        return cols

    return ChipDef(
        "uint256_mul", (K["SYS_UINT256_MUL"],), cb, compile_chip(cb), assign
    )
