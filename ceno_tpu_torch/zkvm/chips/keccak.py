"""Keccak-f[1600] precompile: ecall chip + round-core chip over a Custom bus.

Role mirror of the reference's keccak precompile (SURVEY.md §2.3:
instructions/riscv/ecall/keccak.rs:87-175 and
precompiles/lookup_keccakf.rs:128-560), re-designed for this framework:

  * The reference chains its 24 round-rows with a rotation PIOP over the
    cyclic group of 32 (gkr layer/cpu/mod.rs:249-316) because its zerocheck
    cannot see two rows at once. Here the rounds chain through the existing
    RAM_CUSTOM multiset bus instead: round row (cycle, r) READS
    (KeccakState, cycle, r, state) and WRITES (KeccakState, cycle, r+1,
    state'), while the ecall row WRITES round 0 and READS round 24. The
    global prod(R) = prod(W) check forces every chain to run 0 -> 24 with
    the correct per-round permutation — rows stay fully uniform (no sparse
    selectors, no inter-row constraints), which is the shape the batched
    TPU kernels want.
  * Bitwise semantics use the same byte-lookup arithmetization as the
    reference (xor/and u8 tables, range-checked rotation splits of 64-bit
    lanes: lookup_keccakf.rs:344-475). Rotation r = 8q + s splits each
    byte into (8-s)/s bit halves; the rotated byte is then a linear
    expression, so theta/rho/pi outputs need no extra witnesses.
  * The i-th round constant enters through a 24-row fixed lookup table
    (LK_KECCAK_RC) keyed by the round index, which also range-binds the
    round column.

Soundness of the chain argument: every core row strictly increments the
round key, so no non-empty set of core rows can cancel among themselves;
the only way to cancel the ecall's round-0 write and round-24 read is an
exact 24-row chain applying keccak-f to the ecall's input state.

Copy of ``ceno_tpu/zkvm/chips/keccak.py``: the port keeps its own, with the same
relative imports.
Only the circuit definition and its compile are on the main path (every
key registers this chip); the witgen for nonzero instances is copied but
not yet held against the reference (ROADMAP Queue 1, M10).
"""

from __future__ import annotations

import numpy as np

from ...emulator.keccak import RC, ROT, keccak_round_np
from ...emulator.rv32im import K
from ...emulator.state import Platform
from ...gkr.chip import compile_chip
from ...gkr.circuit_builder import CircuitBuilder, RAM_CUSTOM, RAM_MEMORY
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

TAG_KECCAK_STATE = 2   # CustomRWTag::KeccakState mirror (shard EC point = 1)
LK_KECCAK_RC = 17      # round-constant byte table
N_ROUNDS = 24
N_WORDS = 50           # 25 lanes x 2 u32 words
N_LIMBS = 100          # 16-bit limbs on the bus


def _rot_qs(rot: int):
    return rot // 8, rot % 8


def _chi_src(cx: int, cy: int):
    """Inverse of the rho-pi placement: which theta lane lands at (cx, cy)."""
    # forward: B[y, (2x + 3y) % 5] = rot(A[x, y])
    y = cx
    x = (3 * (cy - 3 * y)) % 5
    return x, y


def build_keccak_core_chip() -> ChipDef:
    cb = CircuitBuilder("keccak_core")
    cycle = cb.create_witin("cycle")
    rnd = cb.create_witin("round")

    in8 = [[cb.create_witin(f"in_{l}_{k}") for k in range(8)] for l in range(25)]

    def A(x, y, k):
        return in8[x + 5 * y][k]

    # theta: c_aux[x][j] = XOR of A[x, 0..j+1]; c[x] = c_aux[x][3]
    ca = [[[cb.create_witin(f"ca_{x}_{j}_{k}") for k in range(8)]
           for j in range(4)] for x in range(5)]
    for x in range(5):
        for j in range(4):
            for k in range(8):
                prev = A(x, 0, k) if j == 0 else ca[x][j - 1][k]
                cb.lk_xor8(prev, A(x, j + 1, k), ca[x][j][k])

    # c_rot[x] = rotl64(c[x], 1): byte split (7 low bits, 1 high bit)
    lo7 = [[cb.create_witin(f"c1l_{x}_{k}") for k in range(8)] for x in range(5)]
    hi1 = [[cb.create_witin(f"c1h_{x}_{k}") for k in range(8)] for x in range(5)]
    for x in range(5):
        for k in range(8):
            cb.require_zero(
                f"c1_split_{x}_{k}", ca[x][3][k] - lo7[x][k] - 128 * hi1[x][k]
            )
            cb.assert_bit(f"c1_bit_{x}_{k}", hi1[x][k])
            cb.assert_u8(lo7[x][k] * 2)

    def c_rot(x, k):
        return lo7[x][k] * 2 + hi1[x][(k + 7) % 8]

    # d[x] = c[x-1] XOR rotl(c[x+1], 1)
    d = [[cb.create_witin(f"d_{x}_{k}") for k in range(8)] for x in range(5)]
    for x in range(5):
        for k in range(8):
            cb.lk_xor8(ca[(x + 4) % 5][3][k], c_rot((x + 1) % 5, k), d[x][k])

    # theta output per lane, immediately split for the rho rotation
    theta_split = {}   # (x, y) -> (lo list, hi list) for s != 0
    theta_wit = {}     # (x, y) -> byte witnesses for s == 0
    for x in range(5):
        for y in range(5):
            q, s = _rot_qs(ROT[x][y])
            if s == 0:
                th = [cb.create_witin(f"th_{x}_{y}_{k}") for k in range(8)]
                theta_wit[(x, y)] = th
                for k in range(8):
                    cb.lk_xor8(A(x, y, k), d[x][k], th[k])
            else:
                lo = [cb.create_witin(f"rl_{x}_{y}_{k}") for k in range(8)]
                hi = [cb.create_witin(f"rh_{x}_{y}_{k}") for k in range(8)]
                theta_split[(x, y)] = (lo, hi)
                for k in range(8):
                    cb.lk_xor8(
                        A(x, y, k), d[x][k], lo[k] + (1 << (8 - s)) * hi[k]
                    )
                    cb.assert_u8(lo[k] * (1 << s))
                    cb.assert_u8(hi[k] * (1 << (8 - s)))

    def B(cx, cy, k):
        """Post rho-pi byte expression at chi coordinates."""
        x, y = _chi_src(cx, cy)
        q, s = _rot_qs(ROT[x][y])
        if s == 0:
            return theta_wit[(x, y)][(k - q) % 8]
        lo, hi = theta_split[(x, y)]
        return (1 << s) * lo[(k - q) % 8] + hi[(k - q - 1) % 8]

    # chi + iota; outputs are the next round's state bytes
    out8 = [[cb.create_witin(f"out_{l}_{k}") for k in range(8)] for l in range(25)]
    nl = [[cb.create_witin(f"nl_{l}_{k}") for k in range(8)] for l in range(25)]
    chi00 = [cb.create_witin(f"chi00_{k}") for k in range(8)]
    rc = [cb.create_witin(f"rc_{k}") for k in range(8)]
    for cy in range(5):
        for cx in range(5):
            l = cx + 5 * cy
            for k in range(8):
                cb.lk_and8(255 - B((cx + 1) % 5, cy, k), B((cx + 2) % 5, cy, k),
                           nl[l][k])
                out = chi00[k] if l == 0 else out8[l][k]
                cb.lk_xor8(B(cx, cy, k), nl[l][k], out)
    for k in range(8):
        cb.lk_xor8(chi00[k], rc[k], out8[0][k])
    cb.lk_record(LK_KECCAK_RC, [rnd] + rc)

    # round-chaining bus records (16-bit limbs, ecall word order)
    def limbs(state8):
        out = []
        for j in range(N_LIMBS):
            lane, pos = j // 4, j % 4
            out.append(state8[lane][2 * pos] + 256 * state8[lane][2 * pos + 1])
        return out

    head = [E.Const(RAM_CUSTOM), E.Const(TAG_KECCAK_STATE), cycle]
    cb.read_record(head + [rnd] + limbs(in8))
    cb.write_record(head + [rnd + 1] + limbs(out8))

    def assign(v: TraceView) -> dict:
        m = v.n  # keccak steps; rows = 24 * m, instance-major
        states = np.zeros((m, 25), np.uint64)
        prev = v.sys_prev[v.sys_idx]  # (m, 50)
        for i in range(25):
            states[:, i] = prev[:, 2 * i].astype(np.uint64) | (
                prev[:, 2 * i + 1].astype(np.uint64) << np.uint64(32)
            )
        rounds = np.zeros((N_ROUNDS + 1, m, 25), np.uint64)
        rounds[0] = states
        for r in range(N_ROUNDS):
            rounds[r + 1] = keccak_round_np(rounds[r], r)
        # (m, 24, ...) row-major flattening: row = step * 24 + round
        sin = rounds[:N_ROUNDS].transpose(1, 0, 2).reshape(m * N_ROUNDS, 25)
        sout = rounds[1:].transpose(1, 0, 2).reshape(m * N_ROUNDS, 25)
        r_col = np.tile(np.arange(N_ROUNDS, dtype=np.uint64), m)
        cols = {
            "cycle": np.repeat(v.ts.astype(np.uint64), N_ROUNDS),
            "round": r_col,
        }

        def bytes_of(vals, k):
            return (vals >> np.uint64(8 * k)) & np.uint64(0xFF)

        inb = np.zeros((25, 8, m * N_ROUNDS), np.uint64)
        outb = np.zeros((25, 8, m * N_ROUNDS), np.uint64)
        for l in range(25):
            for k in range(8):
                inb[l, k] = bytes_of(sin[:, l], k)
                outb[l, k] = bytes_of(sout[:, l], k)
                cols[f"in_{l}_{k}"] = inb[l, k]
                cols[f"out_{l}_{k}"] = outb[l, k]
        # theta intermediates
        cvals = np.zeros((5, 8, m * N_ROUNDS), np.uint64)
        for x in range(5):
            acc = inb[x]
            for j in range(4):
                acc = acc ^ inb[x + 5 * (j + 1)]
                for k in range(8):
                    cols[f"ca_{x}_{j}_{k}"] = acc[k]
            cvals[x] = acc
        for x in range(5):
            for k in range(8):
                cols[f"c1l_{x}_{k}"] = cvals[x, k] & np.uint64(0x7F)
                cols[f"c1h_{x}_{k}"] = cvals[x, k] >> np.uint64(7)
        dvals = np.zeros((5, 8, m * N_ROUNDS), np.uint64)
        for x in range(5):
            crot = np.zeros((8, m * N_ROUNDS), np.uint64)
            for k in range(8):
                crot[k] = ((cvals[(x + 1) % 5, k] << np.uint64(1)) & np.uint64(0xFF)) | (
                    cvals[(x + 1) % 5, (k + 7) % 8] >> np.uint64(7)
                )
            for k in range(8):
                dvals[x, k] = cvals[(x + 4) % 5, k] ^ crot[k]
                cols[f"d_{x}_{k}"] = dvals[x, k]
        theta = np.zeros((5, 5, 8, m * N_ROUNDS), np.uint64)
        for x in range(5):
            for y in range(5):
                q, s = _rot_qs(ROT[x][y])
                for k in range(8):
                    theta[x, y, k] = inb[x + 5 * y, k] ^ dvals[x, k]
                if s == 0:
                    for k in range(8):
                        cols[f"th_{x}_{y}_{k}"] = theta[x, y, k]
                else:
                    for k in range(8):
                        cols[f"rl_{x}_{y}_{k}"] = theta[x, y, k] & np.uint64(
                            (1 << (8 - s)) - 1
                        )
                        cols[f"rh_{x}_{y}_{k}"] = theta[x, y, k] >> np.uint64(8 - s)

        def b_val(cx, cy, k):
            x, y = _chi_src(cx, cy)
            q, s = _rot_qs(ROT[x][y])
            if s == 0:
                return theta[x, y, (k - q) % 8]
            lo = theta[x, y, (k - q) % 8] & np.uint64((1 << (8 - s)) - 1)
            hi = theta[x, y, (k - q - 1) % 8] >> np.uint64(8 - s)
            return (lo << np.uint64(s)) + hi

        for cy in range(5):
            for cx in range(5):
                l = cx + 5 * cy
                for k in range(8):
                    nlv = (np.uint64(0xFF) ^ b_val((cx + 1) % 5, cy, k)) & b_val(
                        (cx + 2) % 5, cy, k
                    )
                    cols[f"nl_{l}_{k}"] = nlv
                    if l == 0:
                        cols[f"chi00_{k}"] = b_val(0, 0, k) ^ nlv
        for k in range(8):
            cols[f"rc_{k}"] = np.broadcast_to(
                (np.array(RC, np.uint64)[r_col] >> np.uint64(8 * k)) & np.uint64(0xFF),
                (m * N_ROUNDS,),
            )
        return cols

    return ChipDef(
        "keccak_core", (K["SYS_KECCAK"],), cb, compile_chip(cb), assign,
        rows_per_step=N_ROUNDS,
    )


def build_keccak_ecall_chip() -> ChipDef:
    """Syscall-facing chip (ecall/keccak.rs:87-175 mirror): one row per
    KECCAK_PERMUTE step — vm-state chain, t0/a0 register reads, 50 guest
    memory read-writes, and the round-0 write / round-24 read on the
    KeccakState bus."""
    cb = CircuitBuilder("keccak_ecall")
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    code = Platform.ECALL_KECCAK
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

    p_limbs, n_limbs = [], []
    for i in range(N_WORDS):
        plo = cb.create_witin(f"m{i}_plo")
        phi = cb.create_witin(f"m{i}_phi")
        nlo = cb.create_witin(f"m{i}_nlo")
        nhi = cb.create_witin(f"m{i}_nhi")
        pts = cb.create_witin(f"m{i}_pts")
        cb.ram_write(RAM_MEMORY, w + i, [plo, phi], [nlo, nhi], pts, st.ts + 3)
        C.ts_lt_check(cb, f"m{i}", pts, st.ts + 3)
        p_limbs += [plo, phi]
        n_limbs += [nlo, nhi]

    head = [E.Const(RAM_CUSTOM), E.Const(TAG_KECCAK_STATE), st.ts]
    cb.write_record(head + [E.Const(0)] + p_limbs)
    cb.read_record(head + [E.Const(N_ROUNDS)] + n_limbs)
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
        new = v.sys_val[v.sys_idx].astype(np.uint64)
        pts = v.sys_pts[v.sys_idx].astype(np.uint64)
        for i in range(N_WORDS):
            plo, phi = _limbs(prev[:, i])
            nlo, nhi = _limbs(new[:, i])
            cols.update({
                f"m{i}_plo": plo, f"m{i}_phi": phi,
                f"m{i}_nlo": nlo, f"m{i}_nhi": nhi, f"m{i}_pts": pts[:, i],
            })
            cols.update(_ts_cols(f"m{i}", pts[:, i], ts + 3))
        return cols

    return ChipDef("keccak_ecall", (K["SYS_KECCAK"],), cb, compile_chip(cb), assign)
