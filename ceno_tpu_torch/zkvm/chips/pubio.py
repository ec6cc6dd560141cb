"""PUB_IO_COMMIT chip: bind a guest-committed 8-word digest to public values.

Role mirror of the reference's pubio-commit path (SURVEY.md §2.3:
ceno_emul/src/syscalls/pubio_commit.rs:15-26 — syscall reads 8 digest words
at a0; ceno_zkvm/src/precompiles/pubio_commit.rs:11-37 +
instructions/riscv/ecall/pubio_commit.rs — the words are constrained equal
to the PUB_IO_COMMIT public-value limbs). The host computes the expected
digest from the declared public-output words with Keccak-256
(e2e.rs:71-85 public_io_words_to_digest_words; bit-exact mirror in
emulator/keccak.py) and the verifier compares it against the proof's public
values, so a verified proof pins the guest's committed outputs.

Copy of ``ceno_tpu/zkvm/chips/pubio.py``: the port keeps its own, with the same
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
from ..layout import PV_PUBIO_DIGEST
from . import common as C
from .opcodes import ChipDef, TraceView, MASK16, _reg_read_cols, _state_cols, _ts_cols

N_WORDS = 8


def build_pubio_commit_chip() -> ChipDef:
    cb = CircuitBuilder("pubio_commit")
    st = C.make_state(cb)
    t0 = C.read_reg(cb, "t0", st, 0, const_id=5)
    a0 = C.read_reg(cb, "a0", st, 1, const_id=10)
    code = Platform.ECALL_COMMIT
    cb.require_zero("code_lo", t0.lo - (code & MASK16))
    cb.require_zero("code_hi", t0.hi - (code >> 16))
    w = cb.create_witin("dp_w")
    wlo = cb.create_witin("dp_wlo")
    whi = cb.create_witin("dp_whi")
    cb.require_zero("dp_align", a0.lo + a0.hi * (1 << 16) - w * 4)
    cb.require_zero("dp_limbs", w - wlo - whi * (1 << 16))
    cb.assert_u16(wlo)
    cb.assert_u12(whi)
    # 8 word READS whose values ARE the public digest limbs
    for i in range(N_WORDS):
        pts = cb.create_witin(f"d{i}_pts")
        cb.ram_read(
            RAM_MEMORY, w + i,
            [E.Instance(PV_PUBIO_DIGEST + 2 * i),
             E.Instance(PV_PUBIO_DIGEST + 2 * i + 1)],
            pts, st.ts + 3,
        )
        C.ts_lt_check(cb, f"d{i}", pts, st.ts + 3)
    C.gs_chain(cb, st, st.pc + 4)
    C.fetch(cb, st, K["ECALL"], 0, 0, 0, 0, 0, 0)

    def assign(v: TraceView) -> dict:
        cols = _state_cols(v)
        ts = cols["ts"]
        cols.update(_reg_read_cols("t0", "rs1", v, ts + 0, with_id=False))
        cols.update(_reg_read_cols("a0", "rs2", v, ts + 1, with_id=False))
        wv = v.rs2_val.astype(np.uint64) >> 2
        cols.update({"dp_w": wv, "dp_wlo": wv & MASK16, "dp_whi": wv >> 16})
        pts = v.sys_pts[v.sys_idx].astype(np.uint64)
        for i in range(N_WORDS):
            cols[f"d{i}_pts"] = pts[:, i]
            cols.update(_ts_cols(f"d{i}", pts[:, i], ts + 3))
        return cols

    return ChipDef("pubio_commit", (K["SYS_COMMIT"],), cb, compile_chip(cb), assign)
