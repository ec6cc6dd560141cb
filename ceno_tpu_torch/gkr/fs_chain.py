"""Global Fiat-Shamir transcript chain in-circuit (RECURSION.md #6).

Role mirror of the reference recursion's transcript-replay tables
(ceno_recursion_v2: the shard verifier's DuplexChallenger is re-proven as
AIR rows inside the recursion VM): the ENTIRE shard-verify transcript —
every Poseidon2 permutation of ``hash/transcript.py::Transcript`` — becomes
one bus-chained row sequence, and every sampled challenge becomes a row of
a CHALLENGE LOOKUP TABLE other verifier chips bind their challenge wires
against.

Design (one row per permutation, duplex semantics preserved exactly):

  * DUPLEX-ROWS chip: row ``step`` reads (ChainState, step, state[16]),
    adds a witnessed 8-element block into the rate slots, runs the
    Poseidon2 permutation in-circuit (zkvm/chips/poseidon2_gadget.py) and
    writes (ChainState, step+1, out[16]). Block binding: slot j reads
    (AbsSlot, step*8+j, blk[j]) — whoever supplies an absorbed element
    writes that record. Sample publication: slot j writes
    (SampleSlot, (step+1)*8+j, out[j]).
  * ENDS chip: writes (ChainState, 0, ZEROS) — the chain start is the
    all-zero sponge, so the whole transcript is determined by the absorbed
    blocks — and reads (ChainState, n_steps, fin[16]).
  * ABS-SUPPLY chip: (idx, v) writes (AbsSlot, idx, v). The generic
    supplier for absorbed elements not yet claimed by a dedicated verifier
    chip (they bind progressively as stages are wired in).
  * ABS-ZERO chip: idx (FIXED column) writes (AbsSlot, idx, 0) — rate
    slots the schedule says are empty are FORCED zero.
  * SAMPLE-SCAVENGER chip: (idx, v) reads (SampleSlot, idx, v) — consumes
    published sample slots nothing else reads.
  * CHALLENGE-TABLE chip: (cid FIXED, sidx FIXED, v[4], mult) reads the 4
    consecutive sample slots at sidx and exposes (cid, v) on the logup
    lookup bus (LK_AGG_CHAL) with witgen-counted multiplicity. Consumer
    chips add ``lk_record(LK_AGG_CHAL, [cid_expr, v...])`` for every
    challenge wire — the value is then transcript-derived, not free.
  * POW chips (sample_ext_pows mirror): a START row pins
    (PowChain, pid, 0, one); each POW row reads (PowChain, pid, i, v),
    looks up the base ``a`` in the challenge table (bcid FIXED), writes
    (PowChain, pid, i+1, v*a) and publishes (cid FIXED, v) — i.e. a^i —
    on the challenge table; an END row consumes the final link.

The (cid, sidx / bcid / zero-idx) schedule is deterministic given the
shard vk and proof geometry; it lives in FIXED columns so the aggregation
key commits it (mirrors how the reference recursion trusts its compiled
recursion program).

Witgen: ``ChainTranscript`` is a drop-in ``Transcript`` that records every
permutation, absorb slot and sample slot while behaving bit-identically
(tests assert equality against a live Transcript), plus registration
hooks: ``sample_ext_chal(cid)``, ``sample_ext_pows_chal(n, bcid, cid0)``,
``use(cid)`` (multiplicity counting), ``claim_absorb(idx)`` /
``claim_sample(idx)`` (a dedicated chip supplies/consumes that slot).
``finalize()`` emits every chip's witness (+ fixed) matrices.

Copy of ``ceno_tpu/gkr/fs_chain.py``, in host numpy over the port's
``hash/transcript.Transcript``: ``ChainTranscript`` records through
``append`` and ``sample_base``, the two methods every absorb and sample of
the port's verifiers passes through, and its ``clone()`` is the recording
chain's ``cursor()``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..hash import poseidon2 as p2
from ..hash.transcript import Transcript
from ..mle import expression as E
from ..zkvm.chips.poseidon2_gadget import Lin, assign_poseidon2, build_poseidon2
from . import gadgets as G
from .chip import compile_chip
from .circuit_builder import CircuitBuilder, RAM_CUSTOM

_P = np.uint64(bb.P)

TAG_CHAIN_STATE = 15   # RAM_CUSTOM sub-tags (see recursion.py's 3..14)
TAG_ABS_SLOT = 16
TAG_SAMPLE_SLOT = 17
TAG_POW_CHAIN = 18

LK_AGG_CHAL = 18       # lookup-table tag (LK_KECCAK_RC = 17)


# ---------------------------------------------------------------------------
# Chips
# ---------------------------------------------------------------------------


@dataclass
class FsChainChips:
    duplex_cb: CircuitBuilder
    duplex_compiled: object
    ends_cb: CircuitBuilder
    ends_compiled: object
    abs_cb: CircuitBuilder
    abs_compiled: object
    abs0_cb: CircuitBuilder
    abs0_compiled: object
    scav_cb: CircuitBuilder
    scav_compiled: object
    chal_cb: CircuitBuilder
    chal_compiled: object
    absx_cb: CircuitBuilder
    absx_compiled: object
    absb_cb: CircuitBuilder
    absb_compiled: object
    const_cb: CircuitBuilder
    const_compiled: object
    pow_start_cb: CircuitBuilder
    pow_start_compiled: object
    pow_cb: CircuitBuilder
    pow_compiled: object
    pow_end_cb: CircuitBuilder
    pow_end_compiled: object


def build_fs_chain_chips() -> FsChainChips:
    # -- duplex rows ----------------------------------------------------------
    db = CircuitBuilder("fs_duplex_rows")
    step = db.create_witin("step")
    st = [db.create_witin(f"st{j}") for j in range(p2.WIDTH)]
    blk = [db.create_witin(f"blk{j}") for j in range(p2.RATE)]
    lins = [Lin.col(st[j]) + Lin.col(blk[j]) for j in range(p2.RATE)]
    lins += [Lin.col(st[j]) for j in range(p2.RATE, p2.WIDTH)]
    out = build_poseidon2(db, "p", lins)
    chead = [E.Const(RAM_CUSTOM), E.Const(TAG_CHAIN_STATE)]
    db.read_record(chead + [step] + [Lin.col(s).to_expr() for s in st])
    db.write_record(chead + [step + 1] + [o.to_expr() for o in out])
    for j in range(p2.RATE):
        db.read_record(
            [E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT), step * 8 + j, blk[j]]
        )
    for j in range(p2.RATE):
        db.write_record(
            [E.Const(RAM_CUSTOM), E.Const(TAG_SAMPLE_SLOT),
             step * 8 + (8 + j), out[j].to_expr()]
        )
    duplex_compiled = compile_chip(db)

    # -- ends -----------------------------------------------------------------
    # s0 (FIXED) is the chain's step base: one aggregation proof carries one
    # chain PER VERIFIED SHARD PROOF, namespaced by disjoint step ranges.
    eb = CircuitBuilder("fs_chain_ends")
    n_steps = eb.create_witin("n_steps")
    s0 = eb.create_fixed("s0")
    fin = [eb.create_witin(f"fin{j}") for j in range(p2.WIDTH)]
    eb.write_record(chead + [s0] + [E.Const(0)] * p2.WIDTH)
    eb.read_record(chead + [n_steps] + [Lin.col(w).to_expr() for w in fin])
    ends_compiled = compile_chip(eb)

    # -- generic absorb supplier ------------------------------------------------
    ab = CircuitBuilder("fs_abs_supply")
    a_idx = ab.create_witin("idx")
    a_v = ab.create_witin("v")
    ab.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT), a_idx, a_v])
    abs_compiled = compile_chip(ab)

    # -- zero-slot supplier (schedule-fixed indices) -----------------------------
    zb = CircuitBuilder("fs_abs_zero")
    z_idx = zb.create_fixed("idx")
    z_d = zb.create_witin("d")  # chips need >=1 witness column; pinned zero
    zb.require_zero("d0", z_d)
    zb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT), z_idx,
                     E.Const(0)])
    abs0_compiled = compile_chip(zb)

    # -- sample scavenger ---------------------------------------------------------
    sb = CircuitBuilder("fs_sample_scav")
    s_idx = sb.create_witin("idx")
    s_v = sb.create_witin("v")
    sb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SAMPLE_SLOT), s_idx, s_v])
    scav_compiled = compile_chip(sb)

    # -- challenge table ----------------------------------------------------------
    tb = CircuitBuilder("fs_chal_table")
    t_cid = tb.create_fixed("cid")
    t_sidx = tb.create_fixed("sidx")
    t_mult = tb.create_witin("mult")
    t_v = [tb.create_witin(f"v{j}") for j in range(4)]
    for j in range(4):
        tb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SAMPLE_SLOT),
                        t_sidx + j, t_v[j]])
    tb.lk_table_record(LK_AGG_CHAL, t_mult, [t_cid] + list(t_v))
    chal_compiled = compile_chip(tb)

    # -- absorbed-ext table: binds PROOF values the verifier absorbs --------------
    # row = (cid FIXED, aidx FIXED, v[4], mult): supplies the 4 absorb slots
    # the value occupies in the duplex AND publishes (cid, v) on the same
    # lookup table, so consumer chips bind absorbed proof elements exactly
    # like sampled challenges.
    xb = CircuitBuilder("fs_absx_table")
    x_cid = xb.create_fixed("cid")
    x_aidx = xb.create_fixed("aidx")
    x_mult = xb.create_witin("mult")
    x_v = [xb.create_witin(f"v{j}") for j in range(4)]
    for j in range(4):
        xb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT),
                         x_aidx + j, x_v[j]])
    xb.lk_table_record(LK_AGG_CHAL, x_mult, [x_cid] + list(x_v))
    absx_compiled = compile_chip(xb)

    # -- absorbed-base table (1 slot; published as (v, 0, 0, 0)) -------------------
    bb_ = CircuitBuilder("fs_absb_table")
    b_cid = bb_.create_fixed("cid")
    b_aidx = bb_.create_fixed("aidx")
    b_mult = bb_.create_witin("mult")
    b_v = bb_.create_witin("v")
    bb_.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT), b_aidx, b_v])
    bb_.lk_table_record(LK_AGG_CHAL, b_mult,
                        [b_cid, b_v, E.Const(0), E.Const(0), E.Const(0)])
    absb_compiled = compile_chip(bb_)

    # -- constant table: key-fixed values consumers can look up -------------------
    # (e.g. the 0/1 slice-index bits of jagged eq chains, EC extended-point
    # constants). Both cid and value are FIXED — pure aggregation-key material.
    kb = CircuitBuilder("fs_const_table")
    k_cid = kb.create_fixed("cid")
    k_v = [kb.create_fixed(f"v{j}") for j in range(4)]
    k_mult = kb.create_witin("mult")
    kb.lk_table_record(LK_AGG_CHAL, k_mult, [k_cid] + list(k_v))
    const_compiled = compile_chip(kb)

    # -- pow chain ------------------------------------------------------------------
    one = G.ExtWire.constant(exth.one())
    pb0 = CircuitBuilder("fs_pow_start")
    p0_pid = pb0.create_witin("pid")
    phead0 = [E.Const(RAM_CUSTOM), E.Const(TAG_POW_CHAIN), p0_pid]
    pb0.write_record(phead0 + [E.Const(0)] + one.c)
    pow_start_compiled = compile_chip(pb0)

    pb = CircuitBuilder("fs_pow_rows")
    pw_pid = pb.create_witin("pid")
    pw_i = pb.create_witin("i")
    pw_bcid = pb.create_fixed("bcid")
    pw_cid = pb.create_fixed("cid")
    pw_mult = pb.create_witin("mult")
    a = G.ext_witness(pb, "a")
    v = G.ext_witness(pb, "v")
    va = G.ext_mul(pb, "va", v, a)
    pb.lk_record(LK_AGG_CHAL, [pw_bcid] + a.c)
    phead = [E.Const(RAM_CUSTOM), E.Const(TAG_POW_CHAIN), pw_pid]
    pb.read_record(phead + [pw_i] + v.c)
    pb.write_record(phead + [pw_i + 1] + va.c)
    pb.lk_table_record(LK_AGG_CHAL, pw_mult, [pw_cid] + v.c)
    pow_compiled = compile_chip(pb)

    pe = CircuitBuilder("fs_pow_end")
    pe_pid = pe.create_witin("pid")
    pe_k = pe.create_witin("k")
    pe_v = G.ext_witness(pe, "v")
    pe.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_POW_CHAIN), pe_pid]
                   + [pe_k] + pe_v.c)
    pow_end_compiled = compile_chip(pe)

    return FsChainChips(db, duplex_compiled, eb, ends_compiled,
                        ab, abs_compiled, zb, abs0_compiled,
                        sb, scav_compiled, tb, chal_compiled,
                        xb, absx_compiled, bb_, absb_compiled,
                        kb, const_compiled,
                        pb0, pow_start_compiled, pb, pow_compiled,
                        pe, pow_end_compiled)


# ---------------------------------------------------------------------------
# Witgen: the recording transcript
# ---------------------------------------------------------------------------


class FsRegistry:
    """Shared registration state: the main recording transcript and every
    stage CURSOR (a replaying clone, see ``ChainTranscript.cursor``) write
    into ONE registry so the finalize step emits a consistent chip set."""

    def __init__(self):
        self.claimed_abs = set()    # abs slots a dedicated chip supplies
        self.claimed_samples = set()
        self.chal_rows = []         # (cid, sidx, value4) sampled challenges
        self.absx_rows = []         # (cid, aidx, value4) absorbed exts
        self.absb_rows = []         # (cid, aidx, value)  absorbed bases
        self.chal_mult = {}         # cid -> lookup use count
        self.pow_chains = []        # (pid, bcid, cid0, a4, values (n+1, 4))
        self.const_rows = {}        # value4 bytes -> (cid, value4)
        self.next_cid = 0
        self.next_pid = 0

    def alloc_cid(self, n: int = 1) -> int:
        c = self.next_cid
        self.next_cid += n
        return c

    def use(self, cid: int, times: int = 1) -> None:
        self.chal_mult[cid] = self.chal_mult.get(cid, 0) + times

    def register_pow_chain(self, bcid: int, base_val, n: int) -> int:
        """Pow chain a^0..a^{n-1} from an ALREADY-REGISTERED base challenge
        ``bcid`` (no transcript interaction — pure registry material).
        Returns cid0 such that a^i lives at cid0 + i."""
        cid0 = self.alloc_cid(max(n, 0))
        a = np.asarray(base_val, np.uint64).reshape(4)
        vals = np.zeros((n + 1, 4), np.uint64)
        cur = exth.one()
        for i in range(n):
            vals[i] = cur
            cur = exth.mul(cur, a)
        vals[n] = cur
        pid = self.next_pid
        self.next_pid += 1
        self.pow_chains.append((pid, bcid, cid0, a, vals))
        self.use(bcid, n)
        return cid0

    def const_cid(self, value) -> int:
        """cid of a key-fixed constant table row (allocated on first use)."""
        v = np.asarray(value, np.uint64).reshape(4) % _P
        key = v.tobytes()
        if key not in self.const_rows:
            self.const_rows[key] = (self.alloc_cid(), v)
        return self.const_rows[key][0]


class ChainTranscript(Transcript):
    """A ``Transcript`` that records every permutation/absorb/sample so the
    whole interaction can be re-proven by the fs-chain chips. Semantics are
    bit-identical to the base class (same state evolution); the recording
    happens in overridden ``append``/``sample_base``.

    ``cursor()`` returns a replaying clone positioned at the current duplex
    coordinates that shares this transcript's registry: stage witgen mirrors
    drive the cursor through the same interaction the verifier performed and
    register the challenges/absorbed values their chips bind (slot indices
    line up with the main recording by construction). Cursors do not record
    rows — only the main pass feeds ``finalize``."""

    __slots__ = ("registry", "rows", "abs_vals", "_blk", "_step", "_record",
                 "step_base", "filled")

    def __init__(self, label: bytes | None = None, registry=None,
                 step_base: int = 0):
        self.registry = registry or FsRegistry()
        self.rows = []            # (state_in16, blk8) per permutation
        self.abs_vals = {}        # abs slot idx -> value (all 8 per row)
        self.filled = set()       # abs slots an append actually wrote
        self._blk = np.zeros(p2.RATE, np.uint64)
        self._step = step_base    # chains share a bus: disjoint step ranges
        self.step_base = step_base
        self._record = True
        super().__init__(label)

    def snapshot(self):
        return (self.state.copy(), self._pos, self._sq_pos, self._absorbed,
                self._step)

    def cursor(self) -> "ChainTranscript":
        c = ChainTranscript(None, registry=self.registry)
        c.state, c._pos, c._sq_pos, c._absorbed, c._step = (
            self.state.copy(), self._pos, self._sq_pos, self._absorbed,
            self._step,
        )
        c._record = False
        return c

    @staticmethod
    def from_snapshot(snap, registry) -> "ChainTranscript":
        c = ChainTranscript(None, registry=registry)
        c.state, c._pos, c._sq_pos, c._absorbed, c._step = (
            snap[0].copy(), snap[1], snap[2], snap[3], snap[4],
        )
        c._record = False
        return c

    # -- recording duplex ------------------------------------------------------

    def _permute_now(self):
        if self._record:
            self.rows.append((self.state.copy(), self._blk.copy()))
            for j in range(p2.RATE):
                self.abs_vals[self._step * 8 + j] = int(self._blk[j])
            self._blk = np.zeros(p2.RATE, np.uint64)
        self._step += 1

    def append(self, elems) -> None:
        arr = np.atleast_1d(np.asarray(elems, np.uint64))
        for e in arr.ravel():
            if self._pos == p2.RATE:
                self._permute_now()
                self.state = p2.permute_host(self.state)
                self._pos = 0
            if self._record:
                self._blk[self._pos] = e % _P
                self.filled.add(self._step * 8 + self._pos)
            self.state[self._pos] = (self.state[self._pos] + e) % _P
            self._pos += 1
            self._absorbed = True

    def sample_base(self) -> int:
        if self._absorbed or self._sq_pos == p2.RATE:
            self._permute_now()
            self.state = p2.permute_host(self.state)
            self._pos = 0
            self._sq_pos = 0
            self._absorbed = False
        v = int(self.state[self._sq_pos])
        self._sq_pos += 1
        return v

    def _sample_slot_idx(self) -> int:
        """Sample-slot key of the NEXT base sample (call before sampling)."""
        if self._absorbed or self._sq_pos == p2.RATE:
            return (self._step + 1) * 8 + 0
        return self._step * 8 + self._sq_pos

    # -- challenge / absorbed-value registration ---------------------------------
    # NOTE slot keys of consecutive elements are consecutive integers even
    # across a permutation boundary (slot = 8*step + pos and a new block
    # starts at 8*(step+1)), so the 4-wide table reads always line up.

    def sample_ext_chal(self, cid: int | None = None):
        """Sample an ext challenge AND register it as challenge-table row
        ``cid`` (auto-allocated if None). Returns (cid, (4,) value)."""
        if cid is None:
            cid = self.registry.alloc_cid()
        sidx = self._sample_slot_idx()
        v = np.array(self.sample_ext(), np.uint64)
        for j in range(4):
            self.registry.claimed_samples.add(sidx + j)
        self.registry.chal_rows.append((cid, sidx, v))
        return cid, v

    def sample_ext_pows_chal(self, n: int):
        """sample_ext_pows mirror: the base lands at an auto table row,
        a^0..a^{n-1} at rows cid0..cid0+n-1 via a pow chain. Returns
        (cid0, (n, 4) powers)."""
        bcid, a = self.sample_ext_chal()
        cid0 = self.registry.alloc_cid(max(n, 0))
        out = np.zeros((max(n, 0), 4), np.uint64)
        vals = np.zeros((n + 1, 4), np.uint64)
        cur = exth.one()
        for i in range(n):
            out[i] = cur
            vals[i] = cur
            cur = exth.mul(cur, a)
        vals[n] = cur
        pid = self.registry.next_pid
        self.registry.next_pid += 1
        self.registry.pow_chains.append((pid, bcid, cid0, a, vals))
        self.registry.use(bcid, n)  # each pow row looks the base up once
        return cid0, out

    def append_ext_chal(self, value, cid: int | None = None) -> int:
        """Absorb an ext element AND register it on the absorbed-ext table
        (its 4 absorb slots are supplied by the table row). Returns cid."""
        if cid is None:
            cid = self.registry.alloc_cid()
        v = np.asarray(value, np.uint64).reshape(4) % _P
        slots = self.absorb_slots_of_next(4)
        self.append(v)
        for s in slots:
            self.registry.claimed_abs.add(s)
        self.registry.absx_rows.append((cid, slots[0], v))
        return cid

    def append_base_chal(self, value, cid: int | None = None) -> int:
        if cid is None:
            cid = self.registry.alloc_cid()
        v = int(value) % bb.P
        slots = self.absorb_slots_of_next(1)
        self.append([v])
        self.registry.claimed_abs.add(slots[0])
        self.registry.absb_rows.append((cid, slots[0], v))
        return cid

    def use(self, cid: int, times: int = 1) -> None:
        """Count a consumer chip's LK_AGG_CHAL lookup of ``cid``."""
        self.registry.use(cid, times)

    # -- direct slot binding (single-use values) --------------------------------
    # A consumer chip row can bind an absorbed/sampled value WITHOUT the
    # lookup table by writing/reading the duplex slot records itself:
    # absorbed proof data -> the row WRITES (AbsSlot, aidx+k, elem_k);
    # a sampled challenge -> the row READS (SampleSlot, sidx+j, chal_j).
    # These helpers perform the interaction, claim the slots (so the
    # generic suppliers/scavenger skip them) and return the base index the
    # chip's FIXED schedule column carries.

    def append_slots(self, elems) -> int:
        """Absorb ``elems``; the CONSUMER chip supplies the slots (claimed
        here). Returns the base absorb-slot index (slots are consecutive)."""
        arr = np.atleast_1d(np.asarray(elems, np.uint64)).ravel()
        slots = self.absorb_slots_of_next(len(arr))
        assert slots == list(range(slots[0], slots[0] + len(arr)))
        self.append(arr)
        for s in slots:
            self.registry.claimed_abs.add(s)
        return slots[0]

    def sample_ext_slot(self):
        """Sample an ext challenge whose 4 slots the CONSUMER chip reads
        directly. Returns (sidx, (4,) value)."""
        sidx = self._sample_slot_idx()
        v = np.array(self.sample_ext(), np.uint64)
        for j in range(4):
            self.registry.claimed_samples.add(sidx + j)
        return sidx, v

    def sample_base_slot(self):
        """Sample one BASE element whose slot the CONSUMER chip reads
        directly (pcs query indices / PoW checks). Returns (sidx, value)."""
        sidx = self._sample_slot_idx()
        v = self.sample_base()
        self.registry.claimed_samples.add(sidx)
        return sidx, v

    def register_absorbed_ext(self, aidx: int, value) -> int:
        """Register 4 ALREADY-RECORDED absorb slots (main-pass absorbs the
        stage mirrors don't replay, e.g. the shard verify's commitment-root
        absorb) as an absorbed-ext table row. Returns the cid."""
        cid = self.registry.alloc_cid()
        v = np.asarray(value, np.uint64).reshape(4) % _P
        for k in range(4):
            self.registry.claimed_abs.add(aidx + k)
        self.registry.absx_rows.append((cid, aidx, v))
        return cid

    def register_absorbed_base(self, aidx: int, value) -> int:
        cid = self.registry.alloc_cid()
        self.registry.claimed_abs.add(aidx)
        self.registry.absb_rows.append((cid, aidx, int(value) % bb.P))
        return cid

    def clone(self):
        """Stage captures inside scheme.verify take clones; for a recording
        chain the natural clone is a registry-sharing replay cursor."""
        return self.cursor()

    def claim_absorb(self, idx: int, n: int = 1) -> None:
        """A dedicated chip writes (AbsSlot, idx..idx+n): skip fs_abs rows."""
        for k in range(n):
            self.registry.claimed_abs.add(idx + k)

    def claim_sample(self, idx: int, n: int = 1) -> None:
        for k in range(n):
            self.registry.claimed_samples.add(idx + k)

    def absorb_slots_of_next(self, n_elems: int) -> list:
        """Abs-slot indices the NEXT ``n_elems`` appended elements will
        occupy (call BEFORE appending them)."""
        out = []
        pos = self._pos
        step = self._step
        for _ in range(n_elems):
            if pos == p2.RATE:
                step += 1
                pos = 0
            out.append(step * 8 + pos)
            pos += 1
        return out

    # -- finalize ---------------------------------------------------------------

    def finalize_chain(self, chips: FsChainChips):
        """Emit (name, compiled, cb, wit, fixed) for this CHAIN's chips
        (duplex rows, ends, absorb suppliers, scavenger). Must be called
        when no partial block is pending a permute that will never happen —
        any trailing absorbed-but-unsampled elements are flushed with one
        final permutation so the chain ends cleanly. Registry-level chips
        (challenge/absorbed tables, pow chains — shared by every chain of
        an aggregation) come from :func:`finalize_registry`."""
        reg = self.registry
        if np.any(self._blk) or self._absorbed:
            self._permute_now()
            self.state = p2.permute_host(self.state)
            self._pos = 0
            self._sq_pos = 0
            self._absorbed = False

        n_rows = len(self.rows)
        states = np.stack([r[0] for r in self.rows]) if n_rows else \
            np.zeros((0, p2.WIDTH), np.uint64)
        blks = np.stack([r[1] for r in self.rows]) if n_rows else \
            np.zeros((0, p2.RATE), np.uint64)
        # the recorded state_in already contains the block additions (append
        # adds in place): the chip's st wires are state BEFORE the block
        pre = states.copy()
        pre[:, :p2.RATE] = (pre[:, :p2.RATE] + _P - blks) % _P
        dcols: dict = {
            "step": self.step_base + np.arange(n_rows, dtype=np.uint64)
        }
        for j in range(p2.WIDTH):
            dcols[f"st{j}"] = pre[:, j]
        for j in range(p2.RATE):
            dcols[f"blk{j}"] = blks[:, j]
        u, w, outs = assign_poseidon2(states)
        names = [n for n in chips.duplex_cb.wit_names if n.startswith("p_")]
        vals = [x for uw in zip(u, w) for x in uw]
        for name, x in zip(names, vals):
            dcols[name] = x
        dup_wit = _mat(chips.duplex_cb, dcols, n_rows)

        ecols = {"n_steps": np.array([self.step_base + n_rows], np.uint64)}
        fin = outs[-1] if n_rows else np.zeros(p2.WIDTH, np.uint64)
        for j in range(p2.WIDTH):
            ecols[f"fin{j}"] = np.array([fin[j]], np.uint64)
        ends_wit = _mat(chips.ends_cb, ecols, 1)
        ends_fixed = np.array([[self.step_base]], np.uint64)

        # absorb suppliers: every slot not claimed by a dedicated chip.
        # The split is STRUCTURAL: slots no append ever wrote (block padding
        # the duplex schedule says is empty) go to the FIXED-index zero chip
        # — forcing them zero is soundness-critical (a free supplier there
        # could fork the in-circuit transcript). Absorbed-but-unclaimed
        # values (zero or not) go to the generic witness supplier. A
        # value-based split would make the aggregation key depend on proof
        # VALUES, breaking verifier-side key reconstruction
        # (zkvm/aggregate.py::expected_agg_key).
        free = sorted(set(self.abs_vals) - reg.claimed_abs)
        nz = [i for i in free if i in self.filled]
        zz = [i for i in free if i not in self.filled]
        abs_wit = _mat(chips.abs_cb, {
            "idx": np.array(nz, np.uint64),
            "v": np.array([self.abs_vals[i] for i in nz], np.uint64),
        }, len(nz))
        abs0_fixed = np.array([zz], np.uint64)

        # scavenger: published samples nobody read
        all_samples = {}
        for s in range(n_rows):
            for j in range(p2.RATE):
                all_samples[(self.step_base + s + 1) * 8 + j] = int(outs[s][j])
        leftover = sorted(set(all_samples) - reg.claimed_samples)
        scav_wit = _mat(chips.scav_cb, {
            "idx": np.array(leftover, np.uint64),
            "v": np.array([all_samples[i] for i in leftover], np.uint64),
        }, len(leftover))
        return [
            ("fs_duplex", chips.duplex_compiled, chips.duplex_cb, dup_wit,
             None),
            ("fs_ends", chips.ends_compiled, chips.ends_cb, ends_wit,
             ends_fixed),
            ("fs_abs", chips.abs_compiled, chips.abs_cb, abs_wit, None),
            ("fs_abs0", chips.abs0_compiled, chips.abs0_cb,
             np.zeros((1, len(zz)), np.uint64), abs0_fixed),
            ("fs_scav", chips.scav_compiled, chips.scav_cb, scav_wit, None),
        ]

    def finalize(self, chips: FsChainChips):
        """Single-chain convenience: chain chips + registry chips."""
        return self.finalize_chain(chips) + finalize_registry(
            chips, self.registry
        )


def finalize_registry(chips: FsChainChips, reg: FsRegistry):
    """Emit the registry-level chips (challenge table, absorbed-ext/base
    tables, pow chains) — ONE set per aggregation, shared by every chain."""
    if True:
        # challenge table
        def _table(rows):
            n_c = len(rows)
            ccols = {"mult": np.array(
                [reg.chal_mult.get(cid, 0) for cid, _, _ in rows],
                np.uint64)}
            cvals = np.stack([v for _, _, v in rows]) if n_c else \
                np.zeros((0, 4), np.uint64)
            for j in range(4):
                ccols[f"v{j}"] = cvals[:, j] if n_c else np.zeros(0, np.uint64)
            fixed = np.array(
                [[cid for cid, _, _ in rows], [ix for _, ix, _ in rows]],
                np.uint64,
            ) if n_c else np.zeros((2, 0), np.uint64)
            return ccols, fixed, n_c

        ccols, chal_fixed, n_chal = _table(reg.chal_rows)
        chal_wit = _mat(chips.chal_cb, ccols, n_chal)
        xcols, absx_fixed, n_absx = _table(reg.absx_rows)
        absx_wit = _mat(chips.absx_cb, xcols, n_absx)
        bcols = {
            "mult": np.array([reg.chal_mult.get(cid, 0)
                              for cid, _, _ in reg.absb_rows], np.uint64),
            "v": np.array([v for _, _, v in reg.absb_rows], np.uint64),
        }
        absb_fixed = np.array(
            [[cid for cid, _, _ in reg.absb_rows],
             [ix for _, ix, _ in reg.absb_rows]], np.uint64,
        ) if reg.absb_rows else np.zeros((2, 0), np.uint64)
        absb_wit = _mat(chips.absb_cb, bcols, len(reg.absb_rows))

        # pow chains
        pid_rows, i_rows, a_rows, v_rows, m_rows = [], [], [], [], []
        bcid_rows, cid_rows = [], []
        ps_pids, pe_rows = [], []
        for pid, bcid, cid0, a, vals2 in reg.pow_chains:
            n = vals2.shape[0] - 1
            ps_pids.append(pid)
            for i in range(n):
                pid_rows.append(pid)
                i_rows.append(i)
                bcid_rows.append(bcid)
                cid_rows.append(cid0 + i)
                a_rows.append(a)
                v_rows.append(vals2[i])
                m_rows.append(reg.chal_mult.get(cid0 + i, 0))
            pe_rows.append((pid, n, vals2[n]))
        pcols: dict = {
            "pid": np.array(pid_rows, np.uint64),
            "i": np.array(i_rows, np.uint64),
            "mult": np.array(m_rows, np.uint64),
        }
        G.assign_ext(pcols, "a", np.stack(a_rows) if a_rows else
                     np.zeros((0, 4), np.uint64))
        G.assign_ext(pcols, "v", np.stack(v_rows) if v_rows else
                     np.zeros((0, 4), np.uint64))
        G.assign_ext(pcols, "va", np.stack(
            [exth.mul(vv, aa) for vv, aa in zip(v_rows, a_rows)]
        ) if v_rows else np.zeros((0, 4), np.uint64))
        pow_wit = _mat(chips.pow_cb, pcols, len(pid_rows))
        pow_fixed = np.array([bcid_rows, cid_rows], np.uint64) if pid_rows \
            else np.zeros((2, 0), np.uint64)
        ps_wit = _mat(chips.pow_start_cb,
                      {"pid": np.array(ps_pids, np.uint64)}, len(ps_pids))
        pecols: dict = {
            "pid": np.array([r[0] for r in pe_rows], np.uint64),
            "k": np.array([r[1] for r in pe_rows], np.uint64),
        }
        G.assign_ext(pecols, "v", np.stack([r[2] for r in pe_rows])
                     if pe_rows else np.zeros((0, 4), np.uint64))
        pe_wit = _mat(chips.pow_end_cb, pecols, len(pe_rows))

        kcols = {"mult": np.array(
            [reg.chal_mult.get(cid, 0)
             for cid, _ in reg.const_rows.values()], np.uint64)}
        const_fixed = np.zeros((5, len(reg.const_rows)), np.uint64)
        for j, (cid, v) in enumerate(reg.const_rows.values()):
            const_fixed[0, j] = cid
            const_fixed[1:, j] = v
        const_wit = _mat(chips.const_cb, kcols, len(reg.const_rows))

        none_fixed = None
        return [
            ("fs_chal", chips.chal_compiled, chips.chal_cb, chal_wit,
             chal_fixed),
            ("fs_absx", chips.absx_compiled, chips.absx_cb, absx_wit,
             absx_fixed),
            ("fs_absb", chips.absb_compiled, chips.absb_cb, absb_wit,
             absb_fixed),
            ("fs_const", chips.const_compiled, chips.const_cb, const_wit,
             const_fixed),
            ("fs_pow_start", chips.pow_start_compiled, chips.pow_start_cb,
             ps_wit, none_fixed),
            ("fs_pow", chips.pow_compiled, chips.pow_cb, pow_wit, pow_fixed),
            ("fs_pow_end", chips.pow_end_compiled, chips.pow_end_cb, pe_wit,
             none_fixed),
        ]


def _mat(cb: CircuitBuilder, cols: dict, n: int) -> np.ndarray:
    wit = np.zeros((len(cb.wit_names), n), np.uint64)
    for j, name in enumerate(cb.wit_names):
        assert name in cols, name
        wit[j] = np.asarray(cols[name], np.uint64) % _P
    return wit


# ---------------------------------------------------------------------------
# Statement binding: the chain's FIRST absorbs are the label digest (a build-
# time constant), the shard vk digest and the shard public values — exactly
# the aggregation proof's public values (zkvm/aggregate.py: agg pv =
# vk.digest_elems() ++ shard pv). This one-row chip FORCES those absorb
# slots to equal Instance() references into the aggregation pv, closing the
# loop: a verifier of the aggregation proof that checks its public values
# has bound the in-circuit transcript to the shard statement.
# ---------------------------------------------------------------------------


def build_pv_supply_chip(label: bytes, n_instance: int,
                         inst_indices=None, step_base: int = 0):
    """One-row chip writing (AbsSlot, slot0 + k, label_digest[k]) for the 8
    label slots and (AbsSlot, slot0 + 8 + i, Instance(idx_i)) for the
    ``n_instance`` statement elements absorbed right after (slots are
    consecutive from slot0 = 8*step_base: nothing is sampled before the
    statement absorbs finish). ``inst_indices`` maps each absorbed element
    to its aggregation-pv slot (default: 0..n_instance-1); together with
    ``step_base`` this places each shard's chain in a multi-shard
    aggregation where the shared vk digest heads the pv."""
    words = [
        int.from_bytes(label[i:i + 4], "little") % bb.P
        for i in range(0, len(label), 4)
    ]
    digest = p2.hash_elements_host(words or [0])
    slot0 = 8 * step_base
    if inst_indices is None:
        inst_indices = list(range(n_instance))
    assert len(inst_indices) == n_instance
    cb = CircuitBuilder("fs_pv_supply")
    d = cb.create_witin("d")  # chips need >=1 witness column; pinned zero
    cb.require_zero("d0", d)
    for k in range(p2.DIGEST_ELEMS):
        cb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT),
                         E.Const(slot0 + k), E.Const(int(digest[k]))])
    for i in range(n_instance):
        cb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ABS_SLOT),
                         E.Const(slot0 + p2.DIGEST_ELEMS + i),
                         E.Instance(int(inst_indices[i]))])
    return cb, compile_chip(cb)


def assign_pv_supply(chain: "ChainTranscript", n_instance: int) -> np.ndarray:
    """Claim the statement absorb slots (call after the main verify pass so
    abs_vals is populated) and return the one-row witness matrix."""
    chain.claim_absorb(8 * chain.step_base, p2.DIGEST_ELEMS + n_instance)
    return np.zeros((1, 1), np.uint64)
