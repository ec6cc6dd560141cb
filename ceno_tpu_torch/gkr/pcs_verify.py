"""Basefold query-phase verification in-circuit (RECURSION.md #6, the PCS
soundness tail).

Role mirror of the reference recursion's PCS verifier tables
(ceno_recursion_v2/src/pcs/mod.rs — 8.4k LoC that exist solely to re-prove
the Basefold/jagged query phase inside the recursion VM). This module
re-proves EVERYTHING pcs/basefold.py::verify_batch does for the jagged
single-point batch opening (K = 1, the only shape the zkVM scheme emits):

  * gamma batching:      batched = sum_c gamma^c * V_c(r)   (bsum chips;
    gamma powers ride an fs pow chain, V_c evals are absorbed-ext rows)
  * the opening sumcheck (generic deg-2 rounds chip, duplex-slot-bound)
    interleaved with the fold-root / tail absorbs (registered absx rows)
  * recombination:       final_claim == eq(z, r) * F(point)  (shared eq1
    chain rows; z = the jagged translation point, r = the opening
    sumcheck's challenges — both on the challenge table)
  * tail folding:        the in-clear tail folds to the CONSTANT F(point)
    (tail chips with FIXED twiddle schedule)
  * PoW grinding:        nonce absorb + sampled element < P >> pow_bits
    (bit-decomposition range check)
  * query sampling:      each query index is the canonical (< P) bit
    decomposition of a duplex sample slot; low bits form the Merkle index
  * query spot checks:   base-leaf gamma combination == U_0, fold
    consistency across every committed level (twiddles w^{-p} built from
    the index bits by mux chains), membership of every opened row via
    Poseidon2 leaf sponges + the Merkle path rows chip, the walk roots
    bound to the absorbed commitment root (wit) or the aggregation key
    (fixed-column commitment).

Bus sub-tags continue recursion.py/fs_chain.py's RAM_CUSTOM namespace; the
LK_QBIT logup table publishes each query index's 31 bits so every consumer
(index peeling, fold slot muxes, twiddle chains) reads the one canonical
decomposition.

Like the rest of the recursion stack the chips are GENERIC: all geometry
(slot indices, challenge cids, twiddle constants, tree depths) lives in
FIXED schedule columns committed by the aggregation key.

Copy of ``ceno_tpu/gkr/pcs_verify.py``, in host numpy; the twiddles come
from the port's ``pcs/ntt.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..hash import poseidon2 as p2
from ..mle import expression as E
from ..pcs import ntt
from ..zkvm.chips.poseidon2_gadget import Lin, assign_poseidon2, build_poseidon2
from . import fs_chain as FS
from . import gadgets as G
from .chip import compile_chip
from .circuit_builder import CircuitBuilder, RAM_CUSTOM
from .recursion import TAG_MERKLE_PATH, TAG_EQ_CHAIN, TAG_SUMCHECK_CLAIM
from ..utils import replay

_P = np.uint64(bb.P)
_INV2 = pow(2, bb.P - 2, bb.P)

# RAM_CUSTOM sub-tags (recursion.py uses 3..14, fs_chain.py 15..18)
TAG_QVAL = 19        # (wid, j, v): opened base-row column value j of walk wid
TAG_COMB = 20        # (wid, j, acc4): gamma-combination chain over columns
TAG_LEAF_STATE = 21  # (wid, blk, state16): leaf sponge chain
TAG_FOLD_AB = 22     # (qid, t, a4 b4): the pair entering fold step t
TAG_LVAL = 23        # (qid, t, side, v4): committed fold-level row value
TAG_TWID = 24        # (tid, i, acc): twiddle product chain w^{-p}
TAG_QIDX = 25        # (qid, u, p): query index peeled u times (x3 multiset)
TAG_TAIL = 26        # (oid, u, i, v4): tail fold value chain
TAG_BSUM = 27        # (oid, j, acc4): batched-claim chain

LK_QBIT = 19         # logup table: (qid, bit position, bit)

N_BITS = 31          # BabyBear values are < 2^31; canonicity enforced


@dataclass
class PcsGeo:
    """Query-phase geometry of ONE batch opening (derived, deterministic)."""

    n_vars: int        # commitment vars == opening sumcheck rounds
    n_cols: int        # C: committed matrix columns
    blowup_log: int
    stop_size: int
    pow_bits: int
    n_queries: int

    @property
    def log_m(self) -> int:
        return self.n_vars + self.blowup_log

    @property
    def m(self) -> int:
        return 1 << self.log_m

    @property
    def n_committed(self) -> int:
        """Committed fold levels T (pcs/basefold.py open_batch hook)."""
        t = 0
        for rnd in range(self.n_vars):
            new_m = self.m >> (rnd + 1)
            if new_m <= self.stop_size or rnd == self.n_vars - 1:
                return t
            t += 1
        return t

    @property
    def tail_rounds(self) -> int:
        return self.n_committed + 1

    @property
    def tail_log(self) -> int:
        return self.log_m - self.tail_rounds

    @property
    def n_tail_folds(self) -> int:
        """Folds applied to the in-clear tail (verify_batch tail loop)."""
        return self.n_vars - self.tail_rounds

    @property
    def n_blocks(self) -> int:
        """Leaf sponge blocks for a base-tree leaf (C values, rate 8)."""
        return max(1, (self.n_cols + p2.RATE - 1) // p2.RATE)

    def walk_count(self) -> int:
        """Merkle walks per query: 2 base + 2 per committed level."""
        return 2 * (self.n_committed + 1)


@dataclass
class PcsVerifyChips:
    """The generic (geometry-free) query-phase chip set; one instance per
    aggregation, shared across openings and queries."""

    qbit_cb: CircuitBuilder
    qbit_compiled: object
    qidx_cb: CircuitBuilder
    qidx_compiled: object
    peel_cb: CircuitBuilder
    peel_compiled: object
    pow_cb: CircuitBuilder | None
    pow_compiled: object | None
    comb_cb: CircuitBuilder
    comb_compiled: object
    combe_cb: CircuitBuilder
    combe_compiled: object
    qpad_cb: CircuitBuilder
    qpad_compiled: object
    leaf_cb: CircuitBuilder
    leaf_compiled: object
    leafe_cb: CircuitBuilder
    leafe_compiled: object
    lleaf_cb: CircuitBuilder
    lleaf_compiled: object
    rootlk_cb: CircuitBuilder
    rootlk_compiled: object
    rootfx_cb: CircuitBuilder
    rootfx_compiled: object
    twid_cb: CircuitBuilder
    twid_compiled: object
    fold_cb: CircuitBuilder
    fold_compiled: object
    qend_cb: CircuitBuilder
    qend_compiled: object
    tsrc_cb: CircuitBuilder
    tsrc_compiled: object
    tfold_cb: CircuitBuilder
    tfold_compiled: object
    tend_cb: CircuitBuilder
    tend_compiled: object
    bsum_cb: CircuitBuilder
    bsum_compiled: object
    bsume_cb: CircuitBuilder
    bsume_compiled: object
    cbind_cb: CircuitBuilder
    cbind_compiled: object
    pow_bits: int


def build_pcs_verify_chips(pow_bits: int) -> PcsVerifyChips:
    # -- query-bit table: the one canonical decomposition per query ----------
    qb = CircuitBuilder("pcs_qbits")
    qb_qid = qb.create_fixed("qid")
    qb_i = qb.create_fixed("i")
    qb_b = qb.create_witin("b")
    qb_m = qb.create_witin("mult")
    qb.assert_bit("b_bool", qb_b)
    qb.lk_table_record(LK_QBIT, qb_m, [qb_qid, qb_i, qb_b])
    qbit_compiled = compile_chip(qb)

    # -- query index chip: one row per query ----------------------------------
    # Reads the duplex sample, proves its canonical 31-bit decomposition
    # (value < P), and seeds the index-peel chain with idx = low bits.
    ib = CircuitBuilder("pcs_qidx")
    ib_qid = ib.create_fixed("qid")
    ib_sidx = ib.create_fixed("sidx")
    ib_v = ib.create_witin("v")
    bits = [ib.create_witin(f"b{i}") for i in range(N_BITS)]
    for i, b in enumerate(bits):
        ib.lk_record(LK_QBIT, [ib_qid, E.Const(i), b])
    recomp = bits[0]
    for i in range(1, N_BITS):
        recomp = recomp + bits[i] * (1 << i)
    ib.require_zero("recompose", recomp - ib_v)
    # canonicity: v < P = 15*2^27 + 1  <=>  hi4 < 15, or hi4 == 15 && lo27 == 0
    hi4 = bits[27] + bits[28] * 2 + bits[29] * 4 + bits[30] * 8
    inv_h = ib.create_witin("inv_h")
    f = ib.create_witin("f15")          # f == (hi4 == 15)
    d = hi4 - 15
    ib.require_zero("f_kill", f * d)
    ib.require_zero("f_def", (f - 1) + d * inv_h)
    lo27 = bits[0]
    for i in range(1, 27):
        lo27 = lo27 + bits[i] * (1 << i)
    ib.require_zero("canonical", f * lo27)
    ib.read_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_SAMPLE_SLOT),
                    ib_sidx, ib_v])
    # idx = v's low (log_m - 1) bits: the schedule bakes log_m via the
    # hi-bit coefficient mask columns mhi_i (1 for i < log_m-1 else 0)
    mk = [ib.create_fixed(f"mk{i}") for i in range(N_BITS)]
    idx = bits[0] * mk[0]
    for i in range(1, N_BITS):
        idx = idx + bits[i] * mk[i] * (1 << i)
    head = [E.Const(RAM_CUSTOM), E.Const(TAG_QIDX), ib_qid, E.Const(0)]
    for _ in range(3):                  # 3 readers per QIDX step (see peel)
        ib.write_record(head + [idx])
    qidx_compiled = compile_chip(ib)

    # -- index peel chain: strips the top bit per committed level -------------
    # step u holds p_u = idx mod 2^{log_m-1-u}; row u reads it, looks the
    # stripped bit up, writes p_{u+1} = p_u - b * 2^{e_u} (x3).
    pb = CircuitBuilder("pcs_peel")
    pb_qid = pb.create_fixed("qid")
    pb_u = pb.create_fixed("u")
    pb_i = pb.create_fixed("i")         # bit position being stripped
    pb_pw = pb.create_fixed("pw")       # 2^i
    pb_p = pb.create_witin("p")
    pb_b = pb.create_witin("b")
    pb.lk_record(LK_QBIT, [pb_qid, pb_i, pb_b])
    phead = [E.Const(RAM_CUSTOM), E.Const(TAG_QIDX), pb_qid]
    pb.read_record(phead + [pb_u, pb_p])
    nxt = pb_p - pb_b * pb_pw
    for _ in range(3):
        pb.write_record(phead + [pb_u + 1, nxt])
    peel_compiled = compile_chip(pb)

    # -- PoW grinding chip: one row per opening --------------------------------
    pow_cb = pow_compiled = None
    if pow_bits > 0:
        thr = bb.P >> pow_bits          # sample must be < thr
        nb = max((thr - 1).bit_length(), 1)
        wb = CircuitBuilder("pcs_pow")
        wb_nidx = wb.create_fixed("nidx")
        wb_sidx = wb.create_fixed("sidx")
        wb_nonce = wb.create_witin("nonce")
        wb_v = wb.create_witin("v")
        wb.write_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_ABS_SLOT),
                         wb_nidx, wb_nonce])
        wb.read_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_SAMPLE_SLOT),
                        wb_sidx, wb_v])
        vb = [wb.create_witin(f"vb{i}") for i in range(nb)]
        cb_ = [wb.create_witin(f"cb{i}") for i in range(nb)]
        for i in range(nb):
            wb.assert_bit(f"vb_bool{i}", vb[i])
            wb.assert_bit(f"cb_bool{i}", cb_[i])
        sv = vb[0]
        sc = cb_[0]
        for i in range(1, nb):
            sv = sv + vb[i] * (1 << i)
            sc = sc + cb_[i] * (1 << i)
        wb.require_zero("v_decomp", sv - wb_v)
        wb.require_zero("v_bound", sc - (thr - 1) + wb_v)  # c = thr-1-v >= 0
        pow_cb, pow_compiled = wb, compile_chip(wb)

    # -- gamma combination chain: one row per (walk, column) ------------------
    # acc' = acc + gamma^j * v ; also publishes v for the leaf sponge.
    cb = CircuitBuilder("pcs_comb")
    cb_wid = cb.create_witin("wid")
    cb_j = cb.create_witin("j")
    cb_gcid = cb.create_fixed("gcid")
    g = G.ext_witness(cb, "g")
    v = cb.create_witin("v")
    acc = G.ext_witness(cb, "acc")
    cb.lk_record(FS.LK_AGG_CHAL, [cb_gcid] + g.c)
    gv = G.ExtWire(*[g.c[i] * v for i in range(4)])
    chead = [E.Const(RAM_CUSTOM), E.Const(TAG_COMB), cb_wid]
    cb.read_record(chead + [cb_j] + acc.c)
    cb.write_record(chead + [cb_j + 1] + acc.add(gv).c)
    cb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_QVAL), cb_wid, cb_j, v])
    comb_compiled = compile_chip(cb)

    # -- combination ends: one row per query ----------------------------------
    # Closes both walks' chains and seeds the fold chain with (U_0^a, U_0^b).
    ce = CircuitBuilder("pcs_comb_ends")
    ce_qid = ce.create_witin("qid")
    ce_w0 = ce.create_witin("w0")       # side-0 walk id (= w1 - 1)
    ce_nc = ce.create_fixed("nc")       # chain length C
    ua = G.ext_witness(ce, "ua")
    ub = G.ext_witness(ce, "ub")
    zero4 = G.ExtWire.constant(np.zeros(4, np.uint64))
    for side, u in ((0, ua), (1, ub)):
        whead = [E.Const(RAM_CUSTOM), E.Const(TAG_COMB), ce_w0 + side]
        ce.write_record(whead + [E.Const(0)] + zero4.c)
        ce.read_record(whead + [ce_nc] + u.c)
    ce.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_FOLD_AB), ce_qid,
                     E.Const(0)] + ua.c + ub.c)
    combe_compiled = compile_chip(ce)

    # -- qval zero padding (sponge blocks beyond C) ----------------------------
    qp = CircuitBuilder("pcs_qpad")
    qp_wid = qp.create_fixed("wid")
    qp_j = qp.create_fixed("j")
    qp_d = qp.create_witin("d")
    qp.require_zero("d0", qp_d)
    qp.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_QVAL), qp_wid, qp_j,
                     E.Const(0)])
    qpad_compiled = compile_chip(qp)

    # -- leaf sponge rows: one row per (walk, block) ---------------------------
    lb = CircuitBuilder("pcs_leaf")
    lb_wid = lb.create_witin("wid")
    lb_blk = lb.create_witin("blk")
    st = [lb.create_witin(f"st{j}") for j in range(p2.WIDTH)]
    blkv = [lb.create_witin(f"bv{j}") for j in range(p2.RATE)]
    for j in range(p2.RATE):
        lb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_QVAL), lb_wid,
                        lb_blk * p2.RATE + j, blkv[j]])
    lins = [Lin.col(st[j]) + Lin.col(blkv[j]) for j in range(p2.RATE)]
    lins += [Lin.col(st[j]) for j in range(p2.RATE, p2.WIDTH)]
    out = build_poseidon2(lb, "p", lins)
    shead = [E.Const(RAM_CUSTOM), E.Const(TAG_LEAF_STATE), lb_wid]
    lb.read_record(shead + [lb_blk] + [Lin.col(s).to_expr() for s in st])
    lb.write_record(shead + [lb_blk + 1] + [o.to_expr() for o in out])
    leaf_compiled = compile_chip(lb)

    # -- leaf ends: one row per base walk --------------------------------------
    # Pins the zero sponge start, takes the final state's digest half, reads
    # the query index, and seeds the Merkle walk at level 0.
    le = CircuitBuilder("pcs_leaf_ends")
    le_qid = le.create_witin("qid")
    le_wid = le.create_fixed("wid")
    le_nb = le.create_fixed("nb")
    le_side = le.create_fixed("side")
    le_half = le.create_fixed("half")   # m/2 (side-1 leaf offset)
    le_idx = le.create_witin("idx")
    fin = [le.create_witin(f"fin{j}") for j in range(p2.WIDTH)]
    lhead = [E.Const(RAM_CUSTOM), E.Const(TAG_LEAF_STATE), le_wid]
    le.write_record(lhead + [E.Const(0)] + [E.Const(0)] * p2.WIDTH)
    le.read_record(lhead + [le_nb] + [Lin.col(w).to_expr() for w in fin])
    le.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_QIDX), le_qid,
                    E.Const(0), le_idx])
    le.write_record(
        [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), le_wid, E.Const(0),
         le_idx + le_side * le_half]
        + [Lin.col(w).to_expr() for w in fin[: p2.DIGEST_ELEMS]]
    )
    leafe_compiled = compile_chip(le)

    # -- committed-level leaf: one row per (query, level, side) ----------------
    # leaf digest = permute([v4, 0 x 12])[:8] (K = 1 tuple leaves); seeds
    # the level tree's Merkle walk at the peeled index.
    ll = CircuitBuilder("pcs_lvl_leaf")
    ll_qid = ll.create_witin("qid")
    ll_t = ll.create_fixed("t")
    ll_u = ll.create_fixed("u")         # QIDX peel step this tree indexes (t+1)
    ll_wid = ll.create_fixed("wid")
    ll_side = ll.create_fixed("side")
    ll_half = ll.create_fixed("half")   # mt/2
    lv = G.ext_witness(ll, "v")
    ll_p = ll.create_witin("p")
    ll.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_LVAL), ll_qid, ll_t,
                    ll_side] + lv.c)
    llins = [Lin.col(w) for w in _ext_wit_cols(lv)]
    llins += [Lin.const_(0)] * (p2.WIDTH - 4)
    lout = build_poseidon2(ll, "p", llins)
    ll.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_QIDX), ll_qid, ll_u,
                    ll_p])
    ll.write_record(
        [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), ll_wid, E.Const(0),
         ll_p + ll_side * ll_half]
        + [o.to_expr() for o in lout[: p2.DIGEST_ELEMS]]
    )
    lleaf_compiled = compile_chip(ll)

    # -- root binding (transcript-absorbed roots: wit commitment, fold trees) --
    rl = CircuitBuilder("pcs_root_lk")
    rl_wid = rl.create_fixed("wid")
    rl_d = rl.create_fixed("depth")
    rl_c0 = rl.create_fixed("rcid0")
    rl_c1 = rl.create_fixed("rcid1")
    rroot = [rl.create_witin(f"r{j}") for j in range(p2.DIGEST_ELEMS)]
    rl.read_record(
        [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), rl_wid, rl_d,
         E.Const(0)] + [Lin.col(w).to_expr() for w in rroot]
    )
    rl.lk_record(FS.LK_AGG_CHAL, [rl_c0] + [Lin.col(w).to_expr()
                                            for w in rroot[:4]])
    rl.lk_record(FS.LK_AGG_CHAL, [rl_c1] + [Lin.col(w).to_expr()
                                            for w in rroot[4:]])
    rootlk_compiled = compile_chip(rl)

    # -- root binding (key-fixed roots: the vk's fixed-column commitment) ------
    rf = CircuitBuilder("pcs_root_fx")
    rf_wid = rf.create_fixed("wid")
    rf_d = rf.create_fixed("depth")
    rf_r = [rf.create_fixed(f"rv{j}") for j in range(p2.DIGEST_ELEMS)]
    rf_dm = rf.create_witin("d")
    rf.require_zero("d0", rf_dm)
    rf.read_record(
        [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), rf_wid, rf_d,
         E.Const(0)] + list(rf_r)
    )
    rootfx_compiled = compile_chip(rf)

    # -- twiddle mux chain: one row per (chain, bit) ----------------------------
    # acc' = acc * (1 + b*(c - 1)) with c = w_{2^L}^{-2^i} in the schedule.
    tw = CircuitBuilder("pcs_twid")
    tw_tid = tw.create_witin("tid")
    tw_i = tw.create_witin("i")
    tw_qid = tw.create_fixed("qid")
    tw_bi = tw.create_fixed("bi")       # bit position looked up
    tw_c = tw.create_fixed("c")
    tw_b = tw.create_witin("b")
    tw_f = tw.create_witin("f")         # the mux factor (materialized: deg 2)
    tw_acc = tw.create_witin("acc")
    tw_out = tw.create_witin("out")
    tw.lk_record(LK_QBIT, [tw_qid, tw_bi, tw_b])
    tw.require_zero("factor", tw_f - 1 - tw_b * tw_c + tw_b)
    tw.require_zero("prod", tw_out - tw_acc * tw_f)
    thead = [E.Const(RAM_CUSTOM), E.Const(TAG_TWID), tw_tid]
    tw.read_record(thead + [tw_i] + [tw_acc])
    tw.write_record(thead + [tw_i + 1] + [tw_out])
    twid_compiled = compile_chip(tw)

    # -- fold consistency: one row per (query, committed level t) --------------
    fb = CircuitBuilder("pcs_fold")
    fb_qid = fb.create_witin("qid")
    fb_t = fb.create_fixed("t")
    fb_tid = fb.create_fixed("tid")     # twiddle chain id
    fb_nb = fb.create_fixed("nbits")    # twiddle chain length
    fb_ccid = fb.create_fixed("chcid")  # fold challenge cid
    fb_si = fb.create_fixed("si")       # slot bit position
    fa = G.ext_witness(fb, "a")
    fbw = G.ext_witness(fb, "b")
    ch = G.ext_witness(fb, "ch")
    fb.lk_record(FS.LK_AGG_CHAL, [fb_ccid] + ch.c)
    tw_v = fb.create_witin("tw")
    fhead = [E.Const(RAM_CUSTOM), E.Const(TAG_TWID), fb_tid]
    fb.write_record(fhead + [E.Const(0), E.Const(1)])
    fb.read_record(fhead + [fb_nb, tw_v])
    slot = fb.create_witin("slot")
    fb.lk_record(LK_QBIT, [fb_qid, fb_si, slot])
    fb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_FOLD_AB), fb_qid, fb_t]
                   + fa.c + fbw.c)
    d = fa.sub(fbw)
    td = G.ExtWire(*[d.c[i] * tw_v for i in range(4)])       # deg 2
    ctd = G.ext_mul(fb, "ctd", ch, td)                        # wires (deg<=2)
    folded = fa.add(fbw).add(ctd).scale(_INV2)
    r0 = G.ext_witness(fb, "r0")
    r1 = G.ext_witness(fb, "r1")
    for i in range(4):
        fb.require_zero(
            f"mux{i}", folded.c[i] - r0.c[i] - slot * (r1.c[i] - r0.c[i])
        )
    fb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_LVAL), fb_qid, fb_t,
                     E.Const(0)] + r0.c)
    fb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_LVAL), fb_qid, fb_t,
                     E.Const(1)] + r1.c)
    fb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_FOLD_AB), fb_qid,
                     fb_t + 1] + r0.c + r1.c)
    fold_compiled = compile_chip(fb)

    # -- query end: the last fold lands in the in-clear tail --------------------
    qe = CircuitBuilder("pcs_qend")
    qe_qid = qe.create_witin("qid")
    qe_t = qe.create_fixed("t")         # == T (the tail fold step)
    qe_tid = qe.create_fixed("tid")
    qe_nb = qe.create_fixed("nbits")
    qe_ccid = qe.create_fixed("chcid")
    qe_u = qe.create_fixed("u")         # QIDX peel step == T
    qe_tc0 = qe.create_fixed("tc0")     # first tail-entry cid
    qa = G.ext_witness(qe, "a")
    qb_ = G.ext_witness(qe, "b")
    qch = G.ext_witness(qe, "ch")
    qe.lk_record(FS.LK_AGG_CHAL, [qe_ccid] + qch.c)
    qtw = qe.create_witin("tw")
    qhead = [E.Const(RAM_CUSTOM), E.Const(TAG_TWID), qe_tid]
    qe.write_record(qhead + [E.Const(0), E.Const(1)])
    qe.read_record(qhead + [qe_nb, qtw])
    qe.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_FOLD_AB), qe_qid, qe_t]
                   + qa.c + qb_.c)
    qd = qa.sub(qb_)
    qtd = G.ExtWire(*[qd.c[i] * qtw for i in range(4)])
    qctd = G.ext_mul(qe, "ctd", qch, qtd)
    qfolded = qa.add(qb_).add(qctd).scale(_INV2)
    qp_ = qe.create_witin("p")
    qe.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_QIDX), qe_qid, qe_u,
                    qp_])
    tv = G.ext_witness(qe, "tv")
    qe.lk_record(FS.LK_AGG_CHAL, [qe_tc0 + qp_] + tv.c)
    G.ext_require_equal(qe, "tail_match", G.ExtWire(*qfolded.c), tv)
    qend_compiled = compile_chip(qe)

    # -- tail source rows: absorbed tail entries seed the tail fold chain ------
    ts = CircuitBuilder("pcs_tail_src")
    ts_oid = ts.create_fixed("oid")
    ts_i = ts.create_fixed("i")
    ts_cid = ts.create_fixed("cid")
    tsv = G.ext_witness(ts, "v")
    ts.lk_record(FS.LK_AGG_CHAL, [ts_cid] + tsv.c)
    ts.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_TAIL), ts_oid,
                     E.Const(0), ts_i] + tsv.c)
    tsrc_compiled = compile_chip(ts)

    # -- tail fold rows: one row per (fold step u, output position i) ----------
    tf = CircuitBuilder("pcs_tail_fold")
    tf_oid = tf.create_fixed("oid")
    tf_u = tf.create_fixed("u")
    tf_i = tf.create_fixed("i")
    tf_half = tf.create_fixed("half")
    tf_ccid = tf.create_fixed("chcid")
    tf_tw = tf.create_fixed("tw")       # twiddle is schedule here (fixed pos)
    ta = G.ext_witness(tf, "a")
    tb = G.ext_witness(tf, "b")
    tch = G.ext_witness(tf, "ch")
    tf.lk_record(FS.LK_AGG_CHAL, [tf_ccid] + tch.c)
    tfhead = [E.Const(RAM_CUSTOM), E.Const(TAG_TAIL), tf_oid]
    tf.read_record(tfhead + [tf_u, tf_i] + ta.c)
    tf.read_record(tfhead + [tf_u, tf_i + tf_half] + tb.c)
    tdd = ta.sub(tb)
    ttd = G.ExtWire(*[tdd.c[i] * tf_tw for i in range(4)])    # fixed: deg 2
    tctd = G.ext_mul(tf, "ctd", tch, ttd)
    tfolded = ta.add(tb).add(tctd).scale(_INV2)
    tout = G.ext_witness(tf, "out")
    G.ext_require_equal(tf, "fold", G.ExtWire(*tfolded.c), tout)
    tf.write_record(tfhead + [tf_u + 1, tf_i] + tout.c)
    tfold_compiled = compile_chip(tf)

    # -- tail ends: every final tail value == F(point) -------------------------
    te = CircuitBuilder("pcs_tail_ends")
    te_oid = te.create_fixed("oid")
    te_u = te.create_fixed("u")
    te_i = te.create_fixed("i")
    te_pc = te.create_fixed("pecid")
    tev = G.ext_witness(te, "v")
    pe_ = G.ext_witness(te, "pe")
    te.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_TAIL), te_oid, te_u,
                    te_i] + tev.c)
    te.lk_record(FS.LK_AGG_CHAL, [te_pc] + pe_.c)
    G.ext_require_equal(te, "const_tail", tev, pe_)
    tend_compiled = compile_chip(te)

    # -- batched-claim chain: one row per (opening, column) ---------------------
    bs = CircuitBuilder("pcs_bsum")
    bs_oid = bs.create_witin("oid")
    bs_j = bs.create_witin("j")
    bs_gcid = bs.create_fixed("gcid")
    bs_vcid = bs.create_fixed("vcid")
    bg = G.ext_witness(bs, "g")
    bv = G.ext_witness(bs, "v")
    bacc = G.ext_witness(bs, "acc")
    bs.lk_record(FS.LK_AGG_CHAL, [bs_gcid] + bg.c)
    bs.lk_record(FS.LK_AGG_CHAL, [bs_vcid] + bv.c)
    bgv = G.ext_mul(bs, "gv", bg, bv)
    bhead = [E.Const(RAM_CUSTOM), E.Const(TAG_BSUM), bs_oid]
    bs.read_record(bhead + [bs_j] + bacc.c)
    bs.write_record(bhead + [bs_j + 1] + bacc.add(bgv).c)
    bsum_compiled = compile_chip(bs)

    # -- batched-claim ends: one row per opening --------------------------------
    # Seeds the opening sumcheck with the batched claim, reads its reduced
    # claim back, and requires fc == eq(z, r) * F(point) (eq via the shared
    # bound eq1 chain; F(point) from the absorbed point-eval row).
    be = CircuitBuilder("pcs_bsum_ends")
    be_oid = be.create_witin("oid")
    be_sc = be.create_fixed("osc")      # opening sumcheck instance id
    be_nc = be.create_fixed("nc")       # chain length C
    be_nv = be.create_fixed("nv")       # sumcheck rounds
    be_pc = be.create_fixed("pecid")
    btot = G.ext_witness(be, "btot")
    bfc = G.ext_witness(be, "fc")
    beq = G.ext_witness(be, "eqv")
    bpe = G.ext_witness(be, "pe")
    behead = [E.Const(RAM_CUSTOM), E.Const(TAG_BSUM), be_oid]
    be.write_record(behead + [E.Const(0)] + zero4.c)
    be.read_record(behead + [be_nc] + btot.c)
    schead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), be_sc]
    be.write_record(schead + [E.Const(0)] + btot.c)
    be.read_record(schead + [be_nv] + bfc.c)
    eqhead = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), be_sc]
    be.write_record(eqhead + [E.Const(0)]
                    + G.ExtWire.constant(exth.one()).c)
    be.read_record(eqhead + [be_nv] + beq.c)
    be.lk_record(FS.LK_AGG_CHAL, [be_pc] + bpe.c)
    eqpe = G.ext_mul(be, "eqpe", beq, bpe)
    G.ext_require_equal(be, "recomb", bfc, eqpe)
    bsume_compiled = compile_chip(be)

    # -- const binder: pins an absorbed value to aggregation-key material ------
    nb_ = CircuitBuilder("pcs_const_bind")
    nb_cid = nb_.create_fixed("cid")
    nb_val = nb_.create_fixed("val")
    nb_d = nb_.create_witin("d")
    nb_.require_zero("d0", nb_d)
    nb_.lk_record(FS.LK_AGG_CHAL, [nb_cid, nb_val, E.Const(0), E.Const(0),
                                   E.Const(0)])
    cbind_compiled = compile_chip(nb_)

    return PcsVerifyChips(
        qb, qbit_compiled, ib, qidx_compiled, pb, peel_compiled,
        pow_cb, pow_compiled, cb, comb_compiled, ce, combe_compiled,
        qp, qpad_compiled, lb, leaf_compiled, le, leafe_compiled,
        ll, lleaf_compiled, rl, rootlk_compiled, rf, rootfx_compiled,
        tw, twid_compiled, fb, fold_compiled, qe, qend_compiled,
        ts, tsrc_compiled, tf, tfold_compiled, te, tend_compiled,
        bs, bsum_compiled, be, bsume_compiled, nb_, cbind_compiled,
        pow_bits,
    )


def _ext_wit_cols(w: G.ExtWire) -> list:
    """The E.Wit nodes of a raw ext_witness (components are bare wires)."""
    out = []
    for c in w.c:
        assert isinstance(c, E.Wit), "expected a bare witness ext wire"
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# Witgen: replay pcs/basefold.py::verify_batch on a ChainTranscript cursor,
# registering every absorb/challenge, and emit all chip witness matrices.
# ---------------------------------------------------------------------------


class _Rows:
    """Column-list accumulator for one chip (name -> list of values)."""

    def __init__(self):
        self.cols: dict = {}
        self.n = 0

    def add(self, **kv):
        for k, v in kv.items():
            self.cols.setdefault(k, []).append(v)
        self.n += 1

    def ext(self, name, v):
        self.cols.setdefault(name, []).append(np.asarray(v, np.uint64))

    def mat(self, cb: CircuitBuilder, fixed: bool = False) -> np.ndarray:
        names = cb.fixed_names if fixed else cb.wit_names
        out = np.zeros((len(names), self.n), np.uint64)
        for j, name in enumerate(names):
            vals = self.cols.get(name)
            if vals is None and name.endswith(("_0", "_1", "_2", "_3")):
                base, comp = name.rsplit("_", 1)
                stacked = self.cols.get("__ext_" + base)
                if stacked is None:
                    stacked = np.stack(self.cols[base]) if self.cols.get(base) \
                        else np.zeros((0, 4), np.uint64)
                    self.cols["__ext_" + base] = stacked
                out[j] = stacked[:, int(comp)] % _P if self.n else 0
                continue
            assert vals is not None, f"{cb.name}: missing column {name}"
            out[j] = np.asarray(vals, np.uint64) % _P
        return out


class PcsCollector:
    """Accumulates rows for every pcs chip across openings/proofs; one
    instance per aggregation. ``emit()`` yields the merged chip sets."""

    def __init__(self, chips: PcsVerifyChips):
        self.chips = chips
        names = ("qbit", "qidx", "peel", "pow", "comb", "combe", "qpad",
                 "leaf", "leafe", "lleaf", "rootlk", "rootfx", "twid",
                 "fold", "qend", "tsrc", "tfold", "tend", "bsum", "bsume",
                 "cbind", "mrows")
        self.w = {n: _Rows() for n in names}
        self.f = {n: _Rows() for n in names}
        self.qbit_mult: dict = {}   # (qid, i, b) -> count
        self.qbit_vals: dict = {}   # (qid, i) -> b
        self.next_qid = 0
        self.next_wid = 0
        self.next_tid = 0
        self.next_oid = 0

    # -- low-level helpers ----------------------------------------------------

    def use_bit(self, qid: int, i: int, b: int) -> int:
        self.qbit_vals[(qid, i)] = b
        self.qbit_mult[(qid, i)] = self.qbit_mult.get((qid, i), 0) + 1
        return b

    def emit(self, fs_pose_names_cache: dict | None = None):
        """Yield (name, compiled, cb, wit, fixed) for every non-empty chip."""
        ch = self.chips
        # qbit table rows from the multiplicity map
        for (qid, i), b in sorted(self.qbit_vals.items()):
            self.w["qbit"].add(b=b, mult=self.qbit_mult.get((qid, i), 0))
            self.f["qbit"].add(qid=qid, i=i)
        pairs = [
            ("pcs_qbits", "qbit", ch.qbit_compiled, ch.qbit_cb),
            ("pcs_qidx", "qidx", ch.qidx_compiled, ch.qidx_cb),
            ("pcs_peel", "peel", ch.peel_compiled, ch.peel_cb),
            ("pcs_pow", "pow", ch.pow_compiled, ch.pow_cb),
            ("pcs_comb", "comb", ch.comb_compiled, ch.comb_cb),
            ("pcs_comb_ends", "combe", ch.combe_compiled, ch.combe_cb),
            ("pcs_qpad", "qpad", ch.qpad_compiled, ch.qpad_cb),
            ("pcs_leaf", "leaf", ch.leaf_compiled, ch.leaf_cb),
            ("pcs_leaf_ends", "leafe", ch.leafe_compiled, ch.leafe_cb),
            ("pcs_lvl_leaf", "lleaf", ch.lleaf_compiled, ch.lleaf_cb),
            ("pcs_root_lk", "rootlk", ch.rootlk_compiled, ch.rootlk_cb),
            ("pcs_root_fx", "rootfx", ch.rootfx_compiled, ch.rootfx_cb),
            ("pcs_twid", "twid", ch.twid_compiled, ch.twid_cb),
            ("pcs_fold", "fold", ch.fold_compiled, ch.fold_cb),
            ("pcs_qend", "qend", ch.qend_compiled, ch.qend_cb),
            ("pcs_tail_src", "tsrc", ch.tsrc_compiled, ch.tsrc_cb),
            ("pcs_tail_fold", "tfold", ch.tfold_compiled, ch.tfold_cb),
            ("pcs_tail_ends", "tend", ch.tend_compiled, ch.tend_cb),
            ("pcs_bsum", "bsum", ch.bsum_compiled, ch.bsum_cb),
            ("pcs_bsum_ends", "bsume", ch.bsume_compiled, ch.bsume_cb),
            ("pcs_const_bind", "cbind", ch.cbind_compiled, ch.cbind_cb),
        ]
        out = []
        for name, key, compiled, cbn in pairs:
            if compiled is None:
                continue
            rows = self.w[key]
            if rows.n == 0:
                continue
            wit = rows.mat(cbn)
            fixed = self.f[key].mat(cbn, fixed=True) \
                if cbn.fixed_names else None
            out.append((name, compiled, cbn, wit, fixed))
        if self.w["mrows"].n:
            mcb, mcompiled = merkle_rows_chip()
            out.append(("pcs_merkle_rows", mcompiled, mcb,
                        self.w["mrows"].mat(mcb), None))
        return out


def assign_pcs_query_verify(
    col: PcsCollector,
    geo: PcsGeo,
    opening,                  # pcs/basefold.py OpeningProof
    v_evals: np.ndarray,      # (C, 4) the absorbed V_c(r) evals
    vcids: list,              # their absorbed-ext table cids
    z_cids: list,             # cids of the opening point's coords (len n_vars)
    z_vals: np.ndarray,       # (n_vars, 4) the point itself
    root_bind,                # ("lk", aidx, root8) | ("fixed", root8)
    transcript,               # ChainTranscript cursor at verify_batch start
    eqrows,                   # recursion._EqRowsCollector (bound eq chip)
    osc_id: int,              # SumcheckClaim instance id for this opening
):
    """Replay verify_batch (K = 1) on the cursor; returns sc_cols for the
    deg-2 rounds chip. All chip rows accumulate into ``col``."""
    from ..sumcheck.verifier import lagrange_extrapolate

    reg = transcript.registry
    ch = col.chips
    n_vars, C = geo.n_vars, geo.n_cols
    m, log_m = geo.m, geo.log_m
    T = geo.n_committed
    oid = col.next_oid
    col.next_oid += 1

    # 1. gamma powers (weights are gamma^c per column, claim order = columns)
    gcid0, gammas = transcript.sample_ext_pows_chal(C)
    batched = np.zeros(4, np.uint64)
    for c in range(C):
        batched = exth.add(batched, exth.mul(gammas[c], v_evals[c]))

    # bsum rows + ends
    accb = np.zeros(4, np.uint64)
    for c in range(C):
        reg.use(gcid0 + c)
        reg.use(vcids[c])
        col.w["bsum"].add(oid=oid, j=c)
        col.w["bsum"].ext("g", gammas[c])
        col.w["bsum"].ext("v", v_evals[c])
        col.w["bsum"].ext("acc", accb)
        col.w["bsum"].ext("gv", exth.mul(gammas[c], v_evals[c]))
        col.f["bsum"].add(gcid=gcid0 + c, vcid=vcids[c])
        accb = exth.add(accb, exth.mul(gammas[c], v_evals[c]))
    replay.check(np.array_equal(accb, batched))

    # 2. opening sumcheck manual replay with interleaved hook absorbs
    msgs = np.asarray(opening.sumcheck_msgs, np.uint64)
    sc_cols: dict = {
        "inst": np.full(n_vars, osc_id, np.uint64),
        "round": np.arange(n_vars, dtype=np.uint64),
    }
    aidxs = np.zeros(n_vars, np.uint64)
    acids = np.zeros(n_vars, np.uint64)
    chals = np.zeros((n_vars, 4), np.uint64)
    cins = np.zeros((n_vars, 4), np.uint64)
    cur = batched
    tail_cid0 = None
    root_cids = []           # [(cid_lo, cid_hi)] per committed level
    next_root = 0
    for rnd in range(n_vars):
        cins[rnd] = cur
        aidxs[rnd] = transcript.append_slots(msgs[rnd].ravel())
        acid, chv = transcript.sample_ext_chal()
        reg.use(acid)
        acids[rnd] = acid
        chals[rnd] = chv
        cur = lagrange_extrapolate(msgs[rnd], chv)
        new_m = m >> (rnd + 1)
        if tail_cid0 is None:
            if new_m <= geo.stop_size or rnd == n_vars - 1:
                tail = np.asarray(opening.tail, np.uint64)
                assert tail.shape == (1, 1 << geo.tail_log, 4)
                cids = [transcript.append_ext_chal(tail[0, i])
                        for i in range(tail.shape[1])]
                tail_cid0 = cids[0]
                assert cids == list(range(tail_cid0, tail_cid0 + len(cids)))
            else:
                root = np.asarray(opening.fold_roots[next_root], np.uint64)
                next_root += 1
                lo = transcript.append_ext_chal(root[:4])
                hi = transcript.append_ext_chal(root[4:])
                root_cids.append((lo, hi))
    assert next_root == T and len(opening.fold_roots) == T
    point = chals[::-1].copy()
    final_claim = cur
    sc_cols["aidx"] = aidxs
    sc_cols["acid"] = acids
    for kk in range(3):
        G.assign_ext(sc_cols, f"y{kk}", msgs[:, kk])
    G.assign_ext(sc_cols, "alpha", chals)
    G.assign_ext(sc_cols, "claim_in", cins)
    G.assign_lagrange(sc_cols, "lag", msgs, chals, 2)

    # 3. recombination eq(z, point) + point eval absorb
    pe = np.asarray(opening.point_evals[0], np.uint64)
    pecid = transcript.append_ext_chal(pe)
    reg.use(pecid)
    point_cids = [acids[n_vars - 1 - k] for k in range(n_vars)]
    eq_v = eqrows.chain(osc_id, z_vals, point,
                        z_cids=z_cids, r_cids=point_cids, reg=reg)
    replay.check(np.array_equal(exth.mul(eq_v, pe), final_claim),
                 "pcs witgen: opening recombination mismatch")
    col.w["bsume"].add(oid=oid)
    col.w["bsume"].ext("btot", batched)
    col.w["bsume"].ext("fc", final_claim)
    col.w["bsume"].ext("eqv", eq_v)
    col.w["bsume"].ext("pe", pe)
    col.w["bsume"].ext("eqpe", exth.mul(eq_v, pe))
    col.f["bsume"].add(osc=osc_id, nc=C, nv=n_vars, pecid=pecid)

    # 4. tail folds down to the constant F(point)
    inv2 = np.uint64(_INV2)
    tail = np.asarray(opening.tail, np.uint64)[0]       # (S, 4)
    for i in range(tail.shape[0]):
        reg.use(tail_cid0 + i)
        col.w["tsrc"].ext("v", tail[i])
        col.w["tsrc"].n += 1
        col.f["tsrc"].add(oid=oid, i=i, cid=tail_cid0 + i)
    cur_t = tail
    tl = geo.tail_log
    for u, t in enumerate(range(geo.tail_rounds, n_vars)):
        half = cur_t.shape[0] // 2
        invw = ntt.domain_pow_inv(tl)
        chv = chals[t]
        ccid = acids[t]
        a, b = cur_t[:half], cur_t[half:]
        s = exth.add(a, b)
        dd = exth.mul_base(exth.sub(a, b), invw)
        nxt = exth.mul_base(exth.add(s, exth.mul(dd, chv[None, :])), inv2)
        for i in range(half):
            reg.use(ccid)
            col.w["tfold"].ext("a", a[i])
            col.w["tfold"].ext("b", b[i])
            col.w["tfold"].ext("ch", chv)
            col.w["tfold"].ext("ctd", exth.mul(chv, dd[i]))
            col.w["tfold"].ext("out", nxt[i])
            col.w["tfold"].n += 1
            col.f["tfold"].add(oid=oid, u=u, i=i, half=half, chcid=ccid,
                               tw=int(invw[i]))
        cur_t = nxt
        tl -= 1
    n_tail_folds = geo.n_tail_folds
    for i in range(cur_t.shape[0]):
        replay.check(np.array_equal(cur_t[i], pe),
                     "tail does not fold to F(point)")
        reg.use(pecid)
        col.w["tend"].ext("v", cur_t[i])
        col.w["tend"].ext("pe", pe)
        col.w["tend"].n += 1
        col.f["tend"].add(oid=oid, u=n_tail_folds, i=i, pecid=pecid)

    # 5. PoW grinding
    if geo.pow_bits > 0:
        nonce = int(opening.pow_nonce) % bb.P
        nslot = transcript.absorb_slots_of_next(1)[0]
        transcript.append([nonce])
        transcript.claim_absorb(nslot)
        sidx, v = transcript.sample_base_slot()
        thr = bb.P >> geo.pow_bits
        replay.check(v < thr, "pow grinding check failed in pcs witgen")
        nb = max((thr - 1).bit_length(), 1)
        row = {"nonce": nonce, "v": v}
        cval = (thr - 1 - v) % bb.P
        for i in range(nb):
            row[f"vb{i}"] = (v >> i) & 1
            row[f"cb{i}"] = (cval >> i) & 1
        col.w["pow"].add(**row)
        col.f["pow"].add(nidx=nslot, sidx=sidx)

    # 6. queries
    half_m = m // 2
    invw_cache = {L: ntt.domain_pow_inv(L) for L in
                  range(log_m - T, log_m + 1)}
    for q in opening.queries:
        qid = col.next_qid
        col.next_qid += 1
        sidx, v = transcript.sample_base_slot()
        idx = v % half_m
        replay.check(idx == int(q.index),
                     "query index does not match transcript")

        # bit decomposition + canonicity row
        bits = [(v >> i) & 1 for i in range(N_BITS)]
        for i in range(N_BITS):
            col.use_bit(qid, i, bits[i])
        hi4 = (v >> 27) & 0xF
        d = (hi4 - 15) % bb.P
        inv_h = pow(d, bb.P - 2, bb.P) if d else 0
        f15 = 1 if hi4 == 15 else 0
        row = {"v": v, "inv_h": inv_h, "f15": f15}
        for i in range(N_BITS):
            row[f"b{i}"] = bits[i]
        col.w["qidx"].add(**row)
        frow = {"qid": qid, "sidx": sidx}
        for i in range(N_BITS):
            frow[f"mk{i}"] = 1 if i < log_m - 1 else 0
        col.f["qidx"].add(**frow)

        # index peel chain (steps 1..T)
        p_u = idx
        for u in range(T):
            e = log_m - u - 2
            b = (p_u >> e) & 1
            col.use_bit(qid, e, b)
            col.w["peel"].add(p=p_u, b=b)
            col.f["peel"].add(qid=qid, u=u, i=e, pw=1 << e)
            p_u -= b << e

        # base walks: gamma combination + leaf sponge + Merkle paths
        base_rows = np.asarray(q.base_rows, np.uint64)     # (C, 2)
        u0 = []
        for side in range(2):
            wid = col.next_wid
            col.next_wid += 1
            if side == 0:
                wid0 = wid
            acc = np.zeros(4, np.uint64)
            for j in range(C):
                vv = int(base_rows[j, side])
                col.w["comb"].add(wid=wid, j=j, v=vv)
                col.w["comb"].ext("g", gammas[j])
                col.w["comb"].ext("acc", acc)
                col.f["comb"].add(gcid=gcid0 + j)
                reg.use(gcid0 + j)
                acc = exth.add(acc, exth.mul_base(gammas[j], np.uint64(vv)))
            u0.append(acc)
            # zero padding for the sponge's last block
            for j in range(C, geo.n_blocks * p2.RATE):
                col.w["qpad"].add(d=0)
                col.f["qpad"].add(wid=wid, j=j)
            # sponge rows
            colvals = np.zeros(geo.n_blocks * p2.RATE, np.uint64)
            colvals[:C] = base_rows[:, side]
            states = np.zeros((geo.n_blocks, p2.WIDTH), np.uint64)
            st = np.zeros(p2.WIDTH, np.uint64)
            pre_states = []
            post_in = []
            for blk in range(geo.n_blocks):
                pre_states.append(st.copy())
                st = st.copy()
                st[:p2.RATE] = (st[:p2.RATE]
                                + colvals[blk * 8: blk * 8 + 8]) % _P
                post_in.append(st.copy())
                st = p2.permute_host(st)
            leaf_digest = st[:p2.DIGEST_ELEMS]
            up, wp, outs = assign_poseidon2(np.stack(post_in))
            pnames = [n for n in ch.leaf_cb.wit_names if n.startswith("p_")]
            pvals = [x for uw in zip(up, wp) for x in uw]
            for blk in range(geo.n_blocks):
                row = {"wid": wid, "blk": blk}
                for j in range(p2.WIDTH):
                    row[f"st{j}"] = pre_states[blk][j]
                for j in range(p2.RATE):
                    row[f"bv{j}"] = colvals[blk * 8 + j]
                for name, x in zip(pnames, pvals):
                    row[name] = x[blk]
                col.w["leaf"].add(**row)
            fin_state = outs[-1]
            lrow = {"qid": qid, "idx": idx}
            for j in range(p2.WIDTH):
                lrow[f"fin{j}"] = fin_state[j]
            col.w["leafe"].add(**lrow)
            col.f["leafe"].add(wid=wid, nb=geo.n_blocks, side=side,
                               half=half_m)
            # Merkle path rows up to the root
            _walk_rows(col, ch, wid, idx + side * half_m, leaf_digest,
                       np.asarray(q.base_paths[side], np.uint64))
            _root_row(col, reg, root_bind, wid, log_m)

        # seed the fold chain
        col.w["combe"].add(qid=qid, w0=wid0)
        col.w["combe"].ext("ua", u0[0])
        col.w["combe"].ext("ub", u0[1])
        col.f["combe"].add(nc=C)

        # committed-level folds
        pair = [u0[0], u0[1]]
        p_cur = idx
        for t in range(T + 1):
            cur_log = log_m - t
            nbits = cur_log - 1
            invw = invw_cache[cur_log]
            twv = int(invw[p_cur])
            ccid = acids[t]
            reg.use(ccid)
            tid = col.next_tid
            col.next_tid += 1
            # twiddle mux chain rows
            accw = 1
            base_c = [int(invw[1 << i]) for i in range(nbits)]
            for i in range(nbits):
                b = (p_cur >> i) & 1
                col.use_bit(qid, i, b)
                cc = base_c[i]
                fct = (1 + b * (cc - 1)) % bb.P
                col.w["twid"].add(tid=tid, i=i, b=b, f=fct, acc=accw,
                                  out=accw * fct % bb.P)
                col.f["twid"].add(qid=qid, bi=i, c=cc)
                accw = accw * fct % bb.P
            replay.check(accw == twv, "twiddle chain mismatch")
            a, b_ = pair
            dd = exth.mul_base(exth.sub(a, b_), np.uint64(twv))
            ctd = exth.mul(chals[t], dd)
            folded = exth.mul_base(
                exth.add(exth.add(a, b_), ctd), inv2)
            if t < T:
                rows_t = np.asarray(q.u_rows[t], np.uint64)   # (2, 1, 4)
                r0, r1 = rows_t[0, 0], rows_t[1, 0]
                mt = 1 << (cur_log - 1)
                slot_bit_pos = cur_log - 2
                slot = 0 if p_cur < mt // 2 else 1
                col.use_bit(qid, slot_bit_pos, slot)
                replay.check(np.array_equal(folded, rows_t[slot, 0]))
                col.w["fold"].add(qid=qid, tw=twv, slot=slot)
                col.w["fold"].ext("a", a)
                col.w["fold"].ext("b", b_)
                col.w["fold"].ext("ch", chals[t])
                col.w["fold"].ext("ctd", ctd)
                col.w["fold"].ext("r0", r0)
                col.w["fold"].ext("r1", r1)
                col.f["fold"].add(t=t, tid=tid, nbits=nbits, chcid=ccid,
                                  si=slot_bit_pos)
                # level-t leaves: sponge = one permutation over [v4, 0 x 12]
                for side in range(2):
                    wid = col.next_wid
                    col.next_wid += 1
                    vv = rows_t[side, 0]
                    st_in = np.zeros(p2.WIDTH, np.uint64)
                    st_in[:4] = vv
                    ul, wl, outl = assign_poseidon2(st_in[None])
                    digest = outl[0][: p2.DIGEST_ELEMS]
                    lrow = {"qid": qid, "p": p_cur % (mt // 2)}
                    lnames = [n for n in ch.lleaf_cb.wit_names
                              if n.startswith("p_")]
                    lvals = [x for uw in zip(ul, wl) for x in uw]
                    for name, x in zip(lnames, lvals):
                        lrow[name] = x[0]
                    col.w["lleaf"].add(**lrow)
                    col.w["lleaf"].ext("v", vv)
                    col.f["lleaf"].add(t=t, u=t + 1, wid=wid, side=side,
                                       half=mt // 2)
                    _walk_rows(col, ch, wid,
                               p_cur % (mt // 2) + side * (mt // 2),
                               digest, np.asarray(q.u_paths[t][side],
                                                  np.uint64))
                    _root_row(col, reg, ("lk", root_cids[t]), wid,
                              cur_log - 1)
                pair = [r0, r1]
                p_cur = p_cur % (mt // 2)
            else:
                # the last fold lands in the tail
                replay.check(np.array_equal(folded, tail[p_cur]))
                reg.use(tail_cid0 + p_cur)
                col.w["qend"].add(qid=qid, tw=twv, p=p_cur)
                col.w["qend"].ext("a", a)
                col.w["qend"].ext("b", b_)
                col.w["qend"].ext("ch", chals[t])
                col.w["qend"].ext("ctd", ctd)
                col.w["qend"].ext("tv", tail[p_cur])
                col.f["qend"].add(t=t, tid=tid, nbits=nbits, chcid=ccid,
                                  u=T, tc0=tail_cid0)
    return sc_cols


def _walk_rows(col: PcsCollector, ch: PcsVerifyChips, wid: int, index: int,
               leaf: np.ndarray, path: np.ndarray):
    """Merkle path rows (recursion.py rows-chip columns) for one walk."""
    depth = path.shape[0]
    d = np.asarray(leaf, np.uint64)
    ix = int(index)
    lws, rws = [], []
    rows_meta = []
    for lv in range(depth):
        bit = ix & 1
        sib = path[lv]
        l, r = (sib, d) if bit else (d, sib)
        rows_meta.append((lv, ix, ix >> 1, bit, d.copy(), sib.copy(),
                          l.copy(), r.copy()))
        d = p2.compress_host(l, r)
        ix >>= 1
    lw = np.stack([m[6] for m in rows_meta])
    rw = np.stack([m[7] for m in rows_meta])
    up, wp, _ = assign_poseidon2(np.concatenate([lw, rw], axis=1))
    pnames = _MROWS_PNAMES(col)
    pvals = [x for uw in zip(up, wp) for x in uw]
    for k, (lv, ixv, ixn, bit, cur, sib, l, r) in enumerate(rows_meta):
        row = {"qid": wid, "level": lv, "idx": ixv, "idx_next": ixn,
               "bit": bit}
        for j in range(8):
            row[f"cur{j}"] = cur[j]
            row[f"sib{j}"] = sib[j]
            row[f"l{j}"] = l[j]
            row[f"r{j}"] = r[j]
        for name, x in zip(pnames, pvals):
            row[name] = x[k]
        col.w["mrows"].add(**row)
    col._last_root = d
    return d


def _MROWS_PNAMES(col: PcsCollector):
    cb = _merkle_rows_cb()
    return [n for n in cb.wit_names if n.startswith("pc_")]


_MERKLE_ROWS: list = []


def _merkle_rows_cb():
    if not _MERKLE_ROWS:
        from .recursion import build_merkle_path_chips

        chips = build_merkle_path_chips(1)
        _MERKLE_ROWS.append((chips.rows_cb, chips.rows_compiled))
    return _MERKLE_ROWS[0][0]


def merkle_rows_chip():
    _merkle_rows_cb()
    return _MERKLE_ROWS[0]


def _root_row(col: PcsCollector, reg, bind, wid: int, depth: int):
    """``bind``: ("lk", (cid_lo, cid_hi)) — walk root looked up against the
    absorbed commitment/fold root rows; ("fixed", root8) — root pinned to
    aggregation-key constants (the vk's fixed-column commitment)."""
    root = col._last_root
    if bind[0] == "lk":
        cids = bind[1]
        reg.use(cids[0])
        reg.use(cids[1])
        col.w["rootlk"].add(**{f"r{j}": int(root[j]) for j in range(8)})
        col.f["rootlk"].add(wid=wid, depth=depth, rcid0=cids[0],
                            rcid1=cids[1])
    else:
        expect = np.asarray(bind[1], np.uint64)
        replay.check(np.array_equal(root, expect),
                     "walk root != key-fixed root")
        col.w["rootfx"].add(d=0)
        # the fixed row carries the KEY-side root (``expect``), never the
        # recomputed walk value: fixed columns are aggregation-key material
        # and must be a function of (vk, geometry) alone — in structure
        # replay the walk value is garbage while ``expect`` is the real
        # vk fixed-commitment root
        frow = {"wid": wid, "depth": depth}
        for j in range(8):
            frow[f"rv{j}"] = int(expect[j])
        col.f["rootfx"].add(**frow)
