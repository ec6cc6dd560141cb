"""Record-claim -> batched-claim link in-circuit (RECURSION.md #6, the
`_slot_multipliers` arithmetic — VERDICT round-3 missing #2).

Role mirror of the reference recursion's main-constraint batching tables
(ceno_recursion_v2/src/main/ + batch_constraint/): everything between a
tower's final record claims and the class-batched main sumcheck's input
claim is re-proven as chips, eliminating the last free witness wires of the
aggregation:

  * the TOWER ENDS chip (recursion.py, bind mode) now PUBLISHES each final
    record claim on the bus: (RecClaim, group, spec_j, claim);
  * BATCH-LINK rows accumulate  bc_i = sum_cat alpha_cat * (claim_cat - sub)
    per chip (sub = 1 for prod/logup-q, sel_v * w_chip for logup-p), the
    alphas being `_slot_multipliers`' pow-chain samples; the chain end is
    written to (BC, cidx) which the class-main CHIP row now READS instead
    of witnessing bc freely;
  * MULT rows derive every slot multiplier alpha_cat * eq(b*, bits(rec))
    (eq chains over the shared bound eq1-rows chip; b* coordinates are the
    tower's transcript challenges) and write (Mult, sid) which the SLOT row
    now reads;
  * SEL-V / W-CHIP chains re-prove sel_prefix_sum(x*, k) and the logup
    shift sum; SEL-EQ chains re-prove sel_eq_eval(x*, point, k) (masked eq
    recombination — a descending prefix pass whose per-bit terms feed an
    ascending pass) and write (Seq, cidx) which the CHIP row reads;
  * SCALAR-EVAL chips evaluate every distinct slot-term scalar expression
    (a DAG over Const / Challenge / ChallengePow / Instance / Sum / Prod /
    Neg nodes) once per proof — leaves ride the existing challenge / pow /
    const tables, interior nodes are bus-chained sum/product rows whose
    results are PUBLISHED on the lookup table; the TERM row now binds its
    scalar wire by cid.

All geometry (claim indices, chain lengths, instance-count bits, cids)
lives in FIXED schedule columns committed by the aggregation key; the
instance counts themselves are bound to the transcript by the absorbed-
num_instances const-bind rows (pcs_verify.py), so `k`-dependent schedules
are transcript-consistent.

Copy of ``ceno_tpu/gkr/claim_link.py``, in host numpy.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..mle import expression as E
from . import fs_chain as FS
from . import gadgets as G
from .chip import compile_chip, interleave_geometry
from .circuit_builder import CircuitBuilder, RAM_CUSTOM
from .recursion import (
    TAG_EQ_CHAIN, TAG_REC_CLAIM, TAG_BC, TAG_MULT, TAG_SEQ,
)
from ..utils import replay

_P = np.uint64(bb.P)

TAG_BCHAIN = 29      # (cidx, j, acc4): batched-claim accumulation chain
TAG_SVW = 31         # (cidx, v4): sel_v * w_chip (logup-p subtrahend)
TAG_SELV = 32        # (cidx, step, res4, pre4): sel_prefix_sum chain
TAG_SELV_OUT = 33    # (cidx, v4)
TAG_WCHIP = 34       # (cidx, i, acc4): sum of the first n_lk eq entries
TAG_SEQD = 37        # (cidx, step, pre4): masked-eq descending prefix
TAG_SEQT = 38        # (cidx, j, c4): per-set-bit term coefficient
TAG_SEQA = 39        # (cidx, step, low4 res4): masked-eq ascending pass
TAG_SCHAIN = 40      # (nid, j, acc4): scalar sum/prod evaluation chains

SLOT_EQ_BASE = 1 << 28       # eq-chain cid namespaces (see aggregate.py)
WCHIP_EQ_BASE = (1 << 28) + (1 << 26)
SEQ_EQ_BASE = (1 << 28) + (1 << 27)


class ClaimLinkChips:
    """Generic chip set (built once per aggregation, bind-only)."""

    def __init__(self):
        one = G.ExtWire.constant(exth.one())
        zero = G.ExtWire.constant(np.zeros(4, np.uint64))

        # -- scalar sum rows --------------------------------------------------
        sb = CircuitBuilder("cl_sx_sum")
        nid = sb.create_witin("nid")
        j = sb.create_witin("j")
        ccid = sb.create_fixed("ccid")
        sgn = sb.create_fixed("sgn")     # +1 or P-1
        c = G.ext_witness(sb, "c")
        acc = G.ext_witness(sb, "acc")
        sb.lk_record(FS.LK_AGG_CHAL, [ccid] + c.c)
        head = [E.Const(RAM_CUSTOM), E.Const(TAG_SCHAIN), nid]
        sb.read_record(head + [j] + acc.c)
        out = G.ExtWire(*[acc.c[i] + c.c[i] * sgn for i in range(4)])
        sb.write_record(head + [j + 1] + out.c)
        self.sxs_cb, self.sxs = sb, compile_chip(sb)

        # -- scalar prod rows -------------------------------------------------
        pb = CircuitBuilder("cl_sx_prod")
        pnid = pb.create_witin("nid")
        pj = pb.create_witin("j")
        pccid = pb.create_fixed("ccid")
        pc = G.ext_witness(pb, "c")
        pacc = G.ext_witness(pb, "acc")
        pb.lk_record(FS.LK_AGG_CHAL, [pccid] + pc.c)
        pout = G.ext_mul(pb, "out", pacc, pc)
        phead = [E.Const(RAM_CUSTOM), E.Const(TAG_SCHAIN), pnid]
        pb.read_record(phead + [pj] + pacc.c)
        pb.write_record(phead + [pj + 1] + pout.c)
        self.sxp_cb, self.sxp = pb, compile_chip(pb)

        # -- scalar publish row (one per interior node) -----------------------
        ub = CircuitBuilder("cl_sx_pub")
        unid = ub.create_witin("nid")
        ucid = ub.create_fixed("cid")
        unf = ub.create_fixed("nf")      # chain length (fan-in)
        ust = [ub.create_fixed(f"st{i}") for i in range(4)]  # 0 (sum) / 1 (prod)
        umult = ub.create_witin("mult")
        tot = G.ext_witness(ub, "tot")
        uhead = [E.Const(RAM_CUSTOM), E.Const(TAG_SCHAIN), unid]
        ub.write_record(uhead + [E.Const(0)] + list(ust))
        ub.read_record(uhead + [unf] + tot.c)
        ub.lk_table_record(FS.LK_AGG_CHAL, umult, [ucid] + tot.c)
        self.sxu_cb, self.sxu = ub, compile_chip(ub)

        # -- batch-link rows (sub == 1) ---------------------------------------
        def _bl(name, with_svw):
            cb = CircuitBuilder(name)
            cidx = cb.create_witin("cidx")
            bj = cb.create_witin("j")
            grp = cb.create_fixed("grp")
            sj = cb.create_fixed("sj")
            acid = cb.create_fixed("acid")
            rc = G.ext_witness(cb, "rc")
            al = G.ext_witness(cb, "al")
            bacc = G.ext_witness(cb, "acc")
            cb.lk_record(FS.LK_AGG_CHAL, [acid] + al.c)
            cb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_REC_CLAIM),
                            grp, sj] + rc.c)
            if with_svw:
                sub = G.ext_witness(cb, "sub")
                cb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SVW), cidx]
                               + sub.c)
                diff = rc.sub(sub)
            else:
                diff = rc.sub(one)
            t = G.ext_mul(cb, "t", al, G.ExtWire(*diff.c))
            bh = [E.Const(RAM_CUSTOM), E.Const(TAG_BCHAIN), cidx]
            cb.read_record(bh + [bj] + bacc.c)
            cb.write_record(bh + [bj + 1] + bacc.add(t).c)
            return cb, compile_chip(cb)

        self.blc_cb, self.blc = _bl("cl_bl_const", False)
        self.blp_cb, self.blp = _bl("cl_bl_p", True)

        # -- batch-link ends --------------------------------------------------
        eb = CircuitBuilder("cl_bl_ends")
        ecidx = eb.create_witin("cidx")
        encat = eb.create_fixed("ncat")
        ebc = G.ext_witness(eb, "bc")
        bh = [E.Const(RAM_CUSTOM), E.Const(TAG_BCHAIN), ecidx]
        eb.write_record(bh + [E.Const(0)] + zero.c)
        eb.read_record(bh + [encat] + ebc.c)
        eb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_BC), ecidx] + ebc.c)
        self.ble_cb, self.ble = eb, compile_chip(eb)

        # -- w-chip sum rows (one per (chip, lookup record)) -------------------
        wb = CircuitBuilder("cl_wchip")
        wcidx = wb.create_witin("cidx")
        wi = wb.create_witin("i")
        weqc = wb.create_fixed("eqcid")
        wrho = wb.create_fixed("rho")
        w = G.ext_witness(wb, "w")
        wacc = G.ext_witness(wb, "acc")
        eqh = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), weqc]
        wb.write_record(eqh + [E.Const(0)] + one.c)
        wb.read_record(eqh + [wrho] + w.c)
        wh = [E.Const(RAM_CUSTOM), E.Const(TAG_WCHIP), wcidx]
        wb.read_record(wh + [wi] + wacc.c)
        wb.write_record(wh + [wi + 1] + wacc.add(w).c)
        self.wch_cb, self.wch = wb, compile_chip(wb)

        # -- sel_v chain rows -------------------------------------------------
        vb = CircuitBuilder("cl_selv")
        vcidx = vb.create_witin("cidx")
        vstep = vb.create_witin("step")
        vpcid = vb.create_fixed("pcid")
        vkb = vb.create_fixed("kb")      # bit of k at this position
        p_ = G.ext_witness(vb, "p")
        vres = G.ext_witness(vb, "res")
        vpre = G.ext_witness(vb, "pre")
        vb.lk_record(FS.LK_AGG_CHAL, [vpcid] + p_.c)
        pp = G.ext_mul(vb, "pp", vpre, p_)
        res_n = G.ExtWire(*[
            vres.c[i] + vkb * (vpre.c[i] - pp.c[i]) for i in range(4)
        ])
        pre_n = G.ExtWire(*[
            vpre.c[i] - pp.c[i] + vkb * (pp.c[i] * 2 - vpre.c[i])
            for i in range(4)
        ])
        vh = [E.Const(RAM_CUSTOM), E.Const(TAG_SELV), vcidx]
        vb.read_record(vh + [vstep] + vres.c + vpre.c)
        vb.write_record(vh + [vstep + 1] + res_n.c + pre_n.c)
        self.slv_cb, self.slv = vb, compile_chip(vb)

        # -- sel_v ends -------------------------------------------------------
        veb = CircuitBuilder("cl_selv_ends")
        vecidx = veb.create_witin("cidx")
        ven = veb.create_fixed("n")
        veres = G.ext_witness(veb, "res")
        vepre = G.ext_witness(veb, "pre")
        vh = [E.Const(RAM_CUSTOM), E.Const(TAG_SELV), vecidx]
        veb.write_record(vh + [E.Const(0)] + zero.c + one.c)
        veb.read_record(vh + [ven] + veres.c + vepre.c)
        veb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_SELV_OUT), vecidx]
                         + veres.c)
        self.sle_cb, self.sle = veb, compile_chip(veb)

        # -- svw rows (the logup-p subtrahend) --------------------------------
        def _svw(name, full):
            cb = CircuitBuilder(name)
            cidx = cb.create_witin("cidx")
            nlk = cb.create_fixed("nlk")
            wch = G.ext_witness(cb, "wch")
            wh = [E.Const(RAM_CUSTOM), E.Const(TAG_WCHIP), cidx]
            cb.write_record(wh + [E.Const(0)] + zero.c)
            cb.read_record(wh + [nlk] + wch.c)
            if full:
                outw = wch
            else:
                sv = G.ext_witness(cb, "sv")
                cb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SELV_OUT),
                                cidx] + sv.c)
                outw = G.ext_mul(cb, "svw", sv, wch)
            cb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_SVW), cidx]
                            + outw.c)
            return cb, compile_chip(cb)

        self.svf_cb, self.svf = _svw("cl_svw_full", True)
        self.svp_cb, self.svp = _svw("cl_svw_partial", False)

        # -- slot multiplier rows ---------------------------------------------
        mb = CircuitBuilder("cl_mult_rec")
        msid = mb.create_witin("sid")
        meqc = mb.create_fixed("eqcid")
        mrho = mb.create_fixed("rho")
        macid = mb.create_fixed("acid")
        mw = G.ext_witness(mb, "w")
        mal = G.ext_witness(mb, "al")
        mb.lk_record(FS.LK_AGG_CHAL, [macid] + mal.c)
        eqh = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), meqc]
        mb.write_record(eqh + [E.Const(0)] + one.c)
        mb.read_record(eqh + [mrho] + mw.c)
        mm = G.ext_mul(mb, "m", mal, mw)
        mb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_MULT), msid] + mm.c)
        self.mtr_cb, self.mtr = mb, compile_chip(mb)

        zb = CircuitBuilder("cl_mult_zero")
        zsid = zb.create_witin("sid")
        zacid = zb.create_fixed("acid")
        zal = G.ext_witness(zb, "al")
        zb.lk_record(FS.LK_AGG_CHAL, [zacid] + zal.c)
        zb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_MULT), zsid] + zal.c)
        self.mtz_cb, self.mtz = zb, compile_chip(zb)

        # -- sel-eq (full): s_eq = eq(x*, point) ------------------------------
        fb = CircuitBuilder("cl_seq_full")
        fcidx = fb.create_witin("cidx")
        feqc = fb.create_fixed("eqcid")
        fn = fb.create_fixed("n")
        fv = G.ext_witness(fb, "v")
        eqh = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), feqc]
        fb.write_record(eqh + [E.Const(0)] + one.c)
        fb.read_record(eqh + [fn] + fv.c)
        fb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQ), fcidx] + fv.c)
        self.sqf_cb, self.sqf = fb, compile_chip(fb)

        # -- sel-eq (masked) descending prefix rows ---------------------------
        # step s walks bit j = n-1-s; set rows also emit the term coefficient
        def _seqd(name, setbit):
            cb = CircuitBuilder(name)
            cidx = cb.create_witin("cidx")
            st = cb.create_witin("step")
            jf = cb.create_fixed("jbit")
            rcid = cb.create_fixed("rtcid")
            pcid = cb.create_fixed("ptcid")
            rt = G.ext_witness(cb, "rt")
            pt = G.ext_witness(cb, "pt")
            pre = G.ext_witness(cb, "pre")
            cb.lk_record(FS.LK_AGG_CHAL, [rcid] + rt.c)
            cb.lk_record(FS.LK_AGG_CHAL, [pcid] + pt.c)
            rp = G.ext_mul(cb, "rp", rt, pt)
            b0 = one.sub(rt).sub(pt).add(rp)         # (1-rt)(1-pt)
            dh = [E.Const(RAM_CUSTOM), E.Const(TAG_SEQD), cidx]
            cb.read_record(dh + [st] + pre.c)
            if setbit:
                cterm = G.ext_mul(cb, "ct", pre, G.ExtWire(*b0.c))
                cb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQT),
                                 cidx, jf] + cterm.c)
                nxt = G.ext_mul(cb, "nx", pre, rp)   # pre * b1
            else:
                nxt = G.ext_mul(cb, "nx", pre, G.ExtWire(*b0.c))
            cb.write_record(dh + [st + 1] + nxt.c)
            return cb, compile_chip(cb)

        self.sqd1_cb, self.sqd1 = _seqd("cl_seqd_set", True)
        self.sqd0_cb, self.sqd0 = _seqd("cl_seqd_unset", False)

        # -- sel-eq (masked) ascending rows -----------------------------------
        def _seqa(name, setbit):
            cb = CircuitBuilder(name)
            cidx = cb.create_witin("cidx")
            st = cb.create_witin("step")
            jf = cb.create_fixed("jbit")
            rcid = cb.create_fixed("rtcid")
            pcid = cb.create_fixed("ptcid")
            rt = G.ext_witness(cb, "rt")
            pt = G.ext_witness(cb, "pt")
            low = G.ext_witness(cb, "low")
            res = G.ext_witness(cb, "res")
            cb.lk_record(FS.LK_AGG_CHAL, [rcid] + rt.c)
            cb.lk_record(FS.LK_AGG_CHAL, [pcid] + pt.c)
            rp = G.ext_mul(cb, "rp", rt, pt)
            aj = one.sub(rt).sub(pt).add(rp).add(rp)  # eq1 factor
            ah = [E.Const(RAM_CUSTOM), E.Const(TAG_SEQA), cidx]
            cb.read_record(ah + [st] + low.c + res.c)
            low_n = G.ext_mul(cb, "ln", low, G.ExtWire(*aj.c))
            if setbit:
                ct = G.ext_witness(cb, "ct")
                cb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQT),
                                cidx, jf] + ct.c)
                cl_ = G.ext_mul(cb, "cl", ct, low)
                res_n = res.add(cl_)
            else:
                res_n = res
            cb.write_record(ah + [st + 1] + low_n.c
                            + G.ExtWire(*res_n.c).c)
            return cb, compile_chip(cb)

        self.sqa1_cb, self.sqa1 = _seqa("cl_seqa_set", True)
        self.sqa0_cb, self.sqa0 = _seqa("cl_seqa_unset", False)

        # -- sel-eq (masked) ends ---------------------------------------------
        qb = CircuitBuilder("cl_seq_ends")
        qcidx = qb.create_witin("cidx")
        qn = qb.create_fixed("n")
        qpre = G.ext_witness(qb, "pre")
        qlow = G.ext_witness(qb, "low")
        qres = G.ext_witness(qb, "res")
        dh = [E.Const(RAM_CUSTOM), E.Const(TAG_SEQD), qcidx]
        qb.write_record(dh + [E.Const(0)] + one.c)
        qb.read_record(dh + [qn] + qpre.c)
        ah = [E.Const(RAM_CUSTOM), E.Const(TAG_SEQA), qcidx]
        qb.write_record(ah + [E.Const(0)] + one.c + zero.c)
        qb.read_record(ah + [qn] + qlow.c + qres.c)
        qb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQ), qcidx]
                        + qres.c)
        self.sqe_cb, self.sqe = qb, compile_chip(qb)


def build_pv_scalar_chip(entries: list):
    """Per-aggregation chip publishing the scalar Instance leaves: one row,
    one lk-table record per (cid, agg-pv index) entry, each with its own
    multiplicity wire. The VALUE is the aggregation public value itself."""
    cb = CircuitBuilder("cl_pv_leaves")
    for i, (cid, pv_idx) in enumerate(entries):
        m = cb.create_witin(f"m{i}")
        cb.lk_table_record(FS.LK_AGG_CHAL, m, [
            E.Const(int(cid)), E.Instance(int(pv_idx)),
            E.Const(0), E.Const(0), E.Const(0),
        ])
    if not entries:
        d = cb.create_witin("d")
        cb.require_zero("d0", d)
    return cb, compile_chip(cb)


# ---------------------------------------------------------------------------
# Witgen
# ---------------------------------------------------------------------------


class _Rows:
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
                if self.n:
                    out[j] = stacked[:, int(comp)] % _P
                continue
            assert vals is not None, f"{cb.name}: missing column {name}"
            out[j] = np.asarray(vals, np.uint64) % _P
        return out


class ScalarRegistry:
    """Evaluates + registers every distinct slot-term scalar of one proof.

    Leaves ride the existing tables (const / challenge / pow / pv-leaf);
    interior Sum/Prod nodes become bus-chained rows published on the lookup
    table. ``cid_of(expr)`` returns the node's table cid, allocating and
    emitting rows on first sight (structural dedup)."""

    def __init__(self, reg, chal_cids, challenges, instances, pv_map,
                 nid_base: int = 0):
        self.reg = reg
        self.chal_cids = list(chal_cids)      # base cids of alpha, beta
        self.challenges = np.asarray(challenges, np.uint64)
        self.instances = instances            # shard pv (base values)
        self.pv_map = pv_map                  # shard pv idx -> agg pv idx
        self.pow_chains = {}                  # chal idx -> [(cid0, n)]
        self.memo = {}                        # canonical key -> (cid, val4)
        self.idmemo = {}                      # id(expr) -> canonical key
        self.pv_entries = []                  # (cid, agg_pv_idx) leaf rows
        self.pv_memo = {}
        self.sum_rows = _Rows()
        self.prod_rows = _Rows()
        self.pub_rows = _Rows()
        self.pub_fixed = _Rows()
        self.pub_cids = []                    # publish-row cids (mult fill)
        self.next_nid = nid_base

    # -- canonical structural key -------------------------------------------

    def _key(self, e):
        k = id(e)
        if k in self.idmemo:
            return self.idmemo[k]
        if isinstance(e, E.Const):
            r = ("c", int(e.value) % bb.P)
        elif isinstance(e, E.ExtConst):
            r = ("x", tuple(int(v) for v in e.value))
        elif isinstance(e, E.Challenge):
            r = ("ch", e.cid)
        elif isinstance(e, E.ChallengePow):
            r = ("cp", e.cid, e.power)
        elif isinstance(e, E.Instance):
            r = ("i", e.idx)
        elif isinstance(e, E.Neg):
            r = ("n", self._key(e.inner))
        elif isinstance(e, E.Sum):
            r = ("s", tuple(sorted(self._key(t) for t in e.terms)))
        elif isinstance(e, E.Prod):
            r = ("p", tuple(sorted(self._key(f) for f in e.factors)))
        else:
            raise TypeError(f"unsupported scalar node {type(e).__name__}")
        self.idmemo[k] = r
        return r

    def _pow_cid(self, c: int, k: int) -> int:
        for cid0, n in self.pow_chains.get(c, []):
            if k < n:
                return cid0 + k
        n = max(2 * k + 2, 128)
        cid0 = self.reg.register_pow_chain(
            self.chal_cids[c], self.challenges[c], n)
        self.pow_chains.setdefault(c, []).append((cid0, n))
        return cid0 + k

    def cid_of(self, expr) -> int:
        cid, _v = self._node(expr)
        return cid

    def pv_cid(self, idx: int) -> int:
        """Lookup-table cid of the pv leaf at SHARD pv index ``idx``.
        Callers with TEMPORARY Instance objects must use this instead of
        cid_of: the structural memo is id()-keyed and assumes persistent
        expression objects (the compiled chips' scalars)."""
        return self.pv_node(idx)[0]

    def pv_node(self, idx: int):
        agg_idx = self.pv_map(idx)
        hit = self.pv_memo.get(agg_idx)
        if hit is not None:
            return hit
        cid = self.reg.alloc_cid()
        self.pv_entries.append((cid, agg_idx))
        v = exth.from_base(np.uint64(int(self.instances[idx]) % bb.P))
        self.pv_memo[agg_idx] = (cid, v)
        return cid, v

    def value_of(self, expr) -> np.ndarray:
        _c, v = self._node(expr)
        return v

    def _node(self, e):
        key = self._key(e)
        hit = self.memo.get(key)
        if hit is not None:
            return hit
        out = self._build(e, key)
        self.memo[key] = out
        return out

    def _build(self, e, key):
        reg = self.reg
        if isinstance(e, E.Const):
            v = exth.from_base(np.uint64(int(e.value) % bb.P))
            return reg.const_cid(v), v
        if isinstance(e, E.ExtConst):
            v = np.asarray(e.value, np.uint64)
            return reg.const_cid(v), v
        if isinstance(e, E.Challenge):
            return self.chal_cids[e.cid], self.challenges[e.cid].copy()
        if isinstance(e, E.ChallengePow):
            v = exth.pow_int(self.challenges[e.cid], e.power)
            return self._pow_cid(e.cid, e.power), v
        if isinstance(e, E.Instance):
            return self.pv_node(e.idx)
        if isinstance(e, E.Neg):
            children = [(bb.P - 1, e.inner)]
            return self._chain(children, prod=False)
        if isinstance(e, E.Sum):
            children = []
            for t in e.terms:
                if isinstance(t, E.Neg):
                    children.append((bb.P - 1, t.inner))
                else:
                    children.append((1, t))
            return self._chain(children, prod=False)
        if isinstance(e, E.Prod):
            return self._chain([(1, f) for f in e.factors], prod=True)
        raise TypeError(type(e).__name__)

    def _chain(self, children, prod: bool):
        reg = self.reg
        nid = self.next_nid
        self.next_nid += 1
        acc = exth.one() if prod else np.zeros(4, np.uint64)
        rows = self.prod_rows if prod else self.sum_rows
        for j, (sgn, child) in enumerate(children):
            ccid, cv = self._node(child)
            reg.use(ccid)
            if prod:
                rows.add(nid=nid, j=j)
                rows.ext("c", cv)
                rows.ext("acc", acc)
                nxt = exth.mul(acc, cv)
                rows.ext("out", nxt)
                self.prod_fixed_ccid(ccid)
            else:
                rows.add(nid=nid, j=j)
                rows.ext("c", cv)
                rows.ext("acc", acc)
                nxt = (acc + cv * np.uint64(sgn)) % _P
                self.sum_fixed(ccid, sgn)
            acc = nxt
        cid = reg.alloc_cid()
        self.pub_rows.add(nid=nid)
        self.pub_rows.ext("tot", acc)
        st = exth.one() if prod else np.zeros(4, np.uint64)
        self.pub_fixed.add(cid=cid, nf=len(children),
                           **{f"st{i}": int(st[i]) for i in range(4)})
        self.pub_cids.append(cid)
        return cid, acc

    # fixed-column side tables (separate _Rows so wit/fixed stay aligned)
    def sum_fixed(self, ccid, sgn):
        self.sum_rows.cols.setdefault("__f_ccid", []).append(ccid)
        self.sum_rows.cols.setdefault("__f_sgn", []).append(sgn)

    def prod_fixed_ccid(self, ccid):
        self.prod_rows.cols.setdefault("__f_ccid", []).append(ccid)

    def emit(self, chips: ClaimLinkChips):
        out = []
        if self.sum_rows.n:
            wit = self.sum_rows.mat(chips.sxs_cb)
            fixed = np.array([self.sum_rows.cols["__f_ccid"],
                              self.sum_rows.cols["__f_sgn"]], np.uint64)
            out.append(("cl_sx_sum", chips.sxs, chips.sxs_cb, wit, fixed))
        if self.prod_rows.n:
            wit = self.prod_rows.mat(chips.sxp_cb)
            fixed = np.array([self.prod_rows.cols["__f_ccid"]], np.uint64)
            out.append(("cl_sx_prod", chips.sxp, chips.sxp_cb, wit, fixed))
        if self.pub_rows.n:
            self.pub_rows.cols["mult"] = [
                self.reg.chal_mult.get(c, 0) for c in self.pub_cids
            ]
            wit = self.pub_rows.mat(chips.sxu_cb)
            fixed = self.pub_fixed.mat(chips.sxu_cb, fixed=True)
            out.append(("cl_sx_pub", chips.sxu, chips.sxu_cb, wit, fixed))
        if self.pv_entries:
            cb, compiled = build_pv_scalar_chip(self.pv_entries)
            # one ROW; one mult witness column per instance leaf
            wit = np.array([[self.reg.chal_mult.get(cid, 0)]
                            for cid, _ in self.pv_entries], np.uint64)
            out.append(("cl_pv_leaves", compiled, cb, wit, None))
        return out


class LinkInfo:
    """Per-chip data stashed between the tower and class-main stages."""

    __slots__ = ("group", "alcid0", "alphas", "n_alpha", "zero_base",
                 "cat_list", "x_star", "b_star", "x_cids", "b_cids",
                 "compiled", "k", "n_vars", "claims")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class ClaimLinkCollector:
    """Accumulates link rows across all proofs of one aggregation."""

    def __init__(self, chips: ClaimLinkChips):
        self.chips = chips
        names = ("blc", "blp", "ble", "wch", "slv", "sle", "svf", "svp",
                 "mtr", "mtz", "sqf", "sqd1", "sqd0", "sqa1", "sqa0", "sqe")
        self.w = {n: _Rows() for n in names}
        self.f = {n: _Rows() for n in names}
        self.info: dict = {}        # id(vctx) -> LinkInfo
        self.next_slot_eq = 0
        self.next_wchip_eq = 0
        self.next_seq_eq = 0

    def emit(self):
        ch = self.chips
        pairs = [
            ("cl_bl_const", "blc", ch.blc, ch.blc_cb),
            ("cl_bl_p", "blp", ch.blp, ch.blp_cb),
            ("cl_bl_ends", "ble", ch.ble, ch.ble_cb),
            ("cl_wchip", "wch", ch.wch, ch.wch_cb),
            ("cl_selv", "slv", ch.slv, ch.slv_cb),
            ("cl_selv_ends", "sle", ch.sle, ch.sle_cb),
            ("cl_svw_full", "svf", ch.svf, ch.svf_cb),
            ("cl_svw_partial", "svp", ch.svp, ch.svp_cb),
            ("cl_mult_rec", "mtr", ch.mtr, ch.mtr_cb),
            ("cl_mult_zero", "mtz", ch.mtz, ch.mtz_cb),
            ("cl_seq_full", "sqf", ch.sqf, ch.sqf_cb),
            ("cl_seqd_set", "sqd1", ch.sqd1, ch.sqd1_cb),
            ("cl_seqd_unset", "sqd0", ch.sqd0, ch.sqd0_cb),
            ("cl_seqa_set", "sqa1", ch.sqa1, ch.sqa1_cb),
            ("cl_seqa_unset", "sqa0", ch.sqa0, ch.sqa0_cb),
            ("cl_seq_ends", "sqe", ch.sqe, ch.sqe_cb),
        ]
        out = []
        for name, key, compiled, cbn in pairs:
            rows = self.w[key]
            if rows.n == 0:
                continue
            wit = rows.mat(cbn)
            fixed = self.f[key].mat(cbn, fixed=True) \
                if cbn.fixed_names else None
            out.append((name, compiled, cbn, wit, fixed))
        return out


def link_tower_group(col: ClaimLinkCollector, transcript, entries,
                     record_claims, rt_vals, rt_cids, group_idx, vctxs):
    """Replay the per-chip `_slot_multipliers` alpha samples right after a
    group tower verification (the cursor sits exactly there) and stash each
    chip's link inputs keyed by its verify context identity."""
    reg = transcript.registry
    pi = li = 0
    s_p = sum(1 for (c, _, _) in entries for _ in range(
        (1 if c.r_exprs else 0) + (1 if c.w_exprs else 0)))
    claims = np.asarray(record_claims, np.uint64)[0]  # (n_claims, 4)
    for (compiled, k, n_vars), vctx in zip(entries, vctxs):
        rho, r_r, r_w, r_l = interleave_geometry(compiled)
        n_zero = sum(1 for s in compiled.slots if s.kind == "zero")
        has_r, has_w, has_l = r_r > 0, r_w > 0, r_l > 0
        n_alpha = int(has_r) + int(has_w) + 2 * int(has_l) + n_zero
        alcid0, alphas = transcript.sample_ext_pows_chal(n_alpha)
        ai = 0
        cat_list = []     # (kind, claim_idx, alpha_offset)
        if has_r:
            cat_list.append(("r", pi, ai)); pi += 1; ai += 1
        if has_w:
            cat_list.append(("w", pi, ai)); pi += 1; ai += 1
        if has_l:
            cat_list.append(("p", s_p + 2 * li, ai))
            cat_list.append(("q", s_p + 2 * li + 1, ai + 1))
            li += 1; ai += 2
        col.info[id(vctx)] = LinkInfo(
            group=group_idx, alcid0=alcid0, alphas=alphas, n_alpha=n_alpha,
            zero_base=ai, cat_list=cat_list,
            x_star=np.asarray(rt_vals[:n_vars], np.uint64),
            b_star=np.asarray(rt_vals[n_vars:], np.uint64),
            x_cids=list(rt_cids[:n_vars]), b_cids=list(rt_cids[n_vars:]),
            compiled=compiled, k=int(k), n_vars=n_vars,
            claims=claims,
        )


def link_class_chip(col: ClaimLinkCollector, vctx, cidx: int, sid0: int,
                    class_point, class_point_cids, eqrows, reg):
    """Emit the full link row set for one chip of one class: batch chain,
    slot multipliers, sel_v / w_chip, sel-eq. Must run AFTER
    link_tower_group stashed the chip's info."""
    info = col.info.pop(id(vctx))
    compiled, k, n_vars = info.compiled, info.k, info.n_vars
    rho = len(info.b_star)
    one = exth.one()

    # -- sel_v * w_chip (logup subtrahend) -----------------------------------
    has_l = any(kind == "p" for kind, _, _ in info.cat_list)
    svw_val = None
    if has_l:
        n_lk = len(compiled.lk_exprs)
        # w_chip = sum of the first n_lk eq-table entries
        acc = np.zeros(4, np.uint64)
        for i in range(n_lk):
            eqcid = WCHIP_EQ_BASE + col.next_wchip_eq
            col.next_wchip_eq += 1
            bits = np.stack([
                exth.from_base(np.uint64((i >> kk) & 1)) for kk in range(rho)
            ]) if rho else np.zeros((0, 4), np.uint64)
            bit_cids = [reg.const_cid(bits[kk]) for kk in range(rho)]
            w = eqrows.chain(eqcid, info.b_star, bits,
                             z_cids=info.b_cids, r_cids=bit_cids, reg=reg)
            col.w["wch"].add(cidx=cidx, i=i)
            col.w["wch"].ext("w", w)
            col.w["wch"].ext("acc", acc)
            col.f["wch"].add(eqcid=eqcid, rho=rho)
            acc = exth.add(acc, w)
        wchip_val = acc
        full = k >= (1 << n_vars)
        if full:
            col.w["svf"].add(cidx=cidx)
            col.w["svf"].ext("wch", wchip_val)
            col.f["svf"].add(nlk=n_lk)
            svw_val = wchip_val
        else:
            # sel_v chain: descending bits of x_star
            res = np.zeros(4, np.uint64)
            pre = one.copy()
            for s in range(n_vars):
                jj = n_vars - 1 - s
                p = info.x_star[jj]
                kb = (k >> jj) & 1
                pp = exth.mul(pre, p)
                col.w["slv"].add(cidx=cidx, step=s)
                col.w["slv"].ext("p", p)
                col.w["slv"].ext("res", res)
                col.w["slv"].ext("pre", pre)
                col.w["slv"].ext("pp", pp)
                col.f["slv"].add(pcid=info.x_cids[jj], kb=kb)
                reg.use(info.x_cids[jj])
                if kb:
                    res = exth.add(res, exth.sub(pre, pp))
                    pre = pp
                else:
                    pre = exth.sub(pre, pp)
            col.w["sle"].add(cidx=cidx)
            col.w["sle"].ext("res", res)
            col.w["sle"].ext("pre", pre)
            col.f["sle"].add(n=n_vars)
            sv = exth.mul(res, wchip_val)
            col.w["svp"].add(cidx=cidx)
            col.w["svp"].ext("wch", wchip_val)
            col.w["svp"].ext("sv", res)
            col.w["svp"].ext("svw", sv)
            col.f["svp"].add(nlk=n_lk)
            svw_val = sv

    # -- batch chain ----------------------------------------------------------
    acc = np.zeros(4, np.uint64)
    for j, (kind, claim_idx, aoff) in enumerate(info.cat_list):
        rc = info.claims[claim_idx]
        al = info.alphas[aoff]
        acid = info.alcid0 + aoff
        reg.use(acid)
        key = "blp" if kind == "p" else "blc"
        sub = svw_val if kind == "p" else one
        t = exth.mul(al, exth.sub(rc, sub))
        col.w[key].add(cidx=cidx, j=j)
        col.w[key].ext("rc", rc)
        col.w[key].ext("al", al)
        col.w[key].ext("acc", acc)
        col.w[key].ext("t", t)
        if kind == "p":
            col.w[key].ext("sub", sub)
        col.f[key].add(grp=info.group, sj=claim_idx, acid=acid)
        acc = exth.add(acc, t)
    replay.check(np.array_equal(acc, np.asarray(vctx.batched_claim,
                                                np.uint64)),
                 "claim link: batched claim mismatch")
    col.w["ble"].add(cidx=cidx)
    col.w["ble"].ext("bc", acc)
    col.f["ble"].add(ncat=len(info.cat_list))

    # -- slot multipliers -----------------------------------------------------
    zi = 0
    amap = {kind: aoff for kind, _, aoff in info.cat_list}
    for si, slot in enumerate(compiled.slots):
        sid = sid0 + si
        expect = np.asarray(vctx.mults[si], np.uint64)
        if slot.kind == "zero":
            aoff = info.zero_base + zi
            zi += 1
            acid = info.alcid0 + aoff
            reg.use(acid)
            col.w["mtz"].add(sid=sid)
            col.w["mtz"].ext("al", info.alphas[aoff])
            col.f["mtz"].add(acid=acid)
            replay.check(np.array_equal(expect, info.alphas[aoff]))
            continue
        kind = {"prod_r": "r", "prod_w": "w", "lkq": "q",
                "lkp_table": "p"}[slot.kind]
        aoff = amap[kind]
        acid = info.alcid0 + aoff
        reg.use(acid)
        eqcid = SLOT_EQ_BASE + col.next_slot_eq
        col.next_slot_eq += 1
        rec = slot.rec
        bits = np.stack([
            exth.from_base(np.uint64((rec >> kk) & 1)) for kk in range(rho)
        ]) if rho else np.zeros((0, 4), np.uint64)
        bit_cids = [reg.const_cid(bits[kk]) for kk in range(rho)]
        w = eqrows.chain(eqcid, info.b_star, bits,
                         z_cids=info.b_cids, r_cids=bit_cids, reg=reg)
        m = exth.mul(info.alphas[aoff], w)
        replay.check(np.array_equal(m, expect),
                     "claim link: slot mult mismatch")
        col.w["mtr"].add(sid=sid)
        col.w["mtr"].ext("w", w)
        col.w["mtr"].ext("al", info.alphas[aoff])
        col.w["mtr"].ext("m", m)
        col.f["mtr"].add(eqcid=eqcid, rho=rho, acid=acid)

    # -- sel-eq ---------------------------------------------------------------
    emit_sel_eq(col, cidx, info.x_star, info.x_cids,
                np.asarray(class_point, np.uint64), class_point_cids, k,
                n_vars, eqrows, reg)


def emit_sel_eq(col: ClaimLinkCollector, seq_key: int, z_vals, z_cids,
                point, point_cids, k: int, n_vars: int, eqrows, reg):
    """Emit the masked sel_eq_eval(z, point, k) chains, writing the result
    to (Seq, seq_key). Shared by the class-main claim link and the EC-quark
    verify's QuarkBinaryTreeLessThan inner evaluations."""
    from .chip import sel_eq_eval

    one = exth.one()
    info_x_star = z_vals
    info_x_cids = z_cids
    class_point_cids = point_cids
    cidx = seq_key
    expect = sel_eq_eval(np.asarray(z_vals, np.uint64), point, k)
    if k >= (1 << n_vars):
        eqcid = SEQ_EQ_BASE + col.next_seq_eq
        col.next_seq_eq += 1
        v = eqrows.chain(eqcid, np.asarray(z_vals, np.uint64), point,
                         z_cids=z_cids, r_cids=point_cids,
                         reg=reg)
        replay.check(np.array_equal(v, expect))
        col.w["sqf"].add(cidx=cidx)
        col.w["sqf"].ext("v", v)
        col.f["sqf"].add(eqcid=eqcid, n=n_vars)
    else:
        # descending prefix pass (emits per-set-bit term coefficients)
        pre = one.copy()
        for s in range(n_vars):
            jj = n_vars - 1 - s
            rt = info_x_star[jj]
            pt = point[jj]
            kb = (k >> jj) & 1
            rp = exth.mul(rt, pt)
            b0 = exth.add(exth.sub(exth.sub(one, rt), pt), rp)
            key = "sqd1" if kb else "sqd0"
            col.w[key].add(cidx=cidx, step=s)
            col.w[key].ext("rt", rt)
            col.w[key].ext("pt", pt)
            col.w[key].ext("pre", pre)
            col.w[key].ext("rp", rp)
            col.f[key].add(jbit=jj, rtcid=info_x_cids[jj],
                           ptcid=class_point_cids[jj])
            reg.use(info_x_cids[jj])
            reg.use(class_point_cids[jj])
            if kb:
                ct = exth.mul(pre, b0)
                col.w[key].ext("ct", ct)
                nxt = exth.mul(pre, rp)
            else:
                nxt = exth.mul(pre, b0)
            col.w[key].ext("nx", nxt)
            pre = nxt
        # ascending pass
        low = one.copy()
        res = np.zeros(4, np.uint64)
        # recompute the term coefficients for consumption
        pre2 = one.copy()
        cterms = {}
        for s in range(n_vars):
            jj = n_vars - 1 - s
            rt, pt = info_x_star[jj], point[jj]
            kb = (k >> jj) & 1
            rp = exth.mul(rt, pt)
            b0 = exth.add(exth.sub(exth.sub(one, rt), pt), rp)
            if kb:
                cterms[jj] = exth.mul(pre2, b0)
                pre2 = exth.mul(pre2, rp)
            else:
                pre2 = exth.mul(pre2, b0)
        for jj in range(n_vars):
            rt, pt = info_x_star[jj], point[jj]
            kb = (k >> jj) & 1
            rp = exth.mul(rt, pt)
            aj = exth.add(exth.add(exth.sub(exth.sub(one, rt), pt), rp), rp)
            key = "sqa1" if kb else "sqa0"
            col.w[key].add(cidx=cidx, step=jj)
            col.w[key].ext("rt", rt)
            col.w[key].ext("pt", pt)
            col.w[key].ext("low", low)
            col.w[key].ext("res", res)
            col.w[key].ext("rp", rp)
            col.w[key].ext("ln", exth.mul(low, aj))
            col.f[key].add(jbit=jj, rtcid=info_x_cids[jj],
                           ptcid=class_point_cids[jj])
            reg.use(info_x_cids[jj])
            reg.use(class_point_cids[jj])
            if kb:
                ct = cterms[jj]
                cl_ = exth.mul(ct, low)
                col.w[key].ext("ct", ct)
                col.w[key].ext("cl", cl_)
                res = exth.add(res, cl_)
            low = exth.mul(low, aj)
        replay.check(np.array_equal(res, expect),
                     "claim link: sel_eq mismatch")
        col.w["sqe"].add(cidx=cidx)
        col.w["sqe"].ext("pre", pre)
        col.w["sqe"].ext("low", low)
        col.w["sqe"].ext("res", res)
        col.f["sqe"].add(n=n_vars)
