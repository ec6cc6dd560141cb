"""EC-sum quark verification in-circuit (the LAST shard-verifier stage).

Role mirror of the reference recursion's continuation-check tables
(ceno_recursion_v2/src/continuation/): gkr/eccquark.py::verify_ec_sum —
the zerocheck that proves the septic-curve binary addition tree behind the
cross-shard RAM multiset hash — is re-proven as chips:

  * the deg-3 zerocheck rides the existing bound sumcheck rounds chip
    (claim pinned to ZERO by the group-final row);
  * the three analytic selector evaluations become chains: sel_add's
    QuarkBinaryTreeLessThan recurrence (per-layer masked sel_eq inner
    evaluations via claim_link.emit_sel_eq + a two-variant recurrence
    chip), the one-hot factors as bound eq1 chains against key-fixed 0/1
    constants, sel_byp / sel_exp as combiner rows;
  * the batched-constraint recombination walks eccquark._term_schedule()
    as key material: per-(instance, selector) accumulation chains whose
    rows look up the absorbed column evals, the alpha pow-chain powers and
    (for the export constants) the final-sum public values;
  * the group-final row recombines sum_sel sel * group_total and requires
    it equal the zerocheck's reduced claim.

All cids/coefficients live in FIXED schedule columns committed by the
aggregation key; pair_counts(num_instances, n) is key material made
transcript-consistent by the absorbed-num_instances const-bind rows.

Copy of ``ceno_tpu/gkr/ec_verify.py``, in host numpy over the port's
``gkr/eccquark.py`` (``_term_schedule``, ``pair_counts``, ``DEG``).
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..mle import expression as E
from . import fs_chain as FS
from . import gadgets as G
from .chip import compile_chip
from .circuit_builder import CircuitBuilder, RAM_CUSTOM
from .recursion import TAG_EQ_CHAIN, TAG_SUMCHECK_CLAIM, TAG_SEQ
from .claim_link import _Rows, emit_sel_eq
from .eccquark import DEG, _term_schedule, pair_counts
from ..utils import replay

_P = np.uint64(bb.P)

TAG_ECSA = 41    # (inst, i, res4): sel_add recurrence chain
TAG_ECSEL = 42   # (inst, s, v4): the three selector values
TAG_ECG = 43     # (gid, j, acc4): per-(inst, sel) term accumulation

EC_EQ_BASE = (1 << 28) + (1 << 27) + (1 << 26)   # bound-eq chain cids
EC_SEQ_KEY_BASE = 1 << 26                        # TAG_SEQ key namespace
EC_SC_BASE = (1 << 27) + (1 << 26)               # zerocheck instance ids


class EcVerifyChips:
    """Generic EC-verify chip set (bind-only; built once per aggregation)."""

    def __init__(self):
        one = G.ExtWire.constant(exth.one())
        zero = G.ExtWire.constant(np.zeros(4, np.uint64))

        # -- term rows: 2-col / 1-col / fsum-const variants --------------------
        def _term(name, ncols, fsum):
            cb = CircuitBuilder(name)
            gid = cb.create_witin("gid")
            j = cb.create_witin("j")
            acid = cb.create_fixed("acid")
            cf = cb.create_fixed("cf")
            al = G.ext_witness(cb, "al")
            acc = G.ext_witness(cb, "acc")
            cb.lk_record(FS.LK_AGG_CHAL, [acid] + al.c)
            if fsum:
                pvcid = cb.create_fixed("pvcid")
                fs_ = cb.create_witin("fs")
                cb.lk_record(FS.LK_AGG_CHAL, [pvcid, fs_, E.Const(0),
                                              E.Const(0), E.Const(0)])
                t = G.ext_witness(cb, "t")
                for i in range(4):
                    cb.require_zero(f"t{i}", t.c[i] - al.c[i] * fs_)
            else:
                cur = al
                for ei in range(ncols):
                    ccid = cb.create_fixed(f"c{ei}")
                    ev = G.ext_witness(cb, f"e{ei}")
                    cb.lk_record(FS.LK_AGG_CHAL, [ccid] + ev.c)
                    cur = G.ext_mul(cb, f"m{ei}", cur, ev)
                t = cur
            head = [E.Const(RAM_CUSTOM), E.Const(TAG_ECG), gid]
            cb.read_record(head + [j] + acc.c)
            out = G.ExtWire(*[acc.c[i] + t.c[i] * cf for i in range(4)])
            cb.write_record(head + [j + 1] + out.c)
            return cb, compile_chip(cb)

        self.t2_cb, self.t2 = _term("ecq_term2", 2, False)
        self.t1_cb, self.t1 = _term("ecq_term1", 1, False)
        self.t0_cb, self.t0 = _term("ecq_term_fsum", 0, True)

        # -- sel_add recurrence -------------------------------------------------
        def _sa(name, with_seq):
            cb = CircuitBuilder(name)
            inst = cb.create_witin("inst")
            i = cb.create_witin("i")
            oc = cb.create_fixed("oc")
            rc = cb.create_fixed("rc")
            o = G.ext_witness(cb, "o")
            r = G.ext_witness(cb, "r")
            res = G.ext_witness(cb, "res")
            cb.lk_record(FS.LK_AGG_CHAL, [oc] + o.c)
            cb.lk_record(FS.LK_AGG_CHAL, [rc] + r.c)
            orr = G.ext_mul(cb, "orr", o, r)
            rhs = G.ext_mul(cb, "rhs", orr, res)
            if with_seq:
                sqk = cb.create_fixed("sqkey")
                seqv = G.ext_witness(cb, "seqv")
                cb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQ), sqk]
                               + seqv.c)
                m1 = G.ext_mul(cb, "m1", one.sub(o), G.ExtWire(*one.sub(r).c))
                lhs = G.ext_mul(cb, "lhs", m1, seqv)
                nxt = lhs.add(rhs)
            else:
                nxt = rhs
            head = [E.Const(RAM_CUSTOM), E.Const(TAG_ECSA), inst]
            cb.read_record(head + [i] + res.c)
            cb.write_record(head + [i + 1] + G.ExtWire(*nxt.c).c)
            return cb, compile_chip(cb)

        self.sa1_cb, self.sa1 = _sa("ecq_sa_pair", True)
        self.sa0_cb, self.sa0 = _sa("ecq_sa_empty", False)

        # start: res_1 = z0 * (1-o0)(1-r0)
        sb = CircuitBuilder("ecq_sa_start")
        s_inst = sb.create_witin("inst")
        s_oc = sb.create_fixed("oc")
        s_rc = sb.create_fixed("rc")
        s_z0 = sb.create_fixed("z0")
        so = G.ext_witness(sb, "o")
        sr = G.ext_witness(sb, "r")
        sb.lk_record(FS.LK_AGG_CHAL, [s_oc] + so.c)
        sb.lk_record(FS.LK_AGG_CHAL, [s_rc] + sr.c)
        sm = G.ext_mul(sb, "m1", one.sub(so), G.ExtWire(*one.sub(sr).c))
        sb.write_record(
            [E.Const(RAM_CUSTOM), E.Const(TAG_ECSA), s_inst, E.Const(1)]
            + [sm.c[i] * s_z0 for i in range(4)]
        )
        self.sas_cb, self.sas = sb, compile_chip(sb)

        # end: publish sel_add TWICE (group-final + sel_byp both read it)
        eb = CircuitBuilder("ecq_sa_end")
        e_inst = eb.create_witin("inst")
        e_n = eb.create_fixed("n")
        ev = G.ext_witness(eb, "v")
        eb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSA), e_inst, e_n]
                       + ev.c)
        for _ in range(2):
            eb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSEL), e_inst,
                             E.Const(0)] + ev.c)
        self.sae_cb, self.sae = eb, compile_chip(eb)

        # -- sel_byp: eq(out, rt) - sel_add - onehot(out,1s)*onehot(rt,1s) ------
        yb = CircuitBuilder("ecq_byp")
        y_inst = yb.create_witin("inst")
        y_eqc = yb.create_fixed("eqcid")
        y_o1 = yb.create_fixed("o1cid")
        y_o2 = yb.create_fixed("o2cid")
        y_n = yb.create_fixed("n")
        eqv = G.ext_witness(yb, "eqv")
        sa = G.ext_witness(yb, "sa")
        ov1 = G.ext_witness(yb, "ov1")
        ov2 = G.ext_witness(yb, "ov2")
        for cid, w in ((y_eqc, eqv), (y_o1, ov1), (y_o2, ov2)):
            h = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), cid]
            yb.write_record(h + [E.Const(0)] + one.c)
            yb.read_record(h + [y_n] + w.c)
        yb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSEL), y_inst,
                        E.Const(0)] + sa.c)
        oo = G.ext_mul(yb, "oo", ov1, ov2)
        v = eqv.sub(sa).sub(oo)
        yb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSEL), y_inst,
                         E.Const(1)] + v.c)
        self.byp_cb, self.byp = yb, compile_chip(yb)

        # -- sel_exp: onehot(out, lsi) * onehot(rt, lsi) -------------------------
        xb = CircuitBuilder("ecq_exp")
        x_inst = xb.create_witin("inst")
        x_c1 = xb.create_fixed("e1cid")
        x_c2 = xb.create_fixed("e2cid")
        x_n = xb.create_fixed("n")
        xv1 = G.ext_witness(xb, "v1")
        xv2 = G.ext_witness(xb, "v2")
        for cid, w in ((x_c1, xv1), (x_c2, xv2)):
            h = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), cid]
            xb.write_record(h + [E.Const(0)] + one.c)
            xb.read_record(h + [x_n] + w.c)
        xm = G.ext_mul(xb, "m", xv1, xv2)
        xb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSEL), x_inst,
                         E.Const(2)] + xm.c)
        self.exp_cb, self.exp = xb, compile_chip(xb)

        # -- group final: fc == sum_sel sel * group_total; pins the zerocheck ---
        fb = CircuitBuilder("ecq_final")
        f_inst = fb.create_witin("inst")
        f_scid = fb.create_fixed("scid")
        f_n = fb.create_fixed("n")
        lens = [fb.create_fixed(f"l{s}") for s in range(3)]
        sels = [G.ext_witness(fb, f"sel{s}") for s in range(3)]
        gs = [G.ext_witness(fb, f"g{s}") for s in range(3)]
        fcw = G.ext_witness(fb, "fc")
        acc = None
        for s_ in range(3):
            fb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_ECSEL), f_inst,
                            E.Const(s_)] + sels[s_].c)
            gh = [E.Const(RAM_CUSTOM), E.Const(TAG_ECG),
                  f_inst * 3 + E.Const(s_)]
            fb.write_record(gh + [E.Const(0)] + zero.c)
            fb.read_record(gh + [lens[s_]] + gs[s_].c)
            term = G.ext_mul(fb, f"sg{s_}", sels[s_], gs[s_])
            acc = term if acc is None else acc.add(term)
        sh = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), f_scid]
        fb.write_record(sh + [E.Const(0)] + zero.c)
        fb.read_record(sh + [f_n] + fcw.c)
        G.ext_require_equal(fb, "ec_recomb", G.ExtWire(*acc.c), fcw)
        self.fin_cb, self.fin = fb, compile_chip(fb)


class EcVerifyCollector:
    def __init__(self, chips: EcVerifyChips):
        self.chips = chips
        names = ("t2", "t1", "t0", "sa1", "sa0", "sas", "sae", "byp", "exp",
                 "fin")
        self.w = {n: _Rows() for n in names}
        self.f = {n: _Rows() for n in names}
        self.next_inst = 0
        self.next_eq = 0
        self.next_seq = 0

    def emit(self):
        ch = self.chips
        pairs = [
            ("ecq_term2", "t2", ch.t2, ch.t2_cb),
            ("ecq_term1", "t1", ch.t1, ch.t1_cb),
            ("ecq_term_fsum", "t0", ch.t0, ch.t0_cb),
            ("ecq_sa_pair", "sa1", ch.sa1, ch.sa1_cb),
            ("ecq_sa_empty", "sa0", ch.sa0, ch.sa0_cb),
            ("ecq_sa_start", "sas", ch.sas, ch.sas_cb),
            ("ecq_sa_end", "sae", ch.sae, ch.sae_cb),
            ("ecq_byp", "byp", ch.byp, ch.byp_cb),
            ("ecq_exp", "exp", ch.exp, ch.exp_cb),
            ("ecq_final", "fin", ch.fin, ch.fin_cb),
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


def assign_ec_verify(col: EcVerifyCollector, cl_col, transcript, ecp,
                     final_sum, fsum_pv_cids, eqrows, reg):
    """Replay verify_ec_sum on the cursor with full chip emission.

    ``fsum_pv_cids``: (2, 7) lookup-table cids publishing the final-sum
    public values (claim_link pv leaves). Returns sc_cols for the shared
    deg-3 bound rounds chip."""
    from ..sumcheck.verifier import lagrange_extrapolate
    from .chip import sel_eq_eval

    chips = col.chips
    n = ecp.n_vars
    inst = col.next_inst
    col.next_inst += 1
    one = exth.one()

    out_cids = []
    out_rt = np.zeros((n, 4), np.uint64)
    for i in range(n):
        cid, v = transcript.sample_ext_chal()
        out_cids.append(cid)
        out_rt[i] = v
    alcid0, alphas = transcript.sample_ext_pows_chal(DEG * 7)

    # zerocheck rounds (claim pinned to zero by the group-final row)
    msgs = np.asarray(ecp.round_msgs, np.uint64)
    sc_inst = EC_SC_BASE + inst
    sc_cols: dict = {
        "inst": np.full(n, sc_inst, np.uint64),
        "round": np.arange(n, dtype=np.uint64),
    }
    aidxs = np.zeros(n, np.uint64)
    acids = np.zeros(n, np.uint64)
    chals = np.zeros((n, 4), np.uint64)
    cins = np.zeros((n, 4), np.uint64)
    cur = np.zeros(4, np.uint64)
    for rnd in range(n):
        cins[rnd] = cur
        aidxs[rnd] = transcript.append_slots(msgs[rnd].ravel())
        acid, ch = transcript.sample_ext_chal()
        reg.use(acid)
        acids[rnd] = acid
        chals[rnd] = ch
        cur = lagrange_extrapolate(msgs[rnd], ch)
    final_claim = cur
    rt = chals[::-1].copy()
    rt_cids = [int(acids[n - 1 - i]) for i in range(n)]
    sc_cols["aidx"] = aidxs
    sc_cols["acid"] = acids
    for kk in range(4):
        G.assign_ext(sc_cols, f"y{kk}", msgs[:, kk])
    G.assign_ext(sc_cols, "alpha", chals)
    G.assign_ext(sc_cols, "claim_in", cins)
    G.assign_lagrange(sc_cols, "lag", msgs, chals, 3)

    # absorbed column evals
    evs = np.asarray(ecp.col_evals, np.uint64)
    ev_cids = [transcript.append_ext_chal(evs[row])
               for row in range(evs.shape[0])]

    # -- sel_add recurrence ----------------------------------------------------
    k = int(ecp.num_instances)
    seq = pair_counts(k, n)[::-1]
    if seq[0] == 0:
        res = np.zeros(4, np.uint64)
    else:
        res = exth.mul(exth.sub(one, out_rt[0]), exth.sub(one, rt[0]))
    reg.use(out_cids[0])
    reg.use(rt_cids[0])
    col.w["sas"].add(inst=inst)
    col.w["sas"].ext("o", out_rt[0])
    col.w["sas"].ext("r", rt[0])
    col.w["sas"].ext("m1", exth.mul(exth.sub(one, out_rt[0]),
                                    exth.sub(one, rt[0])))
    col.f["sas"].add(oc=out_cids[0], rc=rt_cids[0],
                     z0=0 if seq[0] == 0 else 1)
    for i in range(1, n):
        m = seq[i]
        reg.use(out_cids[i])
        reg.use(rt_cids[i])
        rhs = exth.mul(exth.mul(out_rt[i], rt[i]), res)
        if m == 0:
            col.w["sa0"].add(inst=inst, i=i)
            col.w["sa0"].ext("o", out_rt[i])
            col.w["sa0"].ext("r", rt[i])
            col.w["sa0"].ext("res", res)
            col.w["sa0"].ext("orr", exth.mul(out_rt[i], rt[i]))
            col.w["sa0"].ext("rhs", rhs)
            col.f["sa0"].add(oc=out_cids[i], rc=rt_cids[i])
            res = rhs
        else:
            sqkey = EC_SEQ_KEY_BASE + col.next_seq
            col.next_seq += 1
            emit_sel_eq(cl_col, sqkey, out_rt[:i], out_cids[:i], rt[:i],
                        rt_cids[:i], m, i, eqrows, reg)
            seqv = sel_eq_eval(out_rt[:i], rt[:i], m)
            m1 = exth.mul(exth.sub(one, out_rt[i]), exth.sub(one, rt[i]))
            lhs = exth.mul(m1, seqv)
            col.w["sa1"].add(inst=inst, i=i)
            col.w["sa1"].ext("o", out_rt[i])
            col.w["sa1"].ext("r", rt[i])
            col.w["sa1"].ext("res", res)
            col.w["sa1"].ext("seqv", seqv)
            col.w["sa1"].ext("orr", exth.mul(out_rt[i], rt[i]))
            col.w["sa1"].ext("rhs", rhs)
            col.w["sa1"].ext("m1", m1)
            col.w["sa1"].ext("lhs", lhs)
            col.f["sa1"].add(oc=out_cids[i], rc=rt_cids[i], sqkey=sqkey)
            res = exth.add(lhs, rhs)
    sel_add = res
    col.w["sae"].add(inst=inst)
    col.w["sae"].ext("v", sel_add)
    col.f["sae"].add(n=n)

    # -- sel_byp / sel_exp -------------------------------------------------------
    czero = reg.const_cid(np.zeros(4, np.uint64))
    cone = reg.const_cid(one)

    def onehot_chain(point, point_cids, bits):
        cid = EC_EQ_BASE + col.next_eq
        col.next_eq += 1
        zs = np.stack([
            (one if b else np.zeros(4, np.uint64)) for b in bits
        ])
        z_cids = [cone if b else czero for b in bits]
        v = eqrows.chain(cid, zs, np.asarray(point, np.uint64),
                         z_cids=z_cids, r_cids=list(point_cids), reg=reg)
        return cid, v

    eqc = EC_EQ_BASE + col.next_eq
    col.next_eq += 1
    eq_v = eqrows.chain(eqc, out_rt, rt, z_cids=out_cids, r_cids=rt_cids,
                        reg=reg)
    o1c, ones_out = onehot_chain(out_rt, out_cids, [1] * n)
    o2c, ones_rt = onehot_chain(rt, rt_cids, [1] * n)
    sel_byp = exth.sub(exth.sub(eq_v, sel_add), exth.mul(ones_out, ones_rt))
    col.w["byp"].add(inst=inst)
    col.w["byp"].ext("eqv", eq_v)
    col.w["byp"].ext("sa", sel_add)
    col.w["byp"].ext("ov1", ones_out)
    col.w["byp"].ext("ov2", ones_rt)
    col.w["byp"].ext("oo", exth.mul(ones_out, ones_rt))
    col.f["byp"].add(eqcid=eqc, o1cid=o1c, o2cid=o2c, n=n)

    lsi = [0] + [1] * (n - 1)
    x1c, exp_out = onehot_chain(out_rt, out_cids, lsi)
    x2c, exp_rt = onehot_chain(rt, rt_cids, lsi)
    sel_exp = exth.mul(exp_out, exp_rt)
    col.w["exp"].add(inst=inst)
    col.w["exp"].ext("v1", exp_out)
    col.w["exp"].ext("v2", exp_rt)
    col.w["exp"].ext("m", sel_exp)
    col.f["exp"].add(e1cid=x1c, e2cid=x2c, n=n)

    # -- term accumulation chains -------------------------------------------------
    sched, n_alpha = _term_schedule()
    assert n_alpha == DEG * 7
    gacc = [np.zeros(4, np.uint64) for _ in range(3)]
    glen = [0, 0, 0]
    fsum = np.asarray(final_sum, np.uint64) % _P
    for (a, coeff, cols_, sel, fref) in sched:
        al = alphas[a]
        reg.use(alcid0 + a)
        gid = inst * 3 + sel
        j = glen[sel]
        glen[sel] += 1
        if fref is not None:
            fs_ = int(fsum[fref[0], fref[1]])
            pvcid = int(fsum_pv_cids[fref[0]][fref[1]])
            reg.use(pvcid)
            t = exth.mul_base(al, np.uint64(fs_))
            col.w["t0"].add(gid=gid, j=j, fs=fs_)
            col.w["t0"].ext("al", al)
            col.w["t0"].ext("acc", gacc[sel])
            col.w["t0"].ext("t", t)
            col.f["t0"].add(acid=alcid0 + a, cf=coeff, pvcid=pvcid)
        elif len(cols_) == 2:
            e1, e2 = evs[cols_[0]], evs[cols_[1]]
            reg.use(ev_cids[cols_[0]])
            reg.use(ev_cids[cols_[1]])
            m0 = exth.mul(al, e1)
            t = exth.mul(m0, e2)
            col.w["t2"].add(gid=gid, j=j)
            col.w["t2"].ext("al", al)
            col.w["t2"].ext("e0", e1)
            col.w["t2"].ext("m0", m0)
            col.w["t2"].ext("e1", e2)
            col.w["t2"].ext("m1", t)
            col.w["t2"].ext("acc", gacc[sel])
            col.f["t2"].add(acid=alcid0 + a, cf=coeff, c0=ev_cids[cols_[0]],
                            c1=ev_cids[cols_[1]])
        else:
            e1 = evs[cols_[0]]
            reg.use(ev_cids[cols_[0]])
            t = exth.mul(al, e1)
            col.w["t1"].add(gid=gid, j=j)
            col.w["t1"].ext("al", al)
            col.w["t1"].ext("e0", e1)
            col.w["t1"].ext("m0", t)
            col.w["t1"].ext("acc", gacc[sel])
            col.f["t1"].add(acid=alcid0 + a, cf=coeff, c0=ev_cids[cols_[0]])
        gacc[sel] = exth.add(gacc[sel],
                             exth.mul_base(t, np.uint64(coeff)))

    # -- group final ---------------------------------------------------------------
    acc = np.zeros(4, np.uint64)
    sel_vals = [sel_add, sel_byp, sel_exp]
    for s_ in range(3):
        acc = exth.add(acc, exth.mul(sel_vals[s_], gacc[s_]))
    replay.check(np.array_equal(acc, final_claim),
                 "ec verify witgen: recombination mismatch")
    row = {"inst": inst}
    col.w["fin"].add(**row)
    for s_ in range(3):
        col.w["fin"].ext(f"sel{s_}", sel_vals[s_])
        col.w["fin"].ext(f"g{s_}", gacc[s_])
        col.w["fin"].ext(f"sg{s_}", exth.mul(sel_vals[s_], gacc[s_]))
    col.w["fin"].ext("fc", final_claim)
    col.f["fin"].add(scid=sc_inst, n=n, l0=glen[0], l1=glen[1], l2=glen[2])
    return sc_cols
