"""Port parity: the verifier chips of ``gkr/recursion.py`` against the
reference, stage by stage, as in ``tests/test_recursion.py``.

Each stage's real inputs are made once with the reference (host sumchecks,
a Merkle tree, a tower proof, a jagged opening, a class-batched main
zerocheck) from a numpy seed; both packages' witness builders then take the
same inputs (the proofs carried to the port through ``interop``), and for
every chip of the stage the ``chip_digest``, the witness and the fixed
columns must be equal. The port's sets must satisfy its MockProver, and one
tampered cell must break each. Stages: sumcheck-verify (plain and
Fiat-Shamir), Merkle path, tower verify (plain and bound to a recording
transcript), jagged verify and class-main verify; and the EC-sum quark's
verification (``gkr/ec_verify.py``) over a quark proof of 8 points, its
chips, rows and registered challenges against the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceno_tpu.fields import ext4_host as rexth
from ceno_tpu.gkr import chip as rchip
from ceno_tpu.gkr import fs_chain as rFS
from ceno_tpu.gkr import recursion as rR
from ceno_tpu.gkr import tower as rtower
from ceno_tpu.gkr.chip import chip_digest as rchip_digest
from ceno_tpu.hash import poseidon2 as rp2
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.pcs import basefold as rbasefold
from ceno_tpu.pcs import jagged as rjagged
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.pcs.merkle import MerkleTree as RMerkleTree
from ceno_tpu.sumcheck import host_impl as rH
from ceno_tpu.sumcheck import prover as rsc_prover
from ceno_tpu.sumcheck.prover import TermSpec as RTermSpec
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import chip as pchip
from ceno_tpu_torch.gkr import fs_chain as FS
from ceno_tpu_torch.gkr import recursion as R
from ceno_tpu_torch.gkr.chip import chip_digest
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.hash.transcript import Transcript

torch.set_num_threads(1)
N_VARS, DEG = 4, 3


def _pad(wit):
    k = wit.shape[1]
    n = max(2, 1 << max(0, (k - 1).bit_length()))
    return np.pad(wit, ((0, 0), (0, n - k))) if k < n else wit


def _mkset(compiled, cb, wit, fixed=None):
    k = wit.shape[1]
    w = _pad(wit)
    f = (np.zeros((0, w.shape[1]), np.uint64) if fixed is None
         else np.pad(np.asarray(fixed, np.uint64), ((0, 0), (0, w.shape[1] - fixed.shape[1]))))
    return (compiled, cb, w, f, np.zeros(0), k)


def _tamper(sets, i, cb, col, row=0):
    bad = sets[i][2].copy()
    j = cb.wit_names.index(col)
    bad[j, row] = (int(bad[j, row]) + 1) % bb.P
    return sets[:i] + [(sets[i][0], sets[i][1], bad) + sets[i][3:]] + sets[i + 1:]


def _same_chips(ref_chips, port_chips):
    """Every ``*_compiled`` field of two chip dataclasses has the same
    ``chip_digest`` and the same witness names."""
    names = [f.name for f in dataclasses.fields(port_chips) if f.name.endswith("_compiled")]
    assert names == [f.name for f in dataclasses.fields(ref_chips)
                     if f.name.endswith("_compiled")]
    for name in names:
        assert chip_digest(getattr(port_chips, name)) == \
            rchip_digest(getattr(ref_chips, name)), name
        cb = name[: -len("_compiled")] + "_cb"
        assert getattr(port_chips, cb).wit_names == getattr(ref_chips, cb).wit_names, name


def _same_arrays(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                assert np.array_equal(np.asarray(a[k], np.uint64), np.asarray(b[k], np.uint64)), k
        elif isinstance(a, (int, np.integer)):
            assert int(a) == int(b)
        else:
            assert np.array_equal(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


def _sumchecks(rng, m, label=b"rec-test-%d"):
    """m real host sumchecks of the reference; each its messages, round
    challenges, claim and the transcript state before it."""
    out = []
    for i in range(m):
        n = 1 << N_VARS
        f = rng.integers(0, bb.P, size=n, dtype=np.uint64)
        g = rng.integers(0, bb.P, size=(n, 4), dtype=np.uint64)
        h = rng.integers(0, bb.P, size=(n, 4), dtype=np.uint64)
        scalar = rng.integers(0, bb.P, size=4, dtype=np.uint64)
        acc = np.zeros(4, np.uint64)
        for j in range(n):
            acc = rexth.add(acc, rexth.mul_base(rexth.mul(g[j], h[j]), np.uint64(f[j])))
        tp = RTranscript(label % i if b"%d" in label else label)
        pre = tp.state.copy()
        res = rsc_prover.prove([f], [g, h], [RTermSpec(scalar, bidx=(0,), eidx=(0, 1))],
                               N_VARS, tp)
        out.append({"msgs": res.proof.round_msgs, "chals": res.point[::-1].copy(),
                    "claim": rexth.mul(scalar, acc), "pre_state": pre})
    return out


def test_sumcheck_verify_chips_equal_reference():
    trs = _sumchecks(np.random.default_rng(23), 3)
    ref = rR.build_sumcheck_verify_chips(DEG, N_VARS)
    chips = R.build_sumcheck_verify_chips(DEG, N_VARS)
    _same_chips(ref, chips)
    want = rR.assign_sumcheck_verify(ref, [dict(t) for t in trs])
    got = R.assign_sumcheck_verify(chips, [dict(t) for t in trs])
    _same_arrays(want, got)
    rw, ew, _ = got
    sets = [_mkset(chips.rounds_compiled, chips.rounds_cb, rw),
            _mkset(chips.ends_compiled, chips.ends_cb, ew)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 0, chips.rounds_cb, "y2_1", 5),
                                       raise_on_error=False)


def test_fs_sumcheck_verify_chips_equal_reference():
    (tr,) = _sumchecks(np.random.default_rng(29), 1, b"fs-rec")
    tr = {k: tr[k] for k in ("msgs", "claim", "pre_state")}
    ref = rR.build_fs_sumcheck_verify_chips(DEG, N_VARS)
    chips = R.build_fs_sumcheck_verify_chips(DEG, N_VARS)
    _same_chips(ref, chips)
    want = rR.assign_fs_sumcheck_verify(ref, [dict(tr)])
    got = R.assign_fs_sumcheck_verify(chips, [dict(tr)])
    _same_arrays(want[:3], got[:3])
    _same_arrays(want[3], got[3])
    rw, ew = got[0], got[1]
    sets = [_mkset(chips.rounds_compiled, chips.rounds_cb, rw),
            _mkset(chips.ends_compiled, chips.ends_cb, ew)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 0, chips.rounds_cb, "y1_2", 1),
                                       raise_on_error=False)


def test_merkle_path_chips_equal_reference():
    rng = np.random.default_rng(31)
    depth = 5
    cols = rng.integers(0, bb.P, size=(3, 1 << depth), dtype=np.uint64)
    tree = RMerkleTree.build_host(cols)
    walks = [{"index": ix, "leaf": rp2.hash_elements_host(cols[:, ix]),
              "path": tree.open_paths([ix])[0]} for ix in (0, 7, 31)]
    ref, chips = rR.build_merkle_path_chips(depth), R.build_merkle_path_chips(depth)
    _same_chips(ref, chips)
    want = rR.assign_merkle_paths(ref, walks)
    got = R.assign_merkle_paths(chips, walks)
    _same_arrays(want, got)
    rw, ew, roots = got
    assert all(np.array_equal(r, tree.root) for r in roots)
    sets = [_mkset(chips.rows_compiled, chips.rows_cb, rw),
            _mkset(chips.ends_compiled, chips.ends_cb, ew)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 0, chips.rows_cb, "sib3", 2),
                                       raise_on_error=False)


def _tower_proof(rng, n_vars, s_p, s_l, label):
    n = 1 << n_vars
    prods = [rng.integers(1, bb.P, size=(n, 4), dtype=np.uint64) for _ in range(s_p)]
    logups = [(rng.integers(0, bb.P, size=(n, 4), dtype=np.uint64),
               rng.integers(1, bb.P, size=(n, 4), dtype=np.uint64)) for _ in range(s_l)]
    proof, _pt, _claims = rtower.prove_towers_host(prods, logups, RTranscript(label))
    return proof


@pytest.mark.parametrize("bind", [False, True])
def test_tower_verify_chips_equal_reference(bind):
    n_vars, s_p, s_l = 4, 2, 1
    rproof = _tower_proof(np.random.default_rng(37), n_vars, s_p, s_l, b"tower-rec")
    pproof = interop.tower_proof_from_dict(dataclasses.asdict(rproof))
    ref = rR.build_tower_verify_chips(s_p, s_l, n_vars, bind=bind)
    chips = R.build_tower_verify_chips(s_p, s_l, n_vars, bind=bind)
    _same_chips(ref, chips)
    if bind:
        rt, t = rFS.ChainTranscript(b"tower-rec"), FS.ChainTranscript(b"tower-rec")
    else:
        rt, t = RTranscript(b"tower-rec"), Transcript(b"tower-rec")
    rfx, fx = {}, {}
    want = rR.assign_tower_verify(ref, [rproof], rt, fixed_out=rfx)
    got = R.assign_tower_verify(chips, [pproof], t, fixed_out=fx)
    _same_arrays(want, got)
    assert sorted(rfx) == sorted(fx)
    for k in fx:
        _same_arrays(rfx[k] if isinstance(rfx[k], (list, tuple)) else [rfx[k]],
                     fx[k] if isinstance(fx[k], (list, tuple)) else [fx[k]])
    if bind:
        # the same challenges registered at the same table rows and slots
        assert [(c, s, list(map(int, v))) for c, s, v in t.registry.chal_rows] == \
            [(c, s, list(map(int, v))) for c, s, v in rt.registry.chal_rows]
        assert t.registry.chal_rows
        return
    rw, bw, qw, ew, _ = got
    sets = [_mkset(chips.rounds_compiled, chips.rounds_cb, rw),
            _mkset(chips.bound_compiled, chips.bound_cb, bw),
            _mkset(chips.eqrows_compiled, chips.eqrows_cb, qw),
            _mkset(chips.ends_compiled, chips.ends_cb, ew)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 1, chips.bound_cb, "ev1_2", 1),
                                       raise_on_error=False)
    assert MockProver.assert_satisfied(_tamper(sets, 3, chips.ends_cb, "po01_0", 0),
                                       raise_on_error=False)


def test_jagged_verify_chips_equal_reference():
    rng = np.random.default_rng(41)
    params = RParams(blowup_log=1, n_queries=4, stop_size=32)

    def mle_eval(col, z):
        eq = rH.build_eq_host(np.asarray(z, np.uint64))
        acc = np.zeros(4, np.uint64)
        for i in range(len(col)):
            acc = rexth.add(acc, rexth.mul_base(eq[i], np.uint64(col[i])))
        return acc

    rlayout = rjagged.plan_layout([(8, 5), (32, 3)])
    arrs = [(8, rng.integers(0, bb.P, size=(5, 8)).astype(np.uint64)),
            (32, rng.integers(0, bb.P, size=(3, 32)).astype(np.uint64))]
    committed = rbasefold.commit(rjagged.stack_matrix(rlayout, arrs), params)
    z8 = rng.integers(0, bb.P, size=(3, 4)).astype(np.uint64)
    z32 = rng.integers(0, bb.P, size=(5, 4)).astype(np.uint64)
    rclaims = [rjagged.JaggedClaim(j, z8, mle_eval(arrs[0][1][j], z8)) for j in range(5)]
    rclaims += [rjagged.JaggedClaim(5 + j, z32, mle_eval(arrs[1][1][j], z32)) for j in range(3)]
    rproof = rjagged.open_jagged(committed, rlayout, rclaims, RTranscript(b"jagged-rec"), params)
    layout = interop.layout_from_dict(dataclasses.asdict(rlayout))
    claims = interop.claims_from_dicts([dataclasses.asdict(c) for c in rclaims])
    proof = interop.opening_from_dict(dataclasses.asdict(rproof))

    log_r = rlayout.n_r.bit_length() - 1
    ref = rR.build_jagged_verify_chips(log_r, len(rclaims))
    chips = R.build_jagged_verify_chips(log_r, len(claims))
    _same_chips(ref, chips)
    want = rR.assign_jagged_verify(ref, rlayout, rclaims, rproof, RTranscript(b"jagged-rec"))
    got = R.assign_jagged_verify(chips, layout, claims, proof, Transcript(b"jagged-rec"))
    _same_arrays(want, got)
    rows_w, claims_w, final_w, sc_cols = got
    sc2 = R.build_sumcheck_verify_chips(2, log_r)
    sc_wit = np.stack([np.asarray(sc_cols[name], np.uint64) % np.uint64(bb.P)
                       for name in sc2.rounds_cb.wit_names])
    sets = [_mkset(chips.rows_compiled, chips.rows_cb, rows_w),
            _mkset(chips.claims_compiled, chips.claims_cb, claims_w),
            _mkset(chips.final_compiled, chips.final_cb, final_w),
            _mkset(sc2.rounds_compiled, sc2.rounds_cb, sc_wit)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 1, chips.claims_cb, "value_1", 3),
                                       raise_on_error=False)
    assert MockProver.assert_satisfied(_tamper(sets, 0, chips.rows_cb, "z_0", 4),
                                       raise_on_error=False)


def test_class_main_verify_chips_equal_reference():
    rng = np.random.default_rng(43)
    rsc = rR.build_sumcheck_verify_chips(DEG, N_VARS)
    challenges = rng.integers(1, bb.P, size=(2, 4), dtype=np.uint64)
    wits = [_pad(rR.assign_sumcheck_verify(rsc, _sumchecks(rng, 1))[0]) for _ in range(2)]
    n = wits[0].shape[1]
    n_vars = n.bit_length() - 1
    zeros = np.zeros((0, n), np.uint64)
    tp = RTranscript(b"cm-rec")
    inputs = [rchip.build_tower_inputs(rsc.rounds_compiled, w, zeros, zeros, np.zeros(0),
                                       w.shape[1], challenges) for w in wits]
    rtower_proof, ctxs = rchip.prove_group_towers(inputs, tp)
    rclass, _ = rchip.prove_class_main(ctxs, np.zeros(0), challenges, tp)

    # each package verifies the towers with its own compiled chip and
    # transcript, then builds the class-main chips over its own contexts
    psc = R.build_sumcheck_verify_chips(DEG, N_VARS)
    rtv, tv = RTranscript(b"cm-rec"), Transcript(b"cm-rec")
    rv = [r[0] for r in rchip.verify_group_towers(
        [(rsc.rounds_compiled, n, n_vars)] * 2, rtower_proof, np.zeros(0), challenges, rtv)]
    pv = [r[0] for r in pchip.verify_group_towers(
        [(psc.rounds_compiled, n, n_vars)] * 2,
        interop.tower_proof_from_dict(dataclasses.asdict(rtower_proof)), np.zeros(0),
        challenges, tv)]
    ref, cm = rR.build_class_main_verify_chips(), R.build_class_main_verify_chips()
    _same_chips(ref, cm)
    want = rR.assign_class_main_verify(ref, rv, rclass, np.zeros(0), challenges, rtv)
    got = R.assign_class_main_verify(
        cm, pv, interop.class_main_from_dict(dataclasses.asdict(rclass)), np.zeros(0),
        challenges, tv)
    _same_arrays(want, got)
    pw, tw, sw, cw, fw, sc_cols, deg = got
    sc2 = R.build_sumcheck_verify_chips(deg, n_vars)
    sc_wit = np.stack([np.asarray(sc_cols[name], np.uint64) % np.uint64(bb.P)
                       for name in sc2.rounds_cb.wit_names])
    sets = [_mkset(cm.prod_compiled, cm.prod_cb, pw), _mkset(cm.term_compiled, cm.term_cb, tw),
            _mkset(cm.slot_compiled, cm.slot_cb, sw), _mkset(cm.chip_compiled, cm.chip_cb, cw),
            _mkset(cm.final_compiled, cm.final_cb, fw),
            _mkset(sc2.rounds_compiled, sc2.rounds_cb, sc_wit)]
    assert MockProver.assert_satisfied(sets) == []
    assert MockProver.assert_satisfied(_tamper(sets, 0, cm.prod_cb, "c_2", 1),
                                       raise_on_error=False)
    assert MockProver.assert_satisfied(_tamper(sets, 2, cm.slot_cb, "mult_0", 0),
                                       raise_on_error=False)


def _ec_verify_stage(pkg, proof, fsum, words):
    """One package's EC-sum quark verification in-circuit, from a recording
    chain that absorbed ``words`` and sampled the two RLC challenges: the
    rounds chip's columns, the EC and claim-link chip sets, the bound eq
    rows and the registry's challenge rows."""
    FSm, CLm, ECVm, Rm = pkg
    reg = FSm.FsRegistry()
    chain = FSm.ChainTranscript(b"ec-verify", registry=reg)
    chain.append(words)
    chal_cids = [chain.sample_ext_chal()[0] for _ in range(2)]
    sreg = CLm.ScalarRegistry(reg, chal_cids, np.zeros((2, 4), np.uint64),
                              np.asarray(fsum, np.uint64).ravel(), pv_map=lambda i: i)
    pv_cids = [[sreg.pv_cid(r * 7 + c) for c in range(7)] for r in range(2)]
    ec_col = ECVm.EcVerifyCollector(ECVm.EcVerifyChips())
    cl_col = CLm.ClaimLinkCollector(CLm.ClaimLinkChips())
    eqrows = Rm._EqRowsCollector()
    sc = ECVm.assign_ec_verify(ec_col, cl_col, chain.cursor(), proof, fsum, pv_cids, eqrows, reg)
    return sc, ec_col.emit() + cl_col.emit(), eqrows, reg


def test_ec_verify_chips_equal_reference():
    # the EC-sum quark of a tree of 8 points in 16 rows, proved by the port
    from ceno_tpu.gkr import claim_link as rCL
    from ceno_tpu.gkr import ec_verify as rECV
    from ceno_tpu.gkr.eccquark import EccQuarkProof as REccQuarkProof
    from ceno_tpu_torch.fields import septic as S
    from ceno_tpu_torch.gkr import claim_link as CL
    from ceno_tpu_torch.gkr import ec_verify as ECV
    from ceno_tpu_torch.gkr import eccquark as Q

    rng = np.random.default_rng(47)
    xs, ys = [], []
    while len(xs) < 8:
        trial = rng.integers(0, bb.P, size=(20, 7), dtype=np.uint32).astype(np.uint64)
        y, ok = S.from_x(trial)
        for i in np.nonzero(ok)[0][: 8 - len(xs)]:
            xs.append(trial[i])
            ys.append(y[i])
    x, y, s, final = Q.build_tree_witness(np.stack(xs), np.stack(ys), 16)
    words = rng.integers(0, bb.P, size=11, dtype=np.uint64)
    t = Transcript(b"ec-verify")
    t.append(words)
    t.sample_ext(), t.sample_ext()
    proof, _ = Q.prove_ec_sum(x, y, s, 8, final, t, device="cpu")
    fsum = np.asarray(final, np.uint64).reshape(2, 7)
    got = _ec_verify_stage((FS, CL, ECV, R), proof, fsum, words)
    want = _ec_verify_stage((rFS, rCL, rECV, rR), REccQuarkProof(**dataclasses.asdict(proof)),
                            fsum, words)
    assert sorted(got[0]) == sorted(want[0])
    for k in got[0]:
        assert np.array_equal(np.asarray(got[0][k], np.uint64),
                              np.asarray(want[0][k], np.uint64)), k
    assert [t[0] for t in got[1]] == [t[0] for t in want[1]]
    assert {"ecq_term2", "ecq_final", "ecq_sa_end", "ecq_byp", "ecq_exp"} <= \
        {t[0] for t in got[1]}
    for (name, c, cb, w, f), (_, rc, rcb, rw, rf) in zip(got[1], want[1]):
        assert chip_digest(c) == rchip_digest(rc), name
        assert np.array_equal(w, rw), name
        assert (f is None) == (rf is None) and (f is None or np.array_equal(f, rf)), name
    assert got[2].cid == want[2].cid
    assert np.array_equal(got[2].materialize_fixed(), want[2].materialize_fixed())
    assert [(c, s_, list(map(int, v))) for c, s_, v in got[3].chal_rows] == \
        [(c, s_, list(map(int, v))) for c, s_, v in want[3].chal_rows]
