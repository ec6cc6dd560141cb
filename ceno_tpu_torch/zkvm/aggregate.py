"""Aggregation witness builder (RECURSION.md build order #6, first slice).

Role mirror of the reference's recursion pipeline front-end
(ceno_recursion_v2: the shard verifier re-expressed as provable tables):
given a REAL shard ``ZKVMProof``, run the standard verifier with the
``capture`` hook (zkvm/scheme.py::verify) and replay every tower-group and
class-main stage through the recursion witgen mirrors (gkr/recursion.py),
producing bus-balanced chip witness sets that PROVE the verification of
those stages in this framework's own GKR stack.

Covered in-circuit (round 4 — the full verifier): grouped tower
verifications, class-batched main zerochecks, the jagged translation
argument with BOTH eq-chain coordinates challenge-bound, the record-claim
-> batched-claim link (gkr/claim_link.py: bc / slot multipliers / sel_eq /
sel_v / term scalars all derived, no free wires), the ENTIRE Fiat-Shamir
transcript (fs-chain duplex chips; statement absorbs pinned to the
aggregation pv, commitment roots and num_instances bound), and the PCS
query phase (gkr/pcs_verify.py: Merkle membership, fold consistency,
PoW, canonical query sampling), and the EC-sum quark verification
(gkr/ec_verify.py: the septic addition-tree zerocheck, its three analytic
selectors and the batched-constraint recombination). Every shard-verifier
stage is chip-ified.

Bus id allocation: tower group g gets SumcheckClaim ids in
[g*SC_STRIDE, (g+1)*SC_STRIDE) via the build-time sc_base; height class j
gets the single id CLASS_SC_BASE + j. TowerClaim ids are the global group
index; class-main chain ids (term/slot/chip) are allocated contiguously
across classes.

Counterpart of ``ceno_tpu/zkvm/aggregate.py``, with the same witness
builders, key, transcript order and proof objects. The witness builders and
the verifiers are host numpy, as in the reference; :func:`prove_chipset`
runs its commit, towers, class mains and opening on ``device`` (the card
unless the caller names another), as ``zkvm/scheme.prove`` does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..gkr import chip as chiplib
from ..hash.transcript import Transcript
from ..pcs import basefold, jagged
from ..gkr import recursion as R
from ..utils import spans
from . import scheme
from .layout import (
    N_PUBLIC_VALUES as N_PV, PV_SHARD_ID, PV_RW_SUM_IN, PV_RW_SUM_OUT,
    PV_HEAP_WORDS, PV_STACK_WORDS, PV_INFO_WORDS,
)

SC_STRIDE = 4096            # per-tower-group SumcheckClaim id block
CLASS_SC_BASE = 1 << 24     # class-main SumcheckClaim ids start here

# Aggregation transcript domain: separate from the shard scheme LABEL so an
# aggregation proof can never be replayed as a shard proof.
LABEL_AGG = scheme.LABEL + b"/agg-v1"


# Multi-shard chain placement: each verified proof's transcript chain gets a
# disjoint duplex-step range. Duplex slot keys go up to 8*(chain_end)+15, so
# they stay < BabyBear P only while the LAST chain's steps stay below
# (P - 16) / 8: with STEP_STRIDE = 2^22 that caps an aggregation at 59
# chains (NOT 64 — a 60th shard's keys would wrap mod P and alias shard 0's
# slot space, a silent soundness break). build_aggregation_witness_multi
# enforces both the chain-count cap and the per-chain step budget.
STEP_STRIDE = 1 << 22
MAX_CHAINS = 59  # (P - 16) // (8 * STEP_STRIDE)
# Jagged-stage bus namespaces (ids must clear the tower/class blocks)
JAG_SC_BASE = 1 << 26      # SumcheckClaim id of opening o = JAG_SC_BASE + o
JAG_EQ_BASE = 1 << 26      # EqChain cids: JAG_EQ_BASE + o*JAG_EQ_STRIDE + t
JAG_EQ_STRIDE = 1 << 16


def _ec_point_cids(ecp, ec_sc, z_cid_map: dict, reg) -> None:
    """Fill the jagged z-cid map for the EC extended points from the
    zerocheck's registered round-challenge cids (ec_sc['acid'])."""
    n = ecp.n_vars
    acids = [int(a) for a in ec_sc["acid"]]
    point_cids = acids[::-1]
    chals = np.stack([
        np.array([ec_sc[f"alpha_{j}"][r] for j in range(4)], np.uint64)
        for r in range(n)
    ])
    rt = chals[::-1].copy()
    pts = scheme._ec_extended_points(rt)
    czero = reg.const_cid(np.zeros(4, np.uint64))
    cone = reg.const_cid(exth.one())
    cid_lists = {
        "even": [czero] + point_cids,
        "odd": [cone] + point_cids,
        "hi": point_cids + [cone],
    }
    for name, pt in pts.items():
        z_cid_map[np.ascontiguousarray(pt, np.uint64).tobytes()] = \
            cid_lists[name]


def build_aggregation_witness(vk, proof, fs: bool = False, **verify_kwargs):
    """Verify ``proof`` (raising on any failure) and return the in-circuit
    verification witness, bus-balanced as a whole, plus a summary dict.

    ``fs=False``: a list of (name, compiled, cb, wit) chip sets where the
    stage challenges are free witness wires the outer statement binds.

    ``fs=True`` (the full Fiat-Shamir-bound aggregation): the verify runs on
    a recording ``ChainTranscript`` (gkr/fs_chain.py), the returned sets are
    (name, compiled, cb, wit, fixed|None) and additionally contain the
    fs-chain chips — the WHOLE transcript (every Poseidon2 permutation) is
    proven in-circuit, every stage challenge is derived from it (challenge-
    table / pow-chain lookups under committed fixed cids), every stage
    absorb the mirrored stages perform is supplied by the consuming rows,
    and the chain's leading absorbs are pinned to the aggregation public
    values (vk digest ++ shard pv) by the pv-supply chip."""
    return build_aggregation_witness_multi(vk, [(proof, verify_kwargs)],
                                           fs=fs)


def build_aggregation_witness_multi(vk, proof_specs: list, fs: bool = False,
                                    verify_fn=None, label: bytes | None = None,
                                    digest_len: int | None = None,
                                    params=None):
    """Multi-proof aggregation witness: verify EVERY (proof, verify_kwargs)
    in ``proof_specs`` and emit one bus-balanced chip-set list covering all
    of them. Same-shape chip families (sumcheck rounds per degree, eq1
    chains, the class-main chains, the fs-chain chips) are merged across
    proofs; tower-group chips stay per (proof, group). Bus namespaces:
    proof p's tower group g gets global group index G (sequential), its
    chain (fs) lives at duplex steps [p*STEP_STRIDE, ...).

    ``verify_fn(proof, capture, transcript, **kwargs)`` overrides the
    default shard verifier (scheme.verify against ``vk``) — with
    ``label``/``digest_len`` matching the override's transcript label and
    statement-digest length, an AGGREGATION proof itself verifies through
    here (verify_chipset hooks), closing the pairwise aggregation tree."""
    from ..gkr import fs_chain as FS

    if fs and len(proof_specs) > MAX_CHAINS:
        raise AggError(
            f"at most {MAX_CHAINS} proofs per FS-bound aggregation "
            f"(duplex slot keys would wrap mod P); aggregate in a tree"
        )
    if verify_fn is None:
        def verify_fn(proof, cap, transcript, **kwargs):
            return scheme.verify(vk, proof, capture=cap,
                                 transcript=transcript, **kwargs)
    if label is None:
        label = scheme.LABEL
    if digest_len is None:
        digest_len = len(vk.digest_elems())
    if params is None and vk is not None:
        params = vk.params

    caps = []
    chains = []
    shared_reg = FS.FsRegistry() if fs else None
    for p, (proof, verify_kwargs) in enumerate(proof_specs):
        cap: dict = {}
        if fs:
            chain = FS.ChainTranscript(label, registry=shared_reg,
                                       step_base=p * STEP_STRIDE)
            verify_fn(proof, cap, chain, **verify_kwargs)
            # global RLC challenges alpha/beta: registered on the challenge
            # table (scalar-eval leaves + pow chains bind against them)
            pre = cap["pre_challenges"]
            cid_a, _ = pre.sample_ext_chal()
            cid_b, _ = pre.sample_ext_chal()
            cap["chal_cids"] = (cid_a, cid_b)
            chains.append(chain)
        else:
            verify_fn(proof, cap, None, **verify_kwargs)
        caps.append(cap)

    sets = []                  # (name, compiled, cb, wit[, fixed])
    rounds_by_deg: dict = {}   # deg -> [wit matrices to concat]
    rounds_fixed_by_deg: dict = {}
    rounds_cb_by_deg: dict = {}
    eqrows_wits: list = []     # eq1-chain rows, merged into one chip set
    eqrows_fixed: list = []
    eqrows_chip = None
    jag_eq_wits: list = []     # jagged eq1 chains, merged
    jag_eq_fixed: list = []
    jag_eq_chip = None
    jag_global = 0
    # PCS query-phase chips (FS mode, jagged-basefold params): shared
    # collector across all openings of all proofs
    pcs_col = None
    bind_eqrows = None
    pcs_on = bool(fs and params is not None and params.jagged
                  and params.pcs_kind == "basefold")
    cl_col = None
    ec_col = None
    scalar_regs = []
    if fs:
        from ..gkr import claim_link as CL

        bind_eqrows = R._EqRowsCollector()
        cl_col = CL.ClaimLinkCollector(CL.ClaimLinkChips())
    if pcs_on:
        from ..gkr import pcs_verify as PV

        pcs_col = PV.PcsCollector(PV.build_pcs_verify_chips(params.pow_bits))
    PCS_SC_BASE = 1 << 27      # opening sumcheck / eq-chain id namespace

    def emit(name, compiled, cb, wit, fixed=None):
        if fs:
            sets.append((name, compiled, cb, wit, fixed))
        else:
            sets.append((name, compiled, cb, wit))

    def add_rounds(deg, cols, n_rows):
        sc = rounds_cb_by_deg.get(deg)
        if sc is None:
            sc = R.build_sumcheck_verify_chips(deg, 1, bind=fs)
            rounds_cb_by_deg[deg] = sc
        wit = np.zeros((len(sc.rounds_cb.wit_names), n_rows), np.uint64)
        for j, name in enumerate(sc.rounds_cb.wit_names):
            wit[j] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)
        rounds_by_deg.setdefault(deg, []).append(wit)
        if fs:
            rounds_fixed_by_deg.setdefault(deg, []).append(np.array(
                [cols["aidx"], cols["acid"]], np.uint64))

    # -- tower groups (global group index across proofs) -----------------------
    cm = R.build_class_main_verify_chips(bind=fs)
    cm_wits = {k: [] for k in ("prod", "term", "slot", "chip", "final")}
    cm_fixed = {"prod": [], "chip": [], "term": []}
    tid = sid = cidx = 0
    g_global = 0
    class_global = 0
    for p, cap in enumerate(caps):
        z_cid_map: dict = {}   # claim-point bytes -> list of challenge cids
        scalar_reg = None
        if fs:
            from ..gkr import claim_link as CL

            n_pv = len(cap["pv"])
            scalar_reg = CL.ScalarRegistry(
                shared_reg, cap["chal_cids"], cap["challenges"], cap["pv"],
                pv_map=lambda i, _p=p, _n=n_pv: digest_len + _p * _n + i,
                nid_base=p << 20,
            )
            scalar_regs.append(scalar_reg)
        for gi, (n_t, entries, tproof, tstate) in enumerate(
                cap.get("towers", [])):
            g = g_global
            g_global += 1
            rho = chiplib.interleave_geometry(entries[0][0])[0]
            n_tv = entries[0][2] + rho
            s_p = tproof.prod_out.shape[0]
            s_l = tproof.logup_out.shape[0]
            sc_base = g * SC_STRIDE - g * n_tv  # ids = g*SC_STRIDE + level
            chips = R.build_tower_verify_chips(s_p, s_l, n_tv,
                                               sc_base=sc_base, bind=fs)
            fx: dict = {}
            rw, bw, qw, ew, rec_claims = R.assign_tower_verify(
                chips, [tproof], tstate, inst0=g, fixed_out=fx)
            if fs:
                CL.link_tower_group(
                    cl_col, tstate, entries, rec_claims,
                    fx["rt"][0], fx["rt_cids"][0], g,
                    cap["tower_vctxs"][gi],
                )
            if rw.shape[1]:
                sc_cols = {name: rw[j] for j, name in
                           enumerate(chips.rounds_cb.wit_names)}
                if fs:
                    sc_cols["aidx"] = fx["rounds"][0]
                    sc_cols["acid"] = fx["rounds"][1]
                add_rounds(3, sc_cols, rw.shape[1])
            if bw.shape[1]:
                emit(f"tower_g{g}_bounds", chips.bound_compiled,
                     chips.bound_cb, bw, fx.get("bound"))
            if qw.shape[1]:
                eqrows_wits.append(qw)
                if fs:
                    eqrows_fixed.append(fx["eqrows"])
                eqrows_chip = (chips.eqrows_compiled, chips.eqrows_cb)
            emit(f"tower_g{g}_ends", chips.ends_compiled,
                 chips.ends_cb, ew, fx.get("ends"))

        # -- class mains (global class index; shared chain chips) --------------
        for (h, vctxs, cproof, tstate) in cap.get("class_main", []):
            j = class_global
            class_global += 1
            fx = {}
            cidx_base = cidx
            pw, tw, sw, cw, fw, sc_cols, deg = R.assign_class_main_verify(
                cm, vctxs, cproof, cap["pv"], cap["challenges"], tstate,
                class_id=CLASS_SC_BASE + j, tid0=tid, sid0=sid, cidx0=cidx,
                fixed_out=fx, scalar_reg=scalar_reg,
            )
            tid += tw.shape[1]
            sid += sw.shape[1]
            cidx += cw.shape[1]
            if fs:
                z_cid_map[np.ascontiguousarray(
                    fx["point"], np.uint64).tobytes()] = fx["point_cids"]
                for i, v in enumerate(vctxs):
                    CL.link_class_chip(
                        cl_col, v, cidx_base + i, fx["chip_sid0"][i],
                        fx["point"], fx["point_cids"], bind_eqrows,
                        shared_reg,
                    )
            for key, w in (("prod", pw), ("term", tw), ("slot", sw),
                           ("chip", cw), ("final", fw)):
                cm_wits[key].append(w)
            if fs:
                cm_fixed["prod"].append(fx["prod"])
                cm_fixed["chip"].append(fx["chips"])
                cm_fixed["term"].append(fx["terms"])
            add_rounds(deg, sc_cols, vctxs[0].n_vars)

        if fs:
            # EC-sum quark verification in-circuit (gkr/ec_verify.py): the
            # zerocheck rides the shared deg-3 rounds chip, the selector
            # recurrences/one-hots become chains, the recombination walks
            # the key term schedule; the stage's challenges also land on
            # the table so the jagged claims at the EC extended points
            # bind their coordinates.
            for (_name, ecp, _fsum, pv_base, tstate) in cap.get("ec", []):
                if ec_col is None:
                    from ..gkr import ec_verify as ECV

                    ec_col = ECV.EcVerifyCollector(ECV.EcVerifyChips())
                fsum_pv_cids = [
                    [scalar_reg.pv_cid(pv_base + r * 7 + c)
                     for c in range(7)] for r in range(2)
                ]
                ec_sc = ECV.assign_ec_verify(
                    ec_col, cl_col, tstate, ecp, _fsum, fsum_pv_cids,
                    bind_eqrows, shared_reg,
                )
                add_rounds(3, ec_sc, ecp.n_vars)
                _ec_point_cids(ecp, ec_sc, z_cid_map, shared_reg)
            # commitment-root + num_instances absorb binding
            chain = chains[p]
            jag_caps = cap.get("jagged", [])
            if jag_caps and jag_caps[0][4][0] == "absorbed" \
                    and "wit_root_slots" in cap:
                root = np.asarray(jag_caps[0][4][1], np.uint64)
                slots = cap["wit_root_slots"]
                rc0 = chain.register_absorbed_ext(slots[0], root[:4])
                rc1 = chain.register_absorbed_ext(slots[4], root[4:])
                cap["_root_cids"] = (rc0, rc1)
            if pcs_on and "ninst_slots" in cap:
                ninst = proof_specs[p][0].num_instances
                for slot, k in zip(cap["ninst_slots"], ninst):
                    cid = chain.register_absorbed_base(slot, int(k) % bb.P)
                    shared_reg.use(cid)
                    pcs_col.w["cbind"].add(d=0)
                    pcs_col.f["cbind"].add(cid=cid, val=int(k) % bb.P)

        # -- jagged translation stages (one per opening, in verify order) -------
        for (jl, jclaims, jopening, tstate, root_info) in cap.get("jagged",
                                                                  []):
            jid = JAG_SC_BASE + jag_global
            cidb = JAG_EQ_BASE + jag_global * JAG_EQ_STRIDE
            log_r = jl.n_r.bit_length() - 1
            jchips = R.build_jagged_verify_chips(log_r, len(jclaims),
                                                 bind=fs)
            fx = {}
            rows_w, claims_w, final_w, sc_cols = R.assign_jagged_verify(
                jchips, jl, jclaims, jopening, tstate,
                jid=jid, cid_base=cidb, fixed_out=fx,
                z_cid_map=z_cid_map if fs else None,
            )
            jag_eq_wits.append(rows_w)
            if fs:
                jag_eq_fixed.append(fx["rows"])
            jag_eq_chip = (jchips.rows_compiled, jchips.rows_cb)
            emit(f"jag_{jag_global}_claims", jchips.claims_compiled,
                 jchips.claims_cb, claims_w, fx.get("claims"))
            emit(f"jag_{jag_global}_final", jchips.final_compiled,
                 jchips.final_cb, final_w)
            add_rounds(2, sc_cols, log_r)
            if pcs_on:
                # the PCS query phase of this opening, in-circuit
                from ..gkr import pcs_verify as PV

                geo = PV.PcsGeo(
                    n_vars=log_r, n_cols=jl.n_mat_cols,
                    blowup_log=params.blowup_log,
                    stop_size=params.stop_size,
                    pow_bits=params.pow_bits,
                    n_queries=params.n_queries,
                )
                if root_info[0] == "absorbed":
                    root_bind = ("lk", cap["_root_cids"])
                else:
                    root_bind = ("fixed",
                                 np.asarray(root_info[1], np.uint64))
                osc = PCS_SC_BASE + jag_global
                psc = PV.assign_pcs_query_verify(
                    pcs_col, geo, jopening.opening,
                    np.asarray(jopening.v_evals, np.uint64),
                    fx["vcids"], fx["point_cids"],
                    np.asarray(fx["point"], np.uint64),
                    root_bind, tstate, bind_eqrows, osc,
                )
                add_rounds(2, psc, log_r)
            jag_global += 1
    for key, cbn, compiled in (
        ("prod", cm.prod_cb, cm.prod_compiled),
        ("term", cm.term_cb, cm.term_compiled),
        ("slot", cm.slot_cb, cm.slot_compiled),
        ("chip", cm.chip_cb, cm.chip_compiled),
        ("final", cm.final_cb, cm.final_compiled),
    ):
        if cm_wits[key]:
            wit = np.concatenate(cm_wits[key], axis=1)
            if wit.shape[1]:
                fixed = None
                if fs and key in cm_fixed:
                    fixed = np.concatenate(cm_fixed[key], axis=1)
                emit(f"cm_{key}", compiled, cbn, wit, fixed)

    # -- merged eq1-chain rows chips ------------------------------------------
    if fs and bind_eqrows.cid:
        # the PCS / claim-link eq chains share the bound eq-rows chip
        if eqrows_chip is None:
            ecb, ecomp = R.build_eq_rows_chip(bind=True)
            eqrows_chip = (ecomp, ecb)
        eqrows_wits.append(bind_eqrows.materialize(eqrows_chip[1]))
        eqrows_fixed.append(bind_eqrows.materialize_fixed())
    if eqrows_wits:
        emit("eq_rows", eqrows_chip[0], eqrows_chip[1],
             np.concatenate(eqrows_wits, axis=1),
             np.concatenate(eqrows_fixed, axis=1) if fs else None)
    if jag_eq_wits:
        emit("jag_eq_rows", jag_eq_chip[0], jag_eq_chip[1],
             np.concatenate(jag_eq_wits, axis=1),
             np.concatenate(jag_eq_fixed, axis=1) if fs else None)
    if pcs_on:
        for pset in pcs_col.emit():
            sets.append(pset)
    if fs:
        for cset in cl_col.emit():
            sets.append(cset)
        if ec_col is not None:
            for cset in ec_col.emit():
                sets.append(cset)
        for sr in scalar_regs:
            for cset in sr.emit(cl_col.chips):
                sets.append(cset)

    # -- merged sumcheck rounds chips (one per degree) --------------------------
    for deg, wits in sorted(rounds_by_deg.items()):
        sc = rounds_cb_by_deg[deg]
        emit(f"sc_rounds_d{deg}", sc.rounds_compiled,
             sc.rounds_cb, np.concatenate(wits, axis=1),
             np.concatenate(rounds_fixed_by_deg[deg], axis=1) if fs else None)

    # -- the fs-chain chips: duplex rows, suppliers, challenge tables, pows ----
    if fs:
        n_digest = digest_len
        n_pv = len(caps[0]["pv"])
        if any(len(c["pv"]) != n_pv for c in caps):
            raise AggError("aggregated proofs must share a pv length")
        fs_chips = FS.build_fs_chain_chips()
        chain_sets: dict = {}    # name -> ([wit], [fixed])
        for p, chain in enumerate(chains):
            pv_indices = (list(range(n_digest))
                          + list(range(n_digest + p * n_pv,
                                       n_digest + (p + 1) * n_pv)))
            # the chip absorbs digest then pv: indices relative to agg pv
            pv_cb, pv_compiled = FS.build_pv_supply_chip(
                label, n_digest + n_pv,
                inst_indices=pv_indices, step_base=chain.step_base,
            )
            pv_wit = FS.assign_pv_supply(chain, n_digest + n_pv)
            name = "fs_pv" if len(chains) == 1 else f"fs_pv_s{p}"
            sets.append((name, pv_compiled, pv_cb, pv_wit, None))
            for name, compiled, cb, wit, fixed in chain.finalize_chain(
                    fs_chips):
                w, f = chain_sets.setdefault(name, ([], [], compiled, cb))[:2]
                w.append(wit)
                f.append(fixed)
            if chain._step - chain.step_base >= STEP_STRIDE:
                raise AggError(
                    f"chain {p} used {chain._step - chain.step_base} duplex "
                    f"steps (>= STEP_STRIDE {STEP_STRIDE}): slot keys would "
                    f"collide with the next chain's namespace"
                )
        for name, (wits, fixeds, compiled, cb) in chain_sets.items():
            wit = np.concatenate(wits, axis=1)
            fixed = (np.concatenate(fixeds, axis=1)
                     if fixeds[0] is not None else None)
            sets.append((name, compiled, cb, wit, fixed))
        for name, compiled, cb, wit, fixed in FS.finalize_registry(
                fs_chips, shared_reg):
            sets.append((name, compiled, cb, wit, fixed))

    summary = {
        "proofs": len(proof_specs),
        "tower_groups": g_global,
        "classes": class_global,
        "jagged_openings": jag_global,
        "chip_sets": len(sets),
        "rows": int(sum(s[3].shape[1] for s in sets)),
    }
    return sets, summary

# ---------------------------------------------------------------------------
# Aggregation scheme: prove/verify the verifier-chip witness through the
# SAME GKR + jagged-PCS stack the shard prover uses (RECURSION.md build
# order #6, second slice). Role mirror of the recursion VM's proving step
# (ceno_recursion_v2: the shard-verifier tables are themselves proven).
#
# An aggregation proof commits ALL verifier-chip witness columns in ONE
# jagged commitment, proves every chip's read/write multisets with grouped
# towers, every height class with one batched zerocheck, and opens the
# column claims through the jagged PCS — exactly the shard pipeline minus
# fixed columns / EC chips / shard gating. ``AggKey`` (the chip list) is
# a deterministic function of (shard vk, params, the proof's public
# geometry): the verifier RECONSTRUCTS it (expected_agg_key, via
# zkvm/skeleton.py structure replay) instead of trusting a prover-supplied
# key — the same trust the reference's recursion verifier places in its
# fixed compiled recursion program's verifying key.
# ---------------------------------------------------------------------------


@dataclass
class AggChip:
    name: str
    compiled: object
    cb: object
    wit: np.ndarray        # (n_wit, N) canonical, padded pow2
    num_instances: int
    fixed: np.ndarray | None = None   # (n_fixed, N) canonical schedule cols

    @property
    def n_rows(self) -> int:
        return self.wit.shape[1]

    def fixed_mat(self) -> np.ndarray:
        if self.fixed is None:
            return np.zeros((0, self.n_rows), np.uint64)
        f = np.asarray(self.fixed, np.uint64)
        if f.shape[1] < self.n_rows:
            f = np.pad(f, ((0, 0), (0, self.n_rows - f.shape[1])))
        return f


@dataclass
class AggKey:
    chips: list            # [(name, compiled, cb, fixed|None)] in set order
    params: object         # BasefoldParams

    def digest_elems(self) -> np.ndarray:
        """Binding commitment to the key: every chip's FULL compiled
        constraint system (gkr.chip.chip_digest — name, wit/fixed counts,
        structural specs, all record/lookup/slot expressions), its fixed
        schedule columns, AND the PCS params (blowup/queries/pow — the
        security level). A same-shaped key with one altered slot expression
        or weakened n_queries digests differently, so an outer layer that
        pins this digest pins the circuits (mirrors
        ceno_recursion_v2's root circuit, mod.rs:20 child_vk_pre_hash)."""
        import hashlib

        from ..gkr.chip import chip_digest

        parts = [np.uint64(len(self.chips))]
        h = hashlib.sha256()
        p = self.params
        h.update(repr((
            int(p.blowup_log), int(p.n_queries), int(p.pow_bits),
            int(p.stop_size), bool(p.jagged), str(p.pcs_kind),
        )).encode())
        for name, compiled, cb, fixed in self.chips:
            parts.append(np.uint64(compiled.n_wit))
            parts.append(np.uint64(len(compiled.slots)))
            h.update(name.encode())
            h.update(chip_digest(compiled).encode())
            if fixed is not None:
                # the fixed schedule columns are key material: commit them
                h.update(np.ascontiguousarray(fixed, np.uint64).tobytes())
        d = h.digest()
        parts.extend(
            np.frombuffer(d, np.uint32).astype(np.uint64) % np.uint64(bb.P)
        )
        return np.array(parts, np.uint64)


@dataclass
class ShardGeometry:
    """Public geometry of one verified shard proof: everything (besides the
    vk, params and the shard pv — all in the aggregation statement) that
    the verifier-circuit chip set depends on. Prover-supplied, like a shard
    proof's num_instances: any value parameterizes HONEST verifier circuits
    of that shape, so lying about it only changes WHICH statement the
    aggregation attests — which stays pinned by the vk digest + pv."""

    num_instances: list
    is_first: bool = True
    is_last: bool = True
    standalone: bool = True


@dataclass
class AggProof:
    public_values: np.ndarray
    num_instances: list
    witness_root: np.ndarray
    tower_groups: dict     # n_t -> tower.TowerProof
    class_main: dict       # height -> chiplib.ClassMainProof
    witness_opening: object  # jagged opening proof
    # public geometry for verifier-side key reconstruction
    # (expected_agg_key): [ShardGeometry] per verified shard proof, or
    # ("chipset", inner_num_instances) for a level-2 tree proof
    geometry: object = None


class AggError(Exception):
    pass


def _pad_pow2(m: np.ndarray) -> np.ndarray:
    k = m.shape[1]
    n = max(2, 1 << max(0, (k - 1).bit_length()))
    if k < n:
        m = np.pad(m, ((0, 0), (0, n - k)))
    return m


def _agg_layout(chips: list):
    """Group chips by padded height: h -> [(idx, col_off, n_wit)]."""
    layout: dict = {}
    for i, c in enumerate(chips):
        h = c.n_rows if isinstance(c, AggChip) else c[1]
        off = sum(e[2] for e in layout.get(h, []))
        n_wit = (c.compiled.n_wit if isinstance(c, AggChip)
                 else c[0].n_wit)
        layout.setdefault(h, []).append((i, off, n_wit))
    return layout


def _agg_jagged_claims(layout: dict, slice_base: dict, openings: list):
    claims = []
    for h in sorted(layout):
        for i, off, ncols in layout[h]:
            for j in range(ncols):
                claims.append(jagged.JaggedClaim(
                    slice_base[i] + j, openings[i].point,
                    openings[i].wit_evals[j],
                ))
    return claims


def prove_chipset(chips: list, public_values: np.ndarray, params,
                  device=None) -> AggProof:
    """Prove an arbitrary bus-balanced chip set (the generic GKR chipset
    scheme): jagged commit -> challenges -> grouped towers -> class-batched
    main zerochecks -> jagged open. Mirrors zkvm/scheme.py::prove with the
    zkVM-specific stages removed; the device work runs on ``device`` (the
    card by default)."""
    device = device or DEFAULT_DEVICE
    t = Transcript(LABEL_AGG)
    pv = np.asarray(public_values, np.uint64)
    t.append(AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips],
                    params).digest_elems())
    t.append(pv)

    layout = _agg_layout(chips)
    jl, slice_base = scheme._jagged_plan(
        {h: [(i, off, n) for i, off, n in layout[h]] for h in layout}
    )
    mat = jagged.stack_matrix(
        jl, [(h, np.concatenate([chips[i].wit for i, _, _ in layout[h]],
                                axis=0))
             for h in sorted(layout)]
    )
    with spans.span(f"agg/commit/jagged-2^{jl.n_r.bit_length() - 1}"):
        committed = basefold.commit(mat, params, device=device)
    t.append(committed.root)
    for c in chips:
        t.append([c.num_instances % bb.P])

    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)

    inputs = []
    with spans.span("agg/records"):
        for c in chips:
            n = c.n_rows
            structural = np.zeros((0, n), np.uint64)
            inputs.append(chiplib.build_tower_inputs(
                c.compiled, c.wit, c.fixed_mat(), structural, pv,
                c.num_instances, challenges, device=device,
            ))

    group_members: dict = {}
    for i, ti in enumerate(inputs):
        group_members.setdefault(ti.n_tower, []).append(i)
    ctxs = [None] * len(chips)
    tower_groups = {}
    for n_t in sorted(group_members):
        members = group_members[n_t]
        with spans.span("agg/towers"):
            gproof, gctxs = chiplib.prove_group_towers(
                [inputs[i] for i in members], t
            )
        tower_groups[n_t] = gproof
        for i, ctx in zip(members, gctxs):
            ctxs[i] = ctx

    class_main = {}
    openings = [None] * len(chips)
    for h in sorted(layout):
        members = [i for i, _, _ in layout[h]]
        with spans.span(f"agg/class-main/2^{h.bit_length() - 1}"):
            cmp_proof, opens = chiplib.prove_class_main(
                [ctxs[i] for i in members], pv, challenges, t
            )
        class_main[h] = cmp_proof
        for i, op in zip(members, opens):
            openings[i] = op

    claims = _agg_jagged_claims(layout, slice_base, openings)
    with spans.span("agg/open/jagged"):
        opening = jagged.open_jagged(committed, jl, claims, t, params)
    return AggProof(
        pv, [c.num_instances for c in chips], committed.root,
        tower_groups, class_main, opening,
    )


def verify_chipset(key: AggKey, proof: AggProof, *,
                   capture: dict | None = None, transcript=None) -> bool:
    """Verify a generic chipset proof: transcript replay, grouped tower
    verification, global read-write product + logup-sum checks, class main
    recombination, jagged PCS verify.

    ``capture``/``transcript`` mirror scheme.verify's aggregation hooks, so
    an aggregation proof can itself be aggregated (pairwise tree closure):
    each tower-group / class-main stage records its inputs + a transcript
    clone, and a recording ChainTranscript can replace the fresh
    Transcript(LABEL_AGG)."""
    if len(proof.num_instances) != len(key.chips):
        raise AggError("chip count mismatch")
    t = transcript if transcript is not None else Transcript(LABEL_AGG)
    pv = np.asarray(proof.public_values, np.uint64)
    t.append(key.digest_elems())
    t.append(pv)

    heights = []
    for (name, compiled, cb, fixed), k in zip(key.chips, proof.num_instances):
        if k <= 0:
            raise AggError(f"{name}: empty chip in aggregation proof")
        heights.append(max(2, 1 << max(0, (int(k) - 1).bit_length())))
    entries_all = [
        (compiled, int(k), h.bit_length() - 1)
        for (name, compiled, cb, fixed), k, h in zip(
            key.chips, proof.num_instances, heights)
    ]
    layout: dict = {}
    for i, h in enumerate(heights):
        off = sum(e[2] for e in layout.get(h, []))
        layout.setdefault(h, []).append((i, off, key.chips[i][1].n_wit))
    jl, slice_base = scheme._jagged_plan(layout)

    if capture is not None and hasattr(t, "absorb_slots_of_next"):
        capture["wit_root_slots"] = t.absorb_slots_of_next(8)
    t.append(proof.witness_root)
    if capture is not None and hasattr(t, "absorb_slots_of_next"):
        capture["ninst_slots"] = [
            t.absorb_slots_of_next(i + 1)[i]
            for i in range(len(proof.num_instances))
        ]
    for k in proof.num_instances:
        t.append([int(k) % bb.P])
    if capture is not None:
        capture["pre_challenges"] = t.clone()
    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)
    if capture is not None:
        capture["challenges"] = challenges
        capture["pv"] = pv

    group_members: dict = {}
    for i, (compiled, k, n_vars) in enumerate(entries_all):
        rho, _, _, _ = chiplib.interleave_geometry(compiled)
        group_members.setdefault(heights[i] << rho, []).append(i)
    if set(proof.tower_groups) != set(group_members):
        raise AggError("tower group size set mismatch")

    prod_r = exth.one()
    prod_w = exth.one()
    logup_num = np.zeros(4, np.uint64)
    logup_den = exth.one()
    vctxs = [None] * len(key.chips)
    for n_t in sorted(group_members):
        members = group_members[n_t]
        if capture is not None:
            capture.setdefault("towers", []).append(
                (n_t, [entries_all[i] for i in members],
                 proof.tower_groups[n_t], t.clone())
            )
        results = chiplib.verify_group_towers(
            [entries_all[i] for i in members],
            proof.tower_groups[n_t], pv, challenges, t,
        )
        if capture is not None:
            capture.setdefault("tower_vctxs", []).append(
                [r[0] for r in results]
            )
        for i, (vctx, prod_values, logup_fracs) in zip(members, results):
            compiled = key.chips[i][1]
            vctxs[i] = vctx
            pi = 0
            if compiled.r_exprs:
                prod_r = exth.mul(prod_r, prod_values[pi])
                pi += 1
            if compiled.w_exprs:
                prod_w = exth.mul(prod_w, prod_values[pi])
                pi += 1
            for s in range(logup_fracs.shape[0]):
                p, q = logup_fracs[s]
                logup_num = exth.add(
                    exth.mul(logup_num, q), exth.mul(p, logup_den)
                )
                logup_den = exth.mul(logup_den, q)

    from ..utils import replay as _replay

    if not _replay.structure_only():
        if not np.array_equal(prod_r, prod_w):
            raise AggError("global read/write product mismatch")
        if logup_num.any():
            raise AggError("global logup sum is nonzero")

    if set(proof.class_main) != set(layout):
        raise AggError("class main height set mismatch")
    openings = [None] * len(key.chips)
    for h in sorted(layout):
        members = [i for i, _, _ in layout[h]]
        if capture is not None:
            capture.setdefault("class_main", []).append(
                (h, [vctxs[i] for i in members], proof.class_main[h],
                 t.clone())
            )
        opens = chiplib.verify_class_main(
            [vctxs[i] for i in members], proof.class_main[h],
            pv, challenges, t,
        )
        for i, op in zip(members, opens):
            openings[i] = op

    # fixed schedule columns are KEY material (not committed): their claimed
    # evals must equal the key columns' MLE at the class opening point
    from ..sumcheck import host_impl as H

    for i, (name, compiled, cb, fixed) in enumerate(key.chips):
        if compiled.n_fixed == 0:
            continue
        if fixed is None:
            raise AggError(f"{name}: key is missing fixed columns")
        op = openings[i]
        f = np.asarray(fixed, np.uint64)
        h = heights[i]
        if f.shape != (compiled.n_fixed, f.shape[1]) or f.shape[1] > h:
            raise AggError(f"{name}: fixed column shape mismatch")
        eqv = H.build_eq_host(np.asarray(op.point, np.uint64))  # (h, 4)
        if eqv.shape[0] != h:
            raise AggError(f"{name}: fixed eval point arity mismatch")
        for j in range(compiled.n_fixed):
            col = np.zeros(h, np.uint64)
            col[: f.shape[1]] = f[j]
            expect = np.sum((eqv * col[:, None]) % np.uint64(bb.P),
                            axis=0) % np.uint64(bb.P)
            if not np.array_equal(np.asarray(op.fixed_evals[j], np.uint64),
                                  expect) and not _replay.structure_only():
                raise AggError(f"{name}: fixed column {j} eval mismatch")

    claims = _agg_jagged_claims(layout, slice_base, openings)
    if capture is not None:
        capture.setdefault("jagged", []).append(
            (jl, claims, proof.witness_opening, t.clone(),
             ("absorbed", proof.witness_root))
        )
    jagged.verify_jagged(
        proof.witness_root, jl, claims, proof.witness_opening, t, key.params,
    )
    return True


def prove_aggregation(vk, proof, params=None, fs: bool = True, device=None,
                      **verify_kwargs):
    """Build the aggregation witness from a REAL shard proof (verifying it
    in the process) and prove it through the chipset scheme. Returns
    (AggKey, AggProof). Public values bind the shard vk digest + the
    shard's public values; with ``fs=True`` (default) the whole shard-verify
    transcript is re-proven in-circuit and the fs-pv chip pins the chain's
    statement absorbs to those public values. The witness is built on the
    host, the proof on ``device`` (the card by default)."""
    with spans.span("agg/witness"):
        sets, summary = build_aggregation_witness(vk, proof, fs=fs,
                                                  **verify_kwargs)
    chips = _agg_chips_from_sets(sets, fs)
    pv = np.concatenate([
        vk.digest_elems() % np.uint64(bb.P),
        np.asarray(proof.public_values, np.uint64) % np.uint64(bb.P),
    ])
    params = params or vk.params
    aproof = prove_chipset(chips, pv, params, device=device)
    key = AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips], params)
    if fs:
        aproof.geometry = [ShardGeometry(
            list(proof.num_instances),
            is_first=verify_kwargs.get("is_first", True),
            is_last=verify_kwargs.get("is_last", True),
            standalone=verify_kwargs.get("standalone", True),
        )]
    return key, aproof


def expected_agg_key(vk, geometries: list, pvs: list, params=None,
                     _ninst_out: list | None = None) -> AggKey:
    """THE TRUST ANCHOR: deterministically rebuild the aggregation chip set
    (compiled circuits + fixed schedule columns) from public data only —
    the TRUSTED shard vk, the PCS params, each verified proof's public
    geometry and its pv (both in/alongside the aggregation statement).

    Works by synthesizing a shape-exact proof skeleton per shard
    (zkvm/skeleton.py) and running the REAL witness builder over it under
    structure replay: every chip structure and fixed schedule falls out
    exactly as for the real proofs, because none of them depends on proof
    VALUES. verify_aggregation uses this key instead of trusting a
    prover-supplied one — the reference anchors the same trust in its fixed
    recursion circuit's verifying key (ceno_recursion_v2
    its root circuit's prover.rs:177 get_vk + mod.rs:20 child_vk_pre_hash).

    ``_ninst_out``: optional list that receives each chip's (unpadded) row
    count — the level-2 tree reconstruction needs them."""
    from ..utils import replay
    from . import skeleton as SK

    params = params or vk.params
    specs = []
    for g, pv in zip(geometries, pvs):
        sk = SK.skeleton_zkvm_proof(
            vk, g.num_instances, pv, is_first=g.is_first, is_last=g.is_last,
            standalone=g.standalone,
        )
        specs.append((sk, {"is_first": g.is_first, "is_last": g.is_last,
                           "standalone": g.standalone}))
    with replay.structure_replay():
        sets, _summary = build_aggregation_witness_multi(vk, specs, fs=True)
    chips = _agg_chips_from_sets(sets, fs=True)
    if _ninst_out is not None:
        _ninst_out.extend(c.num_instances for c in chips)
    return AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips],
                  params)


def _shard_pvs_of(aproof: AggProof, vk, n_shards: int) -> list:
    digest = vk.digest_elems() % np.uint64(bb.P)
    pv = np.asarray(aproof.public_values, np.uint64)
    n_digest = len(digest)
    if len(pv) != n_digest + n_shards * N_PV:
        raise AggError("aggregation public value length mismatch")
    return [pv[n_digest + s * N_PV: n_digest + (s + 1) * N_PV]
            for s in range(n_shards)]


def verify_aggregation(aproof: AggProof, vk, params=None) -> bool:
    """Verify an aggregation proof against the TRUSTED shard vk ONLY — no
    prover-supplied key. The verifier-circuit chip set is reconstructed
    from (vk, params, aproof.geometry, the shard pv embedded in
    aproof.public_values) via :func:`expected_agg_key`; the pv digest
    prefix must equal ``vk.digest_elems()``. The semantic link back to the
    shard statement (FS-derived challenges, record-claim -> batched-claim
    linkage, PCS query phase in-circuit) is carried by the reconstructed
    chip families (RECURSION.md).

    The single-proof statement is a STANDALONE halting run: the geometry
    flags are pinned to (is_first, is_last, standalone) = (True, True,
    True), so the replayed verifier enforces shard-0 identity, the empty
    cross-shard bus and the halt rule. A prover-chosen is_last=False
    would otherwise skip expect_halt — partial shards only aggregate
    through verify_shard_aggregation, which pins flags per position."""
    if not aproof.geometry or len(aproof.geometry) != 1:
        raise AggError("aggregation proof must carry one shard geometry")
    g = aproof.geometry[0]
    if (g.is_first, g.is_last, g.standalone) != (True, True, True):
        raise AggError(
            "standalone aggregation must carry standalone shard flags"
        )
    pvs = _shard_pvs_of(aproof, vk, 1)
    with spans.span("agg/key-rebuild"):
        key = expected_agg_key(vk, aproof.geometry, pvs, params)
    with spans.span("agg/verify-chipset"):
        verify_chipset(key, aproof)
    _check_pv_digest(aproof, vk.digest_elems())
    return True


def _check_pv_digest(aproof: AggProof, digest: np.ndarray) -> int:
    digest = np.asarray(digest, np.uint64) % np.uint64(bb.P)
    pv = np.asarray(aproof.public_values, np.uint64)
    if len(pv) < len(digest) or not np.array_equal(pv[:len(digest)], digest):
        raise AggError("aggregation pv is not bound to the expected vk digest")
    return len(digest)


# ---------------------------------------------------------------------------
# Sharded aggregation: ALL shard proofs of a ShardedProof in ONE aggregation
# proof (the reference recursion's shard-aggregation role,
# ceno_recursion_v2 + scheme/verifier.rs:438-475 PV chaining). Each shard's
# verify transcript is its own chain (disjoint duplex-step namespace, shared
# challenge/pow registry); the PV-chaining and cross-shard EC-sum checks are
# pv-only, so the aggregation VERIFIER replays them directly on the
# aggregation public values (vk digest ++ every shard's pv).
# ---------------------------------------------------------------------------


def _agg_chips_from_sets(sets, fs: bool):
    chips = []
    for s in sets:
        if fs:
            name, compiled, cb, wit, fixed = s
        else:
            name, compiled, cb, wit = s
            fixed = None
        if wit.shape[1] == 0:
            continue   # empty chip family this proof (e.g. no pow chains)
        chips.append(AggChip(name, compiled, cb, _pad_pow2(wit),
                             wit.shape[1], fixed))
    return chips


def check_pv_chain(pvs: list) -> None:
    """The pv-only half of zkvm/shard.py::verify_shards: shard ids,
    pc/cycle/RAM-length/pubio chaining, global EC-sum infinity. Halt
    enforcement is NOT a pv-only property — it lives in scheme.verify's
    ``expect_halt`` (halt-chip instance count on the last shard), which the
    aggregation witness builder runs per shard."""
    from ..fields import septic as S
    from .layout import (
        PV_INIT_PC, PV_END_PC, PV_INIT_CYCLE, PV_END_CYCLE,
        PV_PUBIO_DIGEST,
    )

    acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    prev_pv = None
    for s, pv in enumerate(pvs):
        pv = np.asarray(pv, np.uint64)
        if int(pv[PV_SHARD_ID]) != s:
            raise AggError(f"shard {s}: wrong shard id {pv[PV_SHARD_ID]}")
        if prev_pv is not None:
            if pv[PV_INIT_PC] != prev_pv[PV_END_PC]:
                raise AggError(f"shard {s}: pc chain broken")
            if pv[PV_INIT_CYCLE] != prev_pv[PV_END_CYCLE]:
                raise AggError(f"shard {s}: cycle chain broken")
            if (
                pv[PV_HEAP_WORDS] != prev_pv[PV_HEAP_WORDS]
                or pv[PV_STACK_WORDS] != prev_pv[PV_STACK_WORDS]
                or pv[PV_INFO_WORDS] != prev_pv[PV_INFO_WORDS]
            ):
                raise AggError(f"shard {s}: dynamic RAM length mismatch")
            if not np.array_equal(
                pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
                prev_pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
            ):
                raise AggError(f"shard {s}: pubio digest mismatch")
        for base_pv in (PV_RW_SUM_IN, PV_RW_SUM_OUT):
            pt = (pv[base_pv:base_pv + 7], pv[base_pv + 7:base_pv + 14])
            acc = S.point_add(acc, pt)
        prev_pv = pv
    if not S.is_infinity(*acc):
        raise AggError("cross-shard RAM EC sum is not the identity")


def prove_shard_aggregation(vk, sproof, params=None, device=None):
    """Aggregate EVERY shard proof of a ShardedProof into one FS-bound
    aggregation proof on ``device`` (the card by default). Returns
    (AggKey, AggProof, n_shards)."""
    n = len(sproof.proofs)
    specs = [
        (proof, {"is_first": s == 0, "is_last": s == n - 1,
                 "standalone": False})
        for s, proof in enumerate(sproof.proofs)
    ]
    with spans.span("agg/witness"):
        sets, summary = build_aggregation_witness_multi(vk, specs, fs=True)
    chips = _agg_chips_from_sets(sets, fs=True)
    pv = np.concatenate(
        [vk.digest_elems() % np.uint64(bb.P)]
        + [np.asarray(p.public_values, np.uint64) % np.uint64(bb.P)
           for p in sproof.proofs]
    )
    params = params or vk.params
    aproof = prove_chipset(chips, pv, params, device=device)
    key = AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips], params)
    aproof.geometry = [
        ShardGeometry(list(p.num_instances), is_first=(s == 0),
                      is_last=(s == n - 1), standalone=False)
        for s, p in enumerate(sproof.proofs)
    ]
    return key, aproof, n


def prove_chipset_aggregation(key: AggKey, aproofs: list, params=None,
                              device=None):
    """Aggregate AGGREGATION proofs (pairwise tree closure, the reference
    recursion's compress step): each inner proof verifies through
    verify_chipset's capture hooks on its own recording chain, the combined
    FS-bound witness proves through the chipset scheme again. All inner
    proofs must share ``key`` (same chip geometry). The outer proof runs
    on ``device`` (the card by default). Returns (outer_key, outer_proof)."""
    specs = [(p, {}) for p in aproofs]
    with spans.span("agg/witness"):
        sets, _summary = build_aggregation_witness_multi(
            None, specs, fs=True,
            verify_fn=lambda proof, cap, t, **kw: verify_chipset(
                key, proof, capture=cap, transcript=t),
            label=LABEL_AGG, digest_len=len(key.digest_elems()),
            params=key.params,
        )
    chips = _agg_chips_from_sets(sets, fs=True)
    pv = np.concatenate(
        [key.digest_elems() % np.uint64(bb.P)]
        + [np.asarray(p.public_values, np.uint64) % np.uint64(bb.P)
           for p in aproofs]
    )
    params = params or key.params
    outer = prove_chipset(chips, pv, params, device=device)
    okey = AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips],
                  params)
    outer.geometry = ("chipset", [list(p.num_instances) for p in aproofs])
    return okey, outer


def expected_chipset_key(inner_key: AggKey, inner_ninsts: list,
                         inner_pvs: list, params=None) -> AggKey:
    """Level-2 trust anchor: rebuild the OUTER aggregation chip set from
    the (itself reconstructed) inner key + each inner proof's public
    geometry (its per-chip num_instances) and pv. Mirrors
    :func:`expected_agg_key` with verify_chipset as the replayed verifier."""
    from ..utils import replay
    from . import skeleton as SK

    params = params or inner_key.params
    specs = []
    for ninst, pv in zip(inner_ninsts, inner_pvs):
        specs.append((SK.skeleton_chipset_proof(inner_key, ninst, pv), {}))
    with replay.structure_replay():
        sets, _summary = build_aggregation_witness_multi(
            None, specs, fs=True,
            verify_fn=lambda proof, cap, t, **kw: verify_chipset(
                inner_key, proof, capture=cap, transcript=t),
            label=LABEL_AGG, digest_len=len(inner_key.digest_elems()),
            params=params,
        )
    chips = _agg_chips_from_sets(sets, fs=True)
    return AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips],
                  params)


def verify_chipset_aggregation(outer: AggProof, inner_key: AggKey,
                               inner_pvs: list, params=None) -> bool:
    """Verify a level-2 (tree closure) aggregation against a TRUSTED (or
    reconstructed) inner key only: the outer chip set is rebuilt from
    public geometry, the outer pv prefix must equal the inner key's
    (circuit-binding) digest, and each inner proof's pv must appear in the
    outer statement."""
    # accept tuple OR list: the proof serializer round-trips tuples as
    # lists (serialize.py tag 'L')
    if not (isinstance(outer.geometry, (tuple, list))
            and len(outer.geometry) == 2
            and outer.geometry[0] == "chipset"):
        raise AggError("proof does not carry chipset-level geometry")
    inner_ninsts = outer.geometry[1]
    if len(inner_ninsts) != len(inner_pvs):
        raise AggError("inner pv count mismatch")
    with spans.span("agg/key-rebuild"):
        key = expected_chipset_key(inner_key, inner_ninsts, inner_pvs, params)
    with spans.span("agg/verify-chipset"):
        verify_chipset(key, outer)
    digest = inner_key.digest_elems() % np.uint64(bb.P)
    pv = np.asarray(outer.public_values, np.uint64)
    n_d = len(digest)
    if not np.array_equal(pv[:n_d], digest):
        raise AggError("outer pv is not bound to the inner key digest")
    off = n_d
    for ipv in inner_pvs:
        ipv = np.asarray(ipv, np.uint64) % np.uint64(bb.P)
        if not np.array_equal(pv[off: off + len(ipv)], ipv):
            raise AggError("outer pv does not embed an inner statement")
        off += len(ipv)
    if off != len(pv):
        raise AggError("outer pv length mismatch")
    return True


def verify_shard_aggregation(aproof: AggProof, n_shards: int, vk,
                             params=None) -> bool:
    """Verify a sharded aggregation against the TRUSTED shard vk ONLY (no
    prover-supplied key — reconstructed, see :func:`expected_agg_key`):
    the chipset proof (in-circuit shard verifications), the pv binding to
    the vk digest, and the pv-only chaining + EC-sum checks.

    Halt enforcement rides the reconstruction: the last shard's geometry
    is replayed with is_last=True, and scheme.verify's expect_halt check
    (a geometry rule, live in replay) rejects a final-shard geometry whose
    halt chip count != 1 — so a witness-forging prover cannot aggregate a
    never-halting trace (verifier.rs has_halt role, verifier-side)."""
    if not aproof.geometry or len(aproof.geometry) != n_shards:
        raise AggError("aggregation proof must carry one geometry per shard")
    for s, g in enumerate(aproof.geometry):
        if (g.is_first, g.is_last, g.standalone) != \
                (s == 0, s == n_shards - 1, False):
            raise AggError(f"shard {s}: wrong geometry flags")
    pvs = _shard_pvs_of(aproof, vk, n_shards)
    with spans.span("agg/key-rebuild"):
        key = expected_agg_key(vk, aproof.geometry, pvs, params)
    with spans.span("agg/verify-chipset"):
        verify_chipset(key, aproof)
    _check_pv_digest(aproof, vk.digest_elems())
    check_pv_chain(pvs)
    return True
