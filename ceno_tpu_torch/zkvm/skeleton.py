"""Proof skeletons: structurally-exact shard proofs from public geometry.

The aggregation trust anchor (zkvm/aggregate.py::expected_agg_key) needs the
verifier-circuit chip set WITHOUT the shard proof: only (vk, params, the
proof's public geometry — num_instances + shard flags — and the shard pv,
which the aggregation statement carries). The chip structures and fixed
schedule columns depend only on those inputs, so the key can be rebuilt by
running the REAL shard verifier (under utils/replay.structure_replay, which
waives value-equality checks) over a proof whose every component has the
right SHAPE and whose transcript-derived parts (query indices) are
self-consistent.

This module builds that proof: a dummy prover that walks the exact
absorb/sample sequence of scheme.prove / scheme.verify, filling proof
components with seeded-random nonzero field elements and deriving anything
the verifier cross-checks against the transcript (PCS query indices) from
the live transcript itself.

Role mirror: the reference recursion fixes ONE compiled recursion program
and trusts its verifying key (ceno_recursion_v2's root circuit, mod.rs:20
child_vk_pre_hash, prover.rs:177 get_vk); here the "program" is the
deterministic function (vk, params, geometry) -> chip set, and this module
is what makes it verifier-computable.

Copy of ``ceno_tpu/zkvm/skeleton.py``: the same ``_Rng`` and shapes, so
the chip sets rebuilt from a skeleton equal those of a real proof, in
either package.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..gkr import chip as chiplib
from ..gkr import eccquark
from ..gkr.tower import TowerProof
from ..gkr.chip import ClassMainProof, interleave_geometry
from ..hash.transcript import Transcript
from ..pcs import basefold
from ..pcs.basefold import OpeningProof, QueryProof
from ..pcs.jagged import JaggedOpening
from . import scheme
from .layout import N_PUBLIC_VALUES, PV_RW_SUM_IN, PV_RW_SUM_OUT

_P = np.uint64(bb.P)


class _Rng:
    """Nonzero canonical field elements (zeros can collapse value-keyed
    dedup maps and hit degenerate code paths the real verifier never sees)."""

    def __init__(self, seed: int):
        self.g = np.random.default_rng(seed)

    def elems(self, *shape) -> np.ndarray:
        return self.g.integers(1, bb.P, size=shape, dtype=np.uint64)

    def digest(self) -> np.ndarray:
        return self.elems(8)


def _sc_rounds(t: Transcript, rng: _Rng, n_rounds: int, deg: int,
               hook=None) -> np.ndarray:
    """Mirror sc_verifier.verify's interaction: per round absorb a (deg+1, 4)
    message and sample the challenge."""
    msgs = rng.elems(n_rounds, deg + 1, 4)
    for rnd in range(n_rounds):
        t.append(msgs[rnd].ravel())
        ch = t.sample_ext()
        if hook is not None:
            hook(rnd, ch)
    return msgs


def _skeleton_opening(t: Transcript, rng: _Rng, n_vars: int, n_cols: int,
                      k: int, params) -> OpeningProof:
    """Mirror basefold.open_batch/verify_batch's transcript walk and emit a
    shape-exact OpeningProof with transcript-consistent query indices."""
    n = 1 << n_vars
    m = n << params.blowup_log
    t.sample_ext()  # gamma

    # fold schedule: which rounds commit a fold root vs emit the tail
    state = {"tail_seen": False, "n_committed": 0}
    tail_rounds_done = 0
    for rnd in range(n_vars):
        new_m = m >> (rnd + 1)
        if state["tail_seen"]:
            continue
        if new_m <= params.stop_size or rnd == n_vars - 1:
            state["tail_seen"] = True
            tail_rounds_done = rnd + 1
        else:
            state["n_committed"] += 1
    n_committed = state["n_committed"]
    assert tail_rounds_done == n_committed + 1
    tail_log = (m.bit_length() - 1) - tail_rounds_done
    tail = rng.elems(k, 1 << tail_log, 4)
    fold_roots = [rng.digest() for _ in range(n_committed)]

    hook_state = {"next_root": 0, "tail_seen": False}

    def hook(rnd, ch):
        new_m = m >> (rnd + 1)
        if hook_state["tail_seen"]:
            return
        if new_m <= params.stop_size or rnd == n_vars - 1:
            t.append(tail.ravel())
            hook_state["tail_seen"] = True
        else:
            t.append(fold_roots[hook_state["next_root"]])
            hook_state["next_root"] += 1

    sumcheck_msgs = _sc_rounds(t, rng, n_vars, 2, hook=hook)
    point_evals = rng.elems(k, 4)
    t.append(point_evals.ravel())

    # query-phase PoW (nonce 0; the bound check is waived in replay, the
    # absorb+sample interaction is part of the sequence)
    t.append([0])
    t.sample_base()
    idxs = [t.sample_base() % (m // 2) for _ in range(params.n_queries)]

    depth_base = m.bit_length() - 1
    queries = []
    for i in idxs:
        u_rows = []
        u_paths = []
        for tt in range(n_committed):
            mt = m >> (tt + 1)
            u_rows.append(rng.elems(2, k, 4))
            u_paths.append(rng.elems(2, mt.bit_length() - 1, 8))
        queries.append(QueryProof(
            i, rng.elems(n_cols, 2), rng.elems(2, depth_base, 8),
            u_rows, u_paths,
        ))
    return OpeningProof(sumcheck_msgs, fold_roots, tail, point_evals,
                        queries, 0)


def _skeleton_jagged_opening(t: Transcript, rng: _Rng, n_claims: int,
                             log_r: int, n_mat_cols: int,
                             params) -> JaggedOpening:
    """Mirror jagged.open_jagged/verify_jagged's transcript walk."""
    t.sample_ext()  # gammas base (sample_ext_pows)
    trans_msgs = _sc_rounds(t, rng, log_r, 2)
    v_evals = rng.elems(n_mat_cols, 4)
    t.append(v_evals.ravel())
    opening = _skeleton_opening(t, rng, log_r, n_mat_cols, 1, params)
    return JaggedOpening(trans_msgs, v_evals, opening)


def _skeleton_towers(t: Transcript, rng: _Rng, entries: list) -> TowerProof:
    """Mirror tower.verify_towers + the per-chip _slot_multipliers samples
    of chiplib.verify_group_towers for ONE tower-size group."""
    s_p = s_l = 0
    geo = [interleave_geometry(e[0]) for e in entries]
    for (compiled, k, n_vars), (rho, r_r, r_w, r_l) in zip(entries, geo):
        s_p += int(r_r > 0) + int(r_w > 0)
        s_l += int(r_l > 0)
    n_tower_vars = entries[0][2] + geo[0][0]

    prod_out = rng.elems(s_p, 2, 4)
    logup_out = rng.elems(s_l, 2, 2, 4)
    proof = TowerProof(prod_out, logup_out)
    for s in range(s_p):
        t.append(proof.prod_out[s].ravel())
    for s in range(s_l):
        t.append(proof.logup_out[s].ravel())
    t.sample_ext()  # rt[0]
    for level in range(1, n_tower_vars):
        t.sample_ext()  # alphas base (sample_ext_pows)
        proof.round_msgs.append(_sc_rounds(t, rng, level, 3))
        evals = rng.elems(2 * s_p + 4 * s_l, 4)
        proof.level_evals.append(evals)
        t.append(evals.ravel())
        t.sample_ext()  # mu
    # per-member slot-multiplier alpha samples (verify_group_towers order)
    for (compiled, k, n_vars), (rho, r_r, r_w, r_l) in zip(entries, geo):
        n_zero = sum(1 for s in compiled.slots if s.kind == "zero")
        n_alpha = int(r_r > 0) + int(r_w > 0) + 2 * int(r_l > 0) + n_zero
        t.sample_ext()  # one sample regardless of n_alpha (sample_ext_pows)
        del n_alpha
    return proof


def _skeleton_class_main(t: Transcript, rng: _Rng, members: list,
                         n_vars: int) -> ClassMainProof:
    """Mirror chiplib.verify_class_main's interaction for one height class.
    ``members``: [CompiledChip]."""
    t.sample_ext()  # gammas base
    deg = max(
        max((len(tm.cols) + 1 for s in c.slots for tm in s.terms), default=1)
        for c in members
    )
    main_msgs = _sc_rounds(t, rng, n_vars, deg)
    wit_evals = [rng.elems(c.n_wit, 4) for c in members]
    fixed_evals = [rng.elems(c.n_fixed, 4) for c in members]
    structural_evals = [rng.elems(len(c.structural), 4) for c in members]
    flat = []
    for we, fe, se in zip(wit_evals, fixed_evals, structural_evals):
        flat += [we, fe, se]
    t.append(
        np.concatenate([x.reshape(-1) for x in flat])
        if flat else np.zeros(0, np.uint64)
    )
    return ClassMainProof(main_msgs, wit_evals, fixed_evals,
                          structural_evals)


def skeleton_zkvm_proof(vk, num_instances: list, public_values: np.ndarray,
                        *, is_first: bool = True, is_last: bool = True,
                        standalone: bool = True,
                        seed: int = 0x5CE1E) -> "scheme.ZKVMProof":
    """A shape-exact ZKVMProof for (vk, geometry, pv): every transcript
    interaction of scheme.verify over it matches a real proof of the same
    geometry; all value checks fail (random data) and must be run under
    utils/replay.structure_replay."""
    rng = _Rng(seed)
    pv = np.asarray(public_values, np.uint64)
    if len(pv) != N_PUBLIC_VALUES:
        raise scheme.ZKVMError("bad public value count")
    if len(num_instances) != len(vk.metas):
        raise scheme.ZKVMError("chip count mismatch")
    wit_layout, heights, chip_active = scheme.derive_shard_layout(
        vk, num_instances, pv, is_first, is_last, standalone
    )

    t = Transcript(scheme.LABEL)
    t.append(vk.digest_elems())
    t.append(pv)
    if not vk.params.jagged:
        raise scheme.ZKVMError(
            "skeletons (aggregation keys) exist for the jagged PcsKind only"
        )
    jl_w, wslice = scheme._jagged_plan(wit_layout)
    witness_roots = {jl_w.n_r: rng.digest()}
    t.append(witness_roots[jl_w.n_r])
    for ci in range(len(vk.metas)):
        t.append([num_instances[ci] % bb.P])
    t.sample_ext()
    t.sample_ext()  # challenges

    group_members: dict = {}
    for ci, meta in enumerate(vk.metas):
        if not chip_active[ci]:
            continue
        rho, _, _, _ = interleave_geometry(meta.compiled)
        group_members.setdefault(heights[ci] << rho, []).append(ci)
    tower_groups = {}
    for n_t in sorted(group_members):
        entries = [
            (vk.metas[ci].compiled, num_instances[ci],
             heights[ci].bit_length() - 1)
            for ci in group_members[n_t]
        ]
        tower_groups[n_t] = _skeleton_towers(t, rng, entries)

    class_main = {}
    for h in sorted(wit_layout):
        members = [vk.metas[ci].compiled for ci, _, _ in wit_layout[h]]
        class_main[h] = _skeleton_class_main(t, rng, members,
                                             h.bit_length() - 1)

    # EC quark proofs (registry order; final_sum = the REAL pv slice so the
    # geometry gate `k == 0 iff fsum == 0` behaves as for a real proof)
    ec_proofs = {}
    n_extra_claims = 0
    for ci, meta in enumerate(vk.metas):
        if not meta.kind.startswith("ec_tree"):
            continue
        k = num_instances[ci]
        if k == 0:
            continue
        base = PV_RW_SUM_IN if meta.kind.endswith("_in") else PV_RW_SUM_OUT
        fsum = pv[base: base + 14].reshape(2, 7)
        n = heights[ci].bit_length() - 2
        t.sample_exts(n)            # out_rt
        t.sample_ext()              # alphas base
        round_msgs = _sc_rounds(t, rng, n, 3)
        col_evals = rng.elems(49, 4)
        t.append(col_evals.ravel())
        ec_proofs[meta.name] = eccquark.EccQuarkProof(
            k, n, round_msgs, col_evals, fsum
        )
        n_extra_claims += sum(
            7 * len(cl) for _, cl in scheme._EC_POINTS
        )

    # jagged witness opening
    n_wit_claims = sum(
        e[2] for h in wit_layout for e in wit_layout[h]
    ) + n_extra_claims
    log_r = jl_w.n_r.bit_length() - 1
    witness_openings = {jl_w.n_r: _skeleton_jagged_opening(
        t, rng, n_wit_claims, log_r, jl_w.n_mat_cols, vk.params
    )}

    # jagged fixed opening (only ACTIVE tables' fixed columns carry claims)
    jl_f, fslice = scheme._jagged_plan(vk.fixed_layout)
    n_fixed_claims = sum(
        e[2]
        for h in vk.fixed_layout
        for e in vk.fixed_layout[h]
        if chip_active[e[0]]
    )
    log_rf = jl_f.n_r.bit_length() - 1
    fixed_openings = {jl_f.n_r: _skeleton_jagged_opening(
        t, rng, n_fixed_claims, log_rf, jl_f.n_mat_cols, vk.params
    )}

    return scheme.ZKVMProof(
        pv, list(num_instances), witness_roots, tower_groups, class_main,
        ec_proofs, witness_openings, fixed_openings,
    )


def skeleton_chipset_proof(key, num_instances: list,
                           public_values: np.ndarray,
                           seed: int = 0xA66):
    """A shape-exact AggProof for (key, per-chip num_instances, pv): every
    transcript interaction of zkvm.aggregate.verify_chipset over it matches
    a real chipset proof — the level-2 (tree closure) analogue of
    :func:`skeleton_zkvm_proof`. Run under structure replay only."""
    from . import aggregate as agg

    rng = _Rng(seed)
    pv = np.asarray(public_values, np.uint64)
    if len(num_instances) != len(key.chips):
        raise agg.AggError("chip count mismatch")
    t = Transcript(agg.LABEL_AGG)
    t.append(key.digest_elems())
    t.append(pv)

    heights = [
        max(2, 1 << max(0, (int(k) - 1).bit_length())) for k in num_instances
    ]
    layout: dict = {}
    for i, h in enumerate(heights):
        off = sum(e[2] for e in layout.get(h, []))
        layout.setdefault(h, []).append((i, off, key.chips[i][1].n_wit))
    witness_root = rng.digest()
    t.append(witness_root)
    for k in num_instances:
        t.append([int(k) % bb.P])
    t.sample_ext()
    t.sample_ext()

    group_members: dict = {}
    for i, (name, compiled, cb, fixed) in enumerate(key.chips):
        rho, _, _, _ = interleave_geometry(compiled)
        group_members.setdefault(heights[i] << rho, []).append(i)
    tower_groups = {}
    for n_t in sorted(group_members):
        entries = [
            (key.chips[i][1], int(num_instances[i]),
             heights[i].bit_length() - 1)
            for i in group_members[n_t]
        ]
        tower_groups[n_t] = _skeleton_towers(t, rng, entries)

    class_main = {}
    for h in sorted(layout):
        members = [key.chips[i][1] for i, _, _ in layout[h]]
        class_main[h] = _skeleton_class_main(t, rng, members,
                                             h.bit_length() - 1)

    jl, _slice_base = scheme._jagged_plan(layout)
    log_r = jl.n_r.bit_length() - 1
    opening = _skeleton_jagged_opening(
        t, rng, sum(e[2] for h in layout for e in layout[h]), log_r,
        jl.n_mat_cols, key.params,
    )
    return agg.AggProof(pv, [int(k) for k in num_instances], witness_root,
                        tower_groups, class_main, opening)
