"""Recursive-verifier chips (RECURSION.md build order #2/#3).

The first in-circuit verifier component: a chip that verifies sumcheck
TRANSCRIPT REDUCTIONS. Row = one round of one sumcheck instance:

  * wires: the round message nodes y_0..y_deg (ext), the round challenge
    alpha (ext), the incoming claim (ext);
  * constraints: y_0 + y_1 == claim_in, and claim_out = the degree-deg
    Lagrange extrapolation of the message at alpha (gadgets.py);
  * chaining: rounds of an instance are chained over the RAM_CUSTOM
    multiset bus exactly like keccak's round chaining
    (zkvm/chips/keccak.py): row (instance, round) READS
    (SumcheckClaim, instance, round, claim_in) and WRITES
    (SumcheckClaim, instance, round+1, claim_out). An ENDPOINTS chip
    closes the bus: per instance it writes the initial claim (round 0)
    and reads the final claim (round n_vars), exposing both as witness
    wires a caller binds to its own statement.

What this does NOT yet do (build order #3+): derive alpha from an
in-circuit transcript (Poseidon2 sponge chip over the same bus) — here
alpha is a witness column the surrounding statement must bind, exactly
like the reference recursion's first milestone binds challenges from the
outer proof object.

Copy of ``ceno_tpu/gkr/recursion.py``: the same chips, bus tags, witness
layouts and fixed schedules, in host numpy over the port's own circuit
builder, gadgets and transcript.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..mle import expression as E
from . import gadgets as G
from .circuit_builder import CircuitBuilder, RAM_CUSTOM
from .chip import compile_chip
from ..utils import replay

TAG_SUMCHECK_CLAIM = 3  # RAM_CUSTOM sub-tag (keccak state = 2)
TAG_SPONGE_STATE = 4    # transcript duplex state chain (fs chips below)


@dataclass
class SumcheckVerifyChips:
    rounds_cb: CircuitBuilder
    rounds_compiled: object
    ends_cb: CircuitBuilder
    ends_compiled: object
    deg: int
    n_vars: int


def build_sumcheck_verify_chips(deg: int, n_vars: int,
                                bind: bool = False) -> SumcheckVerifyChips:
    # -- per-round chip ------------------------------------------------------
    cb = CircuitBuilder("sumcheck_verify_rounds" + ("_fs" if bind else ""))
    inst = cb.create_witin("inst")
    rnd = cb.create_witin("round")
    ys = [G.ext_witness(cb, f"y{k}") for k in range(deg + 1)]
    alpha = G.ext_witness(cb, "alpha")
    claim_in = G.ext_witness(cb, "claim_in")
    # y0 + y1 == claim_in
    G.ext_require_equal(cb, "sum_check", ys[0].add(ys[1]), claim_in)
    claim_out = G.lagrange_extrapolate_gadget(cb, "lag", ys, alpha, deg)
    head = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), inst]
    cb.read_record(head + [rnd] + claim_in.c)
    cb.write_record(head + [rnd + 1] + claim_out.c)
    if bind:
        # global-FS-chain binding (gkr/fs_chain.py): the row SUPPLIES its
        # round message to the duplex absorb slots (so the transcript the
        # duplex chip proves absorbed exactly these ys) and derives alpha
        # from the challenge lookup table.
        from . import fs_chain as FS

        aidx = cb.create_fixed("aidx")
        acid = cb.create_fixed("acid")
        msg_elems = [c for y in ys for c in y.c]
        for k, mc in enumerate(msg_elems):
            cb.write_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_ABS_SLOT),
                             aidx + k, mc])
        cb.lk_record(FS.LK_AGG_CHAL, [acid] + list(alpha.c))
    rounds_compiled = compile_chip(cb)

    # -- endpoints chip (one row per instance) -------------------------------
    eb = CircuitBuilder("sumcheck_verify_ends")
    einst = eb.create_witin("inst")
    init_claim = G.ext_witness(eb, "init_claim")
    final_claim = G.ext_witness(eb, "final_claim")
    ehead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), einst]
    eb.write_record(ehead + [E.Const(0)] + init_claim.c)
    eb.read_record(ehead + [E.Const(n_vars)] + final_claim.c)
    ends_compiled = compile_chip(eb)
    return SumcheckVerifyChips(cb, rounds_compiled, eb, ends_compiled,
                               deg, n_vars)


def assign_sumcheck_verify(chips: SumcheckVerifyChips, transcripts: list):
    """Witgen from verifier-side transcript artifacts.

    ``transcripts``: per instance dict with
        msgs   (n_vars, deg+1, 4) canonical round messages
        chals  (n_vars, 4) the sampled round challenges
        claim  (4,) the initial claim
    Returns (rounds_wit, ends_wit) matrices (row counts = instances*n_vars
    and instances; claims are chained with the Lagrange host mirror)."""
    deg, n_vars = chips.deg, chips.n_vars
    m = len(transcripts)
    n_rows = m * n_vars
    cols: dict = {
        "inst": np.repeat(np.arange(m, dtype=np.uint64), n_vars),
        "round": np.tile(np.arange(n_vars, dtype=np.uint64), m),
    }
    ys = np.zeros((n_rows, deg + 1, 4), np.uint64)
    alpha = np.zeros((n_rows, 4), np.uint64)
    claim_in = np.zeros((n_rows, 4), np.uint64)
    init_claims = np.zeros((m, 4), np.uint64)
    final_claims = np.zeros((m, 4), np.uint64)
    for i, tr in enumerate(transcripts):
        cur = np.asarray(tr["claim"], np.uint64)
        init_claims[i] = cur
        msgs = np.asarray(tr["msgs"], np.uint64)
        chals = np.asarray(tr["chals"], np.uint64)
        for r in range(n_vars):
            row = i * n_vars + r
            ys[row] = msgs[r]
            alpha[row] = chals[r]
            claim_in[row] = cur
            from ..sumcheck.verifier import lagrange_extrapolate

            cur = lagrange_extrapolate(msgs[r], chals[r])
        final_claims[i] = cur
    for k in range(deg + 1):
        G.assign_ext(cols, f"y{k}", ys[:, k])
    G.assign_ext(cols, "alpha", alpha)
    G.assign_ext(cols, "claim_in", claim_in)
    G.assign_lagrange(cols, "lag", ys, alpha, deg)
    rounds_wit = np.zeros((len(chips.rounds_cb.wit_names), n_rows), np.uint64)
    for i, name in enumerate(chips.rounds_cb.wit_names):
        rounds_wit[i] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)

    ecols: dict = {"inst": np.arange(m, dtype=np.uint64)}
    G.assign_ext(ecols, "init_claim", init_claims)
    G.assign_ext(ecols, "final_claim", final_claims)
    ends_wit = np.zeros((len(chips.ends_cb.wit_names), m), np.uint64)
    for i, name in enumerate(chips.ends_cb.wit_names):
        ends_wit[i] = np.asarray(ecols[name], np.uint64) % np.uint64(bb.P)
    return rounds_wit, ends_wit, final_claims


# ---------------------------------------------------------------------------
# Fiat-Shamir-complete sumcheck verification (RECURSION.md build order #3):
# the round chip DERIVES the challenge from an in-circuit Poseidon2 duplex
# instead of witnessing it. A row = one sumcheck round of one instance:
#
#   * reads  (SpongeState,   inst, r, state[16])   -- the duplex before the
#     round (after the label flush, written by the endpoints chip for r=0)
#   * absorb permutation A: in_A = state + msg[0:8] at the rate slots
#   * absorb permutation B: in_B = out_A + msg[8:16]
#   * alpha = out_B[0:4]   (BasicTranscript: 16-elem absorb = permute between
#     slots 7/8; the sample permutes again and reads rate slots 0..3 — so a
#     deg-3 round is EXACTLY two permutations, mirrored bit-for-bit from
#     hash/transcript.py; tests assert equality with a live Transcript)
#   * reads  (SumcheckClaim, inst, r, claim_in), checks y0+y1 == claim_in,
#     writes (SumcheckClaim, inst, r+1, Lagrange(msg, alpha))
#   * writes (SpongeState,   inst, r+1, out_B)
#
# The endpoints chip performs the round-0 FLUSH permutation in-circuit
# (label-digest block absorbed before the first sample, transcript.py
# semantics), pinning the label digest and initial claim as witness wires
# the outer statement binds, and closes both bus chains.
# ---------------------------------------------------------------------------

from ..zkvm.chips.poseidon2_gadget import Lin, assign_poseidon2, build_poseidon2
from ..hash import poseidon2 as p2
from ..hash.transcript import Transcript


@dataclass
class FsSumcheckVerifyChips:
    rounds_cb: CircuitBuilder
    rounds_compiled: object
    ends_cb: CircuitBuilder
    ends_compiled: object
    deg: int
    n_vars: int


def build_fs_sumcheck_verify_chips(deg: int, n_vars: int) -> FsSumcheckVerifyChips:
    assert deg == 3, "fs round chip models the 16-elem absorb (deg 3) schedule"
    cb = CircuitBuilder("fs_sumcheck_rounds")
    inst = cb.create_witin("inst")
    rnd = cb.create_witin("round")
    ys = [G.ext_witness(cb, f"y{k}") for k in range(deg + 1)]
    state_in = [cb.create_witin(f"st{j}") for j in range(p2.WIDTH)]
    # duplex: two permutations with the message as rate blocks
    msg_elems = [c for y in ys for c in y.c]   # 16 wires, transcript order
    lin_a = [Lin.col(state_in[j]) + Lin.col(msg_elems[j]) for j in range(8)]
    lin_a += [Lin.col(state_in[j]) for j in range(8, p2.WIDTH)]
    out_a = build_poseidon2(cb, "pa", lin_a)
    lin_b = [out_a[j] + Lin.col(msg_elems[8 + j]) for j in range(8)]
    lin_b += list(out_a[8:])
    out_b = build_poseidon2(cb, "pb", lin_b)
    alpha = G.ExtWire(*[out_b[j].to_expr() for j in range(4)])
    claim_in = G.ext_witness(cb, "claim_in")
    G.ext_require_equal(cb, "sum_check", ys[0].add(ys[1]), claim_in)
    claim_out = G.lagrange_extrapolate_gadget(cb, "lag", ys, alpha, deg)
    chead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), inst]
    cb.read_record(chead + [rnd] + claim_in.c)
    cb.write_record(chead + [rnd + 1] + claim_out.c)
    shead = [E.Const(RAM_CUSTOM), E.Const(TAG_SPONGE_STATE), inst]
    cb.read_record(shead + [rnd] + [Lin.col(s).to_expr() for s in state_in])
    cb.write_record(shead + [rnd + 1] + [o.to_expr() for o in out_b])
    rounds_compiled = compile_chip(cb)

    # endpoints: flush permutation + chain ends (one row per instance)
    eb = CircuitBuilder("fs_sumcheck_ends")
    einst = eb.create_witin("inst")
    pre = [eb.create_witin(f"pre{j}") for j in range(p2.WIDTH)]  # pre-flush
    flushed = build_poseidon2(eb, "pf", [Lin.col(w) for w in pre])
    init_claim = G.ext_witness(eb, "init_claim")
    final_claim = G.ext_witness(eb, "final_claim")
    final_state = [eb.create_witin(f"fin{j}") for j in range(p2.WIDTH)]
    chead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), einst]
    eb.write_record(chead + [E.Const(0)] + init_claim.c)
    eb.read_record(chead + [E.Const(n_vars)] + final_claim.c)
    shead = [E.Const(RAM_CUSTOM), E.Const(TAG_SPONGE_STATE), einst]
    eb.write_record(shead + [E.Const(0)] + [o.to_expr() for o in flushed])
    eb.read_record(
        shead + [E.Const(n_vars)] + [Lin.col(w).to_expr() for w in final_state]
    )
    ends_compiled = compile_chip(eb)
    return FsSumcheckVerifyChips(cb, rounds_compiled, eb, ends_compiled,
                                 deg, n_vars)


def assign_fs_sumcheck_verify(chips: FsSumcheckVerifyChips, transcripts: list):
    """Witgen; ``transcripts`` per instance:
        msgs  (n_vars, deg+1, 4) round messages
        claim (4,) initial claim
        pre_state (16,) sponge state right BEFORE the round-0 flush
          (i.e. a host Transcript's state after its label/statement absorbs)
    Challenges are NOT inputs — they are what the duplex produces. Returns
    (rounds_wit, ends_wit, final_claims, final_states)."""
    deg, n_vars = chips.deg, chips.n_vars
    m = len(transcripts)
    n_rows = m * n_vars
    cols: dict = {
        "inst": np.repeat(np.arange(m, dtype=np.uint64), n_vars),
        "round": np.tile(np.arange(n_vars, dtype=np.uint64), m),
    }
    ys = np.zeros((n_rows, deg + 1, 4), np.uint64)
    claim_in = np.zeros((n_rows, 4), np.uint64)
    state_in = np.zeros((n_rows, p2.WIDTH), np.uint64)
    alphas = np.zeros((n_rows, 4), np.uint64)
    pre_states = np.zeros((m, p2.WIDTH), np.uint64)
    init_claims = np.zeros((m, 4), np.uint64)
    final_claims = np.zeros((m, 4), np.uint64)
    final_states = np.zeros((m, p2.WIDTH), np.uint64)
    from ..sumcheck.verifier import lagrange_extrapolate

    for i, tr in enumerate(transcripts):
        msgs = np.asarray(tr["msgs"], np.uint64)
        cur = np.asarray(tr["claim"], np.uint64)
        pre_states[i] = np.asarray(tr["pre_state"], np.uint64)
        init_claims[i] = cur
        st = p2.permute_host(pre_states[i])  # the flush
        for r in range(n_vars):
            row = i * n_vars + r
            ys[row] = msgs[r]
            claim_in[row] = cur
            state_in[row] = st
            flat = msgs[r].reshape(-1)
            st = st.copy()
            st[:8] = (st[:8] + flat[:8]) % np.uint64(bb.P)
            st = p2.permute_host(st)
            st[:8] = (st[:8] + flat[8:]) % np.uint64(bb.P)
            st = p2.permute_host(st)
            alphas[row] = st[:4]
            cur = lagrange_extrapolate(msgs[r], st[:4])
        final_claims[i] = cur
        final_states[i] = st
    for k in range(deg + 1):
        G.assign_ext(cols, f"y{k}", ys[:, k])
    for j in range(p2.WIDTH):
        cols[f"st{j}"] = state_in[:, j]
    G.assign_ext(cols, "claim_in", claim_in)
    # permutation sites A and B
    in_a = state_in.copy()
    in_a[:, :8] = (in_a[:, :8] + ys.reshape(n_rows, -1)[:, :8]) % np.uint64(bb.P)
    ua, wa, out_a = assign_poseidon2(in_a)
    names_a = [n for n in chips.rounds_cb.wit_names if n.startswith("pa_")]
    vals_a = [v for uw in zip(ua, wa) for v in uw]
    for name, v in zip(names_a, vals_a):
        cols[name] = v
    in_b = out_a.copy()
    in_b[:, :8] = (in_b[:, :8] + ys.reshape(n_rows, -1)[:, 8:]) % np.uint64(bb.P)
    ub, wb, out_b = assign_poseidon2(in_b)
    names_b = [n for n in chips.rounds_cb.wit_names if n.startswith("pb_")]
    vals_b = [v for uw in zip(ub, wb) for v in uw]
    for name, v in zip(names_b, vals_b):
        cols[name] = v
    replay.check(np.array_equal(out_b[:, :4], alphas))
    G.assign_lagrange(cols, "lag", ys, alphas, deg)
    rounds_wit = np.zeros((len(chips.rounds_cb.wit_names), n_rows), np.uint64)
    for i, name in enumerate(chips.rounds_cb.wit_names):
        assert name in cols, name
        rounds_wit[i] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)

    ecols: dict = {"inst": np.arange(m, dtype=np.uint64)}
    for j in range(p2.WIDTH):
        ecols[f"pre{j}"] = pre_states[:, j]
        ecols[f"fin{j}"] = final_states[:, j]
    uf, wf, _flushed = assign_poseidon2(pre_states)
    names_f = [n for n in chips.ends_cb.wit_names if n.startswith("pf_")]
    vals_f = [v for uw in zip(uf, wf) for v in uw]
    for name, v in zip(names_f, vals_f):
        ecols[name] = v
    G.assign_ext(ecols, "init_claim", init_claims)
    G.assign_ext(ecols, "final_claim", final_claims)
    ends_wit = np.zeros((len(chips.ends_cb.wit_names), m), np.uint64)
    for i, name in enumerate(chips.ends_cb.wit_names):
        assert name in ecols, name
        ends_wit[i] = np.asarray(ecols[name], np.uint64) % np.uint64(bb.P)
    return rounds_wit, ends_wit, final_claims, final_states


# ---------------------------------------------------------------------------
# Merkle-path chip (RECURSION.md build order #4): one row = one tree level
# of one query walk. The row muxes (cur, sib) by the index bit, runs the
# 2-to-1 Poseidon2 compression in-circuit (compress = permute(l||r)[:8],
# hash/poseidon2.py:225), and chains (digest, index) over the bus:
#
#   reads  (MerklePath, qid, level,   idx,      cur[8])
#   writes (MerklePath, qid, level+1, idx_next, out[8])
#   with   idx == 2 * idx_next + bit,  bit boolean
#
# The endpoints chip writes each query's (leaf digest, leaf index) at level
# 0 and reads the walk's end at a fixed depth, pinning leaf digest, index,
# depth, and root as witness wires for the outer statement.
# ---------------------------------------------------------------------------

TAG_MERKLE_PATH = 5


@dataclass
class MerklePathChips:
    rows_cb: CircuitBuilder
    rows_compiled: object
    ends_cb: CircuitBuilder
    ends_compiled: object
    depth: int


def build_merkle_path_chips(depth: int) -> MerklePathChips:
    cb = CircuitBuilder("merkle_path_rows")
    qid = cb.create_witin("qid")
    level = cb.create_witin("level")
    idx = cb.create_witin("idx")
    idx_next = cb.create_witin("idx_next")
    bit = cb.create_witin("bit")
    cb.assert_bit("bit_bool", bit)
    cb.require_zero("idx_split", idx - (idx_next * 2 + bit))
    cur = [cb.create_witin(f"cur{j}") for j in range(8)]
    sib = [cb.create_witin(f"sib{j}") for j in range(8)]
    # mux: left = bit ? sib : cur ; right = bit ? cur : sib. Lin carries
    # only constant coefficients, so the muxed halves are witnessed wires
    # tied down by the degree-2 select equations below.
    lw = [cb.create_witin(f"l{j}") for j in range(8)]
    rw = [cb.create_witin(f"r{j}") for j in range(8)]
    for j in range(8):
        cb.require_zero(f"mux_l{j}", lw[j] - (cur[j] + bit * (sib[j] - cur[j])))
        cb.require_zero(f"mux_r{j}", rw[j] - (sib[j] + bit * (cur[j] - sib[j])))
    state = [Lin.col(w) for w in lw] + [Lin.col(w) for w in rw]
    out = build_poseidon2(cb, "pc", state)
    head = [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), qid]
    cb.read_record(head + [level, idx] + [Lin.col(c).to_expr() for c in cur])
    cb.write_record(head + [level + 1, idx_next]
                    + [out[j].to_expr() for j in range(8)])
    rows_compiled = compile_chip(cb)

    eb = CircuitBuilder("merkle_path_ends")
    eqid = eb.create_witin("qid")
    leaf_idx = eb.create_witin("leaf_idx")
    leaf = [eb.create_witin(f"leaf{j}") for j in range(8)]
    root = [eb.create_witin(f"root{j}") for j in range(8)]
    ehead = [E.Const(RAM_CUSTOM), E.Const(TAG_MERKLE_PATH), eqid]
    eb.write_record(ehead + [E.Const(0), leaf_idx]
                    + [Lin.col(w).to_expr() for w in leaf])
    eb.read_record(ehead + [E.Const(depth), E.Const(0)]
                   + [Lin.col(w).to_expr() for w in root])
    ends_compiled = compile_chip(eb)
    return MerklePathChips(cb, rows_compiled, eb, ends_compiled, depth)


def assign_merkle_paths(chips: MerklePathChips, walks: list):
    """Witgen. ``walks``: per query dict with
        index (int), leaf (8,) digest, path (depth, 8) sibling digests.
    Returns (rows_wit, ends_wit, roots (m, 8))."""
    depth = chips.depth
    m = len(walks)
    n_rows = m * depth
    qid = np.repeat(np.arange(m, dtype=np.uint64), depth)
    level = np.tile(np.arange(depth, dtype=np.uint64), m)
    idx = np.zeros(n_rows, np.uint64)
    bit = np.zeros(n_rows, np.uint64)
    idx_next = np.zeros(n_rows, np.uint64)
    cur = np.zeros((n_rows, 8), np.uint64)
    sib = np.zeros((n_rows, 8), np.uint64)
    leaf_idx = np.zeros(m, np.uint64)
    leafs = np.zeros((m, 8), np.uint64)
    roots = np.zeros((m, 8), np.uint64)
    for i, w in enumerate(walks):
        ix = int(w["index"])
        leaf_idx[i] = ix
        d = np.asarray(w["leaf"], np.uint64)
        leafs[i] = d
        path = np.asarray(w["path"], np.uint64)
        assert path.shape == (depth, 8)
        for lv in range(depth):
            row = i * depth + lv
            idx[row] = ix
            bit[row] = ix & 1
            idx_next[row] = ix >> 1
            cur[row] = d
            sib[row] = path[lv]
            l, r = (path[lv], d) if ix & 1 else (d, path[lv])
            d = p2.compress_host(l, r)
            ix >>= 1
        roots[i] = d
    lw = np.where(bit[:, None] == 1, sib, cur)
    rw_ = np.where(bit[:, None] == 1, cur, sib)
    cols = {"qid": qid, "level": level, "idx": idx, "idx_next": idx_next,
            "bit": bit}
    for j in range(8):
        cols[f"cur{j}"] = cur[:, j]
        cols[f"sib{j}"] = sib[:, j]
        cols[f"l{j}"] = lw[:, j]
        cols[f"r{j}"] = rw_[:, j]
    up, wp, _out = assign_poseidon2(np.concatenate([lw, rw_], axis=1))
    names_p = [n for n in chips.rows_cb.wit_names if n.startswith("pc_")]
    vals_p = [v for uw in zip(up, wp) for v in uw]
    for name, v in zip(names_p, vals_p):
        cols[name] = v
    rows_wit = np.zeros((len(chips.rows_cb.wit_names), n_rows), np.uint64)
    for i, name in enumerate(chips.rows_cb.wit_names):
        assert name in cols, name
        rows_wit[i] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)

    ecols = {"qid": np.arange(m, dtype=np.uint64), "leaf_idx": leaf_idx}
    for j in range(8):
        ecols[f"leaf{j}"] = leafs[:, j]
        ecols[f"root{j}"] = roots[:, j]
    ends_wit = np.zeros((len(chips.ends_cb.wit_names), m), np.uint64)
    for i, name in enumerate(chips.ends_cb.wit_names):
        ends_wit[i] = np.asarray(ecols[name], np.uint64) % np.uint64(bb.P)
    return rows_wit, ends_wit, roots


# ---------------------------------------------------------------------------
# Tower-verify recombination chips (RECURSION.md build order #5, "tower
# claims"): the in-circuit mirror of gkr/tower.py::verify_towers. Reference
# role: the TowerVerify table of the recursion VM (ceno_recursion_v2 /
# scheme/verifier.rs:1371 re-expressed as AIR rows).
#
# Three chips compose over the RAM_CUSTOM bus:
#   * the existing sumcheck ROUNDS chip (build_sumcheck_verify_chips) proves
#     every per-level sumcheck reduction — level k of tower `inst` is
#     sumcheck instance inst*n_vars + k (k rounds, naturally variable-length
#     because the rounds chip is row-per-round);
#   * a BOUNDARY chip, one row per (inst, level), level = 1..n_vars-1:
#       reads  (TowerClaim, inst, level,  claims_in[n_claims])
#       writes (SumcheckClaim, inst*n_vars+level, 0, sum_i alpha_i*claims_i)
#       reads  (SumcheckClaim, inst*n_vars+level, level, final_claim)
#       checks final_claim == eq_v * (sum_s alpha * rel_s(evals))   with
#              rel = L*R for prods, pL*qR+pR*qL and qL*qR for logups
#       writes (TowerClaim, inst, level+1, fold_two(eval pairs, mu))
#   * an ENDS chip, one row per tower instance: folds the absorbed layer-1
#     outs at rt0 into the level-1 claims (bus write), reads back the final
#     record claims at level n_vars, and exposes the claimed totals
#     (products / fraction parts) as gadget wires the outer statement binds.
#
# Challenges (rt0, alphas, mu) are witness wires here — bound by the outer
# statement exactly like build order #2; the FS duplex chips (build order
# #3) replace them when the full transcript chain is wired. eq_v is NOT a
# free wire: each boundary row starts an eq1 chain on the bus and the
# shared eq-rows chip (build_eq_rows_chip) computes eq(rt, point) factor by
# factor; the boundary reads the finished product back.
# ---------------------------------------------------------------------------

TAG_TOWER_CLAIM = 6
TAG_EQ_CHAIN = 7


def build_eq_rows_chip(bind: bool = False):
    """The generic eq1-chain rows chip: one row multiplies a running product
    by eq1(z, r) = 1 - z - r + 2zr (one eq factor per point coordinate),
    chained over the bus as (EqChain, cid, k, acc) -> (EqChain, cid, k+1,
    acc * eq1). Shared by the jagged-weight and tower-eq recombinations —
    any consumer starts a chain by writing (EqChain, cid, 0, 1) and reads
    the finished product back at its chain length.

    ``bind``: both coordinates are looked up on the FS challenge table
    (gkr/fs_chain.py) under FIXED cids — used by the tower chains whose z
    (rt coords) and r (sumcheck round challenges) are all transcript
    samples, so eq_v is fully transcript-derived."""
    cb = CircuitBuilder("eq_chain_rows" + ("_fs" if bind else ""))
    cid = cb.create_witin("cid")
    k = cb.create_witin("k")
    z = G.ext_witness(cb, "z")
    r = G.ext_witness(cb, "r")
    acc_in = G.ext_witness(cb, "acc")
    zr = G.ext_mul(cb, "zr", z, r)
    one = G.ExtWire.constant(exth.one())
    factor = one.sub(z).sub(r).add(zr.scale(2))
    acc_out = G.ext_mul(cb, "accn", acc_in, factor)
    head = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), cid]
    cb.read_record(head + [k] + acc_in.c)
    cb.write_record(head + [k + 1] + acc_out.c)
    if bind:
        from . import fs_chain as FS

        zcid = cb.create_fixed("zcid")
        rcid = cb.create_fixed("rcid")
        cb.lk_record(FS.LK_AGG_CHAL, [zcid] + list(z.c))
        cb.lk_record(FS.LK_AGG_CHAL, [rcid] + list(r.c))
    return cb, compile_chip(cb)


class _EqRowsCollector:
    """Witgen-side accumulator matching build_eq_rows_chip's columns."""

    def __init__(self):
        self.cid: list = []
        self.k: list = []
        self.z: list = []
        self.r: list = []
        self.acc: list = []
        self.zr: list = []
        self.accn: list = []
        self.zcid: list = []
        self.rcid: list = []

    def chain(self, cid: int, zs, rs, z_cids=None, r_cids=None, reg=None):
        """Walk one eq1 chain (zs, rs: (n, 4) point lists) starting from
        acc=1; returns the final product (= eq(zs, rs)). With ``z_cids`` /
        ``r_cids`` (FS binding) the per-factor challenge-table cids are
        recorded and their lookups counted on ``reg``."""
        zs = np.asarray(zs, np.uint64)
        rs = np.asarray(rs, np.uint64)
        acc = exth.one()
        one = exth.one()
        for kk in range(zs.shape[0]):
            zk, rk = zs[kk], rs[kk]
            self.cid.append(cid)
            self.k.append(kk)
            self.z.append(zk)
            self.r.append(rk)
            if z_cids is not None:
                self.zcid.append(z_cids[kk])
                self.rcid.append(r_cids[kk])
                if reg is not None:
                    reg.use(z_cids[kk])
                    reg.use(r_cids[kk])
            self.acc.append(acc)
            zr = exth.mul(zk, rk)
            self.zr.append(zr)
            f = exth.sub(exth.add(one, exth.add(zr, zr)), exth.add(zk, rk))
            acc = exth.mul(acc, f)
            self.accn.append(acc)
        return acc

    def materialize(self, cb: CircuitBuilder) -> np.ndarray:
        n = len(self.cid)
        cols: dict = {
            "cid": np.array(self.cid, np.uint64),
            "k": np.array(self.k, np.uint64),
        }
        for name, vals in (("z", self.z), ("r", self.r), ("acc", self.acc),
                           ("zr", self.zr), ("accn", self.accn)):
            arr = np.stack(vals) if n else np.zeros((0, 4), np.uint64)
            G.assign_ext(cols, name, arr)
        wit = np.zeros((len(cb.wit_names), n), np.uint64)
        for j, name in enumerate(cb.wit_names):
            wit[j] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)
        return wit

    def materialize_fixed(self) -> np.ndarray:
        return np.array([self.zcid, self.rcid], np.uint64)


@dataclass
class TowerVerifyChips:
    rounds_cb: CircuitBuilder
    rounds_compiled: object
    bound_cb: CircuitBuilder
    bound_compiled: object
    ends_cb: CircuitBuilder
    ends_compiled: object
    eqrows_cb: CircuitBuilder
    eqrows_compiled: object
    s_p: int
    s_l: int
    n_vars: int
    sc_base: int = 0


def build_tower_verify_chips(s_p: int, s_l: int, n_vars: int,
                             sc_base: int = 0,
                             bind: bool = False) -> TowerVerifyChips:
    n_claims = s_p + 2 * s_l
    n_evals = 2 * s_p + 4 * s_l
    sc = build_sumcheck_verify_chips(3, n_vars, bind=bind)
    if bind:
        from . import fs_chain as FS

    # -- boundary chip (one row per (inst, level)) ---------------------------
    cb = CircuitBuilder("tower_verify_bounds" + ("_fs" if bind else ""))
    inst = cb.create_witin("inst")
    level = cb.create_witin("level")
    claims_in = [G.ext_witness(cb, f"cin{i}") for i in range(n_claims)]
    alphas = [G.ext_witness(cb, f"al{i}") for i in range(n_claims)]
    evals = [G.ext_witness(cb, f"ev{e}") for e in range(n_evals)]
    mu = G.ext_witness(cb, "mu")
    eq_v = G.ext_witness(cb, "eqv")
    final_claim = G.ext_witness(cb, "fc")

    # batched claim entering the level's sumcheck
    bt = [G.ext_mul(cb, f"bt{i}", alphas[i], claims_in[i]) for i in range(n_claims)]
    batched = bt[0]
    for t in bt[1:]:
        batched = batched.add(t)
    sc_inst = inst * n_vars + level + sc_base
    schead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), sc_inst]
    cb.write_record(schead + [E.Const(0)] + batched.c)
    cb.read_record(schead + [level] + final_claim.c)
    # eq_v = eq(rt, point) is COMPUTED in-circuit: the boundary row starts a
    # generic eq1-chain (the jagged rows chip walks it, one factor per rt
    # coordinate) and reads the level-length product back.
    eqhead = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), sc_inst]
    cb.write_record(eqhead + [E.Const(0)]
                    + G.ExtWire.constant(exth.one()).c)
    cb.read_record(eqhead + [level] + eq_v.c)

    # recombination: final_claim == eq_v * sum_s alpha-weighted relations
    terms = []
    e = 0
    a = 0
    for s in range(s_p):
        pr = G.ext_mul(cb, f"pr{s}", evals[e], evals[e + 1])
        terms.append(G.ext_mul(cb, f"apr{s}", alphas[a], pr))
        e += 2
        a += 1
    for s in range(s_l):
        pL, pR, qL, qR = evals[e], evals[e + 1], evals[e + 2], evals[e + 3]
        n1 = G.ext_mul(cb, f"n1_{s}", pL, qR)
        n2 = G.ext_mul(cb, f"n2_{s}", pR, qL)
        terms.append(G.ext_mul(cb, f"an{s}", alphas[a], n1.add(n2)))
        qq = G.ext_mul(cb, f"qq{s}", qL, qR)
        terms.append(G.ext_mul(cb, f"aq{s}", alphas[a + 1], qq))
        e += 4
        a += 2
    acc = terms[0]
    for t in terms[1:]:
        acc = acc.add(t)
    chk = G.ext_mul(cb, "eacc", eq_v, acc)
    G.ext_require_equal(cb, "recomb", chk, final_claim)

    # claim chain: read this level's claims, write the mu-folded next claims
    thead = [E.Const(RAM_CUSTOM), E.Const(TAG_TOWER_CLAIM), inst]
    cb.read_record(thead + [level] + [c for w in claims_in for c in w.c])
    folded = []
    e = 0
    for s in range(s_p):
        d = G.ext_mul(cb, f"fdp{s}", mu, evals[e + 1].sub(evals[e]))
        folded.append(evals[e].add(d))
        e += 2
    for s in range(s_l):
        dp = G.ext_mul(cb, f"fdlp{s}", mu, evals[e + 1].sub(evals[e]))
        folded.append(evals[e].add(dp))
        dq = G.ext_mul(cb, f"fdlq{s}", mu, evals[e + 3].sub(evals[e + 2]))
        folded.append(evals[e + 2].add(dq))
        e += 4
    cb.write_record(thead + [level + 1] + [c for w in folded for c in w.c])
    if bind:
        # FS binding: the boundary row supplies this level's absorbed evals
        # to the duplex (fixed base index eidx), derives the level's alpha
        # powers from the pow-chain lookup rows (fixed cid base alcid) and
        # mu from the challenge table (fixed mcid).
        b_eidx = cb.create_fixed("eidx")
        b_alcid = cb.create_fixed("alcid")
        b_mcid = cb.create_fixed("mcid")
        for ei in range(n_evals):
            for j in range(4):
                cb.write_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_ABS_SLOT),
                                 b_eidx + (4 * ei + j), evals[ei].c[j]])
        for i in range(n_claims):
            cb.lk_record(FS.LK_AGG_CHAL, [b_alcid + i] + list(alphas[i].c))
        cb.lk_record(FS.LK_AGG_CHAL, [b_mcid] + list(mu.c))
    bound_compiled = compile_chip(cb)

    # -- ends chip (one row per tower instance) ------------------------------
    eb = CircuitBuilder("tower_verify_ends" + ("_fs" if bind else ""))
    einst = eb.create_witin("inst")
    rt0 = G.ext_witness(eb, "rt0")
    init_claims = []
    absorbed = []   # layer-1 outs in transcript absorb order
    for s in range(s_p):
        o0 = G.ext_witness(eb, f"po{s}0")
        o1 = G.ext_witness(eb, f"po{s}1")
        absorbed += [o0, o1]
        G.ext_mul(eb, f"pv{s}", o0, o1)  # claimed total product (outer binds)
        ic = o0.add(G.ext_mul(eb, f"icp{s}", rt0, o1.sub(o0)))
        init_claims.append(ic)
    for s in range(s_l):
        p0 = G.ext_witness(eb, f"lp{s}0")
        p1 = G.ext_witness(eb, f"lp{s}1")
        q0 = G.ext_witness(eb, f"lq{s}0")
        q1 = G.ext_witness(eb, f"lq{s}1")
        absorbed += [p0, p1, q0, q1]
        # claimed total fraction: num = p0*q1 + p1*q0, den = q0*q1
        G.ext_mul(eb, f"fn1_{s}", p0, q1)
        G.ext_mul(eb, f"fn2_{s}", p1, q0)
        G.ext_mul(eb, f"fq{s}", q0, q1)
        icp = p0.add(G.ext_mul(eb, f"iclp{s}", rt0, p1.sub(p0)))
        icq = q0.add(G.ext_mul(eb, f"iclq{s}", rt0, q1.sub(q0)))
        init_claims.extend([icp, icq])
    rc = [G.ext_witness(eb, f"rc{i}") for i in range(n_claims)]
    ehead = [E.Const(RAM_CUSTOM), E.Const(TAG_TOWER_CLAIM), einst]
    eb.write_record(ehead + [E.Const(1)] + [c for w in init_claims for c in w.c])
    eb.read_record(ehead + [E.Const(n_vars)] + [c for w in rc for c in w.c])
    if bind:
        # publish each record claim for the batch-link rows (claim_link.py)
        for jc in range(n_claims):
            eb.write_record([E.Const(RAM_CUSTOM), E.Const(TAG_REC_CLAIM),
                             einst, E.Const(jc)] + rc[jc].c)
    if bind:
        # FS binding: the ends row supplies the absorbed layer-1 outs and
        # derives rt0 from the challenge table.
        e_oidx = eb.create_fixed("oidx")
        e_rcid = eb.create_fixed("rcid")
        for wi, w in enumerate(absorbed):
            for j in range(4):
                eb.write_record([E.Const(RAM_CUSTOM), E.Const(FS.TAG_ABS_SLOT),
                                 e_oidx + (4 * wi + j), w.c[j]])
        eb.lk_record(FS.LK_AGG_CHAL, [e_rcid] + list(rt0.c))
    ends_compiled = compile_chip(eb)
    eq_cb, eq_compiled = build_eq_rows_chip(bind=bind)
    return TowerVerifyChips(sc.rounds_cb, sc.rounds_compiled,
                            cb, bound_compiled, eb, ends_compiled,
                            eq_cb, eq_compiled,
                            s_p, s_l, n_vars, sc_base)


def assign_tower_verify(chips: TowerVerifyChips, proofs: list,
                        transcript: Transcript, inst0: int = 0,
                        fixed_out: dict | None = None):
    """Witgen by transcript replay (the witgen mirror of verify_towers).

    ``proofs``: list of TowerProof, all with the same n_vars and the chip's
    (s_p, s_l) spec shape; ``transcript`` must be positioned exactly where
    the verifier's would be (absorbs happen here). Returns
    (rounds_wit, bound_wit, eqrows_wit, ends_wit,
    record_claims (m, n_claims, 4)) — eqrows_wit carries the eq1-chain
    rows (build_eq_rows_chip) that compute each boundary row's
    eq_v = eq(rt, point) in-circuit.
    ``inst0`` offsets the tower instance ids (and thus the TowerClaim and
    SumcheckClaim bus keys, the latter also shifted by the build-time
    sc_base) so multiple groups share one global bus namespace.

    FS binding: when ``chips`` was built with bind=True, ``transcript`` must
    be a registry-carrying ``ChainTranscript`` cursor (gkr/fs_chain.py) —
    every absorb is claimed for the consumer rows, every challenge is
    registered on the challenge table / pow chains, and ``fixed_out`` (a
    dict) receives the chips' fixed schedule matrices under keys
    "rounds"/"bound"/"ends"/"eqrows"."""
    from ..sumcheck.verifier import lagrange_extrapolate, verify as sc_verify

    s_p, s_l, n_vars = chips.s_p, chips.s_l, chips.n_vars
    n_claims = s_p + 2 * s_l
    m = len(proofs)
    P = np.uint64(bb.P)
    bind = "eidx" in chips.bound_cb.fixed_names
    if bind:
        assert hasattr(transcript, "registry"), \
            "FS-bound tower chips need a ChainTranscript cursor"
        reg = transcript.registry

    sc_rows = []          # dicts for the rounds chip
    brows: dict = {k: [] for k in ("inst", "level")}
    bfix: dict = {k: [] for k in ("eidx", "alcid", "mcid")}
    eq_z_cids: list = []  # per-chain z cids (rt coord registrations)
    efix: dict = {k: [] for k in ("oidx", "rcid")}
    bext: dict = {}       # name -> list of (4,) values, boundary ext wires
    eqrows = _EqRowsCollector()
    erows: dict = {"inst": inst0 + np.arange(m, dtype=np.uint64)}
    eext: dict = {}
    record_claims = np.zeros((m, n_claims, 4), np.uint64)
    rt_list: list = []
    rt_cids_list: list = []

    def bput(name, v):
        bext.setdefault(name, []).append(np.asarray(v, np.uint64))

    def eput(name, v):
        eext.setdefault(name, []).append(np.asarray(v, np.uint64))

    for i, proof in enumerate(proofs):
        assert proof.prod_out.shape[0] == s_p
        assert proof.logup_out.shape[0] == s_l
        outs = np.concatenate(
            [proof.prod_out[s].ravel() for s in range(s_p)]
            + [proof.logup_out[s].ravel() for s in range(s_l)]
        ) if (s_p or s_l) else np.zeros(0, np.uint64)
        if bind:
            efix["oidx"].append(transcript.append_slots(outs))
            rcid0, rt0v = transcript.sample_ext_chal()
            reg.use(rcid0)     # the ends row's rt0 lookup
            efix["rcid"].append(rcid0)
            rt = rt0v[None]
            rt_cids = [rcid0]
        else:
            transcript.append(outs)
            rt = np.array([transcript.sample_ext()], np.uint64)
        eput("rt0", rt[0])
        claims = []
        for s in range(s_p):
            o0, o1 = proof.prod_out[s][0], proof.prod_out[s][1]
            eput(f"po{s}0", o0)
            eput(f"po{s}1", o1)
            eput(f"pv{s}", G.ext_mul_host(o0, o1))
            eput(f"icp{s}", G.ext_mul_host(rt[0], exth.sub(o1, o0)))
            claims.append(_fold2(o0, o1, rt[0]))
        for s in range(s_l):
            (p0, p1), (q0, q1) = proof.logup_out[s][0], proof.logup_out[s][1]
            for nm, v in ((f"lp{s}0", p0), (f"lp{s}1", p1),
                          (f"lq{s}0", q0), (f"lq{s}1", q1)):
                eput(nm, v)
            eput(f"fn1_{s}", G.ext_mul_host(p0, q1))
            eput(f"fn2_{s}", G.ext_mul_host(p1, q0))
            eput(f"fq{s}", G.ext_mul_host(q0, q1))
            eput(f"iclp{s}", G.ext_mul_host(rt[0], exth.sub(p1, p0)))
            eput(f"iclq{s}", G.ext_mul_host(rt[0], exth.sub(q1, q0)))
            claims.extend([_fold2(p0, p1, rt[0]), _fold2(q0, q1, rt[0])])

        for level in range(1, n_vars):
            if bind:
                alcid0, alphas = transcript.sample_ext_pows_chal(n_claims)
                for j in range(n_claims):
                    reg.use(alcid0 + j)   # the boundary row's alpha lookups
            else:
                alphas = transcript.sample_ext_pows(n_claims)
            batched = np.zeros(4, np.uint64)
            for j in range(n_claims):
                batched = exth.add(batched, exth.mul(alphas[j], claims[j]))
            msgs = np.asarray(proof.round_msgs[level - 1], np.uint64)
            sc_inst = (inst0 + i) * n_vars + level + chips.sc_base
            if bind:
                # manual replay so each round's absorb slots + challenge cid
                # land in the rounds chip's fixed schedule columns
                chals = np.zeros((level, 4), np.uint64)
                rnd_cids = []
                cur = batched
                for r in range(level):
                    aidx = transcript.append_slots(msgs[r].ravel())
                    acid, ch = transcript.sample_ext_chal()
                    reg.use(acid)     # the rounds row's alpha lookup
                    chals[r] = ch
                    rnd_cids.append(acid)
                    sc_rows.append({
                        "inst": sc_inst, "round": r,
                        "ys": msgs[r], "alpha": ch, "claim_in": cur,
                        "aidx": aidx, "acid": acid,
                    })
                    cur = lagrange_extrapolate(msgs[r], ch)
                point = chals[::-1].copy()
                point_cids = rnd_cids[::-1]
                final_claim = cur
            else:
                point, final_claim = sc_verify(
                    batched, msgs, level, transcript, deg=3
                )
                chals = point[::-1].copy()
                # rounds-chip rows for this level's sumcheck instance
                cur = batched
                for r in range(level):
                    sc_rows.append({
                        "inst": sc_inst,
                        "round": r,
                        "ys": msgs[r], "alpha": chals[r], "claim_in": cur,
                    })
                    cur = lagrange_extrapolate(msgs[r], chals[r])
                replay.check(np.array_equal(cur, final_claim))

            evals = np.asarray(proof.level_evals[level - 1], np.uint64)
            # eq_v is computed in-circuit by an eq1 chain of `level` rows
            # keyed on this level's sumcheck instance id
            eq_v = eqrows.chain(
                sc_inst, rt.astype(np.uint64), point,
                z_cids=rt_cids if bind else None,
                r_cids=point_cids if bind else None,
                reg=reg if bind else None,
            )
            replay.check(np.array_equal(
                eq_v, exth.eq_eval(rt.astype(np.uint64), point)))
            brows["inst"].append(inst0 + i)
            brows["level"].append(level)
            for j in range(n_claims):
                bput(f"cin{j}", claims[j])
                bput(f"al{j}", alphas[j])
                bput(f"bt{j}", exth.mul(alphas[j], claims[j]))
            for ei in range(evals.shape[0]):
                bput(f"ev{ei}", evals[ei])
            bput("eqv", eq_v)
            bput("fc", final_claim)
            acc = np.zeros(4, np.uint64)
            e = 0
            a = 0
            for s in range(s_p):
                pr = exth.mul(evals[e], evals[e + 1])
                bput(f"pr{s}", pr)
                t = exth.mul(alphas[a], pr)
                bput(f"apr{s}", t)
                acc = exth.add(acc, t)
                e += 2
                a += 1
            for s in range(s_l):
                pLv, pRv, qLv, qRv = evals[e], evals[e + 1], evals[e + 2], evals[e + 3]
                n1 = exth.mul(pLv, qRv)
                n2 = exth.mul(pRv, qLv)
                bput(f"n1_{s}", n1)
                bput(f"n2_{s}", n2)
                t = exth.mul(alphas[a], exth.add(n1, n2))
                bput(f"an{s}", t)
                acc = exth.add(acc, t)
                qq = exth.mul(qLv, qRv)
                bput(f"qq{s}", qq)
                t2 = exth.mul(alphas[a + 1], qq)
                bput(f"aq{s}", t2)
                acc = exth.add(acc, t2)
                e += 4
                a += 2
            bput("eacc", exth.mul(eq_v, acc))
            if not np.array_equal(exth.mul(eq_v, acc), final_claim) \
                    and not replay.structure_only():
                raise ValueError(f"tower {i} level {level}: recombination mismatch")
            if bind:
                bfix["eidx"].append(transcript.append_slots(evals.ravel()))
                bfix["alcid"].append(alcid0)
                mcid, mu = transcript.sample_ext_chal()
                reg.use(mcid)     # the boundary row's mu lookup
                bfix["mcid"].append(mcid)
                rt_cids = point_cids + [mcid]
            else:
                transcript.append(evals.ravel())
                mu = np.array(transcript.sample_ext(), np.uint64)
            bput("mu", mu)
            rt = np.concatenate([point, mu[None, :]], axis=0)
            new_claims = []
            e = 0
            for s in range(s_p):
                bput(f"fdp{s}", exth.mul(mu, exth.sub(evals[e + 1], evals[e])))
                new_claims.append(_fold2(evals[e], evals[e + 1], mu))
                e += 2
            for s in range(s_l):
                bput(f"fdlp{s}", exth.mul(mu, exth.sub(evals[e + 1], evals[e])))
                new_claims.append(_fold2(evals[e], evals[e + 1], mu))
                bput(f"fdlq{s}", exth.mul(mu, exth.sub(evals[e + 3], evals[e + 2])))
                new_claims.append(_fold2(evals[e + 2], evals[e + 3], mu))
                e += 4
            claims = new_claims
        for j in range(n_claims):
            record_claims[i, j] = claims[j]
            eput(f"rc{j}", claims[j])
        rt_list.append(rt.copy())
        if bind:
            rt_cids_list.append(list(rt_cids))

    # -- materialize witness matrices ----------------------------------------
    n_sc = len(sc_rows)
    scols: dict = {
        "inst": np.array([r["inst"] for r in sc_rows], np.uint64),
        "round": np.array([r["round"] for r in sc_rows], np.uint64),
    }
    ys = np.stack([r["ys"] for r in sc_rows]) if n_sc else np.zeros((0, 4, 4), np.uint64)
    al = np.stack([r["alpha"] for r in sc_rows]) if n_sc else np.zeros((0, 4), np.uint64)
    ci = np.stack([r["claim_in"] for r in sc_rows]) if n_sc else np.zeros((0, 4), np.uint64)
    for k in range(4):
        G.assign_ext(scols, f"y{k}", ys[:, k])
    G.assign_ext(scols, "alpha", al)
    G.assign_ext(scols, "claim_in", ci)
    G.assign_lagrange(scols, "lag", ys, al, 3)
    rounds_wit = np.zeros((len(chips.rounds_cb.wit_names), n_sc), np.uint64)
    for j, name in enumerate(chips.rounds_cb.wit_names):
        rounds_wit[j] = np.asarray(scols[name], np.uint64) % P

    n_b = len(brows["inst"])
    bcols: dict = {
        "inst": np.array(brows["inst"], np.uint64),
        "level": np.array(brows["level"], np.uint64),
    }
    for name, vals in bext.items():
        G.assign_ext(bcols, name, np.stack(vals))
    bound_wit = np.zeros((len(chips.bound_cb.wit_names), n_b), np.uint64)
    if n_b:
        for j, name in enumerate(chips.bound_cb.wit_names):
            assert name in bcols, name
            bound_wit[j] = np.asarray(bcols[name], np.uint64) % P

    ecols: dict = dict(erows)
    for name, vals in eext.items():
        G.assign_ext(ecols, name, np.stack(vals))
    ends_wit = np.zeros((len(chips.ends_cb.wit_names), m), np.uint64)
    for j, name in enumerate(chips.ends_cb.wit_names):
        assert name in ecols, name
        ends_wit[j] = np.asarray(ecols[name], np.uint64) % P
    eqrows_wit = eqrows.materialize(chips.eqrows_cb)
    if bind and fixed_out is not None:
        fixed_out["rounds"] = np.array(
            [[r["aidx"] for r in sc_rows], [r["acid"] for r in sc_rows]],
            np.uint64,
        )
        fixed_out["bound"] = np.array(
            [bfix["eidx"], bfix["alcid"], bfix["mcid"]], np.uint64
        )
        fixed_out["ends"] = np.array([efix["oidx"], efix["rcid"]], np.uint64)
        fixed_out["eqrows"] = eqrows.materialize_fixed()
        # the towers' final points + their challenge cids (claim-link input)
        fixed_out["rt"] = rt_list
        fixed_out["rt_cids"] = rt_cids_list
    return rounds_wit, bound_wit, eqrows_wit, ends_wit, record_claims


def _fold2(v0, v1, r):
    return exth.add(np.asarray(v0, np.uint64),
                    exth.mul(np.asarray(r, np.uint64),
                             exth.sub(np.asarray(v1, np.uint64),
                                      np.asarray(v0, np.uint64))))


# ---------------------------------------------------------------------------
# Jagged-translation recombination chips (RECURSION.md build order #5,
# "jagged weights"): the in-circuit mirror of pcs/jagged.py::verify_jagged's
# analytic w_c(r) recombination. Reference role: the jagged-PCS verify
# tables of the recursion VM (the default PcsKind is Jagged<Basefold>,
# ceno_zkvm/src/e2e.rs:103-129).
#
# Key uniformity: EVERY weight factor — eq(z_k, r_k) over the claim's point
# vars AND the slice-index tail bits — is the same bilinear form
#     eq1(z, r) = 1 - z - r + 2*z*r
# with z either a point coordinate or the bit constant, so the chain chip
# has one row shape for all log_r levels of every claim.
#
# Chips over the RAM_CUSTOM bus (tags below):
#   * EQ-ROWS chip, row per (claim, var k = 0..log_r-1):
#       reads  (EqChain, cid, k,   acc)
#       writes (EqChain, cid, k+1, acc * eq1(z_k, r_k))
#   * CLAIM chip, row per claim t (cid = t, globally numbered):
#       writes (EqChain, cid, 0, 1)                     -- chain start
#       reads  (EqChain, cid, log_r, w)                 -- the weight
#       reads  (EqSum, jid, t, S)   writes (EqSum, jid, t+1, S + gamma*w*v)
#       reads  (BSum,  jid, t, B)   writes (BSum,  jid, t+1, B + gamma*value)
#   * FINAL chip, one row per jagged opening jid:
#       writes (EqSum, jid, 0, 0) and (BSum, jid, 0, 0)
#       reads  (EqSum, jid, n_claims, total)
#       reads  (BSum,  jid, n_claims, btotal)
#       writes (SumcheckClaim, sc_inst, 0, btotal)      -- translation claim
#       reads  (SumcheckClaim, sc_inst, log_r, fc), requires fc == total
#     so composed with the sumcheck ROUNDS chip the whole translation
#     argument is verified in-circuit; gammas/points/v_evals are witness
#     wires the outer statement (FS chips) binds.
# ---------------------------------------------------------------------------

TAG_EQ_SUM = 8
TAG_B_SUM = 9


@dataclass
class JaggedVerifyChips:
    rows_cb: CircuitBuilder
    rows_compiled: object
    claims_cb: CircuitBuilder
    claims_compiled: object
    final_cb: CircuitBuilder
    final_compiled: object
    log_r: int
    n_claims: int


def build_jagged_verify_chips(log_r: int, n_claims: int,
                              bind: bool = False) -> JaggedVerifyChips:
    # -- eq-chain rows chip (shared shape with the tower eq chains) -----------
    # bind=True: BOTH chain coordinates are challenge-table lookups — z is a
    # class-main / EC point coordinate or a key-fixed 0/1 slice-index bit
    # (fs_const table row), r a translation-sumcheck round challenge.
    cb, rows_compiled = build_eq_rows_chip(bind=bind)
    one = G.ExtWire.constant(exth.one())

    # -- per-claim chip -------------------------------------------------------
    qb = CircuitBuilder("jagged_claims" + ("_fs" if bind else ""))
    jid = qb.create_witin("jid")
    t = qb.create_witin("t")
    qcid = qb.create_witin("cid")
    gamma = G.ext_witness(qb, "gamma")
    value = G.ext_witness(qb, "value")
    v_eval = G.ext_witness(qb, "v")
    w = G.ext_witness(qb, "w")
    s_in = G.ext_witness(qb, "s_in")
    b_in = G.ext_witness(qb, "b_in")
    gw = G.ext_mul(qb, "gw", gamma, w)
    contrib = G.ext_mul(qb, "ctr", gw, v_eval)
    bterm = G.ext_mul(qb, "bt", gamma, value)
    chead = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_CHAIN), qcid]
    qb.write_record(chead + [E.Const(0)] + one.c)
    qb.read_record(chead + [E.Const(log_r)] + w.c)
    shead = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_SUM), jid]
    qb.read_record(shead + [t] + s_in.c)
    qb.write_record(shead + [t + 1] + s_in.add(contrib).c)
    bhead = [E.Const(RAM_CUSTOM), E.Const(TAG_B_SUM), jid]
    qb.read_record(bhead + [t] + b_in.c)
    qb.write_record(bhead + [t + 1] + b_in.add(bterm).c)
    if bind:
        # FS binding: gamma is a pow-chain power, the V_c(r) eval is an
        # absorbed-ext table row — both on the challenge lookup table
        from . import fs_chain as FS

        q_gcid = qb.create_fixed("gcid")
        q_vcid = qb.create_fixed("vcid")
        qb.lk_record(FS.LK_AGG_CHAL, [q_gcid] + list(gamma.c))
        qb.lk_record(FS.LK_AGG_CHAL, [q_vcid] + list(v_eval.c))
    claims_compiled = compile_chip(qb)

    # -- final chip (one row per jagged opening) ------------------------------
    fb = CircuitBuilder("jagged_final")
    fjid = fb.create_witin("jid")
    total = G.ext_witness(fb, "total")
    btotal = G.ext_witness(fb, "btotal")
    fc = G.ext_witness(fb, "fc")
    zero = G.ExtWire.constant(np.zeros(4, np.uint64))
    fshead = [E.Const(RAM_CUSTOM), E.Const(TAG_EQ_SUM), fjid]
    fb.write_record(fshead + [E.Const(0)] + zero.c)
    fb.read_record(fshead + [E.Const(n_claims)] + total.c)
    fbhead = [E.Const(RAM_CUSTOM), E.Const(TAG_B_SUM), fjid]
    fb.write_record(fbhead + [E.Const(0)] + zero.c)
    fb.read_record(fbhead + [E.Const(n_claims)] + btotal.c)
    schead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), fjid]
    fb.write_record(schead + [E.Const(0)] + btotal.c)
    fb.read_record(schead + [E.Const(log_r)] + fc.c)
    G.ext_require_equal(fb, "translation", fc, total)
    final_compiled = compile_chip(fb)
    return JaggedVerifyChips(cb, rows_compiled, qb, claims_compiled,
                             fb, final_compiled, log_r, n_claims)


def assign_jagged_verify(chips: JaggedVerifyChips, layout, claims: list,
                         proof, transcript: Transcript, jid: int = 0,
                         cid_base: int = 0, fixed_out: dict | None = None,
                         z_cid_map: dict | None = None):
    """Witgen mirror of verify_jagged's recombination (+ the translation
    sumcheck's rounds-chip rows). ``transcript`` must sit where the jagged
    verifier's would. Returns (rows_wit, claims_wit, final_wit, sc_cols) —
    sc_cols is the column dict for the deg-2 sumcheck ROUNDS chip
    (build_sumcheck_verify_chips(2, ...).rounds_cb names). ``cid_base``
    offsets the EqChain cids (claim t -> cid_base + t) so jagged chains
    share the global bus namespace with the tower eq chains.

    FS binding (chips built with bind=True; ChainTranscript cursor):
    gammas ride a pow chain, V_c(r) evals become absorbed-ext table rows
    the claim rows look up, the translation sumcheck is slot-bound
    (sc_cols gains "aidx"/"acid"), and ``fixed_out`` receives the claim
    chip's fixed matrix under "claims"."""
    from ..sumcheck.verifier import lagrange_extrapolate, verify as sc_verify

    log_r = chips.log_r
    n_claims = chips.n_claims
    assert len(claims) == n_claims
    P = np.uint64(bb.P)
    bind = "gcid" in chips.claims_cb.fixed_names
    if bind:
        assert hasattr(transcript, "registry"), \
            "FS-bound jagged chips need a ChainTranscript cursor"
        reg = transcript.registry
        gcid0, gammas = transcript.sample_ext_pows_chal(n_claims)
    else:
        gammas = transcript.sample_ext_pows(n_claims)
    btotal = np.zeros(4, np.uint64)
    for tt, cl in enumerate(claims):
        btotal = exth.add(btotal, exth.mul(gammas[tt], np.asarray(cl.value, np.uint64)))
    msgs = np.asarray(proof.trans_msgs, np.uint64)

    # sumcheck rounds rows (deg-2 chip: sc instance id == jid)
    sc_rows: dict = {
        "inst": np.full(log_r, jid, np.uint64),
        "round": np.arange(log_r, dtype=np.uint64),
    }
    cur = btotal
    cins = np.zeros((log_r, 4), np.uint64)
    if bind:
        chals = np.zeros((log_r, 4), np.uint64)
        aidxs = np.zeros(log_r, np.uint64)
        acids = np.zeros(log_r, np.uint64)
        for rr in range(log_r):
            cins[rr] = cur
            aidxs[rr] = transcript.append_slots(msgs[rr].ravel())
            acid, ch = transcript.sample_ext_chal()
            reg.use(acid)
            acids[rr] = acid
            chals[rr] = ch
            cur = lagrange_extrapolate(msgs[rr], ch)
        point = chals[::-1].copy()
        final_claim = cur
        sc_rows["aidx"] = aidxs
        sc_rows["acid"] = acids
        v_evals = np.asarray(proof.v_evals, np.uint64)
        vcids = [transcript.append_ext_chal(v_evals[c])
                 for c in range(v_evals.shape[0])]
    else:
        point, final_claim = sc_verify(btotal, msgs, log_r, transcript,
                                       deg=2)
        chals = point[::-1].copy()
        v_evals = np.asarray(proof.v_evals, np.uint64)
        transcript.append(v_evals.ravel())
        for rr in range(log_r):
            cins[rr] = cur
            cur = lagrange_extrapolate(msgs[rr], chals[rr])
        replay.check(np.array_equal(cur, final_claim))
    for kk in range(3):
        G.assign_ext(sc_rows, f"y{kk}", msgs[:, kk])
    G.assign_ext(sc_rows, "alpha", chals)
    G.assign_ext(sc_rows, "claim_in", cins)
    G.assign_lagrange(sc_rows, "lag", msgs, chals, 2)

    # eq-chain rows + per-claim rows
    n_rows = n_claims * log_r
    zs = np.zeros((n_rows, 4), np.uint64)
    rs = np.zeros((n_rows, 4), np.uint64)
    accs = np.zeros((n_rows, 4), np.uint64)
    zrs = np.zeros((n_rows, 4), np.uint64)
    accns = np.zeros((n_rows, 4), np.uint64)
    ws = np.zeros((n_claims, 4), np.uint64)
    one = exth.one()
    row_zcids = np.zeros(n_rows, np.uint64)
    row_rcids = np.zeros(n_rows, np.uint64)
    if bind:
        assert z_cid_map is not None, \
            "FS-bound jagged chains need the claim points' challenge cids"
        point_cids = [0] * log_r
        # acids are round-order; point = chals[::-1]
        for kk in range(log_r):
            point_cids[kk] = int(acids[log_r - 1 - kk])
    for tt, cl in enumerate(claims):
        ref = layout.slices[cl.slice_idx]
        zpt = np.asarray(cl.z, np.uint64)
        assert zpt.shape[0] == ref.log_h
        if bind:
            zc = z_cid_map.get(np.ascontiguousarray(zpt).tobytes())
            assert zc is not None and len(zc) >= ref.log_h, \
                "jagged claim point has no registered challenge cids"
        acc = one.copy()
        for kk in range(log_r):
            if kk < ref.log_h:
                zk = zpt[kk]
                if bind:
                    zcid = zc[kk]
            else:
                bit = (ref.sub_idx >> (kk - ref.log_h)) & 1
                zk = exth.from_base(np.uint64(bit))
                if bind:
                    zcid = reg.const_cid(zk)
            rk = point[kk].astype(np.uint64)
            row = tt * log_r + kk
            if bind:
                row_zcids[row] = zcid
                row_rcids[row] = point_cids[kk]
                reg.use(zcid)
                reg.use(point_cids[kk])
            zs[row], rs[row], accs[row] = zk, rk, acc
            zr = exth.mul(zk, rk)
            zrs[row] = zr
            f = exth.sub(exth.add(one, exth.add(zr, zr)), exth.add(zk, rk))
            acc = exth.mul(acc, f)
            accns[row] = acc
        ws[tt] = acc
    rcols: dict = {
        "cid": np.repeat(cid_base + np.arange(n_claims, dtype=np.uint64),
                         log_r),
        "k": np.tile(np.arange(log_r, dtype=np.uint64), n_claims),
    }
    G.assign_ext(rcols, "z", zs)
    G.assign_ext(rcols, "r", rs)
    G.assign_ext(rcols, "acc", accs)
    G.assign_ext(rcols, "zr", zrs)
    G.assign_ext(rcols, "accn", accns)
    rows_wit = np.zeros((len(chips.rows_cb.wit_names), n_rows), np.uint64)
    for j, name in enumerate(chips.rows_cb.wit_names):
        rows_wit[j] = np.asarray(rcols[name], np.uint64) % P

    vals = np.stack([np.asarray(cl.value, np.uint64) for cl in claims])
    vcols = np.stack([v_evals[layout.slices[cl.slice_idx].mat_col]
                      for cl in claims])
    gw = exth.mul(gammas, ws)
    contribs = exth.mul(gw, vcols)
    bterms = exth.mul(gammas, vals)
    s_ins = np.zeros((n_claims, 4), np.uint64)
    b_ins = np.zeros((n_claims, 4), np.uint64)
    s = np.zeros(4, np.uint64)
    b = np.zeros(4, np.uint64)
    for tt in range(n_claims):
        s_ins[tt], b_ins[tt] = s, b
        s = exth.add(s, contribs[tt])
        b = exth.add(b, bterms[tt])
    if not np.array_equal(s, final_claim) and not replay.structure_only():
        raise ValueError("jagged recombination mismatch in witgen")
    if bind:
        claim_gcids = []
        claim_vcids = []
        for tt, cl in enumerate(claims):
            claim_gcids.append(gcid0 + tt)
            reg.use(gcid0 + tt)
            vcid = vcids[layout.slices[cl.slice_idx].mat_col]
            claim_vcids.append(vcid)
            reg.use(vcid)
        if fixed_out is not None:
            fixed_out["claims"] = np.array([claim_gcids, claim_vcids],
                                           np.uint64)
            fixed_out["rows"] = np.array([row_zcids, row_rcids], np.uint64)
            # the opening point + its challenge cids + per-matrix-column
            # absorbed-eval cids: the PCS query stage binds against these
            fixed_out["point"] = point
            fixed_out["point_cids"] = point_cids
            fixed_out["vcids"] = list(vcids)
    qcols: dict = {
        "jid": np.full(n_claims, jid, np.uint64),
        "t": np.arange(n_claims, dtype=np.uint64),
        "cid": cid_base + np.arange(n_claims, dtype=np.uint64),
    }
    G.assign_ext(qcols, "gamma", gammas)
    G.assign_ext(qcols, "value", vals)
    G.assign_ext(qcols, "v", vcols)
    G.assign_ext(qcols, "w", ws)
    G.assign_ext(qcols, "s_in", s_ins)
    G.assign_ext(qcols, "b_in", b_ins)
    G.assign_ext(qcols, "gw", gw)
    G.assign_ext(qcols, "ctr", contribs)
    G.assign_ext(qcols, "bt", bterms)
    claims_wit = np.zeros((len(chips.claims_cb.wit_names), n_claims), np.uint64)
    for j, name in enumerate(chips.claims_cb.wit_names):
        claims_wit[j] = np.asarray(qcols[name], np.uint64) % P

    fcols: dict = {"jid": np.array([jid], np.uint64)}
    G.assign_ext(fcols, "total", s[None])
    G.assign_ext(fcols, "btotal", btotal[None])
    G.assign_ext(fcols, "fc", final_claim[None])
    final_wit = np.zeros((len(chips.final_cb.wit_names), 1), np.uint64)
    for j, name in enumerate(chips.final_cb.wit_names):
        final_wit[j] = np.asarray(fcols[name], np.uint64) % P

    return rows_wit, claims_wit, final_wit, sc_rows


# ---------------------------------------------------------------------------
# Class-main recombination chips (RECURSION.md build order #5, "class-main
# slot terms"): the in-circuit mirror of gkr/chip.py::verify_class_main's
# recombination — per chip: acc = sum_slots mult * sum_terms scalar * prod
# col_evals; class total = sum_chips gamma * sel_eq * acc == the class
# sumcheck's final claim. Reference role: the main-constraint verify tables
# of the recursion VM (scheme/verifier.rs main_constraint replay).
#
# The chips are GENERIC — no per-CompiledChip codegen. Every variable-length
# structure (term column counts, slot term counts, chip slot counts, class
# chip counts) is a bus-balanced chain, so the geometry is enforced by
# multiset balance, not by circuit shape:
#
#   * TERM-ROWS chip, row per (term, col step):
#       reads (TermChain, tid, step, p)  writes (TermChain, tid, step+1, p*c)
#   * TERM chip, row per slot term:
#       writes (TermChain, tid, 0, scalar)   reads (TermChain, tid, nc, val)
#       chains (SlotSum, sid, j) += val
#   * SLOT chip, row per slot:
#       pins (SlotSum, sid, 0, 0), reads the slot total at nt,
#       chains (ChipAcc, cidx, si) += mult * slot_val
#   * CHIP chip, row per class member:
#       pins (ChipAcc, cidx, 0, 0), reads acc at ns,
#       chains (ClassSum, h, i)   += gamma * sel_eq * acc
#       chains (ClassBatch, h, i) += gamma * batched_claim
#   * CLASS-FINAL chip, row per height class:
#       pins both class chains at 0, reads totals at nchips,
#       writes (SumcheckClaim, h, 0, batch_total) and reads the class
#       sumcheck's reduced claim at round nv, requiring it == sum_total —
#       composed with the standard sumcheck ROUNDS chip, the whole class
#       main argument is verified in-circuit.
#
# col_evals / scalars / gammas / mults / sel_eq are witness wires the outer
# statement binds (same incremental-binding status as build order #2's
# challenges; the FS chips supply them when the transcript chain is wired).
# ---------------------------------------------------------------------------

TAG_TERM_CHAIN = 10
TAG_SLOT_SUM = 11
TAG_CHIP_ACC = 12
TAG_CLASS_SUM = 13
TAG_CLASS_BATCH = 14
# claim-link tags consumed by the bind-mode chips here (gkr/claim_link.py
# owns the producing chips)
TAG_REC_CLAIM = 28
TAG_BC = 30
TAG_MULT = 35
TAG_SEQ = 36


@dataclass
class ClassMainVerifyChips:
    prod_cb: CircuitBuilder
    prod_compiled: object
    term_cb: CircuitBuilder
    term_compiled: object
    slot_cb: CircuitBuilder
    slot_compiled: object
    chip_cb: CircuitBuilder
    chip_compiled: object
    final_cb: CircuitBuilder
    final_compiled: object


def build_class_main_verify_chips(bind: bool = False) -> ClassMainVerifyChips:
    if bind:
        from . import fs_chain as FS
    # -- term product rows ----------------------------------------------------
    pb = CircuitBuilder("cm_term_rows" + ("_fs" if bind else ""))
    tid = pb.create_witin("tid")
    step = pb.create_witin("step")
    c = G.ext_witness(pb, "c")
    p = G.ext_witness(pb, "p")
    pc = G.ext_mul(pb, "pc", p, c)
    head = [E.Const(RAM_CUSTOM), E.Const(TAG_TERM_CHAIN), tid]
    pb.read_record(head + [step] + p.c)
    pb.write_record(head + [step + 1] + pc.c)
    if bind:
        # the column eval this step multiplies by is an absorbed proof
        # element: bound against the absorbed-ext table (fs_absx) rows
        p_ccid = pb.create_fixed("ccid")
        pb.lk_record(FS.LK_AGG_CHAL, [p_ccid] + list(c.c))
    prod_compiled = compile_chip(pb)

    # -- per-term chip ---------------------------------------------------------
    tb = CircuitBuilder("cm_terms" + ("_fs" if bind else ""))
    ttid = tb.create_witin("tid")
    sid = tb.create_witin("sid")
    j = tb.create_witin("j")
    nc = tb.create_witin("nc")
    scalar = G.ext_witness(tb, "scalar")
    val = G.ext_witness(tb, "val")
    s_in = G.ext_witness(tb, "s_in")
    thead = [E.Const(RAM_CUSTOM), E.Const(TAG_TERM_CHAIN), ttid]
    tb.write_record(thead + [E.Const(0)] + scalar.c)
    tb.read_record(thead + [nc] + val.c)
    shead = [E.Const(RAM_CUSTOM), E.Const(TAG_SLOT_SUM), sid]
    tb.read_record(shead + [j] + s_in.c)
    tb.write_record(shead + [j + 1] + s_in.add(val).c)
    if bind:
        # the term scalar is the published value of its scalar-eval DAG
        # node (gkr/claim_link.py::ScalarRegistry) under a key-fixed cid
        t_scid = tb.create_fixed("scid")
        tb.lk_record(FS.LK_AGG_CHAL, [t_scid] + scalar.c)
    term_compiled = compile_chip(tb)

    # -- per-slot chip ---------------------------------------------------------
    sb = CircuitBuilder("cm_slots" + ("_fs" if bind else ""))
    ssid = sb.create_witin("sid")
    cidx = sb.create_witin("cidx")
    si = sb.create_witin("si")
    nt = sb.create_witin("nt")
    mult = G.ext_witness(sb, "mult")
    slot_val = G.ext_witness(sb, "slot_val")
    a_in = G.ext_witness(sb, "a_in")
    mv = G.ext_mul(sb, "mv", mult, slot_val)
    zero = G.ExtWire.constant(np.zeros(4, np.uint64))
    sshead = [E.Const(RAM_CUSTOM), E.Const(TAG_SLOT_SUM), ssid]
    sb.write_record(sshead + [E.Const(0)] + zero.c)
    sb.read_record(sshead + [nt] + slot_val.c)
    ahead = [E.Const(RAM_CUSTOM), E.Const(TAG_CHIP_ACC), cidx]
    sb.read_record(ahead + [si] + a_in.c)
    sb.write_record(ahead + [si + 1] + a_in.add(mv).c)
    if bind:
        # the slot multiplier alpha_cat * eq(b*, rec) is derived in-circuit
        # by the claim-link mult rows; no longer a free wire
        sb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_MULT), ssid]
                       + mult.c)
    slot_compiled = compile_chip(sb)

    # -- per-chip chip ---------------------------------------------------------
    hb = CircuitBuilder("cm_chips" + ("_fs" if bind else ""))
    hcidx = hb.create_witin("cidx")
    hidx = hb.create_witin("h")
    i_in = hb.create_witin("i")
    ns = hb.create_witin("ns")
    gamma = G.ext_witness(hb, "gamma")
    s_eq = G.ext_witness(hb, "s_eq")
    acc = G.ext_witness(hb, "acc")
    bc = G.ext_witness(hb, "bc")
    t_in = G.ext_witness(hb, "t_in")
    b_in = G.ext_witness(hb, "b_in")
    ga = G.ext_mul(hb, "ga", gamma, s_eq)
    gacc = G.ext_mul(hb, "gacc", ga, acc)
    gb = G.ext_mul(hb, "gb", gamma, bc)
    hahead = [E.Const(RAM_CUSTOM), E.Const(TAG_CHIP_ACC), hcidx]
    hb.write_record(hahead + [E.Const(0)] + zero.c)
    hb.read_record(hahead + [ns] + acc.c)
    tshead = [E.Const(RAM_CUSTOM), E.Const(TAG_CLASS_SUM), hidx]
    hb.read_record(tshead + [i_in] + t_in.c)
    hb.write_record(tshead + [i_in + 1] + t_in.add(gacc).c)
    bshead = [E.Const(RAM_CUSTOM), E.Const(TAG_CLASS_BATCH), hidx]
    hb.read_record(bshead + [i_in] + b_in.c)
    hb.write_record(bshead + [i_in + 1] + b_in.add(gb).c)
    if bind:
        # gamma is a pow-chain power: bound on the challenge table
        h_gcid = hb.create_fixed("gcid")
        hb.lk_record(FS.LK_AGG_CHAL, [h_gcid] + list(gamma.c))
        # the batched claim and the masked-eq selector are derived
        # in-circuit by the claim-link chains (gkr/claim_link.py)
        hb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_BC), hcidx] + bc.c)
        hb.read_record([E.Const(RAM_CUSTOM), E.Const(TAG_SEQ), hcidx]
                       + s_eq.c)
    chip_compiled = compile_chip(hb)

    # -- class-final chip -------------------------------------------------------
    fb = CircuitBuilder("cm_final" + ("_fs" if bind else ""))
    fh = fb.create_witin("h")
    nchips = fb.create_witin("nchips")
    nv = fb.create_witin("nv")
    total = G.ext_witness(fb, "total")
    btotal = G.ext_witness(fb, "btotal")
    fc = G.ext_witness(fb, "fc")
    fshead = [E.Const(RAM_CUSTOM), E.Const(TAG_CLASS_SUM), fh]
    fb.write_record(fshead + [E.Const(0)] + zero.c)
    fb.read_record(fshead + [nchips] + total.c)
    fbhead = [E.Const(RAM_CUSTOM), E.Const(TAG_CLASS_BATCH), fh]
    fb.write_record(fbhead + [E.Const(0)] + zero.c)
    fb.read_record(fbhead + [nchips] + btotal.c)
    schead = [E.Const(RAM_CUSTOM), E.Const(TAG_SUMCHECK_CLAIM), fh]
    fb.write_record(schead + [E.Const(0)] + btotal.c)
    fb.read_record(schead + [nv] + fc.c)
    G.ext_require_equal(fb, "class_main", fc, total)
    final_compiled = compile_chip(fb)
    return ClassMainVerifyChips(pb, prod_compiled, tb, term_compiled,
                                sb, slot_compiled, hb, chip_compiled,
                                fb, final_compiled)


def assign_class_main_verify(chips: ClassMainVerifyChips, vctxs: list,
                             class_proof, instances: np.ndarray,
                             challenges: np.ndarray, transcript: Transcript,
                             class_id: int = 0,
                             tid0: int = 0, sid0: int = 0, cidx0: int = 0,
                             fixed_out: dict | None = None,
                             scalar_reg=None):
    """Witgen mirror of verify_class_main for ONE height class. ``transcript``
    must sit where the class-main verifier's would (samples gammas, replays
    the class sumcheck, absorbs the evals). Global chain ids start at
    tid0/sid0/cidx0 so multiple classes share the generic chips. Returns
    (prod_wit, term_wit, slot_wit, chip_wit, final_wit, sc_cols, deg) where
    sc_cols feeds build_sumcheck_verify_chips(deg, ...).rounds_cb and the
    sumcheck instance id is ``class_id``.

    FS binding (chips built with bind=True; ``transcript`` must be a
    ChainTranscript cursor): gammas ride a pow chain, the class sumcheck's
    messages/challenges are slot-bound (sc_cols gains "aidx"/"acid" fixed
    schedule arrays), the absorbed column evals become absorbed-ext table
    rows the prod rows look up, and ``fixed_out`` receives the fixed
    matrices under "prod"/"chips"."""
    from .chip import _col_index, sel_eq_eval
    from ..sumcheck.verifier import lagrange_extrapolate, verify as sc_verify

    P = np.uint64(bb.P)
    n_vars = vctxs[0].n_vars
    bind = "gcid" in chips.chip_cb.fixed_names
    if bind:
        assert hasattr(transcript, "registry"), \
            "FS-bound class-main chips need a ChainTranscript cursor"
        reg = transcript.registry
        gcid0, gammas = transcript.sample_ext_pows_chal(len(vctxs))
    else:
        gammas = transcript.sample_ext_pows(len(vctxs))
    combined = np.zeros(4, np.uint64)
    for g, v in zip(gammas, vctxs):
        combined = exth.add(combined, exth.mul(g, v.batched_claim))
    deg = max(v.main_deg for v in vctxs)
    msgs = np.asarray(class_proof.main_msgs, np.uint64)

    # sumcheck rounds rows (instance id = class_id)
    sc_cols: dict = {
        "inst": np.full(n_vars, class_id, np.uint64),
        "round": np.arange(n_vars, dtype=np.uint64),
    }
    cur = combined
    cins = np.zeros((n_vars, 4), np.uint64)
    chals = np.zeros((n_vars, 4), np.uint64)
    if bind:
        aidxs = np.zeros(n_vars, np.uint64)
        acids = np.zeros(n_vars, np.uint64)
        for rr in range(n_vars):
            cins[rr] = cur
            aidxs[rr] = transcript.append_slots(msgs[rr].ravel())
            acid, ch = transcript.sample_ext_chal()
            reg.use(acid)
            acids[rr] = acid
            chals[rr] = ch
            cur = lagrange_extrapolate(msgs[rr], ch)
        point = chals[::-1].copy()
        final_claim = cur
        sc_cols["aidx"] = aidxs
        sc_cols["acid"] = acids
    else:
        point, final_claim = sc_verify(combined, msgs, n_vars, transcript,
                                       deg=deg)
        chals = point[::-1].copy()
        for rr in range(n_vars):
            cins[rr] = cur
            cur = lagrange_extrapolate(msgs[rr], chals[rr])
        assert np.array_equal(cur, final_claim)
    cidmaps = []
    if bind:
        # absorbed column evals -> absorbed-ext table rows (one per ext)
        for i, v in enumerate(vctxs):
            cids_i = []
            for arr in (class_proof.wit_evals[i], class_proof.fixed_evals[i],
                        class_proof.structural_evals[i]):
                a = np.asarray(arr, np.uint64)
                for row in range(a.shape[0]):
                    cids_i.append(transcript.append_ext_chal(a[row]))
            cidmaps.append(cids_i)
    else:
        flat = []
        for i, v in enumerate(vctxs):
            flat += [np.asarray(class_proof.wit_evals[i], np.uint64),
                     np.asarray(class_proof.fixed_evals[i], np.uint64),
                     np.asarray(class_proof.structural_evals[i], np.uint64)]
        transcript.append(
            np.concatenate([x.reshape(-1) for x in flat])
            if flat else np.zeros(0, np.uint64)
        )
    for kk in range(deg + 1):
        G.assign_ext(sc_cols, f"y{kk}", msgs[:, kk])
    G.assign_ext(sc_cols, "alpha", chals)
    G.assign_ext(sc_cols, "claim_in", cins)
    G.assign_lagrange(sc_cols, "lag", msgs, chals, deg)

    prod_rows = {"tid": [], "step": [], "c": [], "p": [], "pc": []}
    term_rows = {"tid": [], "sid": [], "j": [], "nc": [], "scalar": [],
                 "val": [], "s_in": []}
    slot_rows = {"sid": [], "cidx": [], "si": [], "nt": [], "mult": [],
                 "slot_val": [], "a_in": [], "mv": []}
    chip_rows = {"cidx": [], "h": [], "i": [], "ns": [], "gamma": [],
                 "s_eq": [], "acc": [], "bc": [], "t_in": [], "b_in": [],
                 "ga": [], "gacc": [], "gb": []}
    tid = tid0
    sid = sid0
    cidx = cidx0
    total = np.zeros(4, np.uint64)
    btotal = np.zeros(4, np.uint64)
    prod_ccids: list = []
    chip_gcids: list = []
    term_scids: list = []
    chip_sid0: list = []
    for i, v in enumerate(vctxs):
        compiled = v.compiled
        we = np.asarray(class_proof.wit_evals[i], np.uint64)
        fe = np.asarray(class_proof.fixed_evals[i], np.uint64)
        se = np.asarray(class_proof.structural_evals[i], np.uint64)
        col_evals = (
            np.concatenate([we, fe, se], axis=0)
            if compiled.n_cols else np.zeros((0, 4), np.uint64)
        )
        acc = np.zeros(4, np.uint64)
        chip_sid0.append(sid)
        for si_, slot in enumerate(compiled.slots):
            slot_val = np.zeros(4, np.uint64)
            for jj, tm in enumerate(slot.terms):
                sc_val = E.eval_scalar(tm.scalar, challenges, instances)
                if bind and scalar_reg is not None:
                    scid = scalar_reg.cid_of(tm.scalar)
                    replay.check(np.array_equal(
                        scalar_reg.value_of(tm.scalar), sc_val))
                    reg.use(scid)
                    term_scids.append(scid)
                p_run = sc_val
                for st, cref in enumerate(tm.cols):
                    col_i = _col_index(cref, compiled.n_wit, compiled.n_fixed)
                    cv = col_evals[col_i]
                    if bind:
                        prod_ccids.append(cidmaps[i][col_i])
                        reg.use(cidmaps[i][col_i])
                    prod_rows["tid"].append(tid)
                    prod_rows["step"].append(st)
                    prod_rows["c"].append(cv)
                    prod_rows["p"].append(p_run)
                    p_run = exth.mul(p_run, cv)
                    prod_rows["pc"].append(p_run)
                term_rows["tid"].append(tid)
                term_rows["sid"].append(sid)
                term_rows["j"].append(jj)
                term_rows["nc"].append(len(tm.cols))
                term_rows["scalar"].append(sc_val)
                term_rows["val"].append(p_run)
                term_rows["s_in"].append(slot_val)
                slot_val = exth.add(slot_val, p_run)
                tid += 1
            slot_rows["sid"].append(sid)
            slot_rows["cidx"].append(cidx)
            slot_rows["si"].append(si_)
            slot_rows["nt"].append(len(slot.terms))
            slot_rows["mult"].append(np.asarray(v.mults[si_], np.uint64))
            slot_rows["slot_val"].append(slot_val)
            slot_rows["a_in"].append(acc)
            mv_ = exth.mul(np.asarray(v.mults[si_], np.uint64), slot_val)
            slot_rows["mv"].append(mv_)
            acc = exth.add(acc, mv_)
            sid += 1
        s_eq = sel_eq_eval(v.x_star, point, v.num_instances)
        ga_ = exth.mul(gammas[i], s_eq)
        gacc_ = exth.mul(ga_, acc)
        gb_ = exth.mul(gammas[i], np.asarray(v.batched_claim, np.uint64))
        if bind:
            chip_gcids.append(gcid0 + i)
            reg.use(gcid0 + i)
        chip_rows["cidx"].append(cidx)
        chip_rows["h"].append(class_id)
        chip_rows["i"].append(i)
        chip_rows["ns"].append(len(compiled.slots))
        chip_rows["gamma"].append(gammas[i])
        chip_rows["s_eq"].append(s_eq)
        chip_rows["acc"].append(acc)
        chip_rows["bc"].append(np.asarray(v.batched_claim, np.uint64))
        chip_rows["t_in"].append(total)
        chip_rows["b_in"].append(btotal)
        chip_rows["ga"].append(ga_)
        chip_rows["gacc"].append(gacc_)
        chip_rows["gb"].append(gb_)
        total = exth.add(total, gacc_)
        btotal = exth.add(btotal, gb_)
        cidx += 1
    if not np.array_equal(total, final_claim) and not replay.structure_only():
        raise ValueError("class-main recombination mismatch in witgen")

    def mat(cb, rows, base_keys, ext_keys):
        n = len(rows[base_keys[0]]) if rows[base_keys[0]] else 0
        cols: dict = {}
        for kk in base_keys:
            cols[kk] = np.asarray(rows[kk], np.uint64)
        for kk in ext_keys:
            v = (np.stack(rows[kk]) if n else np.zeros((0, 4), np.uint64))
            G.assign_ext(cols, kk, v)
        out = np.zeros((len(cb.wit_names), n), np.uint64)
        for jj, name in enumerate(cb.wit_names):
            out[jj] = np.asarray(cols[name], np.uint64) % P
        return out

    prod_wit = mat(chips.prod_cb, prod_rows, ["tid", "step"], ["c", "p", "pc"])
    term_wit = mat(chips.term_cb, term_rows, ["tid", "sid", "j", "nc"],
                   ["scalar", "val", "s_in"])
    slot_wit = mat(chips.slot_cb, slot_rows, ["sid", "cidx", "si", "nt"],
                   ["mult", "slot_val", "a_in", "mv"])
    chip_wit = mat(chips.chip_cb, chip_rows, ["cidx", "h", "i", "ns"],
                   ["gamma", "s_eq", "acc", "bc", "t_in", "b_in",
                    "ga", "gacc", "gb"])
    fcols: dict = {
        "h": np.array([class_id], np.uint64),
        "nchips": np.array([len(vctxs)], np.uint64),
        "nv": np.array([n_vars], np.uint64),
    }
    G.assign_ext(fcols, "total", total[None])
    G.assign_ext(fcols, "btotal", combined[None])
    G.assign_ext(fcols, "fc", final_claim[None])
    final_wit = np.zeros((len(chips.final_cb.wit_names), 1), np.uint64)
    for jj, name in enumerate(chips.final_cb.wit_names):
        final_wit[jj] = np.asarray(fcols[name], np.uint64) % P
    if bind and fixed_out is not None:
        fixed_out["prod"] = np.array([prod_ccids], np.uint64)
        fixed_out["chips"] = np.array([chip_gcids], np.uint64)
        if scalar_reg is not None:
            fixed_out["terms"] = np.array([term_scids], np.uint64)
        fixed_out["chip_sid0"] = chip_sid0
        # the class opening point + its challenge cids (jagged claims bind
        # their z coordinates against these)
        fixed_out["point"] = point
        fixed_out["point_cids"] = [int(acids[n_vars - 1 - k])
                                   for k in range(n_vars)]
    return prod_wit, term_wit, slot_wit, chip_wit, final_wit, sc_cols, deg
