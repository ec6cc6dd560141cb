"""zkVM proving scheme: keygen, shard prove, verify.

Role mirror of the reference's scheme layer (ZKVMProver::create_proof,
prover.rs:309 and ZKVMVerifier, verifier.rs:398 — SURVEY.md §3.2/§3.3), for
one shard:

  prove:  absorb vk digest + public values -> batch-commit witness trace
          matrices per height class -> sample the RLC challenges alpha, beta
          -> per chip: tower + main zerocheck (gkr/chip.py) -> Quark EC-sum
          proofs for the cross-shard trees -> Basefold batch-open witness and
          fixed commitments at the chips' points (plus the EC trees' three
          extended points).
  verify: replay transcript; per chip verify tower + main sumcheck; verify
          the EC-sum proofs against the public rw sums; check the global bus:
          prod(reads) == prod(writes) and sum of logup fractions == 0;
          verify PCS openings. Shard gating (is_first/is_last) controls which
          RAM init/final tables must be active; standalone verify() is the
          single-shard case (first == last, no cross-shard tokens allowed).

Cross-shard stitching (public-value chaining + EC sum accumulation across
shards, verifier.rs:398-475 mirror) lives in zkvm/shard.py.

Transcript order is the soundness contract and is fixed here (v5: class-
batched main zerocheck — per-chip towers in registry order, then per height
class ascending: gamma powers, ONE batched main sumcheck, per-chip column
evals; reference mirror cpu/mod.rs:1043-1392 adapted to height classes).

Counterpart of ``ceno_tpu/zkvm/scheme.py``, with the same transcript order
and proof objects. ``keygen`` and ``prove`` run their device work (the fixed
and witness commits, records, towers, class mains, openings) on ``device``,
the card unless the caller names another; the witness, the transcript and
the verifier stay on the host in numpy, as in the reference. The port's
keygen commits the fixed stack directly (no ``commit_cached``). The EC-sum
quark proofs run their zerochecks on ``device`` too. The verifier has no
aggregation hooks (``capture``, a recording transcript) and no replay mode:
it always checks."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..gkr import chip as chiplib
from ..gkr import eccquark
from ..gkr.chip import structural_table
from ..pcs import basefold, jagged
from ..utils import spans
from ..pcs.basefold import BasefoldParams, Claim
from .chips import build_all_chips
from .chips.dyn_ram import build_dyn_ram_chips
from .chips.shard_ram import build_shard_chips
from .tables import build_tables, ZKVMConfig
from .witgen import generate_witness, AssignedChip
from .layout import (
    N_PUBLIC_VALUES, PV_SHARD_ID, PV_RW_SUM_IN, PV_RW_SUM_OUT,
    PV_HEAP_WORDS, PV_STACK_WORDS, PV_INFO_WORDS,
)

LABEL = b"ceno-tpu/zkvm/v8"  # v7: PCS PoW grinding; v8: grouped towers


def _pow2_height(k: int) -> int:
    return max(2, 1 << max(0, (k - 1).bit_length()))


@dataclass
class ChipMeta:
    name: str
    compiled: object
    cb: object
    is_table: bool
    table_rows: int | None  # static height for tables, None for opcode chips
    kind: str = "opcode"    # 'opcode' | 'table' | shard-chip kinds
    gate: str = "always"    # table shard gating


def chip_height(meta: ChipMeta, k: int) -> int:
    """Padded height of a chip's witness given its instance count."""
    if meta.is_table:
        return _pow2_height(meta.table_rows)
    if meta.kind.startswith("ec_tree"):
        return 4 if k == 0 else 2 * _pow2_height(k)
    return _pow2_height(k)


@dataclass
class ProvingKey:
    metas: list
    tables: list
    opcode_chips: list
    shard_chips: list
    dyn_chips: list
    cfg: ZKVMConfig
    params: BasefoldParams
    fixed_committed: dict     # height -> basefold.Committed
    fixed_layout: dict        # height -> [(chip_idx, col_offset, n_fixed)]
    program_words: dict
    data_image: dict | None = None  # word_addr -> u32 static program data

    @property
    def vk(self) -> "VerifyingKey":
        return VerifyingKey(
            self.metas,
            self.cfg,
            self.params,
            {h: c.root for h, c in self.fixed_committed.items()},
            self.fixed_layout,
        )


@dataclass
class VerifyingKey:
    metas: list
    cfg: ZKVMConfig
    params: BasefoldParams
    fixed_roots: dict
    fixed_layout: dict

    def digest_elems(self) -> np.ndarray:
        parts = [np.uint64(len(self.metas))]
        for h in sorted(self.fixed_roots):
            parts.extend([np.uint64(h)])
            parts.extend(self.fixed_roots[h].ravel())
        return np.array(parts, np.uint64)


@dataclass
class ZKVMProof:
    public_values: np.ndarray
    num_instances: list
    witness_roots: dict        # height -> (8,) canonical
    tower_groups: dict         # tower size N_t -> tower.TowerProof (grouped)
    class_main: dict           # height -> chiplib.ClassMainProof
    ec_proofs: dict            # chip name -> eccquark.EccQuarkProof
    witness_openings: dict     # height -> basefold.OpeningProof
    fixed_openings: dict       # height -> basefold.OpeningProof


def fixed_matrices(tables: list, n_pre: int, params: BasefoldParams):
    """The fixed columns that keygen commits, grouped by padded table height.

    Returns (layout: h -> [(chip_idx, col_off, n_fixed)], {key: canonical
    (C, N) matrix}): under the jagged PCS one stacked matrix keyed by its
    row count, else one matrix per height. ``n_pre`` is the registry index
    of the first table."""
    by_height: dict = {}
    layout: dict = {}
    for ti, t in enumerate(tables):
        if not t.cb.fixed_names:
            continue
        h = _pow2_height(t.n_rows)
        fx = np.asarray(t.fixed_fn(), np.uint64)
        fx = np.pad(fx, ((0, 0), (0, h - fx.shape[1])))
        chip_idx = n_pre + ti
        layout.setdefault(h, []).append((chip_idx, sum(
            m.shape[0] for m in by_height.get(h, [])
        ), fx.shape[0]))
        by_height.setdefault(h, []).append(fx)
    if not params.jagged:
        return layout, {h: np.concatenate(mats, axis=0) for h, mats in by_height.items()}
    # ONE stacked fixed commitment (Jagged<Basefold> role)
    jl = jagged.plan_layout([(h, sum(m.shape[0] for m in by_height[h]))
                             for h in sorted(by_height)])
    mat = jagged.stack_matrix(
        jl, [(h, np.concatenate(by_height[h], axis=0)) for h in sorted(by_height)]
    )
    return layout, {jl.n_r: mat}


def registry(program_words: dict, cfg: ZKVMConfig, data_image: dict | None = None):
    """Every chip of the key, in registry order: (opcode chips, shard chips,
    dyn_ram chips, tables, metas), the metas in that same order."""
    opcode_chips = build_all_chips()
    shard_chips = build_shard_chips()
    dyn_chips = build_dyn_ram_chips(cfg)
    tables = build_tables(program_words, cfg, data_image)
    metas = [ChipMeta(c.name, c.compiled, c.cb, False, None) for c in opcode_chips]
    metas += [
        ChipMeta(c.name, c.compiled, c.cb, False, None, kind=c.kind)
        for c in shard_chips
    ]
    metas += [
        ChipMeta(c.name, c.compiled, c.cb, False, None, kind=c.kind, gate=c.gate)
        for c in dyn_chips
    ]
    metas += [
        ChipMeta(t.name, t.compiled, t.cb, True, t.n_rows, kind="table", gate=t.gate)
        for t in tables
    ]
    return opcode_chips, shard_chips, dyn_chips, tables, metas


def keygen(program_words: dict, cfg: ZKVMConfig | None = None,
           params: BasefoldParams | None = None,
           data_image: dict | None = None, device=None) -> ProvingKey:
    """Build every chip and table of the registry and commit the fixed
    columns on ``device`` (the card by default)."""
    cfg = cfg or ZKVMConfig()
    params = params or BasefoldParams()
    opcode_chips, shard_chips, dyn_chips, tables, metas = registry(
        program_words, cfg, data_image)
    n_pre = len(opcode_chips) + len(shard_chips) + len(dyn_chips)
    layout, mats = fixed_matrices(tables, n_pre, params)
    # the fixed commit is keygen's only device work
    device = device or DEFAULT_DEVICE
    committed = {k: basefold.commit(m, params, device=device) for k, m in mats.items()}
    return ProvingKey(
        metas, tables, opcode_chips, shard_chips, dyn_chips, cfg, params,
        committed, layout, program_words, data_image,
    )


# ---------------------------------------------------------------------------
# Prove
# ---------------------------------------------------------------------------

# quark-claim geometry: (col_evals offset, chip column base) per extended point
_EC_POINTS = (
    ("even", ((7, 0), (14, 7))),          # [0]++rt: x <- evals[7..14), y <- [14..21)
    ("odd", ((21, 0), (28, 7))),          # [1]++rt
    ("hi", ((35, 0), (42, 7), (0, 14))),  # rt++[1]: x, y, s
)


def _jagged_plan(layout_by_h: dict):
    """Jagged stacking plan + slice index base per chip from a height-class
    layout dict (h -> [(ci, col_off, n_cols)], ascending h processed)."""
    class_cols = [
        (h, sum(e[2] for e in layout_by_h[h])) for h in sorted(layout_by_h)
    ]
    jl = jagged.plan_layout(class_cols)
    slice_base = {}
    s = 0
    for h in sorted(layout_by_h):
        for ci, off, ncols in layout_by_h[h]:
            slice_base[ci] = s + off
        s += sum(e[2] for e in layout_by_h[h])
    return jl, slice_base


def _jagged_claims(layout_by_h: dict, slice_base: dict, openings,
                   extra_rows: dict, *, fixed: bool = False):
    """Canonical claim order for a jagged opening: per class ascending, per
    entry, per column the main class-point claim; then EC extra points."""
    claims = []
    for h in sorted(layout_by_h):
        for ci, off, ncols in layout_by_h[h]:
            evals = openings[ci].fixed_evals if fixed else openings[ci].wit_evals
            for j in range(ncols):
                claims.append(jagged.JaggedClaim(
                    slice_base[ci] + j, openings[ci].point, evals[j]
                ))
    if not fixed:
        for h in sorted(layout_by_h):
            for ci, off, ncols in layout_by_h[h]:
                for point, cols in extra_rows.get(ci, []):
                    for col_j, val in cols:
                        claims.append(jagged.JaggedClaim(
                            slice_base[ci] + col_j, point, val
                        ))
    return claims


def _ec_extended_points(rt: np.ndarray):
    zero = np.zeros((1, 4), np.uint64)
    one = exth.one()[None]
    return {
        "even": np.concatenate([zero, rt], axis=0),
        "odd": np.concatenate([one, rt], axis=0),
        "hi": np.concatenate([rt, one], axis=0),
    }


def _ec_rows(rt: np.ndarray, col_evals: np.ndarray) -> list:
    """An EC tree's extra opening rows: for each extended point of
    ``_EC_POINTS``, the (chip column, eval) pairs bound there."""
    pts = _ec_extended_points(np.asarray(rt, np.uint64))
    rows = []
    for pname, claims in _EC_POINTS:
        cols = []
        for ev_off, col_base in claims:
            for c in range(7):
                cols.append((col_base + c, col_evals[ev_off + c]))
        rows.append((pts[pname], cols))
    return rows


def prove(pk: ProvingKey, vm, records, public_values: np.ndarray,
          shard_ctx=None, opcode_assigned=None, assigned=None, device=None) -> ZKVMProof:
    """Prove one shard on ``device`` (the card by default). ``assigned``
    short-circuits witgen with a pre-generated witness (the P4 host/device
    pipeline overlaps the next shard's witgen with this shard's device
    proving, e2e.rs:2266-2406 mirror — see shard.prove_shards)."""
    if len(public_values) != N_PUBLIC_VALUES:
        raise ZKVMError("bad public value count")
    device = device or DEFAULT_DEVICE

    t = Transcript(LABEL)
    t.append(pk.vk.digest_elems())
    t.append(np.asarray(public_values, np.uint64))

    if assigned is None:
        with spans.span("witgen"):
            assigned = generate_witness(
                records, pk.opcode_chips, pk.tables, vm, public_values,
                pk.cfg, shard_ctx=shard_ctx, shard_chips=pk.shard_chips,
                dyn_chips=pk.dyn_chips,
                opcode_assigned=opcode_assigned, data_image=pk.data_image,
            )

    # MOCK_PROVING mirror (e2e.rs:2069, mock_prover.rs:956): with
    # CENO_TPU_TORCH_MOCK_PROVING set, row-check every constraint and the
    # global record/lookup multisets on this shard BEFORE proving — turns a
    # cryptic failed proof into a named per-row constraint error.
    if os.environ.get("CENO_TPU_TORCH_MOCK_PROVING"):
        from ..gkr.mock import MockProver

        MockProver.assert_satisfied([
            (a.compiled, a.cb, a.wit,
             _fixed_matrix(pk, a, a.n_rows), public_values, a.num_instances)
            for a in assigned if a.num_instances > 0
        ])

    # group witness columns by height, commit per class. Chips with zero
    # instances are skipped ENTIRELY (no commit, no tower, no main slot) —
    # the reference does the same (prover.rs chips iterate assigned
    # circuits only); omitting a chip whose steps executed breaks the
    # GlobalState/RAM chain products, so skipping is sound.
    active = [a.num_instances > 0 for a in assigned]
    by_height: dict = {}
    wit_layout: dict = {}
    for ci, a in enumerate(assigned):
        if not active[ci]:
            continue
        h = a.n_rows
        off = sum(m.shape[0] for m in by_height.get(h, []))
        wit_layout.setdefault(h, []).append((ci, off, a.wit.shape[0]))
        by_height.setdefault(h, []).append(a.wit)
    wit_committed = {}
    if pk.params.jagged:
        jl_w, wslice = _jagged_plan(wit_layout)
        mat = jagged.stack_matrix(
            jl_w, [(h, np.concatenate(by_height[h], axis=0))
                   for h in sorted(by_height)]
        )
        with spans.span(f"commit/jagged-2^{jl_w.n_r.bit_length() - 1}"):
            wit_committed[jl_w.n_r] = basefold.commit(mat, pk.params, device=device)
        t.append(wit_committed[jl_w.n_r].root)
    else:
        for h in sorted(by_height):
            with spans.span(f"commit/2^{h.bit_length() - 1}"):
                wit_committed[h] = basefold.commit(
                    np.concatenate(by_height[h], axis=0), pk.params, device=device
                )
            t.append(wit_committed[h].root)
    for a in assigned:
        t.append([a.num_instances % bb.P])

    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)

    # stage 1a: per-chip record inference (registry order, no transcript)
    inputs = [None] * len(assigned)
    for ci, a in enumerate(assigned):
        if not active[ci]:
            continue
        n = a.n_rows
        structural = (
            np.stack([structural_table(s, n, public_values)
                      for s in a.compiled.structural])
            if a.compiled.structural
            else np.zeros((0, n), np.uint64)
        )
        fixed = _fixed_matrix(pk, a, n)
        with spans.span(f"records/{a.name}"):
            inputs[ci] = chiplib.build_tower_inputs(
                a.compiled, a.wit, fixed, structural, public_values,
                a.num_instances, challenges, device=device,
            )

    # stage 1b: ONE tower prove per tower-size group (ascending N_t; chips
    # in registry order within a group — the verifier reconstructs the same
    # grouping from public chip geometry)
    group_members: dict = {}
    for ci, ti in enumerate(inputs):
        if ti is not None:
            group_members.setdefault(ti.n_tower, []).append(ci)
    ctxs = [None] * len(assigned)
    tower_groups = {}
    for n_t in sorted(group_members):
        members = group_members[n_t]
        gproof, gctxs = chiplib.prove_group_towers(
            [inputs[ci] for ci in members], t
        )
        tower_groups[n_t] = gproof
        for ci, ctx in zip(members, gctxs):
            ctxs[ci] = ctx

    # stage 2: ONE batched main zerocheck per height class (ascending)
    class_main = {}
    openings = [None] * len(assigned)
    for h in sorted(wit_layout):
        members = [ci for ci, _, _ in wit_layout[h]]
        with spans.span(f"class-main/2^{h.bit_length() - 1}"):
            cmp_proof, opens = chiplib.prove_class_main(
                [ctxs[ci] for ci in members], public_values, challenges, t
            )
        class_main[h] = cmp_proof
        for ci, op in zip(members, opens):
            openings[ci] = op

    # Quark EC-sum proofs for the cross-shard trees (registry order)
    ec_proofs = {}
    extra_rows: dict = {}  # ci -> [(point, [(col, val)])]
    pv = np.asarray(public_values, np.uint64)
    for ci, a in enumerate(assigned):
        if not a.kind.startswith("ec_tree") or a.num_instances == 0:
            continue
        base = PV_RW_SUM_IN if a.kind.endswith("_in") else PV_RW_SUM_OUT
        fsum = pv[base : base + 14].reshape(2, 7)
        if not np.array_equal(np.asarray(a.ec_final_sum, np.uint64), fsum):
            raise ZKVMError(f"{a.name}: tree sum does not match public values")
        x, y, s = a.wit[0:7], a.wit[7:14], a.wit[14:21]
        with spans.span(f"ec-sum/{a.name}"):
            proof, rt = eccquark.prove_ec_sum(x, y, s, a.num_instances, fsum, t,
                                              device=device)
        ec_proofs[a.name] = proof
        extra_rows[ci] = _ec_rows(rt, proof.col_evals)

    # PCS openings: witness then fixed
    witness_openings = {}
    fixed_openings = {}
    if pk.params.jagged:
        claims = _jagged_claims(wit_layout, wslice, openings, extra_rows)
        with spans.span("open/jagged-wit"):
            witness_openings[jl_w.n_r] = jagged.open_jagged(
                wit_committed[jl_w.n_r], jl_w, claims, t, pk.params
            )
        active_fixed = {
            h: [e for e in pk.fixed_layout[h] if active[e[0]]]
            for h in pk.fixed_layout
        }
        jl_f, fslice = _jagged_plan(pk.fixed_layout)
        fclaims = _jagged_claims(
            {h: es for h, es in active_fixed.items() if es},
            fslice, openings, {}, fixed=True,
        )
        with spans.span("open/jagged-fixed"):
            fixed_openings[jl_f.n_r] = jagged.open_jagged(
                pk.fixed_committed[jl_f.n_r], jl_f, fclaims, t, pk.params
            )
    else:
        for h in sorted(wit_committed):
            points, claims = _class_claims(wit_layout[h], openings, extra_rows)
            with spans.span(f"open/2^{h.bit_length() - 1}"):
                witness_openings[h] = basefold.open_batch(
                    wit_committed[h], points, claims, t, pk.params
                )
        for h in sorted(pk.fixed_committed):
            entries = [e for e in pk.fixed_layout[h] if active[e[0]]]
            if not entries:
                continue  # every table in this class is shard-gated off
            points = np.stack([openings[entries[0][0]].point])
            claims = []
            for ci, off, ncols in entries:
                for j in range(ncols):
                    claims.append(Claim(0, off + j, openings[ci].fixed_evals[j]))
            fixed_openings[h] = basefold.open_batch(
                pk.fixed_committed[h], points, claims, t, pk.params
            )

    return ZKVMProof(
        pv,
        [a.num_instances for a in assigned],
        {h: c.root for h, c in wit_committed.items()},
        tower_groups,
        class_main,
        ec_proofs,
        witness_openings,
        fixed_openings,
    )


def _class_claims(entries, openings, extra_rows):
    """Opening points for one height class: the SHARED class main point
    (every chip opens at the batched zerocheck's point — one point per
    class), then any extra EC rows (chip order, even/odd/hi)."""
    points = [openings[entries[0][0]].point]
    claims = []
    for ci, off, ncols in entries:
        for j in range(ncols):
            claims.append(Claim(0, off + j, openings[ci].wit_evals[j]))
    k_next = 1
    for ci, off, ncols in entries:
        for point, cols in extra_rows.get(ci, []):
            points.append(point)
            for col_j, val in cols:
                claims.append(Claim(k_next, off + col_j, val))
            k_next += 1
    return np.stack(points), claims


def _fixed_matrix(pk: ProvingKey, a: AssignedChip, n: int) -> np.ndarray:
    if not a.cb.fixed_names:
        return np.zeros((0, n), np.uint64)
    for t in pk.tables:
        if t.name == a.name:
            fx = np.asarray(t.fixed_fn(), np.uint64)
            return np.pad(fx, ((0, 0), (0, n - fx.shape[1])))
    raise KeyError(a.name)


# ---------------------------------------------------------------------------
# Verify
# ---------------------------------------------------------------------------

class ZKVMError(Exception):
    pass


def derive_shard_layout(vk: VerifyingKey, num_instances, pv,
                        is_first: bool = True, is_last: bool = True,
                        standalone: bool = True):
    """Public geometry -> (wit_layout, heights, chip_active): the class
    grouping the verifier derives from num_instances + chip kinds. Raises
    on gating violations: a table is full exactly in the shards its gate
    names, a dynamic-RAM chip has its public length exactly there, and a
    standalone proof carries no shard-RAM or EC-tree tokens."""
    wit_layout: dict = {}
    heights = []
    chip_active = []
    for ci, meta in enumerate(vk.metas):
        k = num_instances[ci]
        if meta.is_table:
            active = (
                (meta.gate == "always")
                or (meta.gate == "first" and is_first)
                or (meta.gate == "last" and is_last)
            )
            if active and k != meta.table_rows:
                raise ZKVMError(f"{meta.name}: table must be active in this shard")
            if not active and k != 0:
                raise ZKVMError(f"{meta.name}: table must be inactive in this shard")
        elif meta.kind.startswith("dyn_ram"):
            active = (meta.gate == "first" and is_first) or (
                meta.gate == "last" and is_last
            )
            slot = (
                PV_HEAP_WORDS if "heap" in meta.name
                else PV_INFO_WORDS if "info" in meta.name
                else PV_STACK_WORDS
            )
            expect = int(pv[slot]) if active else 0
            if k != expect:
                raise ZKVMError(
                    f"{meta.name}: instance count {k} != public RAM length {expect}"
                )
        if standalone and meta.kind.startswith(("shard_ram", "ec_tree")) and k != 0:
            raise ZKVMError(f"{meta.name}: standalone proof cannot carry tokens")
        chip_active.append(k > 0)
        h = chip_height(meta, k)
        heights.append(h)
        if k == 0:
            continue
        n_wit = len(meta.cb.wit_names)
        off = sum(e[2] for e in wit_layout.get(h, []))
        wit_layout.setdefault(h, []).append((ci, off, n_wit))
    return wit_layout, heights, chip_active


def verify(vk: VerifyingKey, proof: ZKVMProof, *, is_first: bool = True,
           is_last: bool = True, standalone: bool = True,
           expect_halt: bool = True) -> bool:
    """Verify one shard proof. ``standalone`` (the single-shard public API)
    additionally requires shard_id == 0 and an empty cross-shard bus.

    ``expect_halt`` (reference: verifier.rs ``has_halt``): on the LAST
    shard, require exactly one halt-chip instance — the halt chip is what
    binds PV_END_PC/PV_END_CYCLE/exit code to a real ECALL-HALT, so without
    this check a prover could present a trace that simply ran out without
    halting while claiming arbitrary end-state public values. The verifier
    is host numpy, so it takes no device."""
    pv = np.asarray(proof.public_values, np.uint64)
    if len(pv) != N_PUBLIC_VALUES:
        raise ZKVMError("bad public value count")
    if standalone:
        if int(pv[PV_SHARD_ID]) != 0:
            raise ZKVMError("standalone proof must be shard 0")
        if pv[PV_RW_SUM_IN:PV_RW_SUM_IN + 28].any():
            raise ZKVMError("standalone proof must have empty rw sums")
    t = Transcript(LABEL)
    t.append(vk.digest_elems())
    t.append(pv)

    if len(proof.num_instances) != len(vk.metas):
        raise ZKVMError("chip count mismatch")
    if is_last and expect_halt:
        n_halt = sum(
            int(proof.num_instances[ci])
            for ci, meta in enumerate(vk.metas) if meta.name == "halt"
        )
        if n_halt != 1:
            raise ZKVMError(f"final shard must halt exactly once (got {n_halt})")

    # reconstruct class grouping from num_instances + chip kinds; chips
    # with zero instances are skipped entirely (mirrors the prover)
    wit_layout, heights, chip_active = derive_shard_layout(
        vk, proof.num_instances, pv, is_first, is_last, standalone
    )
    if vk.params.jagged:
        jl_w, wslice = _jagged_plan(wit_layout)
        if set(proof.witness_roots) != {jl_w.n_r}:
            raise ZKVMError("jagged proof must carry exactly one witness root")
        t.append(proof.witness_roots[jl_w.n_r])
    else:
        for h in sorted(wit_layout):
            if h not in proof.witness_roots:
                raise ZKVMError(f"missing witness root for height {h}")
            t.append(proof.witness_roots[h])
    for ci in range(len(vk.metas)):
        t.append([proof.num_instances[ci] % bb.P])

    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)

    # grouped tower verification: reconstruct the prover's grouping from
    # public chip geometry (N_t = height << rho), ascending N_t, chips in
    # registry order within a group
    group_members: dict = {}
    for ci, meta in enumerate(vk.metas):
        if not chip_active[ci]:
            continue
        rho, _, _, _ = chiplib.interleave_geometry(meta.compiled)
        group_members.setdefault(heights[ci] << rho, []).append(ci)
    if set(proof.tower_groups) != set(group_members):
        raise ZKVMError("tower group size set mismatch")

    prod_r = exth.one()
    prod_w = exth.one()
    logup_num = np.zeros(4, np.uint64)
    logup_den = exth.one()
    vctxs = [None] * len(vk.metas)
    for n_t in sorted(group_members):
        members = group_members[n_t]
        entries = [
            (vk.metas[ci].compiled, proof.num_instances[ci],
             heights[ci].bit_length() - 1)
            for ci in members
        ]
        results = chiplib.verify_group_towers(
            entries, proof.tower_groups[n_t], pv, challenges, t
        )
        for ci, (vctx, prod_values, logup_fracs) in zip(members, results):
            meta = vk.metas[ci]
            vctxs[ci] = vctx
            pi = 0
            if meta.compiled.r_exprs:
                prod_r = exth.mul(prod_r, prod_values[pi])
                pi += 1
            if meta.compiled.w_exprs:
                prod_w = exth.mul(prod_w, prod_values[pi])
                pi += 1
            for s in range(logup_fracs.shape[0]):
                p, q = logup_fracs[s]
                logup_num = exth.add(
                    exth.mul(logup_num, q), exth.mul(p, logup_den)
                )
                logup_den = exth.mul(logup_den, q)

    # class-batched main zerochecks (ascending height; mirrors the prover)
    if set(proof.class_main) != set(wit_layout):
        raise ZKVMError("class main proof height set mismatch")
    openings = [None] * len(vk.metas)
    for h in sorted(wit_layout):
        members = [ci for ci, _, _ in wit_layout[h]]
        opens = chiplib.verify_class_main(
            [vctxs[ci] for ci in members], proof.class_main[h], pv, challenges, t
        )
        for ci, op in zip(members, opens):
            openings[ci] = op

    # EC-sum quark proofs (registry order, matching the prover)
    extra_rows: dict = {}
    for ci, meta in enumerate(vk.metas):
        if not meta.kind.startswith("ec_tree"):
            continue
        k = proof.num_instances[ci]
        base = PV_RW_SUM_IN if meta.kind.endswith("_in") else PV_RW_SUM_OUT
        fsum = pv[base : base + 14].reshape(2, 7)
        if k == 0:
            if fsum.any():
                raise ZKVMError(f"{meta.name}: empty tree but nonzero rw sum")
            if meta.name in proof.ec_proofs:
                raise ZKVMError(f"{meta.name}: unexpected ec proof")
            continue
        ecp = proof.ec_proofs.get(meta.name)
        if ecp is None:
            raise ZKVMError(f"{meta.name}: missing ec proof")
        if ecp.num_instances != k or ecp.n_vars != heights[ci].bit_length() - 2:
            raise ZKVMError(f"{meta.name}: ec proof geometry mismatch")
        rt, evals = eccquark.verify_ec_sum(ecp, fsum, t)
        extra_rows[ci] = _ec_rows(rt, evals)

    if not np.array_equal(prod_r, prod_w):
        raise ZKVMError("global read/write product mismatch")
    if logup_num.any():
        raise ZKVMError("global logup sum is nonzero")
    if not logup_den.any():
        raise ZKVMError("logup denominator vanished")

    if vk.params.jagged:
        if set(proof.witness_openings) != {jl_w.n_r}:
            raise ZKVMError("jagged proof must carry exactly one witness opening")
        claims = _jagged_claims(wit_layout, wslice, openings, extra_rows)
        jagged.verify_jagged(
            proof.witness_roots[jl_w.n_r], jl_w, claims,
            proof.witness_openings[jl_w.n_r], t, vk.params,
        )
        jl_f, fslice = _jagged_plan(vk.fixed_layout)
        if set(proof.fixed_openings) != {jl_f.n_r} or set(vk.fixed_roots) != {jl_f.n_r}:
            raise ZKVMError("jagged proof must carry exactly one fixed opening")
        active_fixed = {
            h: [e for e in vk.fixed_layout[h] if chip_active[e[0]]]
            for h in vk.fixed_layout
        }
        fclaims = _jagged_claims(
            {h: es for h, es in active_fixed.items() if es},
            fslice, openings, {}, fixed=True,
        )
        jagged.verify_jagged(
            vk.fixed_roots[jl_f.n_r], jl_f, fclaims,
            proof.fixed_openings[jl_f.n_r], t, vk.params,
        )
        return True
    for h in sorted(wit_layout):
        entries = wit_layout[h]
        points, claims = _class_claims(entries, openings, extra_rows)
        n_cols = sum(e[2] for e in entries)
        basefold.verify_batch(
            proof.witness_roots[h], h.bit_length() - 1, n_cols, points,
            claims, proof.witness_openings[h], t, vk.params,
        )
    expect_fixed = {
        h for h in vk.fixed_roots
        if any(chip_active[e[0]] for e in vk.fixed_layout[h])
    }
    if set(proof.fixed_openings) != expect_fixed:
        raise ZKVMError("fixed opening height set mismatch")
    for h in sorted(expect_fixed):
        entries = [e for e in vk.fixed_layout[h] if chip_active[e[0]]]
        points = np.stack([openings[entries[0][0]].point])
        claims = []
        # width of the committed class = ALL tables' columns (inactive
        # tables stay committed; they just carry no claims this shard)
        n_cols = sum(e[2] for e in vk.fixed_layout[h])
        for ci, off, ncols in entries:
            for j in range(ncols):
                claims.append(Claim(0, off + j, openings[ci].fixed_evals[j]))
        basefold.verify_batch(
            vk.fixed_roots[h], h.bit_length() - 1, n_cols, points,
            claims, proof.fixed_openings[h], t, vk.params,
        )
    return True
