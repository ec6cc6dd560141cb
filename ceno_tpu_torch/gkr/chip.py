"""Per-chip compilation, record inference, proving and verification.

Counterpart of ``ceno_tpu/gkr/chip.py``. A compiled chip = circuit
expressions expanded ONCE into monomial terms; per shard the prover
  1. evaluates record expressions over the committed witness on the device
     (:func:`build_records`, plain torch on the witness tensors' device),
  2. proves their grand products / logup sums with the tower
     (:func:`prove_group_towers`, one tower per tower-size group),
  3. proves the main zerocheck at the tower's final point: all record claims
     (shape sel_eq*(rec-1) = claim-1) plus named zero constraints, batched
     with alpha powers (:func:`prove_class_main`, one per height class),
and hands the witness-column evaluations at the sumcheck's point to the PCS
opening stage. The verifier replays everything on the host in numpy,
evaluating selector and structural columns analytically.

The reference's size crossover (``HOST_CHIP_N`` and its host record builder
``_build_records_host``) has no counterpart: records of every size are built
on the witness's device. Its verifiers' replay waivers
(``utils/replay.structure_only``) are not ported: these verifiers always
check.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..hash.transcript import Transcript
from ..mle import expression as E
from ..mle import ops
from ..sumcheck import host_impl as H
from ..sumcheck import prover as sc_prover
from ..sumcheck import verifier as sc_verifier
from ..sumcheck.prover import TermSpec
from ..utils import spans
from . import tower
from .circuit_builder import CircuitBuilder, StructuralSpec


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

@dataclass
class Slot:
    kind: str  # 'prod_r' | 'prod_w' | 'lkq' | 'lkp_table' | 'zero'
    name: str
    terms: list  # list[E.Term]
    rec: int = -1  # record index within the interleaved category


@dataclass
class CompiledChip:
    name: str
    n_wit: int
    n_fixed: int
    structural: list  # list[StructuralSpec]
    r_exprs: list
    w_exprs: list
    lk_exprs: list
    lk_table: list
    slots: list  # main-sumcheck slots in canonical order

    @property
    def n_cols(self):
        return self.n_wit + self.n_fixed + len(self.structural)


def _col_index(ref, n_wit, n_fixed):
    kind, idx = ref
    if kind == E.WIT:
        return idx
    if kind == E.FIXED:
        return n_wit + idx
    return n_wit + n_fixed + idx


def compile_chip(cb: CircuitBuilder) -> CompiledChip:
    slots = []
    n_lk = len(cb.lk_records)
    for i, rec in enumerate(cb.r_records):
        slots.append(Slot("prod_r", f"r{i}", E.to_terms(rec - 1), i))
    for i, rec in enumerate(cb.w_records):
        slots.append(Slot("prod_w", f"w{i}", E.to_terms(rec - 1), i))
    for i, rec in enumerate(cb.lk_records):
        slots.append(Slot("lkq", f"lk{i}", E.to_terms(rec - 1), i))
    for i, (mult, rec) in enumerate(cb.lk_table):
        slots.append(Slot("lkp_table", f"lkt_p{i}", E.to_terms(E.Neg(mult)), n_lk + i))
        slots.append(Slot("lkq", f"lkt_q{i}", E.to_terms(rec - 1), n_lk + i))
    for name, expr in cb.zeros:
        slots.append(Slot("zero", name, E.to_terms(expr)))
    return CompiledChip(
        cb.name,
        len(cb.wit_names),
        len(cb.fixed_names),
        list(cb.structural),
        list(cb.r_records),
        list(cb.w_records),
        list(cb.lk_records),
        list(cb.lk_table),
        slots,
    )


# ---------------------------------------------------------------------------
# Structural column materialization + analytic evaluation
# ---------------------------------------------------------------------------

def structural_table(spec: StructuralSpec, n: int,
                     instances=None) -> np.ndarray:
    """Canonical values of a structural column of length n (host).
    See StructuralSpec for the variant semantics (StructuralWitInType
    mirror); ``instances`` supplies the public values for the dynamic
    variant."""
    p = np.uint64(bb.P)
    i = np.arange(n, dtype=np.uint64)
    if spec.kind in ("incremental", "incremental_dynamic"):
        start = (
            int(np.asarray(instances, np.uint64)[spec.start])
            if spec.kind == "incremental_dynamic" else spec.start
        ) % bb.P
        stepped = spec.step % bb.P * i % p
        if spec.descending:
            return (np.uint64(start) + p - stepped) % p
        return (np.uint64(start) + stepped) % p
    if spec.kind == "stacked_incremental":
        # i - 2^floor(log2 i): floor-log2 exactly via bit_length
        out = np.zeros(n, np.uint64)
        bl = np.frompyfunc(lambda x: int(x).bit_length() - 1, 1, 1)(i[1:])
        out[1:] = (i[1:] - (np.uint64(1) << bl.astype(np.uint64))) % p
        return out
    if spec.kind == "stacked_constant":
        out = np.zeros(n, np.uint64)
        bl = np.frompyfunc(lambda x: int(x).bit_length() - 1, 1, 1)(i[1:])
        out[1:] = bl.astype(np.uint64) % p
        return out
    if spec.kind == "inner_repeat":
        return (i >> np.uint64(spec.k)) % p
    if spec.kind == "outer_repeat":
        return (i & np.uint64((1 << spec.k) - 1)) % p
    if spec.kind == "empty":
        return np.zeros(n, np.uint64)
    raise ValueError(f"unknown structural kind {spec.kind}")


def _wellform_eval(point: np.ndarray, offset: int, step: int,
                   descending: bool) -> np.ndarray:
    """offset +- step * (sum_j point[j] * 2^j) — the incremental MLE."""
    acc = np.zeros(4, np.uint64)
    for j in range(point.shape[0]):
        w = step % bb.P * pow(2, j, bb.P) % bb.P
        acc = exth.add(acc, exth.mul_base(point[j], np.uint64(w)))
    if descending:
        acc = exth.sub(exth.from_base(0), acc)
    return exth.add(exth.from_base(offset % bb.P), acc)


def structural_eval(spec: StructuralSpec, point: np.ndarray,
                    instances=None) -> np.ndarray:
    """Analytic MLE eval of a structural column at canonical point (n, 4)
    (verifier side — no PCS opening needed)."""
    point = np.asarray(point, np.uint64)
    if spec.kind in ("incremental", "incremental_dynamic"):
        start = (
            int(np.asarray(instances, np.uint64)[spec.start])
            if spec.kind == "incremental_dynamic" else spec.start
        )
        return _wellform_eval(point, start, spec.step, spec.descending)
    if spec.kind == "inner_repeat":
        return _wellform_eval(point[spec.k:], 0, 1, False)
    if spec.kind == "outer_repeat":
        return _wellform_eval(point[: spec.k], 0, 1, False)
    one = exth.one()
    if spec.kind == "stacked_incremental":
        acc = np.zeros(4, np.uint64)
        for j in range(1, point.shape[0]):
            inner = _wellform_eval(point[:j], 0, 1, False)
            acc = exth.add(
                exth.mul(acc, exth.sub(one, point[j])),
                exth.mul(inner, point[j]),
            )
        return acc
    if spec.kind == "stacked_constant":
        acc = np.zeros(4, np.uint64)
        for j in range(1, point.shape[0]):
            acc = exth.add(
                exth.mul(acc, exth.sub(one, point[j])),
                exth.mul_base(point[j], np.uint64(j % bb.P)),
            )
        return acc
    if spec.kind == "empty":
        return np.zeros(4, np.uint64)
    raise ValueError(f"unknown structural kind {spec.kind}")


def sel_prefix_sum(point: np.ndarray, k: int) -> np.ndarray:
    """sum_{x < k} eq(point, x): MLE eval of the prefix selector (host)."""
    n = point.shape[0]
    one = exth.one()
    if k >= (1 << n):  # full selector: sum of eq over the whole cube is 1
        return one
    result = np.zeros(4, np.uint64)
    prefix = one
    for j in range(n - 1, -1, -1):
        pj = point[j].astype(np.uint64)
        b0 = exth.sub(one, pj)
        if (k >> j) & 1:
            # x_j = 0 branch fully below k: lower bits free sum to 1
            result = exth.add(result, exth.mul(prefix, b0))
            prefix = exth.mul(prefix, pj)
        else:
            prefix = exth.mul(prefix, b0)
    return result


def sel_eq_eval(rt: np.ndarray, point: np.ndarray, k: int) -> np.ndarray:
    """sum_{x < k} eq(rt, x) * eq(point, x): MLE of the masked-eq column."""
    n = point.shape[0]
    rt = rt.astype(np.uint64)
    point = point.astype(np.uint64)
    if k >= (1 << n):  # unmasked: reduces to eq(rt, point)
        return exth.eq_eval(rt, point)
    one = exth.one()
    a = [
        exth.add(
            exth.mul(rt[j], point[j]),
            exth.mul(exth.sub(one, rt[j]), exth.sub(one, point[j])),
        )
        for j in range(n)
    ]
    lower = [one]
    for j in range(n):
        lower.append(exth.mul(lower[-1], a[j]))  # lower[j] = prod_{l<j} a_l
    result = np.zeros(4, np.uint64)
    prefix = one
    for j in range(n - 1, -1, -1):
        b0 = exth.mul(exth.sub(one, rt[j]), exth.sub(one, point[j]))
        b1 = exth.mul(rt[j], point[j])
        if (k >> j) & 1:
            result = exth.add(result, exth.mul(exth.mul(prefix, b0), lower[j]))
            prefix = exth.mul(prefix, b1)
        else:
            prefix = exth.mul(prefix, b0)
    return result


# ---------------------------------------------------------------------------
# Device record inference (expression evaluation over trace banks)
# ---------------------------------------------------------------------------

def _eval_expr(expr, ctx, memo):
    """Evaluate ``expr`` over the banks: ('b', base tensor) or ('e', (4, ...)
    ext tensor), Montgomery int32; constants stay 0-d / (4, 1) and
    broadcast. ``memo`` is keyed by ``id()``: every node must stay alive
    while the memo is in use, or a freed node's address can be reused."""
    key = id(expr)
    if key in memo:
        return memo[key]
    wit, fixed, structural, inst, chals = ctx
    if isinstance(expr, E.Wit):
        out = ("b", wit[expr.idx])
    elif isinstance(expr, E.Fix):
        out = ("b", fixed[expr.idx])
    elif isinstance(expr, E.Structural):
        out = ("b", structural[expr.idx])
    elif isinstance(expr, E.Const):
        out = ("b", torch.tensor(bb.const(expr.value), dtype=bb.DTYPE, device=chals.device))
    elif isinstance(expr, E.ExtConst):
        out = ("e", torch.tensor([bb.const(v) for v in expr.value], dtype=bb.DTYPE,
                                 device=chals.device).reshape(4, 1))
    elif isinstance(expr, E.Challenge):
        out = ("e", chals[expr.cid][:, None])
    elif isinstance(expr, E.ChallengePow):
        pkey = ("chalpow", expr.cid, expr.power)
        if pkey not in memo:
            cur = chals[expr.cid][:, None]
            for _ in range(expr.power - 1):
                cur = ext4.mul(cur, chals[expr.cid][:, None])
            memo[pkey] = ("e", cur)
        out = memo[pkey]
    elif isinstance(expr, E.Instance):
        out = ("b", inst[expr.idx])
    elif isinstance(expr, E.Neg):
        k, v = _eval_expr(expr.inner, ctx, memo)
        out = (k, bb.neg(v))
    elif isinstance(expr, E.Sum):
        k, v = _eval_expr(expr.terms[0], ctx, memo)
        for t in expr.terms[1:]:
            k2, v2 = _eval_expr(t, ctx, memo)
            k, v = _combine_add(k, v, k2, v2)
        out = (k, v)
    elif isinstance(expr, E.Prod):
        k, v = _eval_expr(expr.factors[0], ctx, memo)
        for f in expr.factors[1:]:
            k2, v2 = _eval_expr(f, ctx, memo)
            k, v = _combine_mul(k, v, k2, v2)
        out = (k, v)
    else:
        raise TypeError(type(expr))
    memo[key] = out
    return out


def _promote(v):
    z = torch.zeros_like(v)
    return torch.stack([v, z, z, z])


def _combine_add(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", bb.add(v1, v2)
    if k1 == "b":
        v1 = _promote(v1)
    if k2 == "b":
        v2 = _promote(v2)
    return "e", ext4.add(v1, v2)


def _combine_mul(k1, v1, k2, v2):
    if k1 == "b" and k2 == "b":
        return "b", bb.mul(v1, v2)
    if k1 == "b":
        return "e", ext4.mul_base(v2, v1)
    if k2 == "b":
        return "e", ext4.mul_base(v1, v2)
    return "e", ext4.mul(v1, v2)


def _as_ext_n(kind, v, n):
    if kind == "b":
        v = _promote(v)
    if v.shape[-1] != n:
        v = v[..., :1].expand(4, n)
    return v


def interleave_geometry(compiled: CompiledChip):
    """(rho, R_r, R_w, R_l): shared record-index bits for the interleaved
    towers (records are stacked record-major on TOP of the row bits, padded
    to 2^rho per category — the reference's record interleaving,
    scheme/utils.rs interleaving_mles_to_mles)."""
    r_r = len(compiled.r_exprs)
    r_w = len(compiled.w_exprs)
    r_l = len(compiled.lk_exprs) + len(compiled.lk_table)
    rho = max(
        (max(r, 1) - 1).bit_length() for r in (r_r, r_w, r_l)
    )
    return rho, r_r, r_w, r_l


def build_records_from_sel(compiled: CompiledChip, wit, fixed, structural,
                           inst, chals, sel):
    """Record inference core given an explicit selector column (Monty 0/1):
    (Mr, Mw, P, Q) interleaved record MLEs of size 2^rho * N each (or None
    for absent categories). Padding: products 1, logup p 0, logup q 1."""
    rho, r_r, r_w, r_l = interleave_geometry(compiled)
    n = wit.shape[1] if compiled.n_wit else structural.shape[1]
    dev = sel.device
    ctx = (wit, fixed, structural, inst, chals)
    memo = {}
    one = torch.tensor(bb.MONTY_ONE, dtype=bb.DTYPE, device=dev)

    def padded(expr):
        k, v = _eval_expr(expr, ctx, memo)
        v = _as_ext_n(k, v, n).clone()
        v[0] = bb.sub(v[0], one)
        out = ext4.mul_base(v, sel)
        out[0] = bb.add(out[0], one)
        return out

    def stack(recs, pad_one: bool):
        pad_count = (1 << rho) - len(recs)
        if pad_count:
            mk = ext4.ones if pad_one else ext4.zeros
            recs = recs + [mk((pad_count * n,), dev)]
        return torch.cat(recs, dim=-1)

    mr = stack([padded(e) for e in compiled.r_exprs], True) if r_r else None
    mw = stack([padded(e) for e in compiled.w_exprs], True) if r_w else None
    if r_l:
        ps, qs = [], []
        for e in compiled.lk_exprs:
            ps.append(_promote(sel))
            qs.append(padded(e))
        # hold the Neg temporaries alive for the whole loop: the memo is
        # id()-keyed, and a freed temp's address can be REUSED by the next
        # iteration's Neg, silently returning the previous record's value
        neg_mults = [E.Neg(mult) for mult, _ in compiled.lk_table]
        for nm, (mult, rec) in zip(neg_mults, compiled.lk_table):
            k, v = _eval_expr(nm, ctx, memo)
            v = _as_ext_n(k, v, n)
            ps.append(ext4.mul_base(v, sel))
            qs.append(padded(rec))
        p = stack(ps, False)
        q = stack(qs, True)
    else:
        p = q = None
    return mr, mw, p, q


def build_records(compiled: CompiledChip, wit, fixed, structural, inst, chals,
                  num_instances: int):
    """Records of one chip with the prefix selector ``row < num_instances``:
    the counterpart of the reference's jitted ``make_record_builder``."""
    n = wit.shape[1] if compiled.n_wit else structural.shape[1]
    dev = chals.device
    sel = torch.where(
        torch.arange(n, device=dev) < num_instances,
        torch.tensor(bb.MONTY_ONE, dtype=bb.DTYPE, device=dev),
        torch.tensor(0, dtype=bb.DTYPE, device=dev),
    )
    return build_records_from_sel(compiled, wit, fixed, structural, inst, chals, sel)


def chip_digest(compiled: CompiledChip) -> str:
    """Stable digest of a chip's full constraint structure (expression nodes
    are frozen dataclasses, so repr is deterministic)."""
    import hashlib

    r = repr((compiled.name, compiled.n_wit, compiled.n_fixed,
              compiled.structural, compiled.r_exprs, compiled.w_exprs,
              compiled.lk_exprs, compiled.lk_table, compiled.slots))
    return hashlib.sha256(r.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Chip proof
# ---------------------------------------------------------------------------

def _to_dev(x, device):
    """A Montgomery tensor stays as it is; a canonical numpy array moves to
    ``device`` (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x
    return bb.to_device(np.asarray(x, np.uint64), device or DEFAULT_DEVICE)


def _device_banks(wit, fixed, structural, instances, challenges, device):
    """(wit, fixed, structural, inst, chals) as Montgomery tensors on one
    device: the witness's own if it is a tensor, else ``device``."""
    wit = _to_dev(wit, device)
    dev = wit.device
    return (wit, _to_dev(fixed, dev), _to_dev(structural, dev),
            bb.to_device(np.asarray(instances, np.uint64), dev),
            bb.to_device(np.asarray(challenges, np.uint64), dev))


@dataclass
class ChipProof:
    num_instances: int
    n_vars: int
    tower_proof: tower.TowerProof
    main_msgs: np.ndarray
    wit_evals: np.ndarray        # (n_wit, 4) at main point
    fixed_evals: np.ndarray      # (n_fixed, 4)
    structural_evals: np.ndarray  # (n_structural, 4)


@dataclass
class ChipOpening:
    """Claims handed to the PCS stage."""

    point: np.ndarray       # (n_vars, 4) canonical
    wit_evals: np.ndarray   # (n_wit, 4)
    fixed_evals: np.ndarray


def _main_terms(compiled: CompiledChip, mults, gamma, eidx: int, col_base: int,
                instances, challenges) -> list:
    """The chip's main-zerocheck terms: each slot term's scalar times its
    slot multiplier (and the chip's class gamma, when batched), over the
    chip's columns at ``col_base`` and its sel_eq column ``eidx``."""
    term_list = []
    for si, slot in enumerate(compiled.slots):
        mult = mults[si] if gamma is None else exth.mul(gamma, mults[si])
        for tm in slot.terms:
            sc = exth.mul(mult, E.eval_scalar(tm.scalar, challenges, instances))
            bidx = tuple(
                col_base + _col_index(c, compiled.n_wit, compiled.n_fixed) for c in tm.cols
            )
            term_list.append(TermSpec(sc, bidx=bidx, eidx=(eidx,)))
    return term_list


def _chip_cols(compiled: CompiledChip, wit, fixed, structural) -> list:
    return (
        [wit[j] for j in range(compiled.n_wit)]
        + [fixed[j] for j in range(compiled.n_fixed)]
        + [structural[j] for j in range(len(compiled.structural))]
    )


def prove_chip(
    compiled: CompiledChip,
    wit,              # (n_wit, N) Montgomery tensor or canonical numpy
    fixed,            # (n_fixed, N)
    structural,       # (n_struct, N)
    instances: np.ndarray,  # canonical public values (host)
    num_instances: int,
    challenges: np.ndarray,  # (2, 4) canonical alpha, beta
    transcript: Transcript,
    device=None,
):
    """One chip on its own: records, its tower and its main zerocheck."""
    wit, fixed, structural, inst_dev, chals_dev = _device_banks(
        wit, fixed, structural, instances, challenges, device)
    n = wit.shape[1]
    n_vars = n.bit_length() - 1
    mr, mw, pcat, qcat = build_records(
        compiled, wit, fixed, structural, inst_dev, chals_dev, num_instances)
    prods = [m for m in (mr, mw) if m is not None]
    lps = [(pcat, qcat)] if pcat is not None else []
    assert prods or lps, f"{compiled.name}: chip has no records"
    with spans.span("towers"):
        tower_proof, rt, (prod_claims, logup_claims) = tower.prove_towers(
            prods, lps, transcript
        )

    x_star = rt[:n_vars]
    b_star = rt[n_vars:]
    mults, _meta = _slot_multipliers(compiled, b_star, transcript)
    # masked eq column sel_eq = eq(x*, .) * [row < num_instances]
    sel_eq = _masked_eq(bb.to_device(x_star, wit.device), num_instances)

    with spans.span("term-setup"):
        term_list = _main_terms(compiled, mults, None, 0, 0, instances, challenges)

    base_cols = _chip_cols(compiled, wit, fixed, structural)
    with spans.span("main-zerocheck"):
        out = sc_prover.prove(base_cols, [sel_eq], term_list, n_vars, transcript)
    transcript.append(out.final_base.ravel())

    wit_evals = out.final_base[: compiled.n_wit]
    fixed_evals = out.final_base[compiled.n_wit : compiled.n_wit + compiled.n_fixed]
    structural_evals = out.final_base[compiled.n_wit + compiled.n_fixed :]
    proof = ChipProof(
        num_instances, n_vars, tower_proof, out.proof.round_msgs,
        wit_evals, fixed_evals, structural_evals,
    )
    opening = ChipOpening(out.point, wit_evals, fixed_evals)
    return proof, opening


def _slot_multipliers(compiled: CompiledChip, b_star: np.ndarray, transcript):
    """Sample the main-sumcheck batching alphas and derive per-slot scalar
    multipliers: record slots get alpha_cat * eq(b*, rec) (the interleaved
    claim decomposes as M(rt) = sum_r eq(b*, r) * P_r(x*)); zero-constraint
    slots get their own alpha. Returns (mults per slot, meta dict)."""
    rho, r_r, r_w, r_l = interleave_geometry(compiled)
    n_zero = sum(1 for s in compiled.slots if s.kind == "zero")
    has_r, has_w, has_l = r_r > 0, r_w > 0, r_l > 0
    n_alpha = int(has_r) + int(has_w) + 2 * int(has_l) + n_zero
    alphas = transcript.sample_ext_pows(n_alpha)
    w = H.build_eq_host(np.asarray(b_star, np.uint64))  # (2^rho, 4)
    ai = 0
    meta = {"w": w}
    for key, flag in (("a_r", has_r), ("a_w", has_w)):
        meta[key] = alphas[ai] if flag else None
        ai += int(flag)
    if has_l:
        meta["a_p"] = alphas[ai]
        meta["a_q"] = alphas[ai + 1]
        ai += 2
    else:
        meta["a_p"] = meta["a_q"] = None
    zero_base = ai
    mults = []
    zi = 0
    for s in compiled.slots:
        if s.kind == "prod_r":
            mults.append(exth.mul(meta["a_r"], w[s.rec]))
        elif s.kind == "prod_w":
            mults.append(exth.mul(meta["a_w"], w[s.rec]))
        elif s.kind == "lkq":
            mults.append(exth.mul(meta["a_q"], w[s.rec]))
        elif s.kind == "lkp_table":
            mults.append(exth.mul(meta["a_p"], w[s.rec]))
        else:
            mults.append(alphas[zero_base + zi])
            zi += 1
    return mults, meta


def _masked_eq(rt, num_instances: int):
    """eq(rt, .) on the device with the rows from ``num_instances`` on zeroed."""
    eq = ops.build_eq(rt)
    eq[:, num_instances:] = 0
    return eq


class ChipError(Exception):
    pass


# ---------------------------------------------------------------------------
# Class-batched main zerocheck (cross-chip batching)
#
# Instead of one main sumcheck per chip, all chips of one height class run
# ONE batched zerocheck. Per-chip towers stay as they are (each absorbs its
# proof and samples its slot alphas on the shared transcript); after ALL
# towers of the class are bound, the class samples fresh gamma powers (one
# per chip) and proves
#     sum_i gamma_i * sel_eq_i(x) * (sum_slot mult_slot * slot_expr_i(x)) = claim
# in a single sumcheck over the class's n_vars. Every chip in the class then
# opens its witness columns at the SAME point — the PCS batch gets one main
# point per height class.
# ---------------------------------------------------------------------------


@dataclass
class _TowerInputs:
    """Per-chip record MLEs waiting for the grouped tower stage."""

    compiled: CompiledChip
    num_instances: int
    n_vars: int
    wit_dev: object
    fixed_dev: object
    structural_dev: object
    prods: list        # [(4, N_t) device Monty]
    lps: list          # [(p, q)] same convention
    n_tower: int       # N_t = n << rho (the grouping key)


@dataclass
class ClassMainProof:
    """One batched main zerocheck for all chips of a height class."""

    main_msgs: np.ndarray          # (n_vars, deg+1, 4)
    wit_evals: list                # per chip (class order): (n_wit, 4)
    fixed_evals: list              # per chip: (n_fixed, 4)
    structural_evals: list         # per chip: (n_struct, 4)


@dataclass
class _TowerCtx:
    """Prover-side state between a chip's tower and its class's main stage."""

    compiled: CompiledChip
    num_instances: int
    n_vars: int
    wit_dev: object
    fixed_dev: object
    structural_dev: object
    x_star: np.ndarray
    mults: list


def build_tower_inputs(
    compiled: CompiledChip,
    wit,
    fixed,
    structural,
    instances: np.ndarray,
    num_instances: int,
    challenges: np.ndarray,
    device=None,
) -> _TowerInputs:
    """Record inference for one chip (stage 1a of the class-batched prove).
    No transcript interaction — the records wait for the grouped tower.
    Canonical numpy banks move to ``device`` (the card by default); tensors
    stay where they are."""
    wit, fixed, structural, inst_dev, chals_dev = _device_banks(
        wit, fixed, structural, instances, challenges, device)
    n = wit.shape[1]
    n_vars = n.bit_length() - 1
    mr, mw, pcat, qcat = build_records(
        compiled, wit, fixed, structural, inst_dev, chals_dev, num_instances)
    prods = [m for m in (mr, mw) if m is not None]
    lps = [(pcat, qcat)] if pcat is not None else []
    assert prods or lps, f"{compiled.name}: chip has no records"
    rho, _, _, _ = interleave_geometry(compiled)
    return _TowerInputs(
        compiled, num_instances, n_vars,
        wit, fixed, structural, prods, lps, n << rho,
    )


def prove_group_towers(inputs: list, transcript: Transcript):
    """Stage 1b: ONE tower prove for all chips whose interleaved record tree
    has the same size N_t = n << rho (the per-level sumchecks run once per
    group instead of once per chip). The final point rt is shared; each chip
    splits it per its own geometry (x* = rt[:n_vars], b* = rt[n_vars:]).
    Per-chip slot-multiplier challenges are sampled after the group tower, in
    chip order. Returns (tower.TowerProof, [_TowerCtx])."""
    prods, lps = [], []
    for ti in inputs:
        prods += ti.prods
        lps += ti.lps
    with spans.span(f"towers/2^{inputs[0].n_tower.bit_length() - 1}"):
        tower_proof, rt, _claims = tower.prove_towers(prods, lps, transcript)
    ctxs = []
    for ti in inputs:
        x_star = rt[: ti.n_vars]
        b_star = rt[ti.n_vars :]
        mults, _meta = _slot_multipliers(ti.compiled, b_star, transcript)
        ctxs.append(_TowerCtx(
            ti.compiled, ti.num_instances, ti.n_vars,
            ti.wit_dev, ti.fixed_dev, ti.structural_dev, x_star, mults,
        ))
    return tower_proof, ctxs


def prove_class_main(
    ctxs: list,
    instances: np.ndarray,
    challenges: np.ndarray,
    transcript: Transcript,
):
    """Stage 2: one batched zerocheck for all chips of one height class.

    Returns (ClassMainProof, [ChipOpening per chip in ctx order])."""
    n_vars = ctxs[0].n_vars
    assert all(c.n_vars == n_vars for c in ctxs)
    gammas = transcript.sample_ext_pows(len(ctxs))

    base_cols = []
    ext_cols = []
    term_list = []
    col_base = 0
    for i, ctx in enumerate(ctxs):
        compiled = ctx.compiled
        ext_cols.append(_masked_eq(bb.to_device(ctx.x_star, ctx.wit_dev.device),
                                   ctx.num_instances))
        term_list += _main_terms(compiled, ctx.mults, gammas[i], i, col_base,
                                 instances, challenges)
        base_cols += _chip_cols(compiled, ctx.wit_dev, ctx.fixed_dev, ctx.structural_dev)
        col_base += compiled.n_cols

    with spans.span(f"main-zerocheck/2^{n_vars}"):
        out = sc_prover.prove(base_cols, ext_cols, term_list, n_vars, transcript)
    transcript.append(out.final_base.ravel())

    wit_evals, fixed_evals, structural_evals, openings = [], [], [], []
    off = 0
    for ctx in ctxs:
        compiled = ctx.compiled
        we = out.final_base[off : off + compiled.n_wit]
        fe = out.final_base[off + compiled.n_wit : off + compiled.n_wit + compiled.n_fixed]
        se = out.final_base[
            off + compiled.n_wit + compiled.n_fixed : off + compiled.n_cols
        ]
        off += compiled.n_cols
        wit_evals.append(we)
        fixed_evals.append(fe)
        structural_evals.append(se)
        openings.append(ChipOpening(out.point, we, fe))
    proof = ClassMainProof(out.proof.round_msgs, wit_evals, fixed_evals, structural_evals)
    return proof, openings


@dataclass
class _VerifyCtx:
    """Verifier-side state between a chip's tower and the class main check."""

    compiled: CompiledChip
    num_instances: int
    n_vars: int
    x_star: np.ndarray
    mults: list
    batched_claim: np.ndarray
    main_deg: int


def verify_group_towers(
    entries: list,
    group_proof: tower.TowerProof,
    instances: np.ndarray,
    challenges: np.ndarray,
    transcript: Transcript,
):
    """Stage 1 of the class-batched verify: ONE tower verification for every
    chip of one tower-size group (mirrors prove_group_towers).

    ``entries``: [(compiled, num_instances, n_vars)] in group chip order.
    Returns [(_VerifyCtx, prod_values (S_p_i, 4), logup_fracs (S_l_i, 2, 4))
    per chip]. Raises ChipError if the proof's spec count does not match the
    group geometry."""
    geo = [interleave_geometry(e[0]) for e in entries]
    n_tower_vars = entries[0][2] + geo[0][0]
    for (compiled, k, n_vars), (rho, _, _, _) in zip(entries, geo):
        if n_vars + rho != n_tower_vars:
            raise ChipError(f"{compiled.name}: tower group size mismatch")
    rt, prod_claims, logup_claims, prod_values, logup_fracs = tower.verify_towers(
        group_proof, n_tower_vars, transcript
    )
    out = []
    pi = li = 0
    one = exth.one()
    for (compiled, k, n_vars), (rho, r_r, r_w, r_l) in zip(entries, geo):
        n_lk = len(compiled.lk_exprs)
        x_star = rt[:n_vars]
        b_star = rt[n_vars:]
        mults, meta = _slot_multipliers(compiled, b_star, transcript)
        w = meta["w"]

        batched = np.zeros(4, np.uint64)
        chip_prod_values = []
        if r_r:
            batched = exth.add(
                batched, exth.mul(meta["a_r"], exth.sub(prod_claims[pi], one))
            )
            chip_prod_values.append(prod_values[pi])
            pi += 1
        if r_w:
            batched = exth.add(
                batched, exth.mul(meta["a_w"], exth.sub(prod_claims[pi], one))
            )
            chip_prod_values.append(prod_values[pi])
            pi += 1
        chip_logup_fracs = np.zeros((0, 2, 4), np.uint64)
        if r_l:
            sel_v = sel_prefix_sum(x_star, k)
            w_chip = np.zeros(4, np.uint64)
            for i in range(n_lk):
                w_chip = exth.add(w_chip, w[i])
            p_claim = exth.sub(logup_claims[li][0], exth.mul(sel_v, w_chip))
            batched = exth.add(batched, exth.mul(meta["a_p"], p_claim))
            batched = exth.add(
                batched, exth.mul(meta["a_q"], exth.sub(logup_claims[li][1], one))
            )
            chip_logup_fracs = logup_fracs[li : li + 1]
            li += 1
        main_deg = max(
            (len(t.cols) + 1 for s in compiled.slots for t in s.terms), default=1
        )
        ctx = _VerifyCtx(compiled, k, n_vars, x_star, mults, batched, main_deg)
        out.append((
            ctx,
            np.stack(chip_prod_values)
            if chip_prod_values else np.zeros((0, 4), np.uint64),
            chip_logup_fracs,
        ))
    if pi != prod_values.shape[0] or li != logup_fracs.shape[0]:
        raise ChipError("tower group spec count mismatch")
    return out


def verify_class_main(
    vctxs: list,
    class_proof: ClassMainProof,
    instances: np.ndarray,
    challenges: np.ndarray,
    transcript: Transcript,
):
    """Stage 2 of the class-batched verify. Returns [ChipOpening per chip]."""
    n_vars = vctxs[0].n_vars
    if any(v.n_vars != n_vars for v in vctxs):
        raise ChipError("class members disagree on n_vars")
    if (
        len(class_proof.wit_evals) != len(vctxs)
        or len(class_proof.fixed_evals) != len(vctxs)
        or len(class_proof.structural_evals) != len(vctxs)
    ):
        raise ChipError("class proof eval count mismatch")
    gammas = transcript.sample_ext_pows(len(vctxs))
    combined = np.zeros(4, np.uint64)
    for g, v in zip(gammas, vctxs):
        combined = exth.add(combined, exth.mul(g, v.batched_claim))
    deg = max(v.main_deg for v in vctxs)
    point, final_claim = sc_verifier.verify(
        combined, class_proof.main_msgs, n_vars, transcript, deg=deg
    )
    flat = []
    for i, v in enumerate(vctxs):
        we = np.asarray(class_proof.wit_evals[i], np.uint64)
        fe = np.asarray(class_proof.fixed_evals[i], np.uint64)
        se = np.asarray(class_proof.structural_evals[i], np.uint64)
        if we.shape != (v.compiled.n_wit, 4) or fe.shape != (v.compiled.n_fixed, 4) \
                or se.shape != (len(v.compiled.structural), 4):
            raise ChipError(f"{v.compiled.name}: eval shape mismatch")
        flat += [we, fe, se]
    transcript.append(
        np.concatenate([x.reshape(-1) for x in flat])
        if flat else np.zeros(0, np.uint64)
    )

    total = np.zeros(4, np.uint64)
    openings = []
    for i, v in enumerate(vctxs):
        compiled = v.compiled
        we = np.asarray(class_proof.wit_evals[i], np.uint64)
        fe = np.asarray(class_proof.fixed_evals[i], np.uint64)
        se = np.asarray(class_proof.structural_evals[i], np.uint64)
        for j, spec in enumerate(compiled.structural):
            if not np.array_equal(se[j], structural_eval(spec, point, instances)):
                from ..utils import replay

                if not replay.structure_only():
                    raise ChipError(
                        f"{compiled.name}: structural column {j} eval mismatch"
                    )
        col_evals = (
            np.concatenate([we, fe, se], axis=0)
            if compiled.n_cols
            else np.zeros((0, 4), np.uint64)
        )
        acc = np.zeros(4, np.uint64)
        for si, slot in enumerate(compiled.slots):
            slot_val = np.zeros(4, np.uint64)
            for tm in slot.terms:
                val = E.eval_scalar(tm.scalar, challenges, instances)
                for c in tm.cols:
                    val = exth.mul(
                        val, col_evals[_col_index(c, compiled.n_wit, compiled.n_fixed)]
                    )
                slot_val = exth.add(slot_val, val)
            acc = exth.add(acc, exth.mul(v.mults[si], slot_val))
        s_eq = sel_eq_eval(v.x_star, point, v.num_instances)
        total = exth.add(total, exth.mul(gammas[i], exth.mul(s_eq, acc)))
        openings.append(ChipOpening(point, we, fe))
    if not np.array_equal(total, final_claim):
        from ..utils import replay

        if not replay.structure_only():
            raise ChipError("class main sumcheck recombination mismatch")
    return openings


def verify_chip(
    compiled: CompiledChip,
    proof: ChipProof,
    instances: np.ndarray,   # canonical public values
    challenges: np.ndarray,  # (2, 4) canonical
    transcript: Transcript,
):
    """Returns (opening: ChipOpening, prod_values (S_p,4), logup_fracs (S_l,2,4)).

    prod_values = [prod(reads)?, prod(writes)?] per present category;
    logup_fracs has one (p, q) fraction when the chip has lookups. Raises
    ChipError on any failure."""
    n_vars = proof.n_vars
    k = proof.num_instances
    rho, r_r, r_w, r_l = interleave_geometry(compiled)
    n_lk = len(compiled.lk_exprs)
    rt, prod_claims, logup_claims, prod_values, logup_fracs = tower.verify_towers(
        proof.tower_proof, n_vars + rho, transcript
    )
    x_star = rt[:n_vars]
    b_star = rt[n_vars:]
    mults, meta = _slot_multipliers(compiled, b_star, transcript)
    w = meta["w"]
    one = exth.one()

    batched = np.zeros(4, np.uint64)
    pi = 0
    if r_r:
        batched = exth.add(batched, exth.mul(meta["a_r"], exth.sub(prod_claims[pi], one)))
        pi += 1
    if r_w:
        batched = exth.add(batched, exth.mul(meta["a_w"], exth.sub(prod_claims[pi], one)))
        pi += 1
    if r_l:
        # chip-side lookup numerators are sel: p(rt) = sum_{chip recs} w_r * sel(x*)
        # + (table-side main terms); move the analytic part into the claim
        sel_v = sel_prefix_sum(x_star, k)
        w_chip = np.zeros(4, np.uint64)
        for i in range(n_lk):
            w_chip = exth.add(w_chip, w[i])
        p_claim = exth.sub(logup_claims[0][0], exth.mul(sel_v, w_chip))
        batched = exth.add(batched, exth.mul(meta["a_p"], p_claim))
        batched = exth.add(
            batched, exth.mul(meta["a_q"], exth.sub(logup_claims[0][1], one))
        )

    main_deg = max(
        (len(t.cols) + 1 for s in compiled.slots for t in s.terms), default=1
    )
    point, final_claim = sc_verifier.verify(
        batched, proof.main_msgs, n_vars, transcript, deg=main_deg
    )
    transcript.append(proof.wit_evals.ravel())
    transcript.append(proof.fixed_evals.ravel())
    transcript.append(proof.structural_evals.ravel())

    # structural evals must match their analytic values
    for i, spec in enumerate(compiled.structural):
        expect = structural_eval(spec, point, instances)
        if not np.array_equal(proof.structural_evals[i], expect):
            raise ChipError(f"{compiled.name}: structural column {i} eval mismatch")

    # recombination at the opening point
    col_evals = np.concatenate(
        [proof.wit_evals, proof.fixed_evals, proof.structural_evals], axis=0
    ) if compiled.n_cols else np.zeros((0, 4), np.uint64)
    s_eq = sel_eq_eval(x_star, point, k)
    acc = np.zeros(4, np.uint64)
    for i, slot in enumerate(compiled.slots):
        slot_val = np.zeros(4, np.uint64)
        for t in slot.terms:
            v = E.eval_scalar(t.scalar, challenges, instances)
            for c in t.cols:
                v = exth.mul(v, col_evals[_col_index(c, compiled.n_wit, compiled.n_fixed)])
            slot_val = exth.add(slot_val, v)
        acc = exth.add(acc, exth.mul(mults[i], slot_val))
    if not np.array_equal(exth.mul(s_eq, acc), final_claim):
        raise ChipError(f"{compiled.name}: main sumcheck recombination mismatch")

    opening = ChipOpening(point, proof.wit_evals, proof.fixed_evals)
    return opening, prod_values, logup_fracs
