"""Goldilocks multi-chip zkVM scheme: prove and verify a whole shard over
GoldilocksExt2 (reference `--field goldilocks`, ceno_zkvm/src/e2e.rs:103-129:
the same rv32im circuits instantiated over GL).

Counterpart of ``ceno_tpu/gl/scheme.py``. Against the BabyBear scheme
(zkvm/scheme.py), the chip set, witgen, record conventions, tower/logup
semantics, masked-selector main argument and the global bus checks
(prod(reads) == prod(writes), sum of logup fractions = 0) are the same; the
schedule is the simpler per-chip one: each active chip commits its witness
separately (GL Basefold, gl/pcs.py), proves its towers and its own masked
main zerocheck on the shared transcript, and opens its commitment at its own
point. The transcript order is this configuration's own contract
(``LABEL_GL``).

Field-specific witness columns (is-zero inverses, wraparound-encoded
differences and immediates) come from the standard witgen run under the GL
field context (zkvm/chips/field_ctx.py). Fixed table columns are key
material: the verifier evaluates their MLEs directly (no GL fixed
commitment). Structural columns are evaluated analytically over GL
(:func:`structural_table_gl` / :func:`structural_eval_gl`, the spec's
BabyBear-encoded signed step decoded by centered lift). With a
``shard_ctx`` (gl/shard.py) the GL shard chips carry cross-shard tokens and
the EC-tree chips' sums are proved by the quark (gl/eccquark.py).

:func:`prove_gl` runs on the card unless the caller passes ``device``: each
active chip's witness goes to the device once, beside its fixed and
structural columns (banks of the main zerocheck); the commit runs K14a-c,
and the records, towers, main zerocheck, opening and quark run through
gl/zkvm.py, gl/sumcheck.py and gl/pcs.py on that device. The witgen, the
transcript, the challenges and the public values stay on the host.
Unlike the reference, which derives the GL key on every call,
:func:`prove_gl` takes the key it was given (``vk``, the same bytes) and
derives it only when it has none. :func:`keygen_gl` and :func:`verify_gl`
are host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fields import gl_host as gl
from ..fields import goldilocks as gld
from ..fields import gl2_host as g2
from ..gkr.circuit_builder import StructuralSpec
from ..fields import babybear as bb
from . import eccquark as glq
from . import pcs as gpcs
from . import sumcheck as gsc
from . import zkvm as glz
from .transcript import GlTranscript
from ..utils import spans
from ..zkvm.layout import (
    N_PUBLIC_VALUES, PV_SHARD_ID, PV_RW_SUM_IN, PV_RW_SUM_OUT,
    PV_HEAP_WORDS, PV_STACK_WORDS, PV_INFO_WORDS,
)

_P = np.uint64(gl.P)
LABEL_GL = b"ceno-gl/zkvm/v2"  # v2: GL continuations (quintic shard chips + quark)


class GlSchemeError(Exception):
    pass


# -- structural columns over GL ------------------------------------------------

def _lift_signed(v: int) -> int:
    """Decode a BabyBear-encoded signed constant by centered lift."""
    v = int(v) % bb.P
    return v - bb.P if v > bb.P // 2 else v


def structural_table_gl(spec: StructuralSpec, n: int,
                        instances=None) -> np.ndarray:
    i = np.arange(n, dtype=np.uint64)
    if spec.kind in ("incremental", "incremental_dynamic"):
        start = (
            int(np.asarray(instances, np.uint64)[spec.start])
            if spec.kind == "incremental_dynamic" else _lift_signed(spec.start)
        )
        step = _lift_signed(spec.step)
        stepped = np.uint64(step % gl.P) * i % _P
        if spec.descending:
            return (np.uint64(start % gl.P) + _P - stepped) % _P
        return (np.uint64(start % gl.P) + stepped) % _P
    if spec.kind == "stacked_incremental":
        out = np.zeros(n, np.uint64)
        bl = np.frompyfunc(lambda x: int(x).bit_length() - 1, 1, 1)(i[1:])
        out[1:] = (i[1:] - (np.uint64(1) << bl.astype(np.uint64))) % _P
        return out
    if spec.kind == "stacked_constant":
        out = np.zeros(n, np.uint64)
        bl = np.frompyfunc(lambda x: int(x).bit_length() - 1, 1, 1)(i[1:])
        out[1:] = bl.astype(np.uint64) % _P
        return out
    if spec.kind == "inner_repeat":
        return (i >> np.uint64(spec.k)) % _P
    if spec.kind == "outer_repeat":
        return (i & np.uint64((1 << spec.k) - 1)) % _P
    if spec.kind == "empty":
        return np.zeros(n, np.uint64)
    raise GlSchemeError(f"unknown structural kind {spec.kind}")


def _mle_eval_gl(col: np.ndarray, point: np.ndarray) -> np.ndarray:
    """sum_x eq(point, x) * col[x] over GL2 (host, vectorized)."""
    eq = gsc.build_eq_host(point)
    n = min(len(col), eq.shape[0])
    return glz._gl2_sum(g2.mul_base(eq[:n], np.asarray(col[:n], np.uint64)))


def structural_eval_gl(spec: StructuralSpec, point: np.ndarray,
                       instances=None) -> np.ndarray:
    n = 1 << point.shape[0]
    return _mle_eval_gl(structural_table_gl(spec, n, instances), point)


# -- proof objects -------------------------------------------------------------

@dataclass
class GlChipPiece:
    root: np.ndarray
    tower: object                  # glz.GlTowerProof
    main_msgs: np.ndarray
    wit_evals: np.ndarray          # (n_wit, 2)
    fixed_evals: np.ndarray        # (n_fixed, 2)
    structural_evals: np.ndarray   # (n_struct, 2)
    opening: object                # gpcs.GlOpening
    ec_proof: object = None        # glq.GlEccQuarkProof (ec_tree chips)
    ec_extra: dict = None          # point name -> (evals (n_wit,2), opening)


@dataclass
class GlZKVMProof:
    public_values: np.ndarray
    num_instances: list
    pieces: dict                   # chip index -> GlChipPiece


@dataclass
class GlVerifyingKey:
    metas: list                    # ChipMeta list (shard slots are GL-native)
    cfg: object
    fixed_cols: dict               # chip index -> (n_fixed, n_rows) canonical
    shard_chips: list = None       # GL shard chip defs (prover-side witgen)

    def digest_elems(self) -> np.ndarray:
        import hashlib

        h = hashlib.sha256()
        h.update(len(self.metas).to_bytes(4, "little"))
        for ci in sorted(self.fixed_cols):
            h.update(np.ascontiguousarray(self.fixed_cols[ci],
                                          np.uint64).tobytes())
        return np.frombuffer(h.digest(), np.uint32).astype(np.uint64) % _P


def keygen_gl(pk) -> GlVerifyingKey:
    """Derive the GL verifying key from a BabyBear ProvingKey (the compiled
    chips are field-generic; the BabyBear fixed commitments are unused here
    — fixed columns are GL key material). Fixed CONTENTS are re-generated
    under the GL field context: the program table field-encodes signed
    immediates, so its fixed columns are field-dependent.

    The 4 shard-chip meta slots are SWAPPED for the GL-native chips
    (gl/shard_chips.py): the septic circuits are a BabyBear-extension
    construction (z^7 - 2z - 5 arithmetic, BabyBear Poseidon2 constants)
    and must never be proven over GL."""
    from ..zkvm.chips import field_ctx
    from ..zkvm.scheme import ChipMeta
    from .shard_chips import build_gl_shard_chips

    n_pre = len(pk.opcode_chips) + len(pk.shard_chips) + len(pk.dyn_chips)
    fixed_cols = {}
    with field_ctx.use(gl.P, inv=gl.inv):
        for ti, tdef in enumerate(pk.tables):
            if not tdef.cb.fixed_names:
                continue
            fixed_cols[n_pre + ti] = np.asarray(tdef.fixed_fn(), np.uint64)
    metas = list(pk.metas)
    gl_chips = build_gl_shard_chips()
    base = len(pk.opcode_chips)
    assert len(pk.shard_chips) == len(gl_chips)
    for j, chip in enumerate(gl_chips):
        old = metas[base + j]
        assert old.kind == chip.kind, (old.kind, chip.kind)
        metas[base + j] = ChipMeta(
            chip.name, chip.compiled, chip.cb, False, None, kind=chip.kind
        )
    return GlVerifyingKey(metas, pk.cfg, fixed_cols, shard_chips=gl_chips)


def _pow2(k: int) -> int:
    return max(2, 1 << max(0, (k - 1).bit_length()))


def _chip_height_gl(meta, k: int) -> int:
    if meta.is_table:
        return _pow2(meta.table_rows)
    if meta.kind.startswith("ec_tree"):
        return 4 if k == 0 else 2 * _pow2(k)
    return _pow2(k)


def _mle_evals_device(wit: torch.Tensor, point: np.ndarray) -> np.ndarray:
    """(n_wit, 2): every column's MLE at ``point``, on the columns' device."""
    eq = gsc.build_eq(np.asarray(point, np.uint64), wit.device)
    return gld.to_host(gpcs.gamma_combine(eq, wit.T))


def _bank_rows(mat: np.ndarray, n: int, device) -> torch.Tensor:
    """(C, rows <= n) canonical host columns, zero-padded to n rows, as an
    int64 tensor on ``device``."""
    out = np.zeros((mat.shape[0], n), np.uint64)
    out[:, :mat.shape[1]] = mat
    return gld.to_device(out, device)


def prove_gl(pk, vm, records, public_values, params=None,
             shard_ctx=None, device=None, vk=None) -> GlZKVMProof:
    """Prove one GL shard on ``device`` (the card when None). Standalone by
    default; with ``shard_ctx`` (a zkvm/shard.ShardContext whose pv carries
    the quintic rw sums, gl/shard.py) the cross-shard chips activate: tokens
    hash onto the GL quintic curve in-circuit, the EC trees are accumulated
    by the quark zerocheck (gl/eccquark.py) and opened at its three extended
    points. ``vk`` is ``keygen_gl(pk)``, derived here when not given."""
    from ..zkvm.chips import field_ctx
    from ..zkvm.witgen import generate_witness

    params = params or gpcs.GlParams()
    dev = torch.device("cuda" if device is None else device)
    pv = np.asarray(public_values, np.uint64) % _P
    if len(pv) != N_PUBLIC_VALUES:
        raise GlSchemeError("bad public value count")
    if vk is None:
        vk = keygen_gl(pk)
    with spans.span("gl/witgen"), field_ctx.use(gl.P, inv=gl.inv):
        assigned = generate_witness(
            records, pk.opcode_chips, pk.tables, vm, pv, pk.cfg,
            shard_ctx=shard_ctx, shard_chips=vk.shard_chips,
            dyn_chips=pk.dyn_chips, data_image=pk.data_image,
        )
    t = GlTranscript(LABEL_GL)
    t.append(vk.digest_elems())
    t.append(pv)

    num_instances = [a.num_instances for a in assigned]
    active = [ci for ci, a in enumerate(assigned) if a.num_instances > 0]
    committed = {}
    for ci in active:
        a = assigned[ci]
        with spans.span("gl/commit"):
            wit = gld.to_device(np.asarray(a.wit, np.uint64) % _P, dev)
            committed[ci] = gpcs.commit(wit, params)
        t.append(committed[ci].root)
        t.append([a.num_instances % gl.P])
    challenges = np.stack([t.sample_ext(), t.sample_ext()])

    pieces = {}
    for ci in active:
        with spans.span(f"gl/chip/{vk.metas[ci].name}"):
            pieces[ci] = _prove_chip(vk, ci, assigned[ci], committed.pop(ci),
                                     pv, challenges, t, params)
    return GlZKVMProof(pv, num_instances, pieces)


def _prove_chip(vk, ci, a, com, pv, challenges, t, params) -> GlChipPiece:
    """One active chip's towers, main zerocheck, opening and (for an EC-tree
    chip) quark on the device of its committed witness."""
    compiled = a.compiled
    wit = com.cols
    dev = wit.device
    n = wit.shape[1]
    n_vars = n.bit_length() - 1
    k = a.num_instances
    fixed = vk.fixed_cols.get(ci)
    fixed = (torch.zeros((0, n), dtype=gld.DTYPE, device=dev) if fixed is None
             else _bank_rows(fixed, n, dev))
    nw, nf = compiled.n_wit, fixed.shape[0]
    structural = (_bank_rows(np.stack([structural_table_gl(s, n, pv)
                                       for s in compiled.structural]), n, dev)
                  if compiled.structural
                  else torch.zeros((0, n), dtype=gld.DTYPE, device=dev))
    with spans.span("gl/records"):
        prods, logups = glz.build_records_gl(
            compiled, wit, fixed, structural, pv, challenges, k
        )
    with spans.span("gl/towers"):
        tower_proof, rt, _claims = glz.prove_towers_gl(prods, logups, t)
    del prods, logups
    with spans.span("gl/main"):
        alphas = t.sample_ext_pows(len(compiled.slots))
        sel_eq = glz._sel_eq_masked(rt, k, n, dev)
        terms = []
        for si, slot in enumerate(compiled.slots):
            for tm in slot.terms:
                sc_ = g2.mul(alphas[si],
                             glz._eval_scalar_gl(tm.scalar, challenges, pv))
                bidx = tuple(glz._col_index(c, compiled.n_wit,
                                            compiled.n_fixed)
                             for c in tm.cols)
                terms.append((sc_, bidx, (0,)))
        base_cols = (
            [wit[i] for i in range(compiled.n_wit)]
            + [fixed[i] for i in range(fixed.shape[0])]
            + [structural[i] for i in range(structural.shape[0])]
        )
        out = gsc.prove(base_cols, [sel_eq], terms, n_vars, t)
    del fixed, structural, base_cols, sel_eq
    evals = out.final_base  # (n_cols, 2) in wit++fixed++structural order
    wit_evals = evals[:nw]
    fixed_evals = evals[nw:nw + nf]
    structural_evals = evals[nw + nf:]
    t.append(evals.ravel())
    with spans.span("gl/open"):
        opening = gpcs.open_batch(com, out.point, wit_evals, t, params)
    ec_proof = None
    ec_extra = None
    meta = vk.metas[ci]
    if meta.kind.startswith("ec_tree"):
        with spans.span("gl/quark"):
            base = (PV_RW_SUM_IN if meta.kind.endswith("_in")
                    else PV_RW_SUM_OUT)
            fsum = np.stack([pv[base : base + 5], pv[base + 7 : base + 12]])
            if not np.array_equal(np.asarray(a.ec_final_sum, np.uint64),
                                  fsum):
                raise GlSchemeError(f"{meta.name}: tree sum != public values")
            ec_proof, rt = glq.prove_ec_sum(wit[0:5], wit[5:10], wit[10:15],
                                            k, fsum, t)
            pts = glq.extended_points(np.asarray(rt, np.uint64))
            ec_extra = {}
            for pname in ("even", "odd", "half"):
                pt = pts[pname]
                evs = _mle_evals_device(wit[:compiled.n_wit], pt)
                t.append(evs.ravel())
                ec_extra[pname] = (
                    evs, gpcs.open_batch(com, pt, evs, t, params)
                )
    return GlChipPiece(
        com.root, tower_proof, out.round_msgs,
        wit_evals, fixed_evals, structural_evals, opening,
        ec_proof=ec_proof, ec_extra=ec_extra,
    )


def verify_gl(vk: GlVerifyingKey, proof: GlZKVMProof, params=None,
              expect_halt: bool = True, *, is_first: bool = True,
              is_last: bool = True, standalone: bool = True) -> bool:
    """Verify one GL shard proof: transcript replay, per-chip towers +
    masked main zerocheck + PCS opening, fixed/structural MLEs from key
    material, first/last activity gating, EC-tree quark verification
    (non-standalone), and the global bus checks. ``standalone`` (the
    single-shard public API) additionally requires shard_id == 0 and an
    empty cross-shard bus; multi-shard stitching is gl/shard.py."""
    params = params or gpcs.GlParams()
    pv = np.asarray(proof.public_values, np.uint64)
    if len(pv) != N_PUBLIC_VALUES:
        raise GlSchemeError("bad public value count")
    if standalone:
        if not (is_first and is_last):
            raise GlSchemeError("standalone implies first and last")
        if int(pv[PV_SHARD_ID]) != 0:
            raise GlSchemeError("standalone proof must be shard 0")
        if pv[PV_RW_SUM_IN:PV_RW_SUM_IN + 28].any():
            raise GlSchemeError("standalone proof must have empty rw sums")
    for base in (PV_RW_SUM_IN, PV_RW_SUM_OUT):
        # quintic sums use 5 of the 7 per-coordinate slots; the rest are
        # reserved-zero so a prover cannot smuggle state through them
        if pv[base + 5 : base + 7].any() or pv[base + 12 : base + 14].any():
            raise GlSchemeError("reserved rw-sum slots must be zero")
    if len(proof.num_instances) != len(vk.metas):
        raise GlSchemeError("chip count mismatch")
    if expect_halt and is_last:
        n_halt = sum(int(proof.num_instances[ci])
                     for ci, m in enumerate(vk.metas) if m.name == "halt")
        if n_halt != 1:
            raise GlSchemeError("shard must halt exactly once")

    # activity gating (zkvm/scheme.derive_shard_layout rules)
    for ci, meta in enumerate(vk.metas):
        k = proof.num_instances[ci]
        if meta.is_table:
            active = (
                (meta.gate == "always")
                or (meta.gate == "first" and is_first)
                or (meta.gate == "last" and is_last)
            )
            if active and k != meta.table_rows:
                raise GlSchemeError(f"{meta.name}: table must be active")
            if not active and k != 0:
                raise GlSchemeError(f"{meta.name}: table must be inactive")
        elif meta.kind.startswith("dyn_ram"):
            active = (meta.gate == "first" and is_first) or (
                meta.gate == "last" and is_last
            )
            slot = (PV_HEAP_WORDS if "heap" in meta.name
                    else PV_INFO_WORDS if "info" in meta.name
                    else PV_STACK_WORDS)
            expect = int(pv[slot]) if active else 0
            if k != expect:
                raise GlSchemeError(
                    f"{meta.name}: count {k} != public RAM length {expect}")
        elif meta.kind.startswith(("shard_ram", "ec_tree")):
            if standalone and k != 0:
                raise GlSchemeError(
                    f"{meta.name}: standalone cannot carry tokens")
            if meta.kind.startswith("ec_tree") and k == 0:
                base = (PV_RW_SUM_IN if meta.kind.endswith("_in")
                        else PV_RW_SUM_OUT)
                if pv[base : base + 14].any():
                    raise GlSchemeError(
                        f"{meta.name}: empty tree but nonzero rw sum")

    t = GlTranscript(LABEL_GL)
    t.append(vk.digest_elems())
    t.append(pv)
    active = [ci for ci, k in enumerate(proof.num_instances) if k > 0]
    if set(proof.pieces) != set(active):
        raise GlSchemeError("chip piece set mismatch")
    for ci in active:
        t.append(np.asarray(proof.pieces[ci].root, np.uint64))
        t.append([proof.num_instances[ci] % gl.P])
    challenges = np.stack([t.sample_ext(), t.sample_ext()])

    prod_r = g2.one()
    prod_w = g2.one()
    lg_num = np.zeros(2, np.uint64)
    lg_den = g2.one()
    one = g2.one()
    for ci in active:
        meta = vk.metas[ci]
        compiled = meta.compiled
        piece = proof.pieces[ci]
        k = proof.num_instances[ci]
        n = _chip_height_gl(meta, k)
        n_vars = n.bit_length() - 1
        rt, prod_claims, logup_claims, prod_values, logup_fracs = \
            glz.verify_towers_gl(piece.tower, n_vars, t)
        # chip-side lookup p claims are the selector prefix
        n_lk = len(compiled.lk_exprs)
        sel_v = glz._sel_prefix_eval(rt, k)
        for i in range(n_lk):
            if not np.array_equal(logup_claims[i][0], sel_v):
                raise GlSchemeError(f"{meta.name}: lk {i} p != sel prefix")
        # global bus accumulation
        n_r = len(compiled.r_exprs)
        n_w = len(compiled.w_exprs)
        for i in range(n_r):
            prod_r = g2.mul(prod_r, prod_values[i])
        for i in range(n_w):
            prod_w = g2.mul(prod_w, prod_values[n_r + i])
        for i in range(len(logup_fracs)):
            p_, q_ = logup_fracs[i]
            lg_num = g2.add(g2.mul(lg_num, q_), g2.mul(p_, lg_den))
            lg_den = g2.mul(lg_den, q_)

        alphas = t.sample_ext_pows(len(compiled.slots))
        targets = glz._slot_targets(compiled, prod_claims, logup_claims)
        batched = np.zeros(2, np.uint64)
        for si in range(len(compiled.slots)):
            batched = g2.add(batched, g2.mul(alphas[si], targets[si]))
        deg = max((len(tm.cols) + 1
                   for s in compiled.slots for tm in s.terms), default=1)
        try:
            point, final_claim = gsc.verify(batched, piece.main_msgs,
                                            n_vars, t, deg=deg)
        except Exception as e:
            raise GlSchemeError(f"{meta.name}: main sumcheck: {e}") from e
        wit_evals = np.asarray(piece.wit_evals, np.uint64)
        fixed_evals = np.asarray(piece.fixed_evals, np.uint64)
        structural_evals = np.asarray(piece.structural_evals, np.uint64)
        nf_expect = vk.fixed_cols.get(ci)
        nf = 0 if nf_expect is None else nf_expect.shape[0]
        if wit_evals.shape != (compiled.n_wit, 2) \
                or fixed_evals.shape != (nf, 2) \
                or structural_evals.shape != (len(compiled.structural), 2):
            raise GlSchemeError(f"{meta.name}: bad eval shapes")
        evals = np.concatenate([wit_evals, fixed_evals, structural_evals]) \
            if compiled.n_wit + nf + len(compiled.structural) else \
            np.zeros((0, 2), np.uint64)
        t.append(evals.ravel())
        # fixed / structural evals against KEY material
        if nf:
            for j in range(nf):
                col = np.zeros(n, np.uint64)
                raw = nf_expect[j]
                col[:raw.shape[0]] = raw
                if not np.array_equal(_mle_eval_gl(col, point),
                                      fixed_evals[j]):
                    raise GlSchemeError(f"{meta.name}: fixed eval {j}")
        for j, spec in enumerate(compiled.structural):
            if not np.array_equal(structural_eval_gl(spec, point, pv),
                                  structural_evals[j]):
                raise GlSchemeError(f"{meta.name}: structural eval {j}")
        # main recombination
        s_eq = glz._sel_eq_eval(rt, point, k)
        acc = np.zeros(2, np.uint64)
        for si, slot in enumerate(compiled.slots):
            slot_val = np.zeros(2, np.uint64)
            for tm in slot.terms:
                val = glz._eval_scalar_gl(tm.scalar, challenges, pv)
                for c in tm.cols:
                    val = g2.mul(val, evals[glz._col_index(
                        c, compiled.n_wit, nf)])
                slot_val = g2.add(slot_val, val)
            acc = g2.add(acc, g2.mul(alphas[si], slot_val))
        if not np.array_equal(g2.mul(s_eq, acc), final_claim):
            raise GlSchemeError(f"{meta.name}: main recombination mismatch")
        gpcs.verify_batch(piece.root, n_vars, compiled.n_wit, point,
                          wit_evals, piece.opening, t, params)

        if meta.kind.startswith("ec_tree"):
            base = (PV_RW_SUM_IN if meta.kind.endswith("_in")
                    else PV_RW_SUM_OUT)
            fsum = np.stack([pv[base : base + 5], pv[base + 7 : base + 12]])
            ecp = piece.ec_proof
            if ecp is None:
                raise GlSchemeError(f"{meta.name}: missing ec proof")
            if ecp.num_instances != k or ecp.n_vars != n_vars - 1:
                raise GlSchemeError(f"{meta.name}: ec proof geometry")
            try:
                rt, col_evals = glq.verify_ec_sum(ecp, fsum, t)
            except glq.GlEccError as e:
                raise GlSchemeError(f"{meta.name}: ec quark: {e}") from e
            pts = glq.extended_points(rt)
            if (piece.ec_extra is None
                    or set(piece.ec_extra) != {"even", "odd", "half"}):
                raise GlSchemeError(f"{meta.name}: bad ec opening set")
            for pname, claims in glq.EC_POINTS:
                evs, op = piece.ec_extra[pname]
                evs = np.asarray(evs, np.uint64)
                if evs.shape != (compiled.n_wit, 2):
                    raise GlSchemeError(f"{meta.name}: bad ec eval shape")
                t.append(evs.ravel())
                gpcs.verify_batch(piece.root, n_vars, compiled.n_wit,
                                  pts[pname], evs, op, t, params)
                for ev_off, col_base in claims:
                    for c in range(5):
                        if not np.array_equal(col_evals[ev_off + c],
                                              evs[col_base + c]):
                            raise GlSchemeError(
                                f"{meta.name}: ec col binding ({pname})")

    if not np.array_equal(prod_r, prod_w):
        raise GlSchemeError("global read/write product mismatch")
    if lg_num.any():
        raise GlSchemeError("global logup sum is nonzero")
    if not lg_den.any():
        raise GlSchemeError("logup denominator vanished")
    return True
