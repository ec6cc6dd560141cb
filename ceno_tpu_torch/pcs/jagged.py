"""Jagged PCS: one commitment for all height classes (Jagged<Basefold> role).

Counterpart of ``ceno_tpu/pcs/jagged.py`` (the role mirror of the reference's
default PcsKind::Jagged, e2e.rs:103-129), with its device opening path and
the ``pcs_kind="basefold"`` inner opening only:

  * STACK: every chip column (height h) becomes a SLICE of a matrix with
    uniform height N_r = the largest class height. A matrix column packs
    N_r/h consecutive slices of class h (classes never mix inside one
    matrix column), so slice s of class h living at block u of matrix
    column c satisfies  V_c(x_lo, x_hi) |_{x_hi = bits(u)} = f_s(x_lo).
    ONE Basefold commitment covers the whole shard (one NTT shape, one
    Merkle tree — the TPU-friendly shape).
  * TRANSLATE: each claim f_s(z) = y (z of dim log h, from the class-batched
    main zerocheck or an EC extra point) is gathered into one degree-2
    sumcheck over the row variables:
        sum_x  sum_c V_c(x) * w_c(x)  =  sum_t gamma_t * y_t
    where w_c = sum_{claims t on column c} gamma_t * block_{u_t}(eq(z_t)).
    For FULL-HEIGHT slices (h = N_r) the weight is gamma_t * eq(z_t) with a
    SHARED eq column per distinct point — no materialization; partial
    classes materialize w_c but their total area is small by construction
    (the max class dominates the stacking).
  * OPEN: the sumcheck's final point r binds every matrix column's eval
    V_c(r) (the sumcheck returns them as final base evals); the verifier
    recomputes each w_c(r) ANALYTICALLY as
        sum_t gamma_t * eq(z_t, r[:log h]) * eq(bits(u_t), r[log h:])
    checks the recombination, and a SINGLE-POINT Basefold batch opening at
    r binds the V_c(r) to the commitment.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..mle import ops
from ..sumcheck import prover as sc_prover
from ..sumcheck import verifier as sc_verifier
from ..sumcheck.prover import TermSpec
from ..utils import spans
from . import basefold
from .basefold import BasefoldParams, Claim


@dataclass
class SliceRef:
    """Where one chip column lives in the stacked matrix."""

    mat_col: int
    sub_idx: int
    log_h: int


@dataclass
class JaggedLayout:
    n_r: int                  # uniform matrix height (pow2)
    n_mat_cols: int
    slices: list              # [SliceRef] in canonical slice order
    class_base: dict          # h -> first matrix column of the class


def plan_layout(class_cols: list) -> JaggedLayout:
    """class_cols: [(h, n_cols)] ascending h. Packs each class into its own
    matrix columns, N_r/h slices per column."""
    n_r = max(h for h, _ in class_cols)
    slices = []
    base = 0
    class_base = {}
    for h, n_cols in class_cols:
        per = n_r // h
        class_base[h] = base
        for j in range(n_cols):
            slices.append(SliceRef(base + j // per, j % per, h.bit_length() - 1))
        base += (n_cols + per - 1) // per
    return JaggedLayout(n_r, base, slices, class_base)


def stack_matrix(layout: JaggedLayout, class_arrays: list) -> np.ndarray:
    """class_arrays: [(h, (C_h, h) canonical uint64)] ascending h ->
    (n_mat_cols, n_r) canonical uint64."""
    out = np.zeros((layout.n_mat_cols, layout.n_r), np.uint64)
    base = 0
    for h, arr in class_arrays:
        per = layout.n_r // h
        c_h = arr.shape[0]
        n_cols = (c_h + per - 1) // per
        pad = n_cols * per - c_h
        if pad:
            arr = np.concatenate([arr, np.zeros((pad, h), np.uint64)])
        out[base : base + n_cols] = arr.reshape(n_cols, layout.n_r)
        base += n_cols
    return out


@dataclass
class JaggedClaim:
    slice_idx: int
    z: np.ndarray        # (log_h, 4) canonical point
    value: np.ndarray    # (4,) canonical


@dataclass
class JaggedOpening:
    trans_msgs: np.ndarray   # translation sumcheck round messages
    v_evals: np.ndarray      # (n_mat_cols, 4) canonical V_c(r)
    opening: basefold.OpeningProof


def _point_key(z: np.ndarray) -> bytes:
    return np.ascontiguousarray(z, np.uint64).tobytes()


def _require_basefold(params: BasefoldParams) -> None:
    if params.pcs_kind != "basefold":
        raise NotImplementedError(
            f"pcs_kind={params.pcs_kind!r}: the port opens with Basefold only"
        )


def _weight_block(g, eq):
    """Outer-product weight block: g (4, C, per) Montgomery gamma grid,
    eq (4, h) -> one (4, C, per*h) tensor (a block of C ext columns)."""
    g2 = g.reshape(4, -1)                                  # (4, C*per)
    w = ext4.mul(g2[:, :, None], eq[:, None, :])           # (4, C*per, h)
    return w.reshape(4, g.shape[1], -1)


def _translation_columns(committed, layout: JaggedLayout, claims: list, gammas):
    """The translation sumcheck's base columns, ext columns and terms:
    shared eq columns for full-height points, grouped weight blocks for the
    partial classes."""
    dev = committed.cols.device
    n_r = layout.n_r
    eq_cols: dict = {}     # point key -> ext col index
    ext_cols: list = []
    groups: dict = {}      # (point key, log_h) -> {"z", "slots"}
    terms: list = []
    for t, cl in enumerate(claims):
        ref = layout.slices[cl.slice_idx]
        h = 1 << ref.log_h
        if h == n_r:
            key = _point_key(cl.z)
            if key not in eq_cols:
                eq_cols[key] = len(ext_cols)
                ext_cols.append(ops.build_eq(bb.to_device(np.asarray(cl.z, np.uint64), dev)))
            terms.append(TermSpec(gammas[t], bidx=(ref.mat_col,),
                                  eidx=(eq_cols[key],)))
        else:
            grp = groups.setdefault((_point_key(cl.z), ref.log_h), {})
            grp.setdefault("z", np.asarray(cl.z, np.uint64))
            grp.setdefault("slots", {}).setdefault(
                (ref.mat_col, ref.sub_idx), []
            ).append(t)

    # The claims of one (class, point) group carry CONSECUTIVE powers gamma^t
    # in slice order (sub is the fastest index), so a matrix column whose `per`
    # slices are all claimed with ts t0_c, t0_c+1, ..., t0_c+per-1 needs no
    # private weight column:
    #   w_c = gamma^{t0_c} * W_cls,   W_cls[sub*h + i] = gamma^sub * eq_z[i]
    # one shared (4, n_r) column per group plus a per-term scalar. Irregular
    # leftovers get a per-column outer-product block.
    ext_width = len(ext_cols)  # every item so far has width 1
    for (pkey, log_h), grp in sorted(groups.items(),
                                     key=lambda kv: (kv[0][1], kv[0][0])):
        h = 1 << log_h
        per = n_r // h
        slots = grp["slots"]
        eq_dev = ops.build_eq(bb.to_device(grp["z"], dev))
        cols = sorted({c for c, _ in slots})
        regular, leftover = [], {}
        for c in cols:
            ts = [slots.get((c, sub)) for sub in range(per)]
            if (ts[0] is not None and len(ts[0]) == 1
                    and all(tv is not None and len(tv) == 1
                            and tv[0] == ts[0][0] + sub
                            for sub, tv in enumerate(ts))):
                regular.append((c, ts[0][0]))
            else:
                for sub in range(per):
                    if ts[sub] is not None:
                        leftover.setdefault((c, sub), []).extend(ts[sub])
        if regular:
            g_cls = np.zeros((1, per, 4), np.uint64)
            g_cls[0, :] = gammas[:per]  # regular run implies per <= len
            ext_cols.append(_weight_block(
                bb.to_device(np.ascontiguousarray(g_cls.transpose(2, 0, 1)), dev), eq_dev))
            for c, t0_c in regular:
                terms.append(TermSpec(gammas[t0_c], bidx=(c,),
                                      eidx=(ext_width,)))
            ext_width += 1
        if leftover:
            lcols = sorted({c for c, _ in leftover})
            g = np.zeros((len(lcols), per, 4), np.uint64)
            cpos = {c: i for i, c in enumerate(lcols)}
            for (c, sub), tvs in leftover.items():
                for tv in tvs:
                    g[cpos[c], sub] = exth.add(g[cpos[c], sub], gammas[tv])
            ext_cols.append(_weight_block(
                bb.to_device(np.ascontiguousarray(g.transpose(2, 0, 1)), dev), eq_dev))
            for i, c in enumerate(lcols):
                terms.append(TermSpec(exth.one(), bidx=(c,),
                                      eidx=(ext_width + i,)))
            ext_width += len(lcols)
    base_cols = [committed.cols[c] for c in range(layout.n_mat_cols)]
    return base_cols, ext_cols, terms


def open_jagged(committed, layout: JaggedLayout, claims: list,
                transcript, params: BasefoldParams) -> JaggedOpening:
    _require_basefold(params)
    log_r = layout.n_r.bit_length() - 1
    gammas = transcript.sample_ext_pows(len(claims))
    with spans.span("trans-weights"):
        base_cols, ext_cols, terms = _translation_columns(
            committed, layout, claims, gammas)
    with spans.span("trans-sumcheck"):
        out = sc_prover.prove(base_cols, ext_cols, terms, log_r, transcript)
    transcript.append(out.final_base.ravel())
    v_evals = out.final_base
    pcs_claims = [Claim(0, c, v_evals[c]) for c in range(layout.n_mat_cols)]
    with spans.span("basefold-open"):
        opening = basefold.open_batch(
            committed, np.stack([out.point]), pcs_claims, transcript, params
        )
    return JaggedOpening(out.proof.round_msgs, v_evals, opening)


class JaggedError(Exception):
    pass


def verify_jagged(root, layout: JaggedLayout, claims: list,
                  proof: JaggedOpening, transcript,
                  params: BasefoldParams) -> None:
    n_r, log_r = layout.n_r, layout.n_r.bit_length() - 1
    gammas = transcript.sample_ext_pows(len(claims))
    total = np.zeros(4, np.uint64)
    for t, cl in enumerate(claims):
        total = exth.add(total, exth.mul(gammas[t], np.asarray(cl.value, np.uint64)))
    point, final_claim = sc_verifier.verify(
        total, proof.trans_msgs, log_r, transcript, deg=2
    )
    v_evals = np.asarray(proof.v_evals, np.uint64)
    if v_evals.shape != (layout.n_mat_cols, 4):
        raise JaggedError("bad V eval shape")
    transcript.append(v_evals.ravel())

    # w_c(r) analytically per claim
    acc = np.zeros(4, np.uint64)
    eq_cache: dict = {}
    for t, cl in enumerate(claims):
        ref = layout.slices[cl.slice_idx]
        h = 1 << ref.log_h
        key = (_point_key(cl.z), ref.sub_idx, ref.log_h)
        w_r = eq_cache.get(key)
        if w_r is None:
            z = np.asarray(cl.z, np.uint64)
            w_r = exth.eq_eval(z, point[: ref.log_h])
            one = exth.one()
            for b in range(ref.log_h, log_r):
                bit = (ref.sub_idx >> (b - ref.log_h)) & 1
                pj = point[b].astype(np.uint64)
                w_r = exth.mul(w_r, pj if bit else exth.sub(one, pj))
            eq_cache[key] = w_r
        contrib = exth.mul(gammas[t], exth.mul(w_r, v_evals[ref.mat_col]))
        acc = exth.add(acc, contrib)
    if not np.array_equal(acc, final_claim):
        from ..utils import replay

        if not replay.structure_only():
            raise JaggedError("jagged translation recombination mismatch")

    _require_basefold(params)
    pcs_claims = [Claim(0, c, v_evals[c]) for c in range(layout.n_mat_cols)]
    basefold.verify_batch(
        root, log_r, layout.n_mat_cols, np.stack([point]), pcs_claims,
        proof.opening, transcript, params,
    )
