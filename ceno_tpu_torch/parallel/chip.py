"""Row-sharded FULL chip proving: records -> towers -> main zerocheck.

Counterpart of ``ceno_tpu/parallel/chip.py``: the per-chip prove pipeline of
``gkr/chip.prove_chip`` with the rows of every MLE sharded over the ranks of
a process group (``parallel/sharded.py``'s layout: row i on rank i mod D, at
local index i // D):

  * records: each rank evaluates the chip's record expressions over its slab
    with the single-device ``gkr/chip.build_records_from_sel``, its prefix
    selector from global row indices (``j*D + rank < num_instances``). The
    records stack record-major on top of the row bits, so the local
    concatenation is the rank's slab of the global record MLE;
  * tower layers are built locally with ``gkr/tower.product_layers`` and
    ``logup_layers``: the global halves of a row-sharded layer are its local
    halves, so a layer stays on its rank down to 2D rows; that layer is
    gathered and the smaller ones are built from it on every rank;
  * a level's sumcheck runs through ``sharded.prove_banks`` while its half
    has at least 2D rows, below that through the single-device
    ``sumcheck/prover.prove``; the record claims are the record MLEs
    evaluated at the final point (:func:`_eval_layer_at`, one all-reduce);
  * the main zerocheck runs through ``sharded.prove_banks`` over the
    witness, fixed and structural columns and the masked sel_eq.

Every rank returns the same (ChipProof, ChipOpening), byte-equal to
``gkr/chip.prove_chip``'s. The records and layers are plain torch on each
rank's slab, as on the single device; the round messages are K6a on the
slab, summed across ranks, and the folds K6b.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import babybear as bb
from ..fields import ext4
from ..gkr import chip as chiplib
from ..gkr import tower as towerlib
from ..gkr.chip import ChipOpening, ChipProof
from ..mle import ops
from ..sumcheck import prover as sc_prover
from ..sumcheck import terms as T
from ..sumcheck.prover import TermSpec
from . import sharded
from .sharded import Mesh


def _sharded_records(mesh: Mesh, compiled, wit, fixed, structural, inst, chals,
                     num_instances: int):
    """(Mr, Mw, P, Q) of the rank's slab (each None when absent), with the
    prefix selector over global rows."""
    nloc = wit.shape[1] if compiled.n_wit else structural.shape[1]
    gidx = torch.arange(nloc, device=mesh.device) * mesh.size + mesh.rank
    sel = torch.where(gidx < num_instances,
                      torch.tensor(bb.MONTY_ONE, dtype=bb.DTYPE, device=mesh.device),
                      torch.tensor(0, dtype=bb.DTYPE, device=mesh.device))
    return chiplib.build_records_from_sel(compiled, wit, fixed, structural, inst, chals, sel)


def _product_tree(mesh: Mesh, v) -> list:
    """Every layer of a product tree, layer 1 first: the small ones (2 .. 2D
    global rows) built on every rank from the gathered 2D-row layer, then
    the rank's slabs of the larger ones."""
    local = towerlib.product_layers(v)
    return list(towerlib.product_layers(sharded.gather_rows(mesh, local[0]))) + list(local[1:])


def _logup_tree(mesh: Mesh, p, q) -> tuple:
    """:func:`_product_tree` for a LogUp fraction tree: (p layers, q layers)."""
    pl, ql = towerlib.logup_layers(p, q)
    full_p, full_q = towerlib.logup_layers(sharded.gather_rows(mesh, pl[0]),
                                           sharded.gather_rows(mesh, ql[0]))
    return list(full_p) + list(pl[1:]), list(full_q) + list(ql[1:])


def _eval_layer_at(mesh: Mesh, layer, point: np.ndarray) -> np.ndarray:
    """MLE eval of a row-sharded (4, m/D) layer at the (log m, 4) point:
    canonical (4,) on every rank."""
    local = bb.sum_mod(ext4.mul(sharded.eq_slab(mesh, point), layer), -1)
    return bb.to_host(sharded.all_reduce_mod(mesh, local))


def prove_towers_sharded(mesh: Mesh, prod_records: list, logup_records: list, transcript):
    """Row-sharded ``gkr/tower.prove_towers``: the same transcript and proof
    from each rank's slabs of the records ((4, N/D) Montgomery; LogUp as
    (p, q) pairs). Returns (TowerProof, final point (n, 4) canonical,
    (prod_claims (S_p, 4), logup_claims (S_l, 2, 4)))."""
    first = prod_records[0] if prod_records else logup_records[0][0]
    n_vars = (first.shape[-1] * mesh.size).bit_length() - 1
    dev = mesh.device
    prod_lys = [_product_tree(mesh, v) for v in prod_records]
    logup_lys = [_logup_tree(mesh, p, q) for p, q in logup_records]
    n_prod, n_logup = len(prod_lys), len(logup_lys)

    def canon2(x):  # (4, 2) -> (2, 4) canonical
        return bb.to_host(x).T

    proof = towerlib.TowerProof(
        np.stack([canon2(ls[0]) for ls in prod_lys])
        if prod_lys else np.zeros((0, 2, 4), np.uint64),
        np.stack([np.stack([canon2(pl[0]), canon2(ql[0])]) for pl, ql in logup_lys])
        if logup_lys else np.zeros((0, 2, 2, 4), np.uint64),
    )
    for s in range(n_prod):
        transcript.append(proof.prod_out[s].ravel())
    for s in range(n_logup):
        transcript.append(proof.logup_out[s].ravel())

    rt = np.array([transcript.sample_ext()], np.uint64)
    for level in range(1, n_vars):
        alphas = transcript.sample_ext_pows(n_prod + 2 * n_logup)
        half = 1 << level
        layers = [ls[level] for ls in prod_lys] + [
            lys[i][level] for lys in logup_lys for i in (0, 1)]
        term_list = [TermSpec(alphas[a], eidx=e)
                     for a, e in zip(*towerlib._level_terms(n_prod, n_logup))]
        if half >= 2 * mesh.size:
            base_bank, ext_bank = T.make_banks(
                [], [sharded.eq_slab(mesh, rt), towerlib.split_specs(layers)],
                half // mesh.size, dev)
            out = sharded.prove_banks(mesh, base_bank, ext_bank, term_list, level, transcript)
        else:
            ext_cols = [ops.build_eq(bb.to_device(rt, dev)), towerlib.split_specs(layers)]
            out = sc_prover.prove([], ext_cols, term_list, level, transcript)
        proof.round_msgs.append(out.proof.round_msgs)
        evals = out.final_ext[1:]  # drop eq
        proof.level_evals.append(evals.copy())
        transcript.append(evals.ravel())
        mu = np.array(transcript.sample_ext(), np.uint64)
        rt = np.concatenate([out.point, mu[None, :]], axis=0)

    prod_claims = [_eval_layer_at(mesh, v, rt) for v in prod_records]
    logup_claims = [[_eval_layer_at(mesh, p, rt), _eval_layer_at(mesh, q, rt)]
                    for p, q in logup_records]
    return proof, rt, towerlib._stack_claims(prod_claims, logup_claims)


def prove_chip_sharded(
    mesh: Mesh,
    compiled,
    wit: np.ndarray,          # (n_wit, N) canonical host
    fixed: np.ndarray,        # (n_fixed, N)
    structural: np.ndarray,   # (n_struct, N)
    instances: np.ndarray,
    num_instances: int,
    challenges: np.ndarray,   # (2, 4) canonical alpha, beta
    transcript,
):
    """Row-sharded ``gkr/chip.prove_chip``: every rank passes the same full
    host columns, keeps its slab on its device, and returns the same
    byte-identical (ChipProof, ChipOpening)."""
    n = wit.shape[1]
    n_vars = n.bit_length() - 1
    cols = np.concatenate([np.asarray(wit, np.uint64), np.asarray(fixed, np.uint64),
                           np.asarray(structural, np.uint64)])
    base_bank = sharded.shard_base_cols(mesh, cols)  # checks N against 2D
    w, f = compiled.n_wit, compiled.n_fixed
    wit_s, fixed_s, structural_s = base_bank[:w], base_bank[w : w + f], base_bank[w + f : -1]
    inst = bb.to_device(np.asarray(instances, np.uint64), mesh.device)
    chals = bb.to_device(np.asarray(challenges, np.uint64), mesh.device)
    mr, mw, pcat, qcat = _sharded_records(mesh, compiled, wit_s, fixed_s, structural_s,
                                          inst, chals, num_instances)
    prods = [m for m in (mr, mw) if m is not None]
    lps = [(pcat, qcat)] if pcat is not None else []
    if not (prods or lps):
        raise ValueError(f"{compiled.name}: chip has no records")
    tower_proof, rt, _claims = prove_towers_sharded(mesh, prods, lps, transcript)

    x_star = rt[:n_vars]
    b_star = rt[n_vars:]
    mults, _meta = chiplib._slot_multipliers(compiled, b_star, transcript)
    # masked eq column sel_eq = eq(x*, .) * [row < num_instances], the rank's rows
    sel_eq = sharded.eq_slab(mesh, x_star)
    gidx = torch.arange(sel_eq.shape[1], device=mesh.device) * mesh.size + mesh.rank
    sel_eq[:, gidx >= num_instances] = 0
    term_list = chiplib._main_terms(compiled, mults, None, 0, 0, instances, challenges)
    ext_bank = torch.cat([sel_eq[:, None, :], ext4.ones((1, sel_eq.shape[1]), mesh.device)],
                         dim=1)
    out = sharded.prove_banks(mesh, base_bank, ext_bank, term_list, n_vars, transcript)
    transcript.append(out.final_base.ravel())

    wit_evals = out.final_base[:w]
    fixed_evals = out.final_base[w : w + f]
    structural_evals = out.final_base[w + f :]
    proof = ChipProof(
        num_instances, n_vars, tower_proof, out.proof.round_msgs,
        wit_evals, fixed_evals, structural_evals,
    )
    return proof, ChipOpening(out.point, wit_evals, fixed_evals)
