"""Carry protocol state between ``ceno_tpu`` and this port as plain data.

The reference's state is handed over as numpy arrays, ints and dicts, so this
module never imports the reference. For the dataclasses (BasefoldParams,
JaggedLayout, JaggedClaim, JaggedOpening) the plain form is what
:func:`dataclasses.asdict` gives, in either package; each ``*_from_*`` here
builds the port's object from it. A commitment carries device tensors, so it
has its own pair (:func:`committed_to_numpy`, :func:`committed_from_numpy`),
and a transcript goes across as its ``export_state()`` tuple, which
:meth:`Transcript.from_state` takes. The GKR slice's objects (TowerProof,
ClassMainProof, ChipOpening, TraceView) go the same way: ``asdict`` in, a
``*_from_dict`` here out. Field values in the plain form are canonical numpy
``uint64``, as the reference keeps them on the host. :func:`digest` hashes a
plain form, so either package's object can be held against a committed
digest.

A whole zkVM proof goes across as its ``proof_to_bytes`` bytes: the format
is the same in both packages, so the port's ``zkvm/serialize.proof_from_bytes``
reads the reference's proof and ``proof_to_bytes`` writes it back byte for
byte. A sharded proof goes across as one such blob per shard
(:func:`sharded_proof_to_bytes`, :func:`sharded_proof_from_bytes`). The
continuations' plan goes as plain data: a shard's token lists
(:func:`tokens_to_dict`) and its context without the planned witness
(:func:`shard_context_to_dict`); an EC-sum proof as ``asdict``. Each
``*_to_*`` here reads attributes only, so it takes either package's
object. The key does not go across: keygen is deterministic, so each side
derives it from (program, config, params), and :func:`key_summary` gives what
two keys are compared by.

An aggregation proof goes across as plain data (:func:`agg_proof_to_dict`,
:func:`agg_proof_from_dict`, a ShardGeometry likewise) or as its
``agg_proof_to_bytes`` bytes, the same format in both packages. Its key is
compared, not carried, as the shard key is: each side rebuilds it with
``expected_agg_key`` from the vk and the proof's geometry, and
:func:`agg_key_summary` gives what two keys are compared by (its chips'
names, compiled digests and fixed columns, the params and ``digest_elems``);
:func:`agg_key_check` holds a port key against such a summary.

The Goldilocks pipeline's objects (gl/: GlCommitted with its GlTree,
GlQuery, GlOpening, GlSumcheckOutput, GlTowerProof, GlChipProof) go across
as plain dicts too (``gl_*_to_dict`` / ``gl_*_from_dict``; a commitment, which
holds device tensors in the port and numpy in the reference, as
``gl_committed_to_numpy`` / ``gl_committed_from_numpy``). The reference has
no Goldilocks serializer, so :func:`gl_chip_proof_digest` is what two chip
proofs are compared by: :func:`digest` of the plain form. The GL scheme's
objects (GlEccQuarkProof, GlChipPiece, GlZKVMProof, GlShardedProof) go the
same way, and :func:`gl_zkvm_proof_digest` compares two shard proofs. The GL
key is compared, not carried: :func:`gl_vk_summary` gives its chips' names
and kinds, a digest of its fixed columns and ``digest_elems``.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from . import DEFAULT_DEVICE
from .fields import babybear as bb
from .gkr.chip import ChipOpening, ClassMainProof, chip_digest
from .gkr.eccquark import EccQuarkProof
from .gkr.tower import TowerProof
from .fields import goldilocks as gld
from .gl.eccquark import GlEccQuarkProof
from .gl.pcs import GlCommitted, GlOpening, GlQuery, GlTree
from .gl.scheme import GlChipPiece, GlZKVMProof
from .gl.shard import GlShardedProof
from .gl.sumcheck import GlSumcheckOutput
from .gl.zkvm import GlChipProof, GlTowerProof
from .pcs.basefold import BasefoldParams, Committed, OpeningProof, QueryProof
from .pcs.jagged import JaggedClaim, JaggedLayout, JaggedOpening, SliceRef
from .pcs.merkle import MerkleTree
from .zkvm import serialize
from .zkvm.aggregate import AggKey, AggProof, ShardGeometry
from .zkvm.chips.opcodes import TraceView
from .zkvm.chips.shard_ram import Tokens
from .zkvm.shard import ShardContext, ShardedProof


def _u64(x) -> np.ndarray:
    return np.asarray(x, np.uint64)


# -- BasefoldParams ----------------------------------------------------------

def params_from_dict(d: dict) -> BasefoldParams:
    return BasefoldParams(**d)


# -- Committed: canonical cols, codeword, leaves, levels ----------------------

def committed_to_numpy(c: Committed) -> dict:
    return {
        "cols": bb.to_host(c.cols),
        "codeword": bb.to_host(c.codeword),
        "leaves": bb.to_host(c.tree.leaves),
        "levels": [bb.to_host(lv) for lv in c.tree.levels],
        "n_vars": int(c.n_vars),
    }


def committed_from_numpy(d: dict, device=None) -> Committed:
    device = device or DEFAULT_DEVICE
    tree = MerkleTree.from_device(
        bb.to_device(_u64(d["leaves"]), device),
        [bb.to_device(_u64(lv), device) for lv in d["levels"]],
    )
    return Committed(
        bb.to_device(_u64(d["cols"]), device),
        bb.to_device(_u64(d["codeword"]), device),
        tree,
        int(d["n_vars"]),
    )


# -- JaggedLayout, JaggedClaim, JaggedOpening ---------------------------------

def layout_from_dict(d: dict) -> JaggedLayout:
    return JaggedLayout(
        int(d["n_r"]), int(d["n_mat_cols"]),
        [SliceRef(**s) for s in d["slices"]],
        {int(h): int(b) for h, b in d["class_base"].items()},
    )


def claims_from_dicts(ds: list) -> list:
    return [JaggedClaim(int(d["slice_idx"]), _u64(d["z"]), _u64(d["value"])) for d in ds]


def opening_from_dict(d: dict) -> JaggedOpening:
    o = d["opening"]
    queries = [
        QueryProof(
            int(q["index"]), _u64(q["base_rows"]), _u64(q["base_paths"]),
            [_u64(r) for r in q["u_rows"]], [_u64(p) for p in q["u_paths"]],
        )
        for q in o["queries"]
    ]
    opening = OpeningProof(
        _u64(o["sumcheck_msgs"]), [_u64(r) for r in o["fold_roots"]],
        _u64(o["tail"]), _u64(o["point_evals"]), queries, int(o["pow_nonce"]),
    )
    return JaggedOpening(_u64(d["trans_msgs"]), _u64(d["v_evals"]), opening)


# -- GKR: TowerProof, ClassMainProof, ChipOpening, TraceView ------------------

def tower_proof_from_dict(d: dict) -> TowerProof:
    return TowerProof(
        _u64(d["prod_out"]), _u64(d["logup_out"]),
        [_u64(m) for m in d["round_msgs"]], [_u64(e) for e in d["level_evals"]],
    )


def class_main_from_dict(d: dict) -> ClassMainProof:
    return ClassMainProof(
        _u64(d["main_msgs"]), [_u64(e) for e in d["wit_evals"]],
        [_u64(e) for e in d["fixed_evals"]], [_u64(e) for e in d["structural_evals"]],
    )


def chip_opening_from_dict(d: dict) -> ChipOpening:
    return ChipOpening(_u64(d["point"]), _u64(d["wit_evals"]), _u64(d["fixed_evals"]))


def trace_view_from_dict(d: dict) -> TraceView:
    return TraceView(**{k: (int(v) if k == "n" else np.asarray(v, np.int64)) for k, v in d.items()})


# -- continuations: EccQuarkProof, Tokens, ShardContext, ShardedProof ---------

def ecc_proof_from_dict(d: dict) -> EccQuarkProof:
    return EccQuarkProof(int(d["num_instances"]), int(d["n_vars"]), _u64(d["round_msgs"]),
                         _u64(d["col_evals"]), _u64(d["final_sum"]))


_TOKEN_FIELDS = ("is_reg", "addr", "value", "shard", "clk")


def tokens_to_dict(tok) -> dict:
    return {k: _u64(getattr(tok, k)) for k in _TOKEN_FIELDS}


def tokens_from_dict(d: dict) -> Tokens:
    return Tokens(*(_u64(d[k]) for k in _TOKEN_FIELDS))


def shard_context_to_dict(ctx) -> dict:
    """A shard's plan: its place, its steps, its token lists and public
    values; the planned opcode witness (``opcode_assigned``) stays behind."""
    return {"shard_id": int(ctx.shard_id), "n_shards": int(ctx.n_shards),
            "step_lo": int(ctx.step_lo), "step_hi": int(ctx.step_hi),
            "in_tokens": tokens_to_dict(ctx.in_tokens),
            "out_tokens": tokens_to_dict(ctx.out_tokens), "pv": _u64(ctx.pv)}


def shard_context_from_dict(d: dict, opcode_assigned=None) -> ShardContext:
    """The port's ShardContext from a plan; ``opcode_assigned`` (the port's
    ``witgen.assign_opcode_chips`` over the shard's steps) may be given."""
    return ShardContext(int(d["shard_id"]), int(d["n_shards"]), int(d["step_lo"]),
                        int(d["step_hi"]), tokens_from_dict(d["in_tokens"]),
                        tokens_from_dict(d["out_tokens"]), _u64(d["pv"]), opcode_assigned)


def sharded_proof_to_bytes(sproof, cfg, params) -> list:
    """Each shard's ``proof_to_bytes``, in shard order."""
    return [serialize.proof_to_bytes(p, p.public_values, cfg, params) for p in sproof.proofs]


def sharded_proof_from_bytes(blobs: list) -> ShardedProof:
    return ShardedProof([serialize.proof_from_bytes(b)[0] for b in blobs])


def digest(plain) -> str:
    """SHA-256 (hex) of a plain form: dicts by sorted key, lists in order,
    every number or array as its shape and canonical ``uint64`` bytes."""
    h = hashlib.sha256()

    def walk(x):
        if isinstance(x, dict):
            h.update(b"{%d" % len(x))
            for k in sorted(x):
                h.update(repr(k).encode())
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[%d" % len(x))
            for v in x:
                walk(v)
        else:
            a = np.ascontiguousarray(x, dtype=np.uint64)
            h.update(repr(a.shape).encode())
            h.update(a.astype("<u8").tobytes())

    walk(plain)
    return h.hexdigest()


# -- the key: compared, not carried --------------------------------------------

def key_summary(vk) -> dict:
    """What two verifying keys are compared by: ``digest_elems()`` and, per
    chip in registry order, its name and ``chip_digest``."""
    return {"digest_elems": np.asarray(vk.digest_elems(), np.uint64),
            "chips": [(m.name, chip_digest(m.compiled)) for m in vk.metas]}


# -- aggregation: AggProof and ShardGeometry carried, AggKey compared ----------

def shard_geometry_to_dict(g) -> dict:
    return {"num_instances": [int(k) for k in g.num_instances], "is_first": bool(g.is_first),
            "is_last": bool(g.is_last), "standalone": bool(g.standalone)}


def shard_geometry_from_dict(d: dict) -> ShardGeometry:
    return ShardGeometry([int(k) for k in d["num_instances"]], bool(d["is_first"]),
                         bool(d["is_last"]), bool(d["standalone"]))


def _geometry_to_plain(geo):
    if geo is None:
        return None
    if isinstance(geo, (tuple, list)) and len(geo) == 2 and geo[0] == "chipset":
        return ["chipset", [[int(k) for k in ninst] for ninst in geo[1]]]
    return [shard_geometry_to_dict(g) for g in geo]


def _geometry_from_plain(geo):
    if geo is None:
        return None
    if len(geo) == 2 and geo[0] == "chipset":
        return ("chipset", [[int(k) for k in ninst] for ninst in geo[1]])
    return [shard_geometry_from_dict(g) for g in geo]


def agg_proof_to_dict(aproof) -> dict:
    """An aggregation proof as plain data (either package's; attributes
    only). Its tower groups and class mains keep their keys, and a level-2
    proof's geometry goes as ``["chipset", [num_instances, ...]]``."""
    return {
        "public_values": _u64(aproof.public_values),
        "num_instances": [int(k) for k in aproof.num_instances],
        "witness_root": _u64(aproof.witness_root),
        "tower_groups": {int(n): dataclasses.asdict(p) for n, p in aproof.tower_groups.items()},
        "class_main": {int(h): dataclasses.asdict(p) for h, p in aproof.class_main.items()},
        "witness_opening": dataclasses.asdict(aproof.witness_opening),
        "geometry": _geometry_to_plain(aproof.geometry),
    }


def agg_proof_from_dict(d: dict) -> AggProof:
    return AggProof(
        _u64(d["public_values"]), [int(k) for k in d["num_instances"]], _u64(d["witness_root"]),
        {int(n): tower_proof_from_dict(p) for n, p in d["tower_groups"].items()},
        {int(h): class_main_from_dict(p) for h, p in d["class_main"].items()},
        opening_from_dict(d["witness_opening"]), _geometry_from_plain(d["geometry"]),
    )


def agg_key_summary(key) -> dict:
    """What two aggregation keys (either package's) are compared by: per
    chip in set order its name, ``chip_digest`` and fixed columns (None
    where it has none), the params, and ``digest_elems()``."""
    return {"names": [name for name, _, _, _ in key.chips],
            "chip_digests": [chip_digest(compiled) for _, compiled, _, _ in key.chips],
            "fixed": [None if f is None else _u64(f) for _, _, _, f in key.chips],
            "params": dataclasses.asdict(key.params),
            "digest_elems": _u64(key.digest_elems())}


def agg_key_check(key: AggKey, summary: dict) -> None:
    """Raise ValueError unless the port's ``key`` has ``summary``'s chips,
    fixed columns, params and ``digest_elems`` (:func:`agg_key_summary`)."""
    mine = agg_key_summary(key)
    for what in ("names", "chip_digests", "params"):
        if mine[what] != summary[what]:
            raise ValueError(f"aggregation key: {what} differ")
    for name, a, b in zip(mine["names"], mine["fixed"], summary["fixed"]):
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, _u64(b))):
            raise ValueError(f"aggregation key: fixed columns of {name} differ")
    if not np.array_equal(mine["digest_elems"], _u64(summary["digest_elems"])):
        raise ValueError("aggregation key: digest_elems differ")


# -- Goldilocks (gl/) ------------------------------------------------------------

def _gl_host(x) -> np.ndarray:
    """A port tensor or a reference array -> a new canonical numpy uint64
    array (a copy, so a tampered copy of a proof leaves the proof as it was)."""
    return gld.to_host(x) if isinstance(x, torch.Tensor) else np.array(x, np.uint64)


def gl_committed_to_numpy(c) -> dict:
    return {"cols": _gl_host(c.cols), "codeword": _gl_host(c.codeword),
            "levels": [_gl_host(lv) for lv in c.tree.levels], "n_vars": int(c.n_vars)}


def gl_committed_from_numpy(d: dict, device=None) -> GlCommitted:
    device = device or DEFAULT_DEVICE
    return GlCommitted(gld.to_device(np.asarray(d["cols"]), device),
                       gld.to_device(np.asarray(d["codeword"]), device),
                       GlTree([gld.to_device(np.asarray(lv), device) for lv in d["levels"]]),
                       int(d["n_vars"]))


def gl_query_to_dict(q) -> dict:
    return {"index": int(q.index), "base_col_vals": _gl_host(q.base_col_vals),
            "base_paths": _gl_host(q.base_paths),
            "level_vals": [_gl_host(v) for v in q.level_vals],
            "level_paths": [_gl_host(v) for v in q.level_paths]}


def gl_query_from_dict(d: dict) -> GlQuery:
    return GlQuery(int(d["index"]), _gl_host(d["base_col_vals"]), _gl_host(d["base_paths"]),
                   [_gl_host(v) for v in d["level_vals"]],
                   [_gl_host(v) for v in d["level_paths"]])


def gl_opening_to_dict(o) -> dict:
    return {"round_msgs": _gl_host(o.round_msgs),
            "fold_roots": [_gl_host(r) for r in o.fold_roots],
            "tail": _gl_host(o.tail), "queries": [gl_query_to_dict(q) for q in o.queries],
            "pow_nonce": int(o.pow_nonce)}


def gl_opening_from_dict(d: dict) -> GlOpening:
    return GlOpening(_gl_host(d["round_msgs"]), [_gl_host(r) for r in d["fold_roots"]],
                     _gl_host(d["tail"]), [gl_query_from_dict(q) for q in d["queries"]],
                     int(d["pow_nonce"]))


def gl_sumcheck_output_to_dict(o) -> dict:
    return {k: _gl_host(getattr(o, k)) for k in ("round_msgs", "point", "final_base", "final_ext")}


def gl_sumcheck_output_from_dict(d: dict) -> GlSumcheckOutput:
    return GlSumcheckOutput(*(_gl_host(d[k]) for k in ("round_msgs", "point", "final_base",
                                                    "final_ext")))


def gl_tower_proof_to_dict(t) -> dict:
    return {"prod_out": _gl_host(t.prod_out), "logup_out": _gl_host(t.logup_out),
            "round_msgs": [_gl_host(m) for m in t.round_msgs],
            "level_evals": [_gl_host(e) for e in t.level_evals]}


def gl_tower_proof_from_dict(d: dict) -> GlTowerProof:
    return GlTowerProof(_gl_host(d["prod_out"]), _gl_host(d["logup_out"]),
                        [_gl_host(m) for m in d["round_msgs"]],
                        [_gl_host(e) for e in d["level_evals"]])


def gl_chip_proof_to_dict(p) -> dict:
    return {"num_instances": int(p.num_instances), "n_vars": int(p.n_vars),
            "root": _gl_host(p.root), "tower": gl_tower_proof_to_dict(p.tower),
            "main_msgs": _gl_host(p.main_msgs), "wit_evals": _gl_host(p.wit_evals),
            "opening": gl_opening_to_dict(p.opening)}


def gl_chip_proof_from_dict(d: dict) -> GlChipProof:
    return GlChipProof(int(d["num_instances"]), int(d["n_vars"]), _gl_host(d["root"]),
                       gl_tower_proof_from_dict(d["tower"]), _gl_host(d["main_msgs"]),
                       _gl_host(d["wit_evals"]), gl_opening_from_dict(d["opening"]))


def gl_chip_proof_digest(p) -> str:
    """The canonical digest of a GlChipProof of either package."""
    return digest(gl_chip_proof_to_dict(p))


def gl_ecc_quark_proof_to_dict(p) -> dict:
    return {"num_instances": int(p.num_instances), "n_vars": int(p.n_vars),
            "round_msgs": _gl_host(p.round_msgs), "col_evals": _gl_host(p.col_evals),
            "final_sum": _gl_host(p.final_sum)}


def gl_ecc_quark_proof_from_dict(d: dict) -> GlEccQuarkProof:
    return GlEccQuarkProof(int(d["num_instances"]), int(d["n_vars"]), _gl_host(d["round_msgs"]),
                           _gl_host(d["col_evals"]), _gl_host(d["final_sum"]))


def gl_chip_piece_to_dict(p) -> dict:
    """The plain form of a GlChipPiece; ``ec_proof`` and ``ec_extra`` (an
    EC-tree chip's quark and its three extended-point openings) appear only
    where the piece has them."""
    d = {"root": _gl_host(p.root), "tower": gl_tower_proof_to_dict(p.tower),
         "main_msgs": _gl_host(p.main_msgs), "wit_evals": _gl_host(p.wit_evals),
         "fixed_evals": _gl_host(p.fixed_evals),
         "structural_evals": _gl_host(p.structural_evals),
         "opening": gl_opening_to_dict(p.opening)}
    if p.ec_proof is not None:
        d["ec_proof"] = gl_ecc_quark_proof_to_dict(p.ec_proof)
    if p.ec_extra is not None:
        d["ec_extra"] = {name: {"evals": _gl_host(evs), "opening": gl_opening_to_dict(op)}
                         for name, (evs, op) in p.ec_extra.items()}
    return d


def gl_chip_piece_from_dict(d: dict) -> GlChipPiece:
    ec_proof = d.get("ec_proof")
    ec_extra = d.get("ec_extra")
    return GlChipPiece(
        _gl_host(d["root"]), gl_tower_proof_from_dict(d["tower"]), _gl_host(d["main_msgs"]),
        _gl_host(d["wit_evals"]), _gl_host(d["fixed_evals"]), _gl_host(d["structural_evals"]),
        gl_opening_from_dict(d["opening"]),
        ec_proof=None if ec_proof is None else gl_ecc_quark_proof_from_dict(ec_proof),
        ec_extra=None if ec_extra is None else {
            name: (_gl_host(e["evals"]), gl_opening_from_dict(e["opening"]))
            for name, e in ec_extra.items()})


def gl_zkvm_proof_to_dict(p) -> dict:
    return {"public_values": _gl_host(p.public_values),
            "num_instances": [int(k) for k in p.num_instances],
            "pieces": {int(ci): gl_chip_piece_to_dict(piece) for ci, piece in p.pieces.items()}}


def gl_zkvm_proof_from_dict(d: dict) -> GlZKVMProof:
    return GlZKVMProof(_gl_host(d["public_values"]), [int(k) for k in d["num_instances"]],
                       {int(ci): gl_chip_piece_from_dict(piece)
                        for ci, piece in d["pieces"].items()})


def gl_zkvm_proof_digest(p) -> str:
    """The canonical digest of a GlZKVMProof of either package."""
    return digest(gl_zkvm_proof_to_dict(p))


def gl_sharded_proof_to_dict(p) -> dict:
    return {"proofs": [gl_zkvm_proof_to_dict(q) for q in p.proofs]}


def gl_sharded_proof_from_dict(d: dict) -> GlShardedProof:
    return GlShardedProof([gl_zkvm_proof_from_dict(q) for q in d["proofs"]])


def gl_vk_summary(vk) -> dict:
    """What two GL verifying keys are compared by, as JSON-ready data: the
    metas' names and kinds in registry order, the digest of the fixed
    columns by chip index, and ``digest_elems()``."""
    return {"metas": [[m.name, m.kind] for m in vk.metas],
            "fixed_cols": digest({int(ci): _gl_host(c) for ci, c in vk.fixed_cols.items()}),
            "digest_elems": [int(v) for v in vk.digest_elems()]}
