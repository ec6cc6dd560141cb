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
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import DEFAULT_DEVICE
from .fields import babybear as bb
from .gkr.chip import ChipOpening, ClassMainProof
from .gkr.tower import TowerProof
from .pcs.basefold import BasefoldParams, Committed, OpeningProof, QueryProof
from .pcs.jagged import JaggedClaim, JaggedLayout, JaggedOpening, SliceRef
from .pcs.merkle import MerkleTree
from .zkvm.chips.opcodes import TraceView


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
