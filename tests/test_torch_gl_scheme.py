"""The port's Goldilocks zkVM scheme (gl/scheme.py) against the reference's,
at tests/test_gl_scheme.py's setup: ``fibonacci_vm(8)`` at
``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``, proved as one standalone
shard at the small params of tests/test_gl_continuation.py:154. The same
inputs go through ``ceno_tpu`` and ``ceno_tpu_torch`` (CPU tensors): the GL
key, the standalone GL witness of every chip and the structural tables must
be equal. The reference's own prove takes about 5 minutes and its verify
about 4 on one CPU core, so the port's CPU ``prove_gl`` is held against the
reference's digest in ceno_tpu_torch/golden/gl_scheme.json (written by
tools/torch_gl_scheme_golden.py); the port's ``verify_gl`` must accept it and
reject tests/test_gl_scheme.py's two tampers and a changed opened row, and
the interop converters must carry both packages' objects unchanged.

The one proof is ``chip_smoke.run_gl_scheme`` (phase 12's timed function) on
CPU tensors, cached in :func:`golden_run`; the ``test_phase12_*`` tests
rehearse phase 12 on it (the line, the span report, the device audit and the
worker's verify job; on the CPU each K14 wrapper runs its plain version, so
no launch is counted). The card runs the same functions on the 2^20-step
fibonacci trace at ``GlParams()``, and the golden jobs
(``gl_scheme_golden_standalone``, ``gl_scheme_golden_shards``). The ``slow``
tests hold the golden file to a fresh reference run and the port's two-shard
CPU proof to the file's digests."""

import copy
import dataclasses
import functools
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.gl import eccquark as rq
from ceno_tpu.gl import pcs as rpcs
from ceno_tpu.gl import scheme as rgls
from ceno_tpu.gl import zkvm as rz
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm.chips import field_ctx as rfield_ctx
from ceno_tpu.zkvm.e2e import public_values_from_vm as rpublic_values
from ceno_tpu.zkvm.scheme import keygen as rkeygen
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu.zkvm.witgen import generate_witness as rgenerate_witness

import chip_smoke
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import gl_host as gl
from ceno_tpu_torch.gkr.chip import chip_digest
from ceno_tpu_torch.gl import pcs as gpcs
from ceno_tpu_torch.gl import scheme as gls
from ceno_tpu_torch.gl import shard as gshard
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm.chips import field_ctx
from ceno_tpu_torch.zkvm.witgen import generate_witness

torch.set_num_threads(1)
P = gl.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}  # the BabyBear key's commit, unused by GL
PARAMS = chip_smoke.GL_SCHEME_GOLDEN_PARAMS


def golden() -> dict:
    with open(chip_smoke.GL_SCHEME_GOLDEN) as f:
        return json.load(f)


@functools.lru_cache(maxsize=None)
def port_setup() -> tuple:
    """The port's (key, halted vm, trace, public values) at the golden setup."""
    return chip_smoke.gl_scheme_setup(chip_smoke.GL_SCHEME_GOLDEN_ITERS,
                                      chip_smoke.GL_SCHEME_GOLDEN_CFG, "cpu",
                                      BasefoldParams(**FAST))


@functools.lru_cache(maxsize=None)
def golden_run() -> tuple:
    """``chip_smoke.run_gl_scheme`` on CPU tensors at the golden setup: (its
    line, span report, launches, (GL key, the proof's interop dict, params))."""
    old = chip_smoke.DEVICE, chip_smoke.sync
    chip_smoke.DEVICE, chip_smoke.sync = "cpu", lambda: None
    try:
        return chip_smoke.run_gl_scheme(*port_setup(), gpcs.GlParams(**PARAMS))
    finally:
        chip_smoke.DEVICE, chip_smoke.sync = old


@functools.lru_cache(maxsize=None)
def verify_job() -> dict:
    """Phase 12's untimed worker job ``chip_smoke.gl_scheme_verify_job`` on
    :func:`golden_run`'s proof: the host ``verify_gl`` (its seconds) and the
    three tampers it must reject."""
    _, _, _, (vk, data, params) = golden_run()
    return chip_smoke.gl_scheme_verify_job(vk, data, params)


@pytest.fixture(scope="module")
def ref():
    """The reference's (key, vm, records, public values) at the golden setup."""
    cfg = RConfig(**chip_smoke.GL_SCHEME_GOLDEN_CFG)
    vm = rprograms.fibonacci_vm(chip_smoke.GL_SCHEME_GOLDEN_ITERS)
    records = vm.run()
    return rkeygen(vm.program, cfg, RParams(**FAST)), vm, records, rpublic_values(vm, cfg)


@pytest.fixture(scope="module")
def proved():
    """(the port's GL key, its proof of the golden setup, the params)."""
    _, _, _, (vk, data, params) = golden_run()
    return vk, interop.gl_zkvm_proof_from_dict(data), gpcs.GlParams(**params)


def test_keygen_gl_equal(ref):
    rvk = rgls.keygen_gl(ref[0])
    vk = gls.keygen_gl(port_setup()[0])
    assert [(m.name, m.kind, m.is_table, m.table_rows, m.gate) for m in vk.metas] == \
        [(m.name, m.kind, m.is_table, m.table_rows, m.gate) for m in rvk.metas]
    assert [chip_digest(m.compiled) for m in vk.metas] == \
        [chip_digest(m.compiled) for m in rvk.metas]
    assert sorted(vk.fixed_cols) == sorted(rvk.fixed_cols)
    for ci, cols in vk.fixed_cols.items():
        assert cols.dtype == np.uint64 and np.array_equal(cols, rvk.fixed_cols[ci]), ci
    assert np.array_equal(vk.digest_elems(), rvk.digest_elems())
    assert [c.kind for c in vk.shard_chips] == [c.kind for c in rvk.shard_chips]
    assert interop.gl_vk_summary(vk) == interop.gl_vk_summary(rvk) == golden()["standalone"]["vk"]
    assert gls.LABEL_GL == rgls.LABEL_GL


def test_standalone_gl_witgen_equal(ref):
    """The GL witgen of all 93 chips, 23 of them active, equals the
    reference's chip by chip."""
    rpk, rvm, records, rpv = ref
    pk, vm, trace, pv = port_setup()
    assert np.array_equal(pv, rpv)
    rvk, vk = rgls.keygen_gl(rpk), gls.keygen_gl(pk)
    with field_ctx.use(gl.P, inv=gl.inv):
        got = generate_witness(trace, pk.opcode_chips, pk.tables, vm, pv, pk.cfg,
                               shard_chips=vk.shard_chips, dyn_chips=pk.dyn_chips,
                               data_image=pk.data_image)
    with rfield_ctx.use(gl.P, inv=gl.inv):
        want = rgenerate_witness(records, rpk.opcode_chips, rpk.tables, rvm, rpv, rpk.cfg,
                                 shard_chips=rvk.shard_chips, dyn_chips=rpk.dyn_chips,
                                 data_image=rpk.data_image)
    assert len(got) == len(want) == len(vk.metas) == 93
    for a, b in zip(got, want):
        assert (a.name, a.kind, a.num_instances, a.n_rows) == \
            (b.name, b.kind, b.num_instances, b.n_rows)
        assert np.array_equal(np.asarray(a.wit, np.uint64), np.asarray(b.wit, np.uint64)), a.name
    active = [a.num_instances for a in got if a.num_instances]
    assert len(active) == 23
    assert active == [k for k in golden()["standalone"]["num_instances"] if k]


def test_structural_tables_equal(ref):
    """structural_table_gl and structural_eval_gl on every structural spec of
    the key, at its chip's height and a seeded point."""
    vk = gls.keygen_gl(port_setup()[0])
    rng = np.random.default_rng(5)
    pv = port_setup()[3]
    specs = 0
    for m in vk.metas:
        n = gls._chip_height_gl(m, m.table_rows or 33)
        for spec in m.compiled.structural:
            specs += 1
            table = gls.structural_table_gl(spec, n, pv)
            assert table.dtype == np.uint64
            assert np.array_equal(table, rgls.structural_table_gl(spec, n, pv)), (m.name, spec)
            point = rng.integers(0, P, size=(n.bit_length() - 1, 2), dtype=np.uint64)
            assert np.array_equal(gls.structural_eval_gl(spec, point, pv),
                                  rgls.structural_eval_gl(spec, point, pv)), (m.name, spec)
    assert specs >= 5


def test_prove_gl_matches_the_reference(proved):
    """The port's CPU proof has the reference's digest, instance counts and
    public values (ceno_tpu_torch/golden/gl_scheme.json)."""
    _, proof, _ = proved
    want = golden()["standalone"]
    line = golden_run()[0]
    assert interop.gl_zkvm_proof_digest(proof) == line["proof_digest"] == want["digest"]
    assert proof.num_instances == want["num_instances"]
    assert [int(v) for v in proof.public_values] == want["public_values"]
    assert len(line["active_chips"]) == 23


def test_verify_gl_accepts():
    """The port's verify_gl accepts the proof (phase 12's verify job, which
    also holds the three tampers below)."""
    out = verify_job()
    assert out["seconds"] > 0
    assert set(out["rejected"]) == {"witness evaluation", "public value", "opened row"}


@pytest.mark.parametrize("what", ["witness evaluation", "public value", "opened row"])
def test_verify_gl_rejects(proved, what):
    vk, proof, params = proved
    bad = dict(chip_smoke.gl_scheme_tampered(proof))[what]
    with pytest.raises(chip_smoke.GL_SCHEME_ERRORS):
        gls.verify_gl(vk, bad, params)



def test_phase12_on_cpu():
    line, report, counted, (vk, data, params) = golden_run()
    assert line["proof_digest"] == golden()["standalone"]["digest"]
    assert line["steps"] == golden()["standalone"]["steps"]
    assert set(counted) == {"gl_encode", "gl_leaf_sponge", "gl_merkle_levels"}
    assert line["checked_on_device"]["commits"] == 2 * len(line["active_chips"])
    # one bank a tower level, one for the main zerocheck, one for the opening
    assert line["checked_on_device"]["banks"] == sum(
        c["height"].bit_length() for c in line["active_chips"].values())
    for span in ("gl/witgen", "gl/commit", "gl/records", "gl/towers", "gl/main", "gl/open"):
        assert span in line["span_seconds"], span
    assert set(line["chips"]) == set(line["active_chips"])
    assert abs(sum(c["grind"] for c in line["chips"].values()) - line["grind_seconds"]) < 1e-9
    assert line["active_chips"]["and8"]["rows"] == 65536
    assert "gl/chip/and8" in report and "gl/towers" in report
    json.dumps({"gl_scheme": line})
    pickle.dumps((vk, data, params))  # what the worker is sent


def test_phase12_verify_job_on_cpu():
    """The worker job accepts the honest proof, shipped as its interop dict,
    and rejects its three tampers."""
    out = verify_job()
    assert out["seconds"] > 0
    assert out["rejected"] == {"witness evaluation": "GlSchemeError",
                               "public value": "GlSumcheckError",
                               "opened row": "GlPCSError"}

def _ref_opening(d):
    return rpcs.GlOpening(d["round_msgs"], list(d["fold_roots"]), d["tail"],
                          [rpcs.GlQuery(**q) for q in d["queries"]], d["pow_nonce"])


def _ref_proof(d):
    """The reference's GlZKVMProof built from a plain form."""
    pieces = {}
    for ci, p in d["pieces"].items():
        ec = p.get("ec_proof")
        extra = p.get("ec_extra")
        pieces[ci] = rgls.GlChipPiece(
            p["root"], rz.GlTowerProof(**p["tower"]), p["main_msgs"], p["wit_evals"],
            p["fixed_evals"], p["structural_evals"], _ref_opening(p["opening"]),
            ec_proof=None if ec is None else rq.GlEccQuarkProof(**ec),
            ec_extra=None if extra is None else {
                name: (e["evals"], _ref_opening(e["opening"])) for name, e in extra.items()})
    return rgls.GlZKVMProof(d["public_values"], list(d["num_instances"]), pieces)


def _same(a, b, path="proof"):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.uint64, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def test_interop_round_trips(proved):
    """A reference proof read through the converters gives the port's
    objects unchanged, and the port's proof written out and read back by the
    reference's classes gives the same plain form."""
    _, proof, _ = proved
    plain = interop.gl_zkvm_proof_to_dict(proof)
    ref_proof = _ref_proof(copy.deepcopy(plain))
    assert interop.gl_zkvm_proof_digest(ref_proof) == interop.gl_zkvm_proof_digest(proof)
    _same(interop.gl_zkvm_proof_from_dict(interop.gl_zkvm_proof_to_dict(ref_proof)), proof)
    _same(interop.gl_zkvm_proof_from_dict(plain), proof)
    ec = [ci for ci, p in proof.pieces.items() if p.ec_proof is not None]
    assert not ec  # a standalone shard has no EC-tree chip active
    sharded = gshard.GlShardedProof([proof, proof])
    back = interop.gl_sharded_proof_from_dict(interop.gl_sharded_proof_to_dict(sharded))
    assert back.n_shards == 2
    _same(back.proofs[1], proof)
    piece = next(iter(proof.pieces.values()))
    _same(interop.gl_chip_piece_from_dict(interop.gl_chip_piece_to_dict(piece)), piece)


@pytest.mark.slow
def test_golden_file_against_a_fresh_reference_run():
    """ceno_tpu_torch/golden/gl_scheme.json is what the reference gives now
    (about 15 minutes: its standalone and two-shard proves and verifies)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_gl_scheme_golden

    assert torch_gl_scheme_golden.reference_values() == golden()


@pytest.mark.slow
def test_two_shard_gl_proof_on_cpu(monkeypatch):
    """The port's two-shard GL proof on CPU tensors has the reference's
    digests, and verify_shards_gl rejects the chain tampers (phase 12's
    golden job, chip_smoke.gl_scheme_golden_shards)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    got = chip_smoke.gl_scheme_golden_shards()
    assert len(got["digests"]) == 2
    assert set(got["rejected"]) == {"rw-sum limb", "pc chain", "dropped shard"}
