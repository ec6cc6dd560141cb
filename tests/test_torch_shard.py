"""Port parity: continuations (``zkvm/shard.py``, sharded ``witgen`` and
``scheme``) against the reference, at ``tests/test_shard.py``'s setup.

``fibonacci_vm(12)``, ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``,
``BasefoldParams(blowup_log=1, n_queries=4, stop_size=32)``, at most 40
steps a shard (3 shards). One reference ``prove_shards`` (its pipeline) and
one port ``prove_shards`` on CPU tensors with ``pipeline=False`` (the
sequential path; ``tests/test_torch_shard_smoke.py`` proves the same setup
pipelined and holds it against the same golden digests):

- ``plan_shards`` gives the reference's bounds, tokens and public values for
  every shard, and the tokens cancel across shards;
- each shard's ``generate_witness`` equals the reference's chip by chip
  (``tokens_to_points``, ``assign_shard_ram`` and ``assign_ec_tree`` over
  real tokens included) and is mock-satisfied;
- each shard's ``proof_to_bytes`` equals the reference's, and both equal
  ``ceno_tpu_torch/golden/shard_fibonacci.json`` (recomputed here with both
  packages); the reference's bytes read back through ``interop`` unchanged;
- each ``verify_shards`` accepts the other's proof; the port rejects a
  broken pv chain, a tampered EC sum, a dropped shard and a standalone
  interior shard; the halt check runs only on the last shard, and the
  first/last gating refuses a shard verified in another place.
"""

import copy
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm import shard as rshard
from ceno_tpu.zkvm.chips.opcodes import TraceView as RTraceView
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu.zkvm.witgen import generate_witness as rgenerate_witness
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import programs
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.fields import septic as S
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import layout, scheme, serialize, shard
from ceno_tpu_torch.zkvm.chips.opcodes import TraceView
from ceno_tpu_torch.zkvm.tables import ZKVMConfig
from ceno_tpu_torch.zkvm.witgen import generate_witness

import chip_smoke

torch.set_num_threads(1)
P = bb.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, STEPS = chip_smoke.SHARD_GOLDEN_ITERS, chip_smoke.SHARD_GOLDEN_STEPS
CFG, PARAMS = chip_smoke.SHARD_GOLDEN_CFG, chip_smoke.SHARD_GOLDEN_PARAMS
N_SHARDS = 3
SHARDS = range(N_SHARDS)


@pytest.fixture(scope="module")
def runs():
    rvm = rprograms.fibonacci_vm(ITERS)
    rrecords = rvm.run()
    rpk = rscheme.keygen(rvm.program, RConfig(**CFG), RParams(**PARAMS))
    rsproof = rshard.prove_shards(rpk, rvm, rrecords, STEPS)
    vm = programs.fibonacci_vm(ITERS)
    records = vm.run()
    pk = scheme.keygen(vm.program, ZKVMConfig(**CFG), BasefoldParams(**PARAMS), device="cpu")
    sproof = shard.prove_shards(pk, vm, records, STEPS, pipeline=False, device="cpu")
    rblobs = [rserialize.proof_to_bytes(p, p.public_values, rpk.cfg, rpk.params)
              for p in rsproof.proofs]
    blobs = interop.sharded_proof_to_bytes(sproof, pk.cfg, pk.params)
    return dict(rvm=rvm, rrecords=rrecords, rpk=rpk, rsproof=rsproof, rblobs=rblobs,
                vm=vm, records=records, pk=pk, sproof=sproof, blobs=blobs)


@pytest.fixture(scope="module")
def plans(runs):
    r = runs
    rctxs = rshard.plan_shards(RTraceView.from_records(r["rrecords"]), r["rvm"], r["rpk"],
                               r["rpk"].cfg, STEPS)
    ctxs = shard.plan_shards(TraceView.from_records(r["records"]), r["vm"], r["pk"],
                             r["pk"].cfg, STEPS)
    return rctxs, ctxs


@pytest.fixture(scope="module")
def witnesses(runs, plans):
    r, (rctxs, ctxs) = runs, plans
    rpk, pk = r["rpk"], r["pk"]
    out = []
    for rctx, ctx in zip(rctxs, ctxs):
        want = rgenerate_witness(None, rpk.opcode_chips, rpk.tables, r["rvm"], rctx.pv, rpk.cfg,
                                 shard_ctx=rctx, shard_chips=rpk.shard_chips,
                                 dyn_chips=rpk.dyn_chips, opcode_assigned=rctx.opcode_assigned)
        got = generate_witness(None, pk.opcode_chips, pk.tables, r["vm"], ctx.pv, pk.cfg,
                               shard_ctx=ctx, shard_chips=pk.shard_chips, dyn_chips=pk.dyn_chips,
                               opcode_assigned=ctx.opcode_assigned)
        out.append((want, got))
    return out


@pytest.mark.parametrize("s", SHARDS)
def test_plan_equal(plans, s):
    rctxs, ctxs = plans
    assert len(ctxs) == len(rctxs) == N_SHARDS
    want, got = interop.shard_context_to_dict(rctxs[s]), interop.shard_context_to_dict(ctxs[s])
    assert interop.digest(got) == interop.digest(want)
    for side in ("in_tokens", "out_tokens"):
        for k, v in got[side].items():
            np.testing.assert_array_equal(v, want[side][k], err_msg=f"{side}.{k}")
    np.testing.assert_array_equal(ctxs[s].pv, rctxs[s].pv)
    assert ctxs[s].pv.dtype == np.uint64
    assert (ctxs[s].shard_id, ctxs[s].n_shards, ctxs[s].step_lo, ctxs[s].step_hi) == \
        (rctxs[s].shard_id, rctxs[s].n_shards, rctxs[s].step_lo, rctxs[s].step_hi)
    back = interop.shard_context_from_dict(got, ctxs[s].opcode_assigned)
    assert interop.shard_context_to_dict(back).keys() == got.keys()
    assert interop.digest(interop.shard_context_to_dict(back)) == interop.digest(got)


def test_plan_tokens_cancel(plans):
    _, ctxs = plans
    exported, imported = [], []
    for ctx in ctxs:
        for tok, sink in ((ctx.out_tokens, exported), (ctx.in_tokens, imported)):
            sink += [tuple(int(getattr(tok, k)[i]) for k in ("is_reg", "addr", "value", "shard",
                                                             "clk")) for i in range(tok.n)]
    assert sorted(exported) == sorted(imported) and exported
    acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    for ctx in ctxs:
        for base in (layout.PV_RW_SUM_IN, layout.PV_RW_SUM_OUT):
            acc = S.point_add(acc, (ctx.pv[base:base + 7], ctx.pv[base + 7:base + 14]))
    assert S.is_infinity(*acc)


@pytest.mark.parametrize("s", SHARDS)
def test_witness_equal(witnesses, s):
    want, got = witnesses[s]
    assert [a.name for a in got] == [a.name for a in want]
    for a, w in zip(got, want):
        assert (a.num_instances, a.n_rows, a.is_table, a.kind) == \
            (w.num_instances, w.n_rows, w.is_table, w.kind), a.name
        assert a.wit.dtype == np.uint64, a.name
        np.testing.assert_array_equal(a.wit, w.wit, err_msg=a.name)
        if a.kind.startswith("ec_tree"):
            np.testing.assert_array_equal(a.ec_final_sum, w.ec_final_sum, err_msg=a.name)
    # the shard-RAM and EC-tree chips carry this shard's tokens
    tokens = {a.kind: a.num_instances for a in got if a.kind.startswith(("shard_ram", "ec_tree"))}
    assert tokens["shard_ram_in"] == tokens["ec_tree_in"]
    assert tokens["shard_ram_out"] == tokens["ec_tree_out"]
    assert sum(tokens.values()) > 0


@pytest.mark.parametrize("s", SHARDS)
def test_witness_mock_satisfied(runs, plans, witnesses, s):
    pk, ctx = runs["pk"], plans[1][s]
    _, got = witnesses[s]
    chips = [(a.compiled, a.cb, a.wit, scheme._fixed_matrix(pk, a, a.n_rows), ctx.pv,
              a.num_instances) for a in got]
    errs = MockProver.assert_satisfied(chips, raise_on_error=False)
    assert errs == [], (s, errs[:5])


@pytest.mark.parametrize("s", SHARDS)
def test_proof_bytes_equal(runs, s):
    rblobs, blobs = runs["rblobs"], runs["blobs"]
    assert len(blobs) == len(rblobs) == N_SHARDS
    assert len(blobs[s]) == len(rblobs[s])
    assert blobs[s] == rblobs[s]
    proof = runs["sproof"].proofs[s]
    assert {k: p.num_instances for k, p in proof.ec_proofs.items()} == \
        {k: p.num_instances for k, p in runs["rsproof"].proofs[s].ec_proofs.items()}


def test_reference_bytes_read_and_written_back(runs):
    sproof = interop.sharded_proof_from_bytes(runs["rblobs"])
    assert type(sproof) is shard.ShardedProof and sproof.n_shards == N_SHARDS
    assert all(type(p) is scheme.ZKVMProof for p in sproof.proofs)
    assert interop.sharded_proof_to_bytes(sproof, runs["pk"].cfg, runs["pk"].params) == \
        runs["rblobs"]
    # a ShardedProof and the quark's proof pass the decoder's whitelist
    data = serialize.proof_to_bytes(sproof, np.zeros(1, np.uint64), runs["pk"].cfg,
                                    runs["pk"].params)
    back, _, _, _ = serialize.proof_from_bytes(data)
    assert type(back) is shard.ShardedProof and back.n_shards == N_SHARDS
    assert any(back.proofs[s].ec_proofs for s in SHARDS)


def test_golden_file_recomputed_with_both_packages(runs):
    with open(chip_smoke.SHARD_GOLDEN) as f:
        want = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "torch_shard_golden", os.path.join(ROOT, "tools", "torch_shard_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert {k: want[k] for k in tool.setup()} == tool.setup()
    assert tool.setup() == {"program": f"fibonacci_vm({ITERS})", "cfg": CFG, "params": PARAMS,
                            "max_steps_per_shard": STEPS}
    assert dataclasses.asdict(runs["pk"].params) == \
        {**dataclasses.asdict(BasefoldParams()), **PARAMS}
    for blobs in (runs["rblobs"], runs["blobs"]):
        got = {**tool.setup(), **tool.shard_digests(blobs)}
        assert got == want
    assert chip_smoke.shard_digests(runs["sproof"], runs["pk"].cfg, runs["pk"].params) == \
        {k: want[k] for k in ("n_shards", "shards")}
    assert want["n_shards"] == N_SHARDS


def test_each_verify_shards_accepts_the_others_proof(runs):
    assert shard.verify_shards(runs["pk"].vk, interop.sharded_proof_from_bytes(runs["rblobs"]))
    rsproof = rshard.ShardedProof([rserialize.proof_from_bytes(b)[0] for b in runs["blobs"]])
    assert rshard.verify_shards(runs["rpk"].vk, rsproof)


def _bad(sproof, what):
    bad = copy.deepcopy(sproof)
    if what == "pv chain":  # tests/test_shard.py: shard 1's end pc
        bad.proofs[1].public_values[layout.PV_END_PC] += 4
    elif what == "ec sum":
        pv = bad.proofs[0].public_values
        pv[layout.PV_RW_SUM_OUT] = (int(pv[layout.PV_RW_SUM_OUT]) + 1) % P
    else:
        bad.proofs = bad.proofs[:-1]
        bad.n_shards -= 1
    return bad


@pytest.mark.parametrize("what", ["pv chain", "ec sum", "dropped shard"])
def test_sharded_proof_rejected(runs, what):
    with pytest.raises(chip_smoke.SHARD_ERRORS):
        shard.verify_shards(runs["pk"].vk, _bad(runs["sproof"], what))


@pytest.mark.parametrize("s", [1, 2])
def test_standalone_rejects_non_first_shard(runs, s):
    with pytest.raises(scheme.ZKVMError, match="standalone proof must be shard 0"):
        scheme.verify(runs["pk"].vk, runs["sproof"].proofs[s])


def test_halt_check_only_on_the_last_shard(runs):
    vk, proofs = runs["pk"].vk, runs["sproof"].proofs
    halt = next(ci for ci, m in enumerate(vk.metas) if m.name == "halt")
    assert [p.num_instances[halt] for p in proofs] == [0, 0, 1]
    # an interior shard has no halt: accepted as interior, refused as the last
    assert scheme.verify(vk, proofs[1], is_first=False, is_last=False, standalone=False)
    with pytest.raises(scheme.ZKVMError, match="halt exactly once"):
        scheme.verify(vk, proofs[1], is_first=False, is_last=True, standalone=False)
    with pytest.raises(scheme.ZKVMError, match="halt exactly once"):
        scheme.verify(vk, proofs[0], is_first=True, is_last=True, standalone=False)
    # without expect_halt the check is skipped: the gating of the last
    # shard's tables refuses the interior shard instead
    with pytest.raises(scheme.ZKVMError, match="table must be active"):
        scheme.verify(vk, proofs[1], is_first=False, is_last=True, standalone=False,
                      expect_halt=False)


def test_gating_refuses_a_shard_in_the_wrong_place(runs):
    vk, proofs = runs["pk"].vk, runs["sproof"].proofs
    with pytest.raises(scheme.ZKVMError, match="must be (in)?active in this shard"):
        scheme.verify(vk, proofs[1], is_first=True, is_last=False, standalone=False)
    with pytest.raises(scheme.ZKVMError, match="must be (in)?active in this shard"):
        scheme.verify(vk, proofs[0], is_first=False, is_last=False, standalone=False)
