"""Port parity: keygen -> prove -> verify of a whole zkVM proof against the
reference, byte for byte.

At ``fibonacci_vm(8)`` with the fast test config and params
(``tests/test_zkvm_e2e.py``), one reference run and one port run
(``device="cpu"``) of ``run_e2e``:

- the public values and ``generate_witness`` are equal: every assigned
  chip's witness, instance count and height, the tables' multiplicities and
  the zero-token shard-RAM / EC-tree witnesses;
- the port's ``proof_to_bytes`` equals the reference's; the port reads the
  reference's bytes with its own ``proof_from_bytes`` and writes them back
  unchanged;
- each verifier accepts the other's proof, read through its own decoder;
- the port's verifier rejects a changed public value, tower output, main
  zerocheck message, class-main eval and opening row, as the reference's
  tests do;
- the decoder refuses a class outside the port's whitelist and takes the
  EC-sum quark's and the sharded proof's; the mock-proving switch runs the
  MockProver before the commit; an EC tree whose sum differs from the public
  values is refused; ``verify``'s default flags are the standalone case (the
  first and last shard, no tokens, one halt); the checkpointed pipeline
  stops and resumes;
- ``ceno_tpu_torch/golden/e2e_fibonacci.json`` names the setup that
  ``chip_smoke.py`` proves on the card.
"""

import copy
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import native as rnative
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu.zkvm.witgen import generate_witness as rgenerate_witness
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import e2e, layout, scheme, serialize
from ceno_tpu_torch.zkvm.tables import ZKVMConfig
from ceno_tpu_torch.zkvm.witgen import generate_witness

import chip_smoke

torch.set_num_threads(1)
P = 2013265921
CFG = dict(shl_x_bits=6, mem_words_log=7)
PARAMS = dict(blowup_log=1, n_queries=4, stop_size=32)
ITERS = 8


@pytest.fixture(scope="module")
def runs():
    ref = re2e.run_e2e(rprograms.fibonacci_vm(ITERS), RConfig(**CFG), RParams(**PARAMS))
    port = e2e.run_e2e(programs.fibonacci_vm(ITERS), ZKVMConfig(**CFG), BasefoldParams(**PARAMS),
                       device="cpu")
    rbytes = rserialize.proof_to_bytes(ref.proof, ref.public_values, ref.pk.cfg, ref.pk.params)
    pbytes = serialize.proof_to_bytes(port.proof, port.public_values, port.pk.cfg, port.pk.params)
    return ref, port, rbytes, pbytes


def test_public_values_equal(runs):
    ref, port, _, _ = runs
    np.testing.assert_array_equal(port.public_values, ref.public_values)
    assert port.public_values.dtype == np.uint64 and port.n_steps == ref.n_steps


def test_witness_equal(runs):
    ref, port, _, _ = runs
    rvm, vm = rprograms.fibonacci_vm(ITERS), programs.fibonacci_vm(ITERS)
    rtrace, trace = rnative.run_trace(rvm), native.run_trace(vm)
    rpk, pk = ref.pk, port.pk
    want = rgenerate_witness(rtrace, rpk.opcode_chips, rpk.tables, rvm, ref.public_values, rpk.cfg,
                             shard_chips=rpk.shard_chips, dyn_chips=rpk.dyn_chips)
    got = generate_witness(trace, pk.opcode_chips, pk.tables, vm, port.public_values, pk.cfg,
                           shard_chips=pk.shard_chips, dyn_chips=pk.dyn_chips)
    assert [a.name for a in got] == [a.name for a in want] == [m.name for m in pk.metas]
    for a, w in zip(got, want):
        assert (a.num_instances, a.n_rows, a.is_table, a.kind) == \
            (w.num_instances, w.n_rows, w.is_table, w.kind), a.name
        assert a.wit.dtype == np.uint64, a.name
        np.testing.assert_array_equal(a.wit, w.wit, err_msg=a.name)
        if a.kind.startswith("ec_tree"):
            np.testing.assert_array_equal(a.ec_final_sum, w.ec_final_sum)
    kinds = {a.kind for a in got}
    assert {"shard_ram_in", "shard_ram_out", "ec_tree_in", "ec_tree_out", "table"} <= kinds
    active = [a.name for a in got if a.num_instances]
    assert len(active) == 23 and "keccak_rc" in active


def test_proof_bytes_equal(runs):
    _, _, rbytes, pbytes = runs
    assert len(pbytes) == len(rbytes) == 127393
    assert pbytes == rbytes


def test_reference_bytes_read_and_written_back(runs):
    ref, _, rbytes, _ = runs
    proof, pv, cfg, params = serialize.proof_from_bytes(rbytes)
    assert type(proof) is scheme.ZKVMProof and type(cfg) is ZKVMConfig
    assert type(params) is BasefoldParams
    assert serialize.proof_to_bytes(proof, pv, cfg, params) == rbytes


def test_each_verifier_accepts_the_others_proof(runs):
    ref, port, rbytes, pbytes = runs
    proof, _, _, _ = serialize.proof_from_bytes(rbytes)
    assert scheme.verify(port.pk.vk, proof) is True
    rproof, _, _, _ = rserialize.proof_from_bytes(pbytes)
    assert rscheme.verify(ref.pk.vk, rproof) is True


def _bump(a, index):
    a[index] = (int(a[index]) + 1) % P


def _tamper(proof, what):
    bad = copy.deepcopy(proof)
    if what == "public value":
        _bump(bad.public_values, layout.PV_EXIT_CODE_LO)
    elif what == "tower output":
        gp = next(g for g in bad.tower_groups.values() if g.prod_out.shape[0])
        _bump(gp.prod_out, (0, 0, 0))
    elif what == "main message":
        _bump(bad.class_main[max(bad.class_main)].main_msgs, (0, 0, 0))
    elif what == "class-main eval":
        we = next(e for e in bad.class_main[max(bad.class_main)].wit_evals if e.shape[0])
        _bump(we, (0, 0))
    else:
        (opening,) = bad.witness_openings.values()
        _bump(opening.opening.queries[0].base_rows, (0, 0))
    return bad


@pytest.mark.parametrize("what", ["public value", "tower output", "main message",
                                  "class-main eval", "opening row"])
def test_tampered_proof_rejected(runs, what):
    _, port, _, _ = runs
    with pytest.raises(chip_smoke.PROTOCOL_ERRORS):
        scheme.verify(port.pk.vk, _tamper(port.proof, what))


def test_chip_smoke_tampered_proofs_rejected(runs):
    _, port, _, _ = runs
    whats = []
    for what, bad in chip_smoke.tampered(port.proof):
        with pytest.raises(chip_smoke.PROTOCOL_ERRORS):
            scheme.verify(port.pk.vk, bad)
        whats.append(what)
    assert whats == ["public value", "class-main eval", "opening row"]


def test_launch_plan_matches_the_proof(runs):
    _, port, _, _ = runs
    pk, proof = port.pk, port.proof
    trees = chip_smoke.prove_trees(pk, proof)
    (wo,), (fo,) = proof.witness_openings.values(), proof.fixed_openings.values()
    n_wf = len(wo.opening.fold_roots)
    assert len(trees) == 1 + n_wf + len(fo.opening.fold_roots)
    (n_w,), (n_f,) = proof.witness_roots, pk.fixed_committed
    b = pk.params.blowup_log
    assert trees[0] == n_w.bit_length() - 1 + b
    # each tree's leaf count is the one its query paths climb
    for opening, base_log, logs in ((wo, trees[0], trees[1:1 + n_wf]),
                                    (fo, n_f.bit_length() - 1 + b, trees[1 + n_wf:])):
        q = opening.opening.queries[0]
        assert q.base_paths.shape[1] == base_log
        assert [p.shape[1] for p in q.u_paths] == logs


def test_decoder_whitelist():
    # a class that neither package's whitelist has
    fake = dataclasses.make_dataclass("ForeignProof", [("iters", list)])
    buf = io.BytesIO()
    buf.write(serialize.MAGIC)
    serialize._encode(buf, {"proof": fake([])})
    with pytest.raises(serialize.ProofFormatError, match="ForeignProof"):
        serialize.proof_from_bytes(buf.getvalue())
    # the WHIR classes pass it
    from ceno_tpu_torch.pcs.whir import WhirIter, WhirProof, WhirQuerySet

    qs = WhirQuerySet([3, 1], np.zeros((2, 8, 4), np.uint64), np.zeros((16, 5, 8), np.uint64), 7)
    wp = WhirProof([WhirIter(np.zeros((3, 3, 4), np.uint64), np.zeros(8, np.uint64),
                             np.zeros(4, np.uint64), qs)],
                   np.zeros((2, 3, 4), np.uint64), np.zeros((32, 4), np.uint64), qs)
    data = serialize.proof_to_bytes(wp, np.zeros(1, np.uint64), None, None)
    back, _, _, _ = serialize.proof_from_bytes(data)
    assert type(back) is WhirProof and type(back.iters[0].queries) is WhirQuerySet
    assert back.final_queries.indices == [3, 1] and back.final_queries.pow_nonce == 7
    # the continuations' classes pass it
    from ceno_tpu_torch.gkr.eccquark import EccQuarkProof
    from ceno_tpu_torch.zkvm.shard import ShardedProof

    ecp = EccQuarkProof(3, 2, np.zeros((2, 4, 4), np.uint64), np.zeros((49, 4), np.uint64),
                        np.zeros((2, 7), np.uint64))
    data = serialize.proof_to_bytes(ShardedProof([ecp]), np.zeros(1, np.uint64), None, None)
    back, _, _, _ = serialize.proof_from_bytes(data)
    assert type(back) is ShardedProof and back.n_shards == 1
    assert type(back.proofs[0]) is EccQuarkProof and back.proofs[0].num_instances == 3
    with pytest.raises(serialize.ProofFormatError):
        serialize.proof_to_bytes({"x": torch.zeros(2)}, np.zeros(1, np.uint64), None, None)


def _witness(port):
    vm = programs.fibonacci_vm(ITERS)
    trace = native.run_trace(vm)
    pk = port.pk
    return vm, trace, generate_witness(trace, pk.opcode_chips, pk.tables, vm, port.public_values,
                                       pk.cfg, shard_chips=pk.shard_chips, dyn_chips=pk.dyn_chips)


class _Committed(Exception):
    pass


def test_mock_proving_switch(runs, monkeypatch):
    _, port, _, _ = runs
    vm, trace, assigned = _witness(port)
    monkeypatch.setenv("CENO_TPU_TORCH_MOCK_PROVING", "1")

    def stop(*args, **kwargs):
        raise _Committed

    monkeypatch.setattr(scheme.basefold, "commit", stop)
    # the honest witness passes the MockProver and reaches the commit
    with pytest.raises(_Committed):
        scheme.prove(port.pk, vm, trace, port.public_values, assigned=assigned, device="cpu")
    bad = [dataclasses.replace(a, wit=a.wit.copy()) if a.name == "add" else a for a in assigned]
    add = next(a for a in bad if a.name == "add")
    _bump(add.wit, (add.cb.wit_names.index("rd_lo"), 0))
    with pytest.raises(AssertionError, match="MockProver"):
        scheme.prove(port.pk, vm, trace, port.public_values, assigned=bad, device="cpu")


def test_ec_tree_with_instances_names_the_missing_module(runs):
    """An EC tree whose sum differs from the public values' RW sum is
    refused by ``prove``, which names the chip."""
    _, port, _, _ = runs
    vm, trace, assigned = _witness(port)
    fsum = np.ones((2, 7), np.uint64)
    bad = [dataclasses.replace(a, num_instances=1, ec_final_sum=fsum)
           if a.kind == "ec_tree_in" else a for a in assigned]
    with pytest.raises(scheme.ZKVMError, match="ec_tree_in: tree sum does not match"):
        scheme.prove(port.pk, vm, trace, port.public_values, assigned=bad, device="cpu")


def test_default_verify_flags_are_the_standalone_case(runs):
    _, port, _, _ = runs
    vk, proof = port.pk.vk, port.proof
    assert proof.ec_proofs == {}
    assert scheme.verify(vk, proof, is_first=True, is_last=True, standalone=True,
                         expect_halt=True) is True
    # one shard of a sharded proof: the first and the last
    assert scheme.verify(vk, proof, standalone=False) is True
    with pytest.raises(scheme.ZKVMError, match="must be (in)?active in this shard"):
        scheme.verify(vk, proof, is_last=False, standalone=False)


def test_checkpoint_pipeline(runs):
    _, port, _, _ = runs
    st = e2e.run_e2e_with_checkpoint(
        programs.fibonacci_vm(ITERS), ZKVMConfig(**CFG), BasefoldParams(**PARAMS),
        checkpoint=e2e.Checkpoint.PREP_WITNESS_GEN, device="cpu")
    assert st.checkpoint == e2e.Checkpoint.PREP_WITNESS_GEN
    np.testing.assert_array_equal(st.public_values, port.public_values)
    assert st.trace.n == port.n_steps
    st.proof, st.checkpoint = port.proof, e2e.Checkpoint.PREP_VERIFY
    assert st.resume().verified is True


def test_golden_file_names_chip_smoke_setup():
    with open(chip_smoke.E2E_GOLDEN) as f:
        want = json.load(f)
    assert want["program"] == f"fibonacci_vm({chip_smoke.E2E_GOLDEN_ITERS})"
    assert want["cfg"] == chip_smoke.E2E_GOLDEN_CFG
    assert want["params"] == dataclasses.asdict(BasefoldParams()) == dataclasses.asdict(RParams())
    assert set(want) == {"program", "cfg", "params", "proof_sha256", "proof_bytes",
                         "vk_digest_sha256"}
    assert want["proof_bytes"] == 665986
