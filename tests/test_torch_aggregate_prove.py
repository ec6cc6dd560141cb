"""Port parity: the aggregation proof (``zkvm/aggregate.prove_aggregation``
through ``prove_chipset``) and the key-less verifiers, at
``tests/test_aggregate.py``'s setup, on CPU tensors.

``fibonacci_vm(8)``, ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``,
``BasefoldParams(blowup_log=1, n_queries=4, stop_size=32)``:

- the port's ``prove_aggregation`` on the CPU gives the SHA-256 and length
  of the reference's ``agg_proof_to_bytes`` and its key's digest, as
  ``ceno_tpu_torch/golden/aggregation_fibonacci.json`` has them (written by
  ``tools/torch_agg_golden.py`` with the reference; its ``single`` entry);
- the reference's key-less ``verify_aggregation`` accepts the port's proof
  read by the reference's ``agg_proof_from_bytes``; as those bytes are the
  reference's proof, the port's ``verify_aggregation`` accepts that object
  carried back through ``interop`` (``agg_proof_to_dict`` /
  ``agg_proof_from_dict``), and the port's bytes read back by the port
  write back the same bytes;
- a changed public value, a wrong geometry flag and a changed class-main
  eval are rejected (chip_smoke's phase 9 helpers).

The reference's own prove of this setup takes minutes on the CPU; the
golden file stands for it here, and the one test that proves it again with
the reference is marked slow.
"""

import dataclasses
import hashlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import aggregate as ragg
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import aggregate as agg
from ceno_tpu_torch.zkvm import e2e, scheme, serialize
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "aggregation_fibonacci.json")


@pytest.fixture(scope="module")
def want():
    with open(GOLDEN) as f:
        return json.load(f)["single"]


@pytest.fixture(scope="module")
def proved(want):
    cfg, params = ZKVMConfig(**want["cfg"]), BasefoldParams(**want["params"])
    vm = programs.fibonacci_vm(8)
    trace = native.run_trace_native(vm)
    pk = scheme.keygen(vm.program, cfg, params, device="cpu")
    proof = scheme.prove(pk, vm, trace, e2e.public_values_from_vm(vm, cfg), device="cpu")
    key, aproof = agg.prove_aggregation(pk.vk, proof, params=params, device="cpu")
    return pk, key, aproof, serialize.agg_proof_to_bytes(aproof, params)


def test_golden_setup_is_chip_smokes(want):
    spec = importlib.util.spec_from_file_location(
        "torch_agg_golden", os.path.join(ROOT, "tools", "torch_agg_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    setup = {k: v for k, v in tool.SETUPS["single"].items() if k != "iters"}
    assert {k: want[k] for k in setup} == setup
    assert want["program"] == "fibonacci_vm(8)" and want["cfg"] == chip_smoke.AGG_GOLDEN_CFG
    assert want["params"] == chip_smoke.FAST_PARAMS
    assert os.path.abspath(chip_smoke.AGG_GOLDEN) == GOLDEN


def test_port_proof_has_golden_digests(proved, want):
    pk, key, aproof, blob = proved
    got = chip_smoke.agg_digests(key, aproof, pk.params)
    assert got == {k: want[k] for k in got}
    assert hashlib.sha256(blob).hexdigest() == want["proof_sha256"]
    assert aproof.geometry == [agg.ShardGeometry(list(aproof.geometry[0].num_instances))]


def test_stored_proofs_are_the_golden_ones(proved, want):
    """The single entry's stored bytes are the port's proof (and so the
    reference's); the level-2 entry's have the digests of its entry, and
    chip_smoke's level-2 jobs rebuild the inner key from the stored bytes."""
    with open(chip_smoke.AGG_GOLDEN_PROOF.format("single"), "rb") as f:
        assert f.read() == proved[3]
    with open(GOLDEN) as f:
        level2 = json.load(f)["level2"]
    assert level2["inner"] == "single"
    outer, params = chip_smoke.stored_agg_proof("level2", level2)
    assert outer.geometry[0] == "chipset" and params == proved[0].params
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEVICE", "cpu")
    try:
        key, inner, params = chip_smoke.level2_inner(want)
    finally:
        mp.undo()
    assert chip_smoke.agg_digests(key, inner, params) == chip_smoke.agg_digests(*proved[1:3],
                                                                                 params)


def test_reference_verifies_port_proof(proved):
    pk, _, _, blob = proved
    # the reference's key of the same program (keygen is deterministic)
    rpk = rscheme.keygen(rprograms.fibonacci_vm(8).program, RConfig(**chip_smoke.AGG_GOLDEN_CFG),
                         RParams(**dataclasses.asdict(pk.params)))
    np.testing.assert_array_equal(rpk.vk.digest_elems(), pk.vk.digest_elems())
    raproof, rparams = rserialize.agg_proof_from_bytes(blob)
    assert rparams == RParams(**dataclasses.asdict(pk.params))
    assert ragg.verify_aggregation(raproof, rpk.vk, params=rparams) is True


def test_port_verifies_reference_object(proved):
    pk, _, aproof, blob = proved
    raproof, _ = rserialize.agg_proof_from_bytes(blob)
    plain = interop.agg_proof_to_dict(raproof)
    assert interop.digest(plain) == interop.digest(interop.agg_proof_to_dict(aproof))
    back = interop.agg_proof_from_dict(plain)
    assert serialize.agg_proof_to_bytes(back, pk.params) == blob
    parsed, params = serialize.agg_proof_from_bytes(blob)
    assert params == pk.params and serialize.agg_proof_to_bytes(parsed, params) == blob
    assert agg.verify_aggregation(back, pk.vk, params=pk.params) is True


def test_tampered_proofs_rejected(proved):
    # chip_smoke's phase 9 helpers on the CPU: a changed public value through
    # a worker's job (the key rebuilt from the proof's geometry), a wrong
    # geometry flag and a changed class-main eval
    pk, _, aproof, blob = proved
    assert chip_smoke.agg_verify_job("public value", pk.vk, blob) == \
        {"public value": "SumcheckError"}
    bads = [b for b in chip_smoke.agg_tampered(aproof) if b[0] != "public value"]
    got = chip_smoke.check_agg_rejections(
        lambda p: agg.verify_aggregation(p, pk.vk, params=pk.params), bads, "test")
    assert got == {"geometry flag": "AggError", "class-main eval": "ChipError"}


@pytest.mark.slow
def test_golden_entry_recomputed_by_reference(want):
    # the reference proves the golden setup again (minutes on the CPU)
    spec = importlib.util.spec_from_file_location(
        "torch_agg_golden", os.path.join(ROOT, "tools", "torch_agg_golden.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    got, blob = tool._reference_entry("single")
    assert got == want
    with open(chip_smoke.AGG_GOLDEN_PROOF.format("single"), "rb") as f:
        assert f.read() == blob
