"""Port parity: WHIR (``ceno_tpu_torch/pcs/whir.py``) against the reference.

The port proves on CPU tensors (its kernels' plain versions); the reference
runs its host path. tests/test_whir.py's cases go through both packages:
the seeded opening (N_VARS = 12, C = 5, blowup 2) must give the same
WhirProof field by field and leave the two transcripts in the same state,
also with 4 PoW bits; each package's verifier accepts the other's opening,
and both reject the four tamperings; an opening that stops with no
iteration is held the same way. The zkVM case proves ``fibonacci_vm(8)`` at
test_whir_zkvm_e2e's params in both packages (the port's through
chip_smoke's phase 13 on the CPU, the rehearsal of the card's run): the
``proof_to_bytes`` must be equal, and each verifier accepts the other's
proof. The seeded opening and the zkVM proof must also have the digests of
``ceno_tpu_torch/golden/whir_fibonacci.json``, which the card is held to.
Each package proves each case once (module fixtures).
"""

import copy
import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.pcs import basefold as rbf
from ceno_tpu.pcs import whir as rwhir
from ceno_tpu.pcs.basefold import BasefoldParams as RBasefoldParams
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm.e2e import run_e2e as rrun_e2e
from ceno_tpu.zkvm.tables import ZKVMConfig as RZKVMConfig
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import whir
from ceno_tpu_torch.sumcheck.host_impl import build_eq_host
from ceno_tpu_torch.sumcheck.verifier import SumcheckError
from ceno_tpu_torch.zkvm import e2e, scheme, serialize
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke
import test_whir

torch.set_num_threads(1)
P = bb.P
CASE = chip_smoke.WHIR_OPEN_CASE
LABEL = CASE["label"].encode()


def _open_both(cols, z, values, n_vars, blowup, params: dict) -> dict:
    """Commit ``cols`` and open at z in both packages: proofs, transcripts."""
    rcom = rbf.commit(cols, rbf.BasefoldParams(blowup_log=blowup))
    rtr = RTranscript(LABEL)
    rproof = rwhir.open_whir(rcom, z, values, rtr, blowup, rwhir.WhirParams(**params))
    pcom = bf.commit(cols, bf.BasefoldParams(blowup_log=blowup), device="cpu")
    ptr = Transcript(LABEL)
    pproof = whir.open_whir(pcom, z, values, ptr, blowup, whir.WhirParams(**params))
    return dict(root=rcom.root, proot=pcom.root, rproof=rproof, rtr=rtr, pproof=pproof, ptr=ptr,
                z=z, values=values, n_vars=n_vars, cols=cols.shape[0], blowup=blowup,
                params=params)


@pytest.fixture(scope="module")
def seeded():
    cols, z, values = chip_smoke.whir_open_inputs()
    return {pow_bits: _open_both(cols, z, values, CASE["n_vars"], CASE["blowup_log"],
                                 {**CASE["params"], "pow_bits": pow_bits})
            for pow_bits in (0, 4)}


def _assert_same(a, b, path="proof"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def _assert_same_transcripts(a, b):
    (sa, *ra), (sb, *rb) = a.export_state(), b.export_state()
    np.testing.assert_array_equal(sa, sb)
    assert ra == rb


def test_open_case_is_test_whirs():
    """chip_smoke's golden case is tests/test_whir.py's: its constants, and
    the values are that test's MLE evaluations of the first draw."""
    assert (CASE["n_vars"], CASE["cols"], CASE["blowup_log"]) == (
        test_whir.N_VARS, test_whir.C, test_whir.BLOWUP)
    assert CASE["params"] == dataclasses.asdict(test_whir.WP)
    cols, z, values = chip_smoke.whir_open_inputs()
    rng = np.random.default_rng(CASE["seed"])
    np.testing.assert_array_equal(
        cols, rng.integers(0, P, size=(CASE["cols"], 1 << CASE["n_vars"])).astype(np.uint64))
    for j in range(CASE["cols"]):
        np.testing.assert_array_equal(values[j], test_whir._mle_eval(cols[j], z))


@pytest.mark.parametrize("pow_bits", [0, 4])
def test_open_whir_matches_reference(seeded, pow_bits):
    c = seeded[pow_bits]
    np.testing.assert_array_equal(c["proot"], c["root"])
    assert len(c["pproof"].iters) == 2  # 12 -> 9 -> 6 -> final 3
    _assert_same(dataclasses.asdict(c["pproof"]), dataclasses.asdict(c["rproof"]))
    _assert_same(interop.whir_proof_to_dict(c["pproof"]), dataclasses.asdict(c["rproof"]))
    _assert_same_transcripts(c["ptr"], c["rtr"])
    nonces = [it.queries.pow_nonce for it in c["pproof"].iters] + [
        c["pproof"].final_queries.pow_nonce]
    assert all(isinstance(i, int) for i in c["pproof"].final_queries.indices)
    assert (max(nonces) > 0) == (pow_bits > 0)


@pytest.mark.parametrize("pow_bits", [0, 4])
def test_each_verifier_accepts_the_others_opening(seeded, pow_bits):
    c = seeded[pow_bits]
    args = (c["n_vars"], c["cols"], c["z"], c["values"])
    ref_in_port = interop.whir_proof_from_dict(dataclasses.asdict(c["rproof"]))
    whir.verify_whir(c["root"], *args, ref_in_port, Transcript(LABEL), c["blowup"],
                     whir.WhirParams(**c["params"]))
    rwhir.verify_whir(c["proot"], *args, c["pproof"], RTranscript(LABEL), c["blowup"],
                      rwhir.WhirParams(**c["params"]))


def _tamper(what: str, proof, values):
    bad, vals = copy.deepcopy(proof), values.copy()
    if what == "wrong value":
        vals[1][0] = (int(vals[1][0]) + 1) % P
    elif what == "final function":
        bad.final_g[0][0] = (int(bad.final_g[0][0]) + 1) % P
    elif what == "query leaf":
        bad.iters[0].queries.leaves[0][0][0] = (int(bad.iters[0].queries.leaves[0][0][0]) + 1) % P
    else:
        bad.iters[0].y_ood[0] = (int(bad.iters[0].y_ood[0]) + 1) % P
    return bad, vals


@pytest.mark.parametrize("what", ["wrong value", "final function", "query leaf", "OOD value"])
def test_tampered_openings_are_rejected(seeded, what):
    """tests/test_whir.py's four tamperings of the port's opening: the port's
    verifier rejects each, and so does the reference's."""
    c = seeded[0]
    bad, vals = _tamper(what, c["pproof"], c["values"])
    args = (c["n_vars"], c["cols"], c["z"], vals, bad)
    with pytest.raises((whir.WhirError, SumcheckError)):
        whir.verify_whir(c["proot"], *args, Transcript(LABEL), c["blowup"],
                         whir.WhirParams(**c["params"]))
    with pytest.raises(Exception):
        rwhir.verify_whir(c["root"], *args, RTranscript(LABEL), c["blowup"],
                          rwhir.WhirParams(**c["params"]))


def test_opening_with_no_iteration_matches_reference():
    """m - k <= stop_vars at once (6 variables, k 3, stop 5): one round, the
    function in clear, one query set on the committed columns."""
    rng = np.random.default_rng(5)
    n_vars, blowup = 6, 2
    cols = rng.integers(0, P, size=(3, 1 << n_vars), dtype=np.uint64)
    z = rng.integers(0, P, size=(n_vars, 4), dtype=np.uint64)
    eq = build_eq_host(z)
    values = np.stack([(eq * col[:, None] % np.uint64(P)).sum(axis=0) % np.uint64(P)
                       for col in cols])
    params = {"k": 3, "stop_vars": 5, "security_bits": 8, "pow_bits": 2}
    c = _open_both(cols, z, values, n_vars, blowup, params)
    assert c["pproof"].iters == [] and c["pproof"].final_msgs.shape == (1, 3, 4)
    assert c["pproof"].final_g.shape == (1 << 5, 4)
    _assert_same(dataclasses.asdict(c["pproof"]), dataclasses.asdict(c["rproof"]))
    _assert_same_transcripts(c["ptr"], c["rtr"])
    whir.verify_whir(c["root"], n_vars, 3, z, values,
                     interop.whir_proof_from_dict(dataclasses.asdict(c["rproof"])),
                     Transcript(LABEL), blowup, whir.WhirParams(**params))
    rwhir.verify_whir(c["proot"], n_vars, 3, z, values, c["pproof"], RTranscript(LABEL), blowup,
                      rwhir.WhirParams(**params))


def test_seeded_opening_has_the_golden_digest(seeded):
    with open(chip_smoke.WHIR_GOLDEN) as f:
        want = json.load(f)["open_whir"]
    assert want["setup"] == CASE
    c = seeded[0]
    assert interop.digest(interop.whir_proof_to_dict(c["pproof"])) == want["proof_digest"]
    assert chip_smoke.transcript_state(c["ptr"]) == want["transcript"]


# -- the zkVM case: fibonacci_vm(8) at test_whir_zkvm_e2e's params --------------------

ZK = chip_smoke.WHIR_GOLDEN_PROOFS["test_params"]


@pytest.fixture(scope="module")
def zkvm_case():
    """The reference's run_e2e and the port's phase 13 on CPU tensors, each
    once: (reference result, its bytes, the port's line, report, bank
    lengths, key and bytes)."""
    ref = rrun_e2e(rprograms.fibonacci_vm(ZK["iters"]), RZKVMConfig(**ZK["cfg"]),
                   RBasefoldParams(**ZK["params"]))
    ref_data = rserialize.proof_to_bytes(ref.proof, ref.public_values, ref.pk.cfg, ref.pk.params)
    mp = pytest.MonkeyPatch()
    mp.setattr(chip_smoke, "DEVICE", "cpu")
    try:
        cfg = ZKVMConfig(**ZK["cfg"])
        vm = programs.fibonacci_vm(ZK["iters"])
        trace = native.run_trace_native(vm)
        line, report, lengths, (pk, data) = chip_smoke.run_whir(
            vm, trace, e2e.public_values_from_vm(vm, cfg), ZK["iters"], cfg,
            bf.BasefoldParams(**ZK["params"]))
    finally:
        mp.undo()
    return dict(ref=ref, ref_data=ref_data, line=line, report=report, lengths=lengths, pk=pk,
                data=data)


def test_test_params_are_test_whirs():
    """The zkVM case's setup is test_whir_zkvm_e2e's (its source's literals)."""
    import inspect

    src = inspect.getsource(test_whir.test_whir_zkvm_e2e)
    p = ZK["params"]
    assert (f"BasefoldParams(blowup_log={p['blowup_log']}, n_queries={p['n_queries']}, "
            f"stop_size={p['stop_size']},") in src and 'pcs_kind="whir"' in src
    assert (f"ZKVMConfig(shl_x_bits={ZK['cfg']['shl_x_bits']}, "
            f"mem_words_log={ZK['cfg']['mem_words_log']})") in src
    assert f"fibonacci_vm({ZK['iters']})" in src


def test_phase13_rehearsal_on_cpu(zkvm_case):
    line = zkvm_case["line"]
    assert line["device"] == "cpu" and line["steps"] == 59
    assert line["params"]["pcs_kind"] == "whir"
    assert set(line["seconds"]) == {"keygen", "prove", "verify"}
    assert line["proof_bytes"] == len(zkvm_case["data"])
    checked = line["checked_on_device"]
    assert set(checked) == {"layers", "banks", "commits", "records", "whir g", "whir w",
                            "whir oracles", "whir trees"}
    assert min(checked.values()) > 0 and checked["whir g"] == checked["whir w"]
    # the witness and the fixed openings; each new oracle is g's 4 components
    assert len(line["openings"]) == 2
    iters = sum(o["iterations"] for o in line["openings"])
    assert iters == len(line["oracle_shapes"]) > 0
    assert all(s[0] == 4 for s in line["oracle_shapes"])
    spans_ = line["whir_spans"]
    assert spans_["whir/rounds"]["calls"] == iters + 2 == len(zkvm_case["lengths"])
    assert spans_["whir/encode"]["calls"] == spans_["whir/tree"]["calls"] == iters
    assert spans_["whir/grind"]["calls"] == spans_["whir/queries"]["calls"] == iters + 2
    assert "whir/rounds" in zkvm_case["report"]
    # the rejections, which chip_smoke runs in a worker of the untimed window
    assert chip_smoke.whir_rejects_job(zkvm_case["pk"].vk, zkvm_case["data"]) == {
        "query leaf": "WhirError", "OOD value": "WhirError", "final function": "WhirError"}
    # CPU tensors take the kernels' plain versions: nothing is launched
    assert all(v == 0 for path in line["launches"].values() for v in path.values())


def test_whir_zkvm_proof_matches_reference(zkvm_case):
    data, ref_data = zkvm_case["data"], zkvm_case["ref_data"]
    assert data == ref_data
    with open(chip_smoke.WHIR_GOLDEN) as f:
        want = json.load(f)["test_params"]
    assert want["setup"] == chip_smoke.whir_setup(ZK)
    assert chip_smoke.proof_digests(data, zkvm_case["pk"]) == {
        k: want[k] for k in ("proof_sha256", "proof_bytes", "vk_digest_sha256")}
    assert hashlib.sha256(ref_data).hexdigest() == want["proof_sha256"]
    # the port's proof read back verifies in both packages
    proof, pv, cfg, params = serialize.proof_from_bytes(data)
    op = next(iter(proof.witness_openings.values()))
    assert isinstance(op.opening, whir.WhirProof)
    assert serialize.proof_to_bytes(proof, pv, cfg, params) == data
    assert scheme.verify(zkvm_case["pk"].vk, proof) is True
    rproof, _, _, _ = rserialize.proof_from_bytes(data)
    assert rscheme.verify(zkvm_case["ref"].pk.vk, rproof)
