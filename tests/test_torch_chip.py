"""Port parity: the opcode chips' circuits, records, grouped towers and class
main zerochecks, against the reference, exactly.

- every chip of ``build_opcode_chips`` compiles to the same columns, slots and
  monomial terms;
- structural columns and the selector MLEs evaluate the same, over every
  StructuralSpec variant the reference's tests use;
- on ``fibonacci_vm(8)`` and ``fibonacci_vm(40)``: each active chip's records
  equal the reference's host record builder; the grouped towers (proofs, rt,
  claims), the class mains (proofs, openings) and the final transcript equal
  the reference's, run as ``chip_smoke.py``'s GKR phase runs them; each
  package's verifiers accept the other's proofs; MockProver passes on the
  port's witness;
- the committed reference digests (``tools/torch_gkr_golden.py``) still equal
  both packages' at ``fibonacci_vm(100)``, and chip_smoke's GKR phase runs end
  to end on the CPU.

The reference takes its host paths at these sizes (``CENO_TPU_HOST_N`` is
pinned by tests/conftest.py); the port runs its device code on CPU tensors.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.gkr import chip as rchip
from ceno_tpu.gkr import mock as rmock
from ceno_tpu.gkr import tower as rtower
from ceno_tpu.gkr.circuit_builder import StructuralSpec as RSpec
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm.chips.opcodes import build_opcode_chips as rbuild_opcode_chips
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import chip, mock, tower
from ceno_tpu_torch.gkr.circuit_builder import StructuralSpec
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.mle import ops
from ceno_tpu_torch.zkvm.chips.opcodes import build_opcode_chips

import chip_smoke

torch.set_num_threads(1)
P = rbb.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_gkr_golden", os.path.join(ROOT, "tools", "torch_gkr_golden.py"))
golden = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(golden)

CHIPS = [c.name for c in build_opcode_chips()]
SPECS = [  # every variant tests/test_chip.py uses
    dict(kind="incremental", start=100, step=3),
    dict(kind="incremental", start=900, step=7, descending=True),
    dict(kind="incremental_dynamic", start=1, step=4),
    dict(kind="stacked_incremental"),
    dict(kind="stacked_constant"),
    dict(kind="inner_repeat", k=2),
    dict(kind="outer_repeat", k=3),
    dict(kind="empty"),
]
FIB = [8, 40]


@pytest.fixture(scope="module")
def chips():
    return {c.name: c for c in build_opcode_chips()}, {c.name: c for c in rbuild_opcode_chips()}


@pytest.fixture(scope="module")
def fib_runs():
    """Both packages' GKR stages at each size of FIB: the port's on the CPU
    through chip_smoke, the reference's through the golden tool."""
    chip_smoke.DEVICE = "cpu"
    out = {}
    for n in FIB:
        vm, assigned, _ = chip_smoke.emulate_and_assign(n)
        pv = chip_smoke.public_values(vm)
        out[n] = (chip_smoke.gkr_prove(assigned, pv), assigned, pv, golden.reference_run(n))
    return out


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("name", CHIPS)
def test_compile_chip_matches_reference(name, chips):
    got, want = chips[0][name].compiled, chips[1][name].compiled
    assert (got.n_wit, got.n_fixed, got.n_cols) == (want.n_wit, want.n_fixed, want.n_cols)
    assert chips[0][name].cb.wit_names == chips[1][name].cb.wit_names
    assert [(s.kind, s.name, s.rec) for s in got.slots] == [
        (s.kind, s.name, s.rec) for s in want.slots]
    assert [repr(s.terms) for s in got.slots] == [repr(s.terms) for s in want.slots]
    assert chip.interleave_geometry(got) == rchip.interleave_geometry(want)
    assert chip.chip_digest(got) == rchip.chip_digest(want)


@pytest.mark.parametrize("spec", SPECS, ids=lambda d: "-".join(str(v) for v in d.values()))
def test_structural_columns_match_reference(spec):
    instances = _rand(1, 8) % 1000
    for n_vars in (1, 3, 5):
        np.testing.assert_array_equal(
            chip.structural_table(StructuralSpec(**spec), 1 << n_vars, instances),
            rchip.structural_table(RSpec(**spec), 1 << n_vars, instances))
        for seed in range(2):
            point = _rand((n_vars, seed), (n_vars, 4))
            np.testing.assert_array_equal(
                chip.structural_eval(StructuralSpec(**spec), point, instances),
                rchip.structural_eval(RSpec(**spec), point, instances))


@pytest.mark.parametrize("k", [0, 1, 5, 8, 11, 16])
def test_selector_evals_match_reference(k):
    point, rt = _rand(2, (4, 4)), _rand(3, (4, 4))
    np.testing.assert_array_equal(chip.sel_prefix_sum(point, k), rchip.sel_prefix_sum(point, k))
    np.testing.assert_array_equal(chip.sel_eq_eval(rt, point, k), rchip.sel_eq_eval(rt, point, k))
    # the masked eq column the prover builds has the verifier's MLE value
    eq = chip._masked_eq(bb.to_device(rt, "cpu"), k)
    got = bb.to_host(ops.evaluate(eq, bb.to_device(point, "cpu")))
    np.testing.assert_array_equal(got, chip.sel_eq_eval(rt, point, k))


@pytest.mark.parametrize("n", FIB)
def test_records_match_reference_host_builder(n, fib_runs):
    run, assigned, pv, ref = fib_runs[n]
    active = [a for a in assigned if a.num_instances]
    assert [a.name for a in active] == list(run["inputs"])
    ref_compiled = {a.name: a.compiled for a in ref["assigned"]}
    for a in active:
        ti = run["inputs"][a.name]
        empty = np.zeros((0, a.n_rows), np.uint64)
        want = rchip._build_records_host(ref_compiled[a.name], a.wit, empty, empty, pv,
                                         run["challenges"], a.num_instances, a.n_rows)
        got = ti.prods + [m for pq in ti.lps for m in pq]
        want = [w for w in want if w is not None]
        assert len(got) == len(want), a.name
        for g, w in zip(got, want):
            assert g.device.type == "cpu"
            np.testing.assert_array_equal(bb.to_host(g).T, w, err_msg=a.name)
        assert ti.n_tower == ref["inputs"][a.name].n_tower


@pytest.mark.parametrize("n", FIB)
def test_grouped_towers_and_class_mains_match_reference(n, fib_runs):
    run, _, _, ref = fib_runs[n]
    np.testing.assert_array_equal(run["challenges"], ref["challenges"])
    assert run["groups"] == ref["groups"] and run["classes"] == ref["classes"]
    for n_t in run["groups"]:
        assert interop.digest(dataclasses.asdict(run["towers"][n_t])) == interop.digest(
            dataclasses.asdict(ref["towers"][n_t]))
        # the group's tower from one state: equal rt and record claims
        ti = [run["inputs"][nm] for nm in run["groups"][n_t]]
        rti = [ref["inputs"][nm] for nm in run["groups"][n_t]]
        got = tower.prove_towers([m for t in ti for m in t.prods],
                                 [pq for t in ti for pq in t.lps], Transcript(b"group"))
        want = rtower.prove_towers([m for t in rti for m in t.prods],
                                   [pq for t in rti for pq in t.lps], RTranscript(b"group"))
        for g, w in zip([got[1], *got[2]], [want[1], *want[2]]):
            np.testing.assert_array_equal(g, w)
    for nm, ctx in run["ctxs"].items():
        np.testing.assert_array_equal(ctx.x_star, ref["ctxs"][nm].x_star)
        np.testing.assert_array_equal(np.stack(ctx.mults), np.stack(ref["ctxs"][nm].mults))
    for h in run["classes"]:
        assert interop.digest(dataclasses.asdict(run["mains"][h])) == interop.digest(
            dataclasses.asdict(ref["mains"][h]))
        for g, w in zip(run["openings"][h], ref["openings"][h]):
            assert interop.digest(dataclasses.asdict(g)) == interop.digest(dataclasses.asdict(w))
    for g, w in zip(run["transcript"].export_state(), ref["transcript"].export_state()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["add", "addi", "beq", "jal", "halt"])
def test_prove_chip_and_verify_chip_match_reference(name, fib_runs):
    """One chip on its own (records, its tower, its main zerocheck): equal
    proofs, openings and transcripts; each verify_chip accepts the other's
    proof."""
    run, assigned, pv, ref = fib_runs[8]
    a = next(x for x in assigned if x.name == name)
    ra = next(x for x in ref["assigned"] if x.name == name)
    empty = np.zeros((0, a.n_rows), np.uint64)
    t, rt_ = Transcript(b"one-chip"), RTranscript(b"one-chip")
    proof, opening = chip.prove_chip(a.compiled, a.wit, empty, empty, pv, a.num_instances,
                                     run["challenges"], t, device="cpu")
    rproof, ropening = rchip.prove_chip(ra.compiled, ra.wit, empty, empty, pv, ra.num_instances,
                                        run["challenges"], rt_)
    assert interop.digest(dataclasses.asdict(proof)) == interop.digest(dataclasses.asdict(rproof))
    assert interop.digest(dataclasses.asdict(opening)) == interop.digest(
        dataclasses.asdict(ropening))
    np.testing.assert_array_equal(t.export_state()[0], rt_.export_state()[0])
    d = dataclasses.asdict(rproof)
    as_port = chip.ChipProof(**dict(d, tower_proof=interop.tower_proof_from_dict(d["tower_proof"])))
    got = chip.verify_chip(a.compiled, as_port, pv, run["challenges"], Transcript(b"one-chip"))
    d = dataclasses.asdict(proof)
    as_ref = rchip.ChipProof(**dict(d, tower_proof=rtower.TowerProof(**d["tower_proof"])))
    want = rchip.verify_chip(ra.compiled, as_ref, pv, run["challenges"], RTranscript(b"one-chip"))
    np.testing.assert_array_equal(got[0].point, want[0].point)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def _reference_verify(ref_assigned, pv, proofs):
    """The reference's verifiers over plain-form proofs, in the prover's order;
    returns (final transcript, openings per class)."""
    t = RTranscript(rscheme.LABEL)
    t.append(pv)
    challenges = np.array([t.sample_ext(), t.sample_ext()], np.uint64)
    by_name = {a.name: a for a in ref_assigned}
    vctxs, openings = {}, {}
    for n_t, names in sorted(proofs["groups"].items()):
        entries = [(by_name[nm].compiled, by_name[nm].num_instances,
                    by_name[nm].n_rows.bit_length() - 1) for nm in names]
        out = rchip.verify_group_towers(entries, rtower.TowerProof(**proofs["towers"][n_t]),
                                        pv, challenges, t)
        vctxs.update(zip(names, (o[0] for o in out)))
    for h, names in sorted(proofs["classes"].items()):
        openings[h] = rchip.verify_class_main(
            [vctxs[nm] for nm in names], rchip.ClassMainProof(**proofs["mains"][h]),
            pv, challenges, t)
    return t, openings


def _plain(run):
    return {"groups": run["groups"], "classes": run["classes"],
            "towers": {k: dataclasses.asdict(v) for k, v in run["towers"].items()},
            "mains": {k: dataclasses.asdict(v) for k, v in run["mains"].items()}}


@pytest.mark.parametrize("n", FIB)
def test_each_packages_verifiers_accept_the_others_proofs(n, fib_runs):
    run, assigned, pv, ref = fib_runs[n]
    # the port's verifiers over the reference's proofs
    plain = _plain(ref)
    ref_as_port = dict(plain, towers={k: interop.tower_proof_from_dict(v)
                                      for k, v in plain["towers"].items()},
                       mains={k: interop.class_main_from_dict(v) for k, v in plain["mains"].items()})
    t, openings = chip_smoke.gkr_verify(assigned, pv, ref_as_port)
    np.testing.assert_array_equal(t.export_state()[0], ref["transcript"].export_state()[0])
    # the reference's verifiers over the port's proofs
    rt, ropenings = _reference_verify(ref["assigned"], pv, _plain(run))
    np.testing.assert_array_equal(rt.export_state()[0], run["transcript"].export_state()[0])
    for h in run["classes"]:
        for g, w, mine in zip(openings[h], ropenings[h], run["openings"][h]):
            got = interop.chip_opening_from_dict(dataclasses.asdict(w))
            for x in (g, got):
                np.testing.assert_array_equal(x.point, mine.point)
                np.testing.assert_array_equal(x.wit_evals, mine.wit_evals)


@pytest.mark.parametrize("n", FIB)
def test_changed_add_limb_is_rejected_by_both_verifiers(n, fib_runs):
    _, assigned, pv, ref = fib_runs[n]
    bad = chip_smoke.tamper_add(assigned)
    run = chip_smoke.gkr_prove(bad, pv)
    with pytest.raises(chip_smoke.SumcheckError):
        chip_smoke.gkr_verify(bad, pv, run)
    from ceno_tpu.sumcheck.verifier import SumcheckError as RSumcheckError
    with pytest.raises((RSumcheckError, rchip.ChipError)):
        _reference_verify(ref["assigned"], pv, _plain(run))


def _mock_rows(assigned, pv):
    return [(a.compiled, a.cb, a.wit, np.zeros((0, a.n_rows), np.uint64), pv, a.num_instances)
            for a in assigned if a.num_instances]


@pytest.mark.parametrize("n", FIB)
def test_mock_prover_passes_on_the_ports_witness(n, fib_runs):
    """No constraint fails on any row; the record and lookup multisets do not
    balance without the table chips (not ported yet), and the port's
    MockProver reports that exactly as the reference's does."""
    _, assigned, pv, ref = fib_runs[n]
    got = mock.MockProver.assert_satisfied(_mock_rows(assigned, pv), raise_on_error=False)
    assert [e.chip for e in got] == ["<global>", "<global>"]
    want = rmock.MockProver.assert_satisfied(_mock_rows(ref["assigned"], pv),
                                             raise_on_error=False)
    assert [dataclasses.astuple(e) for e in got] == [dataclasses.astuple(e) for e in want]
    bad = mock.MockProver.assert_satisfied(
        _mock_rows(chip_smoke.tamper_add(assigned), pv), raise_on_error=False)
    assert ("add", "add_lo", 0) in [(e.chip, e.constraint, e.row) for e in bad]


@pytest.mark.parametrize("side", ["reference", "port"])
def test_committed_gkr_digests_are_current(side):
    """The file chip_smoke checks on the card equals what both packages give
    here, so it cannot go stale."""
    with open(chip_smoke.GKR_GOLDEN) as f:
        want = json.load(f)
    assert want["program"] == f"fibonacci_vm({chip_smoke.GOLDEN_ITERS})"
    if side == "reference":
        got = chip_smoke.gkr_digests(golden.reference_run(chip_smoke.GOLDEN_ITERS))
        assert got == want["digests"]
    else:
        chip_smoke.DEVICE = "cpu"
        assert chip_smoke.gkr_golden_check() == want["digests"]
    assert chip_smoke.LABEL == rscheme.LABEL


def test_chip_smoke_gkr_phase_rehearsal_on_cpu():
    chip_smoke.DEVICE = "cpu"
    line = chip_smoke.run_gkr(40)
    assert line["steps"] == sum(chip_smoke.fib_rows(40).values())
    assert line["chips"]["addi"] == {"rows": 129, "height": 256}
    assert list(line["tower_groups"]) == ["2^4", "2^9", "2^10", "2^11"]
    assert line["tower_groups"]["2^11"] == {"chips": ["addi"], "levels": 10, "rounds": 55}
    assert list(line["classes"]) == ["2^1", "2^6", "2^8"]
    assert all(v > 0 for v in line["checked_on_device"].values())
    assert "records/addi" in line["span_report"]
    json.dumps(line)
