"""Port parity: row sharding over ``torch.distributed``
(``ceno_tpu_torch/parallel``) against the reference's single-device provers.

D spawned ``gloo`` ranks on the CPU (``parallel/sharded.run_ranks``: a
``file://`` rendezvous in a temporary directory, a 60 s timeout on every
collective, a deadline on the ranks' answers, no rank left running):

- ``prove_sharded`` with D = 2 and 4, base columns only (9 variables) and
  base + ext (10 variables), as ``tests/test_sharded.py`` sets them up, gives
  the reference's ``sumcheck.prover.prove`` messages, point and final evals
  on every rank; a sharded MLE evaluation (``parallel/chip._eval_layer_at``)
  gives the host evaluation;
- ``prove_chip_sharded`` of ``fibonacci_vm(40)``'s add chip with D = 2 and 4
  (``tests/test_sharded_chip.py``'s setup, which is ``slow`` there) writes
  the reference's ``gkr.chip.prove_chip`` bytes on every rank, and the
  reference's ``verify_chip`` accepts it; chip_smoke's rank job is the one
  that runs;
- a row count that is not a multiple of 2D and a rank count that is not a
  power of two are refused, a failing rank fails the caller, a rank that
  dies without an answer is found at once, and a rank that hangs is cut
  at the deadline.
"""

import dataclasses
import io
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceno_tpu.gkr.chip as rchip
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.fields import babybear as rbb
from ceno_tpu.gkr import tower as rtower
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.sumcheck import host_impl as RH
from ceno_tpu.sumcheck import prover as rprover
from ceno_tpu.sumcheck.prover import TermSpec as RTermSpec
from ceno_tpu.zkvm import serialize as rserialize
from ceno_tpu.zkvm.chips import build_all_chips as rbuild_all_chips
from ceno_tpu.zkvm.chips.opcodes import TraceView as RTraceView
from ceno_tpu.zkvm.e2e import public_values_from_vm as rpublic_values
from ceno_tpu.zkvm.witgen import assign_opcode_chips as rassign
from ceno_tpu_torch.fields import ext4_host as exth
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.parallel import chip as pchip
from ceno_tpu_torch.parallel import sharded
from ceno_tpu_torch.sumcheck.prover import TermSpec
from ceno_tpu_torch.zkvm import serialize

import chip_smoke

torch.set_num_threads(1)
P = 2013265921
TIMEOUT = 60


def _columns(n_vars: int, with_ext: bool):
    """Seeded canonical columns and terms: test_sharded.py's two cases."""
    rng = np.random.default_rng(77 + n_vars)
    if with_ext:
        base = [rng.integers(0, P, size=1 << n_vars, dtype=np.uint64) for _ in range(3)]
        ext = [rng.integers(0, P, size=(4, 1 << n_vars), dtype=np.uint64)]
        terms = [((3,), (0, 1), (0,)), ((7,), (2,), (0,))]
    else:
        base = [rng.integers(0, P, size=1 << n_vars, dtype=np.uint64) for _ in range(2)]
        ext = []
        terms = [((5,), (0, 1), ())]
    return base, ext, terms


def _sumcheck_rank(rank: int, n_vars: int, with_ext: bool) -> dict:
    base, ext, terms = _columns(n_vars, with_ext)
    mesh = sharded.make_mesh(device="cpu")
    specs = [TermSpec(exth.from_base(s[0]), bidx=b, eidx=e) for s, b, e in terms]
    out = sharded.prove_sharded(mesh, base, ext, specs, n_vars, Transcript(b"shard-test"))
    # a row-sharded MLE evaluated at a seeded point
    rng = np.random.default_rng(5)
    layer = rng.integers(0, P, size=(4, 1 << n_vars), dtype=np.uint64)
    point = rng.integers(0, P, size=(n_vars, 4), dtype=np.uint64)
    value = pchip._eval_layer_at(mesh, sharded.slab(mesh, layer), point)
    return {"out": out, "value": value}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n_vars,with_ext", [(9, False), (10, True)], ids=["base", "base+ext"])
def test_prove_sharded_matches_the_reference(d, n_vars, with_ext):
    base, ext, terms = _columns(n_vars, with_ext)
    specs = [RTermSpec(exth.from_base(s[0]), bidx=b, eidx=e) for s, b, e in terms]
    single = rprover.prove([jnp.asarray(rbb.np_to_monty(c.astype(np.uint32))) for c in base],
                           [jnp.asarray(rbb.np_to_monty(c.astype(np.uint32))) for c in ext],
                           specs, n_vars, RTranscript(b"shard-test"))
    rng = np.random.default_rng(5)
    layer = rng.integers(0, P, size=(4, 1 << n_vars), dtype=np.uint64)
    point = rng.integers(0, P, size=(n_vars, 4), dtype=np.uint64)
    eq = RH.build_eq_host(point)  # (N, 4)
    want_value = exth.dot(eq, layer.T)
    results = sharded.run_ranks(_sumcheck_rank, (n_vars, with_ext), world_size=d,
                                timeout=TIMEOUT)
    assert len(results) == d
    for res in results:
        out = res["out"]
        np.testing.assert_array_equal(out.proof.round_msgs, single.proof.round_msgs)
        np.testing.assert_array_equal(out.point, single.point)
        np.testing.assert_array_equal(out.final_base, single.final_base)
        np.testing.assert_array_equal(out.final_ext, single.final_ext)
        np.testing.assert_array_equal(res["value"], want_value)


CHAL = chip_smoke.SHARDED_CHALLENGES


@pytest.fixture(scope="module")
def add_chip(tmp_path_factory):
    """fibonacci_vm(40)'s add chip: the reference's witness (written for the
    ranks as chip_smoke writes it), proof and bytes."""
    vm = rprograms.fibonacci_vm(40)
    records = vm.run()
    (a,) = [c for c in rassign(RTraceView.from_records(records), rbuild_all_chips())
            if c.name == "add"]
    pv = rpublic_values(vm)
    n = a.wit.shape[1]
    fixed = structural = np.zeros((0, n), np.uint64)
    proof, opening = rchip.prove_chip(a.compiled, a.wit, fixed, structural, pv,
                                      a.num_instances, CHAL, RTranscript(chip_smoke.SHARDED_LABEL))
    buf = io.BytesIO()
    rserialize._encode(buf, proof, 0)
    for x in (opening.point, opening.wit_evals, opening.fixed_evals):
        buf.write(np.ascontiguousarray(x, np.uint64).tobytes())
    path = str(tmp_path_factory.mktemp("sharded") / "add.npz")
    np.savez(path, name=a.name, wit=a.wit, pv=pv, num_instances=a.num_instances)
    return a, pv, buf.getvalue(), path


@pytest.mark.parametrize("d", [2, 4])
def test_prove_chip_sharded_matches_the_reference(add_chip, d):
    a, pv, want, path = add_chip
    assert a.num_instances > 8 and a.wit.shape[1] % (2 * d) == 0
    results = sharded.run_ranks(chip_smoke.sharded_chip_job, (path, "cpu"), world_size=d,
                                timeout=TIMEOUT)
    for res in results:
        assert chip_smoke.chip_proof_bytes(res["proof"], res["opening"]) == want
    # the reference's verifier accepts rank 0's proof
    d0 = dataclasses.asdict(results[0]["proof"])
    d0["tower_proof"] = rtower.TowerProof(**d0["tower_proof"])
    opening, _, _ = rchip.verify_chip(a.compiled, rchip.ChipProof(**d0), pv, CHAL,
                                      RTranscript(chip_smoke.SHARDED_LABEL))
    np.testing.assert_array_equal(opening.point, results[0]["opening"].point)


def _refused_rank(rank: int, what: str):
    mesh = sharded.make_mesh(device="cpu")
    if what == "rows":
        sharded.shard_base_cols(mesh, [np.zeros(6, np.uint64)])  # 6 rows over 2 ranks
    return "not refused"


def test_bad_shapes_and_failing_ranks_raise():
    with pytest.raises(RuntimeError, match="multiple of 4"):
        sharded.run_ranks(_refused_rank, ("rows",), world_size=2, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="not a power of two"):
        sharded.run_ranks(_refused_rank, ("ranks",), world_size=3, timeout=TIMEOUT)


def _stuck_rank(rank: int, how: str):
    if rank == 1:
        if how == "dies":
            os._exit(3)
        time.sleep(60)  # hangs past the deadline
    return rank


@pytest.mark.parametrize("how,error", [("dies", RuntimeError), ("hangs", TimeoutError)])
def test_a_dead_or_stuck_rank_is_not_waited_for(how, error):
    t0 = time.monotonic()
    with pytest.raises(error, match="ranks \\[1\\]"):
        sharded.run_ranks(_stuck_rank, (how,), world_size=2, timeout=TIMEOUT, deadline=10)
    assert time.monotonic() - t0 < 40


def test_proof_bytes_helper_is_the_serializers():
    """chip_smoke's comparison covers the serialized proof and the opening."""
    proof = rchip.ChipProof(1, 1, rtower.TowerProof(np.zeros((0, 2, 4), np.uint64),
                                                     np.zeros((0, 2, 2, 4), np.uint64)),
                            np.zeros((1, 4, 4), np.uint64), np.zeros((2, 4), np.uint64),
                            np.zeros((0, 4), np.uint64), np.zeros((0, 4), np.uint64))
    buf = io.BytesIO()
    serialize._encode(buf, proof, 0)
    opening = pchip.ChipOpening(np.ones((1, 4), np.uint64), np.zeros((2, 4), np.uint64),
                                np.zeros((0, 4), np.uint64))
    got = chip_smoke.chip_proof_bytes(proof, opening)
    # the point's 1 x 4 and the wit evals' 2 x 4 words, 8 bytes each
    assert got.startswith(buf.getvalue()) and len(got) == len(buf.getvalue()) + 96
