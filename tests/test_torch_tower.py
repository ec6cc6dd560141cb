"""Port parity: the GKR towers (product and logup layers, prove, verify).

Random product and logup records at N = 2^2..2^6, in three mixes, go through
the reference's host tower (``prove_towers_host``, which its ``prove_towers``
takes for numpy records) and the port's per-level torch path on the CPU. The
layers, the TowerProof (prod_out, logup_out, round messages, level evals),
the final point rt, the record claims and the transcript state afterwards
must be bit-equal; each package's ``verify_towers`` accepts the other's proof
and rejects one with a level eval changed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.fields import ext4_host as rexth
from ceno_tpu.gkr import tower as rtower
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import tower
from ceno_tpu_torch.hash.transcript import Transcript

torch.set_num_threads(1)
P = rbb.P
LABEL = b"tower-parity"
MIXES = {"prod3": (3, 0), "logup3": (0, 3), "prod2+logup2": (2, 2)}
CASES = [(log_n, mix) for log_n in range(2, 7) for mix in MIXES]


def _records(log_n: int, mix: str, seed: int = 0):
    """Canonical (N, 4) records: product columns, and (p, q) logup pairs
    with q nonzero."""
    rng = np.random.default_rng([seed, log_n, len(mix)])
    n_prod, n_logup = MIXES[mix]
    n = 1 << log_n
    rand = lambda: rng.integers(1, P, size=(n, 4), dtype=np.uint64)  # noqa: E731
    return [rand() for _ in range(n_prod)], [(rand(), rand()) for _ in range(n_logup)]


def _dev(x):
    return bb.to_device(x.T, "cpu")


def _both_proofs(log_n, mix):
    prods, lps = _records(log_n, mix)
    rt_ref = RTranscript(LABEL)
    ref = rtower.prove_towers(prods, lps, rt_ref)
    t = Transcript(LABEL)
    got = tower.prove_towers([_dev(v) for v in prods], [(_dev(p), _dev(q)) for p, q in lps], t)
    return prods, lps, ref, rt_ref, got, t


def _assert_proofs_equal(a, b):
    np.testing.assert_array_equal(a.prod_out, b.prod_out)
    np.testing.assert_array_equal(a.logup_out, b.logup_out)
    assert len(a.round_msgs) == len(b.round_msgs) and len(a.level_evals) == len(b.level_evals)
    for x, y in zip(a.round_msgs + a.level_evals, b.round_msgs + b.level_evals):
        np.testing.assert_array_equal(np.asarray(x, np.uint64), np.asarray(y, np.uint64))


@pytest.mark.parametrize("log_n,mix", CASES)
def test_layers_proof_point_and_claims_match_reference(log_n, mix):
    prods, lps, (rproof, rrt, rclaims), rt_ref, (proof, rt, claims), t = _both_proofs(log_n, mix)
    for v in prods:
        want = rtower._product_layers_host(v)
        got = tower.product_layers(_dev(v))
        assert len(got) == len(want) == log_n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(bb.to_host(g).T, w)
    for p, q in lps:
        wp, wq = rtower._logup_layers_host(p, q)
        gp, gq = tower.logup_layers(_dev(p), _dev(q))
        for g, w in zip(gp + gq, wp + wq):
            np.testing.assert_array_equal(bb.to_host(g).T, w)
    _assert_proofs_equal(proof, rproof)
    np.testing.assert_array_equal(rt, rrt)
    assert rt.shape == (log_n, 4)
    for g, w in zip(claims, rclaims):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(t.export_state(), rt_ref.export_state()):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("log_n,mix", CASES)
def test_each_verifier_accepts_the_others_proof_and_rejects_a_changed_eval(log_n, mix):
    prods, lps, (rproof, rrt, rclaims), _, (proof, rt, claims), _ = _both_proofs(log_n, mix)
    # the port's verifier over the reference's proof, and the other way round
    got = tower.verify_towers(interop.tower_proof_from_dict(dataclasses.asdict(rproof)),
                              log_n, Transcript(LABEL))
    want = rtower.verify_towers(rtower.TowerProof(**dataclasses.asdict(proof)),
                                log_n, RTranscript(LABEL))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], rt)
    np.testing.assert_array_equal(got[1], claims[0])
    np.testing.assert_array_equal(got[2], claims[1])
    # totals: the product of every record, the sum of every fraction
    for s, v in enumerate(prods):
        acc = np.array([1, 0, 0, 0], np.uint64)
        for row in v:
            acc = rexth.mul(acc, row)
        np.testing.assert_array_equal(got[3][s], acc)
    bad = interop.tower_proof_from_dict(dataclasses.asdict(proof))
    bad.level_evals[-1][0, 0] = (bad.level_evals[-1][0, 0] + np.uint64(1)) % np.uint64(P)
    with pytest.raises(tower.TowerError):
        tower.verify_towers(bad, log_n, Transcript(LABEL))
    with pytest.raises(rtower.TowerError):
        rtower.verify_towers(rtower.TowerProof(**dataclasses.asdict(bad)), log_n, RTranscript(LABEL))


def test_split_specs_orders_halves_per_layer():
    layers = [bb.to_device(np.arange(16, dtype=np.uint64).reshape(4, 4) + 100 * i, "cpu")
              for i in range(3)]
    got = bb.to_host(tower.split_specs(layers))  # (4, 6, 2)
    for i in range(3):
        base = np.arange(16, dtype=np.uint64).reshape(4, 4) + 100 * i
        np.testing.assert_array_equal(got[:, 2 * i], base[:, :2])
        np.testing.assert_array_equal(got[:, 2 * i + 1], base[:, 2:])
