"""Port parity: the EC-sum quark (``gkr/eccquark.py``) against the reference.

On seeded septic points, exactly:

- ``build_tree_witness`` gives the reference's x, y, s columns and final
  sum at the reference test's (n_pts, n_rows) cases, and the final sum is
  the points' host sum;
- ``prove_ec_sum`` (the port on CPU tensors, the reference on its host
  paths), started from one exported transcript state, gives the same proof,
  the same point and the same end state;
- each ``verify_ec_sum`` accepts the other's proof and returns the same point
  and evals; both reject a wrong sum and a tampered tree;
- the quark's term table is within K6a's limits, and its export terms, which
  have no base factor, point at the ones column.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ceno_tpu.fields import septic as RS
from ceno_tpu.gkr import eccquark as RQ
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.sumcheck.verifier import SumcheckError as RSumcheckError
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.fields import septic as S
from ceno_tpu_torch.gkr import eccquark as Q
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.sumcheck import prover as sc_prover
from ceno_tpu_torch.sumcheck import terms as T
from ceno_tpu_torch.sumcheck.verifier import SumcheckError

torch.set_num_threads(1)
P = bb.P
CASES = [(8, 16), (5, 16), (1, 8), (13, 32)]


def _points(k: int, seed: int):
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    while len(xs) < k:
        trial = rng.integers(0, P, size=(2 * k + 4, 7), dtype=np.uint32).astype(np.uint64)
        y, ok = S.from_x(trial)
        for i in np.nonzero(ok)[0]:
            if len(xs) < k:
                xs.append(trial[i])
                ys.append(y[i])
    return np.stack(xs), np.stack(ys)


def _host_sum(xs, ys):
    acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    for i in range(xs.shape[0]):
        acc = S.point_add(acc, (xs[i], ys[i]))
    return np.stack(acc)


def _tree(n_pts: int, n_rows: int):
    xs, ys = _points(n_pts, 55 + n_pts)
    return Q.build_tree_witness(xs, ys, n_rows)


def _transcripts(seed: int):
    """The reference's transcript after a seeded absorb, and the port's from
    its exported state."""
    rt = RTranscript(b"ecc-test")
    rt.append(np.random.default_rng(seed).integers(0, P, size=9, dtype=np.uint64))
    return rt, Transcript.from_state(rt.export_state())


def _same_state(a, b) -> bool:
    (sa, *ra), (sb, *rb) = a.export_state(), b.export_state()
    return np.array_equal(sa, sb) and ra == rb


@pytest.mark.parametrize("n_pts,n_rows", CASES)
def test_tree_witness_equal(n_pts, n_rows):
    xs, ys = _points(n_pts, 55 + n_pts)
    got = Q.build_tree_witness(xs, ys, n_rows)
    want = RQ.build_tree_witness(xs, ys, n_rows)
    for g, w in zip(got, want):
        assert g.dtype == np.uint64 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[3], _host_sum(xs, ys))


@pytest.mark.parametrize("n_pts,n_rows", CASES)
def test_prove_ec_sum_equal(n_pts, n_rows):
    x, y, s, final = _tree(n_pts, n_rows)
    rt, pt = _transcripts(n_pts)
    want, want_rt = RQ.prove_ec_sum(x, y, s, n_pts, final, rt)
    got, got_rt = Q.prove_ec_sum(x, y, s, n_pts, final, pt, device="cpu")
    want = interop.ecc_proof_from_dict(dataclasses.asdict(want))
    assert (got.num_instances, got.n_vars) == (want.num_instances, want.n_vars)
    for name in ("round_msgs", "col_evals", "final_sum"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == np.uint64, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got_rt, want_rt)
    assert _same_state(pt, rt)


def test_each_verifier_accepts_the_others_proof():
    n_pts, n_rows = 11, 32
    x, y, s, final = _tree(n_pts, n_rows)
    rproof, _ = RQ.prove_ec_sum(x, y, s, n_pts, final, RTranscript(b"ecc-test"))
    pproof, _ = Q.prove_ec_sum(x, y, s, n_pts, final, Transcript(b"ecc-test"), device="cpu")
    got = Q.verify_ec_sum(interop.ecc_proof_from_dict(dataclasses.asdict(rproof)), final,
                          Transcript(b"ecc-test"))
    want = RQ.verify_ec_sum(pproof, final, RTranscript(b"ecc-test"))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_rejects_wrong_sum():
    n_pts, n_rows = 6, 16
    x, y, s, final = _tree(n_pts, n_rows)
    proof, _ = Q.prove_ec_sum(x, y, s, n_pts, final, Transcript(b"ecc-test"), device="cpu")
    bad = final.copy()
    bad[0, 0] = (int(bad[0, 0]) + 1) % P
    with pytest.raises(Q.EccError):
        Q.verify_ec_sum(proof, bad, Transcript(b"ecc-test"))
    with pytest.raises(RQ.EccError):
        RQ.verify_ec_sum(proof, bad, RTranscript(b"ecc-test"))
    # the claimed sum agrees with the public one, but the tree exports another point
    proof2, _ = Q.prove_ec_sum(x, y, s, n_pts, bad, Transcript(b"ecc-test"), device="cpu")
    with pytest.raises((Q.EccError, SumcheckError)):
        Q.verify_ec_sum(proof2, bad, Transcript(b"ecc-test"))
    with pytest.raises((RQ.EccError, RSumcheckError)):
        RQ.verify_ec_sum(proof2, bad, RTranscript(b"ecc-test"))


def test_rejects_tampered_tree():
    n_pts, n_rows = 6, 16
    x, y, s, final = _tree(n_pts, n_rows)
    x[0, n_rows - 2] = (int(x[0, n_rows - 2]) + 1) % P  # corrupt the root node
    proof, _ = Q.prove_ec_sum(x, y, s, n_pts, final, Transcript(b"ecc-test"), device="cpu")
    with pytest.raises((Q.EccError, SumcheckError)):
        Q.verify_ec_sum(proof, final, Transcript(b"ecc-test"))
    with pytest.raises((RQ.EccError, RSumcheckError)):
        RQ.verify_ec_sum(proof, final, RTranscript(b"ecc-test"))


def test_term_table_within_k6a_limits():
    sched, n_alpha = Q._term_schedule()
    assert n_alpha == Q.DEG * 7 and len(sched) == 455
    alphas = np.random.default_rng(3).integers(1, P, size=(n_alpha, 4), dtype=np.uint64)
    final = np.random.default_rng(4).integers(1, P, size=(2, 7), dtype=np.uint64)
    terms = Q._build_terms(alphas, final)
    bidx, eidx, scal, deg = sc_prover.compile_terms(terms, 49, 3)
    assert (bidx.shape[1], eidx.shape[1], deg) == (2, 1, 3)
    assert deg <= T.MAX_DEG and 1 <= bidx.shape[1] + eidx.shape[1] <= T.MAX_FACTORS
    export = [i for i, t in enumerate(terms) if not t.bidx]
    assert len(export) == 14 and all(terms[i].eidx == (2,) for i in export)
    assert (bidx[export] == 49).all()  # the ones column of the base bank


def test_cipolla_sqrt_of_zero_raises_in_both():
    """The batched Cipolla sqrt finds no non-residue for a zero element and
    raises after its 64 tries, in both packages (copied as it is)."""
    a = np.zeros((2, 7), np.uint64)
    a[1, 0] = 4
    with pytest.raises(RuntimeError, match="non-residue"):
        S.sqrt(a)
    with pytest.raises(RuntimeError, match="non-residue"):
        RS.sqrt(a)
