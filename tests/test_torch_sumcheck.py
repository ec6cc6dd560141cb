"""Port parity: MLE ops, the sumcheck round kernels, prover and verifier.

The torch round kernels are held against the numpy host mirror in both
packages, and the whole prover against the reference's (host path, pinned by
tests/conftest.py): round messages, point and final evaluations are compared
exactly, and each verifier accepts the other's messages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.mle import ops as rops
from ceno_tpu.sumcheck import host_impl as RH
from ceno_tpu.sumcheck import prover as rprover
from ceno_tpu.sumcheck import verifier as rverifier
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.mle import ops
from ceno_tpu_torch.sumcheck import host_impl as H
from ceno_tpu_torch.sumcheck import prover, terms, verifier

torch.set_num_threads(1)
P = rbb.P
LABEL = b"sumcheck"


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_build_eq_and_evaluate_match_reference():
    point = _rand(1, (5, 4))
    want = RH.build_eq_host(point)  # (32, 4)
    got = bb.to_host(ops.build_eq(bb.to_device(point, "cpu"))).T
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(H.build_eq_host(point), want)
    scale = _rand(2, 4)
    np.testing.assert_array_equal(
        bb.to_host(ops.build_eq(bb.to_device(point, "cpu"), bb.to_device(scale, "cpu"))).T,
        RH.build_eq_host(point, scale))
    col = _rand(3, 32)
    ref_eval = rbb.np_from_monty(np.asarray(rops.evaluate(
        jnp.asarray(rbb.np_to_monty(col)), jnp.asarray(rbb.np_to_monty(point)))))
    np.testing.assert_array_equal(
        bb.to_host(ops.evaluate(bb.to_device(col, "cpu"), bb.to_device(point, "cpu"))), ref_eval)


def _banks(seed, n_base, n_ext, n):
    base = [_rand(seed + i, n) for i in range(n_base)]
    ext = [_rand(seed + 100 + i, (n, 4)) for i in range(n_ext)]
    return base, ext


def test_round_kernels_match_host_mirrors():
    base, ext = _banks(10, 3, 2, 16)
    term_list = [prover.TermSpec(_rand(20, 4), bidx=(0, 2), eidx=(1,)),
                 prover.TermSpec(_rand(21, 4), bidx=(1,)),
                 prover.TermSpec(_rand(22, 4), eidx=(0, 1))]
    bidx, eidx, scal, deg = prover.compile_terms(term_list, 3, 2)
    ref_c = rprover.compile_terms(
        [rprover.TermSpec(t.scalar, t.bidx, t.eidx) for t in term_list], 3, 2)
    for a, b in zip((bidx, eidx, scal, deg), ref_c):
        np.testing.assert_array_equal(a, b)
    hb, he = H.make_banks_host(base, ext, 16)
    rb, re_ = RH.make_banks_host(base, ext, 16)
    np.testing.assert_array_equal(hb, rb)
    np.testing.assert_array_equal(he, re_)
    want = RH.round_evals_host(rb, re_, bidx, eidx, scal, deg)
    np.testing.assert_array_equal(H.round_evals_host(hb, he, bidx, eidx, scal, deg), want)
    tb, te = terms.make_banks([bb.to_device(c, "cpu") for c in base],
                              [bb.to_device(c.T, "cpu") for c in ext], 16)
    t = lambda a: torch.from_numpy(a.astype(np.int64))  # noqa: E731
    got = terms.round_evals(tb, te, t(bidx), t(eidx), bb.to_device(scal.T, "cpu"), deg=deg)
    np.testing.assert_array_equal(bb.to_host(got), want)
    r = _rand(30, 4)
    merged_want = RH.fold_banks_host(rb, re_, r)  # (C, 8, 4)
    merged = terms.fold_banks(tb, te, bb.to_device(r, "cpu"))
    np.testing.assert_array_equal(bb.to_host(merged).transpose(1, 2, 0), merged_want)
    np.testing.assert_array_equal(H.fold_banks_host(hb, he, r), merged_want)
    r2 = _rand(31, 4)
    np.testing.assert_array_equal(
        bb.to_host(terms.fold_ext_bank(merged, bb.to_device(r2, "cpu"))).transpose(1, 2, 0),
        RH.fold_ext_bank_host(merged_want, r2))
    midx = terms.merge_indices(bidx, eidx, 3, 2)
    np.testing.assert_array_equal(
        bb.to_host(terms.round_evals_ext(merged, t(midx), bb.to_device(scal.T, "cpu"), deg=deg)),
        RH.round_evals_host(np.ones((1, 8), np.uint64), merged_want,
                            np.zeros((scal.shape[0], 0), np.int32), midx, scal, deg))


@pytest.mark.parametrize("n_vars,blocks", [(0, False), (1, False), (5, False), (6, True)])
def test_prove_matches_reference_and_cross_verifies(n_vars, blocks):
    """Mixed base/ext terms of degree 1..4 with pow2 padding; ext columns are
    passed as (4, k, N) blocks in one case."""
    n = 1 << n_vars
    base, ext = _banks(40 + n_vars, 3, 3, n)
    term_list = [prover.TermSpec(_rand(50, 4), bidx=(0,), eidx=(0,)),
                 prover.TermSpec(_rand(51, 4), bidx=(1, 2), eidx=(1, 2)),
                 prover.TermSpec(_rand(52, 4), bidx=(2,)),
                 prover.TermSpec(_rand(53, 4), eidx=(2, 0, 1)),
                 prover.TermSpec(_rand(54, 4), bidx=(0, 1, 2), eidx=(0,))]
    rterms = [rprover.TermSpec(t.scalar, t.bidx, t.eidx) for t in term_list]
    ref = rprover.prove(base, ext, rterms, n_vars, RTranscript(LABEL))
    pbase = [bb.to_device(c, "cpu") for c in base]
    if blocks:
        pext = [bb.to_device(np.stack([c.T for c in ext], axis=1), "cpu")]  # (4, 3, N)
    else:
        pext = [bb.to_device(c.T, "cpu") for c in ext]
    out = prover.prove(pbase, pext, term_list, n_vars, Transcript(LABEL))
    np.testing.assert_array_equal(out.proof.round_msgs, ref.proof.round_msgs)
    np.testing.assert_array_equal(out.point, ref.point)
    np.testing.assert_array_equal(out.final_base, ref.final_base)
    np.testing.assert_array_equal(out.final_ext, ref.final_ext)
    if n_vars == 0:
        return
    claim = RH.round_evals_host(*RH.make_banks_host(base, ext, n),
                                *rprover.compile_terms(rterms, 3, 3)[:3], 4)
    claim = (claim[0] + claim[1]) % np.uint64(P)
    point, final = verifier.verify(claim, out.proof.round_msgs, n_vars, Transcript(LABEL), deg=4)
    rpoint, rfinal = rverifier.verify(claim, out.proof.round_msgs, n_vars, RTranscript(LABEL), deg=4)
    np.testing.assert_array_equal(point, out.point)
    np.testing.assert_array_equal(point, rpoint)
    np.testing.assert_array_equal(final, rfinal)
    bad = out.proof.round_msgs.copy()
    bad[0, 0, 0] = (bad[0, 0, 0] + 1) % P
    with pytest.raises(verifier.SumcheckError):
        verifier.verify(claim, bad, n_vars, Transcript(LABEL), deg=4)


def test_lagrange_extrapolate_matches_reference():
    ys, r = _rand(60, (4, 4)), _rand(61, 4)
    np.testing.assert_array_equal(verifier.lagrange_extrapolate(ys, r),
                                  rverifier.lagrange_extrapolate(ys, r))
