"""Port parity: NTT encode, Merkle trees, Basefold and the jagged PCS.

The port runs on the CPU (its kernels' plain versions); the reference runs
its host path (tests/conftest.py pins CENO_TPU_HOST_N). Inputs come from
numpy seeds; codewords, Merkle levels, roots and the whole JaggedOpening are
compared exactly, and each package's verifier checks the other's opening,
with protocol state carried across through ceno_tpu_torch.interop.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.pcs import basefold as rbf
from ceno_tpu.pcs import jagged as rjg
from ceno_tpu.pcs import merkle as rmerkle
from ceno_tpu.pcs import ntt as rntt
from ceno_tpu.pcs import whir as rwhir
from ceno_tpu.sumcheck import host_impl as RH
from ceno_tpu.sumcheck.verifier import SumcheckError as RSumcheckError
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import jagged as jg
from ceno_tpu_torch.pcs import merkle
from ceno_tpu_torch.pcs import ntt
from ceno_tpu_torch.pcs import whir
from ceno_tpu_torch.sumcheck.verifier import SumcheckError

torch.set_num_threads(1)
P = rbb.P
SMALL = dict(blowup_log=1, n_queries=4, stop_size=32)  # default pow_bits
CLASSES = [(8, 5), (32, 3), (64, 2)]
LABEL = b"ceno-tpu/zkvm/v8"


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("c,log_n,blowup", [(1, 0, 1), (3, 4, 1), (2, 5, 3)])
def test_encode_matches_reference(c, log_n, blowup):
    evals = _rand(log_n, (c, 1 << log_n))
    want = rntt.np_encode(evals, blowup_log=blowup)
    got = bb.to_host(ntt.encode(bb.to_device(evals, "cpu"), blowup_log=blowup))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ntt.np_encode(evals, blowup_log=blowup), want)
    if log_n == 4:  # the reference's device encode, one small jit
        dev = rntt.encode(jnp.asarray(rbb.np_to_monty(evals)), blowup_log=blowup)
        np.testing.assert_array_equal(rbb.np_from_monty(np.asarray(dev)), want)


def test_transforms_and_twiddles_match_reference():
    x = _rand(1, (2, 64))
    xd = bb.to_device(x, "cpu")
    ref = lambda f: rbb.np_from_monty(np.asarray(f(jnp.asarray(rbb.np_to_monty(x)))))  # noqa: E731
    np.testing.assert_array_equal(bb.to_host(ntt.mobius(xd)), ref(rntt.mobius))
    np.testing.assert_array_equal(bb.to_host(ntt.ntt_natural(xd)), ref(rntt.ntt_natural))
    for log_m in (1, 2, 9):
        np.testing.assert_array_equal(ntt.domain_pow_inv(log_m), rntt.domain_pow_inv(log_m))
        np.testing.assert_array_equal(ntt.bitrev_perm(log_m), rntt.bitrev_perm(log_m))


@pytest.mark.parametrize("c,m", [(1, 1), (5, 64), (13, 128)])
def test_merkle_tree_matches_reference(c, m):
    cols = _rand(c + m, (c, m))
    leaves, levels = merkle.hash_and_tree(bb.to_device(cols, "cpu"))
    want_leaves = rmerkle.host_hash_leaves(cols)
    want_levels = rmerkle.host_build_levels(want_leaves)
    np.testing.assert_array_equal(bb.to_host(leaves), want_leaves)
    assert len(levels) == len(want_levels)
    for g, w in zip(levels, want_levels):
        np.testing.assert_array_equal(bb.to_host(g), w)
    tree = merkle.MerkleTree.from_device(leaves, levels)
    ref_tree = rmerkle.MerkleTree.build_host(cols)
    np.testing.assert_array_equal(tree.root, ref_tree.root)
    idx = [0, m - 1, m // 2]
    if m == 1:  # a single leaf is the root: no siblings
        assert tree.open_paths(idx).shape == (3, 0, 8)
    else:
        np.testing.assert_array_equal(tree.open_paths(idx), ref_tree.open_paths(idx))
    for i, path in zip(idx, tree.open_paths(idx)):
        assert rmerkle.verify_path(tree.root, i, cols[:, i], path)
    bad = cols[:, idx].T.copy()
    bad[0, 0] = (bad[0, 0] + 1) % P
    assert merkle.verify_paths(tree.root, idx, cols[:, idx].T, tree.open_paths(idx))
    assert not merkle.verify_paths(tree.root, idx, bad, tree.open_paths(idx))


def _ref_committed(d):
    """A reference host-path Committed from the plain form of a commitment."""
    tree = rmerkle.MerkleTree(d["leaves"], list(d["levels"]),
                              (d["levels"][-1] if d["levels"] else d["leaves"])[:, 0])
    return rbf.Committed(d["cols"], d["codeword"], tree, d["n_vars"])


def test_commit_matches_reference():
    mat = _rand(3, (6, 32))
    params = rbf.BasefoldParams(**SMALL)
    ref = rbf.commit(mat, params)
    port = bf.commit(mat, interop.params_from_dict(dataclasses.asdict(params)), device="cpu")
    d = interop.committed_to_numpy(port)
    np.testing.assert_array_equal(d["cols"], ref.cols)
    np.testing.assert_array_equal(d["codeword"], ref.codeword)
    np.testing.assert_array_equal(d["leaves"], ref.tree.leaf_digests)
    for g, w in zip(d["levels"], ref.tree.levels):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.root, ref.root)
    back = interop.committed_from_numpy(d, device="cpu")
    assert torch.equal(back.codeword, port.codeword) and np.array_equal(back.root, port.root)


def _assert_same(a, b, path="opening"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a, np.uint64), np.asarray(b, np.uint64),
                                      err_msg=path)


def test_open_batch_two_points_matches_reference():
    """K = 2 points: two fold chains, committed fold levels and a tail."""
    mat = _rand(4, (4, 64))
    params = rbf.BasefoldParams(**SMALL)
    pparams = bf.BasefoldParams(**SMALL)
    points = _rand(5, (2, 6, 4))
    claims = [rbf.Claim(0, 0, _rand(6, 4)), rbf.Claim(1, 2, _rand(7, 4)), rbf.Claim(0, 3, _rand(8, 4))]
    pclaims = [bf.Claim(c.point_idx, c.col_idx, c.value) for c in claims]
    ref = rbf.open_batch(rbf.commit(mat, params), points, claims, RTranscript(LABEL), params)
    port = bf.open_batch(bf.commit(mat, pparams, device="cpu"), points, pclaims,
                         Transcript(LABEL), pparams)
    assert len(port.fold_roots) > 0
    _assert_same(dataclasses.asdict(port), dataclasses.asdict(ref))


def _mle(col, z):
    eq = RH.build_eq_host(np.asarray(z, np.uint64))
    return (eq * col[:, None] % np.uint64(P)).sum(axis=0) % np.uint64(P)


@pytest.fixture(scope="module")
def jagged_case():
    rng = np.random.default_rng(11)
    arrs = [(h, rng.integers(0, P, size=(c, h), dtype=np.uint64)) for h, c in CLASSES]
    claims = []
    for h, a in arrs:
        z = rng.integers(0, P, size=(h.bit_length() - 1, 4), dtype=np.uint64)
        for row in a:
            claims.append(rjg.JaggedClaim(len(claims), z, _mle(row, z)))
    rlayout = rjg.plan_layout(CLASSES)
    mat = rjg.stack_matrix(rlayout, arrs)
    params = rbf.BasefoldParams(**SMALL)
    ref_committed = rbf.commit(mat, params)
    ref_open = rjg.open_jagged(ref_committed, rlayout, claims, RTranscript(LABEL), params)

    layout = interop.layout_from_dict(dataclasses.asdict(rlayout))
    pparams = interop.params_from_dict(dataclasses.asdict(params))
    pclaims = interop.claims_from_dicts([dataclasses.asdict(c) for c in claims])
    committed = bf.commit(jg.stack_matrix(layout, arrs), pparams, device="cpu")
    port_open = jg.open_jagged(committed, layout, pclaims, Transcript(LABEL), pparams)
    return dict(rlayout=rlayout, layout=layout, mat=mat, arrs=arrs, claims=claims,
                pclaims=pclaims, params=params, pparams=pparams, ref_committed=ref_committed,
                ref_open=ref_open, committed=committed, port_open=port_open)


def test_jagged_layout_and_stack_match_reference(jagged_case):
    c = jagged_case
    assert dataclasses.asdict(jg.plan_layout(CLASSES)) == dataclasses.asdict(c["rlayout"])
    np.testing.assert_array_equal(jg.stack_matrix(c["layout"], c["arrs"]), c["mat"])
    assert dataclasses.asdict(c["layout"]) == dataclasses.asdict(c["rlayout"])


def test_open_jagged_matches_reference_field_by_field(jagged_case):
    c = jagged_case
    np.testing.assert_array_equal(c["committed"].root, c["ref_committed"].root)
    _assert_same(dataclasses.asdict(c["port_open"]), dataclasses.asdict(c["ref_open"]))


def test_port_verifier_accepts_both_openings(jagged_case):
    c = jagged_case
    jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"], c["port_open"],
                     Transcript(LABEL), c["pparams"])
    ref_open = interop.opening_from_dict(dataclasses.asdict(c["ref_open"]))
    jg.verify_jagged(c["ref_committed"].root, c["layout"], c["pclaims"], ref_open,
                     Transcript(LABEL), c["pparams"])


def _to_ref_opening(d):
    o = d["opening"]
    queries = [rbf.QueryProof(**q) for q in o["queries"]]
    opening = rbf.OpeningProof(o["sumcheck_msgs"], o["fold_roots"], o["tail"],
                               o["point_evals"], queries, o["pow_nonce"])
    return rjg.JaggedOpening(d["trans_msgs"], d["v_evals"], opening)


def test_reference_verifier_accepts_port_opening(jagged_case):
    c = jagged_case
    ref_proof = _to_ref_opening(dataclasses.asdict(c["port_open"]))
    rjg.verify_jagged(c["committed"].root, c["rlayout"], c["claims"], ref_proof,
                      RTranscript(LABEL), c["params"])


def test_reference_opens_against_port_commitment(jagged_case):
    """The reference's prover, given the port's commitment carried across as
    plain arrays, gives an opening the port verifies."""
    c = jagged_case
    ref_committed = _ref_committed(interop.committed_to_numpy(c["committed"]))
    proof = rjg.open_jagged(ref_committed, c["rlayout"], c["claims"], RTranscript(LABEL),
                            c["params"])
    jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"],
                     interop.opening_from_dict(dataclasses.asdict(proof)),
                     Transcript(LABEL), c["pparams"])


def test_tampered_claims_and_proofs_are_rejected(jagged_case):
    c = jagged_case
    bad = list(c["pclaims"])
    bad[4] = jg.JaggedClaim(bad[4].slice_idx, bad[4].z, (bad[4].value + np.uint64(1)) % np.uint64(P))
    with pytest.raises(SumcheckError):
        jg.verify_jagged(c["committed"].root, c["layout"], bad, c["port_open"],
                         Transcript(LABEL), c["pparams"])
    with pytest.raises(RSumcheckError):
        rjg.verify_jagged(c["committed"].root, c["rlayout"],
                          [rjg.JaggedClaim(b.slice_idx, b.z, b.value) for b in bad],
                          _to_ref_opening(dataclasses.asdict(c["port_open"])),
                          RTranscript(LABEL), c["params"])
    d = dataclasses.asdict(c["port_open"])
    d["opening"]["queries"][0]["base_rows"][0, 0] ^= 1
    with pytest.raises(bf.PCSError):
        jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"],
                         interop.opening_from_dict(d), Transcript(LABEL), c["pparams"])
    d = dataclasses.asdict(c["port_open"])
    d["v_evals"][0, 0] = (d["v_evals"][0, 0] + 1) % P
    with pytest.raises(jg.JaggedError):
        jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"],
                         interop.opening_from_dict(d), Transcript(LABEL), c["pparams"])


def test_open_jagged_whir_matches_reference(jagged_case):
    """The WHIR inner opening (pcs_kind="whir") on the same commitments:
    the port's JaggedOpening equals the reference's field by field, each
    package's verifier accepts the other's, and a changed final function is
    rejected by both."""
    c = jagged_case
    params = rbf.BasefoldParams(**SMALL, pcs_kind="whir")
    pparams = interop.params_from_dict(dataclasses.asdict(params))
    ref = rjg.open_jagged(c["ref_committed"], c["rlayout"], c["claims"], RTranscript(LABEL),
                          params)
    port = jg.open_jagged(c["committed"], c["layout"], c["pclaims"], Transcript(LABEL), pparams)
    assert type(port.opening).__name__ == "WhirProof"
    _assert_same(dataclasses.asdict(port), dataclasses.asdict(ref))
    jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"],
                     interop.opening_from_dict(dataclasses.asdict(ref)), Transcript(LABEL),
                     pparams)
    rjg.verify_jagged(c["ref_committed"].root, c["rlayout"], c["claims"], port,
                      RTranscript(LABEL), params)
    d = dataclasses.asdict(port)
    d["opening"]["final_g"][0, 0] = (d["opening"]["final_g"][0, 0] + 1) % P
    bad = interop.opening_from_dict(d)
    with pytest.raises(whir.WhirError):
        jg.verify_jagged(c["committed"].root, c["layout"], c["pclaims"], bad,
                         Transcript(LABEL), pparams)
    with pytest.raises(rwhir.WhirError):
        rjg.verify_jagged(c["ref_committed"].root, c["rlayout"], c["claims"], bad,
                          RTranscript(LABEL), params)
