"""Port parity: Poseidon2, the Merkle kernels' plain versions and the transcript.

The torch permutation and the plain versions of K1 (leaf sponge) and K2 (level
compression) are held against the reference's host permutation, its Pallas
kernels in interpret mode and its host Merkle mirrors; the CUDA source's
constant tables against the protocol tables; the transcript against the
reference's after a scripted absorb/sample sequence and a PoW grind. All
comparisons are exact.
"""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.hash import poseidon2 as rp2
from ceno_tpu.hash import poseidon2_pallas as rpp
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.pcs import merkle as rmerkle
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2 as p2
from ceno_tpu_torch.hash import poseidon2_merkle as pm
from ceno_tpu_torch.hash import transcript as ptranscript
from ceno_tpu_torch.hash.transcript import Transcript

torch.set_num_threads(1)
P = rbb.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, ".commit_cache", "commit-8cc386001f1b61172778f21844b7e769.npz")


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_tables_are_the_reference_tables():
    assert p2.RC_EXTERNAL == rp2.RC_EXTERNAL
    assert p2.RC_INTERNAL == rp2.RC_INTERNAL
    assert p2.INTERNAL_DIAG == rp2.INTERNAL_DIAG
    np.testing.assert_array_equal(p2.RC_EXTERNAL_M, rp2._RC_EXTERNAL_M)
    np.testing.assert_array_equal(p2.RC_INTERNAL_M, rp2._RC_INTERNAL_M)
    np.testing.assert_array_equal(p2.DIAG_M, rp2._DIAG_M)


def test_cuda_source_tables_match():
    """The __constant__ tables and field constants in the CUDA sources (the
    headers csrc/babybear.cuh and csrc/poseidon2.cuh, which the kernel
    sources include) are the Montgomery forms of the protocol tables."""
    csrc = os.path.join(ROOT, "ceno_tpu_torch", "csrc")
    src = "".join(open(os.path.join(csrc, f)).read()
                  for f in ("babybear.cuh", "poseidon2.cuh", "poseidon2_merkle.cu"))
    assert '#include "babybear.cuh"' in src and '#include "poseidon2.cuh"' in src

    def table(name):
        body = re.search(name + r"\[[^\]]*\](?:\[[^\]]*\])?\s*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(v) for v in re.findall(r"(\d+)u", body)]
    assert table("RC_EXT") == p2.RC_EXTERNAL_M.ravel().tolist()
    assert table("RC_INT") == p2.RC_INTERNAL_M.tolist()
    assert table("DIAG") == p2.DIAG_M.tolist()
    assert f"P = {bb.P}u" in src and f"PINV = {bb.PINV}u" in src
    pinv_pos = int(re.search(r"PINV_POS = (\d+)u", src).group(1))
    assert bb.P * pinv_pos % (1 << 32) == 1 and (pinv_pos + bb.PINV) % (1 << 32) == 0
    assert f"MONTY_15 = {bb.const(15)}u" in src


@pytest.mark.parametrize("shape", [(16,), (16, 37)])
def test_permutation_matches_reference(shape):
    state = _rand(1, shape)
    want = rp2.permute_host(state)
    np.testing.assert_array_equal(p2.permute_host(state), want)
    np.testing.assert_array_equal(bb.to_host(p2.permute(bb.to_device(state, "cpu"))), want)
    edges = np.array([0, 1, P - 1] * 5 + [P - 1], np.uint64)
    np.testing.assert_array_equal(p2.permute_host(edges), rp2.permute_host(edges))


def test_sponge_helpers_match_reference():
    for n in (0, 1, 7, 8, 9, 61):
        e = _rand(n, n)
        np.testing.assert_array_equal(p2.hash_elements_host(e), rp2.hash_elements_host(e))
    a, b = _rand(2, 8), _rand(3, 8)
    np.testing.assert_array_equal(p2.compress_host(a, b), rp2.compress_host(a, b))


@pytest.mark.parametrize("c", [0, 1, 8, 13, 61])
def test_plain_leaf_sponge_matches_host_mirror(c):
    cols = _rand(10 + c, (c, 64))
    got = bb.to_host(pm.leaf_sponge_plain(bb.to_device(cols, "cpu")))
    np.testing.assert_array_equal(got, rmerkle.host_hash_leaves(cols))


@pytest.mark.parametrize("c", [1, 8, 13])
def test_plain_leaf_sponge_matches_pallas_interpret(c):
    cols = _rand(20 + c, (c, rpp.TILE))
    want = rbb.np_from_monty(np.asarray(rpp.leaf_sponge(
        jnp.asarray(rbb.np_to_monty(cols)), interpret=True))).astype(np.uint64)
    got = bb.to_host(pm.leaf_sponge(bb.to_device(cols, "cpu")))  # CPU tensor: plain
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [64, 2 * rpp.TILE])
def test_plain_compress_level_matches_pallas_interpret(m):
    """Below 2 * TILE the reference falls back to its scan path; at it, the
    Pallas kernel runs. K2 takes both sizes."""
    level = _rand(30 + m, (8, m))
    want = rbb.np_from_monty(np.asarray(rpp.compress_level(
        jnp.asarray(rbb.np_to_monty(level)), interpret=True))).astype(np.uint64)
    got = bb.to_host(pm.compress_level(bb.to_device(level, "cpu")))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rmerkle.host_build_levels(level)[0])


def test_plain_level_chain_matches_host_levels():
    leaves = _rand(40, (8, 256))
    cur, got = bb.to_device(leaves, "cpu"), []
    while cur.shape[1] > 1:
        cur = pm.compress_level_plain(cur)
        got.append(bb.to_host(cur))
    want = rmerkle.host_build_levels(leaves)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_plain_kernels_reproduce_committed_golden_tree():
    """The fixed-column commitment in .commit_cache: the plain K1 on a window of
    its codeword gives its leaves, and the plain K2 takes each of its small
    levels to the next, up to the root."""
    with np.load(GOLDEN) as z:
        cw = z["cw"][:, :1024].astype(np.uint64)
        leaves = z["leaves"][:, :1024].astype(np.uint64)
        n = int(z["n_levels"])
        levels = [z[f"level{i}"].astype(np.uint64) for i in range(n - 11, n)]
    got = bb.to_host(pm.leaf_sponge_plain(bb.to_device(cw, "cpu")))
    np.testing.assert_array_equal(got, leaves)
    for lo, hi in zip(levels, levels[1:]):
        np.testing.assert_array_equal(
            bb.to_host(pm.compress_level_plain(bb.to_device(lo, "cpu"))), hi)


def test_wrappers_use_plain_on_cpu_and_never_fall_back(monkeypatch):
    cols = _rand(50, (13, 32))
    before = dict(pm.LAUNCHES)
    x = bb.to_device(cols, "cpu")
    assert torch.equal(pm.leaf_sponge(x), pm.leaf_sponge_plain(x))
    leaves = pm.leaf_sponge(x)
    tree = pm.merkle_levels(leaves)
    assert all(torch.equal(a, b) for a, b in zip(tree, pm.merkle_levels_plain(leaves)))
    assert pm.LAUNCHES == before  # CPU tensors launch nothing
    with pytest.raises(ValueError):
        pm.compress_level(bb.to_device(_rand(51, (8, 3)), "cpu"))
    # a tensor on any device other than the CPU goes to the kernel or raises;
    # with the plain versions made to fail, the error is the wrapper's own
    for name in ("leaf_sponge_plain", "compress_level_plain", "merkle_levels_plain"):
        monkeypatch.setattr(pm, name, lambda *a: pytest.fail("plain version on a non-CPU tensor"))
    with pytest.raises(ValueError):
        pm.leaf_sponge(torch.empty((13, 32), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        pm.compress_level(torch.empty((8, 32), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        pm.merkle_levels(torch.empty((8, 32), dtype=torch.int32, device="meta"))
    assert pm.LAUNCHES == before


def _script(t):
    """A scripted absorb/sample sequence; returns everything sampled."""
    out = []
    t.append([5, 6, 7])
    out.append(t.sample_base())
    t.append(np.arange(19, dtype=np.uint64))  # wraps the rate twice
    out.extend(t.sample_ext())
    out.extend(t.sample_exts(3).ravel().tolist())
    out.extend(t.sample_ext_pows(4).ravel().tolist())
    t.append_ext([1, 2, 3, 4])
    f = t.fork(3)
    out.extend(f.sample_ext())
    out.extend(t.clone().sample_ext())
    for _ in range(9):  # exhausts the squeeze window
        out.append(t.sample_base())
    return [int(v) for v in out]


def test_transcript_matches_reference():
    rt, pt = RTranscript(b"ceno-tpu/zkvm/v8"), Transcript(b"ceno-tpu/zkvm/v8")
    assert _script(pt) == _script(rt)
    rs, ps = rt.export_state(), pt.export_state()
    np.testing.assert_array_equal(ps[0], rs[0])
    assert ps[1:] == rs[1:]
    # state carried across from the reference continues identically
    pt2 = Transcript.from_state(rt.export_state())
    rt.append([11])
    pt2.append([11])
    assert pt2.sample_ext() == rt.sample_ext()


def test_grind_nonce_matches_reference():
    rt, pt = RTranscript(b"grind"), Transcript(b"grind")
    rt.append([1, 2, 3])
    pt.append([1, 2, 3])
    nonce = pt.grind(16)
    assert nonce == rt.grind(16)
    assert pt.sample_base() == rt.sample_base()
    rv = RTranscript(b"grind")
    rv.append([1, 2, 3])
    assert rv.check_grind(nonce, 16)


def test_check_grind_replays_grind():
    pt, vt = Transcript(b"g"), Transcript(b"g")
    nonce = pt.grind(12)
    assert vt.check_grind(nonce, 12)
    assert pt.sample_base() == vt.sample_base()


def test_grind_is_bounded(monkeypatch):
    """A broken hash makes grind raise after 2^(pow_bits + 10) candidates."""
    broken = lambda st: np.full_like(np.asarray(st, np.uint64), P - 1)  # noqa: E731
    monkeypatch.setattr(ptranscript.p2, "permute_host", broken)
    with pytest.raises(RuntimeError, match="no nonce"):
        Transcript().grind(4)
