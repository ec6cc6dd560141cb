"""The Goldilocks commit kernels K14a (encode), K14b (leaf sponge) and K14c
(Merkle levels) on the CPU.

Their plain torch versions (gl/device.py) are held against the reference's
host mirrors, ``ceno_tpu/gl/pcs.encode`` and ``GlTree.build`` (the
reference's own XLA device functions are never run here: XLA compiles their
chained 2-limb arithmetic pathologically on the CPU). Then
``csrc/gl_commit.cu`` itself is compiled with the host C++ compiler against
``tests/cuda_host/cuda_runtime.h`` (a launch's blocks one after the other,
each block's threads as threads, ``__umul64hi`` on ``unsigned __int128``)
and driven through the wrappers' ``launch_*`` functions with CPU tensors,
against the plain versions, as tests/test_torch_sumcheck_kernels.py does
for csrc/sumcheck.cu. The card's own compiler and memory model are not
exercised: ``chip_smoke.py`` holds the same kernels against the same plain
versions on the card. All comparisons are exact.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceno_tpu.gl import pcs as rpcs
from ceno_tpu_torch.fields import goldilocks as gld
from ceno_tpu_torch.gl import device as gdev
from ceno_tpu_torch.gl import pcs
from ceno_tpu_torch.gl import poseidon2 as p2
from ceno_tpu_torch.utils import cuda_build

torch.set_num_threads(1)
P = gld.P
HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH = re.compile(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\(", re.S)
EDGE_VALUES = [0, P - 1, (1 << 32) - 1, 1 << 32]


def _words(rng, shape):
    return rng.integers(0, P, size=shape, dtype=np.uint64)


def _t(x):
    return gld.to_device(x, "cpu")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/gl_commit.cu compiled for the host, its C signatures declared."""
    out = tmp_path_factory.mktemp("gl_commit_host")
    for f in os.listdir(cuda_build.CSRC_DIR):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(cuda_build.CSRC_DIR, f), out)
    with open(os.path.join(cuda_build.CSRC_DIR, "gl_commit.cu")) as f:
        src = LAUNCH.sub(r"run_kernel(Launch(\2), \1, ", f.read())
    (out / "gl_commit.cpp").write_text(src)
    so = out / "libgl_commit_host.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", os.path.join(HERE, "cuda_host"), "-o", str(so),
                    str(out / "gl_commit.cpp")], check=True, capture_output=True)
    return gdev.declare(ctypes.CDLL(str(so)))


def _host_encode(lib, evals, blowup_log):
    log_m = (evals.shape[1] << blowup_log).bit_length() - 1
    tw = torch.empty(max(1, 1 << max(log_m - 1, 0)), dtype=gld.DTYPE)
    if log_m:
        gdev.launch_twiddles(lib, None, tw, log_m)
    out = torch.empty((evals.shape[0], evals.shape[1] << blowup_log), dtype=gld.DTYPE)
    gdev.launch_encode(lib, None, evals, tw, out, blowup_log)
    return tw[: 1 << (log_m - 1)] if log_m else tw[:0], out


def _host_levels(lib, leaves):
    m = leaves.shape[1]
    out = torch.empty(4 * (m - 1), dtype=gld.DTYPE)
    if m > 1:
        gdev.launch_merkle_levels(lib, None, leaves, out)
    return gdev.level_views(out, m)


# -- plain versions against the reference's host mirrors -------------------------

@pytest.mark.parametrize("shape", [(5, 5, 2), (3, 7, 1), (1, 0, 1), (2, 1, 0), (26, 4, 3)])
def test_encode_plain_matches_reference(shape):
    c, log_n, blowup = shape
    cols = _words(np.random.default_rng(list(shape)), (c, 1 << log_n))
    assert np.array_equal(gld.to_host(gdev.encode_plain(_t(cols), blowup)),
                          rpcs.encode(cols, blowup))
    # the wrapper takes the plain version for a CPU tensor
    assert np.array_equal(gld.to_host(pcs.encode(_t(cols), blowup)), rpcs.encode(cols, blowup))


@pytest.mark.parametrize("shape", [(7, 5), (26, 6), (2, 4), (1, 0), (4, 3)])
def test_tree_plain_matches_reference(shape):
    c, log_m = shape
    cw = _words(np.random.default_rng(list(shape)), (c, 1 << log_m))
    want = rpcs.GlTree.build(cw)
    got = pcs.GlTree.build(_t(cw))
    assert len(got.levels) == len(want.levels)
    for a, b in zip(got.levels, want.levels):
        assert np.array_equal(gld.to_host(a), b)
    assert np.array_equal(got.root, want.root)
    idxs = list(range(0, 1 << log_m, max(1, (1 << log_m) // 5)))
    paths = got.open_paths(idxs)
    for i, idx in enumerate(idxs):
        assert np.array_equal(paths[i], want.open_path(idx))
        assert np.array_equal(got.open_path(idx), want.open_path(idx))
        assert pcs._verify_path(got.root, idx, pcs._leaf_digest(cw[:, idx]), paths[i])


def test_commit_matches_reference():
    cols = _words(np.random.default_rng(9), (6, 1 << 5))
    want = rpcs.commit(cols, rpcs.GlParams(blowup_log=2))
    got = pcs.commit(cols, pcs.GlParams(blowup_log=2), device="cpu")
    assert np.array_equal(got.root, want.root)
    assert np.array_equal(gld.to_host(got.codeword), want.codeword)
    cw, tree = gdev.commit_device(_t(cols), 2)
    assert np.array_equal(gld.to_host(cw), want.codeword) and np.array_equal(tree.root, want.root)


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError):
        gdev.encode(torch.zeros((2, 3), dtype=gld.DTYPE), 1)       # not a power of two
    with pytest.raises(ValueError):
        gdev.leaf_sponge(torch.zeros((2, 4), dtype=torch.int32))   # not int64
    with pytest.raises(ValueError):
        gdev.merkle_levels(torch.zeros((8, 4), dtype=gld.DTYPE))   # not 4 rows
    with pytest.raises(ValueError):
        gdev.merkle_levels(torch.zeros((4, 6), dtype=gld.DTYPE))
    with pytest.raises(ValueError):
        gdev.leaf_sponge(torch.zeros((4, 8), dtype=gld.DTYPE)[:, ::2])  # not contiguous


def test_launch_counts_follow_the_plan():
    """K14c: one launch per level while the level below has more than
    K14C_TOP digests, then one; K14a: gather, Moebius stages, spread, DIT
    stages. The counts the wrappers add (chip_smoke reads them)."""
    top = gdev.K14C_TOP.bit_length() - 1
    assert [gdev.merkle_launches(1 << k) for k in range(top + 3)] == \
        [0] + [1] * top + [2, 3]
    assert gdev.merkle_launches(1 << 21) == 21 - top + 1
    assert gdev.encode_launches(18, 21) == 41
    src = open(os.path.join(cuda_build.CSRC_DIR, "gl_commit.cu")).read()
    assert re.search(r"constexpr int K14C_TOP = (\d+);", src).group(1) == str(gdev.K14C_TOP)
    assert "gl_commit" in cuda_build.SOURCES


def test_cuda_source_tables_match():
    """csrc/poseidon2_gl.cuh carries gl/poseidon2.py's tables word for word."""
    src = open(os.path.join(cuda_build.CSRC_DIR, "poseidon2_gl.cuh")).read()

    def table(name):
        body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", src, re.S).group(1)
        return [int(x, 16) for x in re.findall(r"0x([0-9a-f]+)ull", body)]

    assert table("RC_EXTERNAL") == [c for row in p2.RC_EXTERNAL for c in row]
    assert table("RC_INTERNAL") == p2.RC_INTERNAL
    assert table("INTERNAL_DIAG") == p2.INTERNAL_DIAG
    for name, v in (("WIDTH", 8), ("RATE", 4), ("DIGEST", 4), ("ROUNDS_F", 8), ("ROUNDS_P", 22)):
        assert re.search(rf"constexpr int {name} = (\d+);", src).group(1) == str(v)
    field = open(os.path.join(cuda_build.CSRC_DIR, "goldilocks.cuh")).read()
    assert int(re.search(r"P = 0x([0-9A-F]+)ull", field).group(1), 16) == P


# -- the CUDA source, compiled for the host, against the plain versions -----------

@pytest.mark.parametrize("shape", [(5, 5, 2), (26, 4, 3), (1, 0, 1), (3, 3, 0), (2, 6, 1)])
def test_encode_kernel_matches_plain(lib, shape):
    c, log_n, blowup = shape
    evals = _t(_words(np.random.default_rng(list(shape)), (c, 1 << log_n)))
    tw, out = _host_encode(lib, evals, blowup)
    assert torch.equal(tw, gdev.top_twiddles_plain(log_n + blowup, "cpu"))
    assert torch.equal(out, gdev.encode_plain(evals, blowup))


@pytest.mark.parametrize("shape", [(26, 6), (2, 7), (1, 2), (7, 0), (4, 3), (5, 1)])
def test_leaf_sponge_kernel_matches_plain(lib, shape):
    c, log_m = shape
    cols = _t(_words(np.random.default_rng(list(shape)), (c, 1 << log_m)))
    out = torch.empty((4, cols.shape[1]), dtype=gld.DTYPE)
    gdev.launch_leaf_sponge(lib, None, cols, out)
    assert torch.equal(out, gdev.leaf_sponge_plain(cols))


def test_merkle_levels_kernel_matches_plain(lib):
    """Every tree from 2^0 to 2^11 leaves: the top block alone below
    K14C_TOP, level launches then the top block above it."""
    rng = np.random.default_rng(12)
    for log_m in range(12):
        leaves = _t(_words(rng, (4, 1 << log_m)))
        got, want = _host_levels(lib, leaves), gdev.merkle_levels_plain(leaves)
        assert len(got) == len(want) == log_m
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("value", EDGE_VALUES + ["alternating"],
                         ids=["0", "p-1", "2^32-1", "2^32", "alternating"])
def test_kernels_on_edge_words(lib, value):
    """Words all 0, all p - 1, all 2^32 - 1, all 2^32, and alternating
    0 / p - 1: where a reduction left out shows."""
    c, m = 9, 1 << 5
    if value == "alternating":
        words = torch.arange(c * m).reshape(c, m) % 2 * gld.const(P - 1)
    else:
        words = gld.full((c, m), value, "cpu")
    _, cw = _host_encode(lib, words, 2)
    assert torch.equal(cw, gdev.encode_plain(words, 2))
    out = torch.empty((4, m), dtype=gld.DTYPE)
    gdev.launch_leaf_sponge(lib, None, words, out)
    assert torch.equal(out, gdev.leaf_sponge_plain(words))
    for a, b in zip(_host_levels(lib, words[:4].contiguous()),
                    gdev.merkle_levels_plain(words[:4].contiguous())):
        assert torch.equal(a, b)
