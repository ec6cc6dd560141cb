"""csrc/sumcheck.cu's kernels (K6a, K6b, K5/K7) run on the CPU, held
against their plain torch versions.

No CUDA runs here, so the test compiles the kernel source itself with the
host C++ compiler against ``tests/cuda_host/cuda_runtime.h``, a stand-in for
the CUDA runtime that runs a launch's blocks one after the other and each
block's threads as threads, and loads it with ctypes. The wrappers'
``launch_round_evals``, ``launch_fold`` and ``launch_duplex`` (the code that
checks, allocates scratch and calls the C entry points on the card) drive it
with CPU tensors. The card's own compiler, register allocation and memory
model are not exercised: ``chip_smoke.py`` holds the same kernels against
the same plain versions on the card. All comparisons are exact.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2 as p2
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.sumcheck import fused, terms as T
from ceno_tpu_torch.utils import cuda_build

torch.set_num_threads(1)
P = bb.P
HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH = re.compile(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\(", re.S)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/sumcheck.cu compiled for the host, its C signatures declared."""
    out = tmp_path_factory.mktemp("sumcheck_host")
    for f in os.listdir(cuda_build.CSRC_DIR):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(cuda_build.CSRC_DIR, f), out)
    with open(os.path.join(cuda_build.CSRC_DIR, "sumcheck.cu")) as f:
        src = LAUNCH.sub(r"run_kernel(Launch(\2), \1, ", f.read())
    (out / "sumcheck.cpp").write_text(src)
    so = out / "libsumcheck_host.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-I", os.path.join(HERE, "cuda_host"), "-o", str(so),
                    str(out / "sumcheck.cpp")], check=True, capture_output=True)
    return T.declare(ctypes.CDLL(str(so)))


def _words(rng, shape, kind="random"):
    if kind == "p-1":
        return torch.full(shape, P - 1, dtype=bb.DTYPE)
    if kind == "0":
        return torch.zeros(shape, dtype=bb.DTYPE)
    return bb.to_device(rng.integers(0, P, size=shape, dtype=np.uint64), "cpu")


def _banks(rng, cb, ce, n, kind="random"):
    base, ext = _words(rng, (cb + 1, n), kind), _words(rng, (4, ce + 1, n), kind)
    base[cb] = bb.MONTY_ONE
    ext[:, ce] = 0
    ext[0, ce] = bb.MONTY_ONE
    return base, ext


# (Cb, Ce, N, T, DB, DE, deg): the main path's kinds of sumcheck (towers: ext
# only, DE 3, deg 3; class mains: DB up to 3, DE 1, deg up to 4; the jagged
# and Basefold sumchecks: deg 2; the shard-RAM chips' class main: DB 7, DE 1,
# deg 8), every degree the kernel takes, no term (all padding), one column
# only
SHAPES = [(0, 9, 64, 8, 0, 3, 3), (12, 2, 256, 40, 3, 1, 4), (5, 3, 32, 7, 1, 1, 2),
          (0, 4, 2, 1, 0, 2, 2), (3, 2, 16, 5, 2, 1, 0), (2, 3, 8, 6, 1, 2, 1),
          (2, 3, 8, 6, 2, 3, 5), (4, 1, 16, 3, 3, 3, 6), (1, 2, 8, 4, 4, 3, 7),
          (2, 2, 4, 0, 1, 1, 2), (1, 0, 2, 2, 1, 0, 1), (6, 5, 2048, 9, 2, 3, 4),
          (9, 1, 64, 12, 7, 1, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_round_evals_and_folds_match_plain(lib, shape):
    cb, ce, n, t, db, de, deg = shape
    rng = np.random.default_rng(list(shape))
    base, ext = _banks(rng, cb, ce, n)
    bidx = torch.from_numpy(rng.integers(0, cb + 1, size=(t, db)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, ce + 1, size=(t, de)).astype(np.int32))
    scalars = _words(rng, (4, t))
    out = torch.empty((deg + 1, 4), dtype=bb.DTYPE)
    T.launch_round_evals(lib, None, base if db else None, ext, bidx, eidx, scalars, deg, out)
    assert torch.equal(out, T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=deg))
    r = _words(rng, (4,))
    mixed = torch.empty((4, cb + ce + 1, n // 2), dtype=bb.DTYPE)
    T.launch_fold(lib, None, base, ext, r, mixed)
    assert torch.equal(mixed, T.fold_banks_plain(base, ext, r))
    folded = torch.empty((4, ce + 1, n // 2), dtype=bb.DTYPE)
    T.launch_fold(lib, None, None, ext, r, folded)
    assert torch.equal(folded, T.fold_ext_bank_plain(ext, r))


@pytest.mark.parametrize("kind", ["p-1", "0"])
def test_edge_words(lib, kind):
    """Banks, scalars and challenge all p - 1, or all 0."""
    rng = np.random.default_rng(5)
    base, ext = _banks(rng, 3, 3, 64, kind)
    bidx = torch.from_numpy(rng.integers(0, 4, size=(6, 2)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, 4, size=(6, 2)).astype(np.int32))
    scalars, r = _words(rng, (4, 6), kind), _words(rng, (4,), kind)
    out = torch.empty((5, 4), dtype=bb.DTYPE)
    T.launch_round_evals(lib, None, base, ext, bidx, eidx, scalars, 4, out)
    assert torch.equal(out, T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=4))
    mixed = torch.empty((4, 7, 32), dtype=bb.DTYPE)
    T.launch_fold(lib, None, base, ext, r, mixed)
    assert torch.equal(mixed, T.fold_banks_plain(base, ext, r))


def test_round_evals_grid_stride(lib):
    """Fewer blocks than the half-cube needs: each thread takes several
    elements (the card's case above 2^18 elements a half)."""
    rng = np.random.default_rng(6)
    base, ext = _banks(rng, 2, 2, 4096)
    bidx = torch.from_numpy(rng.integers(0, 3, size=(5, 2)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, 3, size=(5, 1)).astype(np.int32))
    scalars = _words(rng, (4, 5))
    want = T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=3)
    for blocks in (1, 3):
        out = torch.empty((4, 4), dtype=bb.DTYPE)
        partial = torch.empty(blocks * 16, dtype=bb.DTYPE)
        rc = lib.sc_round_evals(base.data_ptr(), ext.data_ptr(), bidx.data_ptr(),
                                eidx.data_ptr(), scalars.data_ptr(), partial.data_ptr(),
                                out.data_ptr(), 4096, 3, 5, 2, 1, 3, blocks, None)
        assert rc == 0 and torch.equal(out, want)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("pos", range(p2.RATE + 1))
def test_duplex_matches_plain_and_transcript(lib, pos, absorbed):
    """From every pos, absorbs of 0 to 17 words then one sample with 5
    powers: the kernel's state, challenge and powers against the plain
    version's and the host transcript's."""
    for sq_pos in (0, 5, p2.RATE):
        for n_in in (0, 1, 7, 8, 9, 17):
            rng = np.random.default_rng([pos, int(absorbed), sq_pos, n_in])
            st, words = _words(rng, (16,)), _words(rng, (n_in,))
            got = [st.clone(), torch.zeros(4, dtype=bb.DTYPE), torch.zeros((4, 6), dtype=bb.DTYPE)]
            want = [st.clone(), torch.zeros(4, dtype=bb.DTYPE), torch.zeros((4, 6), dtype=bb.DTYPE)]
            absorb = words if n_in else None
            fused.launch_duplex(lib, None, got[0], absorb, got[1], got[2][:, :5], pos, sq_pos,
                                absorbed)
            fused.duplex_plain(want[0], absorb, want[1], want[2][:, :5], pos, sq_pos, absorbed)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            host = Transcript.from_state((bb.to_host(st), pos, sq_pos, absorbed))
            host.append(bb.to_host(words))
            np.testing.assert_array_equal(bb.to_host(got[2][:, :5]).T, host.sample_ext_pows(5))
            np.testing.assert_array_equal(bb.to_host(got[0]), host.state)


def test_duplex_absorb_only_and_sample_only(lib):
    rng = np.random.default_rng(8)
    st, words = _words(rng, (16,)), _words(rng, (11,))
    a, b = st.clone(), st.clone()
    fused.launch_duplex(lib, None, a, words, None, None, 3, 8, False)
    fused.duplex_plain(b, words, None, None, 3, 8, False)
    assert torch.equal(a, b)
    out_a, out_b = torch.zeros(4, dtype=bb.DTYPE), torch.zeros(4, dtype=bb.DTYPE)
    fused.launch_duplex(lib, None, a, None, out_a, None, 6, 8, True)
    fused.duplex_plain(b, None, out_b, None, 6, 8, True)
    assert torch.equal(a, b) and torch.equal(out_a, out_b)


def test_limits_raise(lib):
    """The wrappers refuse what the kernels do not take, and the C entry
    points return cudaErrorInvalidValue (1) for arguments outside their
    limits."""
    rng = np.random.default_rng(9)
    base, ext = _banks(rng, 2, 2, 8)
    idx = torch.zeros((3, 1), dtype=torch.int32)
    sc = _words(rng, (4, 3))
    out = torch.empty((9, 4), dtype=bb.DTYPE)
    with pytest.raises(ValueError, match="limits"):
        T.launch_round_evals(lib, None, base, ext, idx, idx, sc, T.MAX_DEG + 1, out)
    out = torch.empty((4, 4), dtype=bb.DTYPE)
    with pytest.raises(ValueError, match="bank has 3 columns"):
        T.launch_round_evals(lib, None, base, ext, idx + 3, idx, sc, 3, out)
    with pytest.raises(ValueError, match="contiguous"):
        T.launch_round_evals(lib, None, base, ext.transpose(1, 2), idx, idx, sc, 3, out)
    with pytest.raises(ValueError, match="int32"):
        T.launch_round_evals(lib, None, base, ext, idx.float(), idx, sc, 3, out)
    with pytest.raises(ValueError, match="challenge"):
        T.launch_fold(lib, None, base, ext, sc[:, 0].contiguous()[:3],
                      torch.empty((4, 5, 4), dtype=bb.DTYPE))
    rc = lib.sc_round_evals(base.data_ptr(), ext.data_ptr(), idx.data_ptr(), idx.data_ptr(),
                            sc.data_ptr(), out.data_ptr(), out.data_ptr(), 8, 3, 3, 1, 1,
                            T.MAX_DEG + 1, 1, None)
    assert rc == 1
    assert lib.sc_duplex(base.data_ptr(), None, 0, None, None, 0, 0, p2.RATE + 1, 0, 0,
                         None) == 1


def test_round_evals_take_the_ec_quark_terms(lib):
    """K6a over the EC-sum quark's zerocheck (``gkr/eccquark.py``): 455 terms
    over 49 base and 3 ext columns at degree 3, whose 14 export terms have
    no base factor and index the base bank's ones column; the first round
    (mixed banks) and, after one fold, an ext-only round."""
    from ceno_tpu_torch.fields import septic as S
    from ceno_tpu_torch.gkr import eccquark as Q
    from ceno_tpu_torch.sumcheck import prover as sc_prover

    rng = np.random.default_rng(10)
    xs, ys = [], []
    while len(xs) < 5:
        trial = rng.integers(0, P, size=(8, 7), dtype=np.uint64)
        y, ok = S.from_x(trial)
        xs += list(trial[ok])
        ys += list(y[ok])
    x, y, s, final = Q.build_tree_witness(np.stack(xs[:5]), np.stack(ys[:5]), 16)
    views = [Q._views(c) for c in (x, y, s)]
    (x0, x1, x3), (y0, y1, y3), (_, _, s3) = views
    base_np = np.concatenate([s3, x0, y0, x1, y1, x3, y3])          # (49, 8)
    alphas = rng.integers(1, P, size=(Q.DEG * 7, 4), dtype=np.uint64)
    terms = Q._build_terms(alphas, final)
    bidx_np, eidx_np, scal_np, deg = sc_prover.compile_terms(terms, 49, 3)
    live = np.nonzero(scal_np.any(axis=1))[0]
    assert deg == 3 and (bidx_np[[i for i, t in enumerate(terms) if not t.bidx]] == 49).all()
    base, ext = T.make_banks(list(bb.to_device(base_np, "cpu")),
                             [_words(rng, (4, 3, 8))], 8)
    bidx = torch.from_numpy(bidx_np[live])
    eidx = torch.from_numpy(eidx_np[live])
    scalars = bb.to_device(scal_np[live].T, "cpu")
    out = torch.empty((deg + 1, 4), dtype=bb.DTYPE)
    T.launch_round_evals(lib, None, base, ext, bidx, eidx, scalars, deg, out)
    assert torch.equal(out, T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=deg))
    merged = T.fold_banks_plain(base, ext, _words(rng, (4,)))
    midx = torch.from_numpy(T.merge_indices(bidx_np, eidx_np, 49, 3)[live])
    T.launch_round_evals(lib, None, None, merged, torch.zeros((len(live), 0), dtype=torch.int32),
                         midx, scalars, deg, out)
    assert torch.equal(out, T.round_evals_ext_plain(merged, midx, scalars, deg=deg))
