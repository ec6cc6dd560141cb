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
from ceno_tpu_torch.fields import ext4
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
    """Banks, scalars and challenge all p - 1, or all 0 (K6a also over
    several chunks and ranges)."""
    rng = np.random.default_rng(5)
    base, ext = _banks(rng, 3, 3, 64, kind)
    bidx = torch.from_numpy(rng.integers(0, 4, size=(6, 2)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, 4, size=(6, 2)).astype(np.int32))
    scalars, r = _words(rng, (4, 6), kind), _words(rng, (4,), kind)
    out = torch.empty((5, 4), dtype=bb.DTYPE)
    T.launch_round_evals(lib, None, base, ext, bidx, eidx, scalars, 4, out)
    assert torch.equal(out, T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=4))
    _evals_equal(lib, base, ext, bidx, eidx, scalars, 4, t_lanes=4, ranges=2)
    mixed = torch.empty((4, 7, 32), dtype=bb.DTYPE)
    T.launch_fold(lib, None, base, ext, r, mixed)
    assert torch.equal(mixed, T.fold_banks_plain(base, ext, r))


def test_round_evals_grid_stride(lib):
    """Fewer element ranges than the half-cube has elements a thread: each
    thread takes several elements (the card's case at every large
    half-cube)."""
    rng = np.random.default_rng(6)
    base, ext = _banks(rng, 2, 2, 4096)
    bidx = torch.from_numpy(rng.integers(0, 3, size=(5, 2)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, 3, size=(5, 1)).astype(np.int32))
    scalars = _words(rng, (4, 5))
    want = T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=3)
    for ranges in (1, 3):
        plan = T.round_evals_plan(2048, 5, 2, 1, ranges=ranges)
        assert plan.ranges == ranges and plan.e_lanes == 51
        out = torch.empty((4, 4), dtype=bb.DTYPE)
        T.launch_round_evals(lib, None, base, ext, bidx, eidx, scalars, 3, out, plan=plan)
        assert torch.equal(out, want)


def _terms(rng, cb, ce, t, db, de):
    bidx = torch.from_numpy(rng.integers(0, cb + 1, size=(t, db)).astype(np.int32))
    eidx = torch.from_numpy(rng.integers(0, ce + 1, size=(t, de)).astype(np.int32))
    return bidx, eidx, _words(rng, (4, t))


def _evals_equal(lib, base, ext, bidx, eidx, scalars, deg, **plan):
    """K6a under the plan with ``plan``'s overrides equals the plain version."""
    db = bidx.shape[1]
    p = T.eval_plan(ext, bidx, eidx, **plan)
    out = torch.empty((deg + 1, 4), dtype=bb.DTYPE)
    T.launch_round_evals(lib, None, base if db else None, ext, bidx, eidx, scalars, deg, out,
                         plan=p)
    assert torch.equal(out, T.round_evals_plain(base, ext, bidx, eidx, scalars, deg=deg)), p
    return p


# (Cb, Ce, N, T, DB, DE, deg, t_lanes, ranges): plans that force several
# term chunks (t_lanes below T) and several element ranges, some of them with
# fewer elements than threads a term, a block's last chunk short
PLANS = [(3, 4, 512, 23, 1, 2, 3, 4, 3), (3, 4, 512, 23, 1, 2, 3, 23, 40),
         (0, 6, 256, 10, 0, 3, 3, 3, 5), (0, 6, 256, 10, 0, 3, 3, 10, 2),
         (5, 1, 128, 40, 3, 1, 4, 7, 1), (5, 1, 128, 40, 3, 1, 4, 1, 4),
         (2, 2, 64, 9, 2, 2, 2, 32, 2), (4, 0, 32, 17, 2, 1, 5, 64, 2)]


@pytest.mark.parametrize("shape", PLANS)
def test_round_evals_forced_plans(lib, shape):
    cb, ce, n, t, db, de, deg, t_lanes, ranges = shape
    rng = np.random.default_rng(list(shape))
    base, ext = _banks(rng, cb, ce, n)
    bidx, eidx, scalars = _terms(rng, cb, ce, t, db, de)
    p = _evals_equal(lib, base, ext, bidx, eidx, scalars, deg, t_lanes=t_lanes, ranges=ranges)
    assert (p.chunks, p.ranges, p.e_lanes) == (-(-t // t_lanes), ranges,
                                               min(T.THREADS // t_lanes, n // 2))


def test_round_evals_two_rows_many_terms(lib):
    """A 2-row bank (one element) with 3,000 terms over 600 base columns, as
    the secp guest's class: the terms spread over 12 chunks of 256 threads."""
    rng = np.random.default_rng(11)
    base, ext = _banks(rng, 600, 7, 2)
    bidx, eidx, scalars = _terms(rng, 600, 7, 3000, 2, 1)
    p = _evals_equal(lib, base, ext, bidx, eidx, scalars, 3)
    assert (p.t_lanes, p.e_lanes, p.chunks) == (250, 1, 12)


@pytest.mark.parametrize("ranges", [1, 3])
def test_round_evals_degree_8(lib, ranges):
    """Degree 8 with DB 7 and DE 1 (the shard-RAM chips' class main), over
    several chunks and ranges."""
    rng = np.random.default_rng(12)
    base, ext = _banks(rng, 20, 2, 128)
    bidx, eidx, scalars = _terms(rng, 20, 2, 70, 7, 1)
    _evals_equal(lib, base, ext, bidx, eidx, scalars, 8, t_lanes=16, ranges=ranges)


def test_tower_level_without_padding_terms(lib):
    """The fused tower's level table (``tower._level_static``: 10 terms of
    add's and addi's 4 products and 2 LogUps) against compile_terms' padded
    one (16 terms, the padding's scalar the zero slot after the alpha
    powers): K6a gives the same first-round message, and every round of the
    level (``fused.run_rounds``, plain on the CPU) the same messages."""
    from ceno_tpu_torch.gkr import tower
    from ceno_tpu_torch.sumcheck import prover as sc_prover

    n_prod, n_logup, log_n = 4, 2, 6
    bidx, eidx, midx, alpha_idx, deg = tower._level_static(n_prod, n_logup)
    n_ext, n_claims = 1 + 2 * n_prod + 4 * n_logup, n_prod + 2 * n_logup
    one = np.array([1, 0, 0, 0], np.uint64)
    pbidx, peidx, _, pdeg = sc_prover.compile_terms(
        [sc_prover.TermSpec(one, eidx=e) for e in tower._level_terms(n_prod, n_logup)[1]],
        0, n_ext)
    palpha = np.concatenate([alpha_idx, np.full(len(peidx) - len(alpha_idx), n_claims)])
    assert (len(eidx), len(peidx), pdeg) == (10, 16, deg)
    rng = np.random.default_rng(13)
    pows = torch.zeros((4, n_claims + 1), dtype=bb.DTYPE)
    pows[:, :n_claims] = _words(rng, (4, n_claims))
    base, ext = _banks(rng, 0, n_ext, 1 << log_n)
    tables = [(bidx, eidx, midx, alpha_idx),
              (pbidx, peidx, T.merge_indices(pbidx, peidx, 0, n_ext), palpha)]
    firsts, msgs = [], []
    for bi, ei, mi, ai in tables:
        bi, ei, mi = (torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in (bi, ei, mi))
        scalars = pows[:, torch.from_numpy(np.asarray(ai))].contiguous()
        out = torch.empty((deg + 1, 4), dtype=bb.DTYPE)
        T.launch_round_evals(lib, None, None, ext, bi, ei, scalars, deg, out)
        firsts.append(out)
        m = torch.empty((log_n, deg + 1, 4), dtype=bb.DTYPE)
        dpx = fused._DeviceDuplex(torch.zeros(16, dtype=bb.DTYPE), 0, 0, False)
        fused.run_rounds(base, ext, bi, ei, mi, scalars, dpx, m,
                         [torch.empty(4, dtype=bb.DTYPE) for _ in range(log_n)], deg=deg)
        msgs.append(m)
    assert torch.equal(firsts[0], firsts[1]) and torch.equal(msgs[0], msgs[1])
    assert torch.equal(firsts[0], msgs[0][0])


def _plan_cover(plan, half: int, t: int) -> tuple:
    """How often the kernel's index arithmetic visits each term and each
    element of the half-cube under ``plan`` (a thread visits its slot's term
    at its lane's elements): (counts (T,), counts (half,))."""
    terms_seen = np.zeros(max(t, 1), np.int64)
    for x in range(plan.chunks):
        for slot in range(plan.t_lanes):
            if x * plan.t_lanes + slot < t:
                terms_seen[x * plan.t_lanes + slot] += 1
    elems = np.zeros(half, np.int64)
    span = -(-half // plan.ranges)
    for y in range(plan.ranges):
        start, end = y * span, min(y * span + span, half)
        for lane in range(plan.e_lanes):
            elems[np.arange(start + lane, end, plan.e_lanes)] += 1
    return terms_seen[:t], elems


# (half, T, DB, DE): the main path's first rounds (tower level 21, the 2^19
# and 2^18 class mains, shard-RAM, the EC-sum quark, keccak core, keccak
# ecall, secp) and later rounds, a few small banks
PLAN_SHAPES = [(1 << 20, 10, 0, 3), (1 << 18, 83, 2, 1), (1 << 17, 215, 3, 1),
               (256, 3289, 7, 1), (256, 455, 2, 1), (1 << 14, 5376, 2, 1), (512, 1274, 3, 1),
               (1, 39422, 2, 1), (1 << 17, 83, 0, 3), (1 << 16, 215, 0, 4), (1, 1, 0, 2),
               (3, 0, 1, 1), (1000, 7, 9, 7)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_round_evals_plan_limits_and_cover(shape):
    half, t, db, de = shape
    plan = T.round_evals_plan(half, t, db, de)
    assert 1 <= plan.t_lanes and 1 <= plan.e_lanes and plan.t_lanes * plan.e_lanes <= T.THREADS
    assert plan.t_lanes * (db + de) <= T.TABLE_WORDS
    assert 1 <= plan.chunks < 1 << 31 and 1 <= plan.ranges <= T.MAX_RANGES
    assert plan.blocks < T.TARGET_BLOCKS + plan.chunks
    terms_seen, elems = _plan_cover(plan, half, t)
    assert (terms_seen == 1).all() and (elems == 1).all()
    if half >= 1 << 14:  # a long bank fills the card from its elements
        assert plan.blocks >= T.TARGET_BLOCKS // 2
    if t * half >= 1 << 19:  # enough work fills every streaming multiprocessor
        assert plan.blocks >= 132


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


# (words absorbed, powers) of the one-warp duplex's cases: several
# permutations in one launch (up to 70 words), powers past the warp's 32
# lanes (0, 1, 31, 32, 33 and 70)
DUPLEX_CASES = [(70, 70), (0, 33), (33, 32), (16, 0), (20, 31), (64, 1), (70, 33), (1, 70),
                (7, 32)]


def _duplex_step(lib, seed, pos, sq_pos, absorbed, n_in, n_pows):
    """One step through ``lib`` against duplex_plain and the host
    transcript: the state, the challenge and its powers."""
    rng = np.random.default_rng(seed)
    st, words = _words(rng, (16,)), _words(rng, (n_in,))
    absorb = words if n_in else None
    got = [st.clone(), torch.zeros(4, dtype=bb.DTYPE), torch.zeros((4, n_pows), dtype=bb.DTYPE)]
    want = [t.clone() for t in got]
    pw = (lambda t: t if n_pows else None)
    fused.launch_duplex(lib, None, got[0], absorb, got[1], pw(got[2]), pos, sq_pos, absorbed)
    fused.duplex_plain(want[0], absorb, want[1], pw(want[2]), pos, sq_pos, absorbed)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (pos, sq_pos, absorbed, n_in, n_pows)
    host = Transcript.from_state((bb.to_host(st), pos, sq_pos, absorbed))
    host.append(bb.to_host(words))
    alpha = host.sample_ext()
    np.testing.assert_array_equal(bb.to_host(got[1]), alpha)
    np.testing.assert_array_equal(bb.to_host(got[0]), host.state)
    cur = (1, 0, 0, 0)
    for i in range(n_pows):
        np.testing.assert_array_equal(bb.to_host(got[2][:, i]), cur)
        cur = ext4.py_mul(cur, alpha)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("pos", range(p2.RATE + 1))
def test_duplex_long_absorbs_and_powers(lib, pos, absorbed):
    """From every pos and sq_pos, absorbed or not, each of DUPLEX_CASES in
    turn: absorbs of up to 70 words (up to 9 permutations in one launch)
    and up to 70 powers, against the plain version and the host transcript."""
    for sq_pos in range(p2.RATE + 1):
        n_in, n_pows = DUPLEX_CASES[(pos + sq_pos) % len(DUPLEX_CASES)]
        _duplex_step(lib, [pos, sq_pos, int(absorbed), 1], pos, sq_pos, absorbed, n_in, n_pows)


@pytest.mark.parametrize("step", range(4))
def test_duplex_timed_step_shapes(lib, step):
    """Each step shape that chip_smoke times K5/K7 at (DUPLEX_STEPS), from
    where the prove makes it (DUPLEX_FROM), as chip_smoke's own check list
    holds them."""
    import chip_smoke as cs

    what, n_in, n_pows = cs.DUPLEX_STEPS[step]
    assert (*cs.DUPLEX_FROM, n_in, n_pows) in cs.duplex_check_cases(), what
    _duplex_step(lib, [step, 3], *cs.DUPLEX_FROM, n_in, n_pows)


@pytest.mark.parametrize("extra", [0, 1, 1076])
def test_duplex_absorb_past_one_tile(lib, extra):
    """An absorb of the kernel's whole shared tile of words, and past it:
    the words go in a tile at a time."""
    with open(os.path.join(cuda_build.CSRC_DIR, "sumcheck.cu")) as f:
        tile = int(re.search(r"DUPLEX_TILE = (\d+);", f.read()).group(1))
    _duplex_step(lib, [tile, extra], 5, 2, False, tile + extra, 3)


def test_kernel_library_is_declared_once(monkeypatch):
    """The wrappers' library handle declares its C signatures when it is
    first loaded, not on every launch."""
    declared, handle = [], object()
    monkeypatch.setattr(cuda_build, "load", lambda name: handle)
    monkeypatch.setattr(T, "declare", lambda lib: declared.append(lib) or lib)
    T._lib.cache_clear()
    try:
        assert all(T._lib() is handle for _ in range(5)) and declared == [handle]
    finally:
        T._lib.cache_clear()


def test_chip_smoke_duplex_steps(monkeypatch):
    """chip_smoke's K5/K7 step shapes: their permutations from where the
    prove makes them (against the host transcript's), and the check that
    the prove made each."""
    import chip_smoke as cs

    perms = [cs.duplex_perms(n_in, *cs.DUPLEX_FROM) for _, n_in, _ in cs.DUPLEX_STEPS]
    assert perms == [2, 3, 0, 12]
    calls, real = [], p2.permute_host
    monkeypatch.setattr(p2, "permute_host", lambda st: calls.append(1) or real(st))
    for pos in range(p2.RATE + 1):
        for n_in in (0, 5, 16, 70):
            for sq_pos in (0, 4, 8):
                calls.clear()
                host = Transcript.from_state((np.zeros(16, np.uint64), pos, sq_pos, True))
                host.append(np.zeros(n_in, np.uint64))
                host.sample_ext()
                assert cs.duplex_perms(n_in, pos, sq_pos, True) == len(calls), (pos, n_in)
    made = {(n_in, n_pows): 1 for _, n_in, n_pows in cs.DUPLEX_STEPS}
    cs.check_duplex_steps({**made, (5, 0): 3})
    with pytest.raises(SystemExit, match="K5/K7 step"):
        cs.check_duplex_steps({k: v for k, v in made.items() if k != (0, 12)})


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
    ptrs = (base.data_ptr(), ext.data_ptr(), idx.data_ptr(), idx.data_ptr(), sc.data_ptr(),
            out.data_ptr(), out.data_ptr())
    # deg, then the plan: t_lanes, e_lanes, chunks, ranges
    good = (3, 3, 4, 1, 1)
    assert lib.sc_round_evals(*ptrs, 8, 3, 3, 3, 1, 1, *good, None) == 0
    for bad in ((T.MAX_DEG + 1, 3, 4, 1, 1),  # degree
                (3, 3, 100, 1, 1),            # t_lanes * e_lanes > THREADS
                (3, 1, 4, 2, 1),              # chunks * t_lanes < T
                (3, 3, 4, 0, 1),              # no chunk
                (3, 3, 4, 1, T.MAX_RANGES + 1),
                (3, 3000, 1, 1, 1)):          # a factor table beyond TABLE_WORDS
        assert lib.sc_round_evals(*ptrs, 8, 3, 3, 3, 1, 1, *bad, None) == 1, bad
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


def test_chip_smoke_k6a_rows_on_the_cpu(monkeypatch):
    """chip_smoke's phase-2 sumcheck checks rehearsed on the CPU at small
    heights (the wrappers run their plain versions here): every K6a row
    carries the plan the wrapper takes and its kernel's ptxas key."""
    import time

    import chip_smoke as cs

    monkeypatch.setattr(cs, "DEVICE", "cpu")
    monkeypatch.setattr(cs, "cuda_ms", lambda fn, reps: (fn(), 1.0)[1])

    def wall_ms(fn):
        t = time.perf_counter()
        return fn(), (time.perf_counter() - t) * 1e3
    monkeypatch.setattr(cs, "wall_ms", wall_ms)
    monkeypatch.setattr(cs, "graph_ms", lambda fn, n=200: (fn(), 1.0)[1])
    monkeypatch.setattr(cs, "TOWER_LOG_N", 4)
    monkeypatch.setattr(cs, "QUARK_LOG_N", 3)
    for name in ("CLASS_MAINS", "PRECOMPILE_CLASS_MAINS", "AGG_CLASS_MAINS"):
        monkeypatch.setattr(cs, name, [dict(cm, log_n=min(cm["log_n"], 3))
                                       for cm in getattr(cs, name)])
    monkeypatch.setattr(cs, "SHARD_CLASS_MAIN", dict(cs.SHARD_CLASS_MAIN, log_n=3))
    kernels, rows = cs.sumcheck_kernels_vs_plain(np.random.default_rng(1), {})
    assert [k["name"] for k in kernels] == ["round_evals", "fold", "duplex"]
    k6a = [r for r in rows if r["name"] == "round_evals"]
    assert len(k6a) == 11 and all(r["max_abs_err"] == 0 for r in k6a)
    assert k6a[0]["plan"]["t_lanes"] * k6a[0]["plan"]["chunks"] == 10  # the tower's live terms
    for r in k6a:
        (key,) = r["ptxas"]
        assert re.fullmatch(r"round_evals_kernel<\d>", key)


def test_chip_smoke_reads_ptxas_of_template_kernels():
    import chip_smoke as cs

    log = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118round_evals_kernelILi8EEEvPKjS2_PKiS4_S2_Pjliiiiiii' for 'sm_90a'
ptxas info    : Used 96 registers, used 0 barriers, 40960 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125round_evals_reduce_kernelILi3EEEvPKjPjl' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125round_evals_reduce_kernelILi3EEEvPKjPjl
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 40 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111fold_kernelEPKjS1_S1_Pjlii' for 'sm_90a'
ptxas info    : Used 30 registers"""
    assert cs.ptxas_by_kernel(log) == {
        "round_evals_kernel<8>": {"registers": 96},
        "round_evals_reduce_kernel<3>": {"stack_frame": 0, "spill_stores": 8, "spill_loads": 8,
                                         "registers": 40},
        "fold_kernel": {"registers": 30}}


def test_chip_smoke_keeps_a_first_rounds_inputs():
    """``sumcheck_calls(keep)`` hands back the banks and tables of the first
    call of each kept shape (phases 6 and 7 time K6a on them)."""
    import chip_smoke as cs
    from ceno_tpu_torch.sumcheck import prover as sc_prover

    rng = np.random.default_rng(14)
    base_cols = list(_words(rng, (3, 8)))
    term_list = [sc_prover.TermSpec(rng.integers(1, P, size=4, dtype=np.uint64), bidx=(i % 3,),
                                    eidx=(0,)) for i in range(5)]
    shape = {"base": [4, 8], "ext": [4, 2, 8], "terms": 5, "db": 1, "de": 1, "deg": 2,
             "live": 5}
    kept = {"toy": shape, "absent": dict(shape, terms=6)}
    with cs.sumcheck_calls(kept) as calls:
        sc_prover.prove(base_cols, [_words(rng, (4, 8))], term_list, 3,
                        Transcript(b"toy"))
    assert cs.first_rounds(calls) == [shape]
    base, ext, bidx, eidx, scalars, deg = kept["toy"]
    assert tuple(base.shape) == (4, 8) and tuple(bidx.shape) == (5, 1) and deg == 2
    assert kept["absent"] == dict(shape, terms=6)
    assert torch.equal(base[:3], torch.stack(base_cols))
