"""K2's tree entry point: its levels, its buffer, its launch plan and a model
of its two CUDA kernels, on the CPU.

``merkle_levels`` on CPU tensors is held against the reference's host mirror
``host_build_levels`` and its Pallas ``compress_level`` in interpret mode.
No CUDA runs here, so what csrc/poseidon2_merkle.cu does on the card is
transcribed into numpy: the C entry point's walk over the plan's launches,
and, for ``merkle_levels_kernel`` (one thread per parent) and
``merkle_levels_split_kernel`` (four threads per parent), which thread reads
which child words from device or shared memory and where it writes each
parent. The permutation in that model is the port's ``permute_canonical``;
the four-thread permutation's own arithmetic is modelled step by step
against it. The model also checks that every shared-memory word a level
reads was written by the level before, that the one-thread kernel's
shared-memory accesses are free of bank conflicts, and that every output
word is written once. All comparisons are exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.hash import poseidon2 as rp2
from ceno_tpu.hash import poseidon2_pallas as rpp
from ceno_tpu.pcs import merkle as rmerkle
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2 as p2
from ceno_tpu_torch.hash import poseidon2_merkle as pm
from ceno_tpu_torch.pcs import merkle
from chip_smoke import MAIN_PATH_TREES
from test_torch_p2_kernel_arith import DIAG, RC_EXT, RC_INT, RINV, _states, add, mat4, mmul, \
    mmul_lazy

torch.set_num_threads(1)
P = rbb.P
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "ceno_tpu_torch", "csrc", "poseidon2_merkle.cu")
# launches per tree of 2^n leaves under the default plan, n = 0 .. 22
LAUNCHES_PER_TREE = [0] + [1] * 7 + [2] * 8 + [3, 3, 4, 4, 5, 5, 6]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


# --- merkle_levels against the reference ------------------------------------

@pytest.mark.parametrize("m", [2, 4, pm.K2_TOP // 2, pm.K2_TOP, 2 * pm.K2_TOP])
def test_merkle_levels_match_host_levels(m):
    """Below, at and above the top launch's threshold (the CPU runs the
    plain levels; the plan only decides how the card splits them)."""
    leaves = _rand(m, (8, m))
    got = pm.merkle_levels(bb.to_device(leaves, "cpu"))
    want = rmerkle.host_build_levels(leaves)
    assert len(got) == len(want) == m.bit_length() - 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bb.to_host(g), w)


def test_merkle_levels_first_level_matches_pallas_interpret():
    m = 2 * rpp.TILE
    leaves = _rand(60, (8, m))
    want = rbb.np_from_monty(np.asarray(rpp.compress_level(
        jnp.asarray(rbb.np_to_monty(leaves)), interpret=True))).astype(np.uint64)
    got = pm.merkle_levels(bb.to_device(leaves, "cpu"))
    np.testing.assert_array_equal(bb.to_host(got[0]), want)


@pytest.mark.parametrize("m", [1, 2, 8, 1024])
def test_level_views_cover_one_buffer(m):
    """(8, m/2) ... (8, 1), contiguous, one after another in one buffer of
    8 (m - 1) words, each word in exactly one level."""
    views = pm.merkle_levels(bb.to_device(_rand(70 + m, (8, m)), "cpu"))
    assert [tuple(v.shape) for v in views] == [(8, m >> k) for k in range(1, m.bit_length())]
    assert all(v.is_contiguous() for v in views)
    if m == 1:
        return
    storage = views[0].untyped_storage()
    assert all(v.untyped_storage().data_ptr() == storage.data_ptr() for v in views)
    assert storage.nbytes() == 4 * 8 * (m - 1)
    off = 0
    for v in views:
        assert v.storage_offset() == off
        off += v.numel()
    assert off == 8 * (m - 1)


def test_hash_and_tree_levels_and_shapes():
    cols = _rand(80, (5, 64))
    leaves, levels = merkle.hash_and_tree(bb.to_device(cols, "cpu"))
    want = rmerkle.host_build_levels(rmerkle.host_hash_leaves(cols))
    assert len(levels) == 6
    for g, w in zip(levels, want):
        np.testing.assert_array_equal(bb.to_host(g), w)
    assert merkle.hash_and_tree(bb.to_device(_rand(81, (3, 1)), "cpu"))[1] == ()
    with pytest.raises(ValueError):
        merkle.hash_and_tree(bb.to_device(_rand(82, (3, 12)), "cpu"))


@pytest.mark.parametrize("shape", [(8, 12), (8, 3), (7, 8), (8, 0)])
def test_merkle_levels_rejects_what_is_not_a_tree(shape):
    with pytest.raises(ValueError):
        pm.merkle_levels(torch.zeros(shape, dtype=bb.DTYPE))


# --- the launch plan --------------------------------------------------------

def _check_launch(levels, threads, lanes, half):
    """The rules p2_merkle_levels checks before each launch."""
    n = threads // lanes
    assert lanes in (1, 4) and threads % lanes == 0 and 1 <= n
    assert 1 <= levels <= 30 and threads <= pm.K2_MAX_THREADS and half >= 1
    assert n % (1 << (levels - 1)) == 0
    if levels > 1 or lanes == 4:
        assert half % n == 0


@pytest.mark.parametrize("n", range(23))
def test_default_plan_covers_every_level_once(n):
    m, plan = 1 << n, pm.merkle_plan(1 << n)
    assert len(plan) == LAUNCHES_PER_TREE[n]
    assert sum(levels for levels, _, _ in plan) == n
    half = m // 2
    for k, (levels, threads, lanes) in enumerate(plan):
        _check_launch(levels, threads, lanes, half)
        # one thread per parent exactly on the levels of more than K2_SPLIT parents
        assert (lanes == 1) == (half > pm.K2_SPLIT)
        if lanes == 1:
            assert half >> (levels - 1) > pm.K2_SPLIT and threads == min(pm.K2_THREADS, half)
        if k == len(plan) - 1:  # the top launch: one block, down to the root
            assert half == threads // lanes and (half * 2) <= pm.K2_TOP
        else:
            assert 2 * half > pm.K2_TOP
        half >>= levels


def test_main_path_launch_counts():
    """chip_smoke.py's phase 3 builds these 25 trees: K1 once per tree, and
    K2 72 times under the default plan (371 when it ran once per level)."""
    assert len(MAIN_PATH_TREES) == 25
    assert sum(len(pm.merkle_plan(1 << n)) for n in MAIN_PATH_TREES) == 72
    assert sum(MAIN_PATH_TREES) == 371


# Launch plans other than merkle_plan's, written out by hand as (log2 m,
# plan): other block sizes, levels a launch, split points and top blocks,
# each within the C entry point's rules.
HAND_PLANS = {
    "one thread, 3 levels": (11, ((3, 64, 1), (3, 64, 1), (1, 16, 1), (4, 8, 1))),
    "one thread, top 1024": (11, ((1, 512, 1), (10, 512, 1))),
    "one thread, 10 levels": (22, ((10, 512, 1), (2, 512, 1), (10, 512, 1))),
    "one level a launch": (5, ((1, 16, 1), (1, 8, 1), (1, 4, 1), (1, 2, 1), (1, 1, 1))),
    "split at 256": (12, ((2, 256, 1), (1, 256, 1), (4, 32, 4), (1, 32, 4), (4, 32, 4))),
    "split 512 threads": (12, ((1, 64, 1), (5, 512, 4), (6, 128, 4))),
    "split, one parent a block": (5, ((2, 16, 1), (2, 4, 1), (1, 4, 4))),
    "mixed by hand": (9, ((1, 16, 4), (2, 32, 4), (6, 128, 4))),
}


@pytest.mark.parametrize("name", list(HAND_PLANS))
def test_other_plans_cover_every_level_once(name):
    n, plan = HAND_PLANS[name]
    assert sum(levels for levels, _, _ in plan) == n
    half = 1 << n >> 1
    for levels, threads, lanes in plan:
        _check_launch(levels, threads, lanes, half)
        half >>= levels


@pytest.mark.parametrize("m", [0, -4, 3, 6, 12])
def test_plan_rejects_bad_arguments(m):
    with pytest.raises(ValueError):
        pm.merkle_plan(m)


def test_source_constants_match_the_wrapper():
    src = open(SOURCE).read()
    assert f"K2_MAX_THREADS = {pm.K2_MAX_THREADS};" in src
    assert re.search(r"return DIGEST \* \(parents / 2\) \+ 16;", src)
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(kernels) == ["leaf_sponge_kernel", "merkle_levels_kernel",
                               "merkle_levels_split_kernel"]
    for kernel in kernels:  # every kernel is launched by an entry point
        assert re.search(kernel + r"<<<", src), kernel
    assert "p2_compress_level" not in src


# --- a model of the kernels' index arithmetic --------------------------------

def _permute(states):
    """(16, n) Montgomery words -> permuted (16, n) Montgomery words."""
    x = bb.from_monty(torch.from_numpy(states.astype(np.int32))).long()
    return bb.to_monty(p2.permute_canonical(x)).numpy().astype(np.int64)


def _no_bank_conflict(block, thread, addr):
    """Within each warp, distinct lanes touch distinct banks."""
    key = (block * 64 + thread // 32) * 32 + addr % 32
    return len(np.unique(key)) == len(key)


def _one_thread_kernel(mem, in_off, out, written, out_off, half, levels, threads, blocks):
    """merkle_levels_kernel over the whole grid, level by level."""
    row, parity = threads // 2, 8 * (threads // 2) + 16
    sh = np.full((blocks, 4 * parity), -1, np.int64)
    sh_level = np.full((blocks, 4 * parity), -1)
    b = np.arange(blocks)[:, None]
    t = np.arange(threads)[None, :]
    first, width, o = b * threads, half, out_off
    for lv in range(levels):
        bi, ti = np.nonzero((t < (threads >> lv)) & (first + t < width))
        f = first[bi, 0]
        st = np.zeros((16, len(bi)), np.int64)
        for j in range(8):
            if lv == 0:  # one 8-byte load: words 2 pair and 2 pair + 1 of row j
                pair = j * width + f + ti
                st[j], st[8 + j] = mem[in_off + 2 * pair], mem[in_off + 2 * pair + 1]
            else:
                a0 = ((lv + 1) & 1) * 2 * parity + j * row + ti
                a1 = a0 + parity
                assert (sh_level[bi, a0] == lv - 1).all() and (sh_level[bi, a1] == lv - 1).all()
                if threads >= 32:
                    assert _no_bank_conflict(bi, ti, a0) and _no_bank_conflict(bi, ti, a1)
                st[j], st[8 + j] = sh[bi, a0], sh[bi, a1]
        res = _permute(st)
        for j in range(8):
            idx = o + j * width + f + ti
            out[idx] = res[j]
            written[idx] += 1
            if lv + 1 < levels:
                a = (lv & 1) * 2 * parity + (ti & 1) * parity + (ti >> 1) + j * row
                if threads >= 32:
                    assert _no_bank_conflict(bi, ti, a)
                sh[bi, a], sh_level[bi, a] = res[j], lv
        o += 8 * width
        width >>= 1
        first = first >> 1


def _split_kernel(mem, in_off, out, written, out_off, half, levels, threads, blocks):
    """merkle_levels_split_kernel: thread 4i + q loads words 4 (q & 1) + k of
    child 2i + (q >> 1); the group's four x[0..3] together are the state."""
    n0 = threads // 4
    block_threads = max(32, threads)
    row, parity = n0 // 2, 8 * (n0 // 2) + 16
    sh = np.full((blocks, 4 * parity), -1, np.int64)
    sh_level = np.full((blocks, 4 * parity), -1)
    t = np.arange(block_threads)
    i, q = t >> 2, t & 3
    word = 4 * (q & 1)
    first, width, o = np.arange(blocks)[:, None] * n0, half, out_off
    for lv in range(levels):
        n = n0 >> lv
        computing = ((t & ~31) >> 2) < n  # whole warps, as the shuffles need
        assert (computing[i < n]).all()
        bi, ti = np.nonzero(np.broadcast_to(i < n, (blocks, block_threads)))
        ii, qq, ww = i[ti], q[ti], word[ti]
        f = first[bi, 0]
        x = np.zeros((4, len(bi)), np.int64)
        for k in range(4):
            if lv == 0:
                x[k] = mem[in_off + (ww + k) * 2 * width + 2 * (f + ii) + (qq >> 1)]
            else:
                a = ((lv + 1) & 1) * 2 * parity + (qq >> 1) * parity + (ww + k) * row + ii
                assert (sh_level[bi, a] == lv - 1).all()
                x[k] = sh[bi, a]
        # the state of parent (b, i): thread q's x[k] is word 4q + k
        parents = bi * n0 + ii  # one group of four per parent
        order = np.lexsort((qq, parents))
        st = x[:, order].T.reshape(-1, 16).T
        res = _permute(st)
        assert lv > 0 or np.array_equal(st, np.concatenate(
            [mem[in_off + np.arange(8)[:, None] * 2 * width + 2 * (f[order][::4] + ii[order][::4])
                 + c] for c in (0, 1)]))
        # threads q = 0, 1 hold the digest (words 4q .. 4q + 3) and write it
        sel = qq[order] < 2
        xs = res.T.reshape(-1, 4, 4)[:, :2].reshape(-1, 4).T  # the q < 2 threads' x[0..3]
        b2, i2, w2 = bi[order][sel], ii[order][sel], ww[order][sel]
        for k in range(4):
            idx = o + (w2 + k) * width + first[b2, 0] + i2
            out[idx] = xs[k]
            written[idx] += 1
            if lv + 1 < levels:
                a = (lv & 1) * 2 * parity + (i2 & 1) * parity + (i2 >> 1) + (w2 + k) * row
                sh[b2, a], sh_level[b2, a] = xs[k], lv
        o += 8 * width
        width >>= 1
        first = first >> 1


def _run_plan(leaves, plan):
    """p2_merkle_levels: each launch starts from the last level written."""
    m = leaves.shape[1]
    out = np.full(8 * (m - 1), -1, np.int64)
    written = np.zeros(8 * (m - 1), np.int64)
    mem, in_off, dst, half = leaves.ravel(), 0, 0, m // 2
    for levels, threads, lanes in plan:
        _check_launch(levels, threads, lanes, half)
        n = threads // lanes
        kernel = _one_thread_kernel if lanes == 1 else _split_kernel
        kernel(mem, in_off, out, written, dst, half, levels, threads, -(-half // n))
        for _ in range(levels):
            mem, in_off = out, dst
            dst += 8 * half
            half >>= 1
    return out, written


PLANS = {f"default 2^{n}": (n, pm.merkle_plan(1 << n)) for n in (1, 2, 7, 8, 12)}
PLANS.update({name: v for name, v in HAND_PLANS.items() if v[0] <= 12})


@pytest.mark.parametrize("name", list(PLANS))
def test_kernel_model_builds_the_plain_levels(name):
    n, plan = PLANS[name]
    leaves = _rand(90 + n, (8, 1 << n)).astype(np.int64)  # Montgomery words
    out, written = _run_plan(leaves, plan)
    assert (written == 1).all()
    want = pm.merkle_levels_plain(torch.from_numpy(leaves.astype(np.int32)))
    np.testing.assert_array_equal(out, torch.cat([v.reshape(-1) for v in want]).numpy())


def test_kernel_model_one_ragged_level():
    """compress_level: one launch of one level, any even width."""
    level = _rand(95, (8, 600)).astype(np.int64)
    out, written = _run_plan(level, ((1, 256, 1),))
    assert (written[: 8 * 300] == 1).all()
    want = pm.compress_level_plain(torch.from_numpy(level.astype(np.int32)))
    np.testing.assert_array_equal(out[: 8 * 300], want.reshape(-1).numpy())


# --- permute_split's arithmetic, step by step ---------------------------------

def _group_sum(v):
    """Two shuffle steps over the group's four threads (xor 1, then xor 2)."""
    v = [add(v[q], v[q ^ 1]) for q in range(4)]
    return [add(v[q], v[q ^ 2]) for q in range(4)]


def _sbox_shallow(x):
    x2 = mmul(x, x)
    x3 = mmul(x2, x)
    x4 = mmul_lazy(x2, x2)
    assert x2 < P and x3 < P and x4 < 2 * P
    return mmul(x4, x3)


def _external_linear(x):
    x = [mat4(xq) for xq in x]
    sums = [_group_sum([x[q][k] for q in range(4)]) for k in range(4)]
    return [[add(x[q][k], sums[k][q]) for k in range(4)] for q in range(4)]


def _external_rounds(x, r0):
    for r in range(r0, r0 + 4):
        x = [[_sbox_shallow(add(x[q][k], RC_EXT[r][4 * q + k])) for k in range(4)]
             for q in range(4)]
        x = _external_linear(x)
    return x


def permute_split(words):
    """The kernel's permute_split on 16 Montgomery words; x[q] is thread q's."""
    x = _external_rounds(_external_linear([list(words[4 * q:4 * q + 4]) for q in range(4)]), 0)
    z = [x[0][0]] * 4  # __shfl_sync from thread 0: every thread's copy of word 0
    for r in range(13):
        s0 = [_sbox_shallow(add(z[q], RC_INT[r])) for q in range(4)]
        own = [add(x[q][1], add(x[q][2], x[q][3])) for q in range(4)]
        rest = _group_sum([own[0]] + [add(own[q], x[q][0]) for q in range(1, 4)])
        s = [add(rest[q], s0[q]) for q in range(4)]
        z = [add(mmul(s0[q], DIAG[0]), s[q]) for q in range(4)]
        x = [[add(mmul(x[q][k], DIAG[4 * q + k]), s[q]) for k in range(4)] for q in range(4)]
        assert len(set(z)) == 1 and all(v < P for xq in x for v in xq)
    x[0][0] = z[0]
    x = _external_rounds(x, 4)
    return [v for xq in x for v in xq]


def test_shallow_sbox_is_x7():
    rng = np.random.default_rng(96)
    for x in [0, 1, P - 2, P - 1] + rng.integers(0, P, 2000).tolist():
        assert _sbox_shallow(x) == bb.const(pow(x * RINV % P, 7, P)), x


@pytest.mark.parametrize("name", list(_states()))
def test_split_permutation_in_kernel_order(name):
    canonical = _states()[name]
    got = [v * RINV % P for v in permute_split([bb.const(int(v)) for v in canonical])]
    st = torch.from_numpy(canonical.astype(np.int64))[:, None]
    assert got == p2.permute_canonical(st)[:, 0].tolist()
    assert got == rp2.permute_host(canonical).tolist()
