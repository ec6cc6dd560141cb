#!/usr/bin/env python3
"""Smoke run of ceno_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ceno_tpu_torch/csrc`` and checks the port at
the shapes of the 2^20-step fibonacci proof's PCS, in phases:

  0. setup: the card's name and power limit, a 600 s watchdog, the build;
  1. golden Merkle check: K1 then K2 on the committed fixed-column codeword in
     ``.commit_cache/`` must reproduce its leaves, all 19 levels and the root,
     through K2's tree entry point ``merkle_levels`` and once more through the
     one-level ``compress_level``, level after level;
  2. each kernel against its plain torch version at the main path's shapes
     (K1 on seeded (61, 2^22), (13, 2^19) and (4, 2^21) matrices, K2 over
     each of their trees), bitwise, with the times of both and the card's
     bound for the same work; K2 over every tree from 2^1 to 2^11 leaves,
     across its top launch's threshold; then both on edge words at
     (61, 2^16): all 0, all p - 1 and alternating 0 / p - 1;
  3. the slice end to end with the default BasefoldParams: commit, open and
     verify the (61, 2^19) witness stack and the (13, 2^16) fixed stack, each
     with one random ext4 point per height class and the true MLE value of
     every slice; a claim with one value changed must be rejected. The kernel
     launch counts are read over this phase alone and must be those of the
     phase's 25 trees: K1 once per tree, K2 as ``merkle_plan`` plans them;
  4. report: the span tree, the launch counts, a ``{"kernel_shapes": ...}``
     line with every shape of phase 2, a ``{"kernels": [...]}`` line (the
     largest shapes), the card line and, last,
     ``{"ok": true, "device": {...}}``.

Any mismatch, rejected honest proof or exception exits nonzero before the
last line. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2_merkle as pm
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.mle import ops
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import jagged as jg
from ceno_tpu_torch.sumcheck.verifier import SumcheckError
from ceno_tpu_torch.utils import cuda_build, spans

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, ".commit_cache", "commit-8cc386001f1b61172778f21844b7e769.npz")
SEED = 20

# (h, cols) classes of the 2^20-step fibonacci witness (ZKVMConfig(shl_x_bits=10))
WITNESS_CLASSES = [(2, 30), (16, 2), (32, 7), (256, 6), (4096, 1), (16384, 2),
                   (65536, 4), (262144, 62), (524288, 23)]
# fixed-column classes of the same proof's key
FIXED_CLASSES = [(16, 8), (32, 12), (16384, 8), (65536, 9)]

# H100 SXM peaks at the 700 W limit. HBM bytes/s: NVIDIA's H100 data sheet.
# 32-bit integer multiplies/s: the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput gives compute capability 9.0 64 results
# per clock per SM for 32-bit integer multiply and multiply-add (against 128
# for float32 fma), times the data sheet's 132 SMs and 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_PERM = 772 * 3  # Montgomery products per permutation x 3 multiplies

# (C, log2 M) main-path shapes of K1: the witness commit, the fixed commit and
# the first witness fold tree (4 rows for one point); K2 runs over their trees
K1_SHAPES = [(61, 22), (13, 19), (4, 21)]
SMALL_TREES = range(1, 12)  # log2 of the leaf counts of the small K2 trees
# log2 of the leaf counts of phase 3's trees: the witness commit and its 13
# fold trees, the fixed commit and its 10 (folding stops at 2^9 leaves); the
# launch-plan tests read this list too
MAIN_PATH_TREES = [22, *range(21, 8, -1), 19, *range(18, 8, -1)]
EDGE_SHAPE = (61, 16)  # (C, log2 M) of the edge-word inputs
DEVICE = "cuda"
T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def bound(perms: int, nbytes: int) -> tuple:
    """Least time for ``perms`` permutations moving ``nbytes``: the larger of
    the bytes over the HBM rate and the integer multiplies over the multiply
    rate. It counts multiplies only, not the additions and reductions, which
    share the integer ALU pipe's own 64 per clock per SM."""
    t_ops = perms * MULS_PER_PERM / PEAK_MULS_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item())


@contextlib.contextmanager
def phase(name: str):
    log(f"phase {name}: start")
    t = time.time()
    yield
    log(f"phase {name}: done in {time.time() - t:.2f}s")


def golden_check() -> None:
    with np.load(GOLDEN) as z:
        cw = z["cw"].astype(np.uint64)
        leaves = z["leaves"].astype(np.uint64)
        levels = [z[f"level{i}"].astype(np.uint64) for i in range(int(z["n_levels"]))]
    log(f"golden file: cw {cw.shape}, {len(levels)} levels")
    cur = pm.leaf_sponge(bb.to_device(cw, DEVICE))
    if not np.array_equal(bb.to_host(cur), leaves):
        fail("K1 leaves differ from the committed fixed-commit leaves")
    tree = pm.merkle_levels(cur)
    if len(tree) != len(levels):
        fail(f"merkle_levels gave {len(tree)} levels, the committed tree has {len(levels)}")
    for i, want in enumerate(levels):
        if not np.array_equal(bb.to_host(tree[i]), want):
            fail(f"K2 merkle_levels: level {i} differs from the committed level{i}")
        cur = pm.compress_level(cur)
        if not np.array_equal(bb.to_host(cur), want):
            fail(f"K2 compress_level: level {i} differs from the committed level{i}")
    log(f"golden: leaves, {len(levels)} levels (merkle_levels in {len(pm.merkle_plan(cw.shape[1]))}"
        f" launches, and compress_level level by level) and root "
        f"{bb.to_host(cur)[:, 0].tolist()} equal")


def plain_levels(leaves) -> list:
    cur, out = leaves, []
    while cur.shape[1] > 1:
        cur = pm.compress_level_plain(cur)
        out.append(cur)
    return out


def levels_err(got, want) -> int:
    if len(got) != len(want):
        fail(f"K2 gave {len(got)} levels, the plain version {len(want)}")
    return max((max_abs_err(a, b) for a, b in zip(got, want)), default=0)


def kernels_vs_plain(rng) -> tuple:
    """Each kernel against its plain version at every main-path shape, bitwise,
    with both times. Returns (the ``kernels`` entries at the largest shapes,
    one row per shape)."""
    rows, results = [], {}
    for c, log_m in K1_SHAPES:
        m = 1 << log_m
        cols = bb.to_device(rng.integers(0, bb.P, size=(c, m), dtype=np.uint64), DEVICE)
        got = pm.leaf_sponge(cols)
        ms = cuda_ms(lambda: pm.leaf_sponge(cols), reps=5)
        chunk = 1 << 20
        want, plain_ms = wall_ms(lambda: torch.cat(
            [pm.leaf_sponge_plain(cols[:, s:s + chunk]) for s in range(0, m, chunk)], 1))
        err = max_abs_err(got, want)
        b_ms, b_by = bound(-(-max(c, 1) // 8) * m, (c + 8) * 4 * m)
        rows.append(dict(name="leaf_sponge", shape=f"({c}, 2^{log_m})", max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        results.setdefault("leaf_sponge", rows[-1])
        log(f"K1 ({c}, 2^{log_m}) full width: max_abs_err {err}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        if err:
            fail(f"K1 differs from its plain version at ({c}, 2^{log_m})")
        del cols, want
        levels = pm.merkle_levels(got)
        ms = cuda_ms(lambda: pm.merkle_levels(got), reps=5)
        want, plain_ms = wall_ms(lambda: plain_levels(got))
        err = levels_err(levels, want)
        b_ms, b_by = bound(m - 1, 8 * 4 * m + 8 * 4 * (m - 1))
        n_launch = len(pm.merkle_plan(m))
        rows.append(dict(name="compress_level", shape=f"all {log_m} levels of (8, 2^{log_m})",
                         launches_per_tree=n_launch, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        results.setdefault("compress_level", rows[-1])
        log(f"K2 all {log_m} levels of (8, 2^{log_m}) in {n_launch} launches: max_abs_err {err}, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        if err:
            fail(f"K2 differs from its plain version on the 2^{log_m} tree")
        del levels, want
    for log_m in SMALL_TREES:
        leaves = bb.to_device(rng.integers(0, bb.P, size=(8, 1 << log_m), dtype=np.uint64), DEVICE)
        if levels_err(pm.merkle_levels(leaves), plain_levels(leaves)):
            fail(f"K2 differs from its plain version on the 2^{log_m} tree")
    log(f"K2 over every tree from 2^{SMALL_TREES[0]} to 2^{SMALL_TREES[-1]} leaves "
        f"({sum(len(pm.merkle_plan(1 << n)) for n in SMALL_TREES)} launches) equals the plain version")
    edge_words(EDGE_SHAPE)
    kernels = [
        dict(name=name, route="cuda", source="ceno_tpu_torch/csrc/poseidon2_merkle.cu",
             replaces=f"ceno_tpu/hash/poseidon2_pallas.py:{line}",
             **{k: v for k, v in results[name].items() if k not in ("name", "launches_per_tree")},
             library_ms=None)
        for name, line in (("leaf_sponge", 116), ("compress_level", 147))
    ]
    return kernels, rows


def edge_words(shape) -> None:
    """K1 on (C, M) words all 0, all p - 1 and alternating 0 / p - 1, and K2
    over the tree whose leaves are the first 8 rows of each, bitwise against
    the plain versions: the values where a reduction left out shows."""
    c, m = shape[0], 1 << shape[1]
    alternating = (torch.arange(c * m, device=DEVICE).reshape(c, m) % 2 * (bb.P - 1)).to(bb.DTYPE)
    for name, words in (("all 0", torch.zeros((c, m), dtype=bb.DTYPE, device=DEVICE)),
                        ("all p-1", torch.full((c, m), bb.P - 1, dtype=bb.DTYPE, device=DEVICE)),
                        ("alternating 0/p-1", alternating)):
        level = words[:8].contiguous()
        if max_abs_err(pm.leaf_sponge(words), pm.leaf_sponge_plain(words)):
            fail(f"K1 differs from its plain version on {name} words at ({c}, 2^{shape[1]})")
        if levels_err(pm.merkle_levels(level), plain_levels(level)):
            fail(f"K2 differs from its plain version on {name} words, (8, 2^{shape[1]}) tree")
        log(f"edge words {name}: K1 at ({c}, 2^{shape[1]}) and K2 over (8, 2^{shape[1]}) "
            "equal their plain versions")


def mle_values(arr: np.ndarray, z: np.ndarray) -> np.ndarray:
    """True values f_j(z) of every row of ``arr`` (C, h) canonical: (C, 4)."""
    f = torch.from_numpy(arr.astype(np.int64)).to(DEVICE)
    eq = bb.from_monty(ops.build_eq(bb.to_device(z, DEVICE))).long()  # (4, h)
    vals = torch.stack([(f * eq[i]).remainder(bb.P).sum(dim=1) % bb.P for i in range(4)], 1)
    return vals.cpu().numpy().astype(np.uint64)


def run_slice(name, classes, rng, params) -> None:
    layout = jg.plan_layout(classes)
    arrs = [(h, rng.integers(0, bb.P, size=(c, h), dtype=np.uint64)) for h, c in classes]
    mat = jg.stack_matrix(layout, arrs)
    log(f"{name}: stacked ({layout.n_mat_cols}, 2^{layout.n_r.bit_length() - 1}), "
        f"blowup {params.blowup}, {params.n_queries} queries, {params.pow_bits} PoW bits")
    t = time.time()
    committed = bf.commit(mat, params, device=DEVICE)
    log(f"{name}: commit {time.time() - t:.3f}s, codeword {tuple(committed.codeword.shape)}")
    claims = []
    for h, arr in arrs:
        z = rng.integers(0, bb.P, size=(h.bit_length() - 1, 4), dtype=np.uint64)
        for v in mle_values(arr, z):
            claims.append(jg.JaggedClaim(len(claims), z, v))
    t = time.time()
    proof = jg.open_jagged(committed, layout, claims, Transcript(b"chip-smoke"), params)
    log(f"{name}: open {time.time() - t:.3f}s ({len(claims)} claims, "
        f"{len(proof.opening.fold_roots)} fold trees, nonce {proof.opening.pow_nonce})")
    t = time.time()
    jg.verify_jagged(committed.root, layout, claims, proof, Transcript(b"chip-smoke"), params)
    log(f"{name}: verify accepted in {time.time() - t:.3f}s")
    i, bad = len(claims) // 2, list(claims)
    bad[i] = jg.JaggedClaim(claims[i].slice_idx, claims[i].z,
                            (claims[i].value + np.uint64(1)) % np.uint64(bb.P))
    try:
        jg.verify_jagged(committed.root, layout, bad, proof, Transcript(b"chip-smoke"), params)
    except (jg.JaggedError, SumcheckError, bf.PCSError) as e:
        log(f"{name}: tampered claim rejected ({type(e).__name__})")
    else:
        fail(f"{name}: a tampered claim was accepted")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with phase("0 setup"):
        card = card_line()
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        faulthandler.dump_traceback_later(600, exit=True)
        t = time.time()
        cuda_build.build_all()
        log(f"kernels built in {time.time() - t:.2f}s")
        for name, out in cuda_build.build_logs.items():
            for line in out.splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
    with phase("1 golden Merkle check"):
        golden_check()
    with phase("2 kernels against plain versions"):
        kernels, shape_rows = kernels_vs_plain(np.random.default_rng(SEED))
    torch.cuda.empty_cache()

    with phase("3 slice end to end"):
        rng = np.random.default_rng(SEED + 1)
        spans.enable()
        pm.reset_launches()
        for name, classes in (("witness", WITNESS_CLASSES), ("fixed", FIXED_CLASSES)):
            with spans.span(name):
                run_slice(name, classes, rng, bf.BasefoldParams())
        torch.cuda.synchronize()
        launches = dict(pm.LAUNCHES)
        spans.disable()

    with phase("4 report"):
        print(spans.report(min_seconds=0.001), flush=True)
        log(f"launches on the main path: {launches}")
        expected = {"leaf_sponge": len(MAIN_PATH_TREES),
                    "compress_level": sum(len(pm.merkle_plan(1 << n)) for n in MAIN_PATH_TREES)}
        for k in kernels:
            k["launches"] = launches[k["name"]]
            if k["launches"] <= 0:
                fail(f"kernel {k['name']} was not launched on the main path")
            if k["launches"] != expected[k["name"]]:
                fail(f"kernel {k['name']}: {k['launches']} launches on the main path, "
                     f"its launch plan gives {expected[k['name']]}")
        print(json.dumps({"kernel_shapes": shape_rows}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
