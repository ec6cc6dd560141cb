#!/usr/bin/env python3
"""Smoke run of ceno_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ceno_tpu_torch/csrc`` and checks the port at
the shapes of the 2^20-step fibonacci proof, in phases:

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
  3. the PCS slice end to end with the default BasefoldParams: commit, open
     and verify the (61, 2^19) witness stack and the (13, 2^16) fixed stack,
     each with one random ext4 point per height class and the true MLE value
     of every slice; a claim with one value changed must be rejected. The
     kernel launch counts are read over this phase alone and must be those of
     the phase's 25 trees: K1 once per tree, K2 as ``merkle_plan`` plans them;
  4. the GKR slice: ``fibonacci_vm(174760)`` (1,048,571 steps) on the port's
     native emulator core (built from its C++ source; no fallback to the
     Python interpreter), the opcode chips' witness (rows per chip checked
     against the program), then stages 3-5 of ``zkvm/scheme.prove`` on the
     card: records per chip, one tower per tower size, one batched main
     zerocheck per height class, every record, tower layer and sumcheck bank
     checked to lie on the card; the port's verifiers must accept, and reject
     a proof over one changed output limb of the add chip; last, the digests
     of the same stages at ``fibonacci_vm(100)`` must equal the reference's,
     committed in ``ceno_tpu_torch/golden/gkr_fibonacci.json``;
  5. report: phase 3's span tree, the launch counts, a
     ``{"kernel_shapes": ...}`` line with every shape of phase 2, phase 4's
     span tree and its ``{"gkr": {...}}`` line, a ``{"kernels": [...]}`` line
     (the largest shapes; launches over phase 3), the card line and, last,
     ``{"ok": true, "device": {...}}``.

Any mismatch, rejected honest proof or exception exits nonzero before the
last line. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.emulator.state import CYCLE_START
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import chip as gkr_chip
from ceno_tpu_torch.gkr import tower
from ceno_tpu_torch.gkr.chip import ChipError
from ceno_tpu_torch.gkr.tower import TowerError
from ceno_tpu_torch.hash import poseidon2_merkle as pm
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.mle import ops
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import jagged as jg
from ceno_tpu_torch.sumcheck import terms
from ceno_tpu_torch.sumcheck.verifier import SumcheckError
from ceno_tpu_torch.utils import cuda_build, spans
from ceno_tpu_torch.zkvm import layout, witgen
from ceno_tpu_torch.zkvm.chips.opcodes import build_opcode_chips

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


# -- phase 4: the GKR slice ------------------------------------------------------

LABEL = b"ceno-tpu/zkvm/v8"  # the zkVM transcript label (ceno_tpu/zkvm/scheme.py:53)
GKR_ITERS = 174760           # bench.py's fibonacci_vm(174760): 1,048,571 steps
GOLDEN_ITERS = 100           # the size of the reference's committed digests
GKR_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gkr_fibonacci.json")


def sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def fib_rows(n: int) -> dict:
    """Rows of each opcode chip in fibonacci_vm(n), counted from FIBONACCI:
    each of the n iterations runs beq, add, three addi (two mv and the
    decrement) and j (jal); outside the loop run one more beq, one mv, the
    ecall (halt) and four li of two words each, lui + addi where the value
    has upper bits (n >= 2048 for li a0, n) and else addi + an addi nop."""
    lui = int(n >= 2048)
    rows = dict.fromkeys(("add", "sub", "addi", "lui", "beq", "bne", "jal", "slli",
                          "lw", "sw", "halt"), 0)
    rows.update(add=n, addi=3 * n + 9 - lui, lui=lui, beq=n + 1, jal=n, halt=1)
    return rows


def public_values(vm) -> np.ndarray:
    """The public values as zkvm/e2e.py's public_values_from_vm sets them, for
    the slots the opcode chips read: of these chips only halt reads
    instances (end pc, end cycle, exit code). The slots of chips not ported
    yet (shard, heap, stack and info lengths, the public-io digest) stay 0."""
    pv = np.zeros(layout.N_PUBLIC_VALUES, np.uint64)
    pv[layout.PV_INIT_PC] = vm.entry
    pv[layout.PV_INIT_CYCLE] = CYCLE_START
    pv[layout.PV_END_PC] = vm.pc
    pv[layout.PV_END_CYCLE] = vm.cycle
    pv[layout.PV_EXIT_CODE_LO] = vm.exit_code & 0xFFFF
    pv[layout.PV_EXIT_CODE_HI] = (vm.exit_code >> 16) & 0xFFFF
    return pv


def gkr_transcript(pv: np.ndarray) -> tuple:
    """The transcript and the two RLC challenges, as zkvm/scheme.prove starts
    them. The reference absorbs the verifying key's digest before the public
    values, and the witness commitment's root and every chip's instance
    count before the challenges; the key (with the table chips) and the
    witness commit are not part of this slice, so neither is absorbed."""
    t = Transcript(LABEL)
    t.append(pv)
    return t, np.array([t.sample_ext(), t.sample_ext()], np.uint64)


def gkr_prove(assigned: list, pv: np.ndarray) -> dict:
    """Stages 3-5 of zkvm/scheme.prove over the opcode chips that have rows:
    records per chip in registry order, one tower per tower size N_t
    (ascending; chips in registry order), then one main zerocheck per height
    class (ascending). Returns the proofs, the groups, the chips' tower
    inputs and contexts, and each stage's seconds."""
    t, challenges = gkr_transcript(pv)
    active = [a for a in assigned if a.num_instances > 0]
    inputs, seconds = {}, {"records": {}, "towers": {}, "class_main": {}}
    for a in active:
        if a.compiled.n_fixed:
            fail(f"{a.name}: fixed columns come with the key, which this slice does not build")
        n = a.n_rows
        structural = (np.stack([gkr_chip.structural_table(s, n, pv) for s in a.compiled.structural])
                      if a.compiled.structural else np.zeros((0, n), np.uint64))
        t0 = time.time()
        with spans.span(f"records/{a.name}"):
            inputs[a.name] = gkr_chip.build_tower_inputs(
                a.compiled, a.wit, np.zeros((0, n), np.uint64), structural, pv,
                a.num_instances, challenges, device=DEVICE)
            sync()
        seconds["records"][a.name] = time.time() - t0
    groups, towers, ctxs = {}, {}, {}
    for a in active:
        groups.setdefault(inputs[a.name].n_tower, []).append(a.name)
    for n_t in sorted(groups):
        t0 = time.time()
        towers[n_t], gctxs = gkr_chip.prove_group_towers([inputs[nm] for nm in groups[n_t]], t)
        seconds["towers"][f"2^{n_t.bit_length() - 1}"] = time.time() - t0
        ctxs.update(zip(groups[n_t], gctxs))
    classes, mains, openings = {}, {}, {}
    for a in active:
        classes.setdefault(a.n_rows, []).append(a.name)
    for h in sorted(classes):
        t0 = time.time()
        with spans.span(f"class-main/2^{h.bit_length() - 1}"):
            mains[h], openings[h] = gkr_chip.prove_class_main(
                [ctxs[nm] for nm in classes[h]], pv, challenges, t)
        seconds["class_main"][f"2^{h.bit_length() - 1}"] = time.time() - t0
    return dict(challenges=challenges, inputs=inputs, groups=groups, towers=towers, ctxs=ctxs,
                classes=classes, mains=mains, openings=openings, transcript=t, seconds=seconds)


def gkr_verify(assigned: list, pv: np.ndarray, run: dict) -> tuple:
    """The port's verifiers over ``run``'s proofs on a fresh transcript, in
    the prover's order. Returns (transcript, openings per class); raises
    ChipError, TowerError or SumcheckError on a rejected proof."""
    t, challenges = gkr_transcript(pv)
    by_name = {a.name: a for a in assigned}
    vctxs = {}
    for n_t in sorted(run["groups"]):
        names = run["groups"][n_t]
        entries = [(by_name[nm].compiled, by_name[nm].num_instances,
                    by_name[nm].n_rows.bit_length() - 1) for nm in names]
        out = gkr_chip.verify_group_towers(entries, run["towers"][n_t], pv, challenges, t)
        vctxs.update(zip(names, (o[0] for o in out)))
    openings = {}
    for h in sorted(run["classes"]):
        openings[h] = gkr_chip.verify_class_main(
            [vctxs[nm] for nm in run["classes"][h]], run["mains"][h], pv, challenges, t)
    return t, openings


def gkr_digests(run: dict) -> dict:
    """SHA-256 digests of each group's TowerProof, each class's
    ClassMainProof and the final transcript state (``interop.digest`` of
    their plain forms)."""
    return {
        "towers": {f"2^{n_t.bit_length() - 1}": interop.digest(dataclasses.asdict(p))
                   for n_t, p in sorted(run["towers"].items())},
        "class_main": {f"2^{h.bit_length() - 1}": interop.digest(dataclasses.asdict(p))
                       for h, p in sorted(run["mains"].items())},
        "transcript": interop.digest(list(run["transcript"].export_state())),
    }


@contextlib.contextmanager
def device_audit():
    """Record the device of every tower layer and every sumcheck bank made
    inside the block (the tower's layer builders and the banks' constructor,
    wrapped for its length)."""
    seen = {"layers": [], "banks": []}
    originals = (tower.product_layers, tower.logup_layers, terms.make_banks)

    def wrap(fn, key, tensors):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen[key] += [x.device.type for x in tensors(out)]
            return out
        return inner

    tower.product_layers = wrap(originals[0], "layers", lambda out: out)
    tower.logup_layers = wrap(originals[1], "layers", lambda out: out[0] + out[1])
    terms.make_banks = wrap(originals[2], "banks", lambda out: out)
    try:
        yield seen
    finally:
        tower.product_layers, tower.logup_layers, terms.make_banks = originals


def check_devices(run: dict, seen: dict) -> dict:
    """Every record, tower layer and sumcheck bank of ``run`` lies on DEVICE's
    kind; returns how many of each were checked."""
    want = torch.device(DEVICE).type
    records = [x.device.type for ti in run["inputs"].values()
               for x in ti.prods + [m for pq in ti.lps for m in pq]]
    counts = {"records": len(records), "layers": len(seen["layers"]), "banks": len(seen["banks"])}
    for what, devices in (("records", records), ("layers", seen["layers"]), ("banks", seen["banks"])):
        if not devices or set(devices) != {want}:
            fail(f"GKR {what} on {sorted(set(devices))}, not on {want}")
    return counts


def tamper_add(assigned: list) -> list:
    """``assigned`` with one output limb of the add chip changed (rd_lo of
    its first row): a cell its constraints and its write record bind."""
    out = []
    for a in assigned:
        if a.name == "add":
            wit = a.wit.copy()
            i = a.cb.wit_names.index("rd_lo")
            wit[i, 0] = (wit[i, 0] + np.uint64(1)) % np.uint64(bb.P)
            a = dataclasses.replace(a, wit=wit)
        out.append(a)
    return out


def emulate_and_assign(n: int) -> tuple:
    """fibonacci_vm(n) on the native core (never the Python interpreter),
    checked, then the opcode chips' witness, checked row by row against
    :func:`fib_rows`. Returns (vm, assigned, seconds)."""
    seconds = {}
    t0 = time.time()
    vm = programs.fibonacci_vm(n)
    view = native.run_trace_native(vm)
    seconds["emulate"] = time.time() - t0
    want = fib_rows(n)
    if view.n != sum(want.values()) or not vm.halted:
        fail(f"fibonacci_vm({n}) ran {view.n} steps (halted {vm.halted}), "
             f"FIBONACCI gives {sum(want.values())}")
    if vm.regs[10] != programs.fib_expected(n):
        fail(f"fibonacci_vm({n}): a0 = {vm.regs[10]}, fib_expected gives {programs.fib_expected(n)}")
    t0 = time.time()
    assigned = witgen.assign_opcode_chips(view, build_opcode_chips())
    seconds["witgen"] = time.time() - t0
    rows = {a.name: a.num_instances for a in assigned}
    if rows != want:
        fail(f"fibonacci_vm({n}): rows per chip {rows}, FIBONACCI gives {want}")
    return vm, assigned, seconds


def run_gkr(n: int) -> dict:
    """Phase 4 at fibonacci_vm(n): emulate, assign, prove (records, grouped
    towers, class mains), verify, then prove and verify again with one add
    output limb changed, which must be rejected. Returns the ``gkr`` line."""
    vm, assigned, seconds = emulate_and_assign(n)
    log(f"GKR: fibonacci_vm({n}) ran {sum(a.num_instances for a in assigned)} steps in "
        f"{seconds['emulate']:.2f}s on the native core, witness in {seconds['witgen']:.2f}s")
    pv = public_values(vm)
    t0 = time.time()
    spans.enable()
    with device_audit() as seen:
        run = gkr_prove(assigned, pv)
        sync()
    seconds["prove"] = time.time() - t0
    span_report = spans.report(min_seconds=0.001)
    spans.disable()
    checked = check_devices(run, seen)
    log(f"GKR: proved in {seconds['prove']:.2f}s; on {DEVICE}: {checked}")
    t0 = time.time()
    vt, vopen = gkr_verify(assigned, pv, run)
    seconds["verify"] = time.time() - t0
    if not np.array_equal(vt.export_state()[0], run["transcript"].export_state()[0]):
        fail("GKR: the verifier's transcript ended elsewhere than the prover's")
    for h, ops_ in run["openings"].items():
        if any(not np.array_equal(a.point, b.point) for a, b in zip(ops_, vopen[h])):
            fail(f"GKR: class 2^{h.bit_length() - 1} opens at another point than it proved")
    log(f"GKR: verified in {seconds['verify']:.2f}s")
    t0 = time.time()
    bad = tamper_add(assigned)
    try:
        gkr_verify(bad, pv, gkr_prove(bad, pv))
    except (ChipError, TowerError, SumcheckError) as e:
        log(f"GKR: a changed add output limb rejected ({type(e).__name__}: {e})")
    else:
        fail("GKR: a proof over a changed add output limb was accepted")
    seconds["tamper_prove_verify"] = time.time() - t0
    chips = {a.name: {"rows": a.num_instances, "height": a.n_rows} for a in assigned if a.num_instances}
    groups = {}
    for n_t, names in sorted(run["groups"].items()):
        levels = n_t.bit_length() - 2
        groups[f"2^{n_t.bit_length() - 1}"] = {"chips": names, "levels": levels,
                                                "rounds": levels * (levels + 1) // 2}
    classes = {f"2^{h.bit_length() - 1}": {"chips": names, "rounds": h.bit_length() - 1}
               for h, names in sorted(run["classes"].items())}
    return {"program": f"fibonacci_vm({n})", "steps": sum(a.num_instances for a in assigned),
            "device": DEVICE, "seconds": seconds, "stage_seconds": run["seconds"],
            "chips": chips, "tower_groups": groups, "classes": classes,
            "checked_on_device": checked, "span_report": span_report}


def gkr_golden_check(n: int = GOLDEN_ITERS) -> dict:
    """The port's digests at fibonacci_vm(n) against the reference's,
    committed in GKR_GOLDEN."""
    with open(GKR_GOLDEN) as f:
        want = json.load(f)
    vm, assigned, _ = emulate_and_assign(n)
    got = gkr_digests(gkr_prove(assigned, public_values(vm)))
    if want["program"] != f"fibonacci_vm({n})" or got != want["digests"]:
        fail(f"GKR digests at fibonacci_vm({n}) differ from {os.path.relpath(GKR_GOLDEN, ROOT)}: "
             f"{got} against {want}")
    log(f"GKR: fibonacci_vm({n}) digests equal the reference's ({len(got['towers'])} towers, "
        f"{len(got['class_main'])} class mains, transcript)")
    return got


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

    with phase("3 PCS slice end to end"):
        rng = np.random.default_rng(SEED + 1)
        spans.enable()
        pm.reset_launches()
        for name, classes in (("witness", WITNESS_CLASSES), ("fixed", FIXED_CLASSES)):
            with spans.span(name):
                run_slice(name, classes, rng, bf.BasefoldParams())
        torch.cuda.synchronize()
        launches = dict(pm.LAUNCHES)
        pcs_report = spans.report(min_seconds=0.001)
        spans.disable()
    torch.cuda.empty_cache()

    with phase("4 GKR slice"):
        torch.cuda.reset_peak_memory_stats()
        gkr = run_gkr(GKR_ITERS)
        gkr["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        t = time.time()
        gkr["golden_digests"] = gkr_golden_check()
        gkr["seconds"]["golden_check"] = time.time() - t
        gkr_report = gkr.pop("span_report")

    with phase("5 report"):
        print(pcs_report, flush=True)
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
        print(gkr_report, flush=True)
        print(json.dumps({"gkr": gkr}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
