#!/usr/bin/env python3
"""Compare builds of the Poseidon2 Merkle kernels (K1, K2) on one CUDA card.

    python3 tools/torch_p2_cores.py NAME=SOURCE.cu[:DEFINE,...] [NAME=...] \
        [--plans T,L,TOP,SPLIT,TS,LS ...] [--check-only] [--out ceno_tpu_torch/_build/p2_cores]

Each variant is a CUDA source with the C interface of
``ceno_tpu_torch/csrc/poseidon2_merkle.cu``: ``p2_leaf_sponge`` and either
the tree entry point ``p2_merkle_levels`` or, in sources before it, the
one-level ``p2_compress_level``, which the script then drives one level at a
time. Each is built with the port's nvcc flags in its own nvcc process, all
started together, so one compiler crash costs only its variant. A former
version of the source can be compared by writing it out first, for example
``git show <commit>:ceno_tpu_torch/csrc/poseidon2_merkle.cu``.

For every variant that builds, the script prints ptxas's registers, spills
and static shared memory per kernel and the SASS instruction mix of each
kernel (``cuobjdump -sass``): multiplies, other integer ALU instructions,
constant loads and constant-bank operands, counted once per static
instruction and, for K2, per executed instruction of one thread and one
level, with loop trip counts inferred from each innermost loop's Montgomery
products (one IMAD.HI each). Then it checks K1 and K2 of each variant bitwise
against the plain torch versions at the main path's shapes, (61, 2^22),
(13, 2^19) and (4, 2^21) and their trees, on every tree from 2^1 to 2^11
and on edge words at (61, 2^16) (all 0, all p - 1, alternating); a tree
variant is checked with the port's launch plan (``merkle_plan`` in
``ceno_tpu_torch/hash/poseidon2_merkle.py``) and with every plan of
``--plans`` (see ``sweep_plan`` below). With ``--check-only`` it stops
there. Otherwise it times them in turns (contenders in order, then in
reverse, twice), each time the CUDA-event mean of 5 calls after a warm-up.
K2's contenders are each variant through a wrapper (for a tree variant, the
port's ``merkle_levels`` with its default plan; for a one-level variant, the
per-level wrapper the port had before the tree entry point: an allocation,
a device context, a stream query and a ctypes call per level) and with bare
ctypes launches into preallocated buffers, once per plan. For a tree
variant it then splits the wrapper's host time into its steps (checks,
allocation, device context, stream query, the ctypes call with its
launches, the level views), each the perf_counter mean of many calls.
Every number goes to ``OUT/result.json``; the output lists the fastest
contenders and ends with a one-line JSON summary. While K1 runs back to back at (61, 2^22), nvidia-smi
samples the SM clock and power draw, which turn K1's time into SM clocks per
permutation.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ceno_tpu_torch.fields import babybear as bb  # noqa: E402
from ceno_tpu_torch.hash import poseidon2_merkle as pm  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402

K1_SHAPES = [(61, 22), (13, 19), (4, 21)]
SMALL_TREES = range(1, 12)  # log2 of the leaf counts of the small trees checked
SHOW = 25  # fastest K2 contenders printed (result.json has them all)
TIMED_SMALL = [1, 2, 4, 8, 11, 14]  # log2 of the small trees timed (per-level latency)
EDGE_SHAPE = (61, 16)
SEED = 20
HOST_TREES = [1, 4, 8, 14, 22]  # log2 of the trees whose wrapper host time is split into steps
HOST_REPS = 100  # calls per host-time mean (at most 600 launches queued)
REPS, ROUNDS = 5, 2  # calls per timing; turns of (contenders, reversed)
CLOCK_S = 2.0  # seconds of K1 at (61, 2^22) while nvidia-smi samples the clock
MUL_SKIP = ("MOV", "IADD", "SHL")  # IMAD forms that multiply nothing
ALU_OPS = {"IADD3", "IMNMX", "VIMNMX", "ISETP", "SEL", "LOP3", "SHF", "LEA", "PRMT",
           "IABS", "PLOP3", "VIADD", "VIADDMNMX", "IMNMX3", "VIMNMX3", "FSEL", "P2R", "R2P"}


def log(msg: str) -> None:
    print(msg, flush=True)


def build(variants: dict, out_dir: str) -> dict:
    """Start one nvcc per variant, all at once; name -> (library path or None, log)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, defines) in variants.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *[f"-D{d}" for d in defines],
               "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, time.time())
    built = {}
    for name, (proc, lib, t0) in procs.items():
        out, _ = proc.communicate()
        ok = proc.returncode == 0
        log(f"[{name}] nvcc rc {proc.returncode} in {time.time() - t0:.1f}s")
        for line in out.splitlines():
            if not ok or "registers" in line or "spill" in line or "error" in line:
                log(f"[{name}]   {line.strip()}")
        built[name] = (lib if ok else None, out)
    return built


def ptxas_by_kernel(out: str) -> dict:
    """K1 / K2 -> registers, spill bytes and static shared memory from ptxas -v."""
    kernels, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            cur = kernel_key(m.group(1))
            continue
        if cur is None:
            continue
        info = kernels.setdefault(cur, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            info["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            info["smem_bytes"] = int(s.group(1)) if s else 0
    return kernels


def kernel_key(name: str) -> str:
    """K1, K2 with a thread per parent, K2 with four (the split kernel)."""
    return ("leaf_sponge" if "leaf_sponge" in name else
            "compress_level_split" if "merkle_levels_split" in name else
            "compress_level" if "compress_level" in name or "merkle_levels" in name else name)


def sass(lib: str) -> dict:
    """Kernel name -> list of (address, opcode with modifiers, operand text);
    the listing is kept beside the library."""
    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    with open(lib[:-3] + ".sass", "w") as f:
        f.write(text)
    kernels, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            cur = kernels.setdefault(kernel_key(name), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*(.*?);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return kernels


def classify(op: str, args: str) -> list:
    base, _, mods = op.partition(".")
    kinds = []
    if base == "IMAD" and not any(mods.startswith(s) for s in MUL_SKIP):
        kinds.append("mul")
    elif base == "IMAD":
        kinds.append("imad_nonmul")
    elif base in ALU_OPS:
        kinds.append("alu")
    elif base in ("LDC", "ULDC"):
        kinds.append("const_load")
    elif base in ("LDG", "STG", "LD", "ST"):
        kinds.append("memory")
    else:
        kinds.append("other")
    if "c[0x3]" in args:
        kinds.append("const_operand")
    if op.startswith("IMAD.HI"):
        kinds.append("redc_hi")
    return kinds


def mix(instrs, weights=None) -> dict:
    counts = collections.Counter()
    ops = collections.Counter()
    for k, (_, op, args) in enumerate(instrs):
        w = 1 if weights is None else weights[k]
        for kind in classify(op, args):
            counts[kind] += w
        counts["total"] += w
        ops[op] += w
    counts["top_ops"] = dict(ops.most_common(14))
    return dict(counts)


def dynamic_weights(instrs) -> tuple:
    """Executions of each instruction by one thread, from backward branches:
    an innermost loop whose body holds >= 64 Montgomery products (IMAD.HI)
    runs external rounds (4 per loop), else internal rounds (13). A loop that
    holds another (K2's loop over levels) counts once, so the mix is one
    permutation's. Check the printed loops: a loop split by the compiler into
    a body and a remainder is not handled."""
    addr = {a: k for k, (a, _, _) in enumerate(instrs)}
    weights, loops, spans = [1] * len(instrs), [], []
    for k, (a, op, args) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= a or int(m.group(1), 16) not in addr:
            continue
        spans.append((addr[int(m.group(1), 16)], k))
    for lo, k in spans:
        if any(lo <= lo2 and k2 <= k and (lo2, k2) != (lo, k) for lo2, k2 in spans):
            continue
        a = instrs[k][0]
        h = sum(1 for _, o, _ in instrs[lo:k + 1] if o.startswith("IMAD.HI"))
        # products per round: 64 external; 20 internal, 21 with the 15 * s product
        per_round = 64 if h >= 64 else next((r for r in (20, 21) if h % r == 0), h)
        total = 4 if h >= 64 else 13
        rounds_per_iter = max(1, round(h / per_round))
        trip = total // rounds_per_iter
        loops.append(dict(start=hex(instrs[lo][0]), end=hex(a), body=k + 1 - lo, redc_hi=h, trip=trip))
        for j in range(lo, k + 1):
            weights[j] *= trip
    return weights, loops


def lib_of(path: str):
    lib = ctypes.CDLL(path)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.p2_leaf_sponge.argtypes = [vp, vp, ctypes.c_int, i64, vp]
    lib.p2_leaf_sponge.restype = ctypes.c_int
    if is_tree(lib):
        lib.p2_merkle_levels.argtypes = [vp, vp, i64, vp, ctypes.c_int, vp]
        lib.p2_merkle_levels.restype = ctypes.c_int
    else:
        lib.p2_compress_level.argtypes = [vp, vp, i64, vp]
        lib.p2_compress_level.restype = ctypes.c_int
    return lib


def is_tree(lib) -> bool:
    return hasattr(lib, "p2_merkle_levels")


def leaf(lib, cols):
    c, m = cols.shape
    out = torch.empty((8, m), dtype=bb.DTYPE, device=cols.device)
    rc = lib.p2_leaf_sponge(cols.data_ptr(), out.data_ptr(), c, m,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"p2_leaf_sponge: cudaError {rc}")
    return out


def sweep_plan(spec: str, m: int) -> tuple:
    """The launches of plan ``spec`` = "T,L,TOP,SPLIT,TS,LS" for an m-leaf
    tree, as (levels, threads, lanes) triples for ``p2_merkle_levels``.

    While a level has more than TOP digests: up to L levels a launch with
    min(T, parents) threads a block, one per parent, until the parents are at
    most SPLIT; from there up to LS levels a launch with four threads per
    parent, TS / 4 parents a block (fewer where the level has fewer). One
    block then takes the last <= TOP digests, four threads per parent, or one
    if SPLIT is 0 (one thread per parent throughout). The port's own plan is
    "256,2,128,16384,512,8"; the C entry point rejects a plan it cannot run."""
    threads, levels, top, split, split_threads, split_levels = (int(v) for v in spec.split(","))
    plan = []
    while m > top:
        half = m // 2
        if split and half <= split:
            per_block = min(split_threads // 4, half)
            n = min(split_levels, (m // top).bit_length() - 1, per_block.bit_length())
            plan.append((n, 4 * per_block, 4))
        else:
            t = min(threads, half)
            n = min(levels, (m // top).bit_length() - 1, t.bit_length())
            if split:
                n = min(n, (half // split).bit_length() - 1)
            plan.append((n, t, 1))
        m >>= n
    if m > 1:
        lanes = 4 if split else 1
        plan.append((m.bit_length() - 1, lanes * (m // 2), lanes))
    return tuple(plan)


def tree_bare(lib, stream, leaves, out, args) -> None:
    """Every level with one bare ctypes call into a preallocated buffer."""
    rc = lib.p2_merkle_levels(leaves.data_ptr(), out.data_ptr(), leaves.shape[1], *args, stream)
    if rc:
        raise RuntimeError(f"p2_merkle_levels: cudaError {rc}")


def tree_wrapper(lib, leaves):
    """The port's merkle_levels (default plan) on this variant's library."""
    pm._lib = lambda: lib
    return pm.merkle_levels(leaves)


def levels_bare(lib, stream, leaves, outs) -> None:
    """One bare ctypes call per level into preallocated (8, m/2^l) buffers."""
    cur = leaves
    for nxt in outs:
        rc = lib.p2_compress_level(cur.data_ptr(), nxt.data_ptr(), nxt.shape[1], stream)
        if rc:
            raise RuntimeError(f"p2_compress_level: cudaError {rc}")
        cur = nxt


_COUNT = {"compress_level": 0}


def levels_wrapper(lib, leaves):
    """The per-level wrapper the port had before the tree entry point, call
    for call: an allocation, a device context, a stream query, a ctypes call
    and a counter per level."""
    cur, out = leaves, []
    while cur.shape[1] > 1:
        half = cur.shape[1] // 2
        nxt = torch.empty((8, half), dtype=bb.DTYPE, device=cur.device)
        with torch.cuda.device(cur.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.p2_compress_level(cur.data_ptr(), nxt.data_ptr(), half, stream)
        if rc:
            raise RuntimeError(f"p2_compress_level: cudaError {rc}")
        _COUNT["compress_level"] += 1
        out.append(nxt)
        cur = nxt
    return out


def contenders(name, lib, leaves, plans) -> list:
    """(label, launches, fn returning the levels) for K2 of one variant."""
    m = leaves.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    if not is_tree(lib):
        outs = [torch.empty((8, m >> k), dtype=bb.DTYPE, device=leaves.device)
                for k in range(1, m.bit_length())]
        return [(f"{name} per-level wrapper", len(outs), lambda: levels_wrapper(lib, leaves)),
                (f"{name} per-level bare", len(outs),
                 lambda: levels_bare(lib, stream, leaves, outs) or outs)]
    out = torch.empty(8 * (m - 1), dtype=bb.DTYPE, device=leaves.device)
    views = pm.level_views(out, m)
    rows = [(f"{name} tree wrapper", len(pm.merkle_plan(m)), lambda: tree_wrapper(lib, leaves))]
    for spec in ["default", *plans]:
        args = pm.c_plan(pm.merkle_plan(m) if spec == "default" else sweep_plan(spec, m))
        rows.append((f"{name} bare {spec}", args[1],
                     lambda a=args: tree_bare(lib, stream, leaves, out, a) or views))
    return rows


def host_us(fn, reps: int = HOST_REPS) -> float:
    """Mean host time of ``fn()`` in microseconds, the card drained before
    and after (perf_counter; the launches queue without waiting)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


def host_breakdown(lib, leaves) -> dict:
    """Host microseconds per call of each step of the port's merkle_levels
    on ``leaves`` (this variant's library), and of the whole wrapper."""
    m = leaves.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(8 * (m - 1), dtype=bb.DTYPE, device=leaves.device)
    args = pm.c_plan(pm.merkle_plan(m))

    def device_context():
        with torch.cuda.device(leaves.device):
            pass

    def views_by_split():  # split, then view each level: the wrapper's first version
        widths = [m >> k for k in range(1, m.bit_length())]
        return [v.view(8, w) for v, w in zip(out.split([8 * w for w in widths]), widths)]

    steps = {
        "checks": lambda: (pm._check_digests(leaves, "merkle_levels", True),
                           pm._check(leaves, "merkle_levels")),
        "allocation": lambda: torch.empty(8 * (m - 1), dtype=bb.DTYPE, device=leaves.device),
        "device context": device_context,
        "stream query": lambda: torch.cuda.current_stream().cuda_stream,
        "ctypes call and launches": lambda: tree_bare(lib, stream, leaves, out, args),
        "level views": lambda: pm.level_views(out, m),
        "level views by split and view": views_by_split,
        "merkle_levels": lambda: tree_wrapper(lib, leaves),
    }
    return {step: host_us(fn) for step, fn in steps.items()}


def plain_tree(leaves):
    cur, out = leaves, []
    while cur.shape[1] > 1:
        cur = pm.compress_level_plain(cur)
        out.append(cur)
    return out


def plain_leaf(cols):
    chunk = 1 << 20
    return torch.cat([pm.leaf_sponge_plain(cols[:, s:s + chunk])
                      for s in range(0, cols.shape[1], chunk)], 1)


def cuda_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sm_clock_under_load(fn, seconds: float) -> dict:
    """SM clock and power draw that nvidia-smi samples every 100 ms while
    ``fn`` runs back to back for ``seconds``; medians of the samples taken."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    try:
        t = time.time()
        while time.time() - t < seconds:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines()[2:-1] if line.strip()]
    if not rows:
        return {}
    return {"sm_clock_mhz": float(np.median([r[0] for r in rows])),
            "power_w": float(np.median([r[1] for r in rows])), "samples": len(rows)}


def same(a_list, b_list) -> bool:
    return len(a_list) == len(b_list) and all(torch.equal(a, b) for a, b in zip(a_list, b_list))


def check_k2(libs, plans, leaves, what) -> bool:
    """Every K2 contender of every variant against the plain levels, bitwise."""
    want, ok = plain_tree(leaves), True
    for name, lib in libs.items():
        bad = [label for label, _, fn in contenders(name, lib, leaves, plans)
               if not same(list(fn()), want)]
        ok &= not bad
        log(f"[{name}] K2 {what}: {'all equal' if not bad else f'DIFFER: {bad}'}")
    return ok


def edge_words(pattern: str, c: int, log_m: int) -> torch.Tensor:
    m = 1 << log_m
    if pattern == "zeros":
        return torch.zeros((c, m), dtype=bb.DTYPE, device="cuda")
    if pattern == "p-1":
        return torch.full((c, m), bb.P - 1, dtype=bb.DTYPE, device="cuda")
    return (torch.arange(c * m, device="cuda").reshape(c, -1) % 2 * (bb.P - 1)).to(bb.DTYPE)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE.cu[:DEFINE,...]")
    ap.add_argument("--plans", nargs="*", default=[],
                    help="K2 launch plans T,L,TOP,SPLIT,TS,LS (sweep_plan) checked and "
                         "timed for tree variants beside the port's own")
    ap.add_argument("--check-only", action="store_true", help="build and check; time nothing")
    ap.add_argument("--out", default=os.path.join(cuda_build.BUILD_DIR, "p2_cores"),
                    help="directory (git-ignored) for the libraries, SASS listings and result.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_p2_cores: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    variants = {}
    for spec in args.variants:
        name, _, rest = spec.partition("=")
        src, _, defs = rest.partition(":")
        variants[name] = (src, [d for d in defs.split(",") if d])
    built = build(variants, args.out)
    result = {"card": card, "plans": args.plans, "variants": {}}
    libs = {}
    for name, (path, out) in built.items():
        entry = result["variants"][name] = {
            "built": path is not None,
            "ptxas": [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln],
            "ptxas_by_kernel": ptxas_by_kernel(out)}
        log(f"[{name}] ptxas by kernel: {json.dumps(entry['ptxas_by_kernel'])}")
        if path is None:
            continue
        libs[name] = lib_of(path)
        entry["k2_entry"] = "p2_merkle_levels" if is_tree(libs[name]) else "p2_compress_level"
        try:
            for kname, instrs in sass(path).items():
                entry[f"sass_{kname}"] = {"static": mix(instrs)}
                if kname == "compress_level":  # one permutation per thread and level
                    weights, loops = dynamic_weights(instrs)
                    entry[f"sass_{kname}"].update(loops=loops, per_thread=mix(instrs, weights))
        except (OSError, subprocess.CalledProcessError) as e:
            log(f"[{name}] no SASS: {e}")
        log(f"[{name}] SASS: {json.dumps({k: v for k, v in entry.items() if k.startswith('sass')})}")
    plain_lib = pm._lib
    rng = np.random.default_rng(SEED)
    ok = True
    for log_m in SMALL_TREES:
        ok &= check_k2(libs, args.plans, bb.to_device(
            rng.integers(0, bb.P, size=(8, 1 << log_m), dtype=np.uint64), "cuda"), f"tree 2^{log_m}")
    c, log_m = EDGE_SHAPE
    for pattern in ("zeros", "p-1", "alternating"):
        words = edge_words(pattern, c, log_m)
        good = True
        for name, lib in libs.items():
            good &= torch.equal(leaf(lib, words), plain_leaf(words))
        log(f"K1 edge words {pattern} at ({c}, 2^{log_m}), every variant: equal: {good}")
        ok &= good & check_k2(libs, args.plans, words[:8].contiguous(),
                              f"edge words {pattern}, (8, 2^{log_m}) tree")
    times = collections.defaultdict(lambda: collections.defaultdict(list))
    launches = collections.defaultdict(dict)
    for c, log_m in K1_SHAPES:
        m = 1 << log_m
        cols = bb.to_device(rng.integers(0, bb.P, size=(c, m), dtype=np.uint64), "cuda")
        want = plain_leaf(cols)
        for name, lib in libs.items():
            good = torch.equal(leaf(lib, cols), want)
            ok &= good
            log(f"[{name}] K1 ({c}, 2^{log_m}) equals the plain version: {good}")
        ok &= check_k2(libs, args.plans, want, f"tree 2^{log_m}")
        if args.check_only:
            continue
        rows = [(f"{name} K1", f"K1 ({c}, 2^{log_m})", 1, lambda lib=lib: leaf(lib, cols))
                for name, lib in libs.items()]
        for name, lib in libs.items():
            rows += [(label, f"K2 tree 2^{log_m}", n, fn)
                     for label, n, fn in contenders(name, lib, want, args.plans)]
        for _ in range(ROUNDS):
            for label, key, n, fn in rows + rows[::-1]:
                times[label][key].append(cuda_ms(fn, REPS))
                launches[label][key] = n
        if (c, log_m) == K1_SHAPES[0]:
            for name, lib in libs.items():
                clk = sm_clock_under_load(lambda: leaf(lib, cols), CLOCK_S)
                ms = sum(times[f"{name} K1"][f"K1 ({c}, 2^{log_m})"]) / ROUNDS / 2
                if clk:
                    perms = -(-c // 8) * m
                    clk["sm_clocks_per_permutation"] = ms * 1e-3 * clk["sm_clock_mhz"] * 1e6 * \
                        torch.cuda.get_device_properties(0).multi_processor_count / perms
                result["variants"][name]["k1_under_load"] = clk
                log(f"[{name}] K1 ({c}, 2^{log_m}) under load: {clk}")
        del cols, want, rows
        torch.cuda.empty_cache()
    for log_m in [] if args.check_only else TIMED_SMALL:
        leaves = bb.to_device(rng.integers(0, bb.P, size=(8, 1 << log_m), dtype=np.uint64), "cuda")
        rows = [(label, f"K2 tree 2^{log_m}", n, fn) for name, lib in libs.items()
                for label, n, fn in contenders(name, lib, leaves, args.plans)]
        for _ in range(ROUNDS):
            for label, key, n, fn in rows + rows[::-1]:
                times[label][key].append(cuda_ms(fn, REPS))
                launches[label][key] = n
    for log_m in [] if args.check_only else HOST_TREES:
        leaves = bb.to_device(rng.integers(0, bb.P, size=(8, 1 << log_m), dtype=np.uint64), "cuda")
        for name, lib in libs.items():
            if is_tree(lib):
                us = host_breakdown(lib, leaves)
                result["variants"][name].setdefault("host_us", {})[f"tree 2^{log_m}"] = us
                log(f"[{name}] host us per call, tree 2^{log_m}: "
                    + ", ".join(f"{k} {v:.2f}" for k, v in us.items()))
    pm._lib = plain_lib
    result["ms"] = {label: {k: sum(v) / len(v) for k, v in d.items()} for label, d in times.items()}
    result["ms_each"] = {label: dict(d) for label, d in times.items()}
    result["launches"] = {label: dict(d) for label, d in launches.items()}
    result["all_equal"] = ok
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    trees = [f"K2 tree 2^{log_m}" for _, log_m in K1_SHAPES]
    ranked = sorted((v[trees[0]], label) for label, v in result["ms"].items() if trees[0] in v)
    if ranked:
        log(f"K2 contenders, fastest over the first tree first (ms over {' / '.join(trees)}; "
            "launches):")
        for i, (_, label) in enumerate(ranked):
            if i < SHOW or " bare " not in label or label.endswith(" bare default"):
                v = result["ms"][label]
                log(f"  {label:36s} " + " / ".join(f"{v[k]:.4f}" for k in trees) +
                    f"  ({' / '.join(str(launches[label][k]) for k in trees)})")
        small = [f"K2 tree 2^{n}" for n in TIMED_SMALL]
        log(f"K2 over small trees (ms over {' / '.join(small)}; launches):")
        for label, v in result["ms"].items():
            if small[0] in v and (" bare " not in label or label.endswith(" bare default")):
                log(f"  {label:36s} " + " / ".join(f"{v[k]:.4f}" for k in small) +
                    f"  ({' / '.join(str(launches[label][k]) for k in small)})")
        for label, v in result["ms"].items():
            if label.endswith(" K1"):
                log(f"  {label:36s} " + json.dumps(v))
    log(f"all equal: {ok}")
    log(card)
    print(json.dumps({"card": card, "all_equal": ok, "result": os.path.join(args.out, "result.json"),
                      "ptxas_by_kernel": {n: v["ptxas_by_kernel"]
                                          for n, v in result["variants"].items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
