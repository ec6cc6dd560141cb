#!/usr/bin/env python3
"""Compare builds of the Poseidon2 Merkle kernels (K1, K2) on one CUDA card.

    python3 tools/torch_p2_cores.py NAME=SOURCE.cu[:DEFINE,...] [NAME=...] \
        [--out ceno_tpu_torch/_build/p2_cores]

Each variant is a CUDA source with the C interface of
``ceno_tpu_torch/csrc/poseidon2_merkle.cu`` (``p2_leaf_sponge``,
``p2_compress_level``), built with the port's nvcc flags in its own nvcc
process, all started together, so one compiler crash costs only its variant.
A former version of the source can be compared by writing it out first, for
example ``git show <commit>:ceno_tpu_torch/csrc/poseidon2_merkle.cu``.

For every variant that builds, the script prints ptxas's register report and
the SASS instruction mix of each kernel (``cuobjdump -sass``): multiplies,
other integer ALU instructions, constant loads and constant-bank operands,
counted once per static instruction and, for K2, per executed instruction of
one thread, with loop trip counts inferred from each loop's Montgomery
products (one IMAD.HI each). Then it checks K1 and K2 of each variant bitwise
against the plain torch versions at the main path's shapes, (61, 2^22),
(13, 2^19) and (4, 2^21) and their trees, and on edge words at (61, 2^16)
(all 0, all p - 1, alternating), and times them in turns (variants in order,
then in reverse, twice), each time the CUDA-event mean of 5 launches after
a warm-up. The last line is one JSON object with
every number; it is also written to ``OUT/result.json``. While K1 runs back
to back at (61, 2^22), nvidia-smi samples the SM clock and power draw, which
turn K1's time into SM clocks per permutation.
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
EDGE_SHAPE = (61, 16)
SEED = 20
REPS, ROUNDS = 5, 2  # launches per timing; turns of (variants, reversed)
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
            cur = kernels.setdefault("leaf_sponge" if "leaf_sponge" in name else
                                     "compress_level" if "compress_level" in name else name, [])
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
    a loop whose body holds >= 64 Montgomery products (IMAD.HI) runs external
    rounds (4 per loop), else internal rounds (13). Check the printed loops:
    a loop split by the compiler into a body and a remainder is not handled."""
    addr = {a: k for k, (a, _, _) in enumerate(instrs)}
    weights, loops = [1] * len(instrs), []
    for k, (a, op, args) in enumerate(instrs):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", args)
        if not m or int(m.group(1), 16) >= a or int(m.group(1), 16) not in addr:
            continue
        lo = addr[int(m.group(1), 16)]
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
    lib.p2_compress_level.argtypes = [vp, vp, i64, vp]
    lib.p2_compress_level.restype = ctypes.c_int
    return lib


def leaf(lib, cols):
    c, m = cols.shape
    out = torch.empty((8, m), dtype=bb.DTYPE, device=cols.device)
    rc = lib.p2_leaf_sponge(cols.data_ptr(), out.data_ptr(), c, m,
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"p2_leaf_sponge: cudaError {rc}")
    return out


def tree(lib, leaves):
    cur, out = leaves, []
    while cur.shape[1] > 1:
        half = cur.shape[1] // 2
        nxt = torch.empty((8, half), dtype=bb.DTYPE, device=cur.device)
        rc = lib.p2_compress_level(cur.data_ptr(), nxt.data_ptr(), half,
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"p2_compress_level: cudaError {rc}")
        out.append(nxt)
        cur = nxt
    return out


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
    return all(torch.equal(a, b) for a, b in zip(a_list, b_list))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE.cu[:DEFINE,...]")
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
    result = {"card": card, "variants": {}}
    libs = {}
    for name, (path, out) in built.items():
        entry = result["variants"][name] = {
            "built": path is not None,
            "ptxas": [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]}
        if path is None:
            continue
        libs[name] = lib_of(path)
        try:
            for kname, instrs in sass(path).items():
                entry[f"sass_{kname}"] = {"static": mix(instrs)}
                if kname == "compress_level":  # one permutation per thread
                    weights, loops = dynamic_weights(instrs)
                    entry[f"sass_{kname}"].update(loops=loops, per_thread=mix(instrs, weights))
        except (OSError, subprocess.CalledProcessError) as e:
            log(f"[{name}] no SASS: {e}")
        log(f"[{name}] SASS: {json.dumps({k: v for k, v in entry.items() if k.startswith('sass')})}")

    rng = np.random.default_rng(SEED)
    ok = True
    times = collections.defaultdict(lambda: collections.defaultdict(list))
    for c, log_m in K1_SHAPES:
        m = 1 << log_m
        cols = bb.to_device(rng.integers(0, bb.P, size=(c, m), dtype=np.uint64), "cuda")
        want = plain_leaf(cols)
        want_tree = plain_tree(want)
        for name, lib in libs.items():
            got = leaf(lib, cols)
            good = torch.equal(got, want) and same(tree(lib, got), want_tree)
            ok &= good
            log(f"[{name}] ({c}, 2^{log_m}): K1 and K2 equal the plain versions: {good}")
        order = list(libs)
        for _ in range(ROUNDS):
            for name in order + order[::-1]:
                lib = libs[name]
                times[name][f"K1 ({c}, 2^{log_m})"].append(cuda_ms(lambda: leaf(lib, cols), REPS))
                times[name][f"K2 tree 2^{log_m}"].append(cuda_ms(lambda: tree(lib, want), REPS))
        if (c, log_m) == K1_SHAPES[0]:
            for name, lib in libs.items():
                clk = sm_clock_under_load(lambda: leaf(lib, cols), CLOCK_S)
                ms = sum(times[name][f"K1 ({c}, 2^{log_m})"]) / ROUNDS / 2
                if clk:
                    perms = -(-c // 8) * m
                    clk["sm_clocks_per_permutation"] = ms * 1e-3 * clk["sm_clock_mhz"] * 1e6 * \
                        torch.cuda.get_device_properties(0).multi_processor_count / perms
                result["variants"][name]["k1_under_load"] = clk
                log(f"[{name}] K1 ({c}, 2^{log_m}) under load: {clk}")
        del cols, want, want_tree
        torch.cuda.empty_cache()
    c, log_m = EDGE_SHAPE
    for pattern in ("zeros", "p-1", "alternating"):
        if pattern == "zeros":
            words = torch.zeros((c, 1 << log_m), dtype=bb.DTYPE, device="cuda")
        elif pattern == "p-1":
            words = torch.full((c, 1 << log_m), bb.P - 1, dtype=bb.DTYPE, device="cuda")
        else:
            words = (torch.arange(c * (1 << log_m), device="cuda").reshape(c, -1) % 2
                     * (bb.P - 1)).to(bb.DTYPE)
        want = plain_leaf(words)
        lv = words[:8].contiguous()
        want_tree = plain_tree(lv)
        for name, lib in libs.items():
            good = torch.equal(leaf(lib, words), want) and same(tree(lib, lv), want_tree)
            ok &= good
            log(f"[{name}] edge words {pattern} at ({c}, 2^{log_m}): equal: {good}")
    for name in libs:
        result["variants"][name]["ms"] = {k: sum(v) / len(v) for k, v in times[name].items()}
        result["variants"][name]["ms_each"] = {k: v for k, v in times[name].items()}
        log(f"[{name}] mean ms: {json.dumps(result['variants'][name]['ms'])}")
    result["all_equal"] = ok
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    log(card)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
