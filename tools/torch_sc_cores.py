#!/usr/bin/env python3
"""Compare builds of the sumcheck round-evaluation kernel (K6a) on one CUDA card.

    python3 tools/torch_sc_cores.py NAME=SOURCE.cu[:DEFINE,...] [NAME=...] [--check-only] \
        [--sweep] [--reps 5] [--out chiprun_out/sc_cores]

Each variant is a CUDA source with the C interface of
``ceno_tpu_torch/csrc/sumcheck.cu``: either the current ``sc_round_evals``,
which takes the launch plan of ``ceno_tpu_torch/sumcheck/terms.py``
(``round_evals_plan``), or the one before the plan (PR 12's, one thread per
half-cube element: ``blocks`` as its last argument but the stream), which
the script drives as that wrapper did (``min(1024, ceil(half / 256))``
blocks). A former version is compared by writing it out first, for example
``git show 802a472:ceno_tpu_torch/csrc/sumcheck.cu > chip_archive/sumcheck_pr12.cu``
(a git-ignored directory that the chip copy keeps); the build adds
``ceno_tpu_torch/csrc`` to the include path for its headers, and ``-D`` for
each DEFINE after the colon (``new4=ceno_tpu_torch/csrc/sumcheck.cu:K6A_MIN_BLOCKS=4``).
Each variant is built with the port's nvcc flags in its own nvcc process,
all started together, and the script prints ptxas's registers and spills
per kernel.

The shapes are ``chip_smoke.py`` phase 2's (``main_path_sumchecks``: tower
level 21 of the 2^22 group, the 2^19 and 2^18 class mains, the shard-RAM 2^9
class main, the keccak core 2^15, keccak ecall 2^10 and secp 2-row class
mains, the EC-sum quark), the tower level once more with the padded table
the fused tower ran before it dropped its padding terms (16 terms, 6 of
them with the zero scalar), and the 2^19 class main's second round (the
merged ext bank). Every variant must equal ``round_evals_plain`` bit for bit
at every shape; with ``--check-only`` the script stops there. Then it times
the contenders of each shape in turns (in order, then reversed, twice),
each time the CUDA-event mean of ``--reps`` calls after a warm-up: every
variant with its own plan and, with ``--sweep``, a plan variant also with a
half, twice and four times the plan's element ranges, and with 8, 16 and 32
threads a term. Beside each time: the bound (``chip_smoke.round_evals_bound``)
and its share. Everything goes to ``OUT/result.json``; the last line is a
one-line JSON summary: per shape, each contender's best time.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.fields import babybear as bb  # noqa: E402
from ceno_tpu_torch.gkr import tower  # noqa: E402
from ceno_tpu_torch.sumcheck import prover as sc_prover  # noqa: E402
from ceno_tpu_torch.sumcheck import terms as T  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402

SEED = cs.SEED + 2  # chip_smoke phase 2's sumcheck seed: the same banks and tables
ROUNDS = 2  # turns of (contenders, reversed)


def log(msg: str) -> None:
    print(msg, flush=True)


def build(variants: dict, out_dir: str) -> dict:
    """Start one nvcc per variant, all at once; name -> (library or None, ptxas by kernel)."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (src, defines) in variants.items():
        lib = os.path.join(out_dir, f"{name}.so")
        cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", cuda_build.CSRC_DIR,
               *[f"-D{d}" for d in defines], "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib, time.time())
    built = {}
    for name, (proc, lib, t0) in procs.items():
        out, _ = proc.communicate()
        log(f"[{name}] nvcc rc {proc.returncode} in {time.time() - t0:.1f}s")
        ptxas = cs.ptxas_by_kernel(out)
        for kernel, info in ptxas.items():
            if "round_evals" in kernel:
                log(f"[{name}]   {kernel}: {info}")
        if proc.returncode:
            log(out[-4000:])
        built[name] = (lib if proc.returncode == 0 else None, ptxas)
    return built


def has_plan(src: str) -> bool:
    """Whether the source's sc_round_evals takes a launch plan (t_lanes ...)."""
    sig = re.search(r'extern "C" int sc_round_evals\(([^)]*)\)', open(src).read())
    return "t_lanes" in sig.group(1)


def declare_old(lib):
    """The C signature of sc_round_evals before the plan."""
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.sc_round_evals.argtypes = [vp, vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
                                   i32, vp]
    lib.sc_round_evals.restype = ctypes.c_int
    return lib


def stream_of(t: torch.Tensor):
    return torch.cuda.current_stream().cuda_stream if t.is_cuda else None


def old_call(lib, base, ext, bidx, eidx, scalars, deg, out):
    """One K6a call through the pre-plan entry point, as its wrapper made it."""
    n, t, db, de = ext.shape[2], scalars.shape[1], bidx.shape[1], eidx.shape[1]
    blocks = max(1, min(1024, -(-(n // 2) // 256)))
    partial = torch.empty(blocks * (deg + 1) * 4, dtype=bb.DTYPE, device=ext.device)
    rc = lib.sc_round_evals(base.data_ptr() if db else None, ext.data_ptr(), bidx.data_ptr(),
                            eidx.data_ptr(), scalars.data_ptr(), partial.data_ptr(),
                            out.data_ptr(), n, ext.shape[1], t, db, de, deg, blocks,
                            stream_of(ext))
    cuda_build.raise_on(rc, "round_evals (pre-plan)")


def plan_call(lib, base, ext, bidx, eidx, scalars, deg, out, plan):
    T.launch_round_evals(lib, stream_of(ext), base if bidx.shape[1] else None, ext, bidx, eidx,
                         scalars, deg, out, check_indices=False, plan=plan)


def padded_tower(base, ext, scalars):
    """The tower level's inputs with compile_terms' padded table, as the
    fused tower ran them before it dropped the padding terms."""
    n_prod, n_logup = cs.TOWER_SPECS
    n_ext = 1 + 2 * n_prod + 4 * n_logup
    one = np.array([1, 0, 0, 0], np.uint64)
    bidx, eidx, _, _ = sc_prover.compile_terms(
        [sc_prover.TermSpec(one, eidx=e) for e in tower._level_terms(n_prod, n_logup)[1]],
        0, n_ext)
    pad = bidx.shape[0] - scalars.shape[1]
    sc = torch.cat([scalars, torch.zeros((4, pad), dtype=bb.DTYPE, device=scalars.device)], 1)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(ext.device)  # noqa: E731
    return base, ext, dev(bidx), dev(eidx), sc.contiguous()


def shapes(rng):
    """(what, base, ext, bidx, eidx, scalars, deg): phase 2's shapes, the
    padded tower table and the 2^19 class main's second round."""
    out = []
    for what, base, ext, bidx, eidx, scalars, deg in cs.main_path_sumchecks(rng):
        out.append((what, base, ext, bidx, eidx, scalars, deg))
        if what.startswith("tower"):
            out.append((f"{what}, padded table", *padded_tower(base, ext, scalars), deg))
        if what.startswith("2^19"):
            dev = ext.device
            r = bb.to_device(rng.integers(0, bb.P, size=4, dtype=np.uint64), dev)
            merged = T.fold_banks_plain(base, ext, r)
            midx = T.merge_indices(bidx.cpu().numpy(), eidx.cpu().numpy(), base.shape[0] - 1,
                                   ext.shape[1] - 1)
            empty = torch.zeros((bidx.shape[0], 0), dtype=torch.int32, device=dev)
            out.append((what.replace("first", "second"), bb.ones((1, merged.shape[2]), dev),
                        merged, empty, torch.from_numpy(midx).to(dev), scalars, deg))
    return out


def contenders(variants: dict, inputs, sweep: bool = False) -> list:
    """(label, fn(out)) for each way to run K6a on these inputs."""
    base, ext, bidx, eidx, scalars, deg = inputs
    t = bidx.shape[0]
    out = []
    for name, (lib, planned) in variants.items():
        if not planned:
            out.append((name, lambda o, lib=lib: old_call(lib, base, ext, bidx, eidx, scalars,
                                                           deg, o)))
            continue
        plan = T.eval_plan(ext, bidx, eidx)
        plans = {f"{name} {plan}": plan}
        for scale in ((0.5, 2, 4) if sweep else ()):
            ranges = max(1, min(T.MAX_RANGES, round(plan.ranges * scale)))
            p = T.eval_plan(ext, bidx, eidx, ranges=ranges)
            plans.setdefault(f"{name} {p}", p)
        for e_lanes in ((8, 16, 32) if sweep else ()):
            t_lanes = min(max(t, 1), T.THREADS // e_lanes)
            t_lanes = -(-max(t, 1) // -(-max(t, 1) // t_lanes))
            try:
                p = T.eval_plan(ext, bidx, eidx, t_lanes=t_lanes)
            except ValueError:
                continue
            plans.setdefault(f"{name} {p}", p)
        for label, p in plans.items():
            out.append((label, lambda o, lib=lib, p=p: plan_call(lib, base, ext, bidx, eidx,
                                                                  scalars, deg, o, p)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE.cu[:DEFINE,...]")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "sc_cores"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_sc_cores: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    srcs = {}
    for v in args.variants:
        name, spec = v.split("=", 1)
        src, _, defines = spec.partition(":")
        srcs[name] = (src, [d for d in defines.split(",") if d])
    built = build(srcs, args.out)
    variants = {}
    for name, (lib, _) in built.items():
        if lib is None:
            continue
        planned = has_plan(srcs[name][0])
        handle = ctypes.CDLL(lib)
        variants[name] = (T.declare(handle) if planned else declare_old(handle), planned)
    result = {"card": card, "ptxas": {n: p for n, (_, p) in built.items()}, "shapes": []}
    cs.DEVICE = "cuda"
    for what, base, ext, bidx, eidx, scalars, deg in shapes(np.random.default_rng(SEED)):
        inputs = (base, ext, bidx, eidx, scalars, deg)
        want = T.round_evals_plain(base if bidx.shape[1] else None, ext, bidx, eidx, scalars,
                                   deg=deg)
        b_ms, b_by = cs.round_evals_bound(base, ext, bidx, eidx, scalars, deg)
        row = {"shape": f"{what}: base {tuple(base.shape)}, ext {tuple(ext.shape)}, T "
                        f"{bidx.shape[0]}, DB {bidx.shape[1]}, DE {eidx.shape[1]}, deg {deg}",
               "bound_ms": b_ms, "bound_by": b_by, "times": {}}
        runs = contenders(variants, inputs, args.sweep)
        for label, fn in runs:
            out = torch.empty((deg + 1, 4), dtype=bb.DTYPE, device="cuda")
            fn(out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                cs.fail(f"{label} differs from round_evals_plain on the {what}")
        log(f"{row['shape']}: {len(runs)} contenders equal round_evals_plain; bound "
            f"{b_ms:.4f} ms ({b_by})")
        if not args.check_only:
            out = torch.empty((deg + 1, 4), dtype=bb.DTYPE, device="cuda")
            for _ in range(ROUNDS):
                for label, fn in runs + runs[::-1]:
                    row["times"].setdefault(label, []).append(
                        cs.cuda_ms(lambda: fn(out), reps=args.reps))
            for label, ts in row["times"].items():
                log(f"  {label}: {min(ts):.4f} ms (turns {[round(t, 4) for t in ts]}), "
                    f"{b_ms / min(ts):.1%} of bound")
        result["shapes"].append(row)
        del inputs, base, ext, bidx, eidx, scalars, runs
        torch.cuda.empty_cache()
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"sc_cores": [{"shape": r["shape"], "bound_ms": r["bound_ms"],
                                    "best_ms": {k: min(v) for k, v in r["times"].items()}}
                                   for r in result["shapes"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
