#!/usr/bin/env python3
"""Compare builds of the on-device Fiat-Shamir duplex kernel (K5/K7) on one CUDA card.

    python3 tools/torch_duplex_cores.py NAME=SOURCE.cu [NAME=...] [--check-only] \
        [--graph 200] [--out chiprun_out/duplex_cores]

Each variant is a CUDA source with the C interface of
``ceno_tpu_torch/csrc/sumcheck.cu``'s ``sc_duplex``. A former version is
compared by writing it out first, for example the one-thread kernel of commit
8b8cee1: ``git show 8b8cee1:ceno_tpu_torch/csrc/sumcheck.cu >
chip_archive/sumcheck_8b8cee1.cu`` (a git-ignored directory); the build
adds ``ceno_tpu_torch/csrc`` to the include path for its headers. Each
variant is built with the port's nvcc flags in its own nvcc process, beside
the floors' source below, all started together; the script prints ptxas's
registers, stack frame and spills.

First every variant must equal ``sumcheck/fused.duplex_plain`` bit for bit
at ``chip_smoke.duplex_check_cases``: from every pos (0-8), sq_pos 0, 4 or 8
and absorbed or not, with ``chip_smoke.DUPLEX_CHECKS``' absorbs and powers in
turn, and at each step shape below; with ``--check-only`` the script stops
there. Then it times the variants in turns (in order, then reversed, twice)
at ``chip_smoke``'s ``DUPLEX_STEPS``, the fibonacci prove's steps from where
the prove makes them: a degree-3 round (16 words, 2 permutations), a
degree-4 round (20 words, 3), the fused tower's alpha with its 12 powers, a
tower level's 96 words of evals (12 permutations). Each time is the device
time of one launch without the host's pacing: ``--graph`` launches captured
in one CUDA graph, replayed between two CUDA events (``chip_smoke.graph_ms``).
Beside it, the kernel's own duration in a ``torch.profiler`` trace of 50
launches (no launch gaps), and the floors that stand in for a bound, as
latency binds this kernel: an empty ``<<<1, 32>>>`` kernel timed both ways,
and one permutation's latency from a single launch that chains 1,000 of them
on one warp (``permute_warp``) and on one thread (``permute``), the two
chains checked equal. The operations bound of ``chip_smoke.bound`` is
printed too. Everything goes to
``OUT/result.json``; the last line is a one-line JSON summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.fields import babybear as bb  # noqa: E402
from ceno_tpu_torch.sumcheck import fused  # noqa: E402
from ceno_tpu_torch.sumcheck import terms as T  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402
from tools.torch_sc_cores import build  # noqa: E402

SEED = cs.SEED + 2
ROUNDS = 2  # turns of (variants, reversed)
TRACE_LAUNCHES = 50
CHAIN = 1000  # permutations in the one-launch chains

FLOORS_SRC = r"""
// The duplex's latency floors: an empty one-warp kernel, and chains of
// permutations in one launch, on one warp and on one thread.
#include <cstdint>
#include <cuda_runtime.h>

#include "babybear.cuh"
#include "poseidon2.cuh"

namespace {

__global__ void __launch_bounds__(32) empty_kernel() {}

__global__ void __launch_bounds__(32) chain_warp_kernel(uint32_t* state, int n) {
  const int lane = threadIdx.x, i = lane & (WIDTH - 1);
  uint32_t x = state[i];
  const uint32_t diag = DIAG[i];
  for (int k = 0; k < n; ++k) x = permute_warp(x, diag, lane);
  if (lane < WIDTH) state[lane] = x;
}

__global__ void __launch_bounds__(1) chain_thread_kernel(uint32_t* state, int n) {
  uint32_t st[WIDTH];
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) st[j] = state[j];
  for (int k = 0; k < n; ++k) permute(st);
#pragma unroll
  for (int j = 0; j < WIDTH; ++j) state[j] = st[j];
}

}  // namespace

extern "C" int floor_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int floor_chain(void* state, int n, int warp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (warp)
    chain_warp_kernel<<<1, 32, 0, s>>>(static_cast<uint32_t*>(state), n);
  else
    chain_thread_kernel<<<1, 1, 0, s>>>(static_cast<uint32_t*>(state), n);
  return static_cast<int>(cudaGetLastError());
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def words(rng, n: int) -> torch.Tensor:
    return bb.to_device(rng.integers(0, bb.P, size=n, dtype=np.uint64), "cuda")


def step_args(rng, n_in: int, n_pows: int) -> tuple:
    """(state, absorb or None, out, pows or None) for one step."""
    absorb = words(rng, n_in) if n_in else None
    pows = torch.zeros((4, n_pows), dtype=bb.DTYPE, device="cuda") if n_pows else None
    return words(rng, 16), absorb, torch.zeros(4, dtype=bb.DTYPE, device="cuda"), pows


def check(name: str, lib, rng) -> None:
    """The variant against duplex_plain from every state and at every step shape."""
    cases = cs.duplex_check_cases()
    for pos, sq_pos, absorbed, n_in, n_pows in cases:
        got = step_args(rng, n_in, n_pows)
        want = [None if t is None else t.clone() for t in got]
        fused.launch_duplex(lib, stream(), *got, pos, sq_pos, absorbed)
        fused.duplex_plain(*want, pos, sq_pos, absorbed)
        for g, w in zip(got, want):
            if g is not None and not torch.equal(g, w):
                cs.fail(f"{name} differs from duplex_plain from pos {pos}, sq_pos {sq_pos}, "
                        f"absorbed {absorbed}, {n_in} words, {n_pows} powers")
    log(f"[{name}] equals duplex_plain in {len(cases)} steps")


def trace_us(fn, part: str) -> float:
    """Mean duration, in the profiler's trace, of the kernels named with
    ``part`` that TRACE_LAUNCHES calls of ``fn`` launch."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LAUNCHES):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and part in e.name]
    if len(spans) != TRACE_LAUNCHES:
        cs.fail(f"the trace shows {len(spans)} kernels named {part}, not {TRACE_LAUNCHES}")
    return sum(spans) / len(spans)


def floors(lib, graph_n: int) -> dict:
    """The empty kernel (CUDA graph and trace) and the chains' ms per
    permutation, on one warp and on one thread, with the chains checked equal."""
    out = {}
    out["empty_graph_ms"] = cs.graph_ms(lambda: lib.floor_empty(stream()), graph_n)
    out["empty_trace_us"] = trace_us(lambda: lib.floor_empty(stream()), "empty_kernel")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    seed = words(np.random.default_rng(SEED), 16)
    results = {}
    for warp, key in ((1, "permute_warp"), (0, "permute (one thread)")):
        st = seed.clone()
        cuda_build.raise_on(lib.floor_chain(st.data_ptr(), CHAIN, warp, stream()), key)
        torch.cuda.synchronize()
        results[key] = st
        t = seed.clone()
        start.record()
        cuda_build.raise_on(lib.floor_chain(t.data_ptr(), CHAIN, warp, stream()), key)
        end.record()
        torch.cuda.synchronize()
        out[f"{key}: ms a permutation"] = start.elapsed_time(end) / CHAIN
    if not torch.equal(*results.values()):
        cs.fail(f"the chains of {CHAIN} permutations on a warp and on one thread differ")
    log(f"floors: {out}; the two chains of {CHAIN} permutations agree")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="+", help="NAME=SOURCE.cu")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--graph", type=int, default=200, help="launches per CUDA graph")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "duplex_cores"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_duplex_cores: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    os.makedirs(args.out, exist_ok=True)
    floors_src = os.path.join(args.out, "duplex_floors.cu")
    with open(floors_src, "w") as f:
        f.write(FLOORS_SRC)
    srcs = {"floors": (floors_src, [])}
    for v in args.variants:
        name, src = v.split("=", 1)
        srcs[name] = (src, [])
    built = build(srcs, args.out, show=("duplex", "chain", "empty"))
    if any(lib is None for lib, _ in built.values()):
        cs.fail("a build failed")
    result = {"card": card, "ptxas": {n: p for n, (_, p) in built.items()}, "steps": []}
    floor_lib = ctypes.CDLL(built.pop("floors")[0])
    floor_lib.floor_empty.argtypes = [ctypes.c_void_p]
    floor_lib.floor_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    floor_lib.floor_empty.restype = floor_lib.floor_chain.restype = ctypes.c_int
    variants = {name: T.declare(ctypes.CDLL(lib)) for name, (lib, _) in built.items()}
    cs.DEVICE = "cuda"
    rng = np.random.default_rng(SEED)
    for name, lib in variants.items():
        check(name, lib, rng)
    if args.check_only:
        print(card, flush=True)
        return 0
    result["floors"] = floors(floor_lib, args.graph)
    pos, sq_pos, absorbed = cs.DUPLEX_FROM
    for what, n_in, n_pows in cs.DUPLEX_STEPS:
        perms = cs.duplex_perms(n_in, pos, sq_pos, absorbed)
        b_ms, b_by = cs.bound(perms, 4 * (2 * 16 + n_in + 4 + 4 * n_pows))
        row = {"step": f"{what}: {n_in} words from pos {pos}, {n_pows} powers, {perms} "
                       f"permutations", "bound_ms": b_ms, "bound_by": b_by, "graph_ms": {},
               "trace_us": {}}
        args_ = step_args(rng, n_in, n_pows)
        calls = {name: (lambda lib=lib: fused.launch_duplex(lib, stream(), *args_, pos, sq_pos,
                                                             absorbed))
                 for name, lib in variants.items()}
        names = list(calls)
        for _ in range(ROUNDS):
            for name in names + names[::-1]:
                row["graph_ms"].setdefault(name, []).append(cs.graph_ms(calls[name], args.graph))
        for name in names:
            row["trace_us"][name] = trace_us(calls[name], "duplex_kernel")
        for name in names:
            ts = row["graph_ms"][name]
            log(f"{row['step']}: {name} {min(ts) * 1e3:.2f} us a launch in a CUDA graph "
                f"(turns {[round(t * 1e3, 2) for t in ts]}), {row['trace_us'][name]:.2f} us in "
                f"the trace; operations bound {b_ms * 1e3:.5f} us")
        result["steps"].append(row)
    with open(os.path.join(args.out, "result.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(card, flush=True)
    print(json.dumps({"duplex_cores": {
        "floors": result["floors"],
        "steps": [{"step": r["step"], "bound_ms": r["bound_ms"],
                   "graph_us": {k: min(v) * 1e3 for k, v in r["graph_ms"].items()},
                   "trace_us": r["trace_us"]} for r in result["steps"]]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
