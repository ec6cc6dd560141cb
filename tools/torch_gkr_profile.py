#!/usr/bin/env python3
"""Where the card's time goes in chip_smoke's GKR phase or in a whole
prove, by stage and by operation, from a torch.profiler trace.

    python3 tools/torch_gkr_profile.py [--iters N] [--e2e | --shards | --keccak [P] | --agg]

Runs ``fibonacci_vm(N)`` (default chip_smoke.GKR_ITERS, the full width) on
the native core. Without an option it assigns the opcode chips and proves
the GKR stages (chip_smoke phase 4); with ``--e2e`` it makes the key
(``ZKVMConfig(shl_x_bits=10)``, ``BasefoldParams()``, chip_smoke phase 5)
and runs the whole ``zkvm/scheme.prove``; with ``--shards`` it makes the
same key and runs ``zkvm/shard.prove_shards`` over two shards, pipelined
(chip_smoke phase 6); with ``--keccak`` it runs chip_smoke's keccak loop
of P permutations (default chip_smoke.KECCAK_PERMS, phase 7b) instead of
the fibonacci guest, as ``--e2e`` does; with ``--agg`` it makes the same
key, proves the fibonacci once and runs ``zkvm/aggregate.prove_aggregation``
of that proof (chip_smoke phase 9). Either way it proves once
unprofiled (warm-up), then
once more under ``torch.profiler`` with every stage and every operation
family wrapped in a ``record_function`` range:

  stages:     records (``build_tower_inputs``), towers (``prove_group_towers``),
              class_main (``prove_class_main``); with ``--e2e`` also witgen
              (``generate_witness``), commit (``basefold.commit``) and
              openings (``jagged.open_jagged``); with ``--shards`` these and
              plan (``plan_shards``) and ec_sum (``prove_ec_sum``), witgen
              then running on the pipeline's host thread; with ``--agg``
              witness (``build_aggregation_witness``) in witgen's place;
  operations: record_eval (the record builder, K9), tower_layers
              (``product_layers`` / ``logup_layers``, K8's trees),
              round_evals and folds (the sumcheck term kernels K6a and
              K6b), duplex (the on-device transcript, K5/K7), banks
              (``make_banks``), eq (``build_eq``), to_host (device -> host
              copies, where the per-round paths wait for the card and the
              fused ones fetch their results), encode (the NTT, K4), merkle
              (``hash_and_tree`` and ``fold_codewords_and_tree``: K1, K2 and
              the fold before them).

It prints one JSON line: the profiled prove's wall seconds, the device's
busy seconds (the union of its kernel and copy intervals) and idle share,
each range's host and device seconds, the hand-written kernels' (K1, K2,
K6a, K6b, K5/K7) calls and device seconds twice (from the trace by kernel
name, and from CUDA events around each call of their wrappers), and the
kernels with the most device time (the device events exclude the annotation
ranges the profiler mirrors on the device's timeline). The profiler gives a
range the device time of the kernels torch launches inside it, not of those
launched through ctypes: each operation range whose wrappers launch a
hand-written kernel also gets ``kernel_device_s``, that kernel's device
seconds read by name from the trace. The card's name and power limit come
first.
Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.fields import babybear as bb  # noqa: E402
from ceno_tpu_torch.gkr import chip as gkr_chip  # noqa: E402
from ceno_tpu_torch.gkr import eccquark  # noqa: E402
from ceno_tpu_torch.gkr import tower  # noqa: E402
from ceno_tpu_torch.hash import poseidon2_merkle as pm  # noqa: E402
from ceno_tpu_torch.mle import ops  # noqa: E402
from ceno_tpu_torch.pcs import basefold, jagged, ntt  # noqa: E402
from ceno_tpu_torch.sumcheck import fused, terms  # noqa: E402
from ceno_tpu_torch.zkvm import aggregate, e2e, scheme, shard, witgen  # noqa: E402
from ceno_tpu_torch.zkvm.tables import ZKVMConfig  # noqa: E402

STAGES = {"records": (gkr_chip, "build_tower_inputs"), "towers": (gkr_chip, "prove_group_towers"),
          "class_main": (gkr_chip, "prove_class_main")}
E2E_STAGES = {"witgen": (scheme, "generate_witness"), "commit": (basefold, "commit"),
              **STAGES, "openings": (jagged, "open_jagged")}
SHARD_STAGES = {**E2E_STAGES, "witgen": (witgen, "generate_witness"),
                "plan": (shard, "plan_shards"), "ec_sum": (eccquark, "prove_ec_sum")}
AGG_STAGES = {"witness": (aggregate, "build_aggregation_witness"),
              **{k: v for k, v in E2E_STAGES.items() if k != "witgen"}}
OPS = {"record_eval": [(gkr_chip, "build_records")],
       "tower_layers": [(tower, "product_layers"), (tower, "logup_layers")],
       "round_evals": [(terms, "round_evals")],
       "folds": [(terms, "fold_banks"), (terms, "fold_ext_bank")],
       "duplex": [(fused, "duplex")],
       "banks": [(terms, "make_banks")],
       "eq": [(ops, "build_eq")],
       "to_host": [(bb, "to_host")],
       "encode": [(ntt, "encode")],
       "merkle": [(basefold, "hash_and_tree"), (basefold, "fold_codewords_and_tree")]}

# the hand-written kernels: the part of their names in the trace, the
# wrapper (module attribute) that launches them, and the operation range
# that wraps it (K6b's wrappers fold_banks and fold_ext_bank both launch
# through terms._fold)
PORTED_KERNELS = {"K1": ("leaf_sponge_kernel", pm, "leaf_sponge", "op:merkle"),
                  "K2": ("merkle_levels", pm, "merkle_levels", "op:merkle"),
                  "K6a": ("round_evals", terms, "round_evals", "op:round_evals"),
                  "K6b": ("fold_kernel", terms, "_fold", "op:folds"),
                  "K5/K7": ("duplex_kernel", fused, "duplex", "op:duplex")}


@contextlib.contextmanager
def wrapper_events(times: dict):
    """Time each call of the hand-written kernels' wrappers with CUDA events
    on the current stream, for the block's length; ``times[label]`` collects
    the (start, end) pairs, read after the block's last synchronize."""
    saved = []
    for label, (_, mod, attr, _) in PORTED_KERNELS.items():
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        times[label] = []

        def inner(*args, _fn=fn, _label=label, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = _fn(*args, **kwargs)
            end.record()
            times[_label].append((start, end))
            return out
        setattr(mod, attr, inner)
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


@contextlib.contextmanager
def ranges(stages: dict):
    """Wrap each stage and operation function in a record_function range of
    its name for the block's length (module attributes, which their callers
    look up at each call)."""
    saved = []

    def wrap(mod, attr, label):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def inner(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        setattr(mod, attr, inner)

    for label, (mod, attr) in stages.items():
        wrap(mod, attr, f"stage:{label}")
    for label, targets in OPS.items():
        for mod, attr in targets:
            wrap(mod, attr, f"op:{label}")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _elapsed_s(evt) -> float:
    return evt.time_range.elapsed_us() / 1e6


def busy_seconds(events) -> float:
    """Union of the device events' intervals (kernels and copies), seconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("stage:", "op:")))
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def summarize(prof, wall_s: float, top: int = 12) -> dict:
    """The ranges' host seconds (their CPU intervals) and device seconds (the
    kernels launched inside them, nested ranges included: an operation's
    time also counts in its stage), the device's busy seconds and idle
    share over the profiled wall time, the kernels by device time, and the
    calls and device seconds that the trace shows for the hand-written
    kernels (PORTED_KERNELS, by a part of their names)."""
    events = prof.events()
    ranges_ = {}
    for e in events:
        if e.name.startswith(("stage:", "op:")) and e.device_type == torch.autograd.DeviceType.CPU:
            r = ranges_.setdefault(e.name, {"calls": 0, "host_s": 0.0, "device_s": 0.0})
            r["calls"] += 1
            r["host_s"] += _elapsed_s(e)
            r["device_s"] += e.device_time_total / 1e6
    kernels = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith(("stage:", "op:")):
            k = kernels.setdefault(e.name[:100], {"calls": 0, "device_s": 0.0})
            k["calls"] += 1
            k["device_s"] += _elapsed_s(e)
    busy = busy_seconds(events)
    ported = {label: {"trace_calls": sum(k["calls"] for n, k in kernels.items() if part in n),
                      "trace_device_s": sum(k["device_s"] for n, k in kernels.items() if part in n)}
              for label, (part, *_) in PORTED_KERNELS.items()}
    for label, (*_, op) in PORTED_KERNELS.items():
        if op in ranges_:
            r = ranges_[op]
            r["kernel_device_s"] = r.get("kernel_device_s", 0.0) + ported[label]["trace_device_s"]
    return {
        "wall_s": wall_s, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall_s if wall_s else None,
        "device_events": sum(k["calls"] for k in kernels.values()),
        "ranges": dict(sorted(ranges_.items())),
        "ported_kernels": ported,
        "top_device": [dict(name=n, **k) for n, k in sorted(
            kernels.items(), key=lambda kv: -kv[1]["device_s"])[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=cs.GKR_ITERS)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--e2e", action="store_true", help="profile the whole zkvm/scheme.prove")
    mode.add_argument("--shards", action="store_true",
                      help="profile zkvm/shard.prove_shards over two shards, pipelined")
    mode.add_argument("--keccak", type=int, nargs="?", const=cs.KECCAK_PERMS, metavar="P",
                      help="profile zkvm/scheme.prove of the keccak loop of P permutations")
    mode.add_argument("--agg", action="store_true",
                      help="profile zkvm/aggregate.prove_aggregation of the fibonacci proof")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gkr_profile: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    cs.DEVICE = "cuda"
    if args.e2e or args.shards or args.agg or args.keccak is not None:
        t0 = time.time()
        if args.keccak is None:
            vm, program = cs.programs.fibonacci_vm(args.iters), f"fibonacci_vm({args.iters})"
        else:
            vm, program = cs.keccak_loop_vm(args.keccak), f"keccak loop({args.keccak})"
        trace = cs.native.run_trace_native(vm)
        cfg = ZKVMConfig(**cs.E2E_CFG)
        pk = scheme.keygen(vm.program, cfg, basefold.BasefoldParams(), device="cuda")
        pv = e2e.public_values_from_vm(vm, cfg)
        seconds = {"emulate_and_keygen": time.time() - t0}
        steps = trace.n
        if args.shards:
            stages, key = SHARD_STAGES, "shards_profile"

            def prove():
                shard.prove_shards(pk, vm, trace, cs.max_steps_per_shard(trace.n), device="cuda")
        elif args.agg:
            stages, key = AGG_STAGES, "agg_profile"
            proof = scheme.prove(pk, vm, trace, pv, device="cuda")

            def prove():
                aggregate.prove_aggregation(pk.vk, proof, device="cuda")
        else:
            stages, key = E2E_STAGES, "e2e_profile" if args.keccak is None else "keccak_profile"

            def prove():
                scheme.prove(pk, vm, trace, pv, device="cuda")
    else:
        vm, assigned, seconds = cs.emulate_and_assign(args.iters)
        program = f"fibonacci_vm({args.iters})"
        pv = cs.public_values(vm)
        steps, stages, key = sum(a.num_instances for a in assigned), STAGES, "gkr_profile"

        def prove():
            cs.gkr_prove(assigned, pv)
    t0 = time.time()
    prove()
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    times: dict = {}
    with ranges(stages), wrapper_events(times), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        prove()
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    out = summarize(prof, wall_s)
    for label, pairs in times.items():
        out["ported_kernels"][label].update(
            wrapper_calls=len(pairs), event_device_s=sum(a.elapsed_time(b) for a, b in pairs) / 1e3)
    out.update(program=program, steps=steps,
               unprofiled_prove_s=warm_s, host_s=seconds)
    print(json.dumps({key: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
