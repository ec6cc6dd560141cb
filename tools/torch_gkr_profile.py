#!/usr/bin/env python3
"""Where the card's time goes in chip_smoke's GKR phase, by stage and by
operation, from a torch.profiler trace.

    python3 tools/torch_gkr_profile.py [--iters N]

Runs ``fibonacci_vm(N)`` (default chip_smoke.GKR_ITERS, the full width) on
the native core, assigns the opcode chips, proves the GKR stages once
unprofiled (warm-up), then once more under ``torch.profiler`` with every
stage and every operation family wrapped in a ``record_function`` range:

  stages:     records (``build_tower_inputs``), towers (``prove_group_towers``),
              class_main (``prove_class_main``);
  operations: record_eval (the record builder, K9), tower_layers
              (``product_layers`` / ``logup_layers``, K8's trees),
              round_evals and folds (the sumcheck term kernels, K6), banks
              (``make_banks``), eq (``build_eq``), to_host (device -> host
              copies, where every sumcheck round waits for the card).

It prints one JSON line: the profiled prove's wall seconds, the device's
busy seconds (the union of its kernel and copy intervals) and idle share,
each range's host and device seconds, and the kernels with the most device
time (the device events exclude the annotation ranges the profiler mirrors
on the device's timeline). The card's name and power limit come first.
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
from ceno_tpu_torch.gkr import tower  # noqa: E402
from ceno_tpu_torch.mle import ops  # noqa: E402
from ceno_tpu_torch.sumcheck import terms  # noqa: E402

STAGES = {"records": (gkr_chip, "build_tower_inputs"), "towers": (gkr_chip, "prove_group_towers"),
          "class_main": (gkr_chip, "prove_class_main")}
OPS = {"record_eval": [(gkr_chip, "build_records")],
       "tower_layers": [(tower, "product_layers"), (tower, "logup_layers")],
       "round_evals": [(terms, "round_evals")],
       "folds": [(terms, "fold_banks"), (terms, "fold_ext_bank")],
       "banks": [(terms, "make_banks")],
       "eq": [(ops, "build_eq")],
       "to_host": [(bb, "to_host")]}


@contextlib.contextmanager
def ranges():
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

    for label, (mod, attr) in STAGES.items():
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
    share over the profiled wall time, and the kernels by device time."""
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
    return {
        "wall_s": wall_s, "device_busy_s": busy,
        "idle_share": 1.0 - busy / wall_s if wall_s else None,
        "device_events": sum(k["calls"] for k in kernels.values()),
        "ranges": dict(sorted(ranges_.items())),
        "top_device": [dict(name=n, **k) for n, k in sorted(
            kernels.items(), key=lambda kv: -kv[1]["device_s"])[:top]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=cs.GKR_ITERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_gkr_profile: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    cs.DEVICE = "cuda"
    vm, assigned, seconds = cs.emulate_and_assign(args.iters)
    pv = cs.public_values(vm)
    t0 = time.time()
    cs.gkr_prove(assigned, pv)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    with ranges(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        cs.gkr_prove(assigned, pv)
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    out = summarize(prof, wall_s)
    out.update(program=f"fibonacci_vm({args.iters})", steps=sum(a.num_instances for a in assigned),
               unprofiled_prove_s=warm_s, host_s=seconds)
    print(json.dumps({"gkr_profile": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
