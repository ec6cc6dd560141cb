#!/usr/bin/env python3
"""chip_smoke's phase 12 alone on one CUDA card: the Goldilocks zkVM scheme.

    python3 tools/torch_gl_phase12.py [--no-jobs]

Builds the kernels, emulates chip_smoke's 2^20-step ``fibonacci_vm``
(``chip_smoke.E2E_ITERS``), makes its BabyBear key at bench.py's
``ZKVMConfig(shl_x_bits=10)`` on the card, then runs phase 12's timed window
(``chip_smoke.run_gl_scheme``: ``keygen_gl`` and ``prove_gl`` of the trace as
one standalone shard at ``GlParams()``, spans, the device audit, K14's
launches) and prints its span report and ``{"gl_scheme": ...}`` line. Unless
``--no-jobs``, it then runs phase 12's untimed jobs (``chip_smoke.gl_scheme_jobs``:
the host ``verify_gl`` of that proof with its tampers, and the two golden
proofs against ``ceno_tpu_torch/golden/gl_scheme.json``) in a pool of three
spawned workers, one a job, and prints their results in the line.
It is the short way to check phase 12 after a change there.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.emulator import native, programs  # noqa: E402
from ceno_tpu_torch.pcs import basefold as bf  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402
from ceno_tpu_torch.zkvm import e2e, scheme  # noqa: E402
from ceno_tpu_torch.zkvm.tables import ZKVMConfig  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gl_phase12: no CUDA device", file=sys.stderr)
        return 2
    iters = cs.E2E_ITERS
    print(cs.card_line(), flush=True)
    t = time.time()
    cuda_build.build_all()
    cs.log(f"kernels built in {time.time() - t:.2f}s")
    t = time.time()
    vm = programs.fibonacci_vm(iters)
    trace = native.run_trace_native(vm)
    cfg = ZKVMConfig(**cs.E2E_CFG)
    pk = scheme.keygen(vm.program, cfg, bf.BasefoldParams(), device="cuda")
    torch.cuda.synchronize()
    cs.log(f"fibonacci_vm({iters}): {trace.n} steps; BabyBear key in {time.time() - t:.2f}s")
    t = time.time()
    line, report, counted, verify_args = cs.run_gl_scheme(
        pk, vm, trace, e2e.public_values_from_vm(vm, cfg))
    line["program"] = f"fibonacci_vm({iters})"
    cs.log(f"phase 12's timed window in {time.time() - t:.2f}s")
    for name, c in counted.items():
        if c <= 0:
            cs.fail(f"GL scheme: kernel {name} was not launched in prove_gl")
    print(report, flush=True)
    del pk, vm, trace
    torch.cuda.empty_cache()
    if "--no-jobs" not in sys.argv[1:]:
        pool = cs.agg_pool(3)
        try:
            t = time.time()
            checks = cs.agg_results(cs.gl_scheme_jobs(pool, *verify_args))
            cs.log(f"phase 12's untimed jobs in {time.time() - t:.2f}s")
        finally:
            pool.terminate()
            pool.join()
        cs.gl_scheme_collect(line, checks)
    print(json.dumps({"gl_scheme": line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
