#!/usr/bin/env python3
"""chip_smoke's Goldilocks checks alone on one CUDA card: phase 2's K14
checks, phase 11 and the GL golden gate.

    python3 tools/torch_gl_phase11.py [--check-only] [--out DIR]

Builds ``csrc/gl_commit.cu`` and prints ptxas's registers and spills for each
kernel, then runs ``chip_smoke.gl_kernels_vs_plain`` (K14a, K14b and K14c
against their plain versions, bitwise and timed, with their bounds), then
phase 11 (``chip_smoke.run_gl``: the add chip of ``fibonacci_vm(174760)``
proved with ``prove_chip_gl`` at ``GlParams()`` on the card, verified on
the host, three tampered proofs rejected) and ``chip_smoke.gl_golden_check``,
and prints their lines, with the card's name and power limit first. It is
the short way to check the Goldilocks path after a change there;
``--check-only`` stops after the kernel checks (a first call after a kernel
change). ``--out DIR`` also writes the SASS of ``gl_commit.cu`` there.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.emulator import native, programs  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402
from ceno_tpu_torch.zkvm import e2e  # noqa: E402
from ceno_tpu_torch.zkvm.tables import ZKVMConfig  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gl_phase11: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    print(cs.card_line(), flush=True)
    t = time.time()
    cuda_build.build_all(("gl_commit",))
    cs.log(f"gl_commit built in {time.time() - t:.2f}s")
    ptxas = cs.ptxas_by_kernel(cuda_build.build_logs.get("gl_commit", ""))
    for kernel, info in ptxas.items():
        cs.log(f"  gl_commit: {kernel}: {info}")
    if "--out" in args:
        out = args[args.index("--out") + 1]
        os.makedirs(out, exist_ok=True)
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               cuda_build._target("gl_commit")[1]],
                              capture_output=True, text=True, timeout=120)
        with open(os.path.join(out, "gl_commit.sass"), "w") as f:
            f.write(sass.stdout)
    kernels, rows = cs.gl_kernels_vs_plain(np.random.default_rng(cs.SEED + 3), ptxas)
    print(json.dumps({"gl_kernel_shapes": rows}), flush=True)
    if "--check-only" in args:
        return 0
    torch.cuda.empty_cache()
    t = time.time()
    vm = programs.fibonacci_vm(cs.E2E_ITERS)
    trace = native.run_trace_native(vm)
    cs.log(f"fibonacci_vm({cs.E2E_ITERS}): {trace.n} steps in {time.time() - t:.2f}s")
    t = time.time()
    pv = e2e.public_values_from_vm(vm, ZKVMConfig(**cs.E2E_CFG))
    line, report, counted = cs.run_gl(trace, pv)
    cs.log(f"phase 11 in {time.time() - t:.2f}s")
    for k in kernels:
        k["launches"] = counted[k["name"]]
        if k["launches"] <= 0:
            cs.fail(f"GL: kernel {k['name']} was not launched in prove_chip_gl")
    print(report, flush=True)
    t = time.time()
    line["golden"] = cs.gl_golden_check()
    line["seconds"]["golden_check"] = time.time() - t
    print(json.dumps({"gl": line}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
