#!/usr/bin/env python3
"""chip_smoke's phase 10 alone on one CUDA card, with nothing beside it.

    python3 tools/torch_phase10.py

Builds the kernels, makes phase 5's key (``fibonacci_vm(174760)``'s program,
``ZKVMConfig(shl_x_bits=10)``, ``BasefoldParams()``) twice (the first in the
process, then warm) and holds its fixed commitment against the golden file,
then runs ``chip_smoke.key_cache_check`` and ``chip_smoke.run_phase10_untimed``
(the CLI commands in subprocesses beside the 4-rank row-sharded addi prove)
and prints their ``key_cache``, ``cli`` and ``sharded_chip`` lines, with the
card's name and power limit first. It is the short way to check phase 10
after a change to the CLI, the key cache or row sharding (about 2 minutes on
an H100, against chip_smoke's 8); chip_smoke runs the same checks beside
phase 9's golden workers.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ceno_tpu_torch.emulator import programs  # noqa: E402
from ceno_tpu_torch.pcs import basefold as bf  # noqa: E402
from ceno_tpu_torch.utils import cuda_build  # noqa: E402
from ceno_tpu_torch.zkvm import scheme  # noqa: E402
from ceno_tpu_torch.zkvm.tables import ZKVMConfig  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_phase10: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t = time.time()
    cuda_build.build_all()
    cs.log(f"kernels built in {time.time() - t:.2f}s")
    program = programs.fibonacci_vm(cs.E2E_ITERS).program
    t = time.time()
    pk = scheme.keygen(program, ZKVMConfig(**cs.E2E_CFG), bf.BasefoldParams(), device=cs.DEVICE)
    cs.sync()
    first_s = time.time() - t
    cs.log(f"keygen, the first in the process: {first_s:.2f}s")
    cs.fixed_commit_check(pk)
    print(json.dumps({"key_cache": cs.key_cache_check(pk, first_s)}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cli_line, sharded_line = cs.run_phase10_untimed(tmp)
    print(json.dumps({"cli": cli_line}), flush=True)
    print(json.dumps({"sharded_chip": sharded_line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
