#!/usr/bin/env python3
"""Reference digests of aggregation proofs, for the port's checks on the CPU and the card.

    JAX_PLATFORMS=cpu python3 tools/torch_agg_golden.py [--check] [NAME ...]

Runs the JAX reference (``ceno_tpu``) on the CPU and writes the SHA-256 and
length of each ``agg_proof_to_bytes`` to
``ceno_tpu_torch/golden/aggregation_fibonacci.json`` (``--check`` compares
instead of writing; named entries alone are recomputed, and the others
kept). The entries, each proved in a process of its own, all at once:

* ``single``: ``prove_aggregation`` of ``fibonacci_vm(8)`` at
  ``tests/test_aggregate.py``'s setup (``ZKVMConfig(shl_x_bits=6,
  mem_words_log=7)``, ``BasefoldParams(blowup_log=1, n_queries=4,
  stop_size=32)``), about 4 minutes;
* ``sharded``: ``prove_shard_aggregation`` of ``fibonacci_vm(12)`` proved
  as shards of at most 40 steps, at the same setup;
* ``level2``: ``prove_chipset_aggregation`` of the ``single`` aggregation
  proof under its own key;
* ``default``: ``prove_aggregation`` of ``fibonacci_vm(100)`` at the same
  config and ``BasefoldParams()`` (the card's golden setup of the e2e phase).

The card has no JAX, so ``chip_smoke.py`` holds the port's proofs of the same
setups against these bytes there; the CPU tests hold the ``single`` entry.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing as mp
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# the reference's host paths at these sizes, as tests/conftest.py pins them;
# its device paths give the same bytes
os.environ.setdefault("CENO_TPU_HOST_N", str(1 << 17))

OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "aggregation_fibonacci.json")
CFG = {"shl_x_bits": 6, "mem_words_log": 7}
FAST_PARAMS = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}
SETUPS = {
    "single": {"program": "fibonacci_vm(8)", "iters": 8, "cfg": CFG,
               "params": FAST_PARAMS, "entry": "prove_aggregation"},
    "sharded": {"program": "fibonacci_vm(12)", "iters": 12, "cfg": CFG,
                "params": FAST_PARAMS, "max_steps_per_shard": 40,
                "entry": "prove_shard_aggregation"},
    "level2": {"program": "fibonacci_vm(8)", "iters": 8, "cfg": CFG,
               "params": FAST_PARAMS, "entry": "prove_chipset_aggregation",
               "inner": "single"},
    "default": {"program": "fibonacci_vm(100)", "iters": 100, "cfg": CFG,
                "params": {}, "entry": "prove_aggregation"},
}


def blob_digest(blob: bytes) -> dict:
    return {"proof_sha256": hashlib.sha256(blob).hexdigest(), "proof_bytes": len(blob)}


def key_digest(key) -> str:
    """SHA-256 of an aggregation key's ``digest_elems`` as little-endian uint64."""
    import numpy as np

    return hashlib.sha256(np.asarray(key.digest_elems(), np.uint64).tobytes()).hexdigest()


def _reference_entry(name: str) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ceno_tpu.emulator import programs
    from ceno_tpu.pcs.basefold import BasefoldParams
    from ceno_tpu.zkvm import aggregate as agg
    from ceno_tpu.zkvm.e2e import run_e2e
    from ceno_tpu.zkvm.scheme import keygen
    from ceno_tpu.zkvm.serialize import agg_proof_to_bytes
    from ceno_tpu.zkvm.shard import prove_shards
    from ceno_tpu.zkvm.tables import ZKVMConfig

    s = SETUPS[name]
    cfg, params = ZKVMConfig(**s["cfg"]), BasefoldParams(**s["params"])
    vm = programs.fibonacci_vm(s["iters"])
    if name == "sharded":
        records = vm.run()
        pk = keygen(vm.program, cfg, params)
        sproof = prove_shards(pk, vm, records, s["max_steps_per_shard"])
        key, aproof, n = agg.prove_shard_aggregation(pk.vk, sproof, params=params)
        extra = {"n_shards": n}
    else:
        res = run_e2e(vm, cfg, params)
        key, aproof = agg.prove_aggregation(res.pk.vk, res.proof, params=params)
        extra = {}
        if name == "level2":
            key, aproof = agg.prove_chipset_aggregation(key, [aproof], params=params)
    out = {k: v for k, v in s.items() if k != "iters"}
    out.update(extra)
    out.update(blob_digest(agg_proof_to_bytes(aproof, params)))
    out["chips"] = len(key.chips)
    out["key_sha256"] = key_digest(key)
    return out


def main() -> int:
    args = sys.argv[1:]
    only = [a for a in args if a in SETUPS]
    names = only or list(SETUPS)
    with mp.get_context("spawn").Pool(len(names)) as pool:
        got = dict(zip(names, pool.map(_reference_entry, names)))
    if "--check" in args:
        with open(OUT) as f:
            want = json.load(f)
        bad = {n: (got[n], want.get(n)) for n in names if want.get(n) != got[n]}
        print("equal" if not bad else f"differ: {bad}")
        return 0 if not bad else 1
    have = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            have = json.load(f)
    have.update(got)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({n: have[n] for n in SETUPS if n in have}, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.relpath(OUT, ROOT)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
