#!/usr/bin/env python3
"""Reference outputs of the command line, for the port's check on the card.

    JAX_PLATFORMS=cpu python3 tools/torch_cli_golden.py [--check]

Runs the JAX reference's own command line (``python -m ceno_tpu``) on the
CPU, as a user would, on ``examples/fibonacci.s`` with ``--hints 100`` under
``--profile test``: ``prove``, ``verify`` of that file, ``aggregate`` of it
and ``stats --active`` of the same guest. It writes the SHA-256 and length of
the proof and aggregation files, the end of ``verify``'s line (exit code and
cycles; its time is left out) and the text ``stats`` printed to
``ceno_tpu_torch/golden/cli_fibonacci.json``; with ``--check`` it compares
instead of writing. The card has no JAX, so ``chip_smoke.py`` (phase 10)
holds ``python -m ceno_tpu_torch``'s outputs of the same commands against
this file there.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ceno_tpu_torch", "golden", "cli_fibonacci.json")
GUEST = "examples/fibonacci.s"
HINTS = "100"
PROFILE = "test"


def commands(pkg: str, proof: str, agg: str) -> dict:
    """The four commands of the golden setup, as argument lists for
    ``python -m <pkg>``, in the order they run."""
    return {
        "prove": [pkg, "prove", GUEST, "--hints", HINTS, "--profile", PROFILE, "-o", proof],
        "verify": [pkg, "verify", GUEST, proof, "--profile", PROFILE],
        "aggregate": [pkg, "aggregate", GUEST, proof, "--profile", PROFILE, "-o", agg],
        "stats": [pkg, "stats", GUEST, "--hints", HINTS, "--active"],
    }


def file_digest(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def verify_tail(stdout: str) -> str:
    """``exit_code=... cycles=...`` of verify's line (its seconds vary)."""
    line = stdout.strip().splitlines()[-1]
    return line[line.index("exit_code="):]


def reference_golden() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        proof, agg = os.path.join(tmp, "proof.bin"), os.path.join(tmp, "agg.bin")
        out = {}
        for name, argv in commands("ceno_tpu", proof, agg).items():
            r = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, env=env,
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise SystemExit(f"{' '.join(argv)}: exit {r.returncode}\n{r.stderr}")
            out[name] = r.stdout
        return {"guest": GUEST, "hints": HINTS, "profile": PROFILE,
                "prove": file_digest(proof), "verify": verify_tail(out["verify"]),
                "aggregate": file_digest(agg), "stats": out["stats"]}


def main() -> int:
    got = reference_golden()
    if "--check" in sys.argv[1:]:
        with open(OUT) as f:
            want = json.load(f)
        print("equal" if want == got else f"differ: {got} against {want}")
        return 0 if want == got else 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(got, f, indent=1)
        f.write("\n")
    print(f"wrote {os.path.relpath(OUT, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
