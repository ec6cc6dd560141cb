"""Port parity: the command line, ``python -m ceno_tpu_torch``, against the
reference's ``python -m ceno_tpu``.

Both ``main`` functions run in this process (the port's with
``device="cpu"``) on ``examples/fibonacci.s`` under ``--profile test``:

- ``prove`` writes the reference's bytes;
- each package's ``verify`` accepts the other's file and prints the same
  exit code and cycles; a proof made under the other profile is refused
  (exit 1) with the same line, as is a public-io digest the guest did not
  commit;
- ``run`` prints the reference's line and exit code, halted or cut by
  ``--max-steps``, with hints given inline or as a file;
- ``stats`` and ``stats <guest> --active`` print the reference's tables;
- ``aggregate`` refuses a proof of the other profile (exit 1). The
  aggregation prove itself is held on the card (``chip_smoke.py`` phase 10)
  against ``ceno_tpu_torch/golden/cli_fibonacci.json``: on CPU tensors it
  takes minutes;
- importing ``ceno_tpu_torch.__main__`` runs nothing, and the golden file
  names the setup of ``tools/torch_cli_golden.py``.
"""

import contextlib
import importlib
import io
import json
import os
import re

import pytest
import torch

from ceno_tpu.__main__ import main as rmain
from ceno_tpu_torch.__main__ import main as pmain

import chip_smoke

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUEST = os.path.join(ROOT, "examples", "fibonacci.s")
HINTS = "10"


def run(main, argv, **kw) -> tuple:
    """(exit code, printed text) of one command."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue()


def port(argv) -> tuple:
    return run(pmain, argv, device="cpu")


def untimed(text: str) -> str:
    """A printed line with its seconds left out."""
    return re.sub(r"\d+\.\ds", "<s>", text)


@pytest.fixture(scope="module")
def proofs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {}
    for name, main in (("ref", rmain), ("port", pmain)):
        path = str(d / f"{name}.bin")
        argv = ["prove", GUEST, "--hints", HINTS, "--profile", "test", "-o", path]
        rc, text = port(argv) if name == "port" else run(main, argv)
        assert rc == 0, text
        with open(path, "rb") as f:
            out[name] = (path, f.read(), untimed(text))
    return out


def test_prove_writes_the_reference_bytes(proofs):
    (_, rbytes, rtext), (_, pbytes, ptext) = proofs["ref"], proofs["port"]
    assert pbytes == rbytes
    assert ptext.replace(proofs["port"][0], "") == rtext.replace(proofs["ref"][0], "")


@pytest.mark.parametrize("verifier", ["port", "ref"])
def test_verify_accepts_the_other_packages_file(proofs, verifier):
    other = proofs["ref" if verifier == "port" else "port"][0]
    argv = ["verify", GUEST, other, "--profile", "test"]
    rc, text = port(argv) if verifier == "port" else run(rmain, argv)
    assert rc == 0 and text.startswith("verify: OK"), text
    assert "exit_code=55 cycles=288" in text  # fib(10), as the reference prints it


@pytest.mark.parametrize("cmd", ["verify", "aggregate"])
def test_a_proof_of_the_other_profile_is_refused(proofs, cmd):
    path = proofs["port"][0]
    argv = [cmd, GUEST, path, "--profile", "prod"]
    prc, ptext = port(argv)
    rrc, rtext = run(rmain, argv)
    assert prc == rrc == 1
    assert ptext == rtext and "FAIL" in ptext


def test_verify_refuses_a_public_io_digest_not_committed(proofs):
    argv = ["verify", GUEST, proofs["ref"][0], "--profile", "test", "--public-io", "1,2"]
    prc, ptext = port(argv)
    rrc, rtext = run(rmain, argv)
    assert prc == rrc == 1
    assert ptext == rtext == "verify: FAIL — public-io digest mismatch\n"


@pytest.mark.parametrize("extra", [[], ["--max-steps", "20"]], ids=["halts", "cut"])
def test_run_prints_the_reference_line(extra):
    argv = ["run", GUEST, "--hints", HINTS, *extra]
    prc, ptext = port(argv)
    rrc, rtext = run(rmain, argv)
    assert (prc, ptext) == (rrc, rtext)
    assert prc == (1 if extra else 0)


def test_run_reads_a_hints_file(tmp_path):
    path = tmp_path / "hints.bin"
    path.write_bytes((12).to_bytes(4, "little"))
    argv = ["run", GUEST, "--hints-file", str(path)]
    assert port(argv) == run(rmain, argv) == (0, port(["run", GUEST, "--hints", "12"])[1])


@pytest.mark.parametrize("argv", [["stats"], ["stats", GUEST, "--hints", HINTS, "--active"]],
                         ids=["registry", "guest-active"])
def test_stats_prints_the_reference_table(argv):
    prc, ptext = port(argv)
    rrc, rtext = run(rmain, argv)
    assert prc == rrc == 0
    assert ptext == rtext and "TOTAL" in ptext


def test_importing_the_cli_runs_nothing(capsys):
    importlib.reload(importlib.import_module("ceno_tpu_torch.__main__"))
    assert capsys.readouterr().out == ""


def test_golden_file_names_the_tools_setup():
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        golden = importlib.import_module("torch_cli_golden")
    finally:
        sys.path.pop(0)
    with open(golden.OUT) as f:
        want = json.load(f)
    assert (want["guest"], want["hints"], want["profile"]) == (golden.GUEST, golden.HINTS,
                                                               golden.PROFILE)
    assert golden.OUT == chip_smoke.CLI_GOLDEN
    assert want["stats"].splitlines()[0].startswith("guest: ")
    assert len(want["prove"]["sha256"]) == len(want["aggregate"]["sha256"]) == 64
