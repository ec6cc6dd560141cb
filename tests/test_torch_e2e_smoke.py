"""A CPU rehearsal of ``chip_smoke.py``'s end-to-end phase (phase 5).

- ``run_e2e`` at ``fibonacci_vm(8)`` with the fast test config and params on
  CPU tensors: emulate (native core), keygen, two proves that must give the
  same bytes, the device audit of the whole prove (witness commit, records,
  tower layers, sumcheck banks), verify, three tampered proofs rejected, and
  the ``e2e`` line it reports;
- ``fixed_commit_check`` accepts the committed golden commitment over the
  port's own fixed matrix at bench.py's setup, and fails on a changed level.
"""

import types

import numpy as np
import pytest
import torch

from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import programs
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import scheme
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)


def test_e2e_phase_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    line, report, counted, _ = chip_smoke.run_e2e(
        8, ZKVMConfig(shl_x_bits=6, mem_words_log=7),
        BasefoldParams(blowup_log=1, n_queries=4, stop_size=32))
    assert line["steps"] == 59 and line["chips"] == 93 and line["device"] == "cpu"
    assert line["proof_bytes"] == 127393
    assert len(line["active_chips"]) == 23
    assert line["active_chips"]["addi"] == {"rows": 33, "height": 64}
    checked = line["checked_on_device"]
    assert set(checked) == {"layers", "banks", "commits", "records"}
    assert checked["commits"] == 2 and min(checked.values()) > 0
    assert set(line["seconds"]) == {"emulate", "keygen", "prove_first", "prove", "verify", "witgen"}
    assert set(line["stage_seconds"]) == {"witgen", "commit", "records", "towers", "class_main",
                                          "openings"}
    assert "towers/2^16" in report and "open/jagged-wit" in report
    for grouping in ("tower_groups", "classes"):
        names = [nm for members in line[grouping].values() for nm in members]
        assert sorted(names) == sorted(line["active_chips"])
    # CPU tensors take the kernels' plain versions: nothing is launched
    none = {"leaf_sponge": 0, "compress_level": 0, "round_evals": 0, "fold": 0, "duplex": 0}
    assert line["launches"] == {"keygen": none, "prove": none}
    assert counted["keygen"] == (none, [17])
    launches, trees = counted["prove"]
    assert trees[0] == 17 and len(trees) == 23


def _golden_pk(level_changed: bool = False):
    """A key-like object whose fixed commitment holds the committed golden
    codeword, leaves and levels over the port's own fixed matrix."""
    cfg, params = ZKVMConfig(**chip_smoke.E2E_CFG), BasefoldParams()
    opcode, shard, dyn, tables, _ = scheme.registry(
        programs.fibonacci_vm(chip_smoke.E2E_ITERS).program, cfg)
    (mat,) = scheme.fixed_matrices(tables, len(opcode) + len(shard) + len(dyn), params)[1].values()
    with np.load(chip_smoke.GOLDEN) as z:
        levels = [z[f"level{i}"].astype(np.uint64) for i in range(int(z["n_levels"]))]
        if level_changed:
            levels[3][0, 0] = (levels[3][0, 0] + 1) % np.uint64(2013265921)
        plain = {"cols": mat, "codeword": z["cw"].astype(np.uint64),
                 "leaves": z["leaves"].astype(np.uint64), "levels": levels, "n_vars": 16}
    committed = interop.committed_from_numpy(plain, device="cpu")
    return types.SimpleNamespace(fixed_committed={1 << 16: committed}, params=params)


def test_fixed_commit_check():
    chip_smoke.fixed_commit_check(_golden_pk())
    with pytest.raises(SystemExit, match="level 3"):
        chip_smoke.fixed_commit_check(_golden_pk(level_changed=True))
