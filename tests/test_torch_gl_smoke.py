"""chip_smoke.py's Goldilocks checks, rehearsed on CPU tensors at small
sizes: phase 11 (``run_gl``: the add chip proved with ``prove_chip_gl`` at
``GlParams()``, the device audit, the host verifier, three tampered proofs),
the golden gate (``gl_golden_check``: the port reproduces the reference's
digests committed in ceno_tpu_torch/golden/gl_pipeline.json) and phase 2's
K14 checks at small shapes (``gl_kernels_vs_plain``; on the CPU each wrapper
runs its plain version, so this checks the phase's plumbing, not the
kernels). The card runs the same functions at full size."""

import time

import numpy as np
import pytest
import torch

import chip_smoke
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.zkvm import e2e
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

torch.set_num_threads(1)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "sync", lambda: None)


def test_phase11_on_cpu(on_cpu):
    vm = programs.fibonacci_vm(60)
    trace = native.run_trace_native(vm)
    line, report, counted = chip_smoke.run_gl(
        trace, e2e.public_values_from_vm(vm, ZKVMConfig(**chip_smoke.E2E_CFG)))
    assert line["rows"] == 60 and line["witness"] == [26, 64]
    assert set(line["rejected"]) == {"witness evaluation", "opened row", "rd_iszero cell"}
    assert line["checked_on_device"]["commits"] == 2
    assert line["checked_on_device"]["banks"] == line["tower"]["levels"] + 2
    assert set(counted) == {"gl_encode", "gl_leaf_sponge", "gl_merkle_levels"}
    assert "gl/towers" in report


def test_golden_gate_on_cpu(on_cpu):
    got = chip_smoke.gl_golden_check()
    assert got["commit_roots"] == len(chip_smoke.GL_GOLDEN_COMMITS)


def test_phase2_gl_checks_on_cpu(on_cpu, monkeypatch):
    def host_ms(fn, reps):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps

    def host_wall(fn):
        t = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t) * 1e3

    monkeypatch.setattr(chip_smoke, "cuda_ms", host_ms)
    monkeypatch.setattr(chip_smoke, "wall_ms", host_wall)
    monkeypatch.setattr(chip_smoke, "gl_imads_per_product",
                        lambda: {"imad": 15, "imad_mov": 1, "kinds": ["IMAD"]})
    monkeypatch.setattr(chip_smoke, "GL_ENCODE_SHAPE", (26, 5, 3))
    monkeypatch.setattr(chip_smoke, "GL_LEAF_SHAPES", [(26, 8), (2, 6)])
    monkeypatch.setattr(chip_smoke, "GL_TREE_LOG", 8)
    monkeypatch.setattr(chip_smoke, "GL_EDGE_SHAPE", (26, 4))
    monkeypatch.setattr(chip_smoke, "SMALL_TREES", range(1, 5))
    kernels, rows = chip_smoke.gl_kernels_vs_plain(np.random.default_rng(1), {})
    assert [k["name"] for k in kernels] == ["gl_encode", "gl_leaf_sponge", "gl_merkle_levels"]
    for k in kernels:
        assert k["max_abs_err"] == 0 and k["library_ms"] is None and k["bound_ms"] > 0
        assert set(k) >= {"route", "source", "replaces", "ms", "plain_ms", "bound_by"}
    assert [r["shape"] for r in rows] == ["(26, 2^5) at blowup 2^3", "(26, 2^8)", "(2, 2^6)",
                                          "all 8 levels of (4, 2^8)"]
    # the bound: the products' IMADs over the multiply rate against the bytes
    enc = rows[0]
    assert enc["gl_products"] == 26 * 8 * (1 << 7)
    assert enc["bound_ms"] == max(enc["gl_products"] * 15 / chip_smoke.PEAK_MULS_PER_S,
                                  8 * 26 * (32 + 256) / chip_smoke.PEAK_BYTES_PER_S) * 1e3
