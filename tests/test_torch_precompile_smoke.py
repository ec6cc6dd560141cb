"""A CPU rehearsal of ``chip_smoke.py``'s precompile phase (phase 7).

- ``run_keccak_loop`` at 4 permutations with the fast test config and params
  on CPU tensors: the native core, the committed words against keccak-f on
  the host, keygen, the prove under the device audit, verify, the two
  tampered proofs rejected, and the ``precompiles`` line it reports;
- the class mains phase 2 holds K6a and K6b at (``PRECOMPILE_CLASS_MAINS``)
  are those of the named chips in both packages, and at 1,024 permutations
  the keccak loop's 2^15 and 2^10 classes hold exactly those chips.
"""

import numpy as np
import torch

from ceno_tpu.zkvm.chips import build_all_chips as rbuild_all_chips
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig, build_tables as rbuild_tables
from ceno_tpu_torch.emulator import native
from ceno_tpu_torch.host import CenoStdin
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import scheme, witgen
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)
NONE = {"leaf_sponge": 0, "compress_level": 0, "round_evals": 0, "fold": 0, "duplex": 0}


def test_precompile_phase_on_cpu(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    line, report, counted, shapes = chip_smoke.run_keccak_loop(
        4, ZKVMConfig(**chip_smoke.PRECOMPILE_CFG), BasefoldParams(**chip_smoke.FAST_PARAMS))
    assert line["program"] == "keccak loop(4)" and line["steps"] == 237
    assert line["device"] == "cpu"
    assert line["rows"] == {"keccak_ecall": {"rows": 4, "height": 4},
                            "keccak_core": {"rows": 96, "height": 128},
                            "pubio_commit": {"rows": 1, "height": 2}}
    assert set(line["seconds"]) == {"emulate", "keygen", "prove", "verify"}
    assert set(line["stage_seconds"]) == {"witgen", "commit", "records", "towers", "class_main",
                                          "openings"}
    assert set(line["witgen_spans"]) == {"opcode-chips", "lookup-counts", "tables"}
    assert "records/keccak_core" in line["spans"] and "records/keccak_core" in report
    assert line["proof_bytes"] > 0 and line["max_memory_allocated"] is None
    assert set(line["rejected"]) == {"keccak_core class-main message",
                                     "public value (pubio digest)"}
    checked = line["checked_on_device"]
    assert set(checked) == {"layers", "banks", "commits", "records"} and min(checked.values()) > 0
    # CPU tensors take the kernels' plain versions: nothing is launched
    assert counted == NONE and line["launches"] == NONE
    core = [s for s in shapes if s["terms"] >= 5376]
    assert core and all(s["db"] == 2 and s["deg"] == 3 for s in core)


def test_keccak_loop_reads_n_from_its_hints():
    for n in (0, 1, 3):
        vm = chip_smoke.keccak_loop_vm(n)
        native.run_trace_native(vm)
        assert vm.halted and vm.exit_code == 0
        assert vm.pubio_digest == chip_smoke.keccak_digest([], n)
    hints = CenoStdin().write(5).to_words()
    assert chip_smoke.keccak_loop_vm(5).mem_init == {
        (chip_smoke.Platform.hints_start >> 2) + i: w for i, w in enumerate(hints)}


def _shape(compileds, log_n):
    terms = [tm for c in compileds for slot in c.slots for tm in slot.terms]
    db = max(len(tm.cols) for tm in terms)
    return {"log_n": log_n, "base": sum(c.n_cols for c in compileds), "ext": len(compileds),
            "terms": len(terms), "db": db, "de": 1, "deg": db + 1}


# terms with a zero scalar in the proves that run these classes (the card's
# phase 7 and tests/test_torch_curves_e2e.py check those proves' first rounds)
ZERO_SCALAR_TERMS = {"keccak core": 0, "keccak ecall": 2, "secp guest": 5}


def test_precompile_class_mains_are_the_chips():
    """Each shape of PRECOMPILE_CLASS_MAINS is its chips' class main, in both
    packages, less the terms whose scalar is zero in its prove."""
    cfg = ZKVMConfig(**chip_smoke.PRECOMPILE_CFG)
    metas = {m.name: m.compiled for m in scheme.registry({}, cfg)[4]}
    rchips = {c.name: c.compiled for c in rbuild_all_chips()}
    rtables = rbuild_tables({}, RConfig(**chip_smoke.PRECOMPILE_CFG))
    rchips.update({t.name: t.compiled for t in rtables})
    for cm in chip_smoke.PRECOMPILE_CLASS_MAINS:
        want = {k: v for k, v in cm.items() if k not in ("what", "chips")}
        got = _shape([metas[c] for c in cm["chips"]], cm["log_n"])
        assert got == _shape([rchips[c] for c in cm["chips"]], cm["log_n"])
        got["terms"] -= ZERO_SCALAR_TERMS[cm["what"]]
        assert got == want, cm["what"]


def test_full_size_keccak_loop_classes():
    """At 1,024 permutations (phase 7b) the keccak core fills the 2^15 class
    alone and the ecall chip shares the 2^10 class with bne only: no other
    chip or table of bench.py's config has those heights."""
    vm = chip_smoke.keccak_loop_vm(chip_smoke.KECCAK_PERMS)
    view = native.run_trace_native(vm)
    cfg = ZKVMConfig(**chip_smoke.E2E_CFG)
    oc, _, _, tables, _ = scheme.registry(vm.program, cfg)
    heights = {a.name: a.n_rows for a in witgen.assign_opcode_chips(view, oc) if a.num_instances}
    heights.update({t.name: scheme._pow2_height(t.n_rows) for t in tables})
    assert heights["keccak_core"] == 1 << 15  # 24 rows a permutation
    for cm in chip_smoke.KECCAK_CLASS_MAINS:
        members = sorted(name for name, h in heights.items() if h == 1 << cm["log_n"])
        assert members == sorted(cm["chips"]), cm["what"]
    assert np.all(np.asarray(view.kind) >= 0) and view.n == 3297
