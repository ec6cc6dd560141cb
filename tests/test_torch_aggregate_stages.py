"""Port parity: the PCS query phase (``gkr/pcs_verify.py``) and the
record-claim link (``gkr/claim_link.py``) in the FS-bound aggregation
witness, against the reference, as ``tests/test_aggregate.py`` holds them.

At that file's setup (``fibonacci_vm(8)``, ``ZKVMConfig(shl_x_bits=6,
mem_words_log=7)``, ``BasefoldParams(blowup_log=1, n_queries=4,
stop_size=32)``) each package builds ``build_aggregation_witness(...,
fs=True)``; every chip set of the two stages (``pcs_*``, ``cl_*``) must
equal the reference's (names, compiled digests, witness and fixed arrays),
the port's MockProver must accept the whole witness, and a changed Merkle
sibling, opened value, query-index bit, tail fold, PoW sample, batched
claim, slot multiplier or scalar total must each break it.
"""

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import aggregate as ragg
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu_torch.emulator import programs
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import aggregate as agg
from ceno_tpu_torch.zkvm import e2e
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

from test_torch_aggregate import CFG, ITERS, PARAMS, agg_pv, assert_same_sets, mock_sets

torch.set_num_threads(1)
PCS_CHIPS = ("pcs_qidx", "pcs_fold", "pcs_merkle_rows", "pcs_qend", "pcs_tail_fold",
             "pcs_bsum_ends", "pcs_pow", "pcs_root_lk", "pcs_leaf", "pcs_comb")
CL_CHIPS = ("cl_bl_const", "cl_bl_ends", "cl_mult_rec", "cl_sx_sum", "cl_sx_prod", "cl_sx_pub",
            "cl_seqd_set", "cl_seqa_set", "cl_wchip", "cl_svw_partial")


@pytest.fixture(scope="module")
def witness():
    ref = re2e.run_e2e(rprograms.fibonacci_vm(ITERS), RConfig(**CFG), RParams(**PARAMS))
    port = e2e.run_e2e(programs.fibonacci_vm(ITERS), ZKVMConfig(**CFG), BasefoldParams(**PARAMS),
                       device="cpu")
    want, _ = ragg.build_aggregation_witness(ref.pk.vk, ref.proof, fs=True)
    got, _ = agg.build_aggregation_witness(port.pk.vk, port.proof, fs=True)
    return want, got, agg_pv(port.pk.vk, port.proof)


@pytest.mark.parametrize("prefix,expect", [("pcs_", PCS_CHIPS), ("cl_", CL_CHIPS)])
def test_stage_sets_equal_reference(witness, prefix, expect):
    want, got, pv = witness
    names = [s[0] for s in got]
    for name in expect:
        assert name in names, f"missing chip set {name}"
    assert_same_sets([s for s in want if s[0].startswith(prefix)],
                     [s for s in got if s[0].startswith(prefix)])


def test_mock_satisfied(witness):
    _, got, pv = witness
    assert MockProver.assert_satisfied(mock_sets(got, pv)) == []


def _tampered(sets, chip: str, col: str) -> list:
    out = []
    for name, compiled, cb, wit, fixed in sets:
        if name == chip:
            wit = wit.copy()
            j = cb.wit_names.index(col)
            wit[j, 0] = (int(wit[j, 0]) + 1) % bb.P
        out.append((name, compiled, cb, wit, fixed))
    return out


@pytest.mark.parametrize("chip,col", [
    ("pcs_merkle_rows", "sib0"),   # a Merkle sibling: the walk's compress chain
    ("pcs_comb", "v"),             # an opened base-row value: leaf preimage vs combination
    ("pcs_qidx", "b0"),            # a query index bit: decomposition / sample binding
    ("pcs_tail_fold", "out_0"),    # a tail fold output: fold equation or tail chain
    ("pcs_pow", "v"),              # the PoW sample: range check / slot binding
    ("cl_bl_ends", "bc_0"),        # a batched claim
    ("cl_mult_rec", "m_0"),        # a slot multiplier
    ("cl_sx_pub", "tot_0"),        # a scalar total over public values
    ("cm_chip", "bc_0"),
    ("cm_slot", "mult_0"),
])
def test_tampered_cell_breaks(witness, chip, col):
    _, got, pv = witness
    assert chip in [s[0] for s in got]
    errs = MockProver.assert_satisfied(mock_sets(_tampered(got, chip, col), pv),
                                       raise_on_error=False)
    assert errs, f"tampering {chip}.{col} went undetected"
