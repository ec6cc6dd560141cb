"""Port parity: the fused tower levels (``gkr/tower.py``, the default).

Two product specs and one LogUp spec (5 terms a level, padded to 8, so the
padding terms take the zero slot of the alpha-power table) at N = 2^9, and
at N = 2 (one variable: no level) and N = 4, go through the port's
``prove_towers`` three ways on the CPU:

- fused levels (the default);
- per level (``CENO_TPU_TORCH_FUSED_TOWER=0``), its sumchecks fused;
- per level with per-round sumchecks (``CENO_TPU_TORCH_FUSED=0`` too);

and through the reference's ``prove_towers`` (its host path, as the Tier-1
``CENO_TPU_HOST_N`` pins it). The TowerProof, the final point, the record
claims and the transcript's end state must be equal, and each package's
``verify_towers`` must accept the fused proof. A device sponge that ends
elsewhere than the host's replay raises.
"""

import numpy as np
import pytest
import torch

from ceno_tpu.fields import babybear as rbb
from ceno_tpu.gkr import tower as rtower
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import tower
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.sumcheck import fused
from ceno_tpu_torch.sumcheck import prover as sc_prover

torch.set_num_threads(1)
P = rbb.P
LABEL = b"fused-tower"
MODES = {"fused": ("1", "1"), "per-level": ("0", "1"), "per-round": ("0", "0")}


def _records(log_n: int):
    rng = np.random.default_rng([7, log_n])
    rand = lambda: rng.integers(1, P, size=(1 << log_n, 4), dtype=np.uint64)  # noqa: E731
    return [rand(), rand()], [(rand(), rand())]


def _port(prods, lps, monkeypatch, mode: str):
    tower_sw, sc_sw = MODES[mode]
    monkeypatch.setenv("CENO_TPU_TORCH_FUSED_TOWER", tower_sw)
    monkeypatch.setenv("CENO_TPU_TORCH_FUSED", sc_sw)
    dev = lambda x: bb.to_device(x.T, "cpu")  # noqa: E731
    t = Transcript(LABEL)
    out = tower.prove_towers([dev(v) for v in prods], [(dev(p), dev(q)) for p, q in lps], t)
    return out, t


@pytest.mark.parametrize("log_n", [1, 2, 9])
def test_fused_levels_equal_per_level_and_reference(log_n, monkeypatch):
    prods, lps = _records(log_n)
    t_ref = RTranscript(LABEL)
    rproof, rrt, (rprod, rlogup) = rtower.prove_towers(prods, lps, t_ref)
    for mode in MODES:
        (proof, rt, (prod, logup)), t = _port(prods, lps, monkeypatch, mode)
        np.testing.assert_array_equal(proof.prod_out, rproof.prod_out)
        np.testing.assert_array_equal(proof.logup_out, rproof.logup_out)
        assert len(proof.round_msgs) == len(rproof.round_msgs) == log_n - 1
        for x, y in zip(proof.round_msgs + proof.level_evals,
                        rproof.round_msgs + rproof.level_evals):
            assert x.dtype == np.uint64
            np.testing.assert_array_equal(x, np.asarray(y, np.uint64))
        np.testing.assert_array_equal(rt, rrt)
        np.testing.assert_array_equal(prod, rprod)
        np.testing.assert_array_equal(logup, rlogup)
        np.testing.assert_array_equal(t.state, t_ref.state)
        assert t.export_state()[1:] == t_ref.export_state()[1:], mode
    (proof, rt, claims), _ = _port(prods, lps, monkeypatch, "fused")
    got = tower.verify_towers(proof, log_n, Transcript(LABEL))
    np.testing.assert_array_equal(got[0], rt)
    want = rtower.verify_towers(proof, log_n, RTranscript(LABEL))
    np.testing.assert_array_equal(want[0], rt)


def test_level_tables_pad_into_the_zero_slot():
    """compile_terms pads the 5 terms to 8, with 3 terms of the sentinel
    column (9) only; the level tables drop them, as they weigh zero, and
    every term's alpha_idx names one of the n_claims = 4 powers."""
    padded = sc_prover.compile_terms(
        [sc_prover.TermSpec(np.array([1, 0, 0, 0], np.uint64), eidx=e)
         for e in tower._level_terms(2, 1)[1]], 0, 9)[1]
    assert padded.shape == (8, 3) and padded[5:].tolist() == [[9, 9, 9]] * 3
    bidx, eidx, midx, alpha_idx, deg = tower._level_static(2, 1)
    assert bidx.shape == (5, 0) and eidx.shape == (5, 3) and deg == 3
    assert alpha_idx.tolist() == [0, 1, 2, 2, 3]
    np.testing.assert_array_equal(midx, eidx)  # no base columns: ext k -> k
    np.testing.assert_array_equal(eidx, padded[:5])


def test_diverged_device_sponge_raises(monkeypatch):
    prods, lps = _records(3)
    plain = fused.duplex_plain

    def off_by_one(state, *args):
        plain(state, *args)
        state[9] = bb.add(state[9], torch.tensor(bb.MONTY_ONE, dtype=bb.DTYPE))
    monkeypatch.setattr(fused, "duplex_plain", off_by_one)
    with pytest.raises(RuntimeError, match="prove_towers"):
        _port(prods, lps, monkeypatch, "fused")
