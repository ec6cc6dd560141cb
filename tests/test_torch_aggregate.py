"""Port parity: the aggregation witness builders and the key (``zkvm/aggregate.py``,
``zkvm/skeleton.py``, ``utils/replay.py``) against the reference, at
``tests/test_aggregate.py``'s setup.

``fibonacci_vm(8)``, ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)``,
``BasefoldParams(blowup_log=1, n_queries=4, stop_size=32)``: each package
proves it (their proofs are the same bytes), then

- ``build_aggregation_witness`` with ``fs=False`` and ``fs=True`` gives the
  reference's chip sets: names, compiled digests, witness and fixed arrays;
  the port's MockProver accepts them (and, with ``fs=True``, rejects a
  changed challenge wire);
- the verifier's capture records (keys, order, tuple layout) are the
  reference's;
- ``expected_agg_key`` over the skeleton equals the key of the real
  proof's chip set, and the reference's rebuilt key;
- the skeleton proof fails the port's verifier outside
  ``structure_replay()`` and passes inside it; the waiver is thread-local;
- more than ``MAX_CHAINS`` proofs are refused.

The PCS-query and claim-link stages are held in
``tests/test_torch_aggregate_stages.py``, the proof's bytes and the
cross-verification in ``tests/test_torch_aggregate_prove.py``.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.gkr.chip import chip_digest as rchip_digest
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import aggregate as ragg
from ceno_tpu.zkvm import e2e as re2e
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import programs
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr.chip import chip_digest
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.utils import replay
from ceno_tpu_torch.zkvm import aggregate as agg
from ceno_tpu_torch.zkvm import e2e, scheme, skeleton
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

torch.set_num_threads(1)
CFG = dict(shl_x_bits=6, mem_words_log=7)
PARAMS = dict(blowup_log=1, n_queries=4, stop_size=32)
ITERS = 8


@pytest.fixture(scope="module")
def runs():
    ref = re2e.run_e2e(rprograms.fibonacci_vm(ITERS), RConfig(**CFG), RParams(**PARAMS))
    port = e2e.run_e2e(programs.fibonacci_vm(ITERS), ZKVMConfig(**CFG), BasefoldParams(**PARAMS),
                       device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def fs_sets(runs):
    ref, port = runs
    return (ragg.build_aggregation_witness(ref.pk.vk, ref.proof, fs=True)[0],
            agg.build_aggregation_witness(port.pk.vk, port.proof, fs=True)[0])


def agg_pv(vk, proof) -> np.ndarray:
    return np.concatenate([vk.digest_elems() % np.uint64(bb.P),
                           np.asarray(proof.public_values, np.uint64) % np.uint64(bb.P)])


def mock_sets(sets, pv) -> list:
    """(compiled, cb, wit, fixed, pv, rows) for the MockProver, padded."""
    out = []
    for s in sets:
        name, compiled, cb, wit = s[:4]
        fixed = s[4] if len(s) > 4 else None
        k = wit.shape[1]
        if k == 0:
            continue
        n = max(2, 1 << max(0, (k - 1).bit_length()))
        w = np.pad(wit, ((0, 0), (0, n - k)))
        f = (np.zeros((0, n), np.uint64) if fixed is None
             else np.pad(np.asarray(fixed, np.uint64), ((0, 0), (0, n - fixed.shape[1]))))
        out.append((compiled, cb, w, f, pv, k))
    return out


def assert_same_sets(want, got):
    assert [s[0] for s in got] == [s[0] for s in want]
    for w, g in zip(want, got):
        name = g[0]
        assert chip_digest(g[1]) == rchip_digest(w[1]), name
        assert g[2].wit_names == w[2].wit_names, name
        assert g[3].dtype == np.uint64 and np.array_equal(g[3], w[3]), name
        if len(w) > 4:
            assert (g[4] is None) == (w[4] is None), name
            if w[4] is not None:
                assert np.array_equal(np.asarray(g[4], np.uint64), np.asarray(w[4], np.uint64))


def test_proofs_equal(runs):
    ref, port = runs
    assert interop.key_summary(port.pk.vk)["chips"] == [
        (m.name, rchip_digest(m.compiled)) for m in ref.pk.vk.metas]
    np.testing.assert_array_equal(port.pk.vk.digest_elems(), ref.pk.vk.digest_elems())
    np.testing.assert_array_equal(agg_pv(port.pk.vk, port.proof), agg_pv(ref.pk.vk, ref.proof))


def test_witness_equal_without_fs(runs):
    ref, port = runs
    want, rsummary = ragg.build_aggregation_witness(ref.pk.vk, ref.proof, fs=False)
    got, summary = agg.build_aggregation_witness(port.pk.vk, port.proof, fs=False)
    assert summary == rsummary and summary["tower_groups"] >= 1 and summary["rows"] > 100
    assert_same_sets(want, got)
    sets = mock_sets(got, np.zeros(0, np.uint64))
    assert MockProver.assert_satisfied(sets) == []
    big = max(range(len(sets)), key=lambda i: sets[i][2].shape[1])
    bad = sets[big][2].copy()
    bad[4, 1] = (int(bad[4, 1]) + 1) % bb.P
    sets[big] = sets[big][:2] + (bad,) + sets[big][3:]
    assert MockProver.assert_satisfied(sets, raise_on_error=False)


def test_witness_equal_with_fs(runs, fs_sets):
    ref, port = runs
    want, got = fs_sets
    assert_same_sets(want, got)
    names = [s[0] for s in got]
    for expect in ("fs_duplex", "fs_pv", "fs_chal", "sc_rounds_d3", "eq_rows", "cm_final"):
        assert expect in names, expect
    pv = agg_pv(port.pk.vk, port.proof)
    assert MockProver.assert_satisfied(mock_sets(got, pv)) == []
    # a challenge wire of the merged degree-3 rounds chip breaks FS binding
    i = names.index("sc_rounds_d3")
    name, compiled, cb, wit, fixed = got[i]
    bad = wit.copy()
    j = cb.wit_names.index("alpha_0")
    bad[j, 0] = (int(bad[j, 0]) + 1) % bb.P
    tampered = list(got)
    tampered[i] = (name, compiled, cb, bad, fixed)
    assert MockProver.assert_satisfied(mock_sets(tampered, pv), raise_on_error=False)


def _plain(x):
    """A capture record as plain data: tuples and lists by position, arrays
    as uint64 lists, a transcript by its state, a compiled chip by its
    digest, other dataclasses field by field."""
    if isinstance(x, (tuple, list)):
        return [type(x).__name__] + [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, np.ndarray):
        return np.asarray(x, np.uint64).tolist()
    if isinstance(x, (int, np.integer, str, bytes, bool)) or x is None:
        return int(x) if isinstance(x, np.integer) else x
    if hasattr(x, "export_state"):
        return ["transcript", _plain(x.export_state())]
    if type(x).__name__ == "CompiledChip":
        digest = chip_digest if type(x).__module__.startswith("ceno_tpu_torch") else rchip_digest
        return ["chip", digest(x)]
    assert dataclasses.is_dataclass(x), type(x)
    return [type(x).__name__, {f.name: _plain(getattr(x, f.name))
                               for f in dataclasses.fields(x)}]


def test_capture_records_equal(runs):
    ref, port = runs
    rcap, cap = {}, {}
    assert rscheme.verify(ref.pk.vk, ref.proof, capture=rcap)
    assert scheme.verify(port.pk.vk, port.proof, capture=cap)
    assert list(cap) == list(rcap)
    for key in cap:
        assert _plain(cap[key]) == _plain(rcap[key]), key


def test_expected_agg_key_equals_real_key(runs, fs_sets):
    ref, port = runs
    _, got = fs_sets
    chips = agg._agg_chips_from_sets(got, fs=True)
    real = agg.AggKey([(c.name, c.compiled, c.cb, c.fixed) for c in chips],
                      BasefoldParams(**PARAMS))
    geo = [agg.ShardGeometry(list(port.proof.num_instances))]
    pvs = [np.asarray(port.proof.public_values, np.uint64)]
    rebuilt = agg.expected_agg_key(port.pk.vk, geo, pvs, BasefoldParams(**PARAMS))
    summary = interop.agg_key_summary(real)
    interop.agg_key_check(rebuilt, summary)
    rkey = ragg.expected_agg_key(ref.pk.vk, [ragg.ShardGeometry(list(ref.proof.num_instances))],
                                 [np.asarray(ref.proof.public_values, np.uint64)],
                                 RParams(**PARAMS))
    interop.agg_key_check(rebuilt, interop.agg_key_summary(rkey))
    # the digest commits the params and the fixed schedules
    weak = agg.AggKey(real.chips, BasefoldParams(**{**PARAMS, "n_queries": 1}))
    assert not np.array_equal(weak.digest_elems(), real.digest_elems())
    chips2 = list(real.chips)
    i = next(i for i, c in enumerate(chips2) if c[3] is not None)
    fx = np.asarray(chips2[i][3], np.uint64).copy()
    fx[0, 0] = (int(fx[0, 0]) + 1) % bb.P
    chips2[i] = chips2[i][:3] + (fx,)
    with pytest.raises(ValueError, match="fixed"):
        interop.agg_key_check(agg.AggKey(chips2, real.params), summary)


def test_replay_waives_value_checks(runs):
    _, port = runs
    vk, proof = port.pk.vk, port.proof
    sk = skeleton.skeleton_zkvm_proof(vk, list(proof.num_instances),
                                      np.asarray(proof.public_values, np.uint64))
    with pytest.raises(Exception):
        scheme.verify(vk, sk)
    assert not replay.structure_only()
    with replay.structure_replay():
        assert replay.structure_only()
        assert scheme.verify(vk, sk) is True
        # the waiver is this thread's alone
        seen = []
        th = threading.Thread(target=lambda: seen.append(replay.structure_only()))
        th.start()
        th.join()
        assert seen == [False]
    assert not replay.structure_only()
    replay.check(True)
    with pytest.raises(AssertionError):
        replay.check(False, "outside")
    with replay.structure_replay():
        replay.check(False, "inside")


def test_chain_cap_enforced():
    assert agg.MAX_CHAINS == ragg.MAX_CHAINS == 59 == (bb.P - 16) // (8 * agg.STEP_STRIDE)
    assert (agg.SC_STRIDE, agg.CLASS_SC_BASE, agg.STEP_STRIDE, agg.JAG_SC_BASE, agg.JAG_EQ_BASE,
            agg.JAG_EQ_STRIDE, agg.LABEL_AGG) == (
        ragg.SC_STRIDE, ragg.CLASS_SC_BASE, ragg.STEP_STRIDE, ragg.JAG_SC_BASE,
        ragg.JAG_EQ_BASE, ragg.JAG_EQ_STRIDE, ragg.LABEL_AGG)
    with pytest.raises(agg.AggError, match="tree"):
        agg.build_aggregation_witness_multi(None, [(None, {})] * (agg.MAX_CHAINS + 1), fs=True)
