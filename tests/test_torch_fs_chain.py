"""Port parity: the Fiat-Shamir chain in-circuit (``gkr/fs_chain.py``)
against the reference, as in ``tests/test_fs_chain.py``.

One schedule of absorbs and samples (odd-length absorbs, ext challenges on
the challenge table, a power chain, absorbed ext and base values bound to
their tables), its values from a numpy seed, drives the port's
``ChainTranscript``, a live port ``Transcript`` and the reference's
``ChainTranscript``:

- the recording chain ends in the live transcript's state with the same
  samples, and so does the reference's;
- its rows, absorbed slots and registry (challenge rows, absorbed-value
  rows, power chains, claimed slots) equal the reference's, and so do the
  chips of ``finalize`` (names, ``chip_digest``, witness and fixed arrays);
- a chip that looks the challenges up balances the bus: the port's
  MockProver accepts, and a changed absorb, challenge or power breaks it;
- a cursor and a clone replay without recording, as the verifier's stage
  captures use them.
"""

import numpy as np
import torch

from ceno_tpu.gkr import fs_chain as rFS
from ceno_tpu.gkr.chip import chip_digest as rchip_digest
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.gkr import fs_chain as FS
from ceno_tpu_torch.gkr import gadgets as G
from ceno_tpu_torch.gkr.chip import chip_digest, compile_chip
from ceno_tpu_torch.gkr.circuit_builder import CircuitBuilder
from ceno_tpu_torch.gkr.mock import MockProver
from ceno_tpu_torch.hash.transcript import Transcript

torch.set_num_threads(1)
LABEL = b"fs-chain-test"
SEED = 41


def _drive(t, chain_cls):
    """The schedule; ``t`` records iff it is a ``chain_cls``."""
    rng = np.random.default_rng(SEED)
    rec = isinstance(t, chain_cls)
    t.append(rng.integers(0, bb.P, size=13, dtype=np.uint64))
    c1 = t.sample_ext_chal()[1] if rec else np.array(t.sample_ext(), np.uint64)
    ax = rng.integers(0, bb.P, size=4, dtype=np.uint64)
    ab = int(rng.integers(0, bb.P))
    if rec:
        t.append_ext_chal(ax)
        t.append_base_chal(ab)
    else:
        t.append(ax)
        t.append([ab])
    t.append(rng.integers(0, bb.P, size=5, dtype=np.uint64))
    pows = t.sample_ext_pows_chal(3)[1] if rec else t.sample_ext_pows(3)
    t.append(rng.integers(0, bb.P, size=1, dtype=np.uint64))
    c2 = t.sample_ext_chal()[1] if rec else np.array(t.sample_ext(), np.uint64)
    return c1, pows, c2


def _registry_plain(reg) -> dict:
    def rows(rs):
        return [tuple(int(x) if np.ndim(x) == 0 else tuple(map(int, np.ravel(x))) for x in r)
                for r in rs]
    return {"chal": rows(reg.chal_rows), "absx": rows(reg.absx_rows),
            "absb": rows(reg.absb_rows),
            "pow": [(pid, bcid, cid0, tuple(map(int, a)), np.asarray(v, np.uint64).tolist())
                    for pid, bcid, cid0, a, v in reg.pow_chains],
            "claimed_abs": sorted(reg.claimed_abs), "claimed_samples": sorted(reg.claimed_samples),
            "uses": dict(reg.chal_mult), "next": (reg.next_cid, reg.next_pid)}


def _consumer(t, vals):
    """A chip that looks up c1 once, alpha^2 twice, c2 once and the two
    absorbed values (``vals``: c1, the powers, c2): its witness, counted on
    the registry."""
    cb = CircuitBuilder("chal_consumer")
    cid = cb.create_witin("cid")
    v = G.ext_witness(cb, "v")
    cb.lk_record(FS.LK_AGG_CHAL, [cid] + v.c)
    c1, pows, c2 = vals
    absx_cid, _, absx_v = t.registry.absx_rows[0]
    absb_cid, _, absb_v = t.registry.absb_rows[0]
    uses = [(0, c1), (6, pows[2]), (6, pows[2]), (7, c2), (absx_cid, absx_v),
            (absb_cid, np.array([absb_v, 0, 0, 0], np.uint64))]
    w = np.zeros((len(cb.wit_names), len(uses)), np.uint64)
    for r, (c, val) in enumerate(uses):
        t.use(c)
        w[cb.wit_names.index("cid"), r] = c
        for j in range(4):
            w[cb.wit_names.index(f"v_{j}"), r] = val[j]
    return compile_chip(cb), cb, w


def _mkset(compiled, cb, wit, fixed=None):
    k = wit.shape[1]
    n = max(2, 1 << max(0, (k - 1).bit_length()))
    w = np.pad(wit, ((0, 0), (0, n - k)))
    f = (np.zeros((0, n), np.uint64) if fixed is None
         else np.pad(np.asarray(fixed, np.uint64), ((0, 0), (0, n - fixed.shape[1]))))
    return (compiled, cb, w, f, np.zeros(0), k)


def _sets():
    t = FS.ChainTranscript(LABEL)
    vals = _drive(t, FS.ChainTranscript)
    compiled, cb, w = _consumer(t, vals)
    sets = [_mkset(c, b, wit, fx) for _, c, b, wit, fx in t.finalize(FS.build_fs_chain_chips())]
    return sets + [_mkset(compiled, cb, w)]


def test_chain_transcript_matches_live_and_reference():
    t, live, ref = FS.ChainTranscript(LABEL), Transcript(LABEL), rFS.ChainTranscript(LABEL)
    got = _drive(t, FS.ChainTranscript)
    want = _drive(live, FS.ChainTranscript)
    rgot = _drive(ref, rFS.ChainTranscript)
    for a, b, c in zip(got, want, rgot):
        assert np.array_equal(np.asarray(a, np.uint64), np.asarray(b, np.uint64))
        assert np.array_equal(np.asarray(a, np.uint64), np.asarray(c, np.uint64))
    assert np.array_equal(t.state, live.state) and np.array_equal(t.state, ref.state)
    assert (t._pos, t._sq_pos, t._absorbed, t._step) == \
        (ref._pos, ref._sq_pos, ref._absorbed, ref._step)
    # the recording: every permutation's input state and block, the slots
    assert len(t.rows) == len(ref.rows) > 0
    for (s1, b1), (s2, b2) in zip(t.rows, ref.rows):
        assert np.array_equal(s1, s2) and np.array_equal(b1, b2)
    assert t.abs_vals == ref.abs_vals and t.filled == ref.filled
    assert _registry_plain(t.registry) == _registry_plain(ref.registry)
    assert t.sample_ext() == live.sample_ext() == ref.sample_ext()


def test_cursor_and_clone_replay_without_recording():
    t = FS.ChainTranscript(LABEL)
    t.append(np.arange(11, dtype=np.uint64))
    n_rows = len(t.rows)
    for c in (t.cursor(), t.clone()):
        assert isinstance(c, FS.ChainTranscript) and c.registry is t.registry
        live = Transcript.from_state(t.export_state())
        c.append(np.arange(20, dtype=np.uint64))
        live.append(np.arange(20, dtype=np.uint64))
        assert c.sample_ext() == live.sample_ext()
        assert c.rows == [] and len(t.rows) == n_rows
    # the slots the next absorb takes, before taking them
    slots = t.absorb_slots_of_next(10)
    assert slots == [t._step * 8 + t._pos + i for i in range(8 - t._pos)] + \
        [(t._step + 1) * 8 + i for i in range(10 - (8 - t._pos))]


def test_fs_chain_chips_equal_reference():
    t, ref = FS.ChainTranscript(LABEL), rFS.ChainTranscript(LABEL)
    _drive(t, FS.ChainTranscript)
    _drive(ref, rFS.ChainTranscript)
    for c in (0, 6, 6, 7):
        t.use(c)
        ref.use(c)
    got = t.finalize(FS.build_fs_chain_chips())
    want = ref.finalize(rFS.build_fs_chain_chips())
    assert [s[0] for s in got] == [s[0] for s in want]
    for (name, c, cb, w, f), (_, rc, rcb, rw, rf) in zip(got, want):
        assert chip_digest(c) == rchip_digest(rc), name
        assert cb.wit_names == rcb.wit_names, name
        assert np.array_equal(w, rw), name
        assert (f is None) == (rf is None), name
        if f is not None:
            assert np.array_equal(f, rf), name
    # the pv-supply chip of an aggregation chain
    pcb, pc = FS.build_pv_supply_chip(LABEL, 5, inst_indices=list(range(5)))
    rpcb, rpc = rFS.build_pv_supply_chip(LABEL, 5, inst_indices=list(range(5)))
    assert chip_digest(pc) == rchip_digest(rpc)


def test_fs_chain_mock_satisfied():
    assert MockProver.assert_satisfied(_sets()) == []


def _tampered(chip: str, col: str, row: int) -> list:
    sets = _sets()
    i = [s[1].name for s in sets].index(chip)
    compiled, cb, wit, fx, inst, k = sets[i]
    bad = wit.copy()
    j = cb.wit_names.index(col)
    bad[j, row] = (int(bad[j, row]) + 1) % bb.P
    sets[i] = (compiled, cb, bad, fx, inst, k)
    return sets


def test_fs_chain_tamper_absorb_breaks():
    assert MockProver.assert_satisfied(_tampered("fs_abs_supply", "v", 0), raise_on_error=False)


def test_fs_chain_tamper_challenge_breaks():
    assert MockProver.assert_satisfied(_tampered("fs_chal_table", "v0", 0), raise_on_error=False)


def test_fs_chain_tamper_pow_breaks():
    assert MockProver.assert_satisfied(_tampered("fs_pow_rows", "v_0", 1), raise_on_error=False)
