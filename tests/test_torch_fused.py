"""Port parity: the fused device sumcheck (``sumcheck/fused.py``) and its duplex.

- The port's fused path (the default), its per-round path
  (``CENO_TPU_TORCH_FUSED=0``) and the reference's ``sumcheck.prove`` on the
  same numpy-seeded columns and terms: round messages, point, final evals
  and the transcript's end state must be equal, at n_vars 1, 2 and 9, over
  base-only, mixed and all-ext banks, each with a term count that pads to a
  power of two. The reference runs fused where it runs on the device: with
  ``CENO_TPU_FUSED=1`` and ``host_impl.HOST_N`` patched to 32, its jitted
  ``fused_rounds`` runs on the CPU at n_vars 9 (smaller inputs take its host
  path, which gives the same bytes).
- The plain duplex (``fused.duplex_plain``, what the CPU runs in place of
  K5/K7) against the host ``Transcript``: absorb-then-sample steps from every
  ``pos`` in 0..8, with ``absorbed`` true and false, absorbs that cross the
  rate, and the challenge's powers.
- A device sponge that ends elsewhere than the host's replay raises.

All comparisons are exact; the CPU runs each kernel's plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceno_tpu import sumcheck as rsumcheck
from ceno_tpu.fields import babybear as rbb
from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.sumcheck import host_impl as rhost
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.hash import poseidon2 as p2
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.sumcheck import fused, prover, terms as T

torch.set_num_threads(1)
P = rbb.P
LABEL = b"fused-parity"
# (base columns, ext columns, terms as (bidx, eidx)): 3, 5 and 6 terms pad to 4, 8, 8
BANKS = {
    "base": (3, 0, [((0, 1), ()), ((2,), ()), ((1, 2, 0), ())]),
    "mixed": (3, 2, [((0,), (0,)), ((1, 2), (1,)), ((2,), ()), ((), (0, 1)), ((0, 1, 2), (1,))]),
    "ext": (0, 3, [((), (0,)), ((), (1, 2)), ((), (2, 0, 1)), ((), (1,)), ((), (0, 2)),
                   ((), (2,))]),
}


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _inputs(n_vars, bank):
    n_base, n_ext, shapes = BANKS[bank]
    n = 1 << n_vars
    seed = 100 * n_vars + len(bank)
    base = [_rand(seed + i, n) for i in range(n_base)]
    ext = [_rand(seed + 50 + i, (4, n)) for i in range(n_ext)]
    terms = [prover.TermSpec(_rand(seed + 80 + i, 4), bidx=b, eidx=e)
             for i, (b, e) in enumerate(shapes)]
    return base, ext, terms


def _port(base, ext, terms, n_vars, monkeypatch, fused_on: bool):
    monkeypatch.setenv("CENO_TPU_TORCH_FUSED", "1" if fused_on else "0")
    t = Transcript(LABEL)
    out = prover.prove([bb.to_device(c, "cpu") for c in base],
                       [bb.to_device(c, "cpu") for c in ext], terms, n_vars, t)
    return out, t


@pytest.mark.parametrize("bank", sorted(BANKS))
@pytest.mark.parametrize("n_vars", [1, 2, 9])
def test_fused_equals_per_round_and_reference(n_vars, bank, monkeypatch):
    base, ext, terms = _inputs(n_vars, bank)
    fu, t_fu = _port(base, ext, terms, n_vars, monkeypatch, True)
    pr, t_pr = _port(base, ext, terms, n_vars, monkeypatch, False)
    monkeypatch.setattr(rhost, "HOST_N", 32)
    monkeypatch.setenv("CENO_TPU_FUSED", "1")
    t_ref = RTranscript(LABEL)
    ref = rsumcheck.prove(
        [jnp.asarray(rbb.np_to_monty(c)) for c in base],
        [jnp.asarray(rbb.np_to_monty(c)) for c in ext],
        [rsumcheck.TermSpec(t.scalar, t.bidx, t.eidx) for t in terms], n_vars, t_ref)
    for out, t in ((fu, t_fu), (pr, t_pr)):
        np.testing.assert_array_equal(out.proof.round_msgs, ref.proof.round_msgs)
        np.testing.assert_array_equal(out.point, ref.point)
        np.testing.assert_array_equal(out.final_base, ref.final_base)
        np.testing.assert_array_equal(out.final_ext, ref.final_ext)
        assert t.export_state()[1:] == t_ref.export_state()[1:]
        np.testing.assert_array_equal(t.state, t_ref.state)


@pytest.mark.parametrize("absorbed", [False, True])
@pytest.mark.parametrize("pos", range(p2.RATE + 1))
def test_plain_duplex_matches_host_transcript(pos, absorbed):
    """Steps of (absorb n, sample one ext with 5 powers) from ``pos``, with
    n from 0 to 17 (crossing the rate once or twice), against the host
    transcript, which also keeps the bookkeeping that ``fused.advance``
    computes; then a run of steps from the same start."""
    for sq_pos in (0, 4, p2.RATE):
        for n_in in (0, 1, 7, 8, 9, 16, 17):
            seed = [pos, int(absorbed), sq_pos, n_in]
            st, words = _rand(seed, 16), _rand(seed + [1], n_in)
            host = Transcript.from_state((st, pos, sq_pos, absorbed))
            host.append(words)
            want_pows = host.sample_ext_pows(5)
            state = bb.to_device(st, "cpu")
            out = torch.zeros(4, dtype=bb.DTYPE)
            pows = torch.zeros((4, 6), dtype=bb.DTYPE)  # the last column must stay 0
            got = fused.duplex(state, bb.to_device(words, "cpu") if n_in else None, out,
                               pows[:, :5], pos=pos, sq_pos=sq_pos, absorbed=absorbed)
            assert got == host.export_state()[1:]
            np.testing.assert_array_equal(bb.to_host(state), host.state)
            np.testing.assert_array_equal(bb.to_host(out), want_pows[1])
            np.testing.assert_array_equal(bb.to_host(pows[:, :5]).T, want_pows)
            assert not pows[:, 5].any()
    host = Transcript.from_state((_rand([pos, 9], 16), pos, 3, absorbed))
    st, pos, sq_pos, absorbed = host.export_state()
    dpx = fused._DeviceDuplex(bb.to_device(st, "cpu"), pos, sq_pos, absorbed)
    for i, n_in in enumerate((16, 0, 3, 8, 0)):
        words = _rand([pos, 10, i], n_in)
        host.append(words)
        want = host.sample_ext()
        out = torch.zeros(4, dtype=bb.DTYPE)
        dpx.sample_ext(out, absorb=bb.to_device(words, "cpu") if n_in else None)
        np.testing.assert_array_equal(bb.to_host(out), want)
        assert (dpx.pos, dpx.sq_pos, dpx.absorbed) == host.export_state()[1:]
    np.testing.assert_array_equal(bb.to_host(dpx.state), host.state)


def test_fused_rounds_returns_messages_state_and_merged_bank():
    """``fused_rounds`` leaves the start state as it was, and its messages
    and end state are those of the per-round path's transcript."""
    base, ext, terms = _inputs(3, "mixed")
    b, e, s, deg = prover.compile_terms(terms, 3, 2)
    banks = [bb.to_device(c, "cpu") for c in base], [bb.to_device(c, "cpu") for c in ext]
    base_bank, ext_bank = T.make_banks(*banks, 8)
    midx = T.merge_indices(b, e, 3, 2)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    host = Transcript(LABEL)
    start = bb.to_device(host.state, "cpu")
    msgs, end, merged = fused.fused_rounds(
        base_bank, ext_bank, t(b), t(e), t(midx), bb.to_device(s.T, "cpu"), start,
        deg=deg, k=3, pos=host._pos, sq_pos=host._sq_pos, absorbed=host._absorbed)
    np.testing.assert_array_equal(bb.to_host(start), host.state)
    assert tuple(msgs.shape) == (3, deg + 1, 4) and tuple(merged.shape) == (4, 6, 1)
    for m in bb.to_host(msgs):
        host.append(m.ravel())
        host.sample_ext()
    np.testing.assert_array_equal(bb.to_host(end), host.state)
    with pytest.raises(ValueError, match="midx"):
        bad = t(midx)
        bad[0, 0] = 6
        fused.fused_rounds(base_bank, ext_bank, t(b), t(e), bad, bb.to_device(s.T, "cpu"),
                           start, deg=deg, k=3, pos=0, sq_pos=8, absorbed=False)


def test_diverged_device_sponge_raises(monkeypatch):
    """A device sponge that ends elsewhere than the host's replay is an
    error, not a proof."""
    base, ext, terms = _inputs(2, "mixed")
    plain = fused.duplex_plain

    def off_by_one(state, *args):
        plain(state, *args)
        state[15] = bb.add(state[15], torch.tensor(bb.MONTY_ONE, dtype=bb.DTYPE))
    monkeypatch.setattr(fused, "duplex_plain", off_by_one)
    with pytest.raises(RuntimeError, match="sponge state"):
        _port(base, ext, terms, 2, monkeypatch, True)
