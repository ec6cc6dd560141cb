"""The port's Goldilocks pipeline (gl/: transcript, sumcheck, PCS, the
single-chip prover) against the reference's, case by case as
tests/test_gl_pipeline.py runs it: the same numpy-seeded inputs go through
``ceno_tpu.gl`` and ``ceno_tpu_torch.gl`` (CPU tensors); messages, roots,
openings and chip proofs must be equal, the port's verifiers must accept
them and reject the tampered ones. Also the interop converters' round trips
and the golden file's reference digests. All comparisons are exact."""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch

from ceno_tpu.fields import gl2_host as rg2
from ceno_tpu.fields import gl_host as rgl
from ceno_tpu.gl import pcs as rpcs
from ceno_tpu.gl import poseidon2 as rp2
from ceno_tpu.gl import sumcheck as rsc
from ceno_tpu.gl import zkvm as rz
from ceno_tpu.gl.transcript import GlTranscript as RefTranscript
from ceno_tpu_torch import interop
from ceno_tpu_torch.fields import gl2_host as g2
from ceno_tpu_torch.fields import goldilocks as gld
from ceno_tpu_torch.fields import goldilocks_ext2 as gx
from ceno_tpu_torch.gl import pcs, sumcheck as sc
from ceno_tpu_torch.gl import poseidon2 as p2
from ceno_tpu_torch.gl import zkvm as gz
from ceno_tpu_torch.gl.transcript import GlTranscript

import chip_smoke

torch.set_num_threads(1)
P = gld.P
PCS_PARAMS = [dict(blowup_log=1, n_queries=6, pow_bits=4, stop_size=16),
              dict(blowup_log=2, n_queries=8, pow_bits=4, stop_size=32)]
PCS_SHAPES = [(7, 3), (9, 5)]  # (n_vars, n_cols) of test_gl_pcs_roundtrip / _multi_level


def _rand_base(rng, shape):
    lo = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    hi = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
    return (lo | (hi << np.uint64(32))) % np.uint64(P)


def _rand_ext(rng, shape):
    return np.stack([_rand_base(rng, shape), _rand_base(rng, shape)], axis=-1)


def _equal(a, b, path="proof"):
    """Two proof objects (either package), field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _equal(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype == np.uint64, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def test_gl_field_conformance():
    random.seed(11)
    pairs = [(random.randrange(P), random.randrange(P)) for _ in range(200)]
    a = np.array([x for x, _ in pairs], np.uint64)
    b = np.array([y for _, y in pairs], np.uint64)
    ta, tb = gld.to_device(a, "cpu"), gld.to_device(b, "cpu")
    assert gld.to_host(gld.mul(ta, tb)).tolist() == [x * y % P for x, y in pairs]
    assert gld.to_host(gld.add(ta, tb)).tolist() == [(x + y) % P for x, y in pairs]
    assert gld.to_host(gld.sub(ta, tb)).tolist() == [(x - y) % P for x, y in pairs]
    assert np.array_equal(gld.to_host(gld.mul(ta, tb)), rgl.mul(a, b))
    r = _rand_base(np.random.default_rng(7), 32)
    tr = gld.to_device(r, "cpu")
    assert gld.to_host(gld.mul(tr, gld.inv(tr))).tolist() == [1] * 32
    w = gld.two_adic_root(12)
    assert pow(w, 1 << 12, P) == 1 and pow(w, 1 << 11, P) != 1


def test_gl_poseidon2_permutes_and_batches():
    rng = np.random.default_rng(7)
    lanes = _rand_base(rng, (8, 2))
    out = p2.permute_host(lanes)
    assert np.array_equal(out, rp2.permute_host(lanes))
    assert not np.array_equal(out[:, 0], lanes[:, 0])
    for i in range(2):
        assert np.array_equal(out[:, i], p2.permute_host(lanes[:, i]))
    assert np.array_equal(gld.to_host(p2.permute(gld.to_device(lanes, "cpu"))), out)


def _sumcheck_case():
    rng = np.random.default_rng(7)
    n_vars, n = 6, 64
    f, g, scalar = _rand_base(rng, n), _rand_ext(rng, n), _rand_ext(rng, ())
    return n_vars, f, g, scalar


@pytest.mark.parametrize("node_batch", [sc.NODE_BATCH, 1], ids=["batched", "node_by_node"])
def test_gl_sumcheck_roundtrip(node_batch, monkeypatch):
    monkeypatch.setattr(sc, "NODE_BATCH", node_batch)
    n_vars, f, g, scalar = _sumcheck_case()
    terms = [(scalar, (0,), (0,))]
    want = rsc.prove([f], [g], terms, n_vars, RefTranscript(b"gl-sc"))
    got = sc.prove([f], [g], terms, n_vars, GlTranscript(b"gl-sc"), device="cpu")
    _equal(want, got)
    acc = np.zeros(2, np.uint64)
    for i in range(len(f)):
        acc = g2.add(acc, g2.mul(g2.from_base(f[i]), g[i]))
    claim = g2.mul(scalar, acc)
    point, final = sc.verify(claim, got.round_msgs, n_vars, GlTranscript(b"gl-sc"), deg=2)
    assert np.array_equal(point, got.point)
    assert np.array_equal(final, g2.mul(scalar, g2.mul(got.final_base[0], got.final_ext[0])))
    assert np.array_equal(gx.to_host(sc.build_eq(point, "cpu")), rsc.build_eq(point))
    assert np.array_equal(sc.build_eq_host(point), rsc.build_eq(point))


def test_gl_sumcheck_rejects_tamper():
    rng = np.random.default_rng(8)
    n_vars, n = 4, 16
    f = _rand_base(rng, n)
    claim = np.array([int(f.astype(object).sum()) % P, 0], np.uint64)
    out = sc.prove([f], [], [(g2.one(), (0,), ())], n_vars, GlTranscript(b"gl-sc2"),
                   device="cpu")
    _equal(rsc.prove([f], [], [(rg2.one(), (0,), ())], n_vars, RefTranscript(b"gl-sc2")), out)
    sc.verify(claim, out.round_msgs, n_vars, GlTranscript(b"gl-sc2"), deg=1)
    bad = out.round_msgs.copy()
    bad[1, 0, 0] = (int(bad[1, 0, 0]) + 1) % P
    with pytest.raises(sc.GlSumcheckError):
        sc.verify(claim, bad, n_vars, GlTranscript(b"gl-sc2"), deg=1)


def _pcs_inputs(case: int):
    n_vars, n_cols = PCS_SHAPES[case]
    rng = np.random.default_rng(100 + case)
    cols = _rand_base(rng, (n_cols, 1 << n_vars))
    z = _rand_ext(rng, n_vars)
    values = []
    for j in range(n_cols):
        cur = rg2.from_base(cols[j])
        for t in range(n_vars):
            cur = rsc._fold_top(cur, z[t])
        values.append(cur[0])
    return n_vars, n_cols, cols, z, np.stack(values)


@pytest.fixture(scope="module", params=[0, 1], ids=["roundtrip", "multi_level"])
def pcs_case(request):
    """(inputs, params, the port's commitment and opening), the opening held
    against the reference's."""
    n_vars, n_cols, cols, z, values = _pcs_inputs(request.param)
    prm = PCS_PARAMS[request.param]
    rc = rpcs.commit(cols, rpcs.GlParams(**prm))
    tr = RefTranscript(b"gl-pcs")
    tr.append(rc.root)
    want = rpcs.open_batch(rc, z, values, tr, rpcs.GlParams(**prm))
    committed = pcs.commit(cols, pcs.GlParams(**prm), device="cpu")
    assert np.array_equal(committed.root, rc.root)
    tp = GlTranscript(b"gl-pcs")
    tp.append(committed.root)
    got = pcs.open_batch(committed, z, values, tp, pcs.GlParams(**prm))
    return dict(n_vars=n_vars, n_cols=n_cols, cols=cols, z=z, values=values,
                params=pcs.GlParams(**prm), committed=committed, want=want, got=got)


def _verify(case, proof=None, values=None):
    tv = GlTranscript(b"gl-pcs")
    tv.append(case["committed"].root)
    pcs.verify_batch(case["committed"].root, case["n_vars"], case["n_cols"], case["z"],
                     case["values"] if values is None else values,
                     case["got"] if proof is None else proof, tv, case["params"])


def test_gl_pcs_roundtrip(pcs_case):
    """test_gl_pcs_roundtrip and test_gl_pcs_multi_level: equal openings,
    accepted by the port's verifier."""
    _equal(pcs_case["want"], pcs_case["got"])
    _verify(pcs_case)


def test_gl_pcs_rejects_wrong_value(pcs_case):
    values = pcs_case["values"].copy()
    values[0] = g2.add(values[0], g2.one())
    with pytest.raises(pcs.GlPCSError):
        _verify(pcs_case, values=values)


def test_gl_pcs_rejects_tampered_query(pcs_case):
    bad = interop.gl_opening_from_dict(interop.gl_opening_to_dict(pcs_case["got"]))
    q = bad.queries[0]
    q.base_col_vals[0, 0] = (int(q.base_col_vals[0, 0]) + 1) % P
    with pytest.raises(pcs.GlPCSError):
        _verify(pcs_case, proof=bad)


def test_gl_pcs_rejects_bad_pow(pcs_case):
    bad = interop.gl_opening_from_dict(interop.gl_opening_to_dict(pcs_case["got"]))
    bad.pow_nonce = (bad.pow_nonce + 1) % P
    with pytest.raises(pcs.GlPCSError):
        _verify(pcs_case, proof=bad)


def test_gl_pcs_rejects_tampered_tail(pcs_case):
    bad = interop.gl_opening_from_dict(interop.gl_opening_to_dict(pcs_case["got"]))
    bad.tail[0, 0] = (int(bad.tail[0, 0]) + 1) % P
    with pytest.raises(pcs.GlPCSError):
        _verify(pcs_case, proof=bad)


@pytest.fixture(scope="module")
def add_chip():
    """fibonacci_vm(40)'s add chip at tests/test_gl_pipeline.py's setup,
    proved by both packages: (reference compiled chip, port compiled chip,
    witness, public values, params, reference proof, port proof)."""
    from ceno_tpu.emulator import native, programs
    from ceno_tpu.zkvm.chips import build_all_chips
    from ceno_tpu.zkvm.chips.opcodes import TraceView
    from ceno_tpu.zkvm.e2e import public_values_from_vm
    from ceno_tpu.zkvm.tables import ZKVMConfig
    from ceno_tpu.zkvm.witgen import assign_opcode_chips
    from ceno_tpu_torch.zkvm.chips import build_all_chips as port_chips

    vm = programs.fibonacci_vm(40)
    trace = native.run_trace(vm)
    view = trace if isinstance(trace, TraceView) else TraceView.from_records(trace)
    add = next(a for a in assign_opcode_chips(view, build_all_chips())
               if a.name == "add" and a.num_instances)
    pv = public_values_from_vm(vm, ZKVMConfig(shl_x_bits=6, mem_words_log=7))
    wit = np.asarray(add.wit, np.uint64).copy()
    wn = add.cb.wit_names
    wit[wn.index("rd_idinv")] = rgl.inv(wit[wn.index("rd_id")])
    prm = chip_smoke.GL_GOLDEN_PARAMS
    want = rz.prove_chip_gl(add.compiled, wit, pv, add.num_instances, rpcs.GlParams(**prm))
    compiled = next(c for c in port_chips() if c.name == "add").compiled
    got = gz.prove_chip_gl(compiled, wit, pv, add.num_instances, pcs.GlParams(**prm),
                           device="cpu")
    return dict(ref_compiled=add.compiled, compiled=compiled, wit=wit, pv=pv, k=add.num_instances,
                wn=wn, params=pcs.GlParams(**prm), want=want, got=got)


def test_gl_zkvm_chip_proves_real_add_circuit(add_chip):
    """The real rv32im ADD chip proves over GoldilocksExt2 on CPU tensors to
    the reference's proof, which the port's verifier accepts; a tower total
    equals the records' direct product."""
    c = add_chip
    _equal(c["want"], c["got"])
    prod_values, _ = gz.verify_chip_gl(c["compiled"], c["got"], c["pv"], c["params"])
    t = GlTranscript(gz.LABEL)
    t.append(c["got"].root)
    t.append([c["k"] % P])
    challenges = np.stack([t.sample_ext(), t.sample_ext()])
    n = c["wit"].shape[1]
    empty = torch.zeros((0, n), dtype=gld.DTYPE)
    prods, _ = gz.build_records_gl(c["compiled"], gld.to_device(c["wit"], "cpu"), empty, empty,
                                   c["pv"], challenges, c["k"])
    direct = g2.one()
    for row in gx.to_host(prods[0]):
        direct = g2.mul(direct, row)
    assert np.array_equal(prod_values[0], direct)


def test_gl_zkvm_chip_rejects_tampered_witness(add_chip):
    """The reference test's tamper: the is-zero flag of row 1 changed (it
    breaks the rd_z_def zero constraint); proved by the port on CPU tensors,
    rejected by its verifier."""
    c = add_chip
    bad_wit = c["wit"].copy()
    zc = c["wn"].index("rd_iszero")
    bad_wit[zc, 1] = (int(bad_wit[zc, 1]) + 1) % P
    bad = gz.prove_chip_gl(c["compiled"], bad_wit, c["pv"], c["k"], c["params"], device="cpu")
    with pytest.raises((gz.GlZkvmError, sc.GlSumcheckError, pcs.GlPCSError)):
        gz.verify_chip_gl(c["compiled"], bad, c["pv"], c["params"])
    for what, tampered in chip_smoke.gl_tampered(c["got"]):
        with pytest.raises((gz.GlZkvmError, sc.GlSumcheckError, pcs.GlPCSError)):
            gz.verify_chip_gl(c["compiled"], tampered, c["pv"], c["params"])


def test_interop_round_trips(add_chip, pcs_case):
    """Each GL object to its plain dict and back (the port's and the
    reference's objects give the same dict and digest)."""
    c = add_chip
    d = interop.gl_chip_proof_to_dict(c["got"])
    assert interop.digest(d) == interop.digest(interop.gl_chip_proof_to_dict(c["want"]))
    back = interop.gl_chip_proof_from_dict(interop.gl_chip_proof_to_dict(c["want"]))
    _equal(back, c["got"])
    assert interop.gl_chip_proof_digest(back) == interop.gl_chip_proof_digest(c["want"])
    _equal(interop.gl_tower_proof_from_dict(interop.gl_tower_proof_to_dict(c["want"].tower)),
           c["got"].tower)
    _equal(interop.gl_opening_from_dict(interop.gl_opening_to_dict(pcs_case["want"])),
           pcs_case["got"])
    q = pcs_case["want"].queries[0]
    _equal(interop.gl_query_from_dict(interop.gl_query_to_dict(q)), pcs_case["got"].queries[0])
    n_vars, f, g, scalar = _sumcheck_case()
    out = rsc.prove([f], [g], [(scalar, (0,), (0,))], n_vars, RefTranscript(b"gl-sc"))
    _equal(interop.gl_sumcheck_output_from_dict(interop.gl_sumcheck_output_to_dict(out)),
           sc.prove([f], [g], [(scalar, (0,), (0,))], n_vars, GlTranscript(b"gl-sc"),
                    device="cpu"))
    ref_committed = rpcs.commit(pcs_case["cols"], rpcs.GlParams(**dataclasses.asdict(
        pcs_case["params"])))
    plain = interop.gl_committed_to_numpy(ref_committed)
    back = interop.gl_committed_from_numpy(plain, device="cpu")
    assert interop.digest(interop.gl_committed_to_numpy(back)) == interop.digest(plain)
    assert interop.digest(interop.gl_committed_to_numpy(pcs_case["committed"])) == \
        interop.digest(plain)
    assert np.array_equal(back.tree.open_path(3), ref_committed.tree.open_path(3))


def test_golden_file_holds_the_reference_digests(add_chip):
    """ceno_tpu_torch/golden/gl_pipeline.json (tools/torch_gl_golden.py) is
    current: its chip digest is the reference proof's at these inputs, its
    roots the reference commits', its sumcheck digest the reference's."""
    with open(chip_smoke.GL_GOLDEN) as f:
        want = json.load(f)
    assert want["params"] == chip_smoke.GL_GOLDEN_PARAMS
    assert want["chip"]["digest"] == interop.gl_chip_proof_digest(add_chip["want"])
    assert want["chip"]["rows"] == add_chip["k"]
    for name, cols, b in chip_smoke.gl_golden_commit_inputs():
        assert want["commit_roots"][name] == rpcs.commit(cols, rpcs.GlParams(blowup_log=b)) \
            .root.tolist()
    base, ext, terms, n_vars = chip_smoke.gl_golden_sumcheck_inputs()
    out = rsc.prove(base, ext, terms, n_vars, RefTranscript(b"gl-golden-sc"))
    assert want["sumcheck"] == interop.digest(interop.gl_sumcheck_output_to_dict(out))
    assert os.path.basename(chip_smoke.GL_GOLDEN) == "gl_pipeline.json"
