"""The port's GL continuations (gl/{gadget,shard_chips,eccquark,shard}.py and
the witgen's shard-chip hooks) against the reference's, as
tests/test_gl_continuation.py runs them, on the real tokens of a two-shard
plan: the same inputs go through ``ceno_tpu`` and ``ceno_tpu_torch`` (CPU
tensors where the port runs on a device), and every chip, witness, point,
public value and proof must be equal; the port's witnesses must satisfy
their chips' constraints, and both verifiers must reject the quark proof
under a changed final sum. All comparisons are exact.

The reference proves the two shards only in a ``slow`` test (about 15
minutes); chip_smoke.py's phase 12 holds the port's two-shard proof against
the reference's digests on the card, and tests/test_torch_gl_scheme.py has
the ``slow`` CPU check."""

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.fields import gl2_host as rg2
from ceno_tpu.gkr.circuit_builder import CircuitBuilder as RCircuitBuilder
from ceno_tpu.gl import eccquark as rq
from ceno_tpu.gl import gadget as rgadget
from ceno_tpu.gl import scheme as rgls
from ceno_tpu.gl import shard as rshard
from ceno_tpu.gl import shard_chips as rsc
from ceno_tpu.gl.transcript import GlTranscript as RTranscript
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm.chips import field_ctx as rfield_ctx
from ceno_tpu.zkvm.chips.opcodes import TraceView as RTraceView
from ceno_tpu.zkvm.scheme import keygen as rkeygen
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu.zkvm.witgen import generate_witness as rgenerate_witness

import chip_smoke
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import native, programs
from ceno_tpu_torch.fields import gl_host as gl
from ceno_tpu_torch.fields import gl5_host as G5
from ceno_tpu_torch.fields import goldilocks as gld
from ceno_tpu_torch.gkr.chip import chip_digest
from ceno_tpu_torch.gkr.circuit_builder import CircuitBuilder
from ceno_tpu_torch.gl import eccquark as glq
from ceno_tpu_torch.gl import gadget
from ceno_tpu_torch.gl import scheme as gls
from ceno_tpu_torch.gl import shard as gshard
from ceno_tpu_torch.gl import shard_chips as sc
from ceno_tpu_torch.gl.sumcheck import build_eq_host
from ceno_tpu_torch.gl.transcript import GlTranscript
from ceno_tpu_torch.gl.zkvm import eval_expr_gl
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm.chips import field_ctx
from ceno_tpu_torch.zkvm.chips.shard_ram import Tokens
from ceno_tpu_torch.zkvm.layout import N_PUBLIC_VALUES, PV_RW_SUM_IN, PV_RW_SUM_OUT, PV_SHARD_ID
from ceno_tpu_torch.zkvm.scheme import keygen
from ceno_tpu_torch.zkvm.tables import ZKVMConfig
from ceno_tpu_torch.zkvm.witgen import generate_witness

torch.set_num_threads(1)
P = gl.P
FAST = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}  # the BabyBear key's commit, unused by GL


def gl_mock_check(chip, wit, k, pv):
    """Every ``require_zero`` of a GL chip vanishes on the active rows
    (tests/test_gl_continuation.py's GL MockProver), through the port's
    ``eval_expr_gl`` on CPU tensors."""
    n = wit.shape[1]
    w = gld.to_device(wit, "cpu")
    empty = torch.zeros((0, n), dtype=gld.DTYPE)
    chals = gld.to_device(np.stack([rg2.from_base(7), rg2.from_base(13)]), "cpu")
    memo = {}
    for name, expr in chip.cb.zeros:
        kind, v = eval_expr_gl(expr, w, empty, empty, pv, chals, memo)
        v = gld.to_host(v)
        v = np.broadcast_to(np.atleast_1d(v), (n,)) if kind == "b" else v
        assert not np.asarray(v[:k]).any(), f"{chip.name}.{name} violated"


@pytest.fixture(scope="module")
def plans():
    """Both packages' GL shard plans of tests/test_gl_continuation.py's
    two-shard setup (fibonacci_vm(8), max_steps_per_shard = n // 2 + 4),
    each package's key and trace beside its plan."""
    cfg = dict(chip_smoke.GL_SCHEME_GOLDEN_CFG)
    rvm = rprograms.fibonacci_vm(chip_smoke.GL_SCHEME_GOLDEN_ITERS)
    rview = RTraceView.from_records(rvm.run())
    rpk = rkeygen(rvm.program, RConfig(**cfg), RParams(**FAST))
    steps = chip_smoke.gl_golden_shard_steps(rview.n)
    rctxs = rshard.plan_shards_gl(rview, rvm, rpk, rpk.cfg, steps)
    vm = programs.fibonacci_vm(chip_smoke.GL_SCHEME_GOLDEN_ITERS)
    view = native.run_trace_native(vm)
    pk = keygen(vm.program, ZKVMConfig(**cfg), BasefoldParams(**FAST), device="cpu")
    ctxs = gshard.plan_shards_gl(view, vm, pk, pk.cfg, steps)
    return {"ref": (rpk, rvm, rview, rctxs), "port": (pk, vm, view, ctxs)}


def rand_tokens(rng, n, shard=1):
    return Tokens(is_reg=rng.integers(0, 2, n).astype(np.uint64),
                  addr=rng.integers(0, 1 << 20, n).astype(np.uint64),
                  value=rng.integers(0, 1 << 32, n).astype(np.uint64),
                  shard=np.full(n, shard, np.uint64),
                  clk=rng.integers(1, 1 << 24, n).astype(np.uint64))


def test_gadget_assignment_and_constraints():
    rng = np.random.default_rng(3)
    inputs = rng.integers(0, P, size=(9, 8), dtype=np.uint64)
    u, w, final = gadget.assign_poseidon2_gl(inputs)
    ru, rw, rfinal = rgadget.assign_poseidon2_gl(inputs)
    assert len(u) == len(ru) == len(w) == len(rw) == 86
    for a, b in zip(u + w + [final], ru + rw + [rfinal]):
        assert np.array_equal(a, b)
    from ceno_tpu_torch.gl import poseidon2 as p2

    assert np.array_equal(final, p2.permute_host(inputs.T).T)
    built = []
    for cb_cls, mod in ((CircuitBuilder, gadget), (RCircuitBuilder, rgadget)):
        cb = cb_cls("p2gl")
        ins = [mod.GlLin.col(cb.create_witin(f"in{i}")) for i in range(8)]
        ins[3] = ins[3].scale(P - 2) + 5
        outs = mod.build_poseidon2_gl(cb, "p2", ins)
        built.append((cb.wit_names, [(n, repr(e)) for n, e in cb.zeros],
                      [repr(o.to_expr()) for o in outs]))
    assert built[0] == built[1]


def test_chips_compiled_equal():
    mine, ref = sc.build_gl_shard_chips(), rsc.build_gl_shard_chips()
    assert [c.kind for c in mine] == [c.kind for c in ref] == [
        "shard_ram_in", "shard_ram_out", "ec_tree_in", "ec_tree_out"]
    for a, b in zip(mine, ref):
        assert (a.name, a.cb.wit_names) == (b.name, b.cb.wit_names)
        assert chip_digest(a.compiled) == chip_digest(b.compiled)
        assert (a.assign_shard_fn is None) == (b.assign_shard_fn is None)
        assert (a.assign_tree_fn is None) == (b.assign_tree_fn is None)


def test_plan_public_values_equal(plans):
    rctxs, ctxs = plans["ref"][3], plans["port"][3]
    assert len(ctxs) == len(rctxs) == 2
    for a, b in zip(ctxs, rctxs):
        da, db = interop.shard_context_to_dict(a), interop.shard_context_to_dict(b)
        assert interop.digest(da) == interop.digest(db)
        assert a.pv.dtype == np.uint64 and np.array_equal(a.pv, b.pv)
    assert any(c.pv[PV_RW_SUM_IN:PV_RW_SUM_IN + 5].any() for c in ctxs), \
        "no cross-shard tokens hashed"


@pytest.mark.parametrize("direction", ["in", "out"])
def test_shard_chips_on_real_tokens(plans, direction):
    """On every shard's real tokens of one direction: the shard-RAM witness
    and the EC-tree witness and sum equal the reference's, the port's points
    are the reference witness's nonce, x and y columns, the tree sum is the
    public values' rw sum, and the port's witnesses satisfy their chips."""
    mine, ref = sc.build_gl_shard_chips(), rsc.build_gl_shard_chips()
    j = 0 if direction == "in" else 1
    base = PV_RW_SUM_IN if direction == "in" else PV_RW_SUM_OUT
    seen = 0
    for ctx in plans["port"][3]:
        tok = ctx.in_tokens if direction == "in" else ctx.out_tokens
        if tok.n == 0:
            continue
        seen += 1
        wit = sc.assign_shard_ram_gl(mine[j], tok)
        rwit = rsc.assign_shard_ram_gl(ref[j], tok)
        assert wit.dtype == np.uint64 and np.array_equal(wit, rwit)
        nonce, xs, ys = sc.tokens_to_points_gl(tok)
        if direction == "out":
            ys = G5.neg(ys)  # the write half, as the chip holds it
        col = {name: rwit[i, :tok.n] for i, name in enumerate(ref[j].cb.wit_names)}
        assert np.array_equal(nonce, col["nonce"])
        assert np.array_equal(xs, np.stack([col[f"x{i}"] for i in range(5)], axis=1))
        assert np.array_equal(ys, np.stack([col[f"y{i}"] for i in range(5)], axis=1))
        pv = np.array(ctx.pv, np.uint64)
        gl_mock_check(mine[j], wit, tok.n, pv)
        twit, fsum = sc.assign_ec_tree_gl(mine[2 + j], tok)
        rtwit, rfsum = rsc.assign_ec_tree_gl(ref[2 + j], tok)
        assert np.array_equal(twit, rtwit) and np.array_equal(fsum, rfsum)
        assert np.array_equal(fsum, np.stack([pv[base:base + 5], pv[base + 7:base + 12]]))
    assert seen, f"no shard has {direction} tokens"


def test_shard_ram_chip_rejects_a_changed_y():
    """tests/test_gl_continuation.py's tamper: a changed y limb violates the
    curve constraint (through the port's mock check)."""
    chip = sc.build_gl_shard_chips()[0]
    tok = rand_tokens(np.random.default_rng(11), 5, shard=3)
    wit = sc.assign_shard_ram_gl(chip, tok)
    pv = np.zeros(N_PUBLIC_VALUES, np.uint64)
    pv[PV_SHARD_ID] = 3
    gl_mock_check(chip, wit, tok.n, pv)
    bad = wit.copy()
    yi = chip.cb.wit_names.index("y0")
    bad[yi, 0] = (int(bad[yi, 0]) + 1) % P
    with pytest.raises(AssertionError):
        gl_mock_check(chip, bad, tok.n, pv)


def test_gl_quark_roundtrip():
    rng = np.random.default_rng(11)
    n_pts, xs, ys = 11, [], []
    while len(xs) < n_pts:
        cand = rng.integers(0, 1 << 62, (8, 5)).astype(np.uint64)
        y, ok = G5.from_x(cand)
        for i in np.nonzero(ok)[0][: n_pts - len(xs)]:
            xs.append(cand[i])
            ys.append(y[i])
    xs, ys = np.stack(xs), np.stack(ys)
    x, y, s, final = glq.build_tree_witness(xs, ys, 32)
    for a, b in zip((x, y, s, final), rq.build_tree_witness(xs, ys, 32)):
        assert np.array_equal(a, b)
    acc = (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    for i in range(n_pts):
        acc = G5.point_add(acc, (xs[i], ys[i]))
    assert np.array_equal(final[0], acc[0]) and np.array_equal(final[1], acc[1])

    proof, rt = glq.prove_ec_sum(x, y, s, n_pts, final, GlTranscript(b"test-gl-quark"),
                                 device="cpu")
    rproof, rrt = rq.prove_ec_sum(x, y, s, n_pts, final, RTranscript(b"test-gl-quark"))
    assert np.array_equal(rt, rrt)
    assert interop.gl_ecc_quark_proof_to_dict(proof).keys() == \
        interop.gl_ecc_quark_proof_to_dict(rproof).keys()
    assert interop.digest(interop.gl_ecc_quark_proof_to_dict(proof)) == \
        interop.digest(interop.gl_ecc_quark_proof_to_dict(rproof))
    back = interop.gl_ecc_quark_proof_from_dict(interop.gl_ecc_quark_proof_to_dict(rproof))
    rt_v, evals = glq.verify_ec_sum(back, final, GlTranscript(b"test-gl-quark"))
    rrt_v, revals = rq.verify_ec_sum(proof, final, RTranscript(b"test-gl-quark"))
    assert np.array_equal(rt_v, rt) and np.array_equal(rrt_v, rt)
    assert np.array_equal(evals, revals)
    cols = np.concatenate([x, y, s], axis=0)
    pts = glq.extended_points(rt_v)
    for pname, claims in glq.EC_POINTS:
        eq = build_eq_host(pts[pname])
        for ev_off, col_base in claims:
            for c in range(5):
                col = cols[col_base + c]
                direct = np.array([int((eq[:, j].astype(object) * col.astype(object)).sum()) % P
                                   for j in range(2)], np.uint64)
                assert np.array_equal(direct, evals[ev_off + c]), (pname, ev_off, c)
    assert glq.EC_POINTS == rq.EC_POINTS
    for name in ("even", "odd", "half"):
        assert np.array_equal(pts[name], rq.extended_points(rt_v)[name])
    bad = np.array(final, np.uint64)
    bad[0, 0] = (int(bad[0, 0]) + 1) % P
    with pytest.raises(glq.GlEccError):
        glq.verify_ec_sum(proof, bad, GlTranscript(b"test-gl-quark"))
    with pytest.raises(rq.GlEccError):
        rq.verify_ec_sum(proof, bad, RTranscript(b"test-gl-quark"))


def _assigned_digest(a) -> tuple:
    fsum = None if a.ec_final_sum is None else np.asarray(a.ec_final_sum, np.uint64).tolist()
    return (a.name, a.kind, a.num_instances, a.n_rows, interop.digest(np.asarray(a.wit)), fsum)


def test_sharded_gl_witgen_equal(plans):
    """Each shard's GL witgen, with the GL shard chips reached through the
    hooks, equals the reference's chip by chip."""
    rpk, rvm, rview, rctxs = plans["ref"]
    pk, vm, view, ctxs = plans["port"]
    vk, rvk = gls.keygen_gl(pk), rgls.keygen_gl(rpk)
    for ctx, rctx in zip(ctxs, rctxs):
        sub = view.select(np.arange(ctx.step_lo, ctx.step_hi))
        rsub = rview.select(np.arange(rctx.step_lo, rctx.step_hi))
        with field_ctx.use(gl.P, inv=gl.inv):
            got = generate_witness(sub, pk.opcode_chips, pk.tables, vm, ctx.pv, pk.cfg,
                                   shard_ctx=ctx, shard_chips=vk.shard_chips,
                                   dyn_chips=pk.dyn_chips, data_image=pk.data_image)
        with rfield_ctx.use(gl.P, inv=gl.inv):
            want = rgenerate_witness(rsub, rpk.opcode_chips, rpk.tables, rvm, rctx.pv,
                                     rpk.cfg, shard_ctx=rctx, shard_chips=rvk.shard_chips,
                                     dyn_chips=rpk.dyn_chips, data_image=rpk.data_image)
        assert len(got) == len(want) == len(vk.metas)
        for a, b in zip(got, want):
            assert _assigned_digest(a) == _assigned_digest(b), a.name
        shard_wits = {a.kind: a for a in got if a.kind.startswith(("shard_ram", "ec_tree"))}
        assert set(shard_wits) == {"shard_ram_in", "shard_ram_out", "ec_tree_in", "ec_tree_out"}
        for a in shard_wits.values():
            if a.kind.startswith("shard_ram") and a.num_instances:
                gl_mock_check(a, a.wit, a.num_instances, np.array(ctx.pv, np.uint64))
