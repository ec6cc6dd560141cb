"""Port parity: the whole key (every chip and table of the registry) against
the reference, exactly.

- each of the 93 metas (name, kind, gate, table rows, witness / fixed /
  structural column counts, ``chip_digest``) at the fast test config and at
  bench.py's ``ZKVMConfig(shl_x_bits=10)``;
- the fixed layout and the stacked fixed matrix at both configs; at
  bench.py's setup the matrix has the content key that names the committed
  golden commitment (``.commit_cache/``);
- ``keygen`` at the fast config and fast params: ``digest_elems()``, the
  fixed roots, and ``interop.key_summary`` of each side;
- the chips, tables and helpers new to the port hold their copies' values:
  the septic curve arithmetic, the Poseidon2 gadget's witness, the
  shard-RAM and EC-tree witnesses over no token and over seeded tokens;
- ``emulator/elf.py``: ``write_elf`` -> ``load_elf`` gives the same bytes
  and the same Program.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ceno_tpu.emulator import elf as relf
from ceno_tpu.emulator import programs as rprograms
from ceno_tpu.emulator.rv32im import assemble as rassemble
from ceno_tpu.fields import septic as rseptic
from ceno_tpu.gkr.chip import chip_digest as rchip_digest
from ceno_tpu.pcs import jagged as rjagged
from ceno_tpu.pcs.basefold import BasefoldParams as RParams
from ceno_tpu.zkvm import scheme as rscheme
from ceno_tpu.zkvm.chips import build_all_chips as rbuild_all_chips
from ceno_tpu.zkvm.chips import poseidon2_gadget as rgadget
from ceno_tpu.zkvm.chips import shard_ram as rshard
from ceno_tpu.zkvm.chips.dyn_ram import build_dyn_ram_chips as rbuild_dyn
from ceno_tpu.zkvm.tables import ZKVMConfig as RConfig
from ceno_tpu.zkvm.tables import build_tables as rbuild_tables
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import elf, programs
from ceno_tpu_torch.emulator.rv32im import assemble
from ceno_tpu_torch.fields import septic
from ceno_tpu_torch.gkr.chip import chip_digest
from ceno_tpu_torch.pcs.basefold import BasefoldParams
from ceno_tpu_torch.zkvm import scheme
from ceno_tpu_torch.zkvm.chips import poseidon2_gadget as gadget
from ceno_tpu_torch.zkvm.chips import shard_ram
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)
P = 2013265921
CONFIGS = {"fast": dict(shl_x_bits=6, mem_words_log=7), "bench": dict(shl_x_bits=10)}
FAST_PARAMS = dict(blowup_log=1, n_queries=4, stop_size=32)
BENCH_ITERS = chip_smoke.E2E_ITERS  # bench.py's fibonacci_vm(174760)


def _ref_registry(program_words, cfg):
    """The reference's metas, built as its keygen builds them
    (ceno_tpu/zkvm/scheme.py:142-158), and its tables."""
    M = rscheme.ChipMeta
    tables = rbuild_tables(program_words, cfg, None)
    metas = [M(c.name, c.compiled, c.cb, False, None) for c in rbuild_all_chips()]
    metas += [M(c.name, c.compiled, c.cb, False, None, kind=c.kind)
              for c in rshard.build_shard_chips()]
    metas += [M(c.name, c.compiled, c.cb, False, None, kind=c.kind, gate=c.gate)
              for c in rbuild_dyn(cfg)]
    metas += [M(t.name, t.compiled, t.cb, True, t.n_rows, kind="table", gate=t.gate)
              for t in tables]
    return metas, tables


def _meta_rows(metas, digest):
    return [(m.name, m.kind, m.gate, m.is_table, m.table_rows, len(m.cb.wit_names),
             len(m.cb.fixed_names), len(m.compiled.structural), m.compiled.n_wit,
             m.compiled.n_fixed, digest(m.compiled)) for m in metas]


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def registries(request):
    iters = BENCH_ITERS if request.param == "bench" else 8
    cfg = CONFIGS[request.param]
    ref = _ref_registry(rprograms.fibonacci_vm(iters).program, RConfig(**cfg))
    port = scheme.registry(programs.fibonacci_vm(iters).program, ZKVMConfig(**cfg))
    return request.param, ref, port


def test_every_meta_equal(registries):
    _, (rmetas, _), (*_, metas) = registries
    assert len(metas) == len(rmetas) == 93
    assert _meta_rows(metas, chip_digest) == _meta_rows(rmetas, rchip_digest)


def test_fixed_matrices_equal(registries):
    name, (rmetas, rtables), (opcode, shard, dyn, tables, _) = registries
    n_pre = len(opcode) + len(shard) + len(dyn)
    for kw in (dict(), dict(jagged=False)):
        layout, mats = scheme.fixed_matrices(tables, n_pre, BasefoldParams(**kw))
        # the reference's, as its keygen stacks them (ceno_tpu/zkvm/scheme.py:160-194)
        by_h = {}
        for ti, t in enumerate(rtables):
            if t.cb.fixed_names:
                h = max(2, 1 << max(0, (t.n_rows - 1).bit_length()))
                fx = np.asarray(t.fixed_fn(), np.uint64)
                by_h.setdefault(h, []).append(np.pad(fx, ((0, 0), (0, h - fx.shape[1]))))
        if kw:
            want = {h: np.concatenate(m, 0) for h, m in by_h.items()}
        else:
            jl = rjagged.plan_layout([(h, sum(m.shape[0] for m in by_h[h])) for h in sorted(by_h)])
            want = {jl.n_r: rjagged.stack_matrix(
                jl, [(h, np.concatenate(by_h[h], 0)) for h in sorted(by_h)])}
        assert sorted(mats) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(mats[k], want[k])
        assert sum(len(v) for v in layout.values()) == sum(len(v) for v in by_h.values())
    if name == "bench":
        (mat,) = scheme.fixed_matrices(tables, n_pre, BasefoldParams())[1].values()
        key = chip_smoke.content_key(mat, BasefoldParams().blowup_log)
        assert key == chip_smoke.FIXED_KEY
        assert os.path.basename(chip_smoke.GOLDEN) == f"commit-{key}.npz"
        assert os.path.exists(chip_smoke.GOLDEN)


@pytest.fixture(scope="module")
def keys():
    cfg = CONFIGS["fast"]
    rpk = rscheme.keygen(rprograms.fibonacci_vm(8).program, RConfig(**cfg), RParams(**FAST_PARAMS))
    pk = scheme.keygen(programs.fibonacci_vm(8).program, ZKVMConfig(**cfg),
                       BasefoldParams(**FAST_PARAMS), device="cpu")
    return rpk, pk


def test_keygen_digest_equal(keys):
    rpk, pk = keys
    np.testing.assert_array_equal(pk.vk.digest_elems(), rpk.vk.digest_elems())
    assert pk.vk.digest_elems().dtype == np.uint64
    assert pk.fixed_layout == rpk.fixed_layout
    assert sorted(pk.vk.fixed_roots) == sorted(rpk.vk.fixed_roots)
    for h in rpk.vk.fixed_roots:
        np.testing.assert_array_equal(pk.vk.fixed_roots[h], np.asarray(rpk.vk.fixed_roots[h]))
    summary = interop.key_summary(pk.vk)
    np.testing.assert_array_equal(summary["digest_elems"], rpk.vk.digest_elems())
    assert summary["chips"] == [(m.name, rchip_digest(m.compiled)) for m in rpk.vk.metas]
    assert all(c.cols.device.type == "cpu" for c in pk.fixed_committed.values())


def test_keygen_is_deterministic(keys):
    _, pk = keys
    again = scheme.keygen(pk.program_words, pk.cfg, pk.params, device="cpu")
    a, b = interop.key_summary(again.vk), interop.key_summary(pk.vk)
    np.testing.assert_array_equal(a["digest_elems"], b["digest_elems"])
    assert a["chips"] == b["chips"]


def test_chip_heights():
    metas = scheme.registry(programs.fibonacci_vm(8).program, ZKVMConfig(**CONFIGS["fast"]))[4]
    rmetas = _ref_registry(rprograms.fibonacci_vm(8).program, RConfig(**CONFIGS["fast"]))[0]
    for m, rm in zip(metas, rmetas):
        for k in (0, 1, 2, 3, 5, 17, 1024):
            assert scheme.chip_height(m, k) == rscheme.chip_height(rm, k), (m.name, k)
    ec = [m for m in metas if m.kind.startswith("ec_tree")]
    assert len(ec) == 2 and all(scheme.chip_height(m, 0) == 4 for m in ec)


def test_septic_arithmetic():
    rng = np.random.default_rng(3)
    a = rng.integers(0, P, size=(16, 7), dtype=np.uint64)
    b = rng.integers(1, P, size=(16, 7), dtype=np.uint64)
    for name in ("add", "sub", "mul"):
        np.testing.assert_array_equal(getattr(septic, name)(a, b), getattr(rseptic, name)(a, b))
    for name in ("neg", "square", "inv"):
        np.testing.assert_array_equal(getattr(septic, name)(b), getattr(rseptic, name)(b))


def test_poseidon2_gadget_and_zero_token_shard_witness():
    rng = np.random.default_rng(4)
    inputs = rng.integers(0, P, size=(5, 16), dtype=np.uint64)
    (gu, gw, gfinal), (wu, ww, wfinal) = (gadget.assign_poseidon2(inputs),
                                          rgadget.assign_poseidon2(inputs))
    assert len(gu) == len(wu) and len(gw) == len(ww)
    for x, y in zip(gu + gw + [gfinal], wu + ww + [wfinal]):
        np.testing.assert_array_equal(x, y)
    for chip, rchip in zip(shard_ram.build_shard_chips(), rshard.build_shard_chips()):
        if chip.kind.startswith("shard_ram"):
            got = shard_ram.assign_shard_ram(chip, shard_ram.Tokens.empty())
            want = rshard.assign_shard_ram(rchip, rshard.Tokens.empty())
            np.testing.assert_array_equal(got, want)
        else:
            (gw, gs), (ww, ws) = (shard_ram.assign_ec_tree(chip, shard_ram.Tokens.empty()),
                                  rshard.assign_ec_tree(rchip, rshard.Tokens.empty()))
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gs, ws)
            assert gw.shape == (21, 4)


def test_ec_tree_with_tokens_names_the_missing_module():
    """Over seeded tokens, ``tokens_to_points``, the shard-RAM witness and
    the EC tree (``gkr/eccquark.build_tree_witness``, both directions) equal
    the reference's."""
    rng = np.random.default_rng(11)
    cols = {"is_reg": rng.integers(0, 2, 5), "addr": rng.integers(0, 1 << 20, 5),
            "value": rng.integers(0, 1 << 32, 5), "shard": rng.integers(0, 3, 5),
            "clk": rng.integers(0, 1 << 24, 5)}
    tok = shard_ram.Tokens(**{k: v.astype(np.uint64) for k, v in cols.items()})
    rtok = rshard.Tokens(**{k: v.astype(np.uint64) for k, v in cols.items()})
    for got, want in zip(shard_ram.tokens_to_points(tok), rshard.tokens_to_points(rtok)):
        np.testing.assert_array_equal(got, want)
    for chip, rchip in zip(shard_ram.build_shard_chips(), rshard.build_shard_chips()):
        if chip.kind.startswith("shard_ram"):
            got = shard_ram.assign_shard_ram(chip, tok)
            np.testing.assert_array_equal(got, rshard.assign_shard_ram(rchip, rtok))
            assert got.shape == (len(chip.cb.wit_names), 8)
        else:
            (gw, gs), (ww, ws) = (shard_ram.assign_ec_tree(chip, tok),
                                  rshard.assign_ec_tree(rchip, rtok))
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gs, ws)
            assert gw.shape == (21, 16) and gs.any()


ROM = 0x0800_0000


@pytest.mark.parametrize("with_data", [False, True])
def test_elf_roundtrip_equal(with_data):
    src = rprograms.FIBONACCI.format(n=10)
    words = assemble(src, ROM)
    assert words == rassemble(src, ROM)
    kw = dict(sheap=0x1000_0000)
    if with_data:
        kw.update(data={0x0900_0000 + 4 * i: v for i, v in enumerate([3, 5, 7, 11])}, bss_words=8)
    blob = elf.write_elf(words, ROM, **kw)
    assert blob == relf.write_elf(words, ROM, **kw)
    got, want = elf.load_elf(blob), relf.load_elf(blob)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.program_words == want.program_words
    assert got.data_image() == want.data_image()
    with pytest.raises(elf.ElfError):
        elf.load_elf(blob[:40])
