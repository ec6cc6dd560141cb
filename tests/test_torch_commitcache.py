"""Port parity: the content-addressed commitment cache
(``ceno_tpu_torch/pcs/commitcache.py``) against the reference's
``ceno_tpu/pcs/commitcache.py``.

- ``_key`` is the reference's on seeded matrices and blowups;
- a miss writes one file, and a hit writes none and returns the fresh
  commit's cols, codeword, leaves, levels and root, on the device asked for;
- each package loads the other's file and opens it to the same proof bytes
  as a fresh commit. The reference's ``commit_cached`` skips every size up
  to ``HOST_COMMIT_N`` (2^17 under ``tests/conftest.py``), so its side calls
  its ``_save`` / ``_load`` directly;
- a truncated or foreign file is deleted and committed afresh;
- ``keygen`` with ``CENO_TPU_TORCH_COMMIT_CACHE`` set gives the same key as
  without it, and the port never reads the reference's switch;
- chip_smoke's golden fixed commitment is a file the port's cache takes.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ceno_tpu.hash.transcript import Transcript as RTranscript
from ceno_tpu.pcs import basefold as rbf
from ceno_tpu.pcs import commitcache as rcc
from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import programs
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import commitcache as cc
from ceno_tpu_torch.zkvm import scheme
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

import chip_smoke

torch.set_num_threads(1)
P = 2013265921
SMALL = dict(blowup_log=1, n_queries=4, stop_size=32)
LABEL = b"ceno-tpu/zkvm/v8"


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("shape,blowup", [((1, 2), 1), ((6, 32), 1), ((5, 64), 3), ((13, 16), 2)])
def test_key_is_the_references(shape, blowup):
    mat = _rand(sum(shape) + blowup, shape)
    assert cc._key(mat, bf.BasefoldParams(blowup_log=blowup)) == \
        rcc._key(mat, rbf.BasefoldParams(blowup_log=blowup))


def _same_commitment(got, want) -> None:
    d, w = interop.committed_to_numpy(got), interop.committed_to_numpy(want)
    for k in ("cols", "codeword", "leaves"):
        np.testing.assert_array_equal(d[k], w[k], err_msg=k)
    assert len(d["levels"]) == len(w["levels"]) and d["n_vars"] == w["n_vars"]
    for i, (g, x) in enumerate(zip(d["levels"], w["levels"])):
        np.testing.assert_array_equal(g, x, err_msg=f"level {i}")
    np.testing.assert_array_equal(got.root, want.root)


def test_miss_then_hit(tmp_path):
    mat = _rand(1, (6, 32))
    params = bf.BasefoldParams(**SMALL)
    fresh = bf.commit(mat, params, device="cpu")
    miss = cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    files = sorted(os.listdir(tmp_path))
    assert files == [os.path.basename(cc.cache_path(str(tmp_path), mat, params))]
    stamp = os.stat(tmp_path / files[0]).st_mtime_ns
    hit = cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    assert sorted(os.listdir(tmp_path)) == files
    assert os.stat(tmp_path / files[0]).st_mtime_ns == stamp
    for c in (miss, hit):
        _same_commitment(c, fresh)
        assert c.codeword.device.type == c.tree.leaves.device.type == "cpu"
        assert c.codeword.dtype == torch.int32 and c.root.dtype == np.uint64


def _open_both(port_committed, ref_committed):
    """The port's and the reference's opening of their commitments at two
    seeded points, as dicts of canonical arrays."""
    points = _rand(5, (2, 5, 4))
    claims = [rbf.Claim(0, 0, _rand(6, 4)), rbf.Claim(1, 2, _rand(7, 4))]
    pclaims = [bf.Claim(c.point_idx, c.col_idx, c.value) for c in claims]
    params, pparams = rbf.BasefoldParams(**SMALL), bf.BasefoldParams(**SMALL)
    ref = rbf.open_batch(ref_committed, points, claims, RTranscript(LABEL), params)
    port = bf.open_batch(port_committed, points, pclaims, Transcript(LABEL), pparams)
    return dataclasses.asdict(port), dataclasses.asdict(ref)


def _assert_same(a, b, path="opening"):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a, np.uint64), np.asarray(b, np.uint64),
                                      err_msg=path)


def test_the_reference_reads_the_ports_file(tmp_path):
    mat = _rand(2, (4, 32))
    params = bf.BasefoldParams(**SMALL)
    port = cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    path = cc.cache_path(str(tmp_path), mat, params)
    ref = rcc._load(path, mat, rbf.BasefoldParams(**SMALL))
    np.testing.assert_array_equal(ref.root, port.root)
    got, want = _open_both(port, ref)
    _assert_same(got, want)


def test_the_port_reads_the_references_file(tmp_path):
    mat = _rand(3, (4, 32))
    params = bf.BasefoldParams(**SMALL)
    path = cc.cache_path(str(tmp_path), mat, params)
    rcc._save(path, rbf.commit(mat, rbf.BasefoldParams(**SMALL)))
    stamp = os.stat(path).st_mtime_ns
    hit = cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    assert os.stat(path).st_mtime_ns == stamp and os.listdir(tmp_path) == [os.path.basename(path)]
    _same_commitment(hit, bf.commit(mat, params, device="cpu"))
    got, want = _open_both(hit, rbf.commit(mat, rbf.BasefoldParams(**SMALL)))
    _assert_same(got, want)


@pytest.mark.parametrize("damage", ["truncated", "foreign"])
def test_a_damaged_file_is_replaced(tmp_path, damage):
    mat = _rand(4, (3, 16))
    params = bf.BasefoldParams(**SMALL)
    cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    path = cc.cache_path(str(tmp_path), mat, params)
    if damage == "truncated":
        data = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
    else:  # another matrix's commitment under this name
        other = _rand(5, (2, 16))
        cc.commit_cached(other, params, cache_dir=str(tmp_path), device="cpu")
        os.replace(cc.cache_path(str(tmp_path), other, params), path)
    got = cc.commit_cached(mat, params, cache_dir=str(tmp_path), device="cpu")
    _same_commitment(got, bf.commit(mat, params, device="cpu"))
    _same_commitment(cc._load(path, mat, "cpu"), got)  # the file was written afresh


def test_no_cache_without_the_switch(tmp_path, monkeypatch):
    monkeypatch.delenv(cc.ENV, raising=False)
    monkeypatch.setenv("CENO_TPU_COMMIT_CACHE", str(tmp_path))  # the reference's switch
    mat = _rand(6, (2, 16))
    cc.commit_cached(mat, bf.BasefoldParams(**SMALL), device="cpu")
    assert os.listdir(tmp_path) == []


def test_keygen_with_the_switch_gives_the_same_key(tmp_path, monkeypatch):
    vm = programs.fibonacci_vm(8)
    cfg, params = ZKVMConfig(shl_x_bits=6, mem_words_log=7), bf.BasefoldParams(**SMALL)
    monkeypatch.delenv(cc.ENV, raising=False)
    plain = scheme.keygen(vm.program, cfg, params, device="cpu")
    assert os.listdir(tmp_path) == []
    monkeypatch.setenv(cc.ENV, str(tmp_path))
    keys = [scheme.keygen(vm.program, cfg, params, device="cpu") for _ in range(2)]  # miss, hit
    (mat,) = scheme.fixed_matrices(keys[0].tables, len(keys[0].metas) - len(keys[0].tables),
                                   params)[1].values()
    assert os.listdir(tmp_path) == [os.path.basename(cc.cache_path(str(tmp_path), mat, params))]
    for pk in keys:
        np.testing.assert_array_equal(pk.vk.digest_elems(), plain.vk.digest_elems())
        for h, c in plain.fixed_committed.items():
            _same_commitment(pk.fixed_committed[h], c)


def test_chip_smokes_golden_file_is_a_cache_entry():
    """The golden fixed commitment is named by the content key of the key's
    fixed matrix at phase 5's setup (that matrix is made on the card), and
    holds the npz layout the port's cache reads."""
    name = os.path.basename(chip_smoke.GOLDEN)
    assert name == f"commit-{chip_smoke.FIXED_KEY}.npz"
    with np.load(chip_smoke.GOLDEN) as z:
        assert {"cw", "leaves", "n_vars", "n_levels"} <= set(z.files)
        assert z["cw"].dtype == z["leaves"].dtype == np.uint32
        assert len([f for f in z.files if f.startswith("level")]) == int(z["n_levels"])
