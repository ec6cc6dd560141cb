"""The port stands alone: ceno_tpu_torch and chip_smoke import neither jax
nor ceno_tpu, so they run where JAX is not installed, and the native
emulator core and its AOT preflight build and run from the port's own copy
of its source, as do the guest I/O modules (``ceno_tpu_torch.host``)."""

import os
import pkgutil
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ceno_tpu_torch")


def _modules():
    import ceno_tpu_torch

    names = ["ceno_tpu_torch"]
    for info in pkgutil.walk_packages(ceno_tpu_torch.__path__, "ceno_tpu_torch."):
        names.append(info.name)
    return names


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_every_module_imports_without_jax():
    names = _modules()
    assert len(names) >= 100, names
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"       # any `import jax` raises ImportError
        "sys.modules['ceno_tpu'] = None\n"
        "import importlib\n"
        f"for name in {names + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "from ceno_tpu_torch.emulator import native, programs\n"
        "vm = programs.fibonacci_vm(3)\n"
        "assert native.run_trace_native(vm).n == 29 and vm.regs[10] == 2\n"
        "assert native.run_preflight(programs.fibonacci_vm(3))[2] == 29\n"
        "from ceno_tpu_torch.host import CenoStdin, from_words, read_all_messages, run\n"
        "import chip_smoke\n"
        "words = CenoStdin().write(3).write('ab').to_words()\n"
        "assert from_words(words, ['u32', 'str']) == [3, 'ab']\n"
        "vm = chip_smoke.guest_vm(chip_smoke.PRINTLN_SRC, [])\n"
        "assert run(vm) == read_all_messages(vm) == chip_smoke.PRINTLN_MESSAGES\n"
        "vm = chip_smoke.keccak_loop_vm(2)\n"
        "native.run_trace_native(vm)\n"
        "assert vm.pubio_digest == chip_smoke.keccak_digest([], 2)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'ceno_tpu'))]\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "imported" in r.stdout


def test_no_jax_or_reference_imports_in_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|ceno_tpu\b(?!_torch))", re.M)
    for path in _sources():
        hits = pattern.findall(open(path).read())
        assert not hits, (path, hits)


AGGREGATION_MODULES = [
    "ceno_tpu_torch.utils.replay", "ceno_tpu_torch.gkr.fs_chain", "ceno_tpu_torch.gkr.recursion",
    "ceno_tpu_torch.gkr.pcs_verify", "ceno_tpu_torch.gkr.claim_link",
    "ceno_tpu_torch.gkr.ec_verify", "ceno_tpu_torch.zkvm.aggregate",
    "ceno_tpu_torch.zkvm.skeleton",
]


def test_aggregation_modules_stand_alone():
    """The aggregation slice's modules are the port's own: found among its
    modules, imported and driven (a recording transcript, the replay waiver,
    the chain cap, the proof format) with jax and ceno_tpu blocked."""
    assert set(AGGREGATION_MODULES) <= set(_modules())
    for name in AGGREGATION_MODULES:
        path = os.path.join(ROOT, *name.split(".")) + ".py"
        assert path in _sources(), path
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceno_tpu'] = None\n"
        "import threading\n"
        "import numpy as np\n"
        "from ceno_tpu_torch.gkr import fs_chain as FS\n"
        "from ceno_tpu_torch.hash.transcript import Transcript\n"
        "from ceno_tpu_torch.utils import replay\n"
        "from ceno_tpu_torch.zkvm import aggregate, serialize\n"
        "t, live = FS.ChainTranscript(b'x'), Transcript(b'x')\n"
        "for tr in (t, live):\n"
        "    tr.append(np.arange(11, dtype=np.uint64))\n"
        "assert t.sample_ext() == live.sample_ext() and len(t.rows) == 3\n"
        "with replay.structure_replay():\n"
        "    seen = []\n"
        "    th = threading.Thread(target=lambda: seen.append(replay.structure_only()))\n"
        "    th.start(); th.join()\n"
        "    assert replay.structure_only() and seen == [False]\n"
        "try:\n"
        "    aggregate.build_aggregation_witness_multi(None, [(None, {})] * 60, fs=True)\n"
        "except aggregate.AggError:\n"
        "    pass\n"
        "else:\n"
        "    raise SystemExit('chain cap not enforced')\n"
        "assert {'AggProof', 'ShardGeometry'} <= set(serialize._whitelist())\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'ceno_tpu'))]\n"
        "assert not bad, bad\n"
        "print('aggregation ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "aggregation ok" in r.stdout


GOLDILOCKS_MODULES = [
    "ceno_tpu_torch.fields.gl_host", "ceno_tpu_torch.fields.gl2_host",
    "ceno_tpu_torch.fields.goldilocks", "ceno_tpu_torch.fields.goldilocks_ext2",
    "ceno_tpu_torch.gl", "ceno_tpu_torch.gl.poseidon2", "ceno_tpu_torch.gl.transcript",
    "ceno_tpu_torch.gl.sumcheck", "ceno_tpu_torch.gl.device", "ceno_tpu_torch.gl.pcs",
    "ceno_tpu_torch.gl.zkvm",
]


def test_goldilocks_modules_stand_alone():
    """The Goldilocks slice's 11 modules are the port's own: found among its
    modules and driven (a commit, an opening and its verification on CPU
    tensors) with jax and ceno_tpu blocked."""
    assert set(GOLDILOCKS_MODULES) <= set(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceno_tpu'] = None\n"
        "import numpy as np\n"
        "from ceno_tpu_torch.fields import gl2_host as g2\n"
        "from ceno_tpu_torch.gl import pcs, sumcheck\n"
        "from ceno_tpu_torch.gl.transcript import GlTranscript\n"
        "rng = np.random.default_rng(1)\n"
        "cols = rng.integers(0, 2**63, size=(3, 16), dtype=np.uint64)\n"
        "z = rng.integers(0, 2**63, size=(4, 2), dtype=np.uint64)\n"
        "vals = []\n"
        "for c in cols:\n"
        "    cur = g2.from_base(c)\n"
        "    for t in range(4):\n"
        "        cur = sumcheck._fold_top(cur, z[t])\n"
        "    vals.append(cur[0])\n"
        "prm = pcs.GlParams(blowup_log=1, n_queries=3, pow_bits=2, stop_size=4)\n"
        "com = pcs.commit(cols, prm, device='cpu')\n"
        "tp, tv = GlTranscript(b'x'), GlTranscript(b'x')\n"
        "op = pcs.open_batch(com, z, np.stack(vals), tp, prm)\n"
        "pcs.verify_batch(com.root, 4, 3, z, np.stack(vals), op, tv, prm)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'ceno_tpu'))]\n"
        "assert not bad, bad\n"
        "print('goldilocks ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "goldilocks ok" in r.stdout


GL_SCHEME_MODULES = [
    "ceno_tpu_torch.fields.gl5_host", "ceno_tpu_torch.gl.gadget",
    "ceno_tpu_torch.gl.shard_chips", "ceno_tpu_torch.gl.eccquark",
    "ceno_tpu_torch.gl.scheme", "ceno_tpu_torch.gl.shard",
]


def test_goldilocks_scheme_modules_stand_alone():
    """The Goldilocks scheme slice's 6 modules are the port's own: found
    among its modules and driven (hash-to-curve and both shard chips'
    witnesses for three tokens, the quark proved on CPU tensors and
    verified) with jax and ceno_tpu blocked."""
    assert set(GL_SCHEME_MODULES) <= set(_modules())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceno_tpu'] = None\n"
        "import numpy as np\n"
        "from ceno_tpu_torch.fields import gl5_host as G5\n"
        "from ceno_tpu_torch.gl import eccquark as Q, scheme, shard, shard_chips as sc\n"
        "from ceno_tpu_torch.gl.transcript import GlTranscript\n"
        "from ceno_tpu_torch.zkvm.chips.shard_ram import Tokens\n"
        "u = lambda *v: np.array(v, np.uint64)\n"
        "tok = Tokens(u(1, 0, 1), u(5, 64, 7), u(9, 2**32 - 1, 3), u(1, 1, 1), u(4, 5, 6))\n"
        "_, xs, ys = sc.tokens_to_points_gl(tok)\n"
        "assert G5.is_on_curve(xs, ys).all()\n"
        "chips = sc.build_gl_shard_chips()\n"
        "assert sc.assign_shard_ram_gl(chips[0], tok).shape[1] == 4\n"
        "wit, fsum = sc.assign_ec_tree_gl(chips[2], tok)\n"
        "assert np.array_equal(fsum, shard._gl_sum(tok, False))\n"
        "proof, rt = Q.prove_ec_sum(wit[0:5], wit[5:10], wit[10:15], 3, fsum, GlTranscript(b'x'),\n"
        "                           device='cpu')\n"
        "rt_v, _ = Q.verify_ec_sum(proof, fsum, GlTranscript(b'x'))\n"
        "assert np.array_equal(rt, rt_v) and scheme.LABEL_GL == b'ceno-gl/zkvm/v2'\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m.split('.')[0] in ('jax', 'jaxlib', 'ceno_tpu'))]\n"
        "assert not bad, bad\n"
        "print('goldilocks scheme ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "goldilocks scheme ok" in r.stdout
