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
    assert len(names) >= 69, names
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
