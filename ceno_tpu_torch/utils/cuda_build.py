"""Build the CUDA sources in ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
``sm_90a`` into ``_build/<name>-<hash>.so``, where the hash covers the source
and the flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Builds happen at first use, never at import. :func:`build_all`
starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("poseidon2_merkle",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}
build_logs: dict = {}  # name -> nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every source that is not built yet, one nvcc each, in parallel."""
    started = {n: _start(n) for n in names}
    try:
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(_target(name)[1])
    return lib
