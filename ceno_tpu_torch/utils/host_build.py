"""Build a C++ source for the host into a shared library, keyed by content.

``c++ -O2 -shared -fPIC -pthread`` (else ``g++``, else ``cc``) into the git-ignored
``ceno_tpu_torch/_build/<stem>-<hash>.so``, the hash over the source and the
flags, so an edited source is rebuilt; the caller loads it with ``ctypes``.
The native emulator core (emulator/native.py) and the Goldilocks PoW grind
(gl/transcript.py) are built this way.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")


def target(src: str, stem: str, build_dir: str = BUILD_DIR) -> str:
    """The library's path for ``src``."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()
    return os.path.join(build_dir, f"{stem}-{digest[:16]}.so")


def build(src: str, stem: str, build_dir: str = BUILD_DIR) -> str:
    """Build ``src`` into ``build_dir`` unless it is built there; returns
    the library's path. Raises RuntimeError when no C++ compiler can build
    it."""
    out = target(src, stem, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    errors = []
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run([cc, *FLAGS, src, "-o", tmp], check=True, capture_output=True, text=True)
        except FileNotFoundError:
            errors.append(f"{cc}: not found")
            continue
        except subprocess.CalledProcessError as e:
            errors.append(f"{cc}: {e.stderr}")
            continue
        os.replace(tmp, out)
        return out
    raise RuntimeError(f"no C++ toolchain built {os.path.basename(src)}: " + "; ".join(errors))
