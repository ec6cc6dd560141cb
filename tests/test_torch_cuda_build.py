"""``utils/cuda_build``: what names a built kernel library.

A library's file name carries a hash of its source, of every csrc header
the source includes (directly or through another header) and of the nvcc
flags, so that an edited header is rebuilt instead of loading a stale
library. Checked on a temporary copy of ``csrc/``; no nvcc is needed.
"""

import os
import shutil

import pytest

from ceno_tpu_torch.utils import cuda_build


@pytest.fixture
def csrc(tmp_path):
    shutil.copytree(cuda_build.CSRC_DIR, tmp_path / "csrc")
    return str(tmp_path / "csrc")


def test_every_source_is_built():
    assert cuda_build.SOURCES == ("poseidon2_merkle", "sumcheck", "gl_commit")
    for name in cuda_build.SOURCES:
        assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, f"{name}.cu"))


@pytest.mark.parametrize("name, headers", [
    ("poseidon2_merkle", ["babybear.cuh", "poseidon2.cuh"]),
    ("sumcheck", ["babybear.cuh", "poseidon2.cuh"]),
    ("gl_commit", ["goldilocks.cuh", "poseidon2_gl.cuh"]),
], ids=["poseidon2_merkle", "sumcheck", "gl_commit"])
def test_includes_are_the_csrc_headers(csrc, name, headers):
    deps = cuda_build._includes(os.path.join(csrc, f"{name}.cu"), csrc)
    assert [os.path.basename(d) for d in deps] == headers


@pytest.mark.parametrize("name, header", [
    ("poseidon2_merkle", "babybear.cuh"), ("poseidon2_merkle", "poseidon2.cuh"),
    ("sumcheck", "babybear.cuh"), ("sumcheck", "poseidon2.cuh"),
    ("gl_commit", "goldilocks.cuh"), ("gl_commit", "poseidon2_gl.cuh"),
])
def test_an_edited_header_changes_the_library(csrc, name, header):
    """An edit of either header renames either library that includes it
    (babybear.cuh is also reached through poseidon2.cuh, goldilocks.cuh
    through poseidon2_gl.cuh); the library stays in the package's build
    directory, and the same files give the same name."""
    before = cuda_build._target(name, csrc)
    assert before == cuda_build._target(name, csrc)
    assert os.path.dirname(before[1]) == cuda_build.BUILD_DIR
    with open(os.path.join(csrc, header), "a") as f:
        f.write("\n// edited\n")
    after = cuda_build._target(name, csrc)
    assert after[0] == before[0] and after[1] != before[1]


def test_an_unrelated_file_does_not_change_the_library(csrc):
    before = cuda_build._target("sumcheck", csrc)
    with open(os.path.join(csrc, "unused.cuh"), "w") as f:
        f.write("// not included\n")
    with open(os.path.join(csrc, "poseidon2_merkle.cu"), "a") as f:
        f.write("\n// edited\n")
    assert cuda_build._target("sumcheck", csrc) == before
