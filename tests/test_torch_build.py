"""The kernel library's name covers everything its build reads.

``metis_tpu_torch/ops/build.py`` names a build by a hash of the source, the
headers beside it and the flags, and reuses a library of that name.  These
tests edit a temp copy of ``csrc/`` and read the name only: no ``nvcc`` runs.
"""
import re
import shutil

import pytest

from metis_tpu_torch.ops import build

SOURCE = "flash_attention.cu"


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    return copy


@pytest.mark.parametrize("edited", ["hopper.cuh", SOURCE])
def test_an_edit_renames_the_library(csrc, edited):
    before = build.library_path(SOURCE, csrc)
    assert before == build.library_path(SOURCE)  # same bytes, same name
    path = csrc / edited
    path.write_text(path.read_text() + "\n// edited\n")
    after = build.library_path(SOURCE, csrc)
    assert after != before
    assert after.parent == build.BUILD_DIR and after.name.startswith("libflash_attention_")


def test_every_included_header_is_hashed():
    """Each quoted include of a csrc source is a ``*.cuh`` beside it, the
    files ``library_path`` hashes."""
    included = set()
    for src in build.CSRC.iterdir():
        included.update(re.findall(r'#include "([^"]+)"', src.read_text()))
    assert included, "expected the kernels to include a header"
    for name in included:
        assert name.endswith(".cuh") and (build.CSRC / name).is_file(), name
