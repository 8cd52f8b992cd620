"""The CUDA kernels' build bookkeeping (aladin_torch/ops/kernels/build.py),
on the CPU: no nvcc is needed to name a library.

A library is named by a hash of its source, every header under ``csrc/``
and the flags, so editing a header that a source includes never loads a
stale build; every source under ``csrc/`` is built.
"""

import os
import shutil

import pytest

from aladin_torch.ops.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that build.py reads instead of the repository's."""
    path = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, path)
    monkeypatch.setattr(build, "CSRC_DIR", str(path))
    return path


def test_every_source_is_built():
    on_disk = {n for n in os.listdir(build.CSRC_DIR) if n.endswith(".cu")}
    assert set(build.SOURCES) == on_disk
    assert "layernorm_kernel.cu" in build.SOURCES


@pytest.mark.parametrize("source", build.SOURCES)
def test_library_path_follows_source_and_headers(csrc, source):
    """Stable for unchanged files; new after an edit of the source, of a
    header, or when a header is added; not after another source's edit."""
    first = build.library_path(source)
    assert build.library_path(source) == first
    assert os.path.dirname(first) == build.BUILD_DIR
    assert os.path.basename(first).startswith(os.path.splitext(source)[0] + "-")

    header = csrc / "rowquant.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = build.library_path(source)
    assert after_header != first

    (csrc / "extra.cuh").write_text("#pragma once\n")
    after_new_header = build.library_path(source)
    assert after_new_header != after_header

    other = next(s for s in build.SOURCES if s != source)
    (csrc / other).write_text((csrc / other).read_text() + "\n// edited\n")
    assert build.library_path(source) == after_new_header

    (csrc / source).write_text((csrc / source).read_text() + "\n// edited\n")
    assert build.library_path(source) != after_new_header
