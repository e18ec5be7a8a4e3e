"""The port's kernel build: a library is named by what it is built from.

``_build._target`` only hashes files, so this runs without nvcc.
"""

import shutil

import pytest

from dvsg_tpu_torch.ops import _build

SOURCES = ("warp_u8_offsets", "warp_u8_batch", "warp_bilinear")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that _build reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    return copy


def test_library_name_follows_the_shared_header(csrc):
    """Editing warp_u8_tail.cuh renames the libraries of the two sources
    that include it, and no other."""
    before = {n: _build._target(n)[1] for n in SOURCES}
    header = csrc / "warp_u8_tail.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _build._target(n)[1] for n in SOURCES}
    assert edited["warp_u8_offsets"] != before["warp_u8_offsets"]
    assert edited["warp_u8_batch"] != before["warp_u8_batch"]
    assert edited["warp_bilinear"] == before["warp_bilinear"]


def test_library_name_is_by_content_not_by_place(csrc, monkeypatch):
    """The copy names its libraries as the package's sources do; a header
    that no source includes changes no name."""
    copied = {n: _build._target(n)[1] for n in SOURCES}
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    assert {n: _build._target(n)[1] for n in SOURCES} == copied
    monkeypatch.undo()
    assert {n: _build._target(n)[1] for n in SOURCES} == copied
