"""The build tag of the port's CUDA libraries (``ops/_build.py``
``_target``): it must change when a source, a header the sources share
(``csrc/*.cuh``) or the flags change, and only then, or a card would load
a library built from stale code. Needs no ``nvcc``: only the path is
computed."""

import pytest

from kubeflow_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text('#include "common.cuh"\nint k;\n')
    (src / "common.cuh").write_text("#pragma once\nint helper;\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", src / "build")
    return src


def test_tag_is_stable_for_unchanged_sources(csrc):
    first = _build._target("k")
    assert first == _build._target("k")
    assert first.parent == csrc / "build"
    assert first.name.startswith("libk-") and first.suffix == ".so"
    # Rewriting the same bytes, or adding a build product, moves nothing.
    (csrc / "common.cuh").write_text("#pragma once\nint helper;\n")
    (csrc / "build").mkdir()
    (csrc / "build" / "libk-x.so").write_bytes(b"")
    assert _build._target("k") == first


@pytest.mark.parametrize("edit", ["header", "new_header", "source", "flags",
                                  "define"])
def test_tag_changes_with_what_the_build_reads(csrc, monkeypatch, edit):
    before = _build._target("k")
    if edit == "header":
        (csrc / "common.cuh").write_text("#pragma once\nint helper2;\n")
    elif edit == "new_header":
        (csrc / "more.cuh").write_text("#pragma once\n")
    elif edit == "source":
        (csrc / "k.cu").write_text('#include "common.cuh"\nint k2;\n')
    elif edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    else:          # a variant build: its own library, the default unmoved
        assert _build._target("k", ("X=0",)) != _build._target("k", ("X=1",))
        assert _build._target("k", ("X=0",)) != before
        assert _build._target("k") == before
        return
    assert _build._target("k") != before


def test_header_edit_and_revert_give_back_the_first_tag(csrc):
    first = _build._target("k")
    (csrc / "common.cuh").write_text("#pragma once\nint changed;\n")
    assert _build._target("k") != first
    (csrc / "common.cuh").write_text("#pragma once\nint helper;\n")
    assert _build._target("k") == first
