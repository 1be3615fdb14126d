"""The kernels' build (``kernels/_build.py``) on the CPU: a library's file
name carries a hash of its source and of every header the source includes
with quotes, so an edited header rebuilds the library instead of loading a
stale one.  Nothing is compiled here."""

from repro_torch.kernels import _build


def _tree(tmp_path, header: str) -> None:
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text(header)


def test_target_follows_included_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    _tree(tmp_path, "int b = 1;\n")
    first = _build._target("k")
    assert _build._target("k") == first  # the same files: the same name
    assert [p.name for p in _build._sources(tmp_path / "k.cu")] == ["k.cu", "a.cuh", "b.cuh"]
    (tmp_path / "b.cuh").write_text("int b = 2;\n")  # a header two includes deep
    second = _build._target("k")
    assert second != first and second.name.startswith("libk_")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k2;\n')
    assert _build._target("k") not in (first, second)


def test_every_source_includes_only_existing_headers():
    """The port's kernel sources: every quoted include is a file beside
    them, and the conv kernel's Hopper header is part of its hash."""
    for name in _build.SOURCES:
        srcs = _build._sources(_build.CSRC / f"{name}.cu")
        assert all(p.exists() for p in srcs)
    assert "hopper.cuh" in [p.name for p in _build._sources(_build.CSRC / "conv2d.cu")]
