"""The port's native host library is named after what it is built from:
its sources, its Makefile and the host CPU.  A changed source or another
CPU gives a new library path, so a stale or foreign library is never
loaded."""
import shutil

from nextpolish_tpu_torch import native


def test_library_path_follows_sources_and_cpu(tmp_path, monkeypatch):
    base = native.library_path()
    assert any(s.endswith("pileup.cpp") for s in native.SOURCES)
    copies = []
    for src in native.SOURCES:
        dst = tmp_path / src.rsplit("/", 1)[-1]
        shutil.copy(src, dst)
        copies.append(str(dst))
    monkeypatch.setattr(native, "SOURCES", copies)
    assert native.library_path() == base  # same content, same library
    with open(copies[-1], "a") as fh:
        fh.write("\n// edited\n")
    edited = native.library_path()
    assert edited != base
    monkeypatch.setattr(native, "cpu_identity", lambda: "another cpu")
    assert native.library_path() not in (base, edited)


def test_loaded_library_has_the_pileup_walker():
    if not native.available():
        import pytest

        pytest.skip("no C++ compiler here")
    lib = native._load()
    for fn in ("npt_pileup_planes", "npt_pileup_sgs", "npt_cell_index"):
        assert hasattr(lib, fn), fn
