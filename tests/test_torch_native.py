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


def test_first_load_from_many_threads(monkeypatch):
    """Threads that ask for the library while the first caller loads it
    all get it: none reads the load in progress as "no library" (engine
    2's contigs prep on several threads from the first window on, and a
    window that read it so would take the Python read loop)."""
    import threading

    if not native.available():
        import pytest

        pytest.skip("no C++ compiler here")
    for _ in range(5):
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", False)
        start = threading.Barrier(8)
        got = []

        def ask():
            start.wait()
            got.append(native.available())

        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert got == [True] * 8
