"""The kernel build's library key (``kernels/build.py:library_path``): a
hash of the CUDA source, of every ``csrc`` header it includes (directly or
through another header) and of the flags, so an edited header rebuilds
every source that includes it and nothing else; and ``load``, which builds
and loads a library once however many threads ask for it first."""

import threading
import time

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include <cuda.h>\n#include "h.cuh"\n'
                                   'int a;\n')
    (tmp_path / "b.cu").write_text('int b;\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n  #  include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text('int g;\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_sources_follow_includes(csrc):
    names = [p.name for p in build._sources_of("a")]
    assert names == ["a.cu", "h.cuh", "g.cuh"]   # <cuda.h> is not in csrc
    assert [p.name for p in build._sources_of("b")] == ["b.cu"]


@pytest.mark.parametrize("edited,moves", [("h.cuh", True), ("g.cuh", True),
                                          ("a.cu", True), ("b.cu", False)])
def test_an_edited_header_moves_the_key(csrc, edited, moves):
    before = build.library_path("a")
    path = csrc / edited
    path.write_text(path.read_text() + "// edited\n")
    assert (build.library_path("a") != before) is moves
    assert build.library_path("a").name.startswith("a-")


def test_the_port_sources_hash_the_shared_header():
    for name in ("bcr_spmm", "bcr_spmm_skip", "flash_attention"):
        assert "hopper.cuh" in [p.name for p in build._sources_of(name)]
    assert "hopper" not in build.sources()        # a header is not a library


def test_concurrent_first_loads_build_and_load_once(monkeypatch):
    """Two threads (a server's warmup thread and its engine thread) ask for
    one library at once: it is built once, loaded once, declared once, and
    both get the same handle."""
    calls = {"build": 0, "cdll": 0, "declare": 0}
    both_in = threading.Barrier(2)

    def slow_build(names):
        calls["build"] += 1
        time.sleep(0.2)          # a build in progress when the other asks
        return {n: f"/lib/{n}.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            calls["cdll"] += 1
            self.path = path

    def declare(lib):
        calls["declare"] += 1

    monkeypatch.setattr(build, "_LOADED", {})
    monkeypatch.setattr(build, "build_all", slow_build)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    got = []

    def worker():
        both_in.wait()
        got.append(build.load("stub", declare))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert calls == {"build": 1, "cdll": 1, "declare": 1}
    assert len(got) == 2 and got[0] is got[1]
    assert got[0].path == "/lib/stub.so"
