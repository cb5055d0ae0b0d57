"""The kernel build (`abip_tpu_torch.ops.build`): its cache key and its
first use from several threads.

A library is rebuilt only when its key changes, so the key must cover
every file a source may include: an edit to a header of `csrc/` has to
change the key of every source, or the card would run a stale library.
Runs on the CPU (hashing needs no `nvcc`), on a copy of `csrc/`; the
threaded first use runs a stand-in for `nvcc` and for `ctypes.CDLL`.
"""
import shutil
import stat
import sys
import threading

import pytest

pytest.importorskip("torch")

from abip_tpu_torch.ops import build  # noqa: E402


@pytest.fixture
def csrc(tmp_path):
    return shutil.copytree(build.CSRC, tmp_path / "csrc")


def test_key_covers_the_source_and_every_header(csrc):
    names = [p.stem for p in sorted(csrc.glob("*.cu"))]
    assert {"admm_delta", "conic_ladder", "conic_delta"} <= set(names)
    before = {name: build.source_key(name, csrc) for name in names}
    assert before == {name: build.source_key(name) for name in names}
    header = csrc / "conic_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.source_key(name, csrc) for name in names}
    assert all(after[name] != before[name] for name in names)
    src = csrc / "conic_delta.cu"
    src.write_text(src.read_text() + "\n")
    assert build.source_key("conic_delta", csrc) != after["conic_delta"]
    assert build.source_key("conic_ladder", csrc) == after["conic_ladder"]


def test_a_new_header_changes_the_key(csrc):
    key = build.source_key("conic_ladder", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.source_key("conic_ladder", csrc) != key


def test_nothing_builds_at_import():
    """Importing the build module and the kernel wrappers neither runs
    nvcc nor loads a library: `load` is only called at first launch."""
    from abip_tpu_torch.ops import admm_sprint, conic_dr, prox

    assert build._load.cache_info().currsize == 0
    assert conic_dr.kernel_lib.cache_info().currsize == 0
    assert admm_sprint._kernel_lib.cache_info().currsize == 0
    assert prox._kernel_lib.cache_info().currsize == 0


def test_package_data_ships_every_kernel_source():
    """An installed package builds its kernels from `csrc/`, so the
    package data must cover every source and every header there."""
    import fnmatch
    import tomllib
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    with open(root / "pyproject.toml", "rb") as f:
        globs = tomllib.load(f)["tool"]["setuptools"]["package-data"][
            "abip_tpu_torch"]
    files = [p.relative_to(build.CSRC.parent).as_posix()
             for p in build.CSRC.iterdir() if p.is_file()]
    assert any(f.endswith(".cuh") for f in files)
    for f in files:
        assert any(fnmatch.fnmatch(f, g) for g in globs), f


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """`nvcc` replaced by a script that counts its calls in `calls` and,
    after a pause that keeps every caller in flight, writes the `-o`
    file; `ctypes.CDLL` by a plain object; the build directory moved to
    `tmp_path`."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "time.sleep(0.3)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('library')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("CDLL", path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    build._load.cache_clear()
    yield calls
    build._load.cache_clear()


def test_first_use_from_eight_threads_builds_once(fake_toolchain):
    """Eight threads that first need one kernel at once: one `nvcc` run,
    one library, the same object for every caller, no temporary file
    left behind."""
    barrier = threading.Barrier(8)
    got, errors = [], []

    def first_use():
        try:
            barrier.wait(timeout=30)
            got.append(build.load("conic_ladder"))
        except Exception as e:  # noqa: BLE001  (reported below)
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert fake_toolchain.read_text() == "x"          # one build
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert got[0].lib[0] == "CDLL" and got[0].build_seconds > 0
    built = sorted(p.name for p in build.BUILD_DIR.iterdir())
    assert built == [f"conic_ladder-{build.source_key('conic_ladder')}.so"]
    assert build.load("conic_ladder") is got[0]


def test_load_all_builds_each_source_once(fake_toolchain):
    """`load_all` runs one build per source side by side; a second call
    builds nothing."""
    names = ["admm_delta", "conic_delta", "bcsr_spmv"]
    libs = build.load_all(names)
    assert fake_toolchain.read_text() == "x" * 3
    assert build.load_all(names) == libs
    assert fake_toolchain.read_text() == "x" * 3
