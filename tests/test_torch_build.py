"""The kernel build's cache key (`abip_tpu_torch.ops.build.source_key`).

A library is rebuilt only when its key changes, so the key must cover
every file a source may include: an edit to a header of `csrc/` has to
change the key of every source, or the card would run a stale library.
Runs on the CPU (hashing needs no `nvcc`), on a copy of `csrc/`.
"""
import shutil

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

    assert build.load.cache_info().currsize == 0
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
