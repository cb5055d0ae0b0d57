"""No file of the benchmark imports JAX or the JAX package (top-level
names compared whole: `abip_tpu_torch` is not `abip_tpu`), nor the
repository's older benchmark; the reference imports nothing of the
program; a run refuses to go on without the program."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness

BANNED = {"jax", "jaxlib", "flax", "abip_tpu", "bench", "benchmarks",
          "chip_smoke"}
FILES = sorted(harness.HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax_and_no_old_benchmark(path):
    assert not top_level_imports(path) & BANNED


def test_reference_imports_nothing_of_the_program():
    assert top_level_imports(harness.HERE / "reference.py") <= {
        "__future__", "math", "typing", "torch"}


def test_forbidden_modules_compares_whole_names():
    code = ("import sys; sys.modules['abip_tpu_torch_x'] = sys; "
            "sys.modules['jaxish'] = sys; from portbench import harness; "
            "print(harness.forbidden_modules()); "
            "sys.modules['jax.numpy'] = sys; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True).stdout
    assert out.split("\n")[:2] == ["[]", "['jax']"]


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from portbench import harness; "
            "print(harness.run('smoke_lp.single', 1, 1, 0, device='cpu'))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and proc.stdout == ""
    assert "No module named 'abip_tpu_torch'" in proc.stderr
