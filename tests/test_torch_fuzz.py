"""The port's validators (`abip_tpu_torch.tools`) against the JAX tools.

The JAX side is the reference tool itself (`tools/fuzz_conic.py`,
`tools/fuzz_scipy.py`), its class table cut to the class under test, run
through its `main` on the same instances; the port's side is the same
class through `run_class` on the CPU.  Bars:

* generators: bit-equal to `benchmarks.conic_mini` and
  `benchmarks.generate`, every class at i=0 and 1;
* fuzz_conic sprint2 (batches of 2; free_mixed, zero_mixed, qp_diag):
  equal status, verdict and ADMM count (no lane here sits where an f32
  criterion hovers at its threshold, ROADMAP.md queue 3), obj_err
  within 1e-7;
* fuzz_conic host driver and PDHG (free_mixed, i=0): equal status and
  ADMM count, obj_err within 1e-9;
* fuzz_scipy (i=0 of each class): equal status, ADMM count and verdict,
  kkt within 1e-9;
* `--engine delta`: the reference raises ValueError (the delta engine
  is an endgame), the port exits with a usage error that says so.
"""
import importlib.util
import json
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import ConeSpec as JSpec  # noqa: E402
from abip_tpu_torch.cones import ConeSpec  # noqa: E402
from abip_tpu_torch.tools import fuzz_conic, fuzz_scipy, generate  # noqa: E402
from benchmarks import conic_mini  # noqa: E402
from benchmarks import generate as jgenerate  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _tool(name):
    """The reference tool `tools/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JCONIC = _tool("fuzz_conic")
JSCIPY = _tool("fuzz_scipy")


def _reference_records(tool, argv, tmp_path):
    """Run a reference tool's `main` and read back its records."""
    out = tmp_path / "records.jsonl"
    rc = tool.main(argv + ["-o", str(out)])
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert recs[-1]["mismatches"] == int(rc != 0)
    return recs[:-1]


def _only_class(monkeypatch, cls):
    """Cut the reference fuzz_conic's class tables to `cls`."""
    conic = {k: v for k, v in JCONIC.CLASSES.items() if k == cls}
    qp = {k: v for k, v in JCONIC.QP_CLASSES.items() if k == cls}
    monkeypatch.setattr(JCONIC, "CLASSES", conic)
    monkeypatch.setattr(JCONIC, "QP_CLASSES", qp)


def test_class_tables_equal_reference():
    assert list(fuzz_conic.CLASSES) == list(JCONIC.CLASSES)
    assert list(fuzz_conic.QP_CLASSES) == list(JCONIC.QP_CLASSES)
    for cls, mk in JCONIC.CLASSES.items():
        assert fuzz_conic.CLASSES[cls](JSpec) == mk(JSpec)
    for cls, (mk, q) in JCONIC.QP_CLASSES.items():
        assert fuzz_conic.QP_CLASSES[cls][0](JSpec) == mk(JSpec)
        assert fuzz_conic.QP_CLASSES[cls][1] == q
    assert list(fuzz_scipy.CLASSES) == list(JSCIPY.CLASSES)


@pytest.mark.parametrize("cls", fuzz_conic.class_names())
def test_conic_instances_bit_equal_reference(cls):
    cones, insts = fuzz_conic.instances(cls, 2)
    mk = JCONIC.CLASSES.get(cls) or JCONIC.QP_CLASSES[cls][0]
    jcones = mk(JSpec)
    m = max(6, jcones.dim // 3)
    assert cones == mk(ConeSpec)
    for i, (_, A, b, c, Q, star) in enumerate(insts):
        seed = zlib.crc32(f"conic:{cls}:{i}".encode())
        if cls in JCONIC.QP_CLASSES:
            ref = conic_mini.randqcp(f"{cls}{i}", m, jcones, seed,
                                     q_rank=JCONIC.QP_CLASSES[cls][1])
            np.testing.assert_array_equal(Q, ref[4])
        else:
            ref = conic_mini.randcone(f"{cls}{i}", m, jcones, seed)
            assert Q is None
        for got, want in zip((A, b, c), ref[1:4]):
            np.testing.assert_array_equal(got, want)
        assert star == ref[-1]


@pytest.mark.parametrize("cls", list(fuzz_scipy.CLASSES))
def test_lp_instances_bit_equal_reference(cls):
    for i in range(2):
        rng = np.random.default_rng(zlib.crc32(f"{cls}:{i}".encode()))
        if cls in ("infeasible", "unbounded"):
            ref = getattr(jgenerate, f"{cls}_lp")(
                seed=int(rng.integers(1 << 30)))
        else:
            ref = JSCIPY.CLASSES[cls](rng)
        for got, want in zip(fuzz_scipy.instance(cls, i), ref):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_status_generators_bit_equal_reference(seed):
    for name in ("infeasible_lp", "unbounded_lp"):
        for got, want in zip(getattr(generate, name)(seed=seed),
                             getattr(jgenerate, name)(seed=seed)):
            np.testing.assert_array_equal(got, want)


def _same_records(port, ref, obj_tol):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert (p["class"], p["i"], p["status"], p["ok"], p["admm"]) == (
            r["class"], r["i"], r["status"], r["ok"], r["admm"]), (p, r)
        assert abs(p["obj_err"] - r["obj_err"]) <= obj_tol, (p, r)


@pytest.mark.parametrize("cls", ["free_mixed", "zero_mixed", "qp_diag"])
def test_sprint2_batch_matches_reference(cls, monkeypatch, tmp_path):
    _only_class(monkeypatch, cls)
    ref = _reference_records(JCONIC, ["--batched", "--engine", "sprint2",
                                      "--per-class", "2"], tmp_path)
    port = fuzz_conic.run_class(cls, 2, batched=True, engine="sprint2",
                                device="cpu")
    assert all(r["ok"] for r in port)
    _same_records(port, ref, 1e-7)


@pytest.mark.parametrize("method", ["admm", "pdhg"])
def test_host_and_pdhg_match_reference(method, monkeypatch, tmp_path):
    _only_class(monkeypatch, "free_mixed")
    ref = _reference_records(JCONIC, ["--method", method, "--per-class", "1"],
                             tmp_path)
    port = fuzz_conic.run_class("free_mixed", 1, method=method, device="cpu")
    assert port[0]["ok"]
    _same_records(port, ref, 1e-9)


def test_engine_delta_is_refused_as_an_endgame(monkeypatch, capsys):
    _only_class(monkeypatch, "free_mixed")
    with pytest.raises(ValueError, match="endgame"):
        JCONIC.main(["--batched", "--engine", "delta", "--per-class", "1"])
    with pytest.raises(SystemExit) as exc:
        fuzz_conic.main(["--batched", "--engine", "delta", "--cpu"])
    assert exc.value.code == 2
    assert "endgame" in capsys.readouterr().err
    with pytest.raises(ValueError, match="engine"):
        fuzz_conic.run_class("free_mixed", 1, batched=True, engine="delta",
                             device="cpu")


def test_cone_violation_equals_reference():
    rng = np.random.default_rng(3)
    for cls in fuzz_conic.class_names():
        mk = JCONIC.CLASSES.get(cls) or JCONIC.QP_CLASSES[cls][0]
        cones = mk(JSpec)
        for _ in range(3):
            v = rng.standard_normal(cones.dim)
            for dual in (False, True):
                assert fuzz_conic.cone_violation(v, cones, dual) == \
                    JCONIC.cone_violation(v, cones, dual)


@pytest.fixture(scope="module")
def scipy_reference(tmp_path_factory):
    """The reference fuzz_scipy's records at one instance a class."""
    return _reference_records(JSCIPY, ["--per-class", "1"],
                              tmp_path_factory.mktemp("fuzz_scipy"))


@pytest.mark.parametrize("cls", list(fuzz_scipy.CLASSES))
def test_fuzz_scipy_matches_reference(cls, scipy_reference):
    ref = [r for r in scipy_reference if r["class"] == cls]
    port = fuzz_scipy.run_class(cls, 1, device="cpu")
    assert len(port) == len(ref) == 1 and port[0]["ok"]
    p, r = port[0], ref[0]
    assert (p["status"], p["admm"], p["ok"]) == (r["status"], r["admm"],
                                                 r["ok"])
    assert ("kkt" in p) == ("kkt" in r)
    if "kkt" in r:
        assert abs(p["kkt"] - r["kkt"]) <= 1e-9


def test_main_writes_records_and_summary(tmp_path, capsys):
    """The port's fuzz_scipy `main` on the CPU: one record a line, the
    summary last, exit code 0 when every instance passes."""
    out = tmp_path / "out.jsonl"
    assert fuzz_scipy.main(["--per-class", "1", "--cpu", "-o", str(out)]) == 0
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert lines[-1] == {"total": 6, "mismatches": 0, "per_class": 1,
                         "eps": 1e-6}
    assert [r["class"] for r in lines[:-1]] == list(fuzz_scipy.CLASSES)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines


def test_tools_and_examples_import_no_jax():
    """The tools import with JAX blocked, and neither they nor the
    examples name the JAX package or the benchmarks."""
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "import abip_tpu_torch.tools.fuzz_conic, "
            "abip_tpu_torch.tools.fuzz_scipy, abip_tpu_torch.tools.generate; "
            "bad = [m for m, v in sys.modules.items() if v is not None and "
            "m.split('.')[0] in ('abip_tpu', 'benchmarks', 'jax')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pkg = os.path.join(REPO, "abip_tpu_torch")
    for sub in ("tools", "examples"):
        for name in os.listdir(os.path.join(pkg, sub)):
            if name.endswith(".py"):
                src = open(os.path.join(pkg, sub, name)).read()
                for word in ("import jax", "from jax", "abip_tpu.",
                             "import abip_tpu\n", "benchmarks."):
                    assert word not in src, (sub, name, word)
