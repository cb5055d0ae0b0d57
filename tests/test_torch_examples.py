"""The port's examples (`abip_tpu_torch/examples/*.py`) against `abip_tpu`.

Each example runs as a subprocess with `--cpu` and with `jax` blocked
from import (the port imports none of it) and must exit 0; the values it
computed are read from its globals and held to the same `abip_tpu` calls
on the same seeds: equal statuses and iteration counts, f64 objectives
within 1e-8 relative, mixed-precision PDHG within 1e-6 relative (f32
products summed in other orders), solutions, gradients and sensitivities
within 1e-6.  The subprocesses start when the first test runs, two at a
time, each on one thread, and the reference calls run meanwhile.
"""
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import abip_tpu  # noqa: E402
from abip_tpu import ConeSpec as JSpec  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "abip_tpu_torch", "examples",
                                         "*.py")))
NAMES = [os.path.basename(p) for p in EXAMPLES]
OBJ_RTOL = 1e-8
MIXED_RTOL = 1e-6
ATOL = 1e-6

# Run one example as __main__ with `--cpu`, then print the values of the
# expressions given (evaluated in its globals) as one JSON line.
WRAPPER = r"""
import json, runpy, sys
import numpy as np
sys.modules["jax"] = None
path, exprs = sys.argv[1], json.loads(sys.argv[2])
sys.argv = [path, "--cpu"]
g = runpy.run_path(path, run_name="__main__")

def plain(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return v if isinstance(v, str) else np.asarray(v).tolist()

print("VALUES " + json.dumps({k: plain(eval(e, g)) for k, e in exprs.items()}))
"""


def _solution(name):
    return {f"{name}.{f}": f"{name}.{f}" for f in (
        "status_name", "ipm_iters", "admm_iters", "pobj")}


# the globals each example's check reads
VALUES = {
    "01_lp.py": _solution("sol"),
    "02_portfolio_socp.py": {**_solution("sol"), "x": "sol.x"},
    "03_lasso_sweep.py": {"objs": "objs", "W": "W", "status": "res.status",
                          "admm": "res.admm_iters"},
    "04_mps.py": _solution("sol"),
    "05_pdhg.py": {**_solution("sol"), **_solution("ref")},
    "06_diff.py": {"y": "y", "grad_b": "grad_b", "J": "J", "b": "b",
                   "g": "g", "val": "val", "cost": "c @ x"},
    "07_cbf_and_conic_pdhg.py": {"status": "sol.status_name",
                                 "admm": "sol.admm_iters", "obj": "obj",
                                 "pd_status": "pd.status_name",
                                 "pd_iters": "pd.admm_iters",
                                 "pd_pobj": "pd.pobj", "star": "pobj_star"},
    "08_parametric_serving.py": {**_solution("prev"), **_solution("s_k")},
}


# two at a time, the two longest (06 and 08, ~40 s each on one CPU
# thread) first: the other test files run beside this one
WORKERS = 2
LONGEST = ("06_diff.py", "08_parametric_serving.py")


def _run(path):
    """One example in its own single-threaded process: (rc, out, err)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    name = os.path.basename(path)
    proc = subprocess.run([sys.executable, "-c", WRAPPER, path,
                           json.dumps(VALUES[name])], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def runs():
    """Every example started when the first test runs, WORKERS at a time,
    each in its own single-threaded process: {name: future}."""
    from concurrent.futures import ThreadPoolExecutor

    order = sorted(EXAMPLES, key=lambda p: os.path.basename(p) not in
                   LONGEST)
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        yield {os.path.basename(p): pool.submit(_run, p) for p in order}


def _values(runs, name):
    rc, out, err = runs[name].result()
    assert rc == 0, (out[-2000:], err[-2000:])
    line = [ln for ln in out.splitlines() if ln.startswith("VALUES ")]
    assert line, out[-2000:]
    return json.loads(line[-1][len("VALUES "):])


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def _same_solution(v, name, ref, rtol=OBJ_RTOL, counts=True):
    assert v[f"{name}.status_name"] == ref.status_name
    if counts:
        assert (v[f"{name}.ipm_iters"], v[f"{name}.admm_iters"]) == (
            ref.ipm_iters, ref.admm_iters)
    assert _rel(v[f"{name}.pobj"], ref.pobj) <= rtol, (v, ref.pobj)


def _random_lp(seed, m, n):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


def check_01(get):
    ref = abip_tpu.solve_lp(*_random_lp(0, 30, 120), eps=1e-6)
    v = get()   # the example's values, after the reference's
    _same_solution(v, "sol", ref)


def check_02(get):
    rng = np.random.default_rng(1)
    k = 8
    F = rng.standard_normal((k, k)) / np.sqrt(k)
    mu_ret = rng.random(k)
    n = 1 + 2 * k
    A = np.zeros((1 + k, n))
    A[0, 1 + k:] = 1.0
    A[1:, 1:1 + k] = -np.eye(k)
    A[1:, 1 + k:] = F
    b = np.zeros(1 + k)
    b[0] = 1.0
    c = np.zeros(n)
    c[0] = 2.0
    c[1 + k:] = -mu_ret
    ref = abip_tpu.solve_qcp(A, b, c, JSpec(soc=(1 + k,), nonneg=k), eps=1e-5)
    v = get()   # the example's values, after the reference's
    _same_solution(v, "sol", ref)
    np.testing.assert_allclose(v["x"], ref.x, rtol=0, atol=ATOL)


def check_03(get):
    from abip_tpu.problems.lasso import solve_lasso_batch

    rng = np.random.default_rng(2)
    m, n, B = 40, 15, 6
    X = rng.standard_normal((m, n))
    w_true = np.zeros(n)
    w_true[:3] = [2.0, -1.0, 0.5]
    y = X @ w_true + 0.05 * rng.standard_normal(m)
    lams = np.geomspace(0.05, 2.0, B)
    W, objs, res = solve_lasso_batch(np.broadcast_to(X, (B, m, n)),
                                     np.broadcast_to(y, (B, m)), lams,
                                     eps=1e-5)
    v = get()   # the example's values, after the reference's
    assert v["status"] == np.asarray(res.status).tolist() == [1] * B
    assert v["admm"] == np.asarray(res.admm_iters).tolist()
    np.testing.assert_allclose(v["objs"], objs, rtol=OBJ_RTOL)
    np.testing.assert_allclose(v["W"], W, rtol=0, atol=ATOL)
    assert ((np.abs(v["W"]) > 1e-4).sum(1) == (np.abs(W) > 1e-4).sum(1)).all()


def check_04(get):
    from abip_tpu.io.presolve import solve_mps

    ref, _ = solve_mps(os.path.join(REPO, "benchmarks", "suites",
                                    "netlib_mini", "blend01.mps"), eps=1e-6)
    v = get()   # the example's values, after the reference's
    _same_solution(v, "sol", ref)


def check_05(get):
    A, b, c = _random_lp(0, 50, 200)
    pd = abip_tpu.solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed")
    ref = abip_tpu.solve_lp(A, b, c, eps=1e-6)
    v = get()   # the example's values, after the reference's
    _same_solution(v, "sol", pd, rtol=MIXED_RTOL)
    _same_solution(v, "ref", ref)


def check_06(get):
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    m, n = 10, 30
    A = rng.standard_normal((m, n))
    b0 = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    A, b0, c = (jnp.asarray(t) for t in (A, b0, c))

    def xstar(b):
        return abip_tpu.solve_lp_grad(A, b, c, eps=1e-9)[0]

    def outer_loss(b):
        return c @ xstar(b) + 5.0 * jnp.sum((b - b0) ** 2)

    x, y, _ = abip_tpu.solve_lp_grad(A, b0, c, eps=1e-9)
    grad_b = jax.grad(lambda b: c @ xstar(b))(b0)
    J = jax.jacobian(xstar)(b0)
    b = b0
    for _ in range(5):
        val, g = jax.value_and_grad(outer_loss)(b)
        b = b - 0.02 * g
    v = get()   # the example's values, after the reference's
    np.testing.assert_allclose(v["y"], y, rtol=0, atol=ATOL)
    np.testing.assert_allclose(v["grad_b"], grad_b, rtol=0, atol=ATOL)
    np.testing.assert_allclose(v["J"], J, rtol=0, atol=ATOL)
    assert _rel(v["cost"], float(c @ x)) <= OBJ_RTOL
    np.testing.assert_allclose(v["g"], g, rtol=0, atol=ATOL)
    np.testing.assert_allclose(v["b"], b, rtol=0, atol=ATOL)
    assert _rel(v["val"], float(val)) <= OBJ_RTOL


def check_07(get, tmp_path):
    from abip_tpu.io.cbf import solve_cbf, write_cbf
    from benchmarks.conic_mini import randcone

    _, A, b, c, cones, star = randcone(
        "demo", 12, JSpec(soc=(6,), rsoc=(4,), nonneg=14), seed=1)
    write_cbf(str(tmp_path / "demo.cbf"), A, b, c, cones,
              comment="example instance")
    sol, _, obj = solve_cbf(str(tmp_path / "demo.cbf"), eps=1e-7)
    pd = abip_tpu.solve_qcp_pdhg(A, b, c, cones, eps=1e-7)
    v = get()   # the example's values, after the reference's
    assert v["star"] == star
    assert (v["status"], v["admm"]) == (sol.status_name, sol.admm_iters)
    assert _rel(v["obj"], obj) <= OBJ_RTOL
    assert (v["pd_status"], v["pd_iters"]) == (pd.status_name, pd.admm_iters)
    assert _rel(v["pd_pobj"], pd.pobj) <= OBJ_RTOL


def check_08(get):
    from abip_tpu.lp import LPWorkspace

    rng = np.random.default_rng(0)
    m, n = 40, 400
    A = np.concatenate(
        [rng.standard_normal((m, n - m)) * (rng.random((m, n - m)) < 0.3),
         np.eye(m)], axis=1)
    b0 = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    w = LPWorkspace(A, b0, c, abip_tpu.Settings(eps=1e-6, adaptive=False))
    prev = w.solve()
    w.update_problem(b0 * 1.001, c)
    w.solve(warm=(prev.x, prev.y, prev.s))
    for k in range(10):
        w.update_problem(b0 * (1.0 + 0.02 * np.sin(0.3 * (k + 1))), c)
        prev = w.solve(warm=(prev.x, prev.y, prev.s))
    s_k = abip_tpu.solve_lp(A, b0 * (1.0 + 0.02 * np.sin(0.3 * 10)), c,
                            eps=1e-6, adaptive=False)
    v = get()   # the example's values, after the reference's
    _same_solution(v, "prev", prev)
    _same_solution(v, "s_k", s_k)


def test_every_example_has_a_check():
    assert NAMES == sorted(VALUES)
    assert NAMES == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(REPO, "examples", "*.py")))


@pytest.mark.parametrize("name", NAMES)
def test_example_matches_reference(name, runs, tmp_path):
    check = globals()[f"check_{name[:2]}"]
    get = lambda: _values(runs, name)  # noqa: E731
    if name.startswith("07"):
        check(get, tmp_path)
    else:
        check(get)
