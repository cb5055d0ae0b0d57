"""The host LP driver, `abip_tpu_torch.solve_lp` / `LPWorkspace`, against
`abip_tpu.solve_lp` on the same numpy-seeded instances, both in f64 on
the CPU (the port with `device="cpu"`; on a CUDA card its BCSR products
launch K5, tested in `tests/test_torch_cuda.py`).

Required per case: equal status and IPM count; equal ADMM count unless
the case says otherwise; pobj and dobj within 1e-6 relative; x, y, s
within 1e-5 of each vector's largest magnitude (at least 1), NaN where
the reference has NaN.  The inner loop is a host loop here and a
`lax.while_loop` there; in f64 the two follow the same trajectory to
~1e-13 except where PCG's inexact solves feed the Barzilai-Borwein
trials (ROADMAP.md queue 3).
"""
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import abip_tpu  # noqa: E402
import abip_tpu_torch  # noqa: E402
from abip_tpu.lp import LPWorkspace as JWorkspace  # noqa: E402
from abip_tpu.settings import Settings as JSettings  # noqa: E402
from abip_tpu.utils.checkpoint import SolverCheckpoint as JCheckpoint  # noqa: E402
from abip_tpu_torch import LPWorkspace, Settings, lp  # noqa: E402
from abip_tpu_torch.utils.checkpoint import SolverCheckpoint  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402
from benchmarks import generate  # noqa: E402

CPU = dict(device="cpu")
OBJ_RTOL = 1e-6
VEC_TOL = 1e-5


def _smoke(seed=3):
    return reference_smoke_lp(m=20, n_rand=180, seed=seed)


def _scattered(m=30, n_rand=300, seed=5):
    """A = [about 3 nonzeros per row, I]: BCSR tiles would be ~1% full,
    so `from_scipy_sparse` packs ELL rows."""
    rng = np.random.default_rng(seed)
    R = sp.random(m, n_rand, density=0.01,
                  random_state=np.random.RandomState(seed), format="lil")
    R[np.arange(m), rng.integers(0, n_rand, m)] = rng.standard_normal(m)
    A = sp.hstack([R, sp.eye(m)]).tocsr()
    n = A.shape[1]
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


def _assert_parity(ref, port, admm_equal=True):
    assert port.status_name == ref.status_name
    assert port.status == ref.status
    assert port.ipm_iters == ref.ipm_iters
    if admm_equal:
        assert port.admm_iters == ref.admm_iters
    for name in ("pobj", "dobj"):
        r, p = getattr(ref, name), getattr(port, name)
        if np.isfinite(r):
            assert abs(p - r) <= OBJ_RTOL * abs(r), (name, p, r)
        else:
            assert p == r
    for name in ("x", "y", "s"):
        r, p = getattr(ref, name), getattr(port, name)
        np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
        ok = ~np.isnan(r)
        if ok.any():
            scale = max(1.0, float(np.abs(r[ok]).max()))
            assert np.abs(p[ok] - r[ok]).max() <= VEC_TOL * scale, name


CASES = {
    # name: (instance, settings, ADMM counts equal)
    "dense": (_smoke, dict(eps=1e-6), True),
    "csr-bcsr": (lambda: (sp.csr_matrix(_smoke()[0]),) + _smoke()[1:],
                 dict(eps=1e-6), True),
    "scattered-ell": (_scattered, dict(eps=1e-6), True),
    # PCG's loose early solves feed the BB trials, whose spectral ratios
    # amplify f64 rounding: the counts drift apart (507 vs 513 here)
    "cg": (lambda: _smoke(4), dict(eps=1e-6, linsys="cg"), False),
    "half-update": (_smoke, dict(eps=1e-6, half_update=True), True),
    "no-adaptive": (_smoke, dict(eps=1e-6, adaptive=False), True),
    "infeasible": (lambda: generate.infeasible_lp(m=10, n=30, seed=1),
                   dict(eps=1e-6), True),
    "unbounded": (lambda: generate.unbounded_lp(m=10, n=30, seed=1),
                  dict(eps=1e-6), True),
    # stopped early: the inaccurate classifications of `_extract_solution`
    "solved-inaccurate": (_smoke, dict(eps=1e-6, max_ipm_iters=4), True),
    "infeasible-inaccurate": (
        lambda: generate.infeasible_lp(m=10, n=30, seed=1),
        dict(eps=1e-6, max_ipm_iters=5), True),
    "unbounded-inaccurate": (
        lambda: generate.unbounded_lp(m=10, n=30, seed=1),
        dict(eps=1e-6, max_ipm_iters=4), True),
}
STATUS = {"dense": "Solved", "csr-bcsr": "Solved", "scattered-ell": "Solved",
          "cg": "Solved", "half-update": "Solved", "no-adaptive": "Solved",
          "infeasible": "Infeasible", "unbounded": "Unbounded",
          "solved-inaccurate": "Solved/Inaccurate",
          "infeasible-inaccurate": "Infeasible/Inaccurate",
          "unbounded-inaccurate": "Unbounded/Inaccurate"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_lp_matches_reference(case):
    make, kw, admm_equal = CASES[case]
    A, b, c = make()
    ref = abip_tpu.solve_lp(A, b, c, **kw)
    port = abip_tpu_torch.solve_lp(A, b, c, **CPU, **kw)
    assert ref.status_name == STATUS[case]
    _assert_parity(ref, port, admm_equal)


@pytest.mark.parametrize("case,layout", [("csr-bcsr", "bcsr"),
                                         ("scattered-ell", "ell")])
def test_sparse_layouts(case, layout):
    A, b, c = CASES[case][0]()
    ws = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU)
    assert ws.A_op.layout == layout and ws.linsys_kind == "dense"
    assert (ws.ops.bcsr is not None) == (layout == "bcsr")
    assert (ws.ops.ell is not None) == (layout == "ell")


def test_warm_start_matches_reference():
    A, b, c = _smoke(6)
    first = abip_tpu_torch.solve_lp(A, b, c, eps=1e-4, **CPU)
    warm = (first.x, first.y, first.s)
    ref = JWorkspace(A, b, c, JSettings(eps=1e-6)).solve(warm=warm)
    port = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU).solve(warm=warm)
    assert ref.status_name == "Solved"
    _assert_parity(ref, port)


def test_checkpoint_and_resume_match_reference(tmp_path):
    """A solve cut at 6 IPM iterations saves a checkpoint every 3; both
    packages save the same state, and both resume from the port's file
    to the same result."""
    A, b, c = _smoke(7)
    cut = dict(eps=1e-6, max_ipm_iters=6)
    jpath, ppath = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    JWorkspace(A, b, c, JSettings(**cut)).solve(checkpoint_path=jpath,
                                                checkpoint_every=3)
    LPWorkspace(A, b, c, Settings(**cut), **CPU).solve(
        checkpoint_path=ppath, checkpoint_every=3)
    jck, pck = JCheckpoint.load(jpath), SolverCheckpoint.load(ppath)
    assert (pck.ipm_iters, pck.admm_iters) == (jck.ipm_iters, jck.admm_iters)
    for name in ("mu", "beta", "sigma", "gamma"):
        assert getattr(pck, name) == pytest.approx(getattr(jck, name),
                                                   rel=1e-9)
    np.testing.assert_allclose(pck.u, jck.u, rtol=1e-9, atol=1e-11)
    ref = JWorkspace(A, b, c, JSettings(eps=1e-6)).solve(
        resume=JCheckpoint.load(ppath))
    port = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU).solve(resume=pck)
    assert ref.status_name == "Solved" and ref.ipm_iters > pck.ipm_iters
    _assert_parity(ref, port)


def test_update_problem_matches_reference():
    """A workspace re-targeted at new b, c with the same A."""
    A, b, c = _smoke(8)
    rng = np.random.default_rng(9)
    b2 = A @ (rng.random(A.shape[1]) + 0.5)
    c2 = A.T @ rng.standard_normal(A.shape[0]) + rng.random(A.shape[1]) + 0.5
    jw = JWorkspace(A, b, c, JSettings(eps=1e-6))
    pw = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU)
    chol = pw.ops.chol
    ref = jw.update_problem(b2, c2).solve()
    port = pw.update_problem(b2, c2).solve()
    assert pw.ops.chol is chol                  # the factor is reused
    assert ref.status_name == "Solved"
    _assert_parity(ref, port)
    np.testing.assert_allclose(pw.g.numpy(), np.asarray(jw.g), rtol=1e-10,
                               atol=1e-12)


def test_dispatch_matches_reference():
    from abip_tpu.cones import ConeSpec as JSpec

    A, b, c = _smoke(10)
    ref = abip_tpu.solve(A, b, c, eps=1e-6)
    port = abip_tpu_torch.solve(A, b, c, **CPU, eps=1e-6)
    _assert_parity(ref, port)
    lp_cone = abip_tpu_torch.ConeSpec.lp(A.shape[1])
    assert JSpec.lp(A.shape[1]).nonneg == lp_cone.nonneg
    again = abip_tpu_torch.solve(A, b, c, cones=lp_cone, **CPU, eps=1e-6)
    assert again.admm_iters == port.admm_iters


def test_unported_entry_points_raise():
    """Every entry point is ported: both `shard`s (held to the reference
    on gloo groups in `tests/test_torch_sharded.py`) raise without a
    `DeviceMesh`, the stand-in for the reference's JAX `Mesh`, rather
    than run unsharded; the conic branch of `dispatch.solve` and
    `solve_general` take their problems (`tests/test_torch_qcp.py`,
    `tests/test_torch_io.py` hold them to the reference)."""
    A, b, c = _smoke()
    ws = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ws.shard(None)
    cw = abip_tpu_torch.ConicWorkspace(
        A, b, c, abip_tpu_torch.ConeSpec.lp(A.shape[1]), **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        cw.shard(None)
    from abip_tpu_torch.dispatch import solve_general

    sol = solve_general(A, c, row_lo=b, row_hi=b, eps=1e-6, **CPU)
    assert sol.status_name == "Solved"
    assert type(abip_tpu_torch.solve(
        A, b, c, cones=abip_tpu_torch.ConeSpec(nonneg=A.shape[1] - 1,
                                               free=1),
        max_ipm_iters=1, **CPU)).__name__ == "ConicSolution"


@pytest.mark.parametrize("bad,match", [
    (dict(alpha=2.5), "alpha"), (dict(linsys="lu"), "linsys"),
    ("nan", "NaN"), ("shape", "b must have shape")])
def test_input_validation(bad, match):
    A, b, c = _smoke()
    kw = {}
    if bad == "nan":
        A = A.copy()
        A[0, 0] = np.nan
    elif bad == "shape":
        b = b[:-1]
    else:
        kw = bad
    with pytest.raises(ValueError, match=match):
        abip_tpu_torch.solve_lp(A, b, c, **CPU, **kw)


def _entry_points():
    from abip_tpu_torch.parallel.batched import solve_lp_suite

    A, b, c = _smoke()
    stacks = (A[None], b[None], c[None])
    cone = abip_tpu_torch.ConeSpec.lp(A.shape[1])
    return {
        "solve_lp": lambda: abip_tpu_torch.solve_lp(A, b, c),
        "LPWorkspace": lambda: LPWorkspace(A, b, c),
        "solve": lambda: abip_tpu_torch.solve(A, b, c),
        "solve_lp_batch": lambda: abip_tpu_torch.solve_lp_batch(*stacks),
        "solve_lp_suite": lambda: solve_lp_suite([(A, b, c)]),
        "solve_qcp_batch": lambda: abip_tpu_torch.solve_qcp_batch(
            *stacks, cones=cone, engine="sprint2"),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_device_needs_a_card(monkeypatch, name):
    """With no device given an entry point runs on the CUDA card; with no
    card visible it says so and does not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_inner_loop_reads_the_device_once_per_iteration(monkeypatch):
    """The inner loop reads its stop test from the device once per
    iteration (qres_period=1) and once as each stage starts."""
    A, b, c = _smoke()
    ws = LPWorkspace(A, b, c, Settings(eps=1e-6), **CPU)
    reads, stages = [], []
    real_read, real_inner = lp._running, lp._run_inner_k

    def inner(*args, **kw):
        stages.append(1)
        return real_inner(*args, **kw)

    monkeypatch.setattr(lp, "_running",
                        lambda *a: reads.append(1) or real_read(*a))
    monkeypatch.setattr(lp, "_run_inner_k", inner)
    sol = ws.solve()
    assert len(reads) == len(stages) + sol.admm_iters


def test_host_lp_modules_and_smoke_leave_jax_out():
    """The host LP driver's modules and `chip_smoke.py` import neither
    JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; sys.path.insert(0, '.'); import abip_tpu_torch, "
            "abip_tpu_torch.lp, abip_tpu_torch.problem, "
            "abip_tpu_torch.ops.spmv, abip_tpu_torch.ops.ell, "
            "abip_tpu_torch.linsys, abip_tpu_torch.adaptive, "
            "abip_tpu_torch.schedules, abip_tpu_torch.dispatch, "
            "abip_tpu_torch.utils.profiling, abip_tpu_torch.utils.checkpoint, "
            "chip_smoke; chip_smoke.host_lp(1, m=8, n_rand=40, density=0.5); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('abip_tpu.') or "
            "m == 'abip_tpu']; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("linsys", ["dense", "cg"])
def test_workspace_projection_matches_reference(linsys):
    """`LPWorkspace.project_lin_sys` (the KKT projection with the rank-1
    tau correction) on the same state: equal PCG counts, u_t within
    1e-12 relative."""
    import jax.numpy as jnp

    A, b, c = _smoke(11)
    jw = JWorkspace(A, b, c, JSettings(eps=1e-6, linsys=linsys))
    pw = LPWorkspace(A, b, c, Settings(eps=1e-6, linsys=linsys), **CPU)
    rng = np.random.default_rng(12)
    u = np.concatenate([rng.standard_normal(pw.m), rng.random(pw.n + 1)])
    v = np.concatenate([np.zeros(pw.m), rng.random(pw.n + 1)])
    for k in (0, 7):
        ref, jits = jw.project_lin_sys(jnp.asarray(u), jnp.asarray(v), k)
        port, its = pw.project_lin_sys(torch.as_tensor(u),
                                       torch.as_tensor(v), k)
        assert its == int(jits)
        np.testing.assert_allclose(port.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("linsys", ["dense", "cg"])
def test_float32_solve(sparse, linsys):
    """dtype="float32" runs the whole driver in f32 (the reference's own
    float32 setting fails inside its `lax.cond`, so the port is held to
    its f64 solve: Solved, objective within 1e-3 relative), and the
    solve leaves the caller's TF32 flag as it found it."""
    A, b, c = _smoke()
    if sparse:
        A = sp.csr_matrix(A)
    kw = dict(eps=1e-4, linsys=linsys, **CPU)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        f32 = abip_tpu_torch.solve_lp(A, b, c, dtype="float32", **kw)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    f64 = abip_tpu_torch.solve_lp(A, b, c, **kw)
    assert f32.status_name == f64.status_name == "Solved"
    assert f32.x.dtype == np.float32
    assert abs(f32.pobj - f64.pobj) <= 1e-3 * abs(f64.pobj)
