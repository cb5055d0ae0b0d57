"""The host conic driver, `abip_tpu_torch.solve_qcp` / `ConicWorkspace`,
and the pieces it runs, against `abip_tpu` on the same numpy-seeded
inputs, both in f64 on the CPU (the port with `device="cpu"`).

Tolerances:
- components (interiorize, checkpoint files, equilibration): equal or
  1e-12 relative; the DR step and the Schur solvers in modes "chol" and
  "newton": 1e-10 relative plus 1e-12 absolute (Cholesky factors from
  two LAPACK-like implementations); mode "inverse_mixed" on its f32
  path: 1e-8 (three refinement steps against the f64 S from f32 applies
  that round differently); CG: equal iteration counts, 1e-6 of each
  vector's scale, and at most twice the reference's distance from the
  exact solve;
- whole solves on dense "chol": equal status, IPM and ADMM counts,
  objectives within 1e-9 relative (to max(1, |obj|)), x, y, s within
  1e-7 of each vector's largest magnitude (at least 1).  The inner loop
  is a host loop here and a `lax.while_loop` there; in f64 the two
  follow the same trajectory up to the factor's rounding.  With a full
  Q the dual objective is held to 1e-8: y = (w_y - A z_x) / rho_y loses
  six digits to cancellation through the primal-form S, and a one-ulp
  perturbation of S alone moves the eq-qp-full-q instance's dobj by
  2.1e-9 relative (ROADMAP.md section 3);
- solves on CG or "inverse_mixed": equal status, ADMM counts within 10%,
  objectives within 1e-6 relative (ROADMAP.md section 3 records the
  drift).
"""
import os
import signal
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import abip_tpu  # noqa: E402
import abip_tpu_torch  # noqa: E402
from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu import conic_ops as jops  # noqa: E402
from abip_tpu import scaling as jscaling  # noqa: E402
from abip_tpu.linsys import schur as jschur  # noqa: E402
from abip_tpu.problem import LinearOperator as JOp  # noqa: E402
from abip_tpu.qcp import ConicWorkspace as JWorkspace  # noqa: E402
from abip_tpu.qcp import conic_defaults as jdefaults  # noqa: E402
from abip_tpu.utils.checkpoint import ConicCheckpoint as JCheckpoint  # noqa: E402
from abip_tpu_torch import cones, conic_ops, scaling  # noqa: E402
from abip_tpu_torch.linsys import schur  # noqa: E402
from abip_tpu_torch.problem import LinearOperator  # noqa: E402
from abip_tpu_torch.qcp import ConicWorkspace, conic_defaults  # noqa: E402
from abip_tpu_torch.utils.checkpoint import ConicCheckpoint  # noqa: E402
from tests.conftest import random_lp  # noqa: E402

CPU = dict(device="cpu")
OBJ_RTOL = 1e-9
FULL_Q_DOBJ = 1e-8
VEC_TOL = 1e-7
LOOSE_OBJ = 1e-6
ADMM_SLACK = 0.10
SPECS = {
    "soc+rsoc+nonneg": dict(soc=(5, 1, 3), rsoc=(4,), nonneg=6),
    "free+zero": dict(free=3, zero=2, nonneg=4),
}


def t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float64))


def _spec(kind, **kw):
    return (jcones.ConeSpec(**kw) if kind == "j" else cones.ConeSpec(**kw))


def _assert_parity(ref, port, exact=True, full_q=False):
    """`exact`: the dense "chol" bar; else the CG / inverse_mixed bar."""
    assert port.status_name == ref.status_name
    assert port.status == ref.status
    if exact:
        assert port.ipm_iters == ref.ipm_iters
        assert port.admm_iters == ref.admm_iters
    else:
        assert abs(port.admm_iters - ref.admm_iters) <= ADMM_SLACK * max(
            ref.admm_iters, 10), (port.admm_iters, ref.admm_iters)
    for name in ("pobj", "dobj"):
        rtol = OBJ_RTOL if exact else LOOSE_OBJ
        if exact and full_q and name == "dobj":
            rtol = FULL_Q_DOBJ
        r, p = getattr(ref, name), getattr(port, name)
        assert abs(p - r) <= rtol * max(1.0, abs(r)), (name, p, r)
    if not exact:
        return
    for name in ("x", "y", "s"):
        r, p = getattr(ref, name), getattr(port, name)
        np.testing.assert_array_equal(np.isnan(p), np.isnan(r))
        ok = ~np.isnan(r)
        if ok.any():
            scale = max(1.0, float(np.abs(r[ok]).max()))
            err = np.abs(p[ok] - r[ok]).max()
            assert err <= VEC_TOL * scale, (name, err, scale)


# --------------------------------------------------------------------- #
# components                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("name", list(SPECS))
def test_interiorize_matches_reference(name, dual):
    spec = SPECS[name]
    x = np.random.default_rng(3).standard_normal(
        cones.ConeSpec(**spec).dim) * 2.0
    port = cones.ConeLayout(cones.ConeSpec(**spec)).interiorize(x, 1e-3,
                                                               dual=dual)
    ref = jcones.ConeLayout(jcones.ConeSpec(**spec)).interiorize(x, 1e-3,
                                                                dual=dual)
    np.testing.assert_array_equal(port, ref)


def test_conic_checkpoint_files_cross_packages(tmp_path):
    rng = np.random.default_rng(4)
    fields = dict(u=rng.standard_normal(9), v=rng.standard_normal(9),
                  mu=0.125, tol_inner=3e-4, admm_iters=77, ipm_iters=5)
    ConicCheckpoint(**fields).save(str(tmp_path / "port"))
    JCheckpoint(**fields).save(str(tmp_path / "ref"))
    for a, b in ((JCheckpoint.load(str(tmp_path / "port")),
                  ConicCheckpoint.load(str(tmp_path / "ref.npz"))),):
        for k, v in fields.items():
            np.testing.assert_array_equal(getattr(a, k), v)
            np.testing.assert_array_equal(getattr(b, k), v)


def _dr_data(seed=5, spec=SPECS["soc+rsoc+nonneg"], m=6):
    rng = np.random.default_rng(seed)
    n = cones.ConeSpec(**spec).dim
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    l = m + n + 1
    u = rng.standard_normal(l)
    v = rng.standard_normal(l)
    u[m:] = np.abs(u[m:]) + 0.5
    rho = np.concatenate([np.full(m, 1e-3), np.ones(n), [1.0]])
    return A, u, v, rho, m, n, spec


@pytest.mark.parametrize("k", [0, 5])
def test_projection_and_barrier_step_match_reference(k):
    """One DR step: the projection (tau quadratic, `k=0` takes tau_t=1)
    then the barrier prox and dual update."""
    A, u, v, rho, m, n, spec = _dr_data()
    Qd = np.random.default_rng(6).random(n) + 0.1
    jd = jschur.DenseSchurSolver(jnp.asarray(A), jnp.asarray(Qd),
                                 jnp.asarray(rho[:m]), jnp.asarray(rho[m:-1]))
    pd = schur.DenseSchurSolver(t(A)[None], t(Qd)[None], t(rho[:m]),
                                t(rho[m:-1]))
    assert pd.form == jd.form == "woodbury"
    jr = jd.solve(jnp.asarray(-np.ones(m)), jnp.asarray(np.ones(n)),
                  iter_count=-1)
    r_vec = np.concatenate([np.asarray(jr[0]), np.asarray(jr[1])])
    a_coef = 1.0 + float(rho[:m + n] * r_vec @ r_vec)
    ju_t, _ = jops.projection(
        jnp.asarray(u), jnp.asarray(v),
        lambda wy, wx, kk, warm: jd.solve(wy, wx, iter_count=kk),
        jnp.asarray(rho), jnp.asarray(r_vec), a_coef,
        lambda x: jnp.asarray(Qd) * x, m, n, k)
    pu_t, its = conic_ops.projection(
        t(u)[None], t(v)[None],
        lambda wy, wx, kk, warm: pd.solve(wy, wx, iter_count=kk),
        t(rho), t(r_vec), a_coef, lambda x: t(Qd) * x, m, n, k)
    assert its == 0
    np.testing.assert_allclose(pu_t[0].numpy(), np.asarray(ju_t),
                               rtol=1e-10, atol=1e-12)
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    co = cones.cone_operands(lay.spec)
    ju, jv = jops.barrier_and_dual(
        jnp.asarray(u), jnp.asarray(v), ju_t, 0.03, jnp.asarray(rho[m:]),
        jcones.ConeLayout(jcones.ConeSpec(**spec)), 1.8, m, n)
    for op in (co, None):
        pu, pv = conic_ops.barrier_and_dual(t(u)[None], t(v)[None],
                                            t(np.asarray(ju_t))[None], 0.03,
                                            t(rho[m:]), lay, 1.8, m, n, op)
        np.testing.assert_allclose(pu[0].numpy(), np.asarray(ju),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(pv[0].numpy(), np.asarray(jv),
                                   rtol=1e-12, atol=1e-14)


def _schur_data(q, m=7, n=19, seed=8):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    if q == "none":
        Q = None
    elif q == "diag":
        Q = rng.random(n) + 0.1
    else:
        G = rng.standard_normal((n, n)) / np.sqrt(n)
        Q = G @ G.T + 0.1 * np.eye(n)
    wy, wx = rng.standard_normal(m), rng.standard_normal(n)
    return A, Q, wy, wx, np.full(m, 1e-3), np.ones(n)


@pytest.mark.parametrize("q", ["none", "diag", "full"])
@pytest.mark.parametrize("form", ["auto", "primal", "woodbury"])
@pytest.mark.parametrize("mode", ["chol", "inverse_mixed", "newton"])
def test_dense_schur_matches_reference(mode, form, q):
    A, Q, wy, wx, ry, rx = _schur_data(q)
    jargs = (jnp.asarray(A), None if Q is None else jnp.asarray(Q),
             jnp.asarray(ry), jnp.asarray(rx))
    pargs = (t(A)[None], None if Q is None else t(Q)[None], t(ry), t(rx))
    refused = form == "woodbury" and (q == "full" or mode == "inverse_mixed")
    if refused:
        with pytest.raises(ValueError):
            jschur.DenseSchurSolver(*jargs, mode=mode, form=form)
        with pytest.raises(ValueError):
            schur.DenseSchurSolver(*pargs, mode=mode, form=form)
        return
    ref = jschur.DenseSchurSolver(*jargs, mode=mode, form=form)
    port = schur.DenseSchurSolver(*pargs, mode=mode, form=form)
    assert port.form == ref.form
    hints = (None, 1.0, 1e3) if mode == "inverse_mixed" else (None,)
    for hint in hints:
        rzy, rzx, _ = ref.solve(jnp.asarray(wy), jnp.asarray(wx),
                                tol_hint=hint)
        zy, zx, its = port.solve(t(wy)[None], t(wx)[None], tol_hint=hint)
        assert its == 0
        tol = 1e-8 if hint == 1e3 else 1e-10
        np.testing.assert_allclose(zy[0].numpy(), np.asarray(rzy), rtol=tol,
                                   atol=tol * 1e-2)
        np.testing.assert_allclose(zx[0].numpy(), np.asarray(rzx), rtol=tol,
                                   atol=tol * 1e-2)


def test_inverse_mixed_apply_is_ieee_f32():
    """The f32 apply of mode "inverse_mixed" holds TF32 off and restores
    the caller's setting."""
    A, Q, wy, wx, ry, rx = _schur_data("none")
    s = schur.DenseSchurSolver(t(A)[None], None, t(ry), t(rx),
                               mode="inverse_mixed")
    seen = []
    orig = schur._mv

    def spy(M, x):
        if M.dtype == torch.float32:
            seen.append(torch.backends.cuda.matmul.allow_tf32)
        return orig(M, x)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        schur._mv = spy
        s.solve(t(wy)[None], t(wx)[None], tol_hint=1e3)
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        schur._mv = orig
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("ladder", [None, "lasso"])
@pytest.mark.parametrize("q", ["none", "full"])
def test_cg_schur_matches_reference(q, ladder):
    A, Q, wy, wx, _, rx = _schur_data(q, m=12, n=30, seed=9)
    # rho_y = 0.1: CG ends well above its rounding floor (at 1e-3 the
    # setup solve's 1e-9 tolerance sits on it, and two summation orders
    # stop one iteration apart)
    ry = np.full(12, 0.1)
    diag_S = rx + (A * A / ry[:, None]).sum(0) + (
        0.0 if Q is None else np.diag(Q))
    ref = jschur.CGSchurSolver(
        JOp.from_dense(jnp.asarray(A)),
        None if Q is None else (lambda x: jnp.asarray(Q) @ x),
        jnp.asarray(ry), jnp.asarray(rx), jnp.asarray(diag_S),
        tol_ladder=None if ladder is None else jschur.LASSO_PCG_LADDER)
    port = schur.CGSchurSolver(
        LinearOperator.from_dense(t(A)),
        None if Q is None else (lambda x: t(Q) @ x), t(ry), t(rx),
        t(diag_S),
        tol_ladder=None if ladder is None else schur.LASSO_PCG_LADDER)
    S = A.T @ (A / ry[:, None]) + np.diag(rx) + (0.0 if Q is None else Q)
    ex_x = np.linalg.solve(S, wx + A.T @ (wy / ry))
    ex_y = (wy - A @ ex_x) / ry
    warm = np.random.default_rng(1).standard_normal(A.shape[1])
    for k, w, hint in ((-1, None, None), (0, None, 50.0), (3, warm, 400.0)):
        rzy, rzx, rits = ref.solve(
            jnp.asarray(wy), jnp.asarray(wx), iter_count=k,
            warm_start=None if w is None else jnp.asarray(w), tol_hint=hint)
        zy, zx, its = port.solve(t(wy), t(wx), iter_count=k,
                                 warm_start=None if w is None else t(w),
                                 tol_hint=hint)
        assert its == int(rits) and its > 0
        # stopped at the same count, the two inexact solves differ by
        # the rounding of their recurrences (up to 1e-7 of the scale at
        # cond(S) ~ 1e4); the port's solve is as accurate as the
        # reference's: at most 2x its distance from the exact solve
        for p, r, e in ((zx, rzx, ex_x), (zy, rzy, ex_y)):
            r, p, sc = np.asarray(r), p.numpy(), np.abs(e).max()
            assert np.abs(p - r).max() <= 1e-6 * sc
            assert np.abs(p - e).max() <= 2.0 * np.abs(r - e).max() + 1e-12 * sc


def test_low_rank_woodbury_and_tol_ladders_match_reference():
    rng = np.random.default_rng(11)
    m, n, k = 14, 9, 3
    A = rng.standard_normal((m, n))
    U = rng.standard_normal((m, k))
    Hu = rng.random(k) + 0.5
    g = rng.random(m) + 0.2
    H_inv = 1.0 / (rng.random(n) + 1.0)
    ry = np.full(m, 1e-2)
    wy, wx = rng.standard_normal(m), rng.standard_normal(n)
    ref = jschur.LowRankWoodburySolver(
        JOp.from_dense(jnp.asarray(A)), jnp.asarray(H_inv), jnp.asarray(ry),
        jnp.asarray(U), jnp.asarray(Hu), jnp.asarray(g))
    port = schur.LowRankWoodburySolver(
        LinearOperator.from_dense(t(A)), t(H_inv), t(ry), t(U), t(Hu), t(g))
    rzy, rzx, _ = ref.solve(jnp.asarray(wy), jnp.asarray(wx))
    zy, zx, its = port.solve(t(wy), t(wx))
    assert its == 0
    np.testing.assert_allclose(zy.numpy(), np.asarray(rzy), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(zx.numpy(), np.asarray(rzx), rtol=1e-10,
                               atol=1e-12)
    for jl, pl in ((jschur.LASSO_PCG_LADDER, schur.LASSO_PCG_LADDER),
                   (jschur.SVM_PCG_LADDER, schur.SVM_PCG_LADDER)):
        for kk, ratio in ((0.0, 5.0), (4.0, 10.0), (9.0, 250.0),
                          (2.0, 3e5), (0.0, 1e-3)):
            r = float(jl(kk, ratio, jnp.asarray(2.5)))
            p = float(pl(kk, ratio, torch.tensor(2.5, dtype=torch.float64)))
            assert p == pytest.approx(r, rel=1e-15)
    with pytest.raises(ValueError):
        schur.pcg_tol_ladder([1.0, 2.0], [1.0])


@pytest.mark.parametrize("spec,m,n,rtol", [
    (SPECS["soc+rsoc+nonneg"], 7, 19, 1e-12),
    (dict(soc=(100, 100), rsoc=(24,), nonneg=800), 256, 1024, 1e-5)])
def test_equilibrate_conic_full_q_matches_reference(spec, m, n, rtol):
    """A full Q `(B, n, n)`; at 2^18 elements the factor loop runs in
    f32 (reductions in another order: 1e-5)."""
    rng = np.random.default_rng(12)
    B = 2
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    G = rng.standard_normal((B, n, n)) / np.sqrt(n)
    Q = G @ np.swapaxes(G, 1, 2)
    b, c = rng.standard_normal((B, m)), rng.standard_normal((B, n))
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    jlay = jcones.ConeLayout(jcones.ConeSpec(**spec))
    out = scaling.equilibrate_conic(t(A), t(Q), t(b), t(c), lay,
                                    conic_defaults())
    for i in range(B):
        ref = jscaling.equilibrate_conic(jnp.asarray(A[i]), jnp.asarray(Q[i]),
                                         jnp.asarray(b[i]), jnp.asarray(c[i]),
                                         jlay, jdefaults())
        for k, name in enumerate(("A", "Q", "b", "c")):
            np.testing.assert_allclose(out[k][i].numpy(), np.asarray(ref[k]),
                                       rtol=rtol, atol=1e-14, err_msg=name)
        for name in ("D", "E", "sc_b", "sc_c"):
            np.testing.assert_allclose(getattr(out[4], name)[i].numpy(),
                                       np.asarray(getattr(ref[4], name)),
                                       rtol=rtol, err_msg=name)


# --------------------------------------------------------------------- #
# whole solves: the instances of tests/test_qcp.py and                  #
# tests/test_qcp_robustness.py                                          #
# --------------------------------------------------------------------- #
def _lp(seed=0, m=15, n=40):
    A, b, c = random_lp(np.random.default_rng(seed), m, n)
    return A, b, c, None, dict(nonneg=n)


def _soc(seed=1):
    a = np.random.default_rng(seed).standard_normal(4)
    A = np.zeros((4, 5))
    A[:, 1:] = np.eye(4)
    c = np.zeros(5)
    c[0] = 1.0
    return A, a, c, None, dict(soc=(5,))


def _rsoc(seed=2):
    a = np.random.default_rng(seed).standard_normal(3)
    A = np.zeros((4, 5))
    A[0, 1] = 1.0
    A[1:, 2:] = np.eye(3)
    c = np.zeros(5)
    c[0] = 1.0
    return A, np.concatenate([[1.0], a]), c, None, dict(rsoc=(5,))


def _box_qp():
    n = 6
    z = np.random.default_rng(3).standard_normal(n)
    return np.ones((1, n)), np.array([1.0]), -z, np.eye(n), dict(nonneg=n)


def _eq_qp(seed=4):
    rng = np.random.default_rng(seed)
    m, n = 8, 20
    G = rng.standard_normal((n, n))
    A = rng.standard_normal((m, n))
    return (A, A @ rng.standard_normal(n), rng.standard_normal(n),
            G @ G.T + np.eye(n), dict(free=n))


def _mixed(seed=5):
    rng = np.random.default_rng(seed)
    k = 6
    F = rng.standard_normal((k, k)) / np.sqrt(k)
    n, m = 2 * k + 1, 1 + k
    A = np.zeros((m, n))
    A[0, :k] = 1.0
    A[1:, :k] = F
    A[1:, k + 1:] = -np.eye(k)
    b = np.zeros(m)
    b[0] = 1.0
    c = np.zeros(n)
    c[:k] = -rng.random(k)
    c[k] = 2.0
    perm = np.concatenate([[k], np.arange(k + 1, n), np.arange(k)])
    return A[:, perm], b, c[perm], None, dict(soc=(1 + k,), nonneg=k)


def _diag_qp(seed=6):
    rng = np.random.default_rng(seed)
    A, b, c, _, spec = _mixed(seed)
    return A, b, c, rng.random(A.shape[1]) + 0.1, spec


INSTANCES = {"lp-as-conic": _lp, "soc": _soc, "rsoc": _rsoc,
             "box-qp": _box_qp, "eq-qp-full-q": _eq_qp, "mixed": _mixed,
             "diag-q": _diag_qp}


def _both(name, eps, **kw):
    A, b, c, Q, spec = INSTANCES[name]()
    ref = abip_tpu.solve_qcp(A, b, c, _spec("j", **spec), Q=Q, eps=eps, **kw)
    port = abip_tpu_torch.solve_qcp(A, b, c, _spec("p", **spec), Q=Q,
                                    eps=eps, **CPU, **kw)
    return ref, port


@pytest.mark.parametrize("name", list(INSTANCES))
def test_solve_qcp_matches_reference(name):
    ref, port = _both(name, 1e-6 if name in ("box-qp", "eq-qp-full-q")
                      else 1e-5)
    assert ref.status_name == "Solved"
    _assert_parity(ref, port, full_q=name in ("box-qp", "eq-qp-full-q"))


@pytest.mark.parametrize("name", ["soc", "eq-qp-full-q"])
def test_solve_qcp_cg_matches_reference(name):
    ref, port = _both(name, 1e-6, linsys="cg")
    _assert_parity(ref, port, exact=False)
    assert port.avg_cg_iters > 0


def test_inverse_mixed_matches_reference():
    """`tests/test_qcp.py::test_inverse_mixed_dense_mode_matches_chol`'s
    instances: an LP cone and a SOC."""
    for name in ("lp-as-conic", "soc"):
        ref, port = _both(name, 1e-6, dense_mode="inverse_mixed")
        assert ref.status_name.startswith("Solved")
        _assert_parity(ref, port, exact=False)


def test_inverse_mixed_warns_where_the_reference_does():
    n = 500
    A = np.eye(n)[:2]
    with pytest.warns(UserWarning, match="inverse_mixed"):
        ConicWorkspace(A, np.ones(2), np.ones(n), cones.ConeSpec(nonneg=n),
                       settings=conic_defaults(dense_mode="inverse_mixed"),
                       **CPU)


def test_matrix_free_operator_matches_reference():
    """A `LinearOperator` A (normalize=False, linsys="cg"), with the
    column norms as the Jacobi preconditioner."""
    A, b, c, _, spec = _soc()
    s = dict(eps=1e-6, normalize=False, linsys="cg")
    jop = JOp.from_dense(jnp.asarray(A))
    jop.col_norms_sq = (A * A).sum(0)
    pop = LinearOperator.from_dense(t(A))
    pop.col_norms_sq = (A * A).sum(0)
    ref = abip_tpu.solve_qcp(jop, b, c, _spec("j", **spec), **s)
    port = abip_tpu_torch.solve_qcp(pop, b, c, _spec("p", **spec), **CPU,
                                    **s)
    _assert_parity(ref, port, exact=False)
    with pytest.raises(ValueError, match="normalize"):
        ConicWorkspace(pop, b, c, cones.ConeSpec(**spec), **CPU)


def test_warm_start_matches_reference():
    A, b, c, _, spec = _lp()
    s = dict(eps=1e-5)
    cold = abip_tpu.solve_qcp(A, b, c, _spec("j", **spec), **s)
    warm = (cold.x, cold.y, cold.s)
    ref = JWorkspace(A, b, c, _spec("j", **spec),
                     settings=jdefaults(**s)).solve(warm=warm)
    port = ConicWorkspace(A, b, c, _spec("p", **spec),
                          settings=conic_defaults(**s), **CPU).solve(
                              warm=warm)
    assert port.admm_iters < cold.admm_iters
    _assert_parity(ref, port)


def test_checkpoint_resume_matches_reference(tmp_path):
    """A 3-stage solve checkpointed by the port, resumed by both packages
    from the same file."""
    A, b, c, _, spec = _lp(seed=7, m=12)
    ck = str(tmp_path / "cstate")
    ConicWorkspace(A, b, c, _spec("p", **spec),
                   settings=conic_defaults(eps=1e-6, max_ipm_iters=3),
                   **CPU).solve(checkpoint_path=ck, checkpoint_every=1)
    state = ConicCheckpoint.load(ck)
    assert state.ipm_iters == 3 and state.admm_iters > 0
    ref = JWorkspace(A, b, c, _spec("j", **spec),
                     settings=jdefaults(eps=1e-6)).solve(
                         resume=JCheckpoint.load(ck))
    port = ConicWorkspace(A, b, c, _spec("p", **spec),
                          settings=conic_defaults(eps=1e-6), **CPU).solve(
                              resume=state)
    assert port.status_name == "Solved"
    _assert_parity(ref, port)


def test_resumed_avg_cg_iters_counts_this_run(tmp_path):
    """On a resumed CG solve the port divides the CG iterations of this
    run by this run's ADMM iterations, k - k0; the reference divides by
    the cumulative k (`abip_tpu/qcp.py:838`), a fault not copied.  Both
    resume from one checkpoint and run the same CG iterations."""
    A, b, c, _, spec = _mixed(seed=13)
    s = dict(eps=1e-6, linsys="cg")
    ck = str(tmp_path / "c")
    JWorkspace(A, b, c, _spec("j", **spec),
               settings=jdefaults(max_ipm_iters=6, **s)).solve(
                   checkpoint_path=ck, checkpoint_every=1)
    state = JCheckpoint.load(ck)
    k0 = state.admm_iters
    ref = JWorkspace(A, b, c, _spec("j", **spec),
                     settings=jdefaults(**s)).solve(resume=state)
    port = ConicWorkspace(A, b, c, _spec("p", **spec),
                          settings=conic_defaults(**s), **CPU).solve(
                              resume=ConicCheckpoint.load(ck))
    _assert_parity(ref, port, exact=False)
    assert port.admm_iters == ref.admm_iters and 0 < k0 < ref.admm_iters
    # the CG sums of the two runs agree to 1% (CG counts drift by one
    # where a late, tight tolerance meets the rounding floor), so the
    # averages stand in the ratio of their divisors, k / (k - k0)
    ratio = ref.admm_iters / (ref.admm_iters - k0)
    assert ratio > 1.2, (k0, ref.admm_iters)
    assert port.avg_cg_iters / ref.avg_cg_iters == pytest.approx(ratio,
                                                                 rel=1e-2)


def test_update_problem_matches_reference():
    A, b, c, _, spec = _lp(seed=9, m=12)
    rng = np.random.default_rng(123)
    b2 = A @ (rng.random(40) + 0.5)
    c2 = A.T @ rng.standard_normal(12) + rng.random(40) + 0.5
    s = dict(eps=1e-5)
    jw = JWorkspace(A, b, c, _spec("j", **spec), settings=jdefaults(**s))
    pw = ConicWorkspace(A, b, c, _spec("p", **spec),
                        settings=conic_defaults(**s), **CPU)
    _assert_parity(jw.solve(), pw.solve())
    _assert_parity(jw.update_problem(b2, c2).solve(),
                   pw.update_problem(b2, c2).solve())


def test_max_time_ends_a_stage():
    """`tests/test_qcp_robustness.py::test_conic_max_time_inside_stage`:
    max_time interrupts a long barrier stage at a sprint boundary, with
    a finite best-effort solution."""
    import time

    A, b, c = random_lp(np.random.default_rng(10), 20, 80)
    s = conic_defaults(eps=1e-18, max_time=1.0, inner_check_period=10,
                       max_ipm_iters=5)
    w = ConicWorkspace(A, b, c, cones.ConeSpec(nonneg=80), settings=s, **CPU)
    t0 = time.perf_counter()
    sol = w.solve()
    assert time.perf_counter() - t0 < 30.0
    assert sol.status_name == "Solved/Inaccurate"
    assert np.isfinite(sol.x).all()


def test_sigint_returns_best_effort():
    A, b, c = random_lp(np.random.default_rng(11), 20, 80)
    w = ConicWorkspace(A, b, c, cones.ConeSpec(nonneg=80),
                       settings=conic_defaults(eps=1e-18,
                                               inner_check_period=10),
                       **CPU)
    threading.Timer(1.0, lambda: os.kill(os.getpid(), signal.SIGINT)).start()
    sol = w.solve()
    assert sol.status == abip_tpu_torch.Status.SIGINT
    assert np.isfinite(sol.x).all()


def test_dispatch_and_device_defaults():
    """`dispatch.solve` takes cones or Q to the conic driver; the entry
    points run on the CUDA card by default and raise without one; `shard`
    raises without a `DeviceMesh`."""
    A, b, c, _, _ = _lp(seed=12, m=10, n=30)
    s_lp = abip_tpu_torch.solve(A, b, c, eps=1e-5, **CPU)
    s_qp = abip_tpu_torch.solve(A, b, c, Q=np.eye(30), eps=1e-5, **CPU)
    assert type(s_lp).__name__ == "LPSolution"
    assert type(s_qp).__name__ == "ConicSolution"
    assert s_qp.status_name.startswith("Solved")
    ref = abip_tpu.solve(A, b, c, Q=np.eye(30), eps=1e-5)
    _assert_parity(ref, s_qp, full_q=True)
    ws = ConicWorkspace(A, b, c, cones.ConeSpec.lp(30), **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        ws.shard(None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            abip_tpu_torch.solve_qcp(A, b, c, cones.ConeSpec(nonneg=30))
        with pytest.raises(RuntimeError, match="CUDA"):
            abip_tpu_torch.solve(A, b, c, Q=np.eye(30))
