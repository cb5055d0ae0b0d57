"""`abip_tpu_torch.diff` against `abip_tpu.diff`.

Each instance of `tests/test_diff.py` (same numpy seeds) goes through
both packages on the CPU: `torch.autograd` through the port's solution
maps against `jax.grad` through the reference's.  The port's gradients
match the reference's within 1e-6 relative to the gradient's scale (the
largest magnitude; both solve the forward in f64 to the same eps, and
the adjoint system is the same), and pass the reference tests' own
checks (the envelope theorem, central finite differences, the closed
form).  An unsolved instance gets NaN gradients; a degenerate vertex a
finite one; the batched `solve_lp_grad` equals per-instance calls.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import diff as jdiff  # noqa: E402
from abip_tpu.cones import ConeSpec as JSpec  # noqa: E402
from abip_tpu.cones import ConeLayout as JLayout  # noqa: E402
from abip_tpu_torch import diff  # noqa: E402
from abip_tpu_torch.cones import (ConeLayout, ConeSpec,  # noqa: E402
                                  cone_project)

KW = dict(eps=1e-9, max_ipm=200, max_admm=200_000)
QKW = dict(eps=1e-8, max_ipm=300, max_admm=300_000)
DEV = dict(device="cpu")


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float64), requires_grad=True)


def _agree(g, ref, rel=1e-6):
    g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(g - ref).max() <= rel * scale, (
        float(np.abs(g - ref).max()), scale)


def _lp_instance(m=8, n=20, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return A, A @ x0, A.T @ y0 + s0


def _lp_loss_grads(A, b, c, v, wrt):
    """(port gradient, reference gradient) of v'x* w.r.t. `wrt`."""
    args = [_t(A), _t(b), _t(c)]
    x, _, _ = diff.solve_lp_grad(*args, **DEV, **KW)
    (torch.as_tensor(v) @ x).backward()
    k = "Abc".index(wrt)
    jargs = [jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)]

    def loss(z):
        a = list(jargs)
        a[k] = z
        return jnp.asarray(v) @ jdiff.solve_lp_grad(*a, **KW)[0]

    return args[k].grad, jax.grad(loss)(jargs[k])


def test_lp_grad_b_is_dual():
    """Envelope theorem: d(c'x*)/db = y*."""
    A, b, c = _lp_instance()
    g, ref = _lp_loss_grads(A, b, c, c, "b")
    _agree(g, ref)
    _, y, _ = diff.solve_lp_grad(A, b, c, **DEV, **KW)
    np.testing.assert_allclose(g.numpy(), y.numpy(), rtol=1e-5, atol=1e-6)


def test_lp_grad_A_envelope():
    """d(c'x*)/dA = -y x' at a nondegenerate vertex."""
    A, b, c = _lp_instance(seed=3)
    g, ref = _lp_loss_grads(A, b, c, c, "A")
    _agree(g, ref)
    x, y, _ = diff.solve_lp_grad(A, b, c, **DEV, **KW)
    np.testing.assert_allclose(g.numpy(), -np.outer(y.numpy(), x.numpy()),
                               rtol=1e-4, atol=1e-6)


def test_lp_grad_c_vertex_constant():
    A, b, c = _lp_instance(seed=5)
    v = np.random.default_rng(9).standard_normal(c.shape[0])
    g, ref = _lp_loss_grads(A, b, c, v, "c")
    np.testing.assert_allclose(g.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref), atol=1e-9)


def test_lp_grad_b_finite_difference():
    A, b, c = _lp_instance(seed=7)
    v = np.random.default_rng(11).standard_normal(c.shape[0])
    g, ref = _lp_loss_grads(A, b, c, v, "b")
    _agree(g, ref)
    db = np.random.default_rng(13).standard_normal(b.shape[0])
    h = 1e-4

    def loss(bb):
        return float(torch.as_tensor(v) @ diff.solve_lp_grad(
            A, bb, c, **DEV, **KW)[0])

    fd = (loss(b + h * db) - loss(b - h * db)) / (2 * h)
    np.testing.assert_allclose(float(g.numpy() @ db), fd, rtol=2e-2)


def test_lp_grad_batched_equals_per_instance():
    """One batched forward over b (B=2), per-lane backward: each lane's
    gradient equals its own call's (the reference's vmap test) within
    1e-8 relative."""
    A, b, c = _lp_instance(seed=21)
    bs = np.stack([b, 1.01 * b])
    bt = _t(bs)
    x, _, _ = diff.solve_lp_grad(A, bt, c, **DEV, **KW)
    assert x.shape == (2, c.shape[0])
    x.sum().backward()
    for k in range(2):
        bk = _t(bs[k])
        xk, _, _ = diff.solve_lp_grad(A, bk, c, **DEV, **KW)
        xk.sum().backward()
        np.testing.assert_allclose(bt.grad[k].numpy(), bk.grad.numpy(),
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(x[k].detach().numpy(),
                                   xk.detach().numpy(), rtol=0, atol=1e-12)
    gref = jax.vmap(jax.grad(lambda bb: jnp.sum(jdiff.solve_lp_grad(
        jnp.asarray(A), bb, jnp.asarray(c), **KW)[0])))(jnp.asarray(bs))
    _agree(bt.grad, gref)
    # a loss on lane 0 alone: lane 1 gets an exact zero gradient (its
    # adjoint solve, of a zero right-hand side, is skipped)
    b0 = _t(bs)
    x, _, _ = diff.solve_lp_grad(A, b0, c, **DEV, **KW)
    x[0].sum().backward()
    assert torch.equal(b0.grad[0], bt.grad[0])
    assert not b0.grad[1].any()


def test_lp_grad_unsolved_is_nan():
    A = np.array([[1.0, 1.0], [1.0, 1.0]])
    b = _t([1.0, 3.0])   # infeasible
    c = np.array([1.0, 1.0])
    x, _, _ = diff.solve_lp_grad(A, b, c, eps=1e-6, **DEV)
    x.sum().backward()
    assert torch.isnan(b.grad).all()


@pytest.mark.parametrize("lstsq", [True, False])
def test_lp_grad_degenerate(lstsq):
    """Duplicate columns: the minimum-norm adjoint gives a finite
    gradient, equal to the reference's; LU (lstsq=False) matches the
    reference's LU."""
    rng = np.random.default_rng(17)
    m, n = 6, 12
    A = rng.standard_normal((m, n))
    A[:, -1] = A[:, 0]
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    c[-1] = c[0]
    bt = _t(b)
    x, _, _ = diff.solve_lp_grad(A, bt, c, lstsq=lstsq, **DEV, **KW)
    x.sum().backward()
    ref = jax.grad(lambda bb: jnp.sum(jdiff.solve_lp_grad(
        jnp.asarray(A), bb, jnp.asarray(c), lstsq=lstsq, **KW)[0]))(
            jnp.asarray(b))
    if lstsq:
        assert torch.isfinite(bt.grad).all()
        _agree(bt.grad, ref)
    else:
        assert np.array_equal(np.isfinite(bt.grad.numpy()),
                              np.isfinite(np.asarray(ref)))


def _socp_instance(seed=0):
    rng = np.random.default_rng(seed)
    n, m = 7, 3
    A = rng.standard_normal((m, n))
    u = rng.standard_normal(3)
    x0 = np.concatenate([[np.linalg.norm(u) + 1.0], u, rng.random(3) + 0.5])
    ud = rng.standard_normal(3) * 0.3
    s0 = np.concatenate([[np.linalg.norm(ud) + 0.7], ud, rng.random(3) + 0.5])
    y0 = rng.standard_normal(m)
    return A, A @ x0, A.T @ y0 + s0


@pytest.mark.parametrize("seed,what", [(2, "fd"), (4, "dual")])
def test_socp_grad_matches_reference(seed, what):
    A, b, c = _socp_instance(seed)
    v = c if what == "dual" else np.random.default_rng(5).standard_normal(7)
    bt = _t(b)
    x, y, _ = diff.solve_qcp_grad(A, bt, c, cones=ConeSpec(soc=(4,), nonneg=3),
                                  **DEV, **QKW)
    (torch.as_tensor(v) @ x).backward()
    jc = JSpec(soc=(4,), nonneg=3)
    ref = jax.grad(lambda bb: jnp.asarray(v) @ jdiff.solve_qcp_grad(
        jnp.asarray(A), bb, jnp.asarray(c), cones=jc, **QKW)[0])(
            jnp.asarray(b))
    _agree(bt.grad, ref)
    if what == "dual":
        np.testing.assert_allclose(bt.grad.numpy(), y.detach().numpy(),
                                   rtol=1e-4, atol=1e-5)
    else:
        db = np.random.default_rng(8).standard_normal(3)
        h = 1e-4

        def loss(bb):
            return float(torch.as_tensor(v) @ diff.solve_qcp_grad(
                A, bb, c, cones=ConeSpec(soc=(4,), nonneg=3), **DEV,
                **QKW)[0])

        fd = (loss(b + h * db) - loss(b - h * db)) / (2 * h)
        np.testing.assert_allclose(float(bt.grad.numpy() @ db), fd,
                                   rtol=3e-2)


def test_qp_grad_matches_closed_form_and_reference():
    rng = np.random.default_rng(6)
    m, n = 3, 7
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    b = A @ x0
    q = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    c = A.T @ y0 - q * x0
    v = rng.standard_normal(n)
    bt, qt = _t(b), _t(q)
    x, _, _ = diff.solve_qcp_grad(A, bt, c, cones=ConeSpec(nonneg=n),
                                  Q_diag=qt, **DEV, **QKW)
    assert float(x.detach().min()) > 1e-3
    (torch.as_tensor(v) @ x).backward()
    K = np.block([[np.diag(q), -A.T], [A, np.zeros((m, m))]])
    # d(v'x)/db from [[Q, -A'], [A, 0]] [x; y] = [-c; b]
    g_closed = np.linalg.solve(K.T, np.concatenate([v, np.zeros(m)]))[n:]
    np.testing.assert_allclose(bt.grad.numpy(), g_closed, rtol=1e-4,
                               atol=1e-6)
    jc = JSpec(nonneg=n)

    def jloss(bb, qq):
        return jnp.asarray(v) @ jdiff.solve_qcp_grad(
            jnp.asarray(A), bb, jnp.asarray(c), cones=jc, Q_diag=qq,
            **QKW)[0]

    gb, gq = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(b), jnp.asarray(q))
    _agree(bt.grad, gb)
    _agree(qt.grad, gq)


def test_lasso_grad_lambda_matches_reference_and_analytic():
    rng = np.random.default_rng(12)
    m, n = 12, 6
    X = rng.standard_normal((m, n))
    w_true = np.array([1.5, -2.0, 0.0, 0.0, 1.0, 0.0])
    y = X @ w_true + 0.05 * rng.standard_normal(m)
    lam = _t(0.5)
    w = diff.solve_lasso_grad(X, y, lam, **DEV, **QKW)
    S = np.abs(w.detach().numpy()) > 1e-4
    assert S.sum() >= 2
    XS = X[:, S]
    dws = -np.linalg.solve(XS.T @ XS, np.sign(w.detach().numpy()[S]))
    v = rng.standard_normal(n)
    (torch.as_tensor(v) @ w).backward()
    np.testing.assert_allclose(float(lam.grad), float(v[S] @ dws),
                               rtol=1e-3, atol=1e-6)
    ref = jax.grad(lambda ll: jnp.asarray(v) @ jdiff.solve_lasso_grad(
        X, y, ll, **QKW))(jnp.asarray(0.5))
    _agree(lam.grad, ref)


def test_svm_grad_C_matches_reference_and_fd():
    rng = np.random.default_rng(3)
    m, n = 16, 3
    X = rng.standard_normal((m, n)) + 0.8 * np.where(
        np.arange(m)[:, None] < m // 2, 1.0, -1.0)
    y = np.where(np.arange(m) < m // 2, 1.0, -1.0)
    v = rng.standard_normal(n)

    def loss(C):
        w, b0 = diff.solve_svm_grad(X, y, C, **DEV, **QKW)
        return torch.as_tensor(v) @ w + 0.3 * b0

    Ct = _t(0.7)
    loss(Ct).backward()
    h = 1e-4
    fd = (float(loss(0.7 + h)) - float(loss(0.7 - h))) / (2 * h)
    np.testing.assert_allclose(float(Ct.grad), fd, rtol=3e-2, atol=1e-6)

    def jloss(C):
        w, b0 = jdiff.solve_svm_grad(X, y, C, **QKW)
        return jnp.asarray(v) @ w + 0.3 * b0

    _agree(Ct.grad, jax.grad(jloss)(jnp.asarray(0.7)))


def test_dprojection_matches_reference_and_jacobian():
    """`dprojection_dense` equals the reference's, and the Jacobian of
    `cone_project` (torch.autograd) at a generic point."""
    spec = dict(soc=(4,), rsoc=(4,), free=1, nonneg=3)
    lay = ConeLayout(ConeSpec(**spec))
    z = np.random.default_rng(11).standard_normal(lay.n)
    P = diff.dprojection_dense(torch.from_numpy(z), lay).numpy()
    ref = np.asarray(jdiff.dprojection_dense(jnp.asarray(z),
                                             JLayout(JSpec(**spec))))
    np.testing.assert_allclose(P, ref, rtol=0, atol=1e-12)
    J = torch.autograd.functional.jacobian(
        lambda v: cone_project(v, lay), torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(J, P, atol=1e-9)
