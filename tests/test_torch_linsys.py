"""`abip_tpu_torch.linsys` (PCG, the tolerance schedule, the dense and CG
KKT solvers) against `abip_tpu.linsys` on the same numpy-seeded inputs,
in f64.  PCG's stop test is read from the device once per iteration in
the port and inside a `lax.while_loop` in the reference: the iteration
counts must be equal, the solutions within 1e-10 relative."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.linsys import cg as jcg  # noqa: E402
from abip_tpu.linsys import make_solver as j_make_solver  # noqa: E402
from abip_tpu.problem import LinearOperator as JOp  # noqa: E402
from abip_tpu.settings import Settings as JSettings  # noqa: E402
from abip_tpu_torch.linsys import (CGSolver, DenseNormalSolver,  # noqa: E402
                                   make_solver)
from abip_tpu_torch.linsys import cg  # noqa: E402
from abip_tpu_torch.problem import LinearOperator  # noqa: E402
from abip_tpu_torch.settings import Settings  # noqa: E402

RHO_Y = 1e-3


def _A(m=12, n=30, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n))


@pytest.mark.parametrize("tol,max_iters", [(1e-9, 100), (1e-2, 100),
                                           (1e-12, 3)])
def test_pcg_matches_reference(tol, max_iters):
    A = _A()
    G = RHO_Y * np.eye(12) + A @ A.T
    M = 1.0 / np.diag(G)
    rng = np.random.default_rng(1)
    b, x0 = rng.standard_normal(12), rng.standard_normal(12) * 0.1
    jx, jits = jcg.pcg(lambda y: jnp.asarray(G) @ y, jnp.asarray(M),
                       jnp.asarray(b), jnp.asarray(x0), tol, max_iters)
    Gt = torch.as_tensor(G)
    x, its = cg.pcg(lambda y: Gt @ y, torch.as_tensor(M), torch.as_tensor(b),
                    torch.as_tensor(x0), torch.tensor(tol), max_iters)
    assert its == int(jits)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("k", [-1, 0, 1, 7, 250])
@pytest.mark.parametrize("rhs_norm", [1e-9, 0.3, 40.0])
def test_cg_tolerance_matches_reference(k, rhs_norm):
    ref = float(jcg.cg_tolerance(jnp.asarray(rhs_norm), k, 2.0, jnp.float64))
    port = float(cg.cg_tolerance(torch.tensor(rhs_norm, dtype=torch.float64),
                                 k, 2.0, torch.float64))
    assert port == pytest.approx(ref, rel=1e-15)


def _solvers(linsys):
    A = _A(seed=2)
    js = j_make_solver(JOp.from_dense(jnp.asarray(A)), 12, 30, RHO_Y,
                       JSettings(linsys=linsys))
    ps = make_solver(LinearOperator.from_dense(torch.as_tensor(A)), 12, 30,
                     RHO_Y, Settings(linsys=linsys))
    return js, ps


@pytest.mark.parametrize("linsys,cls", [("dense", DenseNormalSolver),
                                        ("cg", CGSolver),
                                        ("auto", DenseNormalSolver)])
def test_kkt_solvers_match_reference(linsys, cls):
    js, ps = _solvers(linsys)
    assert isinstance(ps, cls) and type(js).__name__ == cls.__name__
    rng = np.random.default_rng(3)
    wy, wx = rng.standard_normal(12), rng.standard_normal(30)
    warm = rng.standard_normal(12) * 0.01
    for k in (-1, 0, 5):
        jy, jx, jits = js.solve(jnp.asarray(wy), jnp.asarray(wx), k,
                                jnp.asarray(warm))
        y, x, its = ps.solve(torch.as_tensor(wy), torch.as_tensor(wx), k,
                             torch.as_tensor(warm))
        assert its == int(jits)
        scale = 1.0 + np.abs(np.asarray(jx)).max()
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-10,
                                   atol=1e-10 * scale)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                                   atol=1e-10 * scale)


def test_dense_solver_solves_the_kkt_system():
    """K z = w with K = [[rho_y I, A], [A', -I]], to 1e-10 relative."""
    _, ps = _solvers("dense")
    A = _A(seed=2)
    rng = np.random.default_rng(4)
    wy, wx = rng.standard_normal(12), rng.standard_normal(30)
    zy, zx, _ = ps.solve(torch.as_tensor(wy), torch.as_tensor(wx))
    zy, zx = zy.numpy(), zx.numpy()
    np.testing.assert_allclose(RHO_Y * zy + A @ zx, wy, atol=1e-10)
    np.testing.assert_allclose(A.T @ zy - zx, wx, atol=1e-10)


def test_lp_make_solver_seam_matches_reference():
    """`abip_tpu_torch.lp.make_solver`, the public seam the reference's
    `abip_tpu.lp` re-exports, builds the same KKT solver (here CG on a
    scipy sparse A) as the reference's seam on the same matrix."""
    import scipy.sparse as sp

    from abip_tpu import lp as jlp
    from abip_tpu_torch import lp

    assert lp.make_solver is make_solver
    A = sp.random(12, 30, density=0.3, random_state=np.random.RandomState(6),
                  format="csr")
    js = jlp.make_solver(JOp.from_scipy_sparse(A), 12, 30, RHO_Y,
                         JSettings(linsys="auto"))
    ps = lp.make_solver(LinearOperator.from_scipy_sparse(A), 12, 30, RHO_Y,
                        Settings(linsys="auto"))
    assert type(ps).__name__ == type(js).__name__ == "CGSolver"
    rng = np.random.default_rng(7)
    wy, wx = rng.standard_normal(12), rng.standard_normal(30)
    jy, jx, jits = js.solve(jnp.asarray(wy), jnp.asarray(wx), 0)
    y, x, its = ps.solve(torch.as_tensor(wy), torch.as_tensor(wx), 0)
    assert its == int(jits)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10,
                               atol=1e-10)
