"""`abip_tpu_torch.hsd` against `abip_tpu.hsd` on the same f64 inputs.

Each port function takes a leading lane axis; the reference runs lane by
lane on the same numpy-seeded data.  Tolerance 1e-12 relative: the math
is the same, only the summation order of the reductions differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import hsd as jhsd  # noqa: E402
from abip_tpu_torch import hsd  # noqa: E402

RTOL = ATOL = 1e-12
B, M, N = 3, 5, 9
L = M + N + 1


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(A=rng.standard_normal((B, M, N)),
                b=rng.standard_normal((B, M)), c=rng.standard_normal((B, N)),
                u=rng.random((B, L)) + 0.1, v=rng.random((B, L)) + 0.1,
                u_prev=rng.random((B, L)) + 0.1,
                u_t=rng.standard_normal((B, L)),
                lam=10.0 ** rng.uniform(-8, 0, B),
                pr=rng.random((B, M)) + 0.5, dr=rng.random((B, N)) + 0.5,
                obj=rng.random(B) + 0.5, nm_b=rng.random(B) + 1.0,
                nm_c=rng.random(B) + 1.0)


def _mv_pair(A):
    At = _t(A)
    return (lambda x: torch.einsum("bmn,bn->bm", At, x),
            lambda y: torch.einsum("bmn,bm->bn", At, y))


def test_safediv_pos():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 7))
    y = np.where(rng.random((B, 7)) < 0.3, 1e-20, rng.random((B, 7)))
    _close(hsd.safediv_pos(_t(x), _t(y)), jhsd.safediv_pos(x, y))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_barrier_prox(scale):
    d = _data(2)
    t = np.random.default_rng(3).standard_normal((B, N)) * scale
    ref = np.stack([jhsd.barrier_prox(t[i], d["lam"][i]) for i in range(B)])
    _close(hsd.barrier_prox(_t(t), _t(d["lam"])), ref)


def test_admm_update():
    d = _data(4)
    pu, pv = hsd.admm_update(_t(d["u"]), _t(d["v"]), _t(d["u_prev"]),
                             _t(d["u_t"]), _t(d["lam"]), 1.8, M)
    for i in range(B):
        ru, rv = jhsd.admm_update(*(jnp.asarray(d[k][i]) for k in
                                    ("u", "v", "u_prev", "u_t")),
                                  d["lam"][i], 1.8, M)
        _close(pu[i], ru)
        _close(pv[i], rv)


def test_q_norm_resd():
    d = _data(5)
    mv, rmv = _mv_pair(d["A"])
    port = hsd.q_norm_resd(_t(d["u"]), _t(d["v"]), mv, rmv, _t(d["b"]),
                           _t(d["c"]), M, N)
    ref = [jhsd.q_norm_resd(d["u"][i], d["v"][i],
                            lambda x, A=d["A"][i]: A @ x,
                            lambda y, A=d["A"][i]: A.T @ y,
                            d["b"][i], d["c"][i], M, N) for i in range(B)]
    _close(port, np.stack(ref))


def _residuals_both(d):
    mv, rmv = _mv_pair(d["A"])
    port = hsd.lp_residuals(_t(d["u"]), _t(d["v"]), mv, rmv, _t(d["b"]),
                            _t(d["c"]), _t(d["pr"]), _t(d["dr"]),
                            _t(d["obj"]), _t(d["nm_b"]), _t(d["nm_c"]), M, N)
    ref = [jhsd.lp_residuals(d["u"][i], d["v"][i],
                             lambda x, A=d["A"][i]: jnp.asarray(A) @ x,
                             lambda y, A=d["A"][i]: jnp.asarray(A).T @ y,
                             d["b"][i], d["c"][i], d["pr"][i], d["dr"][i],
                             d["obj"][i], d["nm_b"][i], d["nm_c"][i], M, N)
           for i in range(B)]
    return port, ref


@pytest.mark.parametrize("seed", [6, 7, 8])
def test_lp_residuals(seed):
    """Both certificate branches occur across lanes and seeds; a NaN
    certificate must be NaN on both sides."""
    d = _data(seed)
    d["u"][:, :M] *= np.sign(np.random.default_rng(seed).standard_normal(
        (B, 1)))
    port, ref = _residuals_both(d)
    for f, name in enumerate(hsd.LPResiduals._fields):
        _close(port[f], np.stack([np.asarray(r[f]) for r in ref]))


def test_lp_residuals_init():
    r = hsd.LPResiduals.init(B)
    j = jhsd.LPResiduals.init(jnp.float64)
    for f in range(len(r)):
        _close(r[f], np.full(B, np.asarray(j[f])))


def test_lp_converged_code_cases():
    """Solved, unbounded, infeasible and unfinished lanes, with NaN
    certificates comparing False."""
    nan = np.nan
    rows = np.array([
        # res_pri, res_dual, rel_gap, res_infeas, res_unbdd
        [1e-8, 1e-8, 1e-8, nan, nan],     # solved
        [1.0, 1.0, 1.0, nan, 1e-9],       # unbounded
        [1.0, 1.0, 1.0, 1e-9, nan],       # infeasible
        [1.0, 1e-8, 1e-8, nan, nan],      # unfinished
        [nan, nan, nan, nan, nan],        # all NaN: unfinished
        [1e-8, 1.0, 1e-8, nan, nan],      # pfeasopt decides
    ])
    z = np.zeros(len(rows))
    for pfeas in (False, True):
        for total_pos in (False, True):
            port = hsd.lp_converged_code(
                hsd.LPResiduals(*[_t(rows[:, k]) for k in range(5)],
                                *[_t(z)] * 4),
                1e-6, pfeas, torch.full((len(rows),), total_pos))
            ref = [int(jhsd.lp_converged_code(
                jhsd.LPResiduals(*rows[i], 0.0, 0.0, 0.0, 0.0), 1e-6,
                pfeas, total_pos)) for i in range(len(rows))]
            assert port.dtype == torch.int32
            assert port.tolist() == ref


def test_reinit_rebalance():
    d = _data(9)
    pu, pv = hsd.reinit_rebalance(_t(d["u"]), _t(d["v"]), 0.3, M)
    for i in range(B):
        ru, rv = jhsd.reinit_rebalance(jnp.asarray(d["u"][i]),
                                       jnp.asarray(d["v"][i]), 0.3, M)
        _close(pu[i], ru)
        _close(pv[i], rv)


@pytest.mark.parametrize("mu", [0.5, 1e-4, 1e-9])
def test_mu_update_hybrid(mu):
    """Both regimes: aggressive above hybrid_thresh*eps, LOQO below; one
    lane has a nonpositive product to take the LOQO guard branch."""
    d = _data(10)
    d["v"][2, M + 3] = -0.1
    mus = np.array([mu, mu * 3.0, mu / 7.0])
    port = hsd.mu_update_hybrid(_t(mus), _t(d["u"]), _t(d["v"]), M, 1e-6,
                                1000.0, 0.8, 1.1, 0.5)
    ref = [jhsd.mu_update_hybrid(mus[i], jnp.asarray(d["u"][i]),
                                 jnp.asarray(d["v"][i]), M, 1e-6, 1000.0,
                                 0.8, 1.1, 0.5) for i in range(B)]
    _close(port, np.stack(ref))


# -- one instance (the host LP driver's shapes: (l,) iterates, 0-d scalars)


def _one(seed=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, N))
    K = 1e-3 * np.eye(M) + A @ A.T
    h = rng.standard_normal(M + N)
    return A, K, h, rng.random(L) + 0.1, rng.random(L) + 0.1


def _solve_pair(A, K):
    """The same exact KKT solve in each framework: (rho_y I + AA') z_y =
    w_y + A w_x, z_x = A' z_y - w_x."""
    Kinv = np.linalg.inv(K)

    def jsolve(wy, wx, k, warm):
        zy = jnp.asarray(Kinv) @ (wy + jnp.asarray(A) @ wx)
        return zy, jnp.asarray(A).T @ zy - wx, jnp.zeros((), jnp.int32)

    def psolve(wy, wx, k, warm):
        zy = _t(Kinv) @ (wy + _t(A) @ wx)
        return zy, _t(A).T @ zy - wx, 0

    return jsolve, psolve


def test_project_lin_sys_one_instance():
    A, K, h, u, v = _one()
    jsolve, psolve = _solve_pair(A, K)
    g = np.random.default_rng(5).standard_normal(M + N)
    ref, _ = jhsd.project_lin_sys(jnp.asarray(u), jnp.asarray(v),
                                  jnp.asarray(h), jnp.asarray(g), 0.7, 1e-3,
                                  jsolve, 3, M, N)
    port, its = hsd.project_lin_sys(_t(u), _t(v), _t(h), _t(g),
                                    torch.tensor(0.7, dtype=torch.float64),
                                    1e-3, psolve, 3, M, N)
    assert port.shape == (L,) and its == 0
    _close(port, ref)


@pytest.mark.parametrize("lam", [1e-8, 1e-3, 1.0])
def test_admm_update_half_one_instance(lam):
    _, _, _, u, v = _one(6)
    u_t = np.random.default_rng(7).standard_normal(L)
    ref = jhsd.admm_update_half(u, v, u_t, lam, M)
    port = hsd.admm_update_half(_t(u), _t(v), _t(u_t),
                                torch.tensor(lam, dtype=torch.float64), M)
    for p, r in zip(port, ref):
        _close(p, r)


def test_residuals_one_instance():
    """lp_residuals and q_norm_resd on `(l,)` iterates with 0-d scalars
    give the reference's values."""
    A, _, _, u, v = _one(8)
    rng = np.random.default_rng(9)
    b, c = rng.standard_normal(M), rng.standard_normal(N)
    pr, dr = rng.random(M) + 0.5, rng.random(N) + 0.5
    At = _t(A)
    args = (b, c, pr, dr, 1.3, 2.0, 3.0, M, N)
    ref = jhsd.lp_residuals(u, v, lambda x: A @ x, lambda y: A.T @ y, *args)
    port = hsd.lp_residuals(_t(u), _t(v), lambda x: At @ x,
                            lambda y: At.T @ y, *(_t(a) if isinstance(
                                a, np.ndarray) else torch.tensor(
                                a, dtype=torch.float64) for a in args[:7]),
                            M, N)
    for p, r in zip(port, ref):
        assert p.shape == ()
        _close(p, r)
    _close(hsd.q_norm_resd(_t(u), _t(v), lambda x: At @ x,
                           lambda y: At.T @ y, _t(b), _t(c), M, N),
           jhsd.q_norm_resd(u, v, lambda x: A @ x, lambda y: A.T @ y, b, c,
                            M, N))
