"""`abip_tpu_torch.pdhg` and `cones.cone_project` against `abip_tpu`.

The instances of `tests/test_pdhg.py` and `tests/test_cone_project.py`
(same numpy seeds) go through both packages on the CPU.  Tolerances:

* `cone_project` / `cone_membership_violation`: every cone kind, with
  and without `dual`, within 1e-12 (f64; the block sums add in another
  order); plus the reference tests' properties (membership,
  idempotence, Moreau decomposition, best approximation, the SOC
  branches).
* PDHG in f64: equal status and iteration count, objectives within
  1e-9 relative; mixed precision: equal status, objectives within 1e-6
  relative (f32 delta products summed in other orders; the single-LP
  mixed solve's iteration count comes out equal and is held equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu import pdhg as jpdhg  # noqa: E402
from abip_tpu_torch import cones, pdhg  # noqa: E402
from abip_tpu_torch.cones import ConeLayout, ConeSpec  # noqa: E402

DEV = dict(device="cpu")
SPECS = [
    dict(nonneg=12),
    dict(soc=(5,), nonneg=4),
    dict(soc=(4, 3, 1), rsoc=(5, 3), free=2, zero=3, nonneg=6),
    dict(rsoc=(7,), free=1),
    dict(soc=(2, 2), zero=2),
]


def _layouts(spec):
    return (ConeLayout(ConeSpec(**spec)),
            jcones.ConeLayout(jcones.ConeSpec(**spec)))


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("spec", SPECS)
def test_cone_project_matches_reference(spec, dual):
    lay, jlay = _layouts(spec)
    rng = np.random.default_rng(0)
    Z = 3.0 * rng.standard_normal((4, lay.n))
    Z[0, :] = 0.0                                 # the nu = 0 guard
    out = cones.cone_project(torch.from_numpy(Z), lay, dual=dual).numpy()
    for z, p in zip(Z, out):
        ref = np.asarray(jcones.cone_project(jnp.asarray(z), jlay, dual=dual))
        np.testing.assert_allclose(p, ref, rtol=0, atol=1e-12)
    one = cones.cone_project(torch.from_numpy(Z[1]), lay, dual=dual)
    assert one.shape == (lay.n,)
    np.testing.assert_array_equal(one.numpy(), out[1])


@pytest.mark.parametrize("spec", SPECS)
def test_membership_violation_matches_reference(spec):
    lay, jlay = _layouts(spec)
    rng = np.random.default_rng(1)
    Z = 2.0 * rng.standard_normal((3, lay.n))
    P = cones.cone_project(torch.from_numpy(Z), lay)
    for x in (torch.from_numpy(Z), P):
        out = cones.cone_membership_violation(x, lay).numpy()
        ref = [float(jcones.cone_membership_violation(jnp.asarray(r), jlay))
               for r in x.numpy()]
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("spec", SPECS)
def test_projection_properties(spec):
    """Membership, idempotence, z = Pi_K(z) - Pi_K*(-z) with the parts
    orthogonal, and ||z - Pi(z)|| <= ||z - y|| for sampled y in K
    (`tests/test_cone_project.py`)."""
    lay, _ = _layouts(spec)
    rng = np.random.default_rng(3)
    z = torch.from_numpy(2.0 * rng.standard_normal(lay.n))
    p = cones.cone_project(z, lay)
    assert float(cones.cone_membership_violation(p, lay)) <= 1e-9
    torch.testing.assert_close(cones.cone_project(p, lay), p, rtol=0,
                               atol=1e-12)
    q = cones.cone_project(-z, lay, dual=True)
    torch.testing.assert_close(p - q, z, rtol=0, atol=1e-10)
    assert abs(float(p @ q)) <= 1e-10
    dz = float(torch.linalg.vector_norm(z - p))
    Y = cones.cone_project(torch.from_numpy(
        3.0 * rng.standard_normal((20, lay.n))), lay)
    assert (dz <= torch.linalg.vector_norm(z - Y, dim=-1) + 1e-9).all()


def test_soc_analytic_branches():
    lay = ConeLayout(ConeSpec(soc=(3,)))
    t = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    inside = t([2.0, 1.0, 0.5])
    assert torch.equal(cones.cone_project(inside, lay), inside)
    assert torch.equal(cones.cone_project(t([-3.0, 1.0, 0.5]), lay),
                       torch.zeros(3, dtype=torch.float64))
    torch.testing.assert_close(cones.cone_project(t([0.0, 3.0, 4.0]), lay),
                               t([2.5, 1.5, 2.0]), rtol=0, atol=1e-12)


def random_lp(seed, m, n):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    b = A @ (rng.random(n) + 0.5)
    c = A.T @ rng.standard_normal(m) + rng.random(n) + 0.5
    return A, b, c


def _same(p, r, f64=True):
    """The stated bars on one solution of each package."""
    assert p.status_name == r.status_name
    if f64:
        assert p.admm_iters == r.admm_iters
        tol = 1e-9
    else:
        tol = 1e-6
    if p.status_name == "Solved":
        assert abs(p.pobj - r.pobj) <= tol * max(1.0, abs(r.pobj)), (
            p.pobj, r.pobj)
        assert abs(p.dobj - r.dobj) <= tol * max(1.0, abs(r.dobj))


@pytest.mark.parametrize("seed,m,n", [(3, 30, 90), (0, 50, 200),
                                      (11, 40, 400), (5, 25, 80)])
def test_lp_pdhg_matches_reference(seed, m, n):
    A, b, c = random_lp(seed, m, n)
    eps = 1e-7 if seed == 5 else 1e-6      # test_pdhg_kkt_quality's eps
    r = jpdhg.solve_lp_pdhg(A, b, c, eps=eps)
    p = pdhg.solve_lp_pdhg(A, b, c, eps=eps, **DEV)
    assert p.status_name == "Solved"
    _same(p, r)
    np.testing.assert_allclose(p.x, r.x, rtol=0,
                               atol=1e-7 * np.abs(r.x).max())
    # the reported residuals belong to the returned iterate
    pres = np.linalg.norm(A @ p.x - b) / (1 + np.linalg.norm(b))
    assert pres == pytest.approx(p.res_pri, rel=1e-10)


def test_lp_pdhg_mixed_matches_reference():
    A, b, c = random_lp(0, 50, 200)
    r = jpdhg.solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed")
    p = pdhg.solve_lp_pdhg(A, b, c, eps=1e-6, precision="mixed", **DEV)
    _same(p, r, f64=False)
    assert p.admm_iters == r.admm_iters
    p64 = pdhg.solve_lp_pdhg(A, b, c, eps=1e-6, **DEV)
    assert p.admm_iters == p64.admm_iters        # the reference's own check
    with pytest.raises(ValueError):
        pdhg.solve_lp_pdhg(A, b, c, precision="f32", **DEV)


@pytest.mark.parametrize("kind,seed", [("infeasible", 0), ("infeasible", 1),
                                       ("unbounded", 0), ("unbounded", 1)])
def test_lp_pdhg_certificates_match_reference(kind, seed):
    from benchmarks.generate import infeasible_lp, unbounded_lp

    A, b, c = (infeasible_lp if kind == "infeasible" else unbounded_lp)(
        seed=seed)
    r = jpdhg.solve_lp_pdhg(A, b, c, eps=1e-6, max_iters=100_000)
    p = pdhg.solve_lp_pdhg(A, b, c, eps=1e-6, max_iters=100_000, **DEV)
    assert p.status_name == kind.capitalize()
    _same(p, r)
    cert = p.res_infeas if kind == "infeasible" else p.res_unbdd
    ref = r.res_infeas if kind == "infeasible" else r.res_unbdd
    assert cert < 1e-7
    assert abs(cert - ref) <= 1e-9


def test_spectral_norm_matches_reference():
    A = np.random.default_rng(2).standard_normal((40, 60))
    est = float(pdhg.estimate_spectral_norm(torch.from_numpy(A)))
    ref = float(jpdhg.estimate_spectral_norm(jnp.asarray(A)))
    assert est == pytest.approx(ref, rel=1e-12)
    assert est <= np.linalg.norm(A, 2) * (1 + 1e-9)


def _lp_batch():
    B, m, n = 4, 15, 45
    rng = np.random.default_rng(1)
    As, bs, cs = [], [], []
    for _ in range(B):
        A = rng.standard_normal((m, n))
        b = A @ (rng.random(n) + 0.5)
        As.append(A), bs.append(b)
        cs.append(A.T @ rng.standard_normal(m) + rng.random(n) + 0.5)
    return map(np.stack, (As, bs, cs))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_lp_pdhg_batch_matches_reference_and_single(precision):
    As, bs, cs = _lp_batch()
    ref = jpdhg.solve_lp_pdhg_batch(As, bs, cs, eps=1e-6,
                                    precision=precision)
    st = pdhg.solve_lp_pdhg_batch(As, bs, cs, eps=1e-6, precision=precision,
                                  **DEV)
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(ref.status))
    assert (st.status.numpy() == 1).all()
    tol = 1e-9 if precision == "f64" else 1e-6
    np.testing.assert_allclose(st.pobj.numpy(), np.asarray(ref.pobj),
                               rtol=tol)
    if precision == "f64":
        np.testing.assert_array_equal(st.k.numpy(), np.asarray(ref.k))
    one = pdhg.solve_lp_pdhg(As[2], bs[2], cs[2], eps=1e-6,
                             precision=precision, **DEV)
    # the same lane alone: equal count; a batched matmul sums in another
    # order than a one-lane one, so the objective to 1e-12 in f64 and to
    # the mixed bar in mixed precision
    assert one.admm_iters == int(st.k[2])
    assert one.pobj == pytest.approx(float(st.pobj[2]),
                                     rel=1e-12 if precision == "f64" else tol)
    with pytest.raises(NotImplementedError, match="item 19"):
        pdhg.solve_lp_pdhg_batch(As, bs, cs, mesh=object(), **DEV)


CONIC = [(1, dict(soc=(6, 4), nonneg=15)),
         (2, dict(rsoc=(5,), free=2, nonneg=10)),
         (3, dict(soc=(5,), rsoc=(4,), nonneg=12))]


@pytest.mark.parametrize("seed,spec", CONIC)
def test_qcp_pdhg_matches_reference(seed, spec):
    from benchmarks.conic_mini import randcone

    _, A, b, c, cn, star = randcone(f"p{seed}", 12, jcones.ConeSpec(**spec),
                                    seed)
    r = jpdhg.solve_qcp_pdhg(A, b, c, cn, eps=1e-7)
    p = pdhg.solve_qcp_pdhg(A, b, c, ConeSpec(**spec), eps=1e-7, **DEV)
    assert p.status_name == "Solved"
    _same(p, r)
    assert abs(p.pobj - star) / (1 + abs(star)) < 1e-5
    lay = ConeLayout(ConeSpec(**spec))
    assert float(cones.cone_membership_violation(torch.from_numpy(p.x),
                                                 lay)) < 1e-5


def test_qcp_pdhg_portfolio_matches_reference():
    from benchmarks.conic_mini import portfolio

    _, A, b, c, cn, _ = portfolio(20, 5, 9)
    spec = ConeSpec(soc=cn.soc, rsoc=cn.rsoc, free=cn.free, zero=cn.zero,
                    nonneg=cn.nonneg)
    r = jpdhg.solve_qcp_pdhg(A, b, c, cn, eps=1e-7)
    p = pdhg.solve_qcp_pdhg(A, b, c, spec, eps=1e-7, **DEV)
    assert p.status_name == "Solved"
    _same(p, r)


def test_qcp_pdhg_detects_infeasible():
    A = np.array([[1.0, 0.0, 0.0]])
    b = np.array([-1.0])
    c = np.array([0.0, 1.0, 1.0])
    r = jpdhg.solve_qcp_pdhg(A, b, c, jcones.ConeSpec(soc=(3,)), eps=1e-6,
                             max_iters=50_000)
    p = pdhg.solve_qcp_pdhg(A, b, c, ConeSpec(soc=(3,)), eps=1e-6,
                            max_iters=50_000, **DEV)
    assert p.status_name == "Infeasible"
    _same(p, r)


def test_qcp_pdhg_mixed_and_batch_match_reference():
    from benchmarks.conic_mini import randcone

    jspec = jcones.ConeSpec(soc=(4,), nonneg=8)
    spec = ConeSpec(soc=(4,), nonneg=8)
    insts = [randcone(f"b{s}", 6, jspec, 20 + s) for s in range(3)]
    A0, b0, c0 = insts[0][1:4]
    r = jpdhg.solve_qcp_pdhg(A0, b0, c0, jspec, eps=1e-6, precision="mixed")
    p = pdhg.solve_qcp_pdhg(A0, b0, c0, spec, eps=1e-6, precision="mixed",
                            **DEV)
    _same(p, r, f64=False)
    As, bs, cs = (np.stack([i[k] for i in insts]) for k in (1, 2, 3))
    ref = jpdhg.solve_qcp_pdhg_batch(As, bs, cs, jspec, eps=1e-6,
                                     precision="f64")
    st = pdhg.solve_qcp_pdhg_batch(As, bs, cs, spec, eps=1e-6,
                                   precision="f64", **DEV)
    np.testing.assert_array_equal(st.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(st.k.numpy(), np.asarray(ref.k))
    np.testing.assert_allclose(st.pobj.numpy(), np.asarray(ref.pobj),
                               rtol=1e-9)
