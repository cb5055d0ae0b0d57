"""LASSO and SVM: `abip_tpu_torch.problems` against `abip_tpu.problems`.

The builders are numpy in both packages and must give equal arrays
(the operator forms: equal b, c, Q and Jacobi diagonals, products within
1e-13 of scale).  The solves run the host conic driver (or, for
`solve_lasso_batch`, the batched steps engine in f64) in both packages:
equal statuses and objectives within 1e-6 relative; the LASSO optimum
agrees with a FISTA oracle (`benchmarks.ml_sweep.ista_lasso`) to 1e-5,
and the two SVM forms with each other to 1e-5 (`ml_sweep.py`'s own
cross-check).
"""
from dataclasses import astuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.problems import lasso as jl  # noqa: E402
from abip_tpu.problems import svm as js  # noqa: E402
from abip_tpu_torch import problems as pp  # noqa: E402
from benchmarks.generate import lasso_instance, svm_instance  # noqa: E402
from benchmarks.ml_sweep import ista_lasso  # noqa: E402

CPU = dict(device="cpu")
LASSO = lasso_instance(m=12, n=30, seed=3)
SVM = svm_instance(m=20, n=5, seed=7)


def _assert_operator_equal(port, ref):
    np.testing.assert_array_equal(port.b, ref.b)
    np.testing.assert_array_equal(port.c, ref.c)
    if ref.Q is None:
        assert port.Q is None
    else:
        np.testing.assert_array_equal(port.Q, np.asarray(ref.Q))
    np.testing.assert_array_equal(port.A.col_norms_sq,
                                  np.asarray(ref.A.col_norms_sq))
    assert (port.A.m, port.A.n, port.A.nnz) == (ref.A.m, ref.A.n, ref.A.nnz)
    assert astuple(port.cones) == astuple(ref.cones)
    rng = np.random.default_rng(1)
    z = rng.standard_normal(ref.A.n)
    u = rng.standard_normal(ref.A.m)
    for f, x in (("matvec", z), ("rmatvec", u)):
        r = np.asarray(getattr(ref.A, f)(x))
        p = getattr(port.A, f)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(p, r, rtol=0,
                                   atol=1e-13 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("kind", ["lasso", "svm_qp", "svm_socp"])
def test_builders_equal_reference(kind):
    if kind == "lasso":
        port, ref = pp.lasso_to_conic(*LASSO), jl.lasso_to_conic(*LASSO)
    else:
        form = kind[4:]
        port = getattr(pp, f"svm_to_conic_{form}")(*SVM, 1.0)
        ref = getattr(js, f"svm_to_conic_{form}")(*SVM, 1.0)
    for f in ("A", "b", "c"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    if ref.Q is None:
        assert port.Q is None
    else:
        np.testing.assert_array_equal(port.Q, ref.Q)
    assert astuple(port.cones) == astuple(ref.cones)


@pytest.mark.parametrize("kind", ["lasso", "svm_qp", "svm_socp"])
@pytest.mark.parametrize("scaled", [True, False])
def test_operators_equal_reference(kind, scaled):
    if kind == "lasso":
        port = pp.lasso_operator(*LASSO, scaled=scaled, **CPU)
        ref = jl.lasso_operator(*LASSO, scaled=scaled)
    else:
        form = kind[4:]
        port = getattr(pp, f"svm_operator_{form}")(*SVM, 1.0, scaled=scaled,
                                                   **CPU)
        ref = getattr(js, f"svm_operator_{form}")(*SVM, 1.0, scaled=scaled)
    _assert_operator_equal(port, ref)


@pytest.mark.parametrize("form", ["qp", "socp"])
def test_svm_kkt_factory_matches_reference(form):
    """The custom KKT backend (`LowRankWoodburySolver` through
    `solver_factory`) solves the block system as the reference's.  The
    right-hand side carries A' w_y / rho_y and z_y = w_y / rho_y - u, so
    both blocks cancel terms 1/rho_y larger than themselves: they are
    held to 1e-14 of max |w_y| / rho_y."""
    port = getattr(pp, f"svm_operator_{form}")(*SVM, 1.0, **CPU)
    ref = getattr(js, f"svm_operator_{form}")(*SVM, 1.0)
    m, n = ref.A.m, ref.A.n
    rng = np.random.default_rng(2)
    ry, rx = np.full(m, 1e-6), np.ones(n)
    wy, wx = rng.standard_normal(m), rng.standard_normal(n)
    Qd = None if ref.Q is None else np.asarray(ref.Q)
    t = torch.from_numpy
    sp = port.solver_factory(port.A, t(ry), t(rx),
                             None if Qd is None else t(Qd))
    sr = ref.solver_factory(ref.A, ry, rx, Qd)
    big = np.abs(wy / ry).max()
    for zp, zr in zip(sp.solve(t(wy), t(wx))[:2], sr.solve(wy, wx)[:2]):
        np.testing.assert_allclose(zp.numpy(), np.asarray(zr), rtol=0,
                                   atol=1e-14 * big)


@pytest.mark.parametrize("matrix_free", [False, True])
def test_solve_lasso_matches_reference(matrix_free):
    wp, objp, solp = pp.solve_lasso(*LASSO, eps=1e-6, matrix_free=matrix_free,
                                    **CPU)
    wr, objr, solr = jl.solve_lasso(*LASSO, eps=1e-6, matrix_free=matrix_free)
    assert solp.status_name == solr.status_name == "Solved"
    assert abs(objp - objr) <= 1e-6 * max(1.0, abs(objr))
    star = ista_lasso(*LASSO)[1]
    assert abs(objp - star) <= 1e-5 * max(1.0, abs(star))
    assert wp.shape == (LASSO[0].shape[1],)


def test_solve_lasso_batch_matches_reference():
    """A lambda grid as one batch: the reference's default engine
    ("steps", f64) in both packages."""
    X, y, lam = LASSO
    lams = lam * np.array([0.5, 1.0, 2.0])
    Xs, ys = np.stack([X] * 3), np.stack([y] * 3)
    Wp, objp, resp = pp.solve_lasso_batch(Xs, ys, lams, eps=1e-6, **CPU)
    Wr, objr, resr = jl.solve_lasso_batch(Xs, ys, lams, eps=1e-6)
    assert resp.status.tolist() == np.asarray(resr.status).tolist() == [1] * 3
    assert resp.admm_iters.tolist() == np.asarray(resr.admm_iters).tolist()
    np.testing.assert_allclose(objp, objr, rtol=1e-6)
    np.testing.assert_allclose(Wp, Wr, atol=1e-6)
    star = ista_lasso(X, y, lam)[1]
    assert abs(objp[1] - star) <= 1e-5 * max(1.0, abs(star))


@pytest.fixture(scope="module")
def svm_solves():
    out = {}
    for form in ("qp", "socp"):
        for mf in (False, True):
            out[form, mf] = (
                pp.solve_svm(*SVM, 1.0, form=form, eps=1e-6, matrix_free=mf,
                             **CPU),
                js.solve_svm(*SVM, 1.0, form=form, eps=1e-6, matrix_free=mf))
    return out


@pytest.mark.parametrize("form", ["qp", "socp"])
@pytest.mark.parametrize("matrix_free", [False, True])
def test_solve_svm_matches_reference(svm_solves, form, matrix_free):
    (wp, bp, objp, solp), (wr, br, objr, solr) = svm_solves[form, matrix_free]
    assert solp.status_name == solr.status_name == "Solved"
    assert abs(objp - objr) <= 1e-6 * max(1.0, abs(objr))
    assert wp.shape == (SVM[0].shape[1],) and np.isfinite(bp)


def test_svm_forms_agree(svm_solves):
    """`ml_sweep.py`'s cross-check: the QP and SOCP objectives of one
    instance agree within 1e-5."""
    for mf in (False, True):
        q = svm_solves["qp", mf][0][2]
        s = svm_solves["socp", mf][0][2]
        assert abs(q - s) <= 1e-5 * max(1.0, abs(q))


def test_problem_refusals():
    X, y, lam = LASSO
    with pytest.raises(ValueError, match="lam must be positive"):
        pp.lasso_to_conic(X, y, 0.0)
    with pytest.raises(ValueError, match="y must have shape"):
        pp.lasso_to_conic(X, y[:-1], lam)
    Xs, ys = SVM
    with pytest.raises(ValueError, match="labels"):
        pp.svm_to_conic_qp(Xs, ys * 2, 1.0)
    with pytest.raises(ValueError, match="form must be"):
        pp.solve_svm(Xs, ys, 1.0, form="hinge", **CPU)
