"""`abip_tpu_torch.linsys.schur`, `equilibrate_conic` and
`prepare_conic_batch` against their `abip_tpu` counterparts.

numpy-seeded f64 data through both.  f64 factors and solves agree to
1e-10 relative plus 1e-12 absolute (Newton-refined inverses from f32
Cholesky factors that round differently); the equilibration in its f64 branch to 1e-12, in its
f32 branch (>= 2^18 elements per lane) to 1e-5 (f32 reductions in
another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu import scaling as jscaling  # noqa: E402
from abip_tpu.linsys import schur as jschur  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu.qcp import conic_defaults as j_conic_defaults  # noqa: E402
from abip_tpu_torch import cones, scaling  # noqa: E402
from abip_tpu_torch.linsys import schur  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from abip_tpu_torch.qcp import conic_defaults  # noqa: E402

SPEC = dict(soc=(5,), rsoc=(4,), nonneg=10)


def _data(B, m, n, seed, diag_q):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)) / np.sqrt(n)
    A[rng.random((B, m, n)) < 0.3] = 0.0
    b = rng.standard_normal((B, m))
    c = rng.standard_normal((B, n))
    Q = rng.random((B, n)) + 0.1 if diag_q else None
    return A, b, c, Q


@pytest.mark.parametrize("form,diag_q", [("woodbury", False),
                                         ("woodbury", True),
                                         ("primal", False),
                                         ("primal", True)])
def test_dense_schur_newton_matches_reference(form, diag_q):
    B, m, n = 2, 6, 19
    A, _, _, Q = _data(B, m, n, 4, diag_q)
    rng = np.random.default_rng(9)
    wy, wx = rng.standard_normal((B, m)), rng.standard_normal((B, n))
    port = schur.DenseSchurSolver(
        torch.from_numpy(A), None if Q is None else torch.from_numpy(Q),
        torch.full((m,), 1e-3, dtype=torch.float64),
        torch.ones(n, dtype=torch.float64), form=form)
    assert port.form == form
    zy, zx = port.solve(torch.from_numpy(wy), torch.from_numpy(wx))
    for i in range(B):
        ref = jschur.DenseSchurSolver(
            jnp.asarray(A[i]), None if Q is None else jnp.asarray(Q[i]),
            jnp.full((m,), 1e-3), jnp.ones(n), mode="newton", form=form)
        rzy, rzx, _ = ref.solve(jnp.asarray(wy[i]), jnp.asarray(wx[i]))
        np.testing.assert_allclose(zy[i].numpy(), np.asarray(rzy), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(zx[i].numpy(), np.asarray(rzx), rtol=1e-10,
                                   atol=1e-12)
        inv = ref.Ginv64 if form == "woodbury" else ref.Sinv64
        np.testing.assert_allclose(port.Minv64[i].numpy(), np.asarray(inv),
                                   rtol=1e-9, atol=1e-9)
        # round trip through the converter
        conv = schur.DenseSchurSolver.from_numpy(jax.device_get(ref))
        np.testing.assert_array_equal(conv.Minv64[0].numpy(),
                                      np.asarray(inv))


def test_newton_inverse_is_f64_accurate():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((3, 30, 30))
    S = M @ np.swapaxes(M, 1, 2) + 1e-2 * np.eye(30)
    X = schur._newton_inverse(torch.from_numpy(S)).numpy()
    resid = np.abs(X @ S - np.eye(30)).max()
    assert resid < 1e-9, resid


def test_auto_form_and_unported_modes():
    A = torch.zeros((1, 3, 8), dtype=torch.float64)
    r = torch.ones(3, dtype=torch.float64), torch.ones(8, dtype=torch.float64)
    assert schur.DenseSchurSolver(A, None, *r).form == "woodbury"
    assert schur.DenseSchurSolver(A[:, :, :3], None, r[0],
                                  r[1][:3]).form == "primal"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        schur.DenseSchurSolver(A, None, *r, mode="chol")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        schur.DenseSchurSolver(A, torch.zeros((1, 8, 8)), *r)


@pytest.mark.parametrize("diag_q,m,n,rtol", [
    (False, 7, 19, 1e-12),
    (True, 7, 19, 1e-12),
    (False, 256, 1024, 1e-5)])   # 2^18 elements: the f32 factor loop
def test_equilibrate_conic_matches_reference(diag_q, m, n, rtol):
    spec = (SPEC if n == 19 else
            dict(soc=(100, 100), rsoc=(24,), nonneg=800))
    B = 2
    A, b, c, Q = _data(B, m, n, 7, diag_q)
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    jlay = jcones.ConeLayout(jcones.ConeSpec(**spec))
    assert (scaling._factor_dtype(torch.from_numpy(A)) == torch.float32) == (
        m * n >= 1 << 18)
    out = scaling.equilibrate_conic(
        torch.from_numpy(A), None if Q is None else torch.from_numpy(Q),
        torch.from_numpy(b), torch.from_numpy(c), lay, conic_defaults())
    for i in range(B):
        ref = jscaling.equilibrate_conic(
            jnp.asarray(A[i]), None if Q is None else jnp.asarray(Q[i]),
            jnp.asarray(b[i]), jnp.asarray(c[i]), jlay, j_conic_defaults())
        for k, name in enumerate(("A", "Q", "b", "c")):
            if out[k] is None:
                assert ref[k] is None
                continue
            np.testing.assert_allclose(out[k][i].numpy(), np.asarray(ref[k]),
                                       rtol=rtol, atol=1e-14, err_msg=name)
        for name in ("D", "E", "sc_b", "sc_c"):
            np.testing.assert_allclose(
                getattr(out[4], name)[i].numpy(),
                np.asarray(getattr(ref[4], name)), rtol=rtol, err_msg=name)


@pytest.mark.parametrize("diag_q", [False, True])
def test_prepare_conic_batch_matches_reference(diag_q):
    """The whole per-lane setup (equilibration, factors, r_vec, a_coef),
    and `prepared_from_numpy` of the reference's result."""
    B, m, n = 2, 7, 19
    A, b, c, Q = _data(B, m, n, 8, diag_q)
    spec = cones.ConeSpec(**SPEC)
    port = bq.prepare_conic_batch(
        torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(c),
        None if Q is None else torch.from_numpy(Q), cones=spec, rho_y=1e-3,
        precision="mixed")
    ref = jax.device_get(jbq.prepare_conic_batch(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(c),
        None if Q is None else jnp.asarray(Q), cones=jcones.ConeSpec(**SPEC),
        rho_y=1e-3, precision="mixed"))
    conv = bq.prepared_from_numpy(ref)
    assert port.dss.form == conv.dss.form == ref.dss.form == "woodbury"
    for name in bq.PreparedConic._fields:
        if name == "dss":
            continue
        p, r = getattr(port, name), getattr(ref, name)
        if p is None:
            assert r is None and getattr(conv, name) is None
            continue
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      np.asarray(r), err_msg=name)
    np.testing.assert_allclose(port.dss.Minv64.numpy(),
                               np.asarray(ref.dss.Ginv64), rtol=1e-9,
                               atol=1e-9)
