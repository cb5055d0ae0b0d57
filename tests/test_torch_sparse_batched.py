"""`abip_tpu_torch.parallel.sparse_batched` against
`abip_tpu.parallel.sparse_batched`.

The same numpy-seeded families (the smoke LP of m=30 and the PageRank
family n=600, B=3 of `tests/test_sparse_batched.py`) go through both
packages on the CPU, in f64.  Both run the same steps engine with the
same PCG ladder, summing the sparse products in other orders, so the
tolerances are: equal status, IPM and ADMM counts; objectives within
1e-9 relative; x and y within 1e-7 of their scale (the largest
magnitude), s within 1e-7 of c's (s = c - A'y, near 0 at the
optimum).  Lane b of the batch equals its one-lane solve bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.parallel import sparse_batched as jsb  # noqa: E402
from abip_tpu_torch.linsys.cg import (cg_tolerance_lanes,  # noqa: E402
                                      pcg, pcg_lanes)
from abip_tpu_torch.parallel import sparse_batched as sb  # noqa: E402
from benchmarks.generate import pagerank_lp, smoke_lp  # noqa: E402

DEV = dict(device="cpu")


def _coo(A):
    Ac = sp.coo_matrix(A)
    order = np.lexsort((Ac.col, Ac.row))
    return Ac.row[order], Ac.col[order], Ac.data[order]


def _smoke():
    A, b, c = smoke_lp(m=30, n_rand=80, density=0.3, seed=4)
    rows, cols, vals = _coo(A)
    return rows, cols, vals[None], b[None], c[None], A.shape


def _pagerank(n=600, alphas=(0.80, 0.85, 0.90)):
    valss, bs, cs = [], [], []
    rows = cols = None
    for a in alphas:
        A, b, c = pagerank_lp(n=n, deg=6, alpha=a, seed=100)
        r_, c_, v_ = _coo(A)
        if rows is None:
            rows, cols = r_, c_
        valss.append(v_)
        bs.append(b)
        cs.append(c)
    return rows, cols, np.stack(valss), np.stack(bs), np.stack(cs), (n, n)


def _both(rows, cols, valss, bs, cs, shape, **kw):
    m, n = shape
    ref = jsb.solve_lp_batch_coo(rows, cols, jnp.asarray(valss),
                                 jnp.asarray(bs), jnp.asarray(cs), m=m, n=n,
                                 eps=1e-6, **kw)
    info = {}
    out = sb.solve_lp_batch_coo(rows, cols, valss, bs, cs, m=m, n=n,
                                eps=1e-6, info=info, **DEV, **kw)
    return ref, out, info


def _close(ref, out, cs):
    """The stated tolerances, lane by lane."""
    for name in ("status", "ipm_iters", "admm_iters"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("pobj", "dobj"):
        r, p = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        np.testing.assert_allclose(p, r, rtol=1e-9, atol=0, err_msg=name)
    for name in ("x", "y", "s"):
        r, p = np.asarray(getattr(ref, name)), getattr(out, name).numpy()
        scale = np.abs(cs if name == "s" else r).max(axis=1, keepdims=True)
        assert (np.abs(p - r) <= 1e-7 * scale).all(), (
            name, float(np.abs(p - r).max()))


@pytest.fixture(scope="module")
def pagerank3():
    data = _pagerank()
    return data, _both(*data)


def test_smoke_matches_reference():
    data = _smoke()
    ref, out, info = _both(*data)
    assert int(out.status[0]) == 1
    _close(ref, out, data[4])
    assert int(info["cg_iters"][0]) > 0


def test_pagerank_family_matches_reference(pagerank3):
    data, (ref, out, _) = pagerank3
    _close(ref, out, data[4])
    # every lane at the exact optimum 1'x* = 1
    assert (out.status.numpy() == 1).all()
    assert np.abs(out.pobj.numpy() - 1.0).max() < 1e-4


def test_lane_equals_one_lane_solve(pagerank3):
    (rows, cols, valss, bs, cs, (m, n)), (_, out, info) = pagerank3
    one_info = {}
    one = sb.solve_lp_batch_coo(rows, cols, valss[1:2], bs[1:2], cs[1:2],
                                m=m, n=n, eps=1e-6, info=one_info, **DEV)
    for name in ("x", "y", "s", "status", "ipm_iters", "admm_iters", "pobj",
                 "dobj", "res_pri", "res_dual", "rel_gap"):
        assert torch.equal(getattr(one, name)[0], getattr(out, name)[1]), name
    assert int(one_info["cg_iters"][0]) == int(info["cg_iters"][1])


def test_products_and_equilibration_match_reference():
    """A x, A' y and the Ruiz pass against the reference's segment sums
    (f64, 1e-12 of |A| |x|)."""
    rows, cols, valss, _, _, (m, n) = _pagerank(n=200)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, n))
    y = rng.standard_normal((3, m))
    pat = sb.SharedPattern.from_coo(rows, cols, m, n)
    V = torch.from_numpy(valss)
    ax = sb.coo_matvec(pat, V, torch.from_numpy(x)).numpy()
    aty = sb.coo_rmatvec(pat, V, torch.from_numpy(y)).numpy()
    for lane in range(3):
        ref_ax = np.asarray(jsb.coo_matvec(rows, cols, valss[lane],
                                           x[lane], m))
        ref_aty = np.asarray(jsb.coo_rmatvec(rows, cols, valss[lane],
                                             y[lane], n))
        A = abs(sp.csr_matrix((valss[lane], (rows, cols)), shape=(m, n)))
        np.testing.assert_allclose(ax[lane], ref_ax, rtol=0, atol=1e-12 * (
            A @ np.abs(x[lane])).max())
        np.testing.assert_allclose(aty[lane], ref_aty, rtol=0, atol=1e-12 * (
            A.T @ np.abs(y[lane])).max())
        ref_eq = jsb._equilibrate_coo(jnp.asarray(rows), jnp.asarray(cols),
                                      jnp.asarray(valss[lane]), m, n)
        out_eq = sb._equilibrate_coo(pat, V[lane:lane + 1])
        for r, p in zip(ref_eq, out_eq):
            np.testing.assert_allclose(p[0].numpy(), np.asarray(r),
                                       rtol=1e-12, atol=0)


def test_pcg_lanes_equals_per_lane_pcg():
    """Each lane of the masked batch PCG takes exactly the iterations and
    the iterate of `pcg` on that lane alone; a lane outside `active` is
    left at its warm start with count 0."""
    rng = np.random.default_rng(5)
    B, m = 3, 40
    Ms = [rng.standard_normal((m, m)) for _ in range(B)]
    N = torch.from_numpy(np.stack([0.5 * a @ a.T / m + np.eye(m)
                                   for a in Ms]))
    rhs = torch.from_numpy(rng.standard_normal((B, m)))
    x0 = torch.from_numpy(rng.standard_normal((B, m)))
    Mp = 1.0 / torch.diagonal(N, dim1=-2, dim2=-1)
    tol = torch.tensor([1e-3, 1e-12, 1e-5], dtype=torch.float64)
    # caps: lane 2 stops at its cap of 4, before its tolerance
    caps = torch.tensor([500, 500, 4])
    x, its = pcg_lanes(lambda y: (N @ y[..., None])[..., 0], Mp, rhs, x0,
                       tol, caps)
    for b in range(B):
        xb, ib = pcg(lambda y: (N[b:b + 1] @ y[None, :, None])[0, :, 0],
                     Mp[b], rhs[b], x0[b], tol[b], int(caps[b]))
        assert int(its[b]) == ib
        torch.testing.assert_close(x[b], xb, rtol=0, atol=1e-13)
    act = torch.tensor([True, False, True])
    x2, its2 = pcg_lanes(lambda y: (N @ y[..., None])[..., 0], Mp, rhs, x0,
                         tol, caps, active=act)
    assert its2.tolist() == [int(its[0]), 0, int(its[2])]
    assert torch.equal(x2[1], x0[1])


def test_cg_tolerance_lanes_matches_reference():
    from abip_tpu.linsys.cg import cg_tolerance

    norms = np.array([3.0, 1e-9, 250.0, 7.5])
    ks = np.array([-1, 0, 5, 1000])
    out = cg_tolerance_lanes(torch.from_numpy(norms), torch.from_numpy(ks),
                             2.0).numpy()
    ref = [float(cg_tolerance(jnp.asarray(a), jnp.asarray(k), 2.0,
                              jnp.float64)) for a, k in zip(norms, ks)]
    np.testing.assert_allclose(out, ref, rtol=1e-15, atol=0)
