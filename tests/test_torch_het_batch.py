"""Heterogeneous-cone batches: `abip_tpu_torch`'s `PaddedConeLayout`,
`pad_conic_instances` and `solve_qcp_het_batch` against
`abip_tpu.cones` / `abip_tpu.parallel.batched_qcp`, on the committed
conic-mini instances (`benchmarks.conic_mini.instances`, mixed SOC, RSOC,
free and orthant structures of different shapes).

Tolerances: the padding arrays are equal; the padded prox, interior
point and block tie equal each lane's natural ones to 1e-13 (the padding
exactly 0, or untouched); the solves run the f64 steps engine in both
packages, so statuses and ADMM counts are equal and objectives agree to
1e-9, with the padding of every solution exactly 0.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu_torch import cones  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from benchmarks.conic_mini import instances  # noqa: E402

CPU = dict(device="cpu")


def _spec(s):
    return cones.ConeSpec(soc=tuple(s.soc), rsoc=tuple(s.rsoc), free=s.free,
                          zero=s.zero, nonneg=s.nonneg)


def _problems(k=None, q=None):
    """(reference problems, port problems, optima) of the first k
    conic-mini instances; `q` gives lane 1 a diagonal ("diag") or full
    ("full") PSD quadratic term."""
    out = instances()[:k]
    rng = np.random.default_rng(3)
    jp, pp, stars = [], [], []
    for i, (_n, A, b, c, spec, star) in enumerate(out):
        Q = None
        if q and i == 1:
            n = A.shape[1]
            Q = (rng.random(n) + 0.1 if q == "diag"
                 else (lambda M: M @ M.T / n)(rng.standard_normal((n, n))))
        jp.append((A, b, c, Q, spec))
        pp.append((A, b, c, Q, _spec(spec)))
        stars.append(star)
    return jp, pp, stars


@pytest.mark.parametrize("q", [None, "diag", "full"])
def test_pad_conic_instances_matches_reference(q):
    jp, pp, _ = _problems(5, q)
    ref = jbq.pad_conic_instances(jp)
    port = bq.pad_conic_instances(pp, **CPU)
    for r, p in zip(ref[:4], port[:4]):
        if r is None:
            assert p is None
            continue
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    for f in ("kind", "seg", "head"):
        np.testing.assert_array_equal(getattr(port[4], f),
                                      np.asarray(getattr(ref[4], f)))
    for f in ("n", "num_blocks", "has_blocks", "has_soc", "has_rsoc"):
        assert getattr(port[4], f) == getattr(ref[4], f), f
    assert port[5] == ref[5]
    if q == "full":
        assert port[3].dim() == 3


SPECS = [dict(soc=(6, 4), rsoc=(5,), free=2, nonneg=7),
         dict(soc=(1, 3), nonneg=4), dict(rsoc=(3, 4), zero=2, nonneg=3),
         dict(nonneg=5)]


def test_padded_prox_matches_natural():
    """The prox through a stacked padded layout (per-lane operands)
    equals each lane's natural prox; the padding comes out exactly 0."""
    rng = np.random.default_rng(5)
    pad = cones.PaddedConeLayout.stack([cones.ConeSpec(**s) for s in SPECS])
    t = torch.from_numpy(rng.standard_normal((len(SPECS), pad.n)))
    lam = torch.from_numpy(np.abs(rng.standard_normal((len(SPECS), pad.n)))
                           + 0.1)
    out = cones.cone_barrier_prox(t, lam, pad).numpy()
    for k, s in enumerate(SPECS):
        lay = cones.ConeLayout(cones.ConeSpec(**s))
        nat = cones.cone_barrier_prox(t[k:k + 1, :lay.n], lam[k:k + 1, :lay.n],
                                      lay).numpy()[0]
        np.testing.assert_allclose(out[k, :lay.n], nat, rtol=1e-13,
                                   atol=1e-300)
        assert (out[k, lay.n:] == 0.0).all()


@pytest.mark.parametrize("which", range(len(SPECS)))
def test_padded_layout_matches_reference(which):
    """`tests/test_het_batch.py:47-84` through both packages: one layout
    padded by `from_layout` (operands shared by every lane), its prox,
    interior point and block tie against the reference's."""
    rng = np.random.default_rng(11 + which)
    spec = SPECS[which]
    jlay = jcones.ConeLayout(jcones.ConeSpec(**spec))
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    jpad = jcones.PaddedConeLayout.from_layout(jlay, jlay.n + 9,
                                               jlay.num_blocks + 2)
    pad = cones.PaddedConeLayout.from_layout(lay, lay.n + 9,
                                             lay.num_blocks + 2)
    t = rng.standard_normal(lay.n + 9)
    lam = np.abs(rng.standard_normal(lay.n + 9)) + 0.1
    ref = np.asarray(jcones.cone_barrier_prox(jnp.asarray(t),
                                              jnp.asarray(lam), jpad))
    port = cones.cone_barrier_prox(torch.from_numpy(t[None]),
                                   torch.from_numpy(lam[None]), pad)
    np.testing.assert_allclose(port.numpy()[0], ref, rtol=1e-13, atol=1e-300)
    assert (port.numpy()[0, lay.n:] == 0.0).all()
    np.testing.assert_array_equal(pad.interior_point().numpy(),
                                  np.asarray(jpad.interior_point(
                                      jnp.float64)))
    e = np.abs(rng.standard_normal(pad.n)) + 0.5
    tied = pad.segment_mean_tie(torch.from_numpy(e[None])).numpy()[0]
    np.testing.assert_allclose(tied, np.asarray(jpad.segment_mean_tie(
        jnp.asarray(e))), rtol=1e-13)
    np.testing.assert_array_equal(tied[lay.n:], e[lay.n:])


def test_padded_layout_refuses_short_padding():
    lay = cones.ConeLayout(cones.ConeSpec(soc=(4,), nonneg=3))
    with pytest.raises(ValueError, match="n_pad"):
        cones.PaddedConeLayout.from_layout(lay, 5, 1)
    with pytest.raises(ValueError, match="nb_pad"):
        cones.PaddedConeLayout.from_layout(lay, 9, 0)


def _assert_solved_as_reference(port, ref, jp):
    assert port.status.tolist() == np.asarray(ref.status).tolist()
    assert set(port.status.tolist()) == {1}
    assert port.admm_iters.tolist() == np.asarray(ref.admm_iters).tolist()
    np.testing.assert_allclose(port.pobj.numpy(), np.asarray(ref.pobj),
                               rtol=1e-9, atol=1e-9)
    for k, (A, *_rest) in enumerate(jp):
        m, n = A.shape
        assert np.abs(port.x.numpy()[k, n:]).max(initial=0.0) == 0.0
        assert np.abs(port.y.numpy()[k, m:]).max(initial=0.0) == 0.0


@pytest.mark.parametrize("normalize", [True, False])
def test_het_batch_matches_reference(normalize):
    """Route "batch": one steps-engine batch over six cone structures,
    each lane equilibrated at its natural shape (normalize=True) or
    not, against the reference's lockstep batch."""
    jp, pp, _ = _problems(6)
    kw = dict(eps=1e-5, normalize=normalize, inner_crit_period=16,
              route="batch")
    _assert_solved_as_reference(bq.solve_qcp_het_batch(pp, **kw, **CPU),
                                jbq.solve_qcp_het_batch(jp, **kw), jp)


def test_het_pool_matches_reference():
    """Route "pool": `solve_qcp_device` per instance (cadence "cond",
    f64), the results padded back to the batch contract."""
    jp, pp, _ = _problems(3)
    kw = dict(eps=1e-5, route="pool")
    port = bq.solve_qcp_het_batch(pp, **kw, **CPU)
    _assert_solved_as_reference(port, jbq.solve_qcp_het_batch(jp, **kw), jp)
    assert port.u_raw is None
    n_pad = max(p[0].shape[1] for p in pp)
    assert tuple(port.x.shape) == (3, n_pad)


def test_het_routes_agree_with_optima():
    """Every conic-mini instance with a recorded optimum, through "auto"
    (the pool here: the padded batch would waste more than 2x) and the
    forced batch, and one lane with a diagonal Q: equal statuses, the
    optima within 1e-4 (`tests/test_het_batch.py:103-139`)."""
    jp, pp, stars = _problems()
    keep = [k for k, s in enumerate(stars) if s is not None]
    pp = [pp[k] for k in keep]
    stars = np.array([stars[k] for k in keep])
    nat = sum(p[0].shape[0] * p[0].shape[1] for p in pp)
    waste = len(pp) * max(p[0].shape[0] for p in pp) * max(
        p[0].shape[1] for p in pp) / nat
    assert waste > 2.0
    kw = dict(eps=1e-6, inner_crit_period=16, **CPU)
    auto = bq.solve_qcp_het_batch(pp, **kw)
    batch = bq.solve_qcp_het_batch(pp, route="batch", **kw)
    assert auto.status.tolist() == batch.status.tolist() == [1] * len(pp)
    assert (np.abs(auto.pobj.numpy() - stars)
            <= 1e-4 * (1 + np.abs(stars))).all()
    np.testing.assert_allclose(auto.pobj.numpy(), batch.pobj.numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("q", ["diag", "full"])
def test_het_batch_with_q_matches_reference(q):
    """A quadratic term on one lane: a diagonal Q keeps the batch
    diagonal (zeros elsewhere); a full Q promotes the whole batch to
    (B, n, n) and the primal form."""
    jp, pp, _ = _problems(3, q)
    kw = dict(eps=1e-5, route="batch", inner_crit_period=16)
    _assert_solved_as_reference(bq.solve_qcp_het_batch(pp, **kw, **CPU),
                                jbq.solve_qcp_het_batch(jp, **kw), jp)


def test_het_route_refusal():
    _, pp, _ = _problems(2)
    with pytest.raises(ValueError, match="route must be"):
        bq.solve_qcp_het_batch(pp, route="bucket", **CPU)
