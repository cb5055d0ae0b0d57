"""`abip_tpu_torch.ops.conic_delta` against `abip_tpu.ops.conic_delta`.

Mid-solve anchors: the reference prepares a numpy-seeded batch, the port
takes the same prepared data (`prepared_from_numpy`) and runs phase 1
(the ladder) to the 1e-3 switch; both packages then build the chunk's
anchor from the same f64 state.  The anchor's f32 fields are f32
roundings of f64 values that agree to ~1e-12, so they agree to one f32
ulp (rtol 3e-7) plus 1e-10 absolute; the rounded prox argument plus its
residue is compared in f64.  Chunks run on identical f32 operands: their
decisions (t_done) are equal and their values agree to the LP chunk's
cross-framework tolerance (`tests/test_torch_admm_delta.py`), rtol 2e-5 plus 1e-5 of each output's largest
magnitude (f32 reductions in another order); the port agrees with an
f64 run of its recurrence to the same tolerance and sits at most 3x as
far from it as the reference does.  The CUDA kernel is held to the plain
version on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import cones as jcones  # noqa: E402
from abip_tpu.ops import conic_delta as jcd  # noqa: E402
from abip_tpu.ops import conic_pallas as jcp  # noqa: E402
from abip_tpu.parallel import batched_qcp as jbq  # noqa: E402
from abip_tpu_torch import cones  # noqa: E402
from abip_tpu_torch.ops import conic_delta as cd  # noqa: E402
from abip_tpu_torch.cones import cone_operands  # noqa: E402
from abip_tpu_torch.parallel import batched_qcp as bq  # noqa: E402
from benchmarks.conic_mini import randcone, randqcp  # noqa: E402

RTOL_F32, REL_SCALE = 2e-5, 1e-5
RHO_Y, ALPHA = 1e-3, 1.8
SPEC = dict(soc=(5,), rsoc=(4,), nonneg=10)
KW = dict(eps=1e-6, precision="mixed", rho_y=RHO_Y, max_admm=1_000_000,
          inner_crit_period=512, probe_period=8)


def assert_f32_close(port, ref, err_msg=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    atol = REL_SCALE * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=RTOL_F32, atol=atol,
                               err_msg=err_msg)


def _setup(woodbury, diag_q):
    """Reference prep, the port's copy of it, and the port's phase-1
    state (two lanes)."""
    m = 7 if woodbury else 12
    data = [(randqcp("x", m, jcones.ConeSpec(**SPEC), seed=60 + i,
                     q_rank="diag") if diag_q else
             randcone("x", m, jcones.ConeSpec(**SPEC), seed=60 + i))
            for i in range(2)]
    As, bs, cs = (np.stack([d[k] for d in data]) for k in (1, 2, 3))
    Qs = np.stack([d[4] for d in data]) if diag_q else None
    prep = jbq.prepare_conic_batch(
        jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
        None if Qs is None else jnp.asarray(Qs),
        cones=jcones.ConeSpec(**SPEC), rho_y=RHO_Y, precision="mixed")
    P = bq.prepared_from_numpy(jax.device_get(prep))
    assert P.dss.form == ("woodbury" if woodbury else "primal")
    r1 = bq._solve(None, None, None, P.Q_diag, cones=cones.ConeSpec(**SPEC),
                   engine="ladder", mu_stop=1e-3, prepared=P, **KW)
    assert r1.status.tolist() == [0, 0] and (r1.mu < 1e-3).all()
    return dict(prep=prep, P=P, u=r1.u_raw, v=r1.v_raw, mu=r1.mu,
                tol=r1.tol_inner, woodbury=woodbury)


@pytest.fixture(scope="module", params=[(True, False), (False, True)],
                ids=["woodbury", "primal-diagQ"])
def mid(request):
    return _setup(*request.param)


def _port_anchor(s, thresh, q_init=float("inf")):
    P = s["P"]
    m = P.A.shape[1]
    Hinv = (P.dss.H_inv if s["woodbury"]
            else torch.zeros_like(P.c))
    return cd.conic_delta_anchor(
        P.A, P.dss.solve, P.Q_diag, P.r_vec[:, :m], P.r_vec[:, m:], P.b, P.c,
        P.a_coef, RHO_Y, 1.0, 1.0, s["mu"], ALPHA, thresh, s["u"], s["v"],
        q_init, cones.ConeLayout(cones.ConeSpec(**SPEC)), P.A.float(),
        P.dss.Minv64.float(), Hinv.float())


def _reference_anchor(s, i, thresh, q_init=np.inf):
    """The reference's anchor for lane i, its operands padded to 128."""
    p = jax.tree.map(lambda a: a[i], s["prep"])
    m, n = p.A.shape
    mp, np_ = jcp._pad128(m), jcp._pad128(n)
    mk = mp if s["woodbury"] else np_
    Minv = p.dss.Ginv64 if s["woodbury"] else p.dss.Sinv64
    f32 = jnp.float32
    A32p = jnp.zeros((mp, np_), f32).at[:m, :n].set(p.A.astype(f32))
    Minv32p = jnp.zeros((mk, mk), f32).at[:Minv.shape[0], :Minv.shape[0]].set(
        Minv.astype(f32))
    Hinv32p = jnp.zeros((1, np_), f32)
    if s["woodbury"]:
        Hinv32p = Hinv32p.at[0, :n].set(p.dss.H_inv.astype(f32))
    lay = jcones.ConeLayout(jcones.ConeSpec(**SPEC))
    return jcd.conic_delta_anchor(
        p.A, lambda wy, wx, *a: p.dss.solve(wy, wx), p.Q_diag, p.r_vec[:m],
        p.r_vec[m:], p.b, p.c, p.a_coef, RHO_Y, 1.0, 1.0,
        float(s["mu"][i]), ALPHA, thresh, jnp.asarray(s["u"][i].numpy()),
        jnp.asarray(s["v"][i].numpy()), q_init, lay,
        jcp.cone_kernel_data(lay, np_), A32p, Minv32p, Hinv32p, s["woodbury"])


@partial(jax.jit, static_argnames=("T", "woodbury"))
def _reference_chunk(anc, T, woodbury):
    with jax.default_matmul_precision("highest"):
        return jcd._conic_delta_compute(anc, T=T, probe=8, woodbury=woodbury)


def _converted(s, anchors):
    m, n = s["P"].A.shape[1:]
    per_lane = [cd.conic_anchor_from_numpy(jax.device_get(a), m, n,
                                           s["woodbury"]) for a in anchors]
    return cd.ConicDeltaAnchor(*[torch.cat(f) for f in zip(*per_lane)])


def test_anchor_matches_reference(mid):
    port = _port_anchor(mid, 0.0)
    ref = _converted(mid, [_reference_anchor(mid, i, 0.0) for i in range(2)])
    for name in cd.ConicDeltaAnchor._fields:
        if name in ("etx", "A", "Minv"):
            continue
        np.testing.assert_allclose(getattr(port, name).numpy(),
                                   getattr(ref, name).numpy(), rtol=3e-7,
                                   atol=1e-10, err_msg=name)
    for name in ("A", "Minv"):
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      getattr(ref, name).numpy())
    np.testing.assert_allclose(
        port.t0x.double().numpy() + port.etx.double().numpy(),
        ref.t0x.double().numpy() + ref.etx.double().numpy(), rtol=1e-12,
        atol=1e-12)


def test_plain_chunk_matches_reference(mid):
    """T=64, thresh=0, two lanes at once: t_done equal, values within
    the cross-framework tolerance of the reference and of an f64 run."""
    refs = [_reference_anchor(mid, i, 0.0) for i in range(2)]
    anc = _converted(mid, refs)
    co = cone_operands(cones.ConeSpec(**SPEC))
    t_max = torch.full((2,), 64, dtype=torch.int32)
    port = cd._conic_delta_compute(anc, co, t_max, probe=8,
                                   woodbury=mid["woodbury"])
    exact = cd._conic_delta_compute(
        cd.ConicDeltaAnchor(*[x.double() for x in anc]), co, t_max, probe=8,
        woodbury=mid["woodbury"])
    m, n = mid["P"].A.shape[1:]
    for i, a in enumerate(refs):
        r = _reference_chunk(a, 64, mid["woodbury"])
        r = [np.asarray(r[0])[0, :m], np.asarray(r[1])[0, :n],
             np.asarray(r[2])[0, :m], np.asarray(r[3])[0, :n],
             np.asarray(r[4])[0, :cd.DELTA_ROW]]
        assert port[4][i, 3].item() == r[4][3] == exact[4][i, 3].item() == 64
        for k, name in enumerate(("dy", "dx", "dvy", "dvx", "row")):
            assert_f32_close(port[k][i].numpy(), r[k], name)
            assert_f32_close(port[k][i].numpy(), exact[k][i].numpy(), name)
        # the port is no less accurate than the reference: its largest
        # distance from the f64 run is at most 3x the reference's
        p_err = max(np.abs(port[k][i].double().numpy() - exact[k][i].numpy())
                    .max() for k in range(5))
        r_err = max(np.abs(r[k] - exact[k][i].numpy()).max() for k in range(5))
        assert p_err <= 3.0 * r_err, (p_err, r_err)


def test_plain_chunk_stops_mid_chunk(mid):
    """A threshold just above each lane's criterion after 64 iterations
    stops the lane within T=256, within one probe of the reference."""
    co = cone_operands(cones.ConeSpec(**SPEC))
    anc0 = _converted(mid, [_reference_anchor(mid, i, 0.0) for i in range(2)])
    e64 = cd._conic_delta_compute(anc0, co, torch.full((2,), 64,
                                                       dtype=torch.int32),
                                  probe=8, woodbury=mid["woodbury"])[4][:, 2]
    refs = [_reference_anchor(mid, i, 1.05 * float(e64[i])) for i in range(2)]
    port = cd._conic_delta_compute(_converted(mid, refs), co,
                                   torch.full((2,), 256, dtype=torch.int32),
                                   probe=8, woodbury=mid["woodbury"])
    for i, a in enumerate(refs):
        t_ref = int(np.asarray(_reference_chunk(a, 256, mid["woodbury"])[4])
                    [0, 3])
        assert t_ref < 256
        assert abs(port[4][i, 3].item() - t_ref) <= 8


def test_run_chunk_matches_reference_and_masks_lanes(mid):
    """The whole chunk (f64 anchor, f32 iterations, f64 state) against
    the reference's at the stage's own tolerance; an inactive lane runs
    zero iterations and comes back unchanged."""
    P, s = mid["P"], mid
    m, n = P.A.shape[1:]
    Hinv = P.dss.H_inv if s["woodbury"] else torch.zeros_like(P.c)
    lay = cones.ConeLayout(cones.ConeSpec(**SPEC))
    co = cone_operands(cones.ConeSpec(**SPEC))
    res = cd.run_conic_delta_chunk(
        P.A, P.dss.solve, P.Q_diag, P.r_vec[:, :m], P.r_vec[:, m:], P.b,
        P.c, P.a_coef, RHO_Y, 1.0, 1.0, s["mu"], ALPHA, s["tol"], s["u"],
        s["v"], float("inf"), lay, co, P.A.float(), P.dss.Minv64.float(),
        Hinv.float(), s["woodbury"], T=512, probe=8,
        active=torch.tensor([True, False]))
    assert res.t_done[1].item() == 0
    assert torch.equal(res.u[1], s["u"][1]) and torch.equal(res.v[1],
                                                            s["v"][1])
    p = jax.tree.map(lambda a: a[0], s["prep"])
    a = _reference_anchor(s, 0, float(s["tol"][0]))
    ref = jcd.run_conic_delta_chunk(
        p.A, lambda wy, wx, *_: p.dss.solve(wy, wx), p.Q_diag, p.r_vec[:m],
        p.r_vec[m:], p.b, p.c, p.a_coef, RHO_Y, 1.0, 1.0, float(s["mu"][0]),
        ALPHA, float(s["tol"][0]), jnp.asarray(s["u"][0].numpy()),
        jnp.asarray(s["v"][0].numpy()), np.inf,
        jcones.ConeLayout(jcones.ConeSpec(**SPEC)), a.cd, a.A, a.Minv,
        a.Hinv, s["woodbury"], T=512, probe=8, use_pallas=False)
    assert abs(res.t_done[0].item() - int(ref.t_done)) <= 8
    assert 0 < res.t_done[0].item() < 512
    assert_f32_close(res.u[0].numpy(), np.asarray(ref.u), "u")
    assert_f32_close(res.v[0].numpy(), np.asarray(ref.v), "v")


def _prox_delta_setup(spec, seed):
    lay = cones.ConeLayout(cones.ConeSpec(**spec))
    co = cone_operands(cones.ConeSpec(**spec))
    rng = np.random.default_rng(seed)
    t0 = rng.standard_normal((1, lay.n)).astype(np.float32)
    return lay, co, rng, t0


def test_cone_prox_delta_is_zero_at_zero_and_scales_with_delta():
    """Mirror of `tests/test_conic_delta.py:18-50`: P(0) == 0 exactly,
    and P(dt)'s error is proportional to |dt| (no absolute floor) for
    every cone type, against the f64 prox difference."""
    spec = dict(soc=(25, 25), rsoc=(10,), nonneg=40)
    lay, co, rng, t0 = _prox_delta_setup(spec, 0)
    lam = 1e-5
    lam32 = torch.full((1, 1), lam)
    t0t = torch.from_numpy(t0)
    zero = cd._cone_prox_delta(torch.zeros_like(t0t), t0t, lam32, co)
    assert torch.equal(zero, torch.zeros_like(zero))
    for scale, bound in ((1e-4, 1e-7), (1e-6, 1e-9), (1e-8, 1e-11)):
        dt = (scale * rng.standard_normal((1, lay.n))).astype(np.float32)
        t64 = torch.from_numpy(t0.astype(np.float64))
        d64 = torch.from_numpy(dt.astype(np.float64))
        truth = (cones.cone_barrier_prox(t64 + d64, torch.tensor([[lam]]),
                                         lay)
                 - cones.cone_barrier_prox(t64, torch.tensor([[lam]]), lay))
        est = cd._cone_prox_delta(torch.from_numpy(dt), t0t, lam32, co)
        err = (est.double() - truth).abs().max().item()
        assert err < bound, (scale, err)


def test_branch_seams_fall_back_to_the_direct_difference():
    """An SOC head that changes sign and an RSOC block whose
    discriminant d changes sign inside one delta take the fallback (the
    RSOC one through the NaN sentinel); both agree with the reference's
    f32 delta and with the f64 prox difference to the fallback's
    O(1e-7) absolute error."""
    spec = dict(soc=(4,), rsoc=(4,), nonneg=2)
    lay, co, _, _ = _prox_delta_setup(spec, 1)
    lam = 1e-2
    # SOC block (0..3): a0 = 1e-3 -> a = -1e-3; RSOC block (4..7):
    # ze=zn=0.5, body^2 = 0.52 -> d0 = 0.5 - 0.52 < 0, then d > 0
    t0 = np.array([[1e-3, 0.2, -0.1, 0.3, 0.5, 0.5, 0.6, 0.4, 1.0, -1.0]],
                  np.float32)
    dt = np.array([[-2e-3, 1e-3, 0.0, -1e-3, 0.05, 0.05, -0.05, 0.0, 1e-3,
                    -1e-3]], np.float32)
    d0 = 2 * 0.5 * 0.5 - (0.6 ** 2 + 0.4 ** 2)
    dc = 2 * 0.55 * 0.55 - (0.55 ** 2 + 0.4 ** 2)
    assert d0 < 0 < dc
    est = cd._cone_prox_delta(torch.from_numpy(dt), torch.from_numpy(t0),
                              torch.full((1, 1), lam), co)[0].numpy()
    np_ = jcp._pad128(lay.n)

    def pad(x):
        out = np.zeros((1, np_), np.float32)
        out[0, :lay.n] = x[0]
        return jnp.asarray(out)

    jlay = jcones.ConeLayout(jcones.ConeSpec(**spec))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jcd._cone_prox_delta(
            pad(dt), pad(t0), jnp.float32(lam),
            jcp.cone_kernel_data(jlay, np_)))[0, :lay.n]
    t64 = torch.from_numpy(t0.astype(np.float64))
    truth = (cones.cone_barrier_prox(t64 + torch.from_numpy(
        dt.astype(np.float64)), torch.tensor([[lam]]), lay)
        - cones.cone_barrier_prox(t64, torch.tensor([[lam]]), lay))[0].numpy()
    assert np.isfinite(est).all()
    np.testing.assert_allclose(est, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(est, truth, rtol=1e-5, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors(mid):
    anc = _port_anchor(mid, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        cd.conic_delta_cuda(anc, cone_operands(cones.ConeSpec(**SPEC)),
                            torch.ones((2,), dtype=torch.int32), probe=8,
                            woodbury=mid["woodbury"])
