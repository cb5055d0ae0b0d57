"""`abip_tpu_torch.ops.admm_delta` against `abip_tpu.ops.admm_delta`.

Inputs are numpy-seeded LPs advanced to a mid-solve state by absolute
f64 ADMM steps of the reference (`tests/test_delta_engine.py`); both
sides then receive identical operands through the converters.  On the
CPU the reference chunk is its XLA version `_delta_ref` and the port's
is its plain PyTorch version.  The CUDA kernel is compared with the
plain version on the card in `tests/test_torch_cuda.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.ops import admm_delta as jdelta  # noqa: E402
from abip_tpu_torch.ops import admm_delta as delta  # noqa: E402
from abip_tpu_torch.parallel.batched import lane_state_from_numpy  # noqa: E402
from test_delta_engine import _absolute_step, _setup, _smoke_lp  # noqa: E402

f64 = jnp.float64
# The reference holds its kernel to its fallback at rtol 2e-5, atol 1e-6
# (`tests/test_delta_engine.py:182-184`): the same f32 reductions in the
# same order.  Across frameworks they run in another order.  Measured at
# T=64 on the lanes below: the port and the reference each sit up to
# ~1e-6 (deltas of size ~1) and ~6e-5 (sums of size ~60) from an f64 run
# of the same recurrence, and as far from each other.  So outputs are
# held to rtol 2e-5 plus 1e-5 of the array's largest magnitude (ROADMAP
# queue 3 records this gap).
RTOL_F32, REL_SCALE = 2e-5, 1e-5


def _assert_f32_close(port, ref, err_msg=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    atol = REL_SCALE * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=RTOL_F32, atol=atol,
                               err_msg=err_msg)


def _mid_solve(m, n, seed, steps=200):
    """A reference setup and an f64 state advanced through three barrier
    stages."""
    A, b, c = _smoke_lp(m=m, n=n, seed=seed)
    A, b, c, solve64, h, g, g_th, rho_y = _setup(A, b, c)
    step = jax.jit(lambda u, v, mu: _absolute_step(A, solve64, h, g, g_th,
                                                   rho_y, u, v, mu))
    l = m + n + 1
    u = jnp.concatenate([jnp.zeros((m,), f64), jnp.ones((l - m,), f64)])
    v = u
    for mu in (1.0, 1e-2, 1e-4):
        for _ in range(steps):
            u, v = step(u, v, mu)
    return dict(A=A, solve64=solve64, h=h, g=g, g_th=g_th, rho_y=rho_y,
                u=u, v=v, step=step, l=l)


def _port_inputs(s):
    """The same setup as batched one-lane tensors, with an f64 Cholesky
    solve standing in for the reference's."""
    A = torch.as_tensor(np.array(s["A"]))[None]
    L = torch.linalg.cholesky(s["rho_y"] * torch.eye(A.shape[1],
                                                     dtype=torch.float64)
                              + A[0] @ A[0].T)

    def solve64(rhs):
        if rhs.dim() == 3:
            return torch.cholesky_solve(rhs, L)
        return torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)

    def lane(x):
        return torch.as_tensor(np.array(x))[None]

    return A, solve64, lane(s["h"]), lane(s["g"]), lane(s["g_th"])


def _stack(anchors):
    return delta.DeltaAnchor(*[torch.cat(f) for f in zip(*anchors)])


@pytest.fixture(scope="module")
def mid():
    return [_mid_solve(16, 140, seed) for seed in (5, 6)]


def _jax_anchor(s, lam, thresh, qres=jnp.inf):
    l = s["l"]
    return jdelta.delta_anchor(
        s["A"], s["solve64"], s["h"], s["g"], s["g_th"], s["rho_y"], lam,
        1.8, thresh, s["u"], s["v"], jnp.zeros((l,), f64),
        jnp.zeros((l,), f64), jnp.zeros((), jnp.int32), qres)


def test_delta_anchor_matches_reference(mid):
    """f32 operands from the same f64 state agree to about one f32 ulp,
    plus 1e-10 absolute: f64 reductions of O(10)-sized terms in another
    order (and another Cholesky solve) differ by ~1e-11 absolute, which
    shows in the small residue slots.  The rounded prox argument plus
    its residue is compared in f64."""
    s = mid[0]
    m, n = s["A"].shape
    ref = [np.asarray(f) for f in _jax_anchor(s, 1e-5, 0.0)]
    A, solve64, h, g, g_th = _port_inputs(s)
    st = lane_state_from_numpy(s["u"], s["v"], np.zeros(s["l"]),
                               np.zeros(s["l"]), 0, np.inf, "cpu")
    port = delta.delta_anchor(A, solve64, h, g, g_th, s["rho_y"], 1e-5, 1.8,
                              0.0, st.u, st.v, st.u_sum, st.v_sum, st.sj,
                              st.qres)
    for name, r in zip(jdelta.DeltaAnchor._fields, ref):
        p = getattr(port, name)[0].numpy()
        if name == "scal":
            r = r[0, :delta.N_SCAL]
        elif name == "A":
            r = r[:m, :n]
        elif name == "Ninv":
            r = r[:m, :m]
        else:
            r = r[0, :p.shape[0]]
        if name in ("etx",):
            continue
        np.testing.assert_allclose(p, r, rtol=3e-7, atol=1e-10,
                                   err_msg=name)
    np.testing.assert_allclose(
        port.t0x[0].double().numpy() + port.etx[0].double().numpy(),
        ref[11][0, :n].astype(np.float64) + ref[13][0, :n], rtol=1e-12,
        atol=1e-10)


def _run_both(anchors_jax, T, probe):
    ref = [jdelta._delta_ref(a, T=T, probe=probe) for a in anchors_jax]
    anc = _stack([delta.anchor_from_numpy([np.asarray(f) for f in a], "cpu")
                  for a in anchors_jax])
    B = len(anchors_jax)
    port = delta._delta_compute(
        anc, torch.full((B,), T, dtype=torch.int32), probe)
    return ref, port


def test_plain_chunk_matches_reference(mid):
    """T=64, probe=8, thresh=0, two lanes at once: t_done equal, every
    output within the cross-framework f32 tolerance of the reference,
    and both within it of an f64 run of the port's recurrence."""
    anchors = [_jax_anchor(s, 1e-5, 0.0) for s in mid]
    ref, port = _run_both(anchors, 64, 8)
    anc64 = _stack([delta.anchor_from_numpy(
        [np.asarray(f, np.float64) for f in a], "cpu") for a in anchors])
    anc64 = delta.DeltaAnchor(*[x.double() for x in anc64])
    exact = delta._delta_compute(
        anc64, torch.full((len(mid),), 64, dtype=torch.int32), 8)
    for i, r in enumerate(ref):
        r = [np.asarray(x)[0] for x in r[:6]] + [
            np.asarray(r[6])[0, :delta.ROW_WIDTH]]
        for k, name in enumerate(("dy", "dx", "dvx", "dsy", "dsx", "dsvx",
                                  "row")):
            _assert_f32_close(port[k][i].numpy(), r[k], name)
            _assert_f32_close(port[k][i].numpy(), exact[k][i].numpy(), name)
            _assert_f32_close(r[k], exact[k][i].numpy(), name)
        assert int(port[6][i, 5]) == int(r[6][5]) == 64


def test_plain_chunk_stops_mid_chunk(mid):
    """A threshold just above each lane's qres after 64 iterations stops
    the lane within T=256, within one probe of the reference."""
    q64 = [float(np.asarray(jdelta._delta_ref(_jax_anchor(s, 1e-5, 0.0),
                                              T=64, probe=8)[6])[0, 4])
           for s in mid]
    ref, port = _run_both([_jax_anchor(s, 1e-5, 1.05 * q)
                           for s, q in zip(mid, q64)], 256, 8)
    for i, r in enumerate(ref):
        t_ref = int(np.asarray(r[6])[0, 5])
        t_port = int(port[6][i, 5])
        assert t_ref < 256
        assert abs(t_port - t_ref) <= 8, (t_port, t_ref)


def test_run_delta_chunk_matches_f64_trajectory():
    """Mirror of `test_delta_chunk_matches_f64_trajectory`: T f32 delta
    iterations of the port track T absolute f64 reference iterations to
    a small fraction of the iterate movement, the accumulators track the
    running sums, and the port agrees with the reference chunk."""
    m, n = 40, 300
    s = _mid_solve(m, n, seed=1, steps=400)
    l = s["l"]
    mu, T = 1e-5, 192
    ua, va = s["u"], s["v"]
    usum = jnp.zeros((l,), f64)
    vsum = jnp.zeros((l,), f64)
    for _ in range(T):
        ua, va = s["step"](ua, va, mu)
        usum = usum + ua
        vsum = vsum + va
    A, solve64, h, g, g_th = _port_inputs(s)
    st = lane_state_from_numpy(s["u"], s["v"], np.zeros(l), np.zeros(l), 0,
                               np.inf, "cpu")
    res = delta.run_delta_chunk(A, solve64, h, g, g_th, s["rho_y"], mu, 1.8,
                                0.0, *st, T=T, probe=8)
    assert int(res.t_done[0]) == T
    ua, va, usum = (np.asarray(x) for x in (ua, va, usum))
    movement = float(np.linalg.norm(ua - np.asarray(s["u"]))) + 1e-12
    assert np.abs(res.u[0].numpy() - ua).max() < 1e-4 * max(movement, 1.0)
    assert np.abs(res.v[0].numpy() - va).max() < 1e-4 * max(movement, 1.0)
    rel = np.abs(res.u_sum[0].numpy() - usum).max() / (np.abs(usum).max()
                                                       + 1e-12)
    assert rel < 1e-6, rel
    jres = jdelta.run_delta_chunk(
        s["A"], s["solve64"], s["h"], s["g"], s["g_th"], s["rho_y"], mu, 1.8,
        0.0, s["u"], s["v"], jnp.zeros((l,), f64), jnp.zeros((l,), f64),
        jnp.zeros((), jnp.int32), jnp.inf, T=T, probe=8, use_pallas=False)
    for name in ("u", "v", "u_sum", "v_sum"):
        _assert_f32_close(getattr(res, name)[0].numpy(),
                          np.asarray(getattr(jres, name)), name)


def test_run_delta_chunk_converged_and_inactive_lanes_run_zero_trips():
    """Mirror of `test_delta_chunk_converged_lane_runs_zero_trips`, in a
    batch: lane 0 enters below its threshold, lane 1 is inactive, lane 2
    runs the whole chunk.  Lanes 0 and 1 come back unchanged."""
    m, n = 40, 300
    A, b, c = _smoke_lp(m=m, n=n, seed=2)
    A, b, c, solve64, h, g, g_th, rho_y = _setup(A, b, c)
    s = dict(A=A, solve64=solve64, h=h, g=g, g_th=g_th, rho_y=rho_y)
    A1, solve1, h1, g1, gth1 = _port_inputs(s)
    B, l = 3, m + n + 1
    u = torch.cat([torch.zeros((B, m), dtype=torch.float64),
                   torch.ones((B, l - m), dtype=torch.float64)], dim=1)
    z = torch.zeros((B, l), dtype=torch.float64)
    res = delta.run_delta_chunk(
        A1.expand(B, m, n), solve1, h1.expand(B, -1), g1.expand(B, -1),
        gth1.expand(B), rho_y, 1e-5, 1.8, torch.tensor([1e3, 0.0, 0.0]),
        u, u.clone(), z, z, torch.zeros(B, dtype=torch.int32),
        torch.tensor([1e-9, np.inf, np.inf]), T=256, probe=8,
        active=torch.tensor([True, False, True]))
    assert res.t_done.tolist() == [0, 0, 256]
    for i in (0, 1):
        assert torch.equal(res.u[i], u[i])
        assert torch.equal(res.v[i], u[i])
        assert torch.equal(res.u_sum[i], z[i])


def test_cuda_wrapper_refuses_cpu_tensors(mid):
    """The kernel wrapper never runs on CPU tensors: it raises."""
    anc = delta.anchor_from_numpy(
        [np.asarray(f) for f in _jax_anchor(mid[0], 1e-5, 0.0)], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        delta.delta_chunk_cuda(anc, torch.full((1,), 8, dtype=torch.int32), 8)



# the largest shape the one-block kernel took: n + 5 m floats and its
# 224-float reduction scratch within the H100's 232,448 bytes
OLD_LIMIT_FLOATS = delta.SMEM_OPTIN // 4 - 224


@pytest.mark.parametrize("m,n,cluster,resident", [
    (50, 2000, 6, True), (37, 411, 6, True), (200, 3000, 6, False),
    (50, 5000, 6, False), (1, OLD_LIMIT_FLOATS - 5, 6, False),
    (11_000, OLD_LIMIT_FLOATS - 55_000, 6, False)],
    ids=["smoke", "ragged", "L2-streaming", "wide-streaming",
         "old-limit-wide", "old-limit-tall"])
def test_delta_launch_plan(m, n, cluster, resident):
    """The cluster size, the residency and the shared memory a CTA needs;
    every shape the one-block kernel took still launches."""
    plan = delta.delta_launch_plan(m, n)
    assert (plan.cluster, plan.resident) == (cluster, resident)
    assert plan.smem_bytes == delta.delta_smem_bytes(m, n, cluster, resident)
    assert plan.smem_bytes <= delta.SMEM_OPTIN
    nc = -(-n // cluster)
    nc += -nc % 4                  # 16-byte rows
    assert plan.smem_bytes == 4 * (4 * m + 240 + nc + (
        5 * m + m * nc + m * m + 17 * nc if resident else 0))


@pytest.mark.parametrize("m,n", [(15_000, 1), (2, OLD_LIMIT_FLOATS * 8)],
                         ids=["tall", "wide"])
def test_delta_launch_plan_refuses_beyond_the_largest_shape(m, n):
    """Beyond the largest shape the streaming form's shared memory holds,
    the plan takes no shared memory: it spills the CTA's layout to a
    global workspace."""
    assert delta.delta_smem_bytes(m, n, delta.CLUSTER, False) > delta.SMEM_OPTIN
    assert delta.delta_launch_plan(m, n) == delta.DeltaPlan(
        delta.CLUSTER, False, 0, spill=True)


@pytest.mark.parametrize("spare,resident", [(0, True), (-4, False)],
                         ids=["fits", "one-float-short"])
def test_delta_launch_plan_on_a_smaller_card(spare, resident):
    """The plan is resident exactly where the card's shared memory holds
    the resident CTA, and streams otherwise."""
    need = delta.delta_smem_bytes(50, 2000, delta.CLUSTER, True)
    plan = delta.delta_launch_plan(50, 2000, smem_limit=need + spare)
    assert plan == delta.DeltaPlan(delta.CLUSTER, resident,
                                   delta.delta_smem_bytes(50, 2000,
                                                          delta.CLUSTER,
                                                          resident))
