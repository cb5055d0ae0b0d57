"""`abip_tpu_torch.ops.admm_sprint` (the LP sprints' plain version)
against `abip_tpu.ops.admm_pallas`: the stopping sprint
`fused_admm_sprint_stop` and the plain sprint `fused_admm_sprint`, each
run as the Pallas kernel body (`use_pallas=True, interpret=True`) and as
its XLA fallback (`use_pallas=False`).

Inputs are numpy-seeded smoke LPs of `tests/test_delta_engine.py` at
the cold start, with lam = 0.1 (phase 1 of a solve, where the sprints
run); both sides receive the same f32 operands.  Iteration counts must
be equal.  The sprints iterate the absolute iterate in f32, not a delta
from an f64 anchor: after 64 iterations the two f32 versions sit up to
3e-5 of the iterate's largest magnitude apart, each about as far from
an f64 run of the same recurrence, and further into a solve up to 1e-4
(ROADMAP.md queue 3).  Values are held to rtol 2e-5 plus 1e-4 of each
output's largest magnitude, against the reference and the f64 run; the
inner criterion qres, a residual of such iterates, to 2%.  The CUDA
kernel is held to the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import hsd as jhsd  # noqa: E402
from abip_tpu.ops import admm_pallas as jap  # noqa: E402
from abip_tpu.ops import prox_pallas as jpp  # noqa: E402
from abip_tpu_torch.ops import admm_sprint as sp  # noqa: E402
from test_delta_engine import _absolute_step, _setup, _smoke_lp  # noqa: E402

f64 = jnp.float64
RTOL_F32, REL_SCALE = 2e-5, 1e-4
RHO_Y, ALPHA = 1e-3, 1.8
LAM = 0.1
REFERENCE = {"pallas": dict(use_pallas=True, interpret=True),
             "xla": dict(use_pallas=False)}


def _assert_f32_close(port, ref, err_msg=""):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    atol = REL_SCALE * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=RTOL_F32, atol=atol,
                               err_msg=err_msg)


def _lane(m, n, seed):
    """f32 operands (numpy) of one smoke LP at the cold start (the
    reference's own sprint test starts there): A, Ninv, h, g, g_th, u, v."""
    A, b, c = _smoke_lp(m=m, n=n, seed=seed)
    A, b, c, _, h, g, g_th, _ = _setup(A, b, c, RHO_Y)
    l = m + n + 1
    u = np.concatenate([np.zeros(m), np.ones(l - m)])
    Ninv = np.linalg.inv(RHO_Y * np.eye(m) + np.asarray(A) @ np.asarray(A).T)
    f = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return dict(A=f(A), Ninv=f(Ninv), h=f(h), g=f(g), g_th=float(g_th),
                u=f(u), v=f(u))


@pytest.fixture(scope="module")
def lanes():
    return [_lane(12, 100, seed) for seed in (5, 6)]


def _stack(lanes, key):
    return torch.from_numpy(np.stack([s[key] for s in lanes]))


def _port_stop(lanes, thresh, T, probe):
    return sp.fused_admm_sprint_stop(
        _stack(lanes, "A"), _stack(lanes, "Ninv"), _stack(lanes, "h"),
        _stack(lanes, "g"), RHO_Y,
        torch.tensor([s["g_th"] for s in lanes], dtype=torch.float64), LAM,
        ALPHA, torch.as_tensor(thresh, dtype=torch.float64),
        _stack(lanes, "u"), _stack(lanes, "v"), T=T, probe=probe)


def _ref_stop(s, thresh, T, probe, how):
    return jap.fused_admm_sprint_stop(
        jnp.asarray(s["A"]), jnp.asarray(s["Ninv"]), jnp.asarray(s["h"]),
        jnp.asarray(s["g"]), RHO_Y, s["g_th"], LAM, ALPHA, thresh,
        jnp.asarray(s["u"]), jnp.asarray(s["v"]), T=T, probe=probe,
        **REFERENCE[how])


@pytest.mark.parametrize("how", sorted(REFERENCE))
def test_stopping_sprint_matches_reference(lanes, how):
    """T=64, probe=8, thresh=0, two lanes at once: t_done equal, u, v
    and qres within the cross-framework f32 tolerance."""
    u, v, t_done, q = _port_stop(lanes, [0.0, 0.0], 64, 8)
    for i, s in enumerate(lanes):
        ru, rv, rt, rq = _ref_stop(s, 0.0, 64, 8, how)
        assert int(t_done[i]) == int(rt) == 64
        _assert_f32_close(u[i].numpy(), ru, "u")
        _assert_f32_close(v[i].numpy(), rv, "v")
        np.testing.assert_allclose(float(q[i]), float(rq), rtol=2e-2)
        eu, ev = _f64_run(s, 64, 8)
        for f32_run in ((u[i], v[i]), (ru, rv)):
            _assert_f32_close(np.asarray(f32_run[0]), eu, "u vs f64 run")
            _assert_f32_close(np.asarray(f32_run[1]), ev, "v vs f64 run")


def _f64_run(s, T, probe):
    """The port's recurrence in f64 on the lane's f32 operands."""
    op = sp.sprint_operands(
        *(torch.from_numpy(s[k][None]) for k in ("A", "Ninv", "h", "g")),
        RHO_Y, 1.0 / (s["g_th"] + 1.0), LAM, ALPHA, 0.0,
        torch.from_numpy(s["u"][None]), torch.from_numpy(s["v"][None]))
    op = sp.SprintOperands(*[x.double() for x in op])
    y, x, vx, row = sp._sprint_compute(op, torch.full((1,), T), probe)
    return (torch.cat([y, x, row[:, :1]], 1)[0].numpy(),
            torch.cat([op.vy, vx, row[:, 1:2]], 1)[0].numpy())


def test_stopping_sprint_stops_with_the_reference(lanes):
    """A threshold halfway (geometrically) between the reference's qres
    after 32 and after 40 iterations, a drop of at least 1.2x, stops
    both versions at 40 within T=256; a huge threshold stops at the
    first probe."""
    for i, s in enumerate(lanes):
        q32, q40 = (float(_ref_stop(s, 0.0, t, 8, "xla")[3]) for t in (32, 40))
        assert q32 > 1.2 * q40
        thresh = (q32 * q40) ** 0.5
        assert int(_ref_stop(s, thresh, 256, 8, "pallas")[2]) == 40
        assert int(_port_stop([s], [thresh], 256, 8)[2][0]) == 40
    _, _, t_done, _ = _port_stop(lanes, [1e9, 1e9], 64, 4)
    assert t_done.tolist() == [4, 4]


@pytest.mark.parametrize("how", sorted(REFERENCE))
def test_plain_sprint_matches_reference(lanes, how):
    """Exactly T=32 iterations, one lane at a time through the one-lane
    entry, against the reference's kernel body and fallback."""
    for s in lanes:
        u, v = sp.fused_admm_sprint(
            *(torch.from_numpy(s[k]) for k in ("A", "Ninv", "h", "g")),
            RHO_Y, s["g_th"], LAM, ALPHA, torch.from_numpy(s["u"]),
            torch.from_numpy(s["v"]), T=32)
        ru, rv = jap.fused_admm_sprint(
            *(jnp.asarray(s[k]) for k in ("A", "Ninv", "h", "g")), RHO_Y,
            s["g_th"], LAM, ALPHA, jnp.asarray(s["u"]), jnp.asarray(s["v"]),
            T=32, **REFERENCE[how])
        assert u.shape == (s["u"].shape[0],) and u.dtype == torch.float32
        _assert_f32_close(u.numpy(), ru, "u")
        _assert_f32_close(v.numpy(), rv, "v")


def test_rank1_weight_rounding_follows_each_reference_kernel(monkeypatch):
    """The stopping sprint forms 1 / (g_th + 1) in f64 and rounds it
    (`admm_pallas.py:437`); the plain sprint forms it in f32 (`:506`).
    At g_th = 2^24 + 1 the two differ in the last bit."""
    g_th = float(2 ** 24 + 1)
    want_stop = np.float32(1.0 / (g_th + 1.0))
    want_plain = np.float32(1.0) / (np.float32(g_th) + np.float32(1.0))
    assert want_stop != want_plain
    seen = {}

    plain = sp._sprint_compute

    def spy(op, t_max, probe):
        seen[probe] = float(op.scal[0, sp.S_IGTH])
        return plain(op, t_max, probe)

    A = torch.ones((1, 1, 2))
    one = torch.ones((1, 4))
    monkeypatch.setattr(sp, "_sprint_compute", spy)
    sp.fused_admm_sprint_stop(A, torch.ones((1, 1, 1)), one, one, RHO_Y,
                              g_th, LAM, ALPHA, 0.0, one, one, T=1, probe=1)
    sp.fused_admm_sprint(A, torch.ones((1, 1, 1)), one, one, RHO_Y, g_th,
                         LAM, ALPHA, one, one, T=1)
    assert seen[1] == want_stop and seen[0] == want_plain


def test_masked_and_inactive_lanes(lanes):
    """An inactive lane runs zero iterations and comes back as it went
    in; a masked x coordinate stays 0."""
    A, Ninv = _stack(lanes, "A"), _stack(lanes, "Ninv")
    h, g, u, v = (_stack(lanes, k) for k in ("h", "g", "u", "v"))
    g_th = torch.tensor([s["g_th"] for s in lanes], dtype=torch.float64)
    uo, vo, t_done, _ = sp.fused_admm_sprint_stop(
        A, Ninv, h, g, RHO_Y, g_th, LAM, ALPHA, 0.0, u, v, T=16, probe=8,
        active=torch.tensor([False, True]))
    assert t_done.tolist() == [0, 16]
    assert torch.equal(uo[0], u[0]) and torch.equal(vo[0], v[0])
    m, n = A.shape[1:]
    mask = torch.ones((2, n))
    mask[:, 3] = 0.0
    op = sp.sprint_operands(A, Ninv, h, g, RHO_Y, 1.0 / (g_th + 1.0), LAM,
                            ALPHA, 0.0, u, v, maskx=mask)
    _, x, _, _ = sp._sprint_compute(op, torch.full((2,), 8), 8)
    assert (x[:, 3] == 0).all() and (x[:, 4] != 0).all()


PROX_POINTS = (-1e-20, -1e-17, -1e-15)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_prox_is_accurate_where_the_reference_guard_is_not(dtype):
    """For small negative arguments the port's prox stays within 1e-6
    relative of the f64 `abip_tpu.hsd.barrier_prox`; the sprint
    kernels' prox (`admm_pallas._prox`, guard 1e-30) returns 1000.0 at
    t = -1e-20 with lam = 1e-4 (the true value is 0.01), and the
    barrier step's f32 plain version (`prox_pallas._ref_impl`, guard
    1e-300, which rounds to 0 in f32) returns 0.0 there.  ROADMAP.md
    queue 3."""
    lam = 1e-4
    t = np.asarray(PROX_POINTS)
    exact = np.asarray(jhsd.barrier_prox(jnp.asarray(t, f64), lam))
    port = sp.prox(torch.tensor(t, dtype=dtype), lam).double().numpy()
    np.testing.assert_allclose(port, exact, rtol=1e-6)
    jdt = jnp.float32 if dtype == torch.float32 else f64
    ref = np.asarray(jap._prox(jnp.asarray(t, jdt), lam), np.float64)
    assert ref[0] == pytest.approx(1000.0, rel=1e-6)
    assert abs(ref[0] - exact[0]) > 1e4 * exact[0]
    if dtype == torch.float32:
        step = jpp._ref_impl(jnp.asarray(t, jnp.float32) / 1.8,
                             jnp.zeros(3, jnp.float32),
                             jnp.zeros(3, jnp.float32), lam, 1.8)[0]
        assert float(step[0]) == 0.0


def test_cuda_wrappers_refuse_cpu_tensors(lanes):
    """The kernel wrappers never run on CPU tensors: they raise."""
    op = sp.sprint_operands(
        _stack(lanes, "A"), _stack(lanes, "Ninv"), _stack(lanes, "h"),
        _stack(lanes, "g"), RHO_Y, 0.5, LAM, ALPHA, 0.0, _stack(lanes, "u"),
        _stack(lanes, "v"))
    t_max = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sp.sprint_stop_cuda(op, t_max, 8)
    with pytest.raises(ValueError, match="CUDA"):
        sp.sprint_cuda(op, t_max)
