"""`abip_tpu_torch.parallel.batched` against `abip_tpu.parallel.batched`.

The port solves a stack of lanes at once; the reference solves each
lane with `device_solve_lp` under the same options (the kwargs of
`tests/test_delta_engine.py:121-127`, engine "delta", eps 1e-6), so its
program comes warm from that test's compile cache.  Both sides run the
delta chunk in f32 with the reductions in another order, so ADMM counts
may differ by a chunk; statuses and IPM counts must agree, and the
objectives to 1e-6 relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu.parallel import batched as jbatched  # noqa: E402
from abip_tpu_torch.parallel import batched  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402
from conftest import random_lp  # noqa: E402

KW = dict(eps=1e-6, max_ipm=200, max_admm=400_000, solver="inverse",
          qres_period=768, avg_period=20, precision="mixed",
          cadence="chunk", engine="delta")
# the port's entry points run on the CUDA card unless told otherwise
DEV = dict(device="cpu")


def _stack(problems):
    return tuple(np.stack(x) for x in zip(*problems))


@pytest.fixture(scope="module")
def smoke3():
    data = [reference_smoke_lp(m=30, n_rand=400, seed=11 + i)
            for i in range(3)]
    res = batched.solve_lp_batch(*_stack(data), **DEV, **KW)
    return data, res


def test_batch_matches_reference_per_lane(smoke3):
    data, res = smoke3
    for i, (A, b, c) in enumerate(data):
        r = jbatched.device_solve_lp(jnp.asarray(A), jnp.asarray(b),
                                     jnp.asarray(c), **KW)
        assert int(res.status[i]) == int(r.status) == 1
        assert int(res.ipm_iters[i]) == int(r.ipm_iters)
        kp, kr = int(res.admm_iters[i]), int(r.admm_iters)
        assert abs(kp - kr) <= max(0.02 * kr, 2 * KW["qres_period"]), (kp, kr)
        assert abs(float(res.pobj[i]) - float(r.pobj)) <= 1e-6 * abs(
            float(r.pobj)), (float(res.pobj[i]), float(r.pobj))
        assert float(res.rel_gap[i]) < 1.05e-6


def test_batch_matches_scipy(smoke3):
    from scipy.optimize import linprog

    data, res = smoke3
    for i, (A, b, c) in enumerate(data):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        assert ref.status == 0
        assert abs(float(res.pobj[i]) - ref.fun) < 1e-5 * (1 + abs(ref.fun))
        x = res.x[i].numpy()
        assert np.abs(A @ x - b).max() < 1e-4 * (1 + np.abs(b).max())


def test_lane_equals_one_lane_solve(smoke3):
    """A lane of the batch ends where a one-lane solve of its instance
    ends: masking freezes the other lanes without touching it.  Counts
    are equal; x agrees to 1e-8 absolute, since a batched product of
    one lane may take another kernel than one of three."""
    data, res = smoke3
    one = batched.solve_lp_batch(*_stack(data[1:2]), **DEV, **KW)
    assert int(one.status[0]) == int(res.status[1])
    assert int(one.ipm_iters[0]) == int(res.ipm_iters[1])
    assert int(one.admm_iters[0]) == int(res.admm_iters[1])
    np.testing.assert_allclose(one.x[0].numpy(), res.x[1].numpy(),
                               rtol=1e-9, atol=1e-8)


def test_mu_stop_exits_at_phase_boundary(smoke3):
    """mu_stop ends the outer loop once the barrier parameter passes it:
    status 0, with the state and mu returned for a continuation."""
    data, res = smoke3
    r = batched.solve_lp_batch(*_stack(data), mu_stop=1e-3, **DEV, **KW)
    assert r.status.tolist() == [0, 0, 0]
    assert (r.mu < 1e-3).all() and (r.mu > 0).all()
    assert (r.ipm_iters < res.ipm_iters).all()
    assert r.u_raw.shape == res.u_raw.shape


@pytest.mark.parametrize("case,status", [("infeasible", -2),
                                         ("unbounded", -1)])
def test_certificates(case, status):
    """The infeasible and unbounded instances of
    `tests/test_delta_engine.py:187-201`."""
    if case == "infeasible":
        A, b, c = [[1.0, 1.0], [1.0, 1.0]], [1.0, 3.0], [1.0, 1.0]
    else:
        A, b, c = [[1.0, -1.0]], [0.0], [-1.0, 0.0]
    r = batched.solve_lp_batch(np.asarray([A]), np.asarray([b]),
                               np.asarray([c]), **DEV, **KW)
    assert int(r.status[0]) == status


def test_tiling_matches_whole_batch():
    """tile=2 over 4 lanes gives the whole-batch result lane by lane."""
    rng = np.random.default_rng(21)
    probs = [random_lp(rng, m=6, n=15) for _ in range(4)]
    kw = dict(KW, qres_period=64)
    whole = batched.solve_lp_batch(*_stack(probs), tile=0, **DEV, **kw)
    tiled = batched.solve_lp_batch(*_stack(probs), tile=2, **DEV, **kw)
    assert tiled.status.tolist() == whole.status.tolist() == [1] * 4
    assert tiled.admm_iters.tolist() == whole.admm_iters.tolist()
    np.testing.assert_allclose(tiled.pobj.numpy(), whole.pobj.numpy(),
                               rtol=1e-9)


def test_pad_instances_and_suite():
    """Mixed shapes pad as the reference pads, and the padded suite
    solves each instance to its scipy objective."""
    from scipy.optimize import linprog

    rng = np.random.default_rng(22)
    probs = [random_lp(rng, m=m, n=n) for m, n in ((5, 12), (7, 16))]
    As, bs, cs, dims = batched.pad_instances(probs)
    jAs, jbs, jcs, jdims = jbatched.pad_instances(probs)
    assert dims == jdims
    for p, r in zip((As, bs, cs), (jAs, jbs, jcs)):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    out = batched.solve_lp_suite(probs, **DEV, **dict(KW, qres_period=64))
    for (A, b, c), o in zip(probs, out):
        ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
        assert o["status"] == 1
        assert o["x"].shape == (A.shape[1],)
        assert abs(o["pobj"] - ref.fun) < 1e-5 * (1 + abs(ref.fun))


@pytest.mark.parametrize("opts", [dict(mesh=object())])
def test_unported_options_raise(opts):
    """Every option of the reference's is ported; a `mesh` that is not
    a `DeviceMesh` (the stand-in for the reference's JAX `Mesh`, held to
    the reference in `tests/test_torch_mesh.py`) raises rather than
    fall back to an unmeshed solve."""
    kw = dict(KW, **opts)
    A, b, c = random_lp(np.random.default_rng(0), m=3, n=6)
    with pytest.raises(TypeError, match="DeviceMesh"):
        batched.solve_lp_batch(A[None], b[None], c[None], **DEV, **kw)


@pytest.mark.parametrize("opts,status", [
    (dict(engine="steps"), 1), (dict(engine="sprint"), 1),
    (dict(engine="sprint2"), 1), (dict(precision="f64"), 1),
    (dict(k_cap=10), 0)])
def test_engines_and_resume_options_run(opts, status):
    """The engines and options of the reference's batched driver run
    from the delta engine's options (parity with the reference:
    `tests/test_torch_batched_sprint.py`); k_cap stops the solve at its
    cap with status 0."""
    A, b, c = random_lp(np.random.default_rng(0), m=3, n=6)
    r = batched.solve_lp_batch(A[None], b[None], c[None], **DEV,
                               **dict(KW, **opts))
    assert r.status.tolist() == [status]
    if status == 0:
        assert 10 <= int(r.admm_iters[0]) < 10 + KW["qres_period"]


def test_option_checks_follow_the_reference():
    """The reference's `ValueError`s: the delta engine needs cadence
    "chunk", the sprint engine precision "mixed"."""
    A, b, c = random_lp(np.random.default_rng(0), m=3, n=6)
    with pytest.raises(ValueError, match="cadence='chunk'"):
        batched.solve_lp_batch(A[None], b[None], c[None], **DEV,
                               **dict(KW, cadence="cond"))
    with pytest.raises(ValueError, match="precision='mixed'"):
        batched.solve_lp_batch(A[None], b[None], c[None], **DEV,
                               **dict(KW, engine="sprint", precision="f64"))


def test_lane_state_from_numpy():
    u = np.arange(7.0)
    st = batched.lane_state_from_numpy(u, u + 1, u * 0, u * 2, 3, 0.5, "cpu")
    assert st.u.shape == (1, 7) and st.u.dtype == torch.float64
    assert st.sj.tolist() == [3] and st.sj.dtype == torch.int32
    assert st.qres.tolist() == [0.5]
    np.testing.assert_array_equal(st.v_sum[0].numpy(), u * 2)
