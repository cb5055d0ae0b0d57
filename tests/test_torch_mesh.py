"""`mesh=` on the port's batch drivers (`solve_lp_batch`,
`solve_lp_suite`, `solve_lp_pdhg_batch`, `solve_qcp_pdhg_batch`) on gloo
groups of CPU processes, `utils/roofline.py`, and the one-instance
`device_solve_lp`, against `abip_tpu` on the CPU mesh of
`tests/conftest.py`.

The reference's own mesh tests with their bars, on groups of 2 and 4
ranks (`tests/torch_gloo.py`): a batch over the mesh Solved within 1e-2
of HiGHS (`tests/test_parallel.py:47-57`), PDHG over the mesh equal to
the unmeshed batch to rtol 1e-8 (`tests/test_pdhg.py:114-146`).  Port
against JAX package: `solve_lp_batch(mesh=..., engine="steps",
precision="f64")` with the reference's mesh call's statuses and counts.
A rank's share runs the single-card driver, so the meshed port equals
the unmeshed port: statuses and counts equal, objectives to 1e-10
relative.  Every rank must return the same bits.  The roofline's byte
and operation counts equal the reference's, and so do its ceilings
under `chip="cpu"`, the one entry both tables hold.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_gloo import Groups, cpu_mesh, run_tasks  # noqa: E402
from tests.torch_gloo import result as rank_result  # noqa: E402

WORLDS = (2, 4)
CPU = dict(device="cpu")
# the delta main path's options at a CPU size (`tests/test_torch_batched.py`)
DELTA_KW = dict(eps=1e-6, max_ipm=200, max_admm=400_000, solver="inverse",
                qres_period=256, avg_period=20, precision="mixed",
                cadence="chunk", engine="delta")
SPRINT2_KW = dict(DELTA_KW, engine="sprint2", endgame="delta", sprint_T=32,
                  sprint_mu_switch=1e-4)


def random_lp(rng, m, n):
    """`tests/conftest.random_lp`: b = A x0, c = A' y0 + s0."""
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return A, A @ x0, A.T @ y0 + s0


def _stack(problems):
    return tuple(np.stack(x) for x in zip(*problems))


def _pdhg_lp_batch():
    """`tests/test_pdhg.py:114-126`'s B=4 batch."""
    B, m, n = 4, 15, 45
    rng = np.random.default_rng(1)
    out = []
    for _ in range(B):
        A = rng.standard_normal((m, n))
        b = A @ (rng.random(n) + 0.5)
        out.append((A, b, A.T @ rng.standard_normal(m) + rng.random(n)
                    + 0.5))
    return _stack(out)


QCP_SPEC = dict(soc=(4,), nonneg=8)


def _pdhg_qcp_batch():
    from benchmarks.conic_mini import randcone

    from abip_tpu.cones import ConeSpec

    insts = [randcone(f"b{s}", 6, ConeSpec(**QCP_SPEC), 20 + s)
             for s in range(4)]
    return tuple(np.stack([i[k] for i in insts]) for k in (1, 2, 3))


def _data(world):
    rng = np.random.default_rng(0)
    return dict(
        steps=_stack([random_lp(rng, 10, 30) for _ in range(world)]),
        delta=_stack([random_lp(np.random.default_rng(40 + i), 10, 30)
                      for i in range(2 * world)]),
        suite=[random_lp(np.random.default_rng(60 + i), 6 + i, 20 + 3 * i)
               for i in range(4)],
        pdhg_lp=_pdhg_lp_batch(), pdhg_qcp=_pdhg_qcp_batch())


ONLY_TWO = ("sprint2", "suite", "pdhg_qcp", "indivisible", "rows_axis")


def _fields(res):
    return {k: None if v is None else v.numpy()
            for k, v in res._asdict().items()}


def _tasks(rank, world, d, part):
    """Every task of `part` on this rank; a task that raises returns its
    traceback (and so fails only its own test)."""
    from abip_tpu_torch.cones import ConeSpec
    from abip_tpu_torch.parallel import solve_lp_batch, solve_lp_suite
    from abip_tpu_torch.pdhg import solve_lp_pdhg_batch, solve_qcp_pdhg_batch

    mesh = cpu_mesh(world, "batch")

    def refused(fn):
        try:
            fn()
        except ValueError as e:
            return f"ValueError: {e}"
        return "no error"

    As, bs, cs = d["delta"]
    tasks = dict(
        steps=lambda: _fields(solve_lp_batch(
            *d["steps"], mesh=mesh, eps=1e-5, engine="steps",
            precision="f64", **CPU)),
        delta=lambda: _fields(solve_lp_batch(*d["delta"], mesh=mesh, **CPU,
                                             **DELTA_KW)),
        sprint2=lambda: _fields(solve_lp_batch(*d["delta"], mesh=mesh, **CPU,
                                               **SPRINT2_KW)),
        suite=lambda: solve_lp_suite(d["suite"], mesh=mesh, **CPU,
                                     **DELTA_KW),
        pdhg_lp=lambda: _fields(solve_lp_pdhg_batch(
            *d["pdhg_lp"], eps=1e-6, mesh=mesh, **CPU)),
        pdhg_qcp=lambda: _fields(solve_qcp_pdhg_batch(
            *d["pdhg_qcp"], ConeSpec(**QCP_SPEC), eps=1e-6,
            precision="f64", mesh=mesh, **CPU)),
        indivisible=lambda: refused(lambda: solve_lp_batch(
            As[:world + 1], bs[:world + 1], cs[:world + 1], mesh=mesh, **CPU,
            **DELTA_KW)),
        rows_axis=lambda: refused(lambda: solve_lp_pdhg_batch(
            *d["pdhg_lp"], mesh=cpu_mesh(world, "rows"), **CPU)),
    )
    return run_tasks({k: f for k, f in tasks.items()
                      if world == 2 or k not in ONLY_TWO}, part)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """`ranks(world)`: (data, every rank's task results) of one group."""
    return Groups(_tasks, _data, tmp_path_factory)


def result(ranks, world, name):
    """(data, rank 0's result of task `name`) of the group of `world`."""
    d, outs = ranks(world)
    return d, rank_result(outs, name)


def _same_lanes(meshed, plain, rel=1e-10):
    """A meshed batch against the unmeshed one: every lane-first field
    present in both, statuses and counts equal, objectives to `rel`."""
    for k in ("status", "ipm_iters", "admm_iters", "k"):
        if k in meshed:
            np.testing.assert_array_equal(meshed[k],
                                          getattr(plain, k).numpy())
    np.testing.assert_allclose(meshed["pobj"], plain.pobj.numpy(), rtol=rel)
    for k, v in meshed.items():
        assert (v is None) == (getattr(plain, k) is None), k
        if v is not None:
            assert v.shape == tuple(getattr(plain, k).shape), k


def _jax_mesh(world):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:world]), ("batch",))


@pytest.mark.parametrize("world", WORLDS)
def test_batch_over_mesh_matches_reference(ranks, world):
    import jax.numpy as jnp
    from scipy.optimize import linprog

    from abip_tpu.parallel.batched import solve_lp_batch as jsolve

    d, got = result(ranks, world, "steps")
    As, bs, cs = d["steps"]
    refs = np.array([linprog(c, A_eq=A, b_eq=b, bounds=(0, None),
                             method="highs").fun
                     for A, b, c in zip(As, bs, cs)])
    assert (got["status"] == 1).all()
    np.testing.assert_allclose(got["pobj"], refs,
                               atol=1e-2 * (1 + np.abs(refs).max()))
    ref = jsolve(jnp.asarray(As), jnp.asarray(bs), jnp.asarray(cs),
                 mesh=_jax_mesh(world), eps=1e-5, engine="steps",
                 precision="f64")
    for k in ("status", "ipm_iters", "admm_iters"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)))
    np.testing.assert_allclose(got["pobj"], np.asarray(ref.pobj), rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_delta_batch_over_mesh_equals_unmeshed(ranks, world):
    from abip_tpu_torch.parallel import solve_lp_batch

    d, got = result(ranks, world, "delta")
    plain = solve_lp_batch(*d["delta"], **CPU, **DELTA_KW)
    assert (got["status"] == 1).all()
    _same_lanes(got, plain)


def test_sprint2_over_mesh_equals_unmeshed(ranks):
    from abip_tpu_torch.parallel import solve_lp_batch

    d, got = result(ranks, 2, "sprint2")
    plain = solve_lp_batch(*d["delta"], **CPU, **SPRINT2_KW)
    assert (got["status"] == 1).all()
    _same_lanes(got, plain)


def test_suite_over_mesh_equals_unmeshed(ranks):
    from abip_tpu_torch.parallel import solve_lp_suite

    d, got = result(ranks, 2, "suite")
    plain = solve_lp_suite(d["suite"], **CPU, **DELTA_KW)
    for g, p, (A, _, _) in zip(got, plain, d["suite"]):
        assert g["status"] == p["status"] == 1
        assert g["admm_iters"] == p["admm_iters"]
        assert g["pobj"] == pytest.approx(p["pobj"], rel=1e-10)
        assert g["x"].shape == (A.shape[1],)


@pytest.mark.parametrize("world", WORLDS)
def test_pdhg_batch_over_mesh(ranks, world):
    from abip_tpu.pdhg import solve_lp_pdhg_batch as jsolve

    from abip_tpu_torch.pdhg import solve_lp_pdhg_batch

    d, got = result(ranks, world, "pdhg_lp")
    plain = solve_lp_pdhg_batch(*d["pdhg_lp"], eps=1e-6, **CPU)
    assert (got["status"] == 1).all()
    np.testing.assert_allclose(got["pobj"], plain.pobj.numpy(), rtol=1e-8)
    _same_lanes(got, plain, rel=1e-8)
    ref = jsolve(*d["pdhg_lp"], eps=1e-6, mesh=_jax_mesh(world))
    np.testing.assert_allclose(got["pobj"], np.asarray(ref.pobj), rtol=1e-8)


def test_qcp_pdhg_batch_over_mesh(ranks):
    from abip_tpu.cones import ConeSpec as JSpec
    from abip_tpu.pdhg import solve_qcp_pdhg_batch as jsolve

    from abip_tpu_torch.cones import ConeSpec
    from abip_tpu_torch.pdhg import solve_qcp_pdhg_batch

    d, got = result(ranks, 2, "pdhg_qcp")
    plain = solve_qcp_pdhg_batch(*d["pdhg_qcp"], ConeSpec(**QCP_SPEC),
                                 eps=1e-6, precision="f64", **CPU)
    _same_lanes(got, plain, rel=1e-8)
    ref = jsolve(*d["pdhg_qcp"], JSpec(**QCP_SPEC), eps=1e-6,
                 precision="f64", mesh=_jax_mesh(2))
    np.testing.assert_array_equal(got["status"], np.asarray(ref.status))
    np.testing.assert_allclose(got["pobj"], np.asarray(ref.pobj), rtol=1e-8)


@pytest.mark.parametrize("task,match", [
    ("indivisible", "ValueError: a batch of 3 lanes must be divisible by "
                    "the mesh size 2"),
    ("rows_axis", "ValueError: mesh has no axis 'batch'"),
])
def test_mesh_refusals(ranks, task, match):
    _, msg = result(ranks, 2, task)
    assert msg.startswith(match), msg


def test_mesh_needs_a_device_mesh():
    from abip_tpu_torch.parallel import solve_lp_batch
    from abip_tpu_torch.pdhg import solve_qcp_pdhg_batch

    As, bs, cs = _stack([random_lp(np.random.default_rng(0), 3, 6)])
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_lp_batch(As, bs, cs, mesh=object(), **CPU)
    from abip_tpu_torch.cones import ConeSpec

    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_qcp_pdhg_batch(As, bs, cs, ConeSpec(nonneg=6), mesh="batch",
                             **CPU)


# --------------------------------------------------------------------- #
# device_solve_lp on one instance                                        #
# --------------------------------------------------------------------- #
def test_device_solve_lp_takes_one_instance():
    """`tests/test_parallel.py:32-37`: one LP, unbatched fields, the
    reference's counts (f64 steps engine, its defaults)."""
    import jax.numpy as jnp
    from scipy.optimize import linprog

    from abip_tpu.parallel.batched import device_solve_lp as jsolve

    from abip_tpu_torch.parallel import device_solve_lp

    A, b, c = random_lp(np.random.default_rng(0), 12, 40)
    ref = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun
    res = device_solve_lp(*(torch.as_tensor(x) for x in (A, b, c)), eps=1e-6)
    assert res.x.shape == (40,) and res.y.shape == (12,)
    assert res.status.shape == () and res.u_raw.shape == (53,)
    assert int(res.status) == 1
    assert float(res.pobj) == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    r = jsolve(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), eps=1e-6)
    assert (int(res.ipm_iters), int(res.admm_iters)) == (
        int(r.ipm_iters), int(r.admm_iters))
    assert float(res.pobj) == pytest.approx(float(r.pobj), rel=1e-9)
    lane = device_solve_lp(*(torch.as_tensor(x)[None] for x in (A, b, c)),
                           eps=1e-6)
    for one, batch in zip(res, lane):
        assert torch.equal(one, batch[0])


def test_device_solve_result_handoff_fields_default_to_none():
    from abip_tpu.parallel.batched import DeviceSolveResult as JResult

    from abip_tpu_torch.parallel.batched import DeviceSolveResult

    head = [torch.zeros(1)] * 11
    r = DeviceSolveResult(*head)
    assert r._fields == JResult._fields
    assert all(getattr(r, f) is None for f in r._fields[11:])


# --------------------------------------------------------------------- #
# utils/roofline.py                                                      #
# --------------------------------------------------------------------- #
LP_CASES = [dict(m=50, n=2000), dict(m=50, n=2000, precision="f64"),
            dict(m=200, n=3000, qres_period=64, avg_period=20),
            dict(m=7, n=11, qres_period=3, avg_period=4, precision="f32")]
QCP_CASES = [dict(m=340, n=1020), dict(m=600, n=1020, precision="f64"),
             dict(m=30, n=100, inner_crit_period=8, form="primal"),
             dict(m=30, n=100, form="dual")]


@pytest.mark.parametrize("kind,case", [("lp", c) for c in LP_CASES]
                         + [("qcp", c) for c in QCP_CASES])
def test_roofline_matches_reference(kind, case):
    from abip_tpu.utils import roofline as jroof

    from abip_tpu_torch.utils import roofline

    name = f"{kind}_iteration_cost"
    ref = getattr(jroof, name)(**case, chip="cpu")
    got = getattr(roofline, name)(**case, chip="cpu")
    assert got.bytes_moved == ref.bytes_moved
    assert got.flops == ref.flops
    assert got.ceiling_iters_per_sec_bw == pytest.approx(
        ref.ceiling_iters_per_sec_bw, rel=1e-15)
    assert got.ceiling_iters_per_sec_flops == pytest.approx(
        ref.ceiling_iters_per_sec_flops, rel=1e-15)
    card = getattr(roofline, name)(**case)          # the H100 by default
    assert card.bytes_moved == ref.bytes_moved
    assert card.ceiling_iters_per_sec_bw == pytest.approx(
        3.35e12 / ref.bytes_moved, rel=1e-15)
    peak = 34e12 if case.get("precision") == "f64" else 67e12
    assert card.ceiling_iters_per_sec_flops == pytest.approx(
        peak / ref.flops, rel=1e-15)
    assert card.ceiling_iters_per_sec == min(
        card.ceiling_iters_per_sec_bw, card.ceiling_iters_per_sec_flops)


def test_roofline_holds_no_tpu_constant():
    from abip_tpu_torch.utils import roofline

    assert set(roofline.CHIPS) == {"h100", "cpu"}
    with pytest.raises(KeyError):
        roofline.lp_iteration_cost(50, 2000, chip="tpu_v5e")
