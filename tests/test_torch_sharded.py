"""`abip_tpu_torch.parallel.sharded`, `LPWorkspace.shard` and
`ConicWorkspace.shard` on gloo groups of CPU processes, against
`abip_tpu` on the CPU mesh of `tests/conftest.py`.

The reference's own sharded tests (`tests/test_parallel.py:60-85`,
`:302-362`, `:500-540`) with their bars, on groups of 2 and 4 ranks
(`tests/torch_gloo.py`): the sharded KKT solve against the dense one at
atol 1e-7; `shard()` Solved within 1e-3 of HiGHS; its CG solve within
max(5, 5%) of the unsharded CG solve's ADMM count; its dense solve with
the unsharded dense solve's ADMM count and pobj to 1e-9 relative; the
conic shard within 1e-4 of the known optimum and max(5, 5%) of the
unsharded CG solve's count.  Port against JAX package, f64:
`sharded_normal_matvec` against the reference's under `shard_map` to
1e-12 of scale, and `sharded_pcg` to 1e-12 relative in norm with equal
CG counts (on rho_y I + AA' of a 32 x 200 A: on the worse-conditioned
32 x 60 A the two packages' 4-way sums, added in other orders, part by
1.2e-12 after 20 CG iterations); the sharded dense
`LPWorkspace` against the reference's, equal status, IPM and ADMM counts
and pobj to 1e-9 relative.  Every rank must return the same bits.

Each task runs once per group size (`ranks`, module-scoped): the conic
and the CG whole solves, each with its unsharded run, in a group of
their own, every other task in a third; each task's data is made here
with numpy from a seed and sent to the ranks, whose code imports only
torch, numpy and the port.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests.torch_gloo import Groups, cpu_mesh, run_tasks  # noqa: E402
from tests.torch_gloo import result as rank_result  # noqa: E402

WORLDS = (2, 4)
RHO_Y = 1e-3


def random_lp(rng, m, n):
    """`tests/conftest.random_lp`: b = A x0, c = A' y0 + s0."""
    A = rng.standard_normal((m, n))
    x0 = rng.random(n) + 0.5
    y0 = rng.standard_normal(m)
    s0 = rng.random(n) + 0.5
    return A, A @ x0, A.T @ y0 + s0


def _conic_data(m, spec, name, seed):
    from benchmarks.conic_mini import randcone

    from abip_tpu.cones import ConeSpec

    _, A, b, c, _, star = randcone(name, m, ConeSpec(**spec), seed)
    return A, b, c, spec, star


# The whole solves: one instance for both group sizes, m divisible by 4
# (the reference's m = 8 x devices): a sharded CPU solve pays a gloo
# round trip between processes at every product with A.
LP_M = 16
CONIC_M = 8


def _data(world):
    m = 8 * world
    rng = np.random.default_rng(0)
    A_kkt = rng.standard_normal((m, 200))
    A_mv = rng.standard_normal((m, 60))
    return dict(
        A_mv=A_mv, y_mv=rng.standard_normal(m), b_mv=rng.standard_normal(m),
        A_kkt=A_kkt, w_y=rng.standard_normal(m), w_x=rng.standard_normal(200),
        lp200=random_lp(np.random.default_rng(0), LP_M, 200),
        lp160=random_lp(np.random.default_rng(1), LP_M, 160),
        conic=_conic_data(CONIC_M, dict(soc=(10,), rsoc=(5,),
                                        nonneg=3 * CONIC_M + 9), "sh", 6),
        conic_small=_conic_data(8, dict(soc=(5,), nonneg=19), "d", 3))


# what each group size runs (`shard_default` and the refusals only once)
ONLY_TWO = ("kkt_bad_rows", "shard_default", "conic_requires_cg", "sparse",
            "bad_linsys", "dense_of_cg", "device_type")


# the two longest whole sharded solves, each with its unsharded run, in a
# group of its own (`tests/torch_gloo.Groups`)
PARTS = (("conic_base", "conic_shard"), ("cg_base", "cg_shard"))


def _sol(s):
    return dict(status=s.status_name, pobj=s.pobj, ipm=s.ipm_iters,
                admm=s.admm_iters, x=s.x)


def _tasks(rank, world, d, part):
    """Every task of `part` on this rank; a task that raises returns its
    traceback (and so fails only its own test)."""
    import dataclasses

    import scipy.sparse as sp
    from torch.distributed.device_mesh import DeviceMesh

    from abip_tpu_torch import (ConeSpec, ConicWorkspace, LPWorkspace,
                                Settings, conic_defaults)
    from abip_tpu_torch.parallel import sharded

    mesh = cpu_mesh(world, "rows")
    group = mesh.get_group("rows")
    CPU = dict(device="cpu")

    def rows_of(m):
        return slice(rank * (m // world), (rank + 1) * (m // world))

    def t(x):
        return torch.as_tensor(x)

    def gathered(part):
        return sharded.all_gather_rows(part, group, world).numpy()

    def matvec():
        r = rows_of(d["A_mv"].shape[0])
        return gathered(sharded.sharded_normal_matvec(
            t(d["A_mv"][r]), t(d["y_mv"][r]), RHO_Y, group))

    def pcg():
        A = d["A_kkt"]
        r = rows_of(A.shape[0])
        M = 1.0 / (RHO_Y + (A * A).sum(1))
        x, its = sharded.sharded_pcg(t(A[r]), t(d["b_mv"][r]), t(M[r]),
                                     RHO_Y, 1e-10, 500, group)
        return gathered(x), its

    def kkt():
        solve = sharded.make_sharded_kkt_solver(d["A_kkt"], RHO_Y, mesh,
                                                tol=1e-11, max_iters=1000)
        z_y, z_x, its = solve(d["w_y"], d["w_x"])
        return z_y.numpy(), z_x.numpy(), its

    def refused(fn):
        try:
            fn()
        except (ValueError, TypeError) as e:
            return f"{type(e).__name__}: {e}"
        return "no error"

    def lp(key, stgs, **shard):
        ws = LPWorkspace(*d[key], stgs, **CPU)
        if shard:
            ws.shard(mesh, **shard)
        out = _sol(ws.solve())
        out["chol"] = ws.ops.chol is not None
        return out

    def conic(shard):
        A, b, c, spec, _ = d["conic"]
        s = dataclasses.replace(conic_defaults(), eps=1e-6, linsys="cg")
        ws = ConicWorkspace(A, b, c, ConeSpec(**spec), settings=s, **CPU)
        if shard:
            ws.shard(mesh)
        return _sol(ws.solve())

    def cuda_mesh():
        return DeviceMesh("cuda", list(range(world)),
                          mesh_dim_names=("rows",), _init_backend=False)

    A, b, c = d["lp200"]
    m = A.shape[0]
    tasks = dict(
        matvec=matvec, pcg=pcg, kkt=kkt,
        kkt_bad_rows=lambda: refused(lambda: sharded.make_sharded_kkt_solver(
            d["A_kkt"][:4 * world + 1, :20], RHO_Y, mesh)),
        shard_default=lambda: lp("lp200", Settings(eps=1e-5, adaptive=False),
                                 linsys="cg"),
        shard_divisible=lambda: refused(lambda: LPWorkspace(
            A[:m - 1], b[:m - 1], c, Settings(eps=1e-4), **CPU).shard(mesh)),
        cg_base=lambda: lp("lp160", Settings(eps=1e-6, adaptive=False,
                                             linsys="cg")),
        cg_shard=lambda: lp("lp160", Settings(eps=1e-6, adaptive=False,
                                              linsys="cg"), linsys="cg"),
        dense_base=lambda: lp("lp160", Settings(eps=1e-6, adaptive=False)),
        dense_shard=lambda: lp("lp160", Settings(eps=1e-6, adaptive=False),
                               linsys="dense"),
        conic_base=lambda: conic(False), conic_shard=lambda: conic(True),
        conic_requires_cg=lambda: refused(lambda: ConicWorkspace(
            *d["conic_small"][:3], ConeSpec(**d["conic_small"][3]),
            **CPU).shard(mesh)),
        sparse=lambda: refused(lambda: LPWorkspace(
            sp.csr_matrix(A), b, c, Settings(eps=1e-4), **CPU).shard(mesh)),
        bad_linsys=lambda: refused(lambda: LPWorkspace(
            A, b, c, Settings(eps=1e-4), **CPU).shard(mesh, linsys="chol")),
        dense_of_cg=lambda: refused(lambda: LPWorkspace(
            A, b, c, Settings(eps=1e-4, linsys="cg"), **CPU).shard(
                mesh, linsys="dense")),
        device_type=lambda: refused(lambda: LPWorkspace(
            A, b, c, Settings(eps=1e-4), **CPU).shard(cuda_mesh())),
    )
    return run_tasks({k: f for k, f in tasks.items()
                      if world == 2 or k not in ONLY_TWO}, part)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """`ranks(world)`: (data, every rank's task results) of one group."""
    return Groups(_tasks, _data, tmp_path_factory, parts=PARTS)


def result(ranks, world, name):
    """(data, rank 0's result of task `name`) of the group of `world`."""
    d, outs = ranks(world)
    return d, rank_result(outs, name)


def _jax_mesh(world):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:world]), ("rows",))


def _shard_map(fn, world, in_specs, out_specs):
    import jax
    from jax import shard_map

    return jax.jit(shard_map(fn, mesh=_jax_mesh(world), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _highs(A, b, c):
    from scipy.optimize import linprog

    return linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs").fun


@pytest.mark.parametrize("world", WORLDS)
def test_normal_matvec_matches_reference(ranks, world):
    from jax.sharding import PartitionSpec as P

    from abip_tpu.parallel.sharded import sharded_normal_matvec

    d, got = result(ranks, world, "matvec")
    A, y = d["A_mv"], d["y_mv"]
    ref = np.asarray(_shard_map(
        lambda A, y: sharded_normal_matvec(A, y, RHO_Y, "rows"), world,
        (P("rows", None), P("rows")), P("rows"))(A, y))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * abs(ref).max())
    np.testing.assert_allclose(got, RHO_Y * y + A @ (A.T @ y), rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_pcg_matches_reference(ranks, world):
    from jax.sharding import PartitionSpec as P

    from abip_tpu.parallel.sharded import sharded_pcg

    d, (x, its) = result(ranks, world, "pcg")
    A, b = d["A_kkt"], d["b_mv"]
    M = 1.0 / (RHO_Y + (A * A).sum(1))
    ref, ref_its = _shard_map(
        lambda A, b, M: sharded_pcg(A, b, M, RHO_Y, 1e-10, 500, "rows"),
        world, (P("rows", None), P("rows"), P("rows")),
        (P("rows"), P()))(A, b, M)
    ref = np.asarray(ref)
    assert its == int(ref_its) > 0
    rel = np.linalg.norm(x - ref) / np.linalg.norm(ref)
    assert rel <= 1e-12, rel


@pytest.mark.parametrize("world", WORLDS)
def test_kkt_solver_matches_dense(ranks, world):
    d, (z_y, z_x, its) = result(ranks, world, "kkt")
    A = d["A_kkt"]
    m, n = A.shape
    K = np.block([[RHO_Y * np.eye(m), A], [A.T, -np.eye(n)]])
    z = np.linalg.solve(K, np.concatenate([d["w_y"], d["w_x"]]))
    np.testing.assert_allclose(z_y, z[:m], atol=1e-7)
    np.testing.assert_allclose(z_x, z[m:], atol=1e-7)
    assert 0 < its < 1000


def test_kkt_solver_rejects_bad_row_count(ranks):
    _, msg = result(ranks, 2, "kkt_bad_rows")
    assert msg.startswith("ValueError") and "must divide" in msg, msg


def test_workspace_shard_solves(ranks):
    d, sol = result(ranks, 2, "shard_default")
    ref = _highs(*d["lp200"])
    assert sol["status"].startswith("Solved")
    assert sol["pobj"] == pytest.approx(ref, abs=1e-3 * (1 + abs(ref)))
    assert not sol["chol"]


def test_workspace_shard_refuses_indivisible_rows(ranks):
    _, msg = result(ranks, 4, "shard_divisible")
    assert "must be divisible by the mesh size 4" in msg
    assert msg.startswith("ValueError") and "divisible" in msg, msg


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cg_tracks_unsharded(ranks, world):
    d, base = result(ranks, world, "cg_base")
    _, sh = result(ranks, world, "cg_shard")
    ref = _highs(*d["lp160"])
    assert sh["status"].startswith("Solved")
    assert sh["pobj"] == pytest.approx(ref, abs=1e-4 * (1 + abs(ref)))
    assert abs(sh["admm"] - base["admm"]) <= max(5, 0.05 * base["admm"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dense_reproduces_unsharded(ranks, world):
    _, base = result(ranks, world, "dense_base")
    _, sh = result(ranks, world, "dense_shard")
    assert sh["chol"]
    assert sh["status"].startswith("Solved")
    assert sh["admm"] == base["admm"]
    assert sh["pobj"] == pytest.approx(base["pobj"], rel=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dense_matches_reference(ranks, world):
    import abip_tpu
    from abip_tpu.lp import LPWorkspace as JWorkspace

    d, sh = result(ranks, world, "dense_shard")
    w = JWorkspace(*d["lp160"], abip_tpu.Settings(eps=1e-6, adaptive=False))
    ref = w.shard(_jax_mesh(world), linsys="dense").solve()
    assert sh["status"] == ref.status_name
    assert (sh["ipm"], sh["admm"]) == (ref.ipm_iters, ref.admm_iters)
    assert sh["pobj"] == pytest.approx(ref.pobj, rel=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_conic_shard_tracks_unsharded(ranks, world):
    d, base = result(ranks, world, "conic_base")
    _, sh = result(ranks, world, "conic_shard")
    star = d["conic"][4]
    assert sh["status"].startswith("Solved")
    assert sh["pobj"] == pytest.approx(star, abs=1e-4 * (1 + abs(star)))
    assert abs(sh["admm"] - base["admm"]) <= max(5, 0.05 * base["admm"])


@pytest.mark.parametrize("task,match", [
    ("conic_requires_cg", "ValueError: .*CG Schur"),
    ("sparse", "ValueError: .*requires dense operands"),
    ("bad_linsys", "ValueError: linsys must be 'cg' or 'dense'"),
    ("dense_of_cg", "ValueError: no cached factor"),
    ("device_type", "ValueError: the mesh runs on 'cuda'"),
])
def test_shard_refusals(ranks, task, match):
    import re

    _, msg = result(ranks, 2, task)
    assert re.match(match, msg), msg


def test_shard_needs_a_device_mesh():
    """Without a `DeviceMesh` (the stand-in for the reference's `Mesh`)
    every multi-card entry point raises `TypeError`."""
    from abip_tpu_torch import LPWorkspace, Settings
    from abip_tpu_torch.parallel.sharded import make_sharded_kkt_solver

    A, b, c = random_lp(np.random.default_rng(0), 8, 20)
    ws = LPWorkspace(A, b, c, Settings(eps=1e-4), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        ws.shard(object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_sharded_kkt_solver(A, RHO_Y, None)
