"""The LASSO operator's PCG iteration as F1 and F2, on the CPU.

On a card `linsys.schur._FusedPCGBlock` runs each iteration of the
Schur PCG's block on `problems.lasso_operator`'s products as the two
kernels of `csrc/lasso_pcg.cu`; here their plain versions
(`ops.lasso_pcg.f1_plain`, `f2_plain`: the kernels' algebra, row by row
in F1's partition and order of sums) are held to `cg._pcg_iteration`
over `CGSchurSolver._S`, their masking to `cg.pcg_block`'s, whole solves
through the fused block to the eager ones, the dispatch to the LASSO
operator alone, and the benchmark's reader of `qcp.cg_fused_iter_share`
to span trees made up here.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import lasso_pcg_cases as cases  # noqa: E402
from abip_tpu_torch.linsys import cg, schur  # noqa: E402
from abip_tpu_torch.linsys.schur import CGSchurSolver  # noqa: E402
from abip_tpu_torch.ops import lasso_pcg  # noqa: E402
from abip_tpu_torch.problem import LinearOperator  # noqa: E402
from abip_tpu_torch.problems import lasso_operator, solve_lasso  # noqa: E402
from abip_tpu_torch.utils import graphs, profiling  # noqa: E402
from benchmarks.generate import lasso_instance  # noqa: E402

f64 = torch.float64
SHAPES = [(20, 100), (200, 1000)]
ACTIVE = lasso_pcg.H100_ACTIVE


# ------------------------------------------------------------- the plan

@pytest.mark.parametrize("m, n", SHAPES + [(1000, 5000), (5, 8185)])
def test_plan_cuts_every_row_once(m, n):
    """F1's CTAs hold consecutive row ranges that cover [0, m) once and
    differ by at most one row; a CTA gets ROWS_MIN rows or more unless
    one cluster is all there is."""
    pl = lasso_pcg.plan(m, n, ACTIVE)
    spans = lasso_pcg.rows(pl)
    assert len(spans) == pl.clusters * pl.cluster
    assert spans[0][0] == 0 and spans[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    sizes = [e - f for f, e in spans]
    assert max(sizes) - min(sizes) <= 1
    assert pl.clusters == 1 or min(sizes) >= lasso_pcg.ROWS_MIN
    assert 1 <= pl.clusters <= ACTIVE


def test_plan_refuses_what_the_kernels_cannot_hold():
    """F2 holds a unit a thread in one cluster of at most CLUSTER CTAs (a
    portable cluster), so n + 2 + m <= 8192, which keeps F1 within
    MAX_COLS columns a thread; the plan's F2 cluster is the least that
    holds its units."""
    most = lasso_pcg.CLUSTER * lasso_pcg.THREADS
    assert most - 3 <= lasso_pcg.MAX_COLS * lasso_pcg.THREADS
    for m, n in ((1, most - 3), (most - 3, 1), (1000, most - 1002)):
        assert lasso_pcg.fits(m, n)
        assert not lasso_pcg.fits(m + 1, n) and not lasso_pcg.fits(m, n + 1)
        assert lasso_pcg.plan(m, n, ACTIVE).f2_cluster == lasso_pcg.CLUSTER
    for m, n in ((5000, 5000), (10, most), (0, 100), (100, 0)):
        assert not lasso_pcg.fits(m, n)
        with pytest.raises(ValueError):
            lasso_pcg.plan(m, n, ACTIVE)
    assert lasso_pcg.plan(1000, 5000, ACTIVE).f2_cluster == 6
    assert lasso_pcg.plan(20, 100, ACTIVE).f2_cluster == 1


# ------------------------------------------------- the twin's algebra

@pytest.mark.parametrize("m, n", SHAPES)
@pytest.mark.parametrize("steps, bar", [(1, 1e-12), (cg.PCG_BLOCK, 1e-10)])
def test_twin_matches_the_pcg_iteration(m, n, steps, bar):
    """From one state, F1 then F2 give `cg._pcg_iteration`'s x, r, p and
    <z, r> within 1e-12 relative after one iteration and 1e-10 after a
    block; the count and the flag follow, and w is the new p's."""
    solver, b = cases.system(m, n)
    state = cases.start(solver, b)
    fused = cases.Fused(solver, state, lasso_pcg.plan(m, n, ACTIVE))
    got = fused.slot(steps)
    want = cases.eager(solver, state, steps)
    for k in cases.STATE:
        assert cases.rel(got[k], want[k]) <= bar, k
    assert got["flag"].tolist() == [1, steps]
    E, p, h = solver.A_op.operands["E"], got["p"], 2 + m
    assert torch.equal(got["w"],
                       p[h:h + n] / E[h:h + n] - p[h + n:] / E[h + n:])


@pytest.mark.parametrize("m, n", SHAPES)
def test_twin_s_apply_is_the_operators(m, n):
    """F1's v and partial rows, summed as F2 sums them, give `_S`'s
    S p within 1e-14 relative, block by block."""
    solver, b = cases.system(m, n, seed=3)
    state = cases.start(solver, b)
    pl = lasso_pcg.plan(m, n, ACTIVE)
    fused = cases.Fused(solver, state, pl)
    fused.f1()
    t, o = fused.t, solver.A_op.operands
    xt = sum(t["partials"][c] for c in range(pl.clusters))
    p = state["p"]
    u0 = (solver.ry_inv[:1] * ((p[:1] / o["E"][:1]) / o["D"][:1])) \
        / o["D"][:1]
    got = torch.cat([u0, 0 * u0, t["v"], xt, -xt]) / o["E"] \
        + solver.rho_x * p
    want = solver._S(p)
    h = 2 + m
    for sl in (slice(0, 2), slice(2, h), slice(h, h + n), slice(h + n, None)):
        assert cases.rel(got[sl], want[sl]) <= 1e-14


@pytest.mark.parametrize("stage", ["f1", "f2", "slot"])
def test_a_stopped_loop_is_left_bit_for_bit(stage):
    """Where the flag says the loop has stopped, F1 and F2 change
    nothing: x, r, p, <z, r>, the count, w, v and the partial rows stay
    as they were, bit for bit."""
    solver, b = cases.system(20, 100)
    fused = cases.Fused(solver, cases.start(solver, b),
                        lasso_pcg.plan(20, 100, ACTIVE))
    fused.slot(3)
    fused.t["flag"][0] = 0
    before = {k: v.clone() for k, v in fused.t.items()}
    for _ in range(2):
        getattr(fused, stage)()
    assert all(torch.equal(before[k], v) for k, v in fused.t.items())
    assert fused.t["flag"].tolist() == [0, 3]


def _stop_tol(solver, state, ks):
    """(k, a tolerance at which `pcg` stops after exactly k iterations)
    for the first k of `ks` at which ||r|| falls below every earlier
    one."""
    st = tuple(state[key] for key in cases.STATE)
    norms = [float(torch.linalg.vector_norm(st[1]))]
    for _ in range(max(ks)):
        st = cg._pcg_iteration(solver._S, solver.M, *st)
        norms.append(float(torch.linalg.vector_norm(st[1])))
    k = next(k for k in ks if norms[k] < min(norms[:k]))
    return k, torch.tensor((norms[k] + min(norms[:k])) / 2, dtype=f64)


@pytest.mark.parametrize("case", ["mid-block", "block-boundary", "cap"])
def test_fused_block_stops_where_pcg_stops(monkeypatch, case):
    """`_FusedPCGBlock` run uncaptured, read once a block, stops after
    `pcg`'s count (at a tolerance inside a block, at a block's edge, at
    the cap) with its x within 1e-10, in max(1, ceil(count / 10))
    blocks, and notes every iteration as fused."""
    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    solver, b = cases.system(200, 1000, seed=4)
    x0 = torch.zeros_like(b)
    B = cg.PCG_BLOCK
    if case == "cap":
        want_its, tol, solver.max_iters = 7, torch.tensor(0.0, dtype=f64), 7
    else:
        ks = ([k for k in range(B + 1, 4 * B) if k % B] if case == "mid-block"
              else [B, 2 * B, 3 * B, 4 * B])
        want_its, tol = _stop_tol(solver, cases.start(solver, b), ks)
    x_ref, its_ref = cg.pcg(solver._S, solver.M, b, x0, tol,
                            solver.max_iters)
    assert its_ref == want_its
    block = schur._FusedPCGBlock(solver, b)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        x, its = block.solve(solver, b, x0, tol)
    spans = [s for s in profiling.spans() if s.name == "qcp.cg_block"]
    profiling.clear()
    assert its == its_ref
    assert cases.rel(x, x_ref) <= 1e-10
    assert len(spans) == max(1, -(-its // B))
    assert [s.attrs["fused_iters"] for s in spans] == [
        s.attrs["iters"] for s in spans]


# ------------------------------------------------------- whole solves

def _lasso(m=20, n=100, seed=0):
    return solve_lasso(*lasso_instance(m=m, n=n, seed=seed), eps=1e-3,
                       matrix_free=True, device="cpu")


def test_solves_through_the_fused_block(monkeypatch):
    """A matrix-free LASSO whose PCG runs as fused blocks (both
    engagements made to say yes): status and IPM count as the eager
    solve's, the ADMM count within 1, the PCG iterations within 1%, the
    objective within 1e-6 relative; every block's iterations are fused
    and add up to the root's `cg_iters`."""
    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    _, obj_e, eager = _lasso()
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    monkeypatch.setattr(schur, "_fused_engages", lambda *a: True)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, obj_f, fused = _lasso()
    spans = profiling.spans()
    profiling.clear()
    assert fused.status_name == eager.status_name == "Solved"
    assert fused.ipm_iters == eager.ipm_iters
    assert abs(fused.admm_iters - eager.admm_iters) <= 1
    cg_f = fused.avg_cg_iters * fused.admm_iters
    cg_e = eager.avg_cg_iters * eager.admm_iters
    assert abs(cg_f - cg_e) <= 0.01 * cg_e
    assert abs(obj_f - obj_e) <= 1e-6 * abs(obj_e)
    (root,) = [s for s in spans if s.parent_id is None]
    blocks = [s for s in spans if s.name == "qcp.cg_block"]
    assert sum(s.attrs["fused_iters"] for s in blocks) \
        == sum(s.attrs["iters"] for s in blocks) == root.attrs["cg_iters"]
    assert all(isinstance(g, schur._FusedPCGBlock)
               for g in schur._GRAPHS._graphs.values())


@pytest.mark.parametrize("m, n", SHAPES)
def test_fused_block_matches_the_reference_cg(monkeypatch, m, n):
    """`CGSchurSolver.solve` with its PCG as fused blocks (both
    engagements made to say yes) against the JAX package's
    `CGSchurSolver` over its own `lasso_operator`, on the same LASSO data,
    rho_y, rho_x, right-hand sides and tolerance ladder, at the bar the
    eager port is held to (`test_torch_qcp.test_cg_schur_matches_
    reference`): equal iteration counts, z within 1e-6 of the exact
    solve's scale, and at most twice the reference's distance from it.
    rho_x of order one keeps every stop above the rounding floor, as
    that test's rho_y = 0.1 does: at rho_x ~ 1e-2 the eager port too
    stops an iteration or more from the reference at the setup solve's
    1e-9 tolerance."""
    import jax.numpy as jnp

    from abip_tpu.linsys import schur as jschur
    from abip_tpu.problems import lasso as jlasso

    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    monkeypatch.setattr(schur, "_fused_engages", lambda *a: True)
    data = lasso_instance(m=m, n=n, seed=5)
    op = lasso_operator(*data, device="cpu").A
    p, q = op.m, op.n
    A = torch.stack([op.rmatvec(e) for e in torch.eye(p, dtype=f64)]).numpy()
    rng = np.random.default_rng(6)
    ry = 1.0 / (rng.random(p) + 0.5)
    rx = rng.random(q) + 0.5
    diag = rx + (A * A / ry[:, None]).sum(0)
    wy, wx = rng.standard_normal(p), rng.standard_normal(q)
    ref = jschur.CGSchurSolver(
        jlasso.lasso_operator(*data).A, None, jnp.asarray(ry),
        jnp.asarray(rx), jnp.asarray(diag),
        tol_ladder=jschur.LASSO_PCG_LADDER)
    t = torch.as_tensor
    port = CGSchurSolver(op, None, t(ry), t(rx), t(diag),
                         tol_ladder=schur.LASSO_PCG_LADDER)
    S = A.T @ (A / ry[:, None]) + np.diag(rx)
    ex_x = np.linalg.solve(S, wx + A.T @ (wy / ry))
    ex_y = (wy - A @ ex_x) / ry
    warm = rng.standard_normal(q)
    for k, w, hint in ((-1, None, None), (0, None, 50.0), (3, warm, 400.0),
                       (0, None, None)):
        rzy, rzx, rits = ref.solve(
            jnp.asarray(wy), jnp.asarray(wx), iter_count=k,
            warm_start=None if w is None else jnp.asarray(w), tol_hint=hint)
        zy, zx, its = port.solve(t(wy), t(wx), iter_count=k,
                                 warm_start=None if w is None else t(w),
                                 tol_hint=hint)
        assert its == int(rits) and its > 0
        for got, r, e in ((zx, rzx, ex_x), (zy, rzy, ex_y)):
            r, got, sc = np.asarray(r), got.numpy(), np.abs(e).max()
            assert np.abs(got - r).max() <= 1e-6 * sc
            assert (np.abs(got - e).max()
                    <= 2.0 * np.abs(r - e).max() + 1e-12 * sc)
    graphs_made = list(schur._GRAPHS._graphs.values())
    assert graphs_made and all(isinstance(g, schur._FusedPCGBlock)
                               for g in graphs_made)


def test_torch_op_blocks_note_no_fused_iterations(monkeypatch):
    """Blocks of the torch-op body note `fused_iters` 0."""
    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _lasso(m=8, n=30, seed=2)
    blocks = [s for s in profiling.spans() if s.name == "qcp.cg_block"]
    profiling.clear()
    assert blocks and all(s.attrs["fused_iters"] == 0 for s in blocks)
    assert sum(s.attrs["iters"] for s in blocks) > 0


# ------------------------------------------------------ where it engages

class _Card:
    """A stand-in rhs on a card."""
    is_cuda = True

    def __init__(self, dtype=f64):
        self.dtype = dtype


def _solver(kind):
    X, y, lam = lasso_instance(m=8, n=20, seed=1)
    op = lasso_operator(X, y, lam, device="cpu").A
    q, p = op.n, op.m
    Q_op = None
    if kind == "dense":
        op = LinearOperator.from_dense(torch.as_tensor(
            np.random.default_rng(0).standard_normal((p, q))))
    elif kind == "sharded":
        op = op.with_operands(op.operands)
        op.normal = lambda x, w: x
    elif kind == "q":
        Q_op = lambda x: x  # noqa: E731
    elif kind == "wide":
        n = lasso_pcg.MAX_COLS * lasso_pcg.THREADS + 1
        op = op.with_operands({**op.operands})
        op.operands["X"] = torch.zeros((8, n), dtype=f64)
    ones = torch.ones
    return CGSchurSolver(op, Q_op, ones(p, dtype=f64), ones(q, dtype=f64),
                         ones(q, dtype=f64))


@pytest.mark.parametrize("kind", ["lasso", "dense", "sharded", "q", "wide"])
def test_fused_engages_on_the_lasso_operator_alone(kind):
    """On a card in float64 only `lasso_operator`'s products, unsharded,
    with no Q and at a width F1 holds, run as F1 and F2; not in float32,
    and not on the CPU."""
    solver = _solver(kind)
    assert schur._fused_engages(solver, _Card()) == (kind == "lasso")
    assert not schur._fused_engages(solver, _Card(torch.float32))
    assert not schur._fused_engages(solver, torch.ones(solver.A_op.n,
                                                       dtype=f64))


def test_fused_and_torch_op_blocks_keep_their_own_graphs(monkeypatch):
    """The graph cache keys the fused choice: one shape taken fused and
    then not holds two blocks, each of its own kind."""
    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    solver = _solver("lasso")
    rhs = torch.ones(solver.A_op.n, dtype=f64)
    kinds = []
    for fused in (True, False, True):
        monkeypatch.setattr(schur, "_fused_engages", lambda *a: fused)
        with schur._pcg_graph(solver, rhs) as graph:
            kinds.append(type(graph))
    assert kinds == [schur._FusedPCGBlock, schur._PCGBlock,
                     schur._FusedPCGBlock]
    assert len(schur._GRAPHS) == 2


# ----------------------------------------------------- the benchmark's reader

def _span(name, span_id, parent, **attrs):
    return SimpleNamespace(name=name, span_id=span_id, parent_id=parent,
                           request_id=1, attrs=attrs, start_ns=0, end_ns=1)


def _record(admm):
    return SimpleNamespace(profile=SimpleNamespace(
        calls=[(0.1, {"admm_iters": np.array([admm])})]))


@pytest.mark.parametrize("fused, share", [((10, 10, 4), 100.0),
                                          ((10, 0, 0), 100.0 * 10 / 24),
                                          ((0, 0, 0), 0.0)])
def test_fused_share_reader(monkeypatch, fused, share):
    """`portbench/metrics/qcp.cg_fused_iter_share.py`: Σ `fused_iters`
    of the `qcp.cg_block` spans over the `qcp.solve` root's `cg_iters`,
    in percent; None without a profile or without the root's noted
    counts."""
    from portbench import harness

    metric = harness.load_module(
        harness.HERE / "metrics" / "qcp.cg_fused_iter_share.py")
    iters = (10, 10, 4)
    tree = [_span("qcp.solve", 0, None, admm_iters=np.array([3]),
                  cg_iters=sum(iters)),
            _span("qcp.cg", 1, 0, iters=sum(iters))]
    tree += [_span("qcp.cg_block", 2 + i, 1, iters=it, fused_iters=f)
             for i, (it, f) in enumerate(zip(iters, fused))]
    monkeypatch.setattr(profiling, "spans", lambda: tree)
    assert metric.CARD_ONLY
    assert metric.read(_record(3)) == pytest.approx(share)
    assert metric.read(SimpleNamespace(profile=None)) is None
    assert metric.read(_record(4)) is None
    monkeypatch.setattr(profiling, "spans", lambda: tree[1:])
    assert metric.read(_record(3)) is None
