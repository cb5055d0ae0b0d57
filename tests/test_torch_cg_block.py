"""The Schur PCG's masked block against its eager loop, on the CPU.

On a CUDA card `linsys.schur.CGSchurSolver` runs its PCG as blocks of
`cg.PCG_BLOCK` masked iterations (`cg.pcg_block`), each block a CUDA
graph over static buffers (`schur._PCGBlock` on `utils.graphs`) whose
operator is rebuilt over those buffers (`LinearOperator.with_operands`).
Here the block runs uncaptured and must give `cg.pcg`'s x and iteration
count bit for bit, at every kind of stop; whole solves run as blocks
(the engagement made to say yes) give the eager solves' answers bit for
bit.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu_torch import ConeSpec  # noqa: E402
from abip_tpu_torch.linsys import cg, schur  # noqa: E402
from abip_tpu_torch.linsys.schur import CGSchurSolver  # noqa: E402
from abip_tpu_torch.problem import LinearOperator  # noqa: E402
from abip_tpu_torch.problems import lasso_operator, solve_lasso  # noqa: E402
from abip_tpu_torch.problems.lasso import _lasso_products  # noqa: E402
from abip_tpu_torch.qcp import conic_defaults, solve_qcp  # noqa: E402
from abip_tpu_torch.tools.generate import randcone  # noqa: E402
from abip_tpu_torch.utils import graphs, profiling  # noqa: E402
from benchmarks.generate import lasso_instance  # noqa: E402

f64 = torch.float64
N = 25
B = cg.PCG_BLOCK


def _system(seed=0):
    """(G, M, b, x0) of an SPD n = 25 system with a Jacobi M."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((2 * N, N))
    G = torch.as_tensor(A.T @ A + 0.1 * np.eye(N))
    b = torch.as_tensor(rng.standard_normal(N))
    x0 = torch.as_tensor(0.1 * rng.standard_normal(N))
    return (lambda v: G @ v), 1.0 / torch.diagonal(G), b, x0


def _norms(G, M, b, x0, count):
    """||r|| of `pcg`'s recurrence after 0..count iterations."""
    x = x0
    r, p, ipzr = cg.pcg_start(G, M, b, x)
    out = [float(torch.linalg.vector_norm(r))]
    for _ in range(count):
        x, r, p, ipzr = cg._pcg_iteration(G, M, x, r, p, ipzr)
        out.append(float(torch.linalg.vector_norm(r)))
    return out


def _stop_at(norms, k):
    """A tolerance at which `pcg` stops after exactly k iterations: at or
    below ||r|| before each of the first k, above it after the k-th."""
    if k == 0:
        return torch.tensor(2 * norms[0], dtype=f64)
    above = min(norms[:k])
    assert norms[k] < above
    return torch.tensor((norms[k] + above) / 2, dtype=f64)


def _tol_cap(case, G, M, b, x0):
    """(tol, cap, the eager count the case needs) of each stop."""
    norms = _norms(G, M, b, x0, 3 * B)
    if case == "mid-block":
        return _stop_at(norms, B + 7), 1000, B + 7
    if case == "block-boundary":
        return _stop_at(norms, 2 * B), 1000, 2 * B
    if case == "below-tol-at-start":
        return _stop_at(norms, 0), 1000, 0
    if case == "max-iters-cap":
        return torch.tensor(0.0, dtype=f64), 13, 13
    # the setup solve's tolerance (`iter_count = -1`): 1e-9 * norm_p
    return 1e-9 * torch.linalg.vector_norm(b), 1000, None


@pytest.mark.parametrize("case", ["mid-block", "block-boundary",
                                  "below-tol-at-start", "max-iters-cap",
                                  "setup-tolerance"])
def test_pcg_block_matches_pcg(case):
    """Blocks of `pcg_block`, read once a block, stop where `pcg` stops:
    x and the count bit for bit, in max(1, ceil(count / 10)) blocks."""
    G, M, b, x0 = _system()
    tol, cap, want = _tol_cap(case, G, M, b, x0)
    x_ref, its_ref = cg.pcg(G, M, b, x0, tol, cap)
    if want is not None:
        assert its_ref == want
    else:
        assert B < its_ref < cap and its_ref % B
    r, p, ipzr = cg.pcg_start(G, M, b, x0)
    state = (x0, r, p, ipzr, torch.zeros((), dtype=torch.int64))
    cap_t = torch.tensor(cap, dtype=torch.int64)
    blocks, go = 0, True
    while go:
        state, running = cg.pcg_block(G, M, *state, tol, cap_t)
        go, blocks = bool(running), blocks + 1
    assert int(state[-1]) == its_ref
    assert torch.equal(state[0], x_ref)
    assert blocks == max(1, -(-its_ref // B))


# ------------------------------------------- operators over substitutes

def _ops():
    """{kind: (operator, {name: substitute})} with a new X or A."""
    X, y, lam = lasso_instance(m=8, n=20, seed=1)
    lasso = lasso_operator(X, y, lam, device="cpu").A
    A = torch.as_tensor(np.random.default_rng(2).standard_normal((6, 15)))
    dense = LinearOperator.from_dense(A)
    return {"lasso": (lasso, {"X": lasso.operands["X"] * -1.5}),
            "dense": (dense, {"A": A + 1.0})}


@pytest.mark.parametrize("kind", ["lasso", "dense"])
def test_with_operands_gives_the_same_products(kind):
    """An operator rebuilt over copies of its operands gives its
    products bit for bit; one rebuilt over another X (or A) gives that
    one's products, not the old: no operand is kept stale."""
    op, new = _ops()[kind]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(op.n))
    y = torch.as_tensor(rng.standard_normal(op.m))
    copies = op.with_operands({k: t.clone() for k, t in op.operands.items()})
    assert torch.equal(copies.matvec(x), op.matvec(x))
    assert torch.equal(copies.rmatvec(y), op.rmatvec(y))
    assert copies.nnz == op.nnz and copies.has_dense == op.has_dense
    other = op.with_operands({**op.operands, **new})
    if kind == "lasso":
        mv, rmv = _lasso_products({**op.operands, **new})
        assert np.array_equal(other.col_norms_sq, op.col_norms_sq)
    else:
        A2 = new["A"]
        mv, rmv = (lambda v: A2 @ v), (lambda v: A2.T @ v)
        assert other.dense() is A2 and op.dense() is op.operands["A"]
    assert torch.equal(other.matvec(x), mv(x))
    assert torch.equal(other.rmatvec(y), rmv(y))
    assert not torch.equal(other.matvec(x), op.matvec(x))
    assert not torch.equal(other.rmatvec(y), op.rmatvec(y))


def test_with_operands_refuses_other_names_and_shapes():
    op, _ = _ops()["dense"]
    A = op.operands["A"]
    for bad in ({"B": A}, {"A": A[:, 1:]}, {"A": A.float()}):
        with pytest.raises(ValueError):
            op.with_operands(bad)
    plain = LinearOperator(2, 2, lambda x: x, lambda y: y)
    assert plain.operands is None
    with pytest.raises(ValueError):
        plain.with_operands({})


# ----------------------------------------------- whole solves as blocks

def _lasso():
    return solve_lasso(*lasso_instance(m=20, n=100, seed=0), eps=1e-3,
                       matrix_free=True, device="cpu")[2]


def _dense_cg():
    cones = ConeSpec(soc=(5,), rsoc=(4,), nonneg=10)
    _, A, b, c, _, _ = randcone("x", 8, cones, 1)
    return solve_qcp(A, b, c, cones, settings=conic_defaults(
        eps=1e-6, linsys="cg"), device="cpu")


def _blocks(monkeypatch, fn):
    """fn() with the PCG as uncaptured blocks, under the profiler: (the
    solution, the spans)."""
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sol = fn()
    spans = profiling.spans()
    profiling.clear()
    return sol, spans


@pytest.mark.parametrize("fn", [_lasso, _dense_cg], ids=["lasso", "dense-cg"])
def test_solves_in_blocks_match_eager(monkeypatch, fn):
    """A matrix-free LASSO and a dense-A `solve_qcp(linsys="cg")` run as
    blocks give the eager solve's x, y, s and counts bit for bit; each
    PCG solve reads its flag once a block, and the blocks' `iters` add
    up to the root's `cg_iters`."""
    eager = fn()
    sol, spans = _blocks(monkeypatch, fn)
    assert (sol.status_name, sol.admm_iters, sol.ipm_iters,
            sol.avg_cg_iters) == (eager.status_name, eager.admm_iters,
                                  eager.ipm_iters, eager.avg_cg_iters)
    for name in "xys":
        assert np.array_equal(getattr(sol, name), getattr(eager, name))
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "qcp.solve"
    blocks = [s for s in spans if s.name == "qcp.cg_block"]
    assert sum(s.attrs["iters"] for s in blocks) == root.attrs["cg_iters"] > 0
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "qcp.cg":
            mine = [b for b in blocks if b.parent_id == s.span_id]
            assert len(mine) == max(1, -(-s.attrs["iters"] // B))
            reads = [r for r in spans if r.name == "qcp.host_read"
                     and by_id[r.parent_id].name == "qcp.cg_block"
                     and by_id[r.parent_id].parent_id == s.span_id]
            assert len(reads) == len(mine)


# ------------------------------------------------------- where it engages

def _solver(kind):
    X, y, lam = lasso_instance(m=8, n=20, seed=1)
    op = lasso_operator(X, y, lam, device="cpu").A
    q, p = op.n, op.m
    Q_op = None
    if kind == "sparse":
        import scipy.sparse as sp
        op = LinearOperator.from_scipy_sparse(
            sp.random(p, q, density=0.3, random_state=0, format="csr"))
    elif kind == "sharded":
        op = op.with_operands(op.operands)
        op.normal = lambda x, w: x
    elif kind == "q":
        Q_op = lambda x: x  # noqa: E731
    ones = torch.ones
    return CGSchurSolver(op, Q_op, ones(p, dtype=f64), ones(q, dtype=f64),
                         ones(q, dtype=f64))


@pytest.mark.parametrize("kind", ["named", "sparse", "sharded", "q"])
def test_graph_engages_on_what_it_observes(kind):
    """On a card only an operator that names its operands, unsharded and
    with no Q, runs as blocks; on the CPU nothing does."""
    solver = _solver(kind)

    class Card:
        is_cuda = True

    assert schur._graph_engages(solver, Card()) == (kind == "named")
    assert not schur._graph_engages(solver, torch.ones(solver.A_op.n,
                                                       dtype=f64))


def test_a_held_graph_leaves_the_solve_eager(monkeypatch):
    """A second solve of the shape while another holds its graph runs
    eagerly, with the same answer; the process keeps at most four
    graphs, least recent out."""
    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    solver = _solver("named")
    rhs = torch.ones(solver.A_op.n, dtype=f64)
    out = []

    def take_in_thread():
        with schur._pcg_graph(solver, rhs) as other:
            out.append(other)

    with schur._pcg_graph(solver, rhs) as graph:
        assert graph is not None and graph.lock.locked()
        worker = threading.Thread(target=take_in_thread)
        worker.start()
        worker.join()
        assert out == [None]
        held = solver.solve(rhs[:solver.A_op.m], rhs)
    assert not graph.lock.locked()
    free = solver.solve(rhs[:solver.A_op.m], rhs)
    assert held[2] == free[2]
    assert all(torch.equal(a, b) for a, b in zip(held[:2], free[:2]))
    for n in range(2, 8):
        with schur._pcg_graph(solver, torch.ones(n, dtype=f64)):
            pass
    assert len(schur._GRAPHS) == schur._GRAPHS.kept


def test_threads_share_one_pcg_graph(monkeypatch):
    """Six threads solving matrix-free LASSOs of one shape at once, with
    the engagement made to say yes and a short switch interval: a PCG
    solve that finds the graph's buffers held by another runs the eager
    loop, and every thread gets the answer it gets alone, bit for bit."""
    import sys
    import time

    monkeypatch.setattr(schur, "_GRAPHS", graphs.GraphCache(
        schur._GRAPHS.kept))
    monkeypatch.setattr(schur, "_graph_engages", lambda *a: True)
    probs = [lasso_instance(m=10, n=40, seed=50 + i) for i in range(6)]

    def one(p):
        return solve_lasso(*p, eps=1e-3, matrix_free=True, device="cpu")[2]

    alone = [one(p) for p in probs]
    together = [None] * len(probs)

    def work(i):
        together[i] = one(probs[i])

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(len(probs))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(schur._GRAPHS) == 1
    for a, b in zip(alone, together):
        assert b is not None and (a.admm_iters, a.avg_cg_iters) == (
            b.admm_iters, b.avg_cg_iters)
        for name in "xys":
            assert np.array_equal(getattr(a, name), getattr(b, name))
