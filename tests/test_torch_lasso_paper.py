"""The LASSO front door's matrix-free form (`problems.solve_lasso`,
`matrix_free=True`), its spans in the host conic loop, and the
benchmark's `lasso_paper.m1000_n5000` cell at its tiny shape.

The matrix-free form runs on `lasso_operator`'s scaled embedding; its
answer comes back in the units of `lasso_to_conic`'s embedding, as the
dense form's does.  Tolerances are stated beside each check.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu_torch.linsys.schur import CGSchurSolver  # noqa: E402
from abip_tpu_torch.problems import (lasso_operator, lasso_to_conic,  # noqa: E402
                                     solve_lasso)
from abip_tpu_torch.qcp import conic_defaults, solve_qcp  # noqa: E402
from abip_tpu_torch.utils import profiling  # noqa: E402
from benchmarks.generate import lasso_instance  # noqa: E402
from portbench import reference  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CELL = "lasso_paper.m1000_n5000"
EPS = 1e-6
# the tiny shape of the benchmark's configuration: RSOC(22) x R+^200
TINY = dict(m=20, n=100)
SEEDS = [0, 3]


def _instance(seed):
    return lasso_instance(**TINY, seed=seed)


@pytest.fixture(scope="module")
def solves():
    """{seed: (matrix-free, dense)} `solve_lasso` results at EPS."""
    return {seed: (solve_lasso(*_instance(seed), eps=EPS, matrix_free=True,
                               device="cpu"),
                   solve_lasso(*_instance(seed), eps=EPS, device="cpu"))
            for seed in SEEDS}


def _optimum(X, y, lam):
    """The plain reference's optimum p* of the embedding, in f64."""
    P = lasso_to_conic(X, y, lam)
    A, b, c = (torch.as_tensor(v)[None] for v in (P.A, P.b, P.c))
    cones = {"rsoc": [2 + X.shape[0]], "nonneg": 2 * X.shape[1]}
    r = reference.solve(A, b, c, cones, 1e-9)
    assert int(r.status[0]) == 1
    return float((c * r.x).sum())


@pytest.mark.parametrize("seed", SEEDS)
def test_matrix_free_answer_meets_the_embedding(solves, seed):
    """x, y, s in the embedding's units: its primal and dual residuals
    and its gap under 10 eps.  The solver stops on inf-norm residuals
    of the scaled embedding; the row and column scalings between the two
    (fourth roots of row and column norms, with b and c normalized) move
    a relative residual by a small factor, under 3 on these instances."""
    (_, _, sol), _ = solves[seed]
    P = lasso_to_conic(*_instance(seed))
    x, y, s = sol.x, sol.y, sol.s
    inf = lambda v: np.abs(v).max()  # noqa: E731
    assert sol.status == 1
    assert inf(P.A @ x - P.b) / (1 + inf(P.b)) < 10 * EPS
    assert inf(P.A.T @ y + s - P.c) / (1 + inf(P.c)) < 10 * EPS
    cx, by = P.c @ x, P.b @ y
    assert abs(cx - by) / (1 + abs(cx) + abs(by)) < 10 * EPS
    # the objectives the solver reports are those of its answer
    assert sol.pobj == pytest.approx(cx, rel=1e-12)
    assert sol.dobj == pytest.approx(by, rel=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_objectives_agree_with_dense_form_and_reference(solves, seed):
    """pobj and dobj in original units: within 10 eps (relative to
    1 + |p*|) of the plain reference's optimum and of the dense form's,
    which both stop at eps of their own criteria."""
    (_, _, mf), (_, _, dense) = solves[seed]
    pstar = _optimum(*_instance(seed))
    scale = 1 + abs(pstar)
    for v in (mf.pobj, mf.dobj, dense.pobj, dense.dobj):
        assert abs(v - pstar) / scale < 10 * EPS
    assert abs(mf.pobj - dense.pobj) / scale < 10 * EPS
    assert abs(mf.dobj - dense.dobj) / scale < 10 * EPS


def _operator_scaling(X, y, lam):
    """E and sc_b of `lasso_operator(scaled=True)`, by its own formulas."""
    m, n = X.shape
    colX_sq = np.sum(X * X, axis=0)
    col_sq = np.concatenate([[1.0, 1.0], np.ones(m), colX_sq, colX_sq])
    E = np.sqrt(np.sqrt(np.maximum(col_sq, 1e-8)))
    E[:2 + m] = E[:2 + m].mean()
    q = 2 + m + 2 * n
    b = np.concatenate([[1.0], y])
    c = np.zeros(q)
    c[1] = 1.0
    c[2 + m:] = lam
    sc = float(np.sqrt(np.sqrt(b @ b + c @ c)))
    sc = 1.0 if sc < 1e-3 else min(sc, 1e3)
    return E, 1.0 / sc


@pytest.mark.parametrize("seed", SEEDS)
def test_weights_and_counts_are_the_scaled_solves(seed):
    """w and the objective are bit-equal to what the scaled solve gave
    before its answer came back in the embedding's units (x / (E sc_b),
    split into w+ - w-), and the status and the ADMM, IPM and CG counts
    are the scaled solve's."""
    X, y, lam = _instance(seed)
    w, obj, sol = solve_lasso(X, y, lam, eps=1e-3, matrix_free=True,
                              device="cpu")
    prob = lasso_operator(X, y, lam, device="cpu")
    scaled = solve_qcp(prob.A, prob.b, prob.c, prob.cones,
                       settings=conic_defaults(normalize=False, linsys="cg"),
                       tol_ladder=prob.tol_ladder, device="cpu", eps=1e-3)
    E, sc_b = _operator_scaling(X, y, lam)
    m, n = X.shape
    z = np.asarray(scaled.x) / (E * sc_b)
    w0 = z[2 + m:2 + m + n] - z[2 + m + n:]
    obj0 = 0.5 * np.sum((X @ w0 - y) ** 2) + lam * np.sum(np.abs(w0))
    assert np.array_equal(w, w0) and obj == obj0
    assert np.array_equal(sol.x, z)
    for f in ("status", "admm_iters", "ipm_iters", "avg_cg_iters"):
        assert getattr(sol, f) == getattr(scaled, f)


# ---------------------------------------------------------------- spans

@pytest.fixture(scope="module")
def traced():
    """The record of two profiled matrix-free solves and their answers."""
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sols = [solve_lasso(*_instance(seed), eps=1e-3, matrix_free=True,
                            device="cpu")[2] for seed in SEEDS]
    spans = profiling.spans()
    profiling.clear()
    return spans, sols


def _roots(spans):
    return [s for s in spans if s.parent_id is None]


def test_one_root_per_call(traced):
    spans, sols = traced
    roots = _roots(spans)
    assert [r.name for r in roots] == ["qcp.solve"] * len(sols)
    assert {s.request_id for s in spans} == {r.span_id for r in roots}


def test_root_notes_the_answers_counts(traced):
    """The root's `admm_iters` is the answer's; its `cg_iters` is the sum
    of the `iters` its `qcp.cg` spans note, the setup's solve included."""
    spans, sols = traced
    for root, sol in zip(_roots(spans), sols):
        tree = [s for s in spans if s.request_id == root.span_id]
        cg = [s.attrs["iters"] for s in tree if s.name == "qcp.cg"]
        assert root.attrs["admm_iters"] == sol.admm_iters
        assert root.attrs["cg_iters"] == sum(cg) > 0
        assert sum(s.name == "qcp.admm" for s in tree) == sol.admm_iters
        # one PCG solve an ADMM iteration, and one at setup
        assert len(cg) == sol.admm_iters + 1


def test_spans_nest_by_layer(traced):
    spans, _ = traced
    by_id = {s.span_id: s for s in spans}
    parents = {"qcp.setup": {"qcp.solve"}, "qcp.admm": {"qcp.inner_admm"},
               "qcp.inner_admm": {"qcp.solve"},
               "qcp.project": {"qcp.admm"}, "qcp.cone": {"qcp.admm"},
               "qcp.check": {"qcp.admm"}, "qcp.cg": {"qcp.project",
                                                     "qcp.setup"},
               "qcp.mu_update": {"qcp.solve"}, "qcp.extract": {"qcp.solve"}}
    names = {s.name for s in spans}
    assert set(parents) <= names
    for s in spans:
        if s.name in parents:
            assert by_id[s.parent_id].name in parents[s.name], s.name
        assert s.name.startswith("qcp.")


def test_every_pcg_stop_test_is_a_host_read(traced, monkeypatch):
    """Each PCG solve reads its stop test once an iteration and once to
    stop (no solve here reaches its cap): iters + 1 `qcp.host_read`
    spans under each `qcp.cg`, and the count of stop tests the PCG
    made."""
    spans, _ = traced
    for s in spans:
        if s.name == "qcp.cg":
            reads = [c for c in spans if c.parent_id == s.span_id]
            assert [c.name for c in reads] == ["qcp.host_read"] * len(reads)
            assert len(reads) == s.attrs["iters"] + 1
    from abip_tpu_torch.linsys import cg

    tests = []
    real = cg._above
    monkeypatch.setattr(cg, "_above",
                        lambda x, tol: tests.append(1) or real(x, tol))
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        solve_lasso(*_instance(SEEDS[0]), eps=1e-3, matrix_free=True,
                    device="cpu")
    recorded = profiling.spans()
    profiling.clear()
    cgs = {s.span_id for s in recorded if s.name == "qcp.cg"}
    assert len(tests) == sum(s.name == "qcp.host_read"
                             and s.parent_id in cgs for s in recorded)


def test_off_records_nothing():
    profiling.clear()
    solve_lasso(*_instance(SEEDS[0]), eps=1e-3, matrix_free=True,
                device="cpu")
    assert profiling.spans() == []
    assert profiling.annotate("qcp.solve") is profiling.annotate("qcp.cg")


def test_cg_span_of_the_schur_solver():
    """`CGSchurSolver.solve` is one `qcp.cg` span noting its iterations,
    also outside a root."""
    prob = lasso_operator(*_instance(SEEDS[0]), device="cpu")
    p, q = prob.A.m, prob.A.n
    f64 = dict(dtype=torch.float64)
    solver = CGSchurSolver(prob.A, None, torch.full((p,), 1e-6, **f64),
                           torch.ones(q, **f64), torch.ones(q, **f64))
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, _, iters = solver.solve(torch.ones(p, **f64), torch.ones(q, **f64))
    (root,) = _roots(profiling.spans())
    profiling.clear()
    assert root.name == "qcp.cg" and root.attrs["iters"] == iters > 0


# ------------------------------------------------- the benchmark's cell

RUN = """
import json, sys
from portbench import harness
from portbench.tests.cases import tiny_cell
cell = tiny_cell(sys.argv[1])
line, _ = harness.run(sys.argv[1], 2 ** 31 + 2468, 0.5, int(sys.argv[2]),
                      device="cpu", cell=cell)
wanted = cell.per_layer if int(sys.argv[2]) else cell.end_to_end
line["wanted"] = sorted(m["name"] for m in wanted
                        if m["source"] != "device_trace")
print(json.dumps(line))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_at_its_tiny_shape(trace):
    """`portbench.harness.run` of the cell on the CPU at its
    configuration's tiny shape, in a process of its own (a run refuses a
    process that holds JAX): correct, nothing failed, and every metric
    of the cell but the device's reported above 0, but for the shares of
    PCG iterations run in CUDA graphs' blocks and through the LASSO
    operator's two kernels, which run only on a card and read 0 here."""
    card_only = {"qcp.cg_block_iter_share", "qcp.cg_fused_iter_share"}
    proc = subprocess.run(
        [sys.executable, "-c", RUN, CELL, str(trace)], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert sorted(line["metrics"]) == line["wanted"]
    assert line["wanted"] and all((v["value"] > 0) == (k not in card_only)
                                  for k, v in line["metrics"].items())
    if trace:
        assert {m for m in line["wanted"] if m.startswith("qcp.")} == {
            "qcp.admm_iters_per_s", "qcp.admm_iters_per_solve",
            "qcp.cg_iters_per_admm", "qcp.host_reads_per_admm",
            "qcp.host_wait_share", "qcp.cg_share"} | card_only
