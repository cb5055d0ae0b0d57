"""Schur systems of the matrix-free LASSO operator, and runs of
`ops.lasso_pcg`'s F1 and F2 and of `linsys.cg`'s PCG iteration from one
state, for the CPU tests (`test_torch_lasso_pcg.py`) and the card's
(`test_torch_cuda.py`).  Imports no JAX."""
import numpy as np
import torch

from abip_tpu_torch.linsys import cg
from abip_tpu_torch.linsys.schur import CGSchurSolver
from abip_tpu_torch.ops import lasso_pcg
from abip_tpu_torch.problems import lasso_operator
from benchmarks.generate import lasso_instance

f64 = torch.float64
STATE = ("x", "r", "p", "ipzr")


def system(m, n, seed=0, device="cpu"):
    """(solver, b): `CGSchurSolver` on `lasso_operator`'s products of a
    seeded (m, n) instance, with seeded rho_y and rho_x of the sizes a
    solve meets and the exact Jacobi diagonal, and a seeded rhs."""
    X, y, lam = lasso_instance(m=m, n=n, seed=seed)
    op = lasso_operator(X, y, lam, device=device).A
    rng = np.random.default_rng(seed + 1)
    rho_y = torch.as_tensor(1.0 / (rng.random(op.m) + 0.5), device=device)
    rho_x = torch.as_tensor(rng.random(op.n) * 1e-3 + 1e-4, device=device)
    diag = torch.as_tensor(op.col_norms_sq, device=device) + rho_x
    solver = CGSchurSolver(op, None, rho_y, rho_x, diag)
    return solver, torch.as_tensor(rng.standard_normal(op.n), device=device)


def start(solver, b):
    """{x, r, p, ipzr}: the PCG's state at x = 0."""
    x = torch.zeros_like(b)
    return dict(zip(STATE, (x, *cg.pcg_start(solver._S, solver.M, b, x))))


def eager(solver, state, steps):
    """{x, r, p, ipzr} after `steps` iterations of `cg._pcg_iteration`."""
    st = tuple(state[k] for k in STATE)
    for _ in range(steps):
        st = cg._pcg_iteration(solver._S, solver.M, *st)
    return dict(zip(STATE, st))


class Fused:
    """F1 and F2 over copies of a state on the solver's device, with the
    plan `pl`, tol and cap: `slot()` runs one iteration of each."""

    def __init__(self, solver, state, pl, tol=0.0, cap=10 ** 6):
        dev = state["x"].device
        self.solver, self.pl = solver, pl
        self.ops = solver.A_op.operands
        self.t = {k: v.clone() for k, v in state.items()}
        self.t["w"] = lasso_pcg.w_of(pl, self.t["p"], self.ops["E"])
        self.t["v"] = torch.zeros(pl.m, dtype=f64, device=dev)
        self.t["partials"] = torch.zeros((pl.clusters, pl.n), dtype=f64,
                                         device=dev)
        self.t["flag"] = torch.tensor([1, 0], device=dev)
        self.tol = torch.tensor(tol, dtype=f64, device=dev)
        self.cap = torch.tensor(cap, device=dev)

    def f1(self):
        o, t = self.ops, self.t
        lasso_pcg.f1(self.pl, o["X"], o["D"], o["E"], self.solver.ry_inv,
                     t["p"], t["w"], t["flag"], t["v"], t["partials"])

    def f2(self):
        o, t, s = self.ops, self.t, self.solver
        lasso_pcg.f2(self.pl, t["partials"], t["v"], o["D"], o["E"],
                     s.ry_inv, s.rho_x, s.M, self.tol, self.cap, t["x"],
                     t["r"], t["p"], t["w"], t["ipzr"], t["flag"])

    def slot(self, count=1):
        for _ in range(count):
            self.f1()
            self.f2()
        return self.t


def on_cpu(solver):
    """The solver with every tensor it holds, its operator's too, on the
    CPU."""
    op = solver.A_op
    cpu = CGSchurSolver(op.with_operands(
        {k: t.cpu() for k, t in op.operands.items()}), None,
        1.0 / solver.ry_inv.cpu(), solver.rho_x.cpu(), 1.0 / solver.M.cpu())
    cpu.ry_inv, cpu.M = solver.ry_inv.cpu(), solver.M.cpu()
    return cpu


def rel(a, b):
    """||a - b|| / ||b|| on the CPU."""
    a, b = a.cpu().double(), b.cpu().double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))
