"""Linear-system layer: the KKT solvers of the projection steps.

Port of `abip_tpu/linsys/`.  Every LP backend solves the quasi-definite
KKT system

    K z = w,     K = [[rho_y * I,  A ],
                      [A^T,       -I ]]

through the normal equations (`indirect.c:205-220` of the reference):

    (rho_y * I + A A^T) z_y = w_y + A w_x
    z_x = A^T z_y - w_x

  * dense -- Cholesky of the m x m normal matrix, factored once;
  * cg    -- matrix-free Jacobi-preconditioned conjugate gradients with
             the reference's decaying tolerance schedule.

`schur.py` holds the conic drivers' Schur-complement solvers (dense,
low-rank Woodbury, PCG).
"""
from .dense import DenseNormalSolver
from .cg import CGSolver

__all__ = ["DenseNormalSolver", "CGSolver", "make_solver"]


def make_solver(A_op, m: int, n: int, rho_y: float, settings,
                normal_matrix=None):
    """Pick and build a KKT solver for operator `A_op` (a
    `abip_tpu_torch.problem.LinearOperator`).  `normal_matrix` optionally
    supplies a precomputed rho_y*I + A A^T, enabling the direct backend
    without a dense A.  Auto: direct when m <= 4096 and a dense A or the
    normal matrix is at hand (`src/abip-qcp/source/util.c:237-244`)."""
    kind = settings.linsys
    if kind == "auto":
        direct_ok = A_op.has_dense or normal_matrix is not None
        kind = "dense" if m <= 4096 and direct_ok else "cg"
    if kind == "dense":
        return DenseNormalSolver(A_op, m, n, rho_y, settings,
                                 normal_matrix=normal_matrix)
    return CGSolver(A_op, m, n, rho_y, settings)
