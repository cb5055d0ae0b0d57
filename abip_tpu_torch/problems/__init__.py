"""Application reformulations: LASSO, SVM (SOCP and QP forms).

Port of `abip_tpu/problems/` (the reference's per-problem configs,
`source/{lasso,svm,svm_qp}_config.c`): each `*_to_conic` builds the
conic embedding (cones, constraint data, recovery map) in numpy, each
`*_operator` its matrix-free form on a device (default: the CUDA card),
and `solve_*` solves it through `qcp.solve_qcp` (or, for a sweep of
LASSO instances, `parallel.batched_qcp.solve_qcp_batch`).
"""
from .lasso import (ConicProblem, lasso_operator, lasso_to_conic,
                    solve_lasso, solve_lasso_batch)
from .svm import (solve_svm, svm_operator_qp, svm_operator_socp,
                  svm_to_conic_qp, svm_to_conic_socp)

__all__ = [
    "ConicProblem",
    "lasso_operator",
    "lasso_to_conic",
    "solve_lasso",
    "solve_lasso_batch",
    "svm_operator_qp",
    "svm_operator_socp",
    "svm_to_conic_qp",
    "svm_to_conic_socp",
    "solve_svm",
]
