"""Checkpoint / resume of solver state (copy of `abip_tpu/utils/checkpoint.py`).

The reference has no checkpointing (SURVEY.md section 5.4); its nearest
feature is warm start.  Here the iterate state is a small pytree, so
checkpointing is a plain .npz round-trip: `save_state` between barrier
stages, `LPWorkspace.solve(resume=...)` or `ConicWorkspace.solve(resume=...)`
to continue a long solve after preemption with the same workspace (same
A: the cached factorization is rebuilt at workspace construction, the
iterate picks up where it left off).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SolverCheckpoint:
    u: np.ndarray
    v: np.ndarray
    mu: float
    beta: float
    sigma: float
    gamma: float
    admm_iters: int
    ipm_iters: int
    final_check: bool

    def save(self, path: str):
        np.savez(
            path, u=self.u, v=self.v,
            scalars=np.array([self.mu, self.beta, self.sigma, self.gamma]),
            counters=np.array([self.admm_iters, self.ipm_iters,
                               int(self.final_check)]),
        )

    @classmethod
    def load(cls, path: str) -> "SolverCheckpoint":
        z = np.load(path if str(path).endswith(".npz") else path + ".npz")
        mu, beta, sigma, gamma = z["scalars"]
        admm, ipm, fc = z["counters"]
        return cls(u=z["u"], v=z["v"], mu=float(mu), beta=float(beta),
                   sigma=float(sigma), gamma=float(gamma),
                   admm_iters=int(admm), ipm_iters=int(ipm),
                   final_check=bool(fc))


@dataclasses.dataclass
class ConicCheckpoint:
    """Conic-driver checkpoint: iterate + barrier stage scalars.

    The conic analogue of `SolverCheckpoint` (the reference's QCP side has
    no checkpointing either; its init/solve split `source/abip.c:1271-1311`
    is the nearest seam).  The file format is the JAX package's, so a
    file saved by either package loads in the other."""

    u: np.ndarray
    v: np.ndarray
    mu: float
    tol_inner: float
    admm_iters: int
    ipm_iters: int

    def save(self, path: str):
        np.savez(
            path, u=self.u, v=self.v,
            scalars=np.array([self.mu, self.tol_inner]),
            counters=np.array([self.admm_iters, self.ipm_iters]),
        )

    @classmethod
    def load(cls, path: str) -> "ConicCheckpoint":
        z = np.load(path if str(path).endswith(".npz") else path + ".npz")
        mu, tol_inner = z["scalars"]
        admm, ipm = z["counters"]
        return cls(u=z["u"], v=z["v"], mu=float(mu),
                   tol_inner=float(tol_inner),
                   admm_iters=int(admm), ipm_iters=int(ipm))
