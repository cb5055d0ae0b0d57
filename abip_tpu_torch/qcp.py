"""Conic constants and defaults.

Port of the JAX-free head of `abip_tpu/qcp.py:36-44`.  The host conic
driver `ConicWorkspace` is not ported yet (ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

from .settings import Settings

EPS_TOL = 1e-18


def conic_defaults(**overrides) -> Settings:
    """Conic defaults (`src/abip-qcp/source/util.c:203-255`): rho_y=1e-6."""
    base = dict(rho_y=1e-6, rho_x=1.0, rho_tau=1.0, psi=1.0,
                origin_rescale=True, pc_ruiz_rescale=True, qp_rescale=False)
    base.update(overrides)
    return Settings(**base)
