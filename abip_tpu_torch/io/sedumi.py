"""SeDuMi-format problem loader (a copy of `abip_tpu/io/sedumi.py` on the
port's `ConeSpec` and `solve_qcp`).

The reference's conic benchmarks feed SeDuMi-style (A, b, c, K) structs
(`scripts/bench-qcp/get_abip_data_from_mosek.m`,
`test_cblib.m:60-76`): K with fields f (free), l (nonneg), q (SOC dims),
r (rotated SOC dims); variables ordered [free, nonneg, soc..., rsoc...].

Our cone ordering is [soc..., rsoc..., free, zero, nonneg]
(`cones.ConeLayout`), so loading permutes columns accordingly and returns
the permutation for mapping solutions back.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..cones import ConeSpec


def _ints(v):
    a = np.atleast_1d(np.asarray(v)).ravel()
    return [int(x) for x in a if int(x) > 0]


def from_sedumi(A, b, c, K):
    """Convert SeDuMi (A, b, c, K) to (A, b, c, ConeSpec, perm).

    K: dict-like with optional fields f, l, q, r.  Returns column-permuted
    data in our cone order plus `perm` such that x_sedumi = x_ours[inv];
    concretely  x_ours = x_sedumi[perm].
    """
    A = sp.csc_matrix(A)
    b = np.asarray(b, float).ravel()
    c = np.asarray(c, float).ravel()
    n = A.shape[1]

    f = int(np.asarray(K.get("f", 0)).ravel()[0]) if _has(K, "f") else 0
    lcone = int(np.asarray(K.get("l", 0)).ravel()[0]) if _has(K, "l") else 0
    q = _ints(K.get("q", [])) if _has(K, "q") else []
    r = _ints(K.get("r", [])) if _has(K, "r") else []

    total = f + lcone + sum(q) + sum(r)
    if total != n:
        raise ValueError(
            f"K dims ({total}) do not match number of columns ({n})"
        )

    # sedumi order: [free, nonneg, soc..., rsoc...]
    idx_free = np.arange(0, f)
    idx_l = np.arange(f, f + lcone)
    idx_q = np.arange(f + lcone, f + lcone + sum(q))
    idx_r = np.arange(f + lcone + sum(q), n)
    # ours: [soc..., rsoc..., free, zero, nonneg]
    perm = np.concatenate([idx_q, idx_r, idx_free, idx_l]).astype(int)

    cones = ConeSpec(soc=tuple(q), rsoc=tuple(r), free=f, nonneg=lcone)
    return A[:, perm].toarray(), b, c[perm], cones, perm


def to_sedumi(A, b, c, cones):
    """Convert (A, b, c, ConeSpec) in our cone order to SeDuMi (A, b, c, K).

    Inverse of :func:`from_sedumi`: permutes columns back to the SeDuMi
    variable order [free, nonneg, soc..., rsoc...].  SeDuMi's K struct has
    no zero-cone field for primal variables, so ``cones.zero`` must be 0.
    """
    A = sp.csc_matrix(A)
    b = np.asarray(b, float).ravel()
    c = np.asarray(c, float).ravel()
    n = A.shape[1]
    if cones.zero:
        raise ValueError("SeDuMi K has no primal zero cone; zero must be 0")
    if cones.dim != n:
        raise ValueError(
            f"cone dims ({cones.dim}) do not match number of columns ({n})"
        )
    nq, nr = sum(cones.soc), sum(cones.rsoc)
    # ours: [soc..., rsoc..., free, zero(=0), nonneg]
    idx_q = np.arange(0, nq)
    idx_r = np.arange(nq, nq + nr)
    idx_free = np.arange(nq + nr, nq + nr + cones.free)
    idx_l = np.arange(nq + nr + cones.free, n)
    # sedumi order: [free, nonneg, soc..., rsoc...]
    inv = np.concatenate([idx_free, idx_l, idx_q, idx_r]).astype(int)
    K = {"f": cones.free, "l": cones.nonneg,
         "q": list(cones.soc), "r": list(cones.rsoc)}
    return A[:, inv], b, c[inv], K


def write_sedumi_mat(path, A, b, c, cones, extra=None):
    """Write a SeDuMi .mat file readable by :func:`load_sedumi_mat`.

    Round-trips through :func:`to_sedumi`; `extra` merges additional
    fields (e.g. a known optimal objective) into the saved dict.
    """
    from scipy.io import savemat

    As, bs, cs, K = to_sedumi(A, b, c, cones)
    d = {"A": sp.csc_matrix(As), "b": bs.reshape(-1, 1),
         "c": cs.reshape(-1, 1), "K": K}
    if extra:
        d.update(extra)
    savemat(path, d)


def _has(K, field):
    try:
        v = K[field]
    except (KeyError, IndexError, TypeError, ValueError):
        return False
    return v is not None and np.asarray(v).size > 0


def _read_mat(path):
    from scipy.io import loadmat

    return loadmat(path, simplify_cells=True)


def _convert_mat_dict(d):
    """(A, b, c, ConeSpec, perm) in our cone ordering from a loaded dict."""
    if "A" in d:
        A = d["A"]
    elif "At" in d:
        A = sp.csc_matrix(d["At"]).T
    else:
        raise ValueError("no A or At in the .mat file")
    K = d.get("K", {})
    if not isinstance(K, dict):
        # structured numpy record from older loadmat
        K = {name: K[name] for name in K.dtype.names}
    return from_sedumi(A, d["b"], d["c"], K)


def load_sedumi_mat(path):
    """Load a SeDuMi .mat file (A/At, b, c, K) via scipy.io.

    Returns (A, b, c, ConeSpec, perm) in our cone ordering.
    """
    return _convert_mat_dict(_read_mat(path))


def solve_sedumi(path, settings=None, extra_fields=(), device=None,
                 **overrides):
    """Load a SeDuMi .mat problem and solve it; x returned in sedumi order.
    The solve runs on the CUDA card unless `device` says otherwise.

    `extra_fields` names additional .mat entries (e.g. a `pobj_star`
    oracle) returned alongside the solution as a dict from the single
    file read; with the default empty tuple only the solution is
    returned.
    """
    from ..qcp import solve_qcp

    d = _read_mat(path)
    A, b, c, cones, perm = _convert_mat_dict(d)
    sol = solve_qcp(A, b, c, cones, settings=settings, device=device,
                    **overrides)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    sol.x = sol.x[inv]
    sol.s = sol.s[inv]
    if extra_fields:
        return sol, {k: d.get(k) for k in extra_fields}
    return sol
