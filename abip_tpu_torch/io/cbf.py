"""Native CBLIB Conic Benchmark Format (.cbf) reader/writer (a copy of
`abip_tpu/io/cbf.py` on the port's `ConeSpec` and `dispatch`).

The reference runs its CBLIB protocol by loading instances through the
Mosek MATLAB reader (`scripts/bench-qcp/test_cblib.m:60-76`,
`get_abip_data_from_mosek.m`) -- a proprietary dependency.  This module
parses CBF text natively, so the public CBLIB suite feeds the solver
directly.

Supported: VER 1-3 scalar sections -- OBJSENSE, VAR, CON, INT (rejected
unless relaxed), OBJACOORD, OBJBCOORD, ACOORD, BCOORD; cones F, L+, L-,
L=, Q (second-order), QR (rotated second-order, `2 x1 x2 >= ||x||^2`,
matching our RSOC membership, `cones.py:cone_membership_violation`).
PSD and exponential/power cones raise (outside the reference's cone set,
`src/abip-qcp/include/abip.h:67-76`).

A CBF problem is  optimize  c'x + objb  s.t.  A x + b in K_con, x in
K_var.  The standard-form embedding introduces one slack block per
non-equality constraint cone (`s = A x + b`), negates nonpositive (L-)
variables/slacks into the nonneg orthant, and permutes columns into our
cone order [soc..., rsoc..., free, zero, nonneg] (`cones.ConeLayout`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from ..cones import ConeSpec

_SCALAR_CONES = {"F", "L+", "L-", "L=", "Q", "QR"}
_UNSUPPORTED_CONES = {"EXP", "EXP*", "POW", "POW*"}
_UNSUPPORTED_SECTIONS = {
    "PSDVAR", "PSDCON", "OBJFCOORD", "FCOORD", "HCOORD", "DCOORD",
    "OBJPSDVAR", "CHANGE",
}


@dataclasses.dataclass
class CBFProblem:
    """Raw parse of a .cbf file (CBF index conventions, 0-based)."""

    objsense: str                       # "MIN" | "MAX"
    var_cones: List[Tuple[str, int]]    # (cone name, dim) blocks
    con_cones: List[Tuple[str, int]]
    n: int
    m: int
    obj_a: Dict[int, float]             # j -> coefficient
    obj_b: float
    a_coord: List[Tuple[int, int, float]]
    b_coord: Dict[int, float]
    integers: List[int]


def parse_cbf(path_or_text: str) -> CBFProblem:
    """Parse CBF text (a path or the raw content itself)."""
    if "\n" in path_or_text:
        text = path_or_text
        where = "<string>"
    else:
        with open(path_or_text) as f:
            text = f.read()
        where = path_or_text
    # strip comments / blank lines; keep a line counter for messages
    lines: List[Tuple[int, str]] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        s = raw.split("#", 1)[0].strip()
        if s:
            lines.append((lineno, s))

    pos = 0

    def err(msg, lineno=None):
        at = f"{where}:{lineno}" if lineno else where
        return ValueError(f"CBF parse error at {at}: {msg}")

    def next_line():
        nonlocal pos
        if pos >= len(lines):
            raise err("unexpected end of file")
        ln = lines[pos]
        pos += 1
        return ln

    objsense = "MIN"
    var_cones: List[Tuple[str, int]] = []
    con_cones: List[Tuple[str, int]] = []
    n = m = 0
    obj_a: Dict[int, float] = {}
    obj_b = 0.0
    a_coord: List[Tuple[int, int, float]] = []
    b_coord: Dict[int, float] = {}
    integers: List[int] = []
    seen_ver = False

    def read_cones(count, total, section):
        blocks: List[Tuple[str, int]] = []
        acc = 0
        for _ in range(count):
            lineno, s = next_line()
            toks = s.split()
            if len(toks) != 2:
                raise err(f"malformed {section} cone line {s!r}", lineno)
            name, d = toks[0], int(toks[1])
            if name in _UNSUPPORTED_CONES:
                raise err(
                    f"cone {name!r} is outside the supported set "
                    "{F, L+, L-, L=, Q, QR}", lineno)
            if name not in _SCALAR_CONES:
                raise err(f"unknown cone {name!r}", lineno)
            if d < 1 or (name == "QR" and d < 3) or (name == "Q" and d < 1):
                raise err(f"bad dimension {d} for cone {name}", lineno)
            blocks.append((name, d))
            acc += d
        if acc != total:
            raise err(f"{section} cone dims sum to {acc}, expected {total}")
        return blocks

    while pos < len(lines):
        lineno, kw = next_line()
        if kw in _UNSUPPORTED_SECTIONS:
            raise err(
                f"section {kw!r} (semidefinite/parametric CBF) is not "
                "supported", lineno)
        if kw == "VER":
            _, v = next_line()
            if int(v) not in (1, 2, 3, 4):
                raise err(f"unsupported CBF version {v}", lineno)
            seen_ver = True
        elif kw == "OBJSENSE":
            _, s = next_line()
            if s not in ("MIN", "MAX"):
                raise err(f"OBJSENSE must be MIN or MAX, got {s!r}", lineno)
            objsense = s
        elif kw == "VAR":
            _, hdr = next_line()
            n, k = (int(t) for t in hdr.split())
            var_cones = read_cones(k, n, "VAR")
        elif kw == "CON":
            _, hdr = next_line()
            m, k = (int(t) for t in hdr.split())
            con_cones = read_cones(k, m, "CON")
        elif kw == "INT":
            _, cnt = next_line()
            for _ in range(int(cnt)):
                _, j = next_line()
                integers.append(int(j))
        elif kw == "OBJACOORD":
            _, cnt = next_line()
            for _ in range(int(cnt)):
                ln2, s = next_line()
                j, v = s.split()
                obj_a[int(j)] = obj_a.get(int(j), 0.0) + float(v)
        elif kw == "OBJBCOORD":
            _, s = next_line()
            obj_b = float(s)
        elif kw == "ACOORD":
            _, cnt = next_line()
            for _ in range(int(cnt)):
                ln2, s = next_line()
                i, j, v = s.split()
                a_coord.append((int(i), int(j), float(v)))
        elif kw == "BCOORD":
            _, cnt = next_line()
            for _ in range(int(cnt)):
                ln2, s = next_line()
                i, v = s.split()
                b_coord[int(i)] = b_coord.get(int(i), 0.0) + float(v)
        else:
            raise err(f"unknown section keyword {kw!r}", lineno)

    if not seen_ver:
        raise err("missing VER section")
    if not var_cones:
        raise err("missing VAR section")
    return CBFProblem(objsense=objsense, var_cones=var_cones,
                      con_cones=con_cones, n=n, m=m, obj_a=obj_a,
                      obj_b=obj_b, a_coord=a_coord, b_coord=b_coord,
                      integers=integers)


@dataclasses.dataclass
class ConicEmbedding:
    """Standard-form embedding of a CBF problem, in our cone order."""

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    cones: ConeSpec
    recover: Callable[[np.ndarray], np.ndarray]  # x_ours -> x_cbf
    objsense: str
    obj_b: float
    n_orig: int

    def objective(self, pobj_solver: float) -> float:
        """Solver pobj (always a MIN of the embedded c) -> user objective."""
        sign = -1.0 if self.objsense == "MAX" else 1.0
        return sign * pobj_solver + self.obj_b


@dataclasses.dataclass
class _EmbeddingPlan:
    """Structural plan of the embedding (no matrices): cheap enough for
    shape/cone signatures (`embedding_signature`), reused for assembly."""

    sgn: np.ndarray                       # per-CBF-variable sign flips
    slack_rows: List[int]
    slack_sign: List[float]
    keep_rows: np.ndarray                 # bool mask; F rows dropped
    perm: np.ndarray
    cones: ConeSpec
    n: int


def _embedding_plan(p: CBFProblem, relax_integrality=False) -> _EmbeddingPlan:
    if p.integers and not relax_integrality:
        raise ValueError(
            f"instance declares {len(p.integers)} integer variables; the "
            "solver is continuous (pass relax_integrality=True for the "
            "relaxation)")

    n = p.n
    # --- variables: sign flips for L-, category per block -------------
    sgn = np.ones(n)
    var_cat: List[Tuple[str, np.ndarray]] = []  # (our kind, col indices)
    j0 = 0
    for name, d in p.var_cones:
        idx = np.arange(j0, j0 + d)
        if name == "F":
            var_cat.append(("free", idx))
        elif name == "L+":
            var_cat.append(("nonneg", idx))
        elif name == "L-":
            sgn[idx] = -1.0
            var_cat.append(("nonneg", idx))
        elif name == "L=":
            var_cat.append(("zero", idx))
        elif name == "Q":
            var_cat.append(("soc", idx))
        else:  # QR
            var_cat.append(("rsoc", idx))
        j0 += d

    # --- constraints: slack block per non-equality cone; F rows are
    # vacuous (A_i x + b_i in R) and are DROPPED from the system --------
    slack_rows: List[int] = []
    slack_sign: List[float] = []
    slack_cat: List[Tuple[str, int]] = []  # (our kind, block dim)
    keep_rows = np.ones(p.m, bool)
    i0 = 0
    for name, d in p.con_cones:
        rows = list(range(i0, i0 + d))
        if name == "L=":
            pass  # A_i x = -b_i directly
        elif name == "F":
            keep_rows[rows] = False
        else:  # L+/L-/Q/QR
            # s = A x + b in K  =>  A_i x - s_i = -b_i  (s negated for L-)
            s_sgn = -1.0 if name == "L-" else 1.0
            slack_rows.extend(rows)
            slack_sign.extend([s_sgn] * d)
            kind = {"L+": "nonneg", "L-": "nonneg",
                    "Q": "soc", "QR": "rsoc"}[name]
            slack_cat.append((kind, d))
        i0 += d

    # --- permute columns into our order [soc, rsoc, free, zero, nonneg]
    groups = {"soc": [], "rsoc": [], "free": [], "zero": [], "nonneg": []}
    dims = {"soc": [], "rsoc": [], "free": 0, "zero": 0, "nonneg": 0}
    for kind, idx in var_cat:
        groups[kind].append(idx)
        if kind in ("soc", "rsoc"):
            dims[kind].append(len(idx))
        else:
            dims[kind] += len(idx)
    col = n
    for kind, d in slack_cat:
        groups[kind].append(np.arange(col, col + d))
        if kind in ("soc", "rsoc"):
            dims[kind].append(d)
        else:
            dims[kind] += d
        col += d

    order = ["soc", "rsoc", "free", "zero", "nonneg"]
    perm = np.concatenate(
        [idx for k in order for idx in groups[k]]
        or [np.arange(0)]).astype(int)
    cones = ConeSpec(soc=tuple(dims["soc"]), rsoc=tuple(dims["rsoc"]),
                     free=dims["free"], zero=dims["zero"],
                     nonneg=dims["nonneg"])
    return _EmbeddingPlan(sgn=sgn, slack_rows=slack_rows,
                          slack_sign=slack_sign, keep_rows=keep_rows,
                          perm=perm, cones=cones, n=n)


def embedding_signature(p: CBFProblem, relax_integrality=False):
    """(A.shape, ConeSpec) of the embedding WITHOUT assembling matrices
    -- the compile-bucketing signature for suite runners."""
    plan = _embedding_plan(p, relax_integrality=relax_integrality)
    m_kept = int(plan.keep_rows.sum())
    return ((m_kept, plan.perm.size), plan.cones)


def cbf_to_conic(p: CBFProblem, relax_integrality=False) -> ConicEmbedding:
    """Embed a parsed CBF problem into `min c'X s.t. A X = b, X in K`.

    Slack blocks turn conic constraint rows into equalities; free (F)
    constraint rows are vacuous and dropped; L- blocks are negated into
    the nonneg orthant; columns are permuted into our cone order.
    `recover` maps a solver solution back to CBF variable order
    (undoing permutation and sign flips).
    """
    plan = _embedding_plan(p, relax_integrality=relax_integrality)
    n, sgn, perm = plan.n, plan.sgn, plan.perm

    A_x = sp.coo_matrix(
        (np.array([v for (_, _, v) in p.a_coord]),
         (np.array([i for (i, _, _) in p.a_coord], int),
          np.array([j for (_, j, _) in p.a_coord], int))),
        shape=(p.m, n)).tocsc() if p.a_coord else sp.csc_matrix((p.m, n))
    bvec = np.zeros(p.m)
    for i, v in p.b_coord.items():
        bvec[i] = v

    n_slack = len(plan.slack_rows)
    # S has -s_sgn at (row, slack col): A x - sgn*s = -b
    S = sp.coo_matrix(
        (-np.asarray(plan.slack_sign), (np.asarray(plan.slack_rows, int),
                                        np.arange(n_slack))),
        shape=(p.m, n_slack)).tocsc()

    A_full = sp.hstack(
        [A_x.multiply(sgn[None, :]), S], format="csc")
    A_full = A_full[plan.keep_rows]
    b_full = -bvec[plan.keep_rows]
    c_full = np.zeros(n + n_slack)
    for j, v in p.obj_a.items():
        c_full[j] = v * sgn[j]
    if p.objsense == "MAX":
        c_full = -c_full

    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)

    def recover(x_ours: np.ndarray) -> np.ndarray:
        X = np.asarray(x_ours)[inv]          # back to [vars, slacks]
        return sgn * X[:n]                   # undo L- flips, drop slacks

    return ConicEmbedding(A=sp.csc_matrix(A_full)[:, perm].toarray(),
                          b=b_full, c=c_full[perm], cones=plan.cones,
                          recover=recover, objsense=p.objsense,
                          obj_b=p.obj_b, n_orig=n)


def parse_cbf_auto(path_or_text: str,
                   prefer_native: str = "auto") -> CBFProblem:
    """Parse CBF from a path (or raw text), choosing the parser.

    prefer_native: "auto" uses the C++ parser (native/abip_cbf.cpp) for
    FILES over ~1 MB when the library is buildable; "always" requires
    it (raises if unavailable); "never" forces pure Python.  Raw text
    input always takes the Python parser.  Both parsers accept the same
    grammar (parity-tested on the committed cblib-mini suite)."""
    if "\n" not in path_or_text and prefer_native != "never":
        import os as _os

        from . import native as _native

        if prefer_native == "always":
            return _native.parse_cbf_native(path_or_text)  # raises if absent
        if (_os.path.getsize(path_or_text) > (1 << 20)
                and _native.cbf_native_available()):
            return _native.parse_cbf_native(path_or_text)
    return parse_cbf(path_or_text)


def read_cbf(path: str, relax_integrality=False,
             prefer_native: str = "auto") -> ConicEmbedding:
    """Parse + embed a .cbf file (or raw CBF text); see
    :func:`cbf_to_conic` and :func:`parse_cbf_auto`."""
    return cbf_to_conic(parse_cbf_auto(path, prefer_native=prefer_native),
                        relax_integrality=relax_integrality)


def solve_cbf(path: str, settings=None, relax_integrality=False,
              device=None, **overrides):
    """Load a .cbf instance and solve it (the `test_cblib.m` role) on the
    CUDA card unless `device` says otherwise.

    Returns `(sol, x_cbf, objective)`: the solver solution object, the
    primal in CBF variable order, and the objective in the instance's
    own sense (MAX instances report the maximized value, `obj_b`
    included).
    """
    from ..dispatch import solve

    emb = read_cbf(path, relax_integrality=relax_integrality)
    sol = solve(emb.A, emb.b, emb.c, cones=emb.cones, settings=settings,
                device=device, **overrides)
    x = emb.recover(np.asarray(sol.x))
    return sol, x, emb.objective(float(sol.pobj))


def write_cbf(path: str, A, b, c, cones: ConeSpec, objsense="MIN",
              obj_b=0.0, comment=None):
    """Write a standard-form instance (our cone order) as CBF text.

    All constraints are equalities (`L=` rows with BCOORD -b, since CBF
    constraints read `A x + b in K`); variables are emitted in our block
    order, so :func:`read_cbf` round-trips to the same embedding."""
    A = sp.csc_matrix(A)
    m, n = A.shape
    cones.validate_dim(n)
    b = np.asarray(b, float).ravel()
    c = np.asarray(c, float).ravel()
    if objsense not in ("MIN", "MAX"):
        raise ValueError(f"objsense must be MIN or MAX, got {objsense!r}")

    blocks: List[Tuple[str, int]] = []
    blocks += [("Q", d) for d in cones.soc]
    blocks += [("QR", d) for d in cones.rsoc]
    if cones.free:
        blocks.append(("F", cones.free))
    if cones.zero:
        blocks.append(("L=", cones.zero))
    if cones.nonneg:
        blocks.append(("L+", cones.nonneg))

    Ac = A.tocoo()
    obj_nz = np.nonzero(c)[0]
    b_nz = np.nonzero(b)[0]
    out = []
    if comment:
        out.append(f"# {comment}")
    out += ["VER", "2", "", "OBJSENSE", objsense, ""]
    out += ["VAR", f"{n} {len(blocks)}"]
    out += [f"{name} {d}" for name, d in blocks]
    if m:  # a constraint-free instance has no CON section at all
        out += ["", "CON", f"{m} 1", f"L= {m}"]
    out += ["", "OBJACOORD", str(len(obj_nz))]
    out += [f"{j} {float(c[j])!r}" for j in obj_nz]
    if obj_b:
        out += ["", "OBJBCOORD", repr(float(obj_b))]
    out += ["", "ACOORD", str(Ac.nnz)]
    out += [f"{i} {j} {float(v)!r}"
            for i, j, v in zip(Ac.row, Ac.col, Ac.data)]
    # CBF rows read A x + b in K: equality A x = b_std needs BCOORD -b
    out += ["", "BCOORD", str(len(b_nz))]
    out += [f"{i} {float(-b[i])!r}" for i in b_nz]
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
