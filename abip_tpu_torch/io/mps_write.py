"""MPS format writer (a copy of `abip_tpu/io/mps_write.py`).

Inverse of `mps.read_mps`: serializes a `GeneralLP` to free-format MPS so
generated instances can round-trip through the full
parser -> presolve -> solve -> recover pipeline the way the reference's
Netlib runs do (`scripts/bench-lp/preprocess.m:15`,
`test_one_abip.m:29-37`).

Row-bound encoding (exact inverse of the reader's RANGES rules):

  lo == hi            -> E row, RHS lo
  lo = -inf, hi fin.  -> L row, RHS hi
  lo fin., hi = inf   -> G row, RHS lo
  both finite, lo<hi  -> L row, RHS hi, RANGES hi-lo
  both infinite       -> rejected (a free row carries no information; the
                         reader drops extra N rows, so a round-trip would
                         not preserve it)
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .mps import GeneralLP


def _fmt(x: float) -> str:
    """Full-precision, compact numeric token (parseable by float())."""
    return repr(float(x))


def write_mps(p: GeneralLP, path: str, name: Optional[str] = None) -> None:
    m, n = p.A.shape
    rnames: List[str] = (
        list(p.row_names) if p.row_names else [f"R{i}" for i in range(m)]
    )
    cnames: List[str] = (
        list(p.col_names) if p.col_names else [f"X{j}" for j in range(n)]
    )
    if len(rnames) != m or len(cnames) != n:
        raise ValueError("row/col name lengths do not match A")

    out: List[str] = []
    out.append(f"NAME          {name or p.name or 'ABIPGEN'}")
    if p.maximize:
        out.append("OBJSENSE")
        out.append("    MAX")

    out.append("ROWS")
    out.append(" N  OBJ")
    senses: List[str] = []
    for i in range(m):
        lo, hi = p.row_lo[i], p.row_hi[i]
        if np.isinf(lo) and np.isinf(hi):
            raise ValueError(f"row {rnames[i]} is free (both bounds inf)")
        if lo == hi:
            s = "E"
        elif np.isinf(lo):
            s = "L"
        elif np.isinf(hi):
            s = "G"
        else:
            s = "L"  # ranged: L + RANGES entry
        senses.append(s)
        out.append(f" {s}  {rnames[i]}")

    out.append("COLUMNS")
    A = p.A.tocsc()
    for j in range(n):
        nnz_lines = 0
        for k in range(A.indptr[j], A.indptr[j + 1]):
            i = A.indices[k]
            v = A.data[k]
            if v != 0.0:
                out.append(f"    {cnames[j]}  {rnames[i]}  {_fmt(v)}")
                nnz_lines += 1
        # a column must appear at least once or the reader never registers
        # the variable (and any BOUNDS line for it then errors), so emit
        # the objective entry even when c[j] == 0 for empty columns
        if p.c[j] != 0.0 or nnz_lines == 0:
            out.append(f"    {cnames[j]}  OBJ  {_fmt(p.c[j])}")

    out.append("RHS")
    for i in range(m):
        lo, hi = p.row_lo[i], p.row_hi[i]
        rv = lo if senses[i] in ("E", "G") else hi
        if rv != 0.0:
            out.append(f"    RHS  {rnames[i]}  {_fmt(rv)}")
    if p.objcon != 0.0:
        # reader maps objective-row RHS r to objcon = -r
        out.append(f"    RHS  OBJ  {_fmt(-p.objcon)}")

    ranged = [
        i for i in range(m)
        if np.isfinite(p.row_lo[i]) and np.isfinite(p.row_hi[i])
        and p.row_lo[i] < p.row_hi[i]
    ]
    if ranged:
        out.append("RANGES")
        for i in ranged:
            out.append(
                f"    RNG  {rnames[i]}  {_fmt(p.row_hi[i] - p.row_lo[i])}"
            )

    blines: List[str] = []
    for j in range(n):
        lo, hi = p.lb[j], p.ub[j]
        if lo == 0.0 and np.isinf(hi):
            continue  # MPS default
        if np.isinf(lo) and np.isinf(hi):
            blines.append(f" FR BND  {cnames[j]}")
        elif lo == hi:
            blines.append(f" FX BND  {cnames[j]}  {_fmt(lo)}")
        else:
            if np.isinf(lo):
                blines.append(f" MI BND  {cnames[j]}")
            elif lo != 0.0:
                blines.append(f" LO BND  {cnames[j]}  {_fmt(lo)}")
            if np.isfinite(hi):
                # note: hi<0 with lo==0 would trip the reader's negative-UP
                # quirk (lb -> -inf), but that combination is an empty box
                # and rejected by any valid instance
                blines.append(f" UP BND  {cnames[j]}  {_fmt(hi)}")
    if blines:
        out.append("BOUNDS")
        out.extend(blines)

    out.append("ENDATA")
    if str(path).endswith(".gz"):
        import gzip

        with gzip.open(path, "wt") as f:
            f.write("\n".join(out) + "\n")
    else:
        with open(path, "w") as f:
            f.write("\n".join(out) + "\n")
