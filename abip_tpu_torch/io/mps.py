"""MPS format reader (a copy of `abip_tpu/io/mps.py`).

Pure-Python replacement for the MATLAB `mpsread` used by the reference
bench pipeline (`scripts/bench-lp/preprocess.m:15`).  Handles the standard
sections (ROWS, COLUMNS, RHS, RANGES, BOUNDS, OBJSENSE) in free format;
integer markers are rejected (ABIP is a continuous solver).
"""
from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp


@dataclasses.dataclass
class GeneralLP:
    """General-form LP:  min/max c'x + objcon
    s.t. row_lo <= A x <= row_hi,  lb <= x <= ub."""

    c: np.ndarray
    A: sp.csc_matrix
    row_lo: np.ndarray
    row_hi: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    objcon: float = 0.0
    maximize: bool = False
    name: str = ""
    col_names: Optional[List[str]] = None
    row_names: Optional[List[str]] = None


def _tokens(line: str) -> List[str]:
    return line.split()


def read_mps(path: str, prefer_native: str = "auto") -> GeneralLP:
    """Parse an MPS file (optionally .gz) into a GeneralLP.

    prefer_native: "auto" uses the C++ parser (native/abip_io.cpp) for
    plain files above 1 MB when available; "always"/"never" force it.
    """
    if prefer_native != "never" and not str(path).endswith(".gz"):
        from . import native as _native

        big = os.path.getsize(path) > 1_000_000 if os.path.exists(path) else False
        if (prefer_native == "always" or big) and _native.native_available():
            return _native.read_mps_native(path)

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        lines = f.readlines()

    section = None
    name = ""
    maximize = False
    obj_row: Optional[str] = None
    row_sense: Dict[str, str] = {}
    row_order: List[str] = []
    col_order: List[str] = []
    col_idx: Dict[str, int] = {}
    entries: List[Tuple[int, int, float]] = []  # (row, col, val)
    obj_coeffs: Dict[int, float] = {}
    rhs: Dict[str, float] = {}
    rhs_obj = 0.0
    ranges: Dict[str, float] = {}
    bounds: List[Tuple[str, str, Optional[float]]] = []
    row_idx: Dict[str, int] = {}
    in_integer = False

    def parse_error(lineno, raw, exc):
        return ValueError(
            f"MPS parse error at line {lineno} ({raw.strip()!r}) in section "
            f"{section}: {exc}"
        )

    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if not raw[0].isspace():
            toks = _tokens(raw)
            section = toks[0].upper()
            if section == "NAME":
                name = toks[1] if len(toks) > 1 else ""
            elif section == "OBJSENSE":
                # value may be on the same line or the next
                if len(toks) > 1:
                    maximize = toks[1].upper() in ("MAX", "MAXIMIZE")
                else:
                    nxt = lines[i].strip().upper()
                    maximize = nxt in ("MAX", "MAXIMIZE")
                    i += 1
            elif section == "ENDATA":
                break
            continue

        toks = _tokens(raw)
        try:
            if section == "ROWS":
                sense, rname = toks[0].upper(), toks[1]
                if sense == "N":
                    if obj_row is None:
                        obj_row = rname
                    # extra N rows are ignored (free rows)
                else:
                    row_sense[rname] = sense
                    row_idx[rname] = len(row_order)
                    row_order.append(rname)
            elif section == "COLUMNS":
                if len(toks) >= 3 and toks[1].upper() == "'MARKER'":
                    marker = toks[2].upper().strip("'")
                    if "INTORG" in marker:
                        in_integer = True
                    elif "INTEND" in marker:
                        in_integer = False
                    continue
                cname = toks[0]
                if in_integer:
                    raise ValueError(
                        f"integer variable {cname!r}: ABIP solves continuous LPs; "
                        "relax integrality before reading"
                    )
                if cname not in col_idx:
                    col_idx[cname] = len(col_order)
                    col_order.append(cname)
                j = col_idx[cname]
                for k in range(1, len(toks) - 1, 2):
                    rname, val = toks[k], float(toks[k + 1])
                    if rname == obj_row:
                        obj_coeffs[j] = obj_coeffs.get(j, 0.0) + val
                    elif rname in row_idx:
                        entries.append((row_idx[rname], j, val))
                    # coefficients on ignored free rows are dropped
            elif section == "RHS":
                # first token is the (arbitrary) rhs set name unless the line
                # pairs up without it
                start = 1 if len(toks) % 2 == 1 else 0
                for k in range(start, len(toks) - 1, 2):
                    rname, val = toks[k], float(toks[k + 1])
                    if rname == obj_row:
                        rhs_obj = val
                    elif rname in row_idx:
                        rhs[rname] = val
            elif section == "RANGES":
                start = 1 if len(toks) % 2 == 1 else 0
                for k in range(start, len(toks) - 1, 2):
                    rname, val = toks[k], float(toks[k + 1])
                    if rname in row_idx:
                        ranges[rname] = val
            elif section == "BOUNDS":
                # "BTYPE [SETNAME] COL [VAL]" -- the bound-set name is
                # optional, so a 3-token line is ambiguous between
                # "BTYPE SET COL" and "BTYPE COL VAL".  Disambiguate by
                # column-name membership (COLUMNS precedes BOUNDS) and by
                # whether the bound type requires a value.
                btype = toks[0].upper()
                needs_val = btype in ("LO", "UP", "FX", "LI", "UI")
                if len(toks) >= 4:
                    cname, vtok = toks[2], toks[3]
                elif len(toks) == 3:
                    if needs_val:
                        if toks[1] in col_idx:
                            cname, vtok = toks[1], toks[2]  # no set name
                        elif toks[2] in col_idx:
                            raise ValueError(
                                f"bound type {btype} requires a value for "
                                f"column {toks[2]!r}"
                            )
                        else:
                            raise ValueError(
                                f"unknown column in BOUNDS line: {toks[1]!r}"
                                f"/{toks[2]!r}"
                            )
                    else:
                        cname = toks[2] if toks[2] in col_idx else toks[1]
                        vtok = None
                elif len(toks) == 2 and not needs_val:
                    cname, vtok = toks[1], None
                else:
                    raise ValueError(
                        f"malformed BOUNDS line (type {btype}, "
                        f"{len(toks)} tokens)"
                    )
                if cname not in col_idx:
                    raise ValueError(
                        f"unknown column in BOUNDS line: {cname!r}"
                    )
                if needs_val and vtok is None:
                    raise ValueError(
                        f"bound type {btype} requires a value for column "
                        f"{cname!r}"
                    )
                val = float(vtok) if vtok is not None else None
                bounds.append((btype, cname, val))

        except (IndexError, KeyError) as e:
            raise parse_error(i, raw, e) from e
        except ValueError as e:
            if "MPS parse error" in str(e):
                raise
            raise parse_error(i, raw, e) from e
    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")

    n = len(col_order)
    m = len(row_order)
    c = np.zeros(n)
    for j, v in obj_coeffs.items():
        c[j] = v

    if entries:
        r, cc, v = zip(*entries)
        A = sp.coo_matrix((v, (r, cc)), shape=(m, n)).tocsc()
    else:
        A = sp.csc_matrix((m, n))

    # row activities: sense + rhs + ranges -> [row_lo, row_hi]
    # (standard MPS RANGES semantics)
    row_lo = np.full(m, -np.inf)
    row_hi = np.full(m, np.inf)
    for rname in row_order:
        k = row_idx[rname]
        s = row_sense[rname]
        rv = rhs.get(rname, 0.0)
        if s == "E":
            row_lo[k] = row_hi[k] = rv
        elif s == "L":
            row_hi[k] = rv
        elif s == "G":
            row_lo[k] = rv
        if rname in ranges:
            rng = ranges[rname]
            if s == "E":
                if rng >= 0:
                    row_hi[k] = rv + rng
                else:
                    row_lo[k] = rv + rng
            elif s == "L":
                row_lo[k] = rv - abs(rng)
            elif s == "G":
                row_hi[k] = rv + abs(rng)

    lb = np.zeros(n)
    ub = np.full(n, np.inf)
    for btype, cname, val in bounds:
        j = col_idx[cname]  # membership validated at parse time
        if btype == "LO":
            lb[j] = val
        elif btype == "UP":
            ub[j] = val
            # MPS quirk: UP with negative value and default lb 0 makes lb -inf
            if val is not None and val < 0 and lb[j] == 0.0:
                lb[j] = -np.inf
        elif btype == "FX":
            lb[j] = ub[j] = val
        elif btype == "FR":
            lb[j], ub[j] = -np.inf, np.inf
        elif btype == "MI":
            lb[j] = -np.inf
        elif btype == "PL":
            ub[j] = np.inf
        elif btype in ("BV", "LI", "UI"):
            raise ValueError(f"integer bound type {btype} not supported")
        else:
            raise ValueError(f"unknown bound type {btype!r}")

    return GeneralLP(
        c=c, A=A, row_lo=row_lo, row_hi=row_hi, lb=lb, ub=ub,
        objcon=-rhs_obj,  # RHS on the objective row is a negated constant
        maximize=maximize, name=name,
        col_names=col_order, row_names=row_order,
    )
