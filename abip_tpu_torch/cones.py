"""Cone specifications and the f64 cone barrier prox, batched over lanes.

Port of `abip_tpu/cones.py`.  `ConeSpec` and `ConeLayout` are the
reference's numpy/dataclass code, copied (the reference module imports
JAX).  The prox works on `(B, n)` tensors: every lane shares one layout,
or (`PaddedConeLayout`) each lane has its own, padded to one width.

SOC/RSOC blocks are contiguous ranges of the cone tail
([soc..., rsoc..., free, zero, nonneg], `source/abip.c:358-409`).  One
description of them serves every consumer: `ConeOperands`, per-element
class codes and per-block (start, length, type) rows, which the CUDA
kernels read as they are and the PyTorch code reads through `Blocks`.
Block sums gather each block's body into a zero-padded `(nb, L)` index
table and sum along the last axis: a reduction whose order is fixed, so
it gives the same bits from run to run (no atomics).

The deep scalar branching of the C prox (`cones.c:130-248`) stays the
reference's domain-safe `where` chains, with the f64 guards `_TINY`
and `_SOC_TOL`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

_TINY = 1e-300  # guard for divisions in untaken branches
_SOC_TOL = 1e-9  # |a| threshold (`cones.c:133,137`)


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """Cone structure K = soc x rsoc x free x zero x nonneg.

    Mirrors the reference `ABIPCone {f,z,l,q,rq}` with the dims
    validation of `cones.c:37-82`.
    """

    soc: Tuple[int, ...] = ()
    rsoc: Tuple[int, ...] = ()
    free: int = 0
    zero: int = 0
    nonneg: int = 0

    def __post_init__(self):
        for q in self.soc:
            if q < 1:
                raise ValueError(f"soc cone dims must be >= 1; got {q}")
        for q in self.rsoc:
            if q < 3:
                raise ValueError(f"rsoc cone dims must be >= 3; got {q}")
        if self.free < 0 or self.zero < 0 or self.nonneg < 0:
            raise ValueError("cone dims must be nonnegative")

    @property
    def dim(self) -> int:
        return sum(self.soc) + sum(self.rsoc) + self.free + self.zero + self.nonneg

    @classmethod
    def lp(cls, n: int) -> "ConeSpec":
        return cls(nonneg=n)

    def validate_dim(self, n: int):
        if self.dim != n:
            raise ValueError(
                f"cone dimensions {self.dim} do not match problem dim n = {n}"
            )


# element-class codes used in the layout arrays
_NONNEG, _FREE, _ZERO, _SOC, _RSOC = 0, 1, 2, 3, 4


class ConeLayout:
    """Static (numpy) index structure compiled from a ConeSpec."""

    def __init__(self, spec: ConeSpec):
        self.spec = spec
        n = spec.dim
        kind = np.zeros(n, np.int32)
        seg = np.zeros(n, np.int64)      # element -> block id (soc/rsoc only)
        head = np.zeros(n, np.int32)     # 1 for block head, 2 for rsoc 2nd head
        block_start = []                 # head element index per block

        pos = 0
        blk = 0
        for q in spec.soc:
            if q == 1:
                # 1-d SOC is the nonneg ray (`source/abip.c:364-367`)
                kind[pos] = _NONNEG
                seg[pos] = blk
            else:
                kind[pos : pos + q] = _SOC
                seg[pos : pos + q] = blk
                head[pos] = 1
            block_start.append(pos)
            pos += q
            blk += 1
        for q in spec.rsoc:
            kind[pos : pos + q] = _RSOC
            seg[pos : pos + q] = blk
            head[pos] = 1
            head[pos + 1] = 2
            block_start.append(pos)
            pos += q
            blk += 1
        kind[pos : pos + spec.free] = _FREE
        pos += spec.free
        kind[pos : pos + spec.zero] = _ZERO
        pos += spec.zero
        kind[pos : pos + spec.nonneg] = _NONNEG
        pos += spec.nonneg
        assert pos == n

        self.n = n
        self.num_blocks = max(blk, 1)
        self.kind = kind
        self.seg = seg
        self.head = head
        self.block_start = np.asarray(block_start, np.int64) if block_start else np.zeros(1, np.int64)
        self.has_blocks = blk > 0
        self.has_soc = bool((kind == _SOC).any())
        self.has_rsoc = bool((kind == _RSOC).any())

    # ---------------------------------------------------------------- #
    def interior_point(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """Cone-aware cold start (`source/abip.c:925-976`): SOC head = 1,
        RSOC heads = (1,1), nonneg = 1, free/zero = 0."""
        x = np.zeros(self.n, dtype=np.float64)
        x[self.kind == _NONNEG] = 1.0
        x[self.head > 0] = 1.0
        x[(self.kind == _FREE) | (self.kind == _ZERO)] = 0.0
        return torch.as_tensor(x, dtype=dtype, device=device)

    def interiorize(self, x: np.ndarray, floor: float,
                    dual: bool = False) -> np.ndarray:
        """Project a caller-provided point safely into the cone interior
        (host-side, warm-start path; a copy of
        `abip_tpu/cones.py:144-184`).

        The reference has no conic warm start (its `ABIP(init)`/`ABIP(solve)`
        split, `source/abip.c:1271-1311`, reuses the factorization but
        always cold-starts); this is the conic analogue of the LP driver's
        floored warm start.  `dual=True` maps through K*: the dual of the
        free cone is {0} and of the zero cone is free (self-dual otherwise).
        """
        x = np.array(x, dtype=np.float64, copy=True)
        kind = self.kind
        nn = kind == _NONNEG
        x[nn] = np.maximum(x[nn], floor)
        if dual:
            x[kind == _FREE] = 0.0
        else:
            x[kind == _ZERO] = 0.0
        if self.has_blocks:
            seg = self.seg
            h1 = (self.head == 1)
            h2 = (self.head == 2)
            body = ((kind == _SOC) | (kind == _RSOC)) & ~h1 & ~h2
            nb = self.num_blocks
            bsq = np.zeros(nb)
            np.add.at(bsq, seg[body], x[body] ** 2)
            # SOC: head >= ||body|| + floor
            soc_h = h1 & (kind == _SOC)
            x[soc_h] = np.maximum(x[soc_h],
                                  np.sqrt(bsq[seg[soc_h]]) + floor)
            # RSOC: t1 >= floor, then t2 >= ||body||^2/(2 t1) + floor
            r1 = h1 & (kind == _RSOC)
            r2 = h2 & (kind == _RSOC)
            x[r1] = np.maximum(x[r1], floor)
            t1 = np.zeros(nb)
            t1[seg[r1]] = x[r1]
            need = bsq[seg[r2]] / np.maximum(2.0 * t1[seg[r2]], _TINY) + floor
            x[r2] = np.maximum(x[r2], need)
        return x

    def segment_mean_tie(self, e: torch.Tensor) -> torch.Tensor:
        """Replace entries within each soc/rsoc block by the block mean
        (`source/qcp_config.c:194-212`); `e` is `(B, n)`."""
        if not self.has_blocks:
            return e
        return _mean_tie(e, cone_operands(self.spec, e.device))


# element classes of a cone tail, as the kernels read them
# (`csrc/conic_common.cuh` uses the same codes)
(E_NN, E_FREE, E_ZERO, E_SOC_H, E_SOC_B, E_RSOC_H1, E_RSOC_H2,
 E_RSOC_B) = range(8)


class ConeOperands(NamedTuple):
    """The cone structure of a batch (every lane shares it).  Blocks are
    the SOC blocks of dimension >= 2 and the RSOC blocks, in layout
    order; a 1-d SOC is a nonneg element."""

    code: torch.Tensor    # (n,) int32 element class E_*
    blk: torch.Tensor     # (n,) int32 block of each SOC/RSOC element (else 0)
    start: torch.Tensor   # (nb,) int32 head element of each block
    length: torch.Tensor  # (nb,) int32 elements in the block
    soc: torch.Tensor     # (nb,) int32 1 for SOC, 0 for RSOC
    body: torch.Tensor    # (nb, L) int64 body elements padded with n


@functools.lru_cache(maxsize=None)
def _cone_operands_np(spec: ConeSpec):
    lay = ConeLayout(spec)
    n = lay.n
    code = np.full(n, E_NN, np.int32)
    code[lay.kind == _FREE] = E_FREE
    code[lay.kind == _ZERO] = E_ZERO
    blk = np.zeros(n, np.int32)
    start, length, soc, body = [], [], [], []
    pos = 0
    for q in spec.soc:
        if q > 1:
            code[pos] = E_SOC_H
            code[pos + 1:pos + q] = E_SOC_B
            blk[pos:pos + q] = len(start)
            start.append(pos), length.append(q), soc.append(1)
            body.append(np.arange(pos + 1, pos + q))
        pos += q
    for q in spec.rsoc:
        code[pos] = E_RSOC_H1
        code[pos + 1] = E_RSOC_H2
        code[pos + 2:pos + q] = E_RSOC_B
        blk[pos:pos + q] = len(start)
        start.append(pos), length.append(q), soc.append(0)
        body.append(np.arange(pos + 2, pos + q))
        pos += q
    table = np.full((len(start), max([1] + [len(r) for r in body])), n,
                    np.int64)
    for k, r in enumerate(body):
        table[k, :len(r)] = r
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return code, blk, i32(start), i32(length), i32(soc), table


def cone_operands(spec: ConeSpec, device=None) -> ConeOperands:
    """The `ConeOperands` of a `ConeSpec` on `device`."""
    return ConeOperands(*[torch.from_numpy(np.ascontiguousarray(x)).to(device)
                          for x in _cone_operands_np(spec)])


def _padded_operands_np(spec: ConeSpec, n_pad: int, nb_pad: int):
    """One lane's operands embedded at n_pad elements and nb_pad blocks:
    padded elements are zero-cone, unused block rows an empty SOC block
    at element 0 (never gathered back: no element names it), and body
    indices that pointed past the lane's n point past n_pad."""
    code, blk, start, length, soc, body = _cone_operands_np(spec)
    n, nb = code.shape[0], start.shape[0]
    codep = np.full(n_pad, E_ZERO, np.int32)
    codep[:n] = code
    blkp = np.zeros(n_pad, np.int32)
    blkp[:n] = blk
    rows = lambda x, fill: np.concatenate(  # noqa: E731
        [x, np.full(nb_pad - nb, fill, np.int32)])
    bodyp = np.full((nb_pad, body.shape[1]), n_pad, np.int64)
    bodyp[:nb] = np.where(body >= n, n_pad, body)
    return (codep, blkp, rows(start, 0), rows(length, 1), rows(soc, 1),
            bodyp)


class PaddedConeLayout:
    """A cone layout per lane, padded to one element count (port of
    `abip_tpu/cones.py:199-286`): one batch solves instances whose cone
    structures differ.

    Each lane's `ConeLayout` arrays (`kind`, `seg`, `head`) are padded to
    n_pad elements with ZERO-cone elements: the prox pins them to 0, so
    with zero A columns and c entries they are inert.  `from_layout`
    embeds one layout (arrays `(n_pad,)`, operands shared by every
    lane); `stack` one layout per lane (arrays `(B, n_pad)`, operands
    with a lane axis).  `has_soc`/`has_rsoc` are suite-wide ORs: a lane
    without SOC blocks masks the SOC math out elementwise.  It offers the
    `ConeLayout` surface the steps engine uses: `interior_point`,
    `segment_mean_tie` and `operands`."""

    def __init__(self, specs, kind, seg, head, n, num_blocks, has_blocks,
                 has_soc, has_rsoc, lanes):
        self.specs = tuple(specs)
        self.kind, self.seg, self.head = kind, seg, head
        self.n = n
        self.num_blocks = num_blocks
        self.has_blocks = has_blocks
        self.has_soc = has_soc
        self.has_rsoc = has_rsoc
        self.lanes = lanes          # False: one layout shared by every lane

    @classmethod
    def from_layout(cls, lay: ConeLayout, n_pad: int,
                    nb_pad: int) -> "PaddedConeLayout":
        if n_pad < lay.n:
            raise ValueError(f"n_pad {n_pad} < layout dim {lay.n}")
        if nb_pad < lay.num_blocks:
            raise ValueError(
                f"nb_pad {nb_pad} < layout blocks {lay.num_blocks}")
        kind = np.full(n_pad, _ZERO, np.int32)
        seg = np.zeros(n_pad, np.int32)
        head = np.zeros(n_pad, np.int32)
        kind[:lay.n] = lay.kind
        seg[:lay.n] = lay.seg.astype(np.int32)
        head[:lay.n] = lay.head
        return cls((lay.spec,), kind, seg, head, n_pad, nb_pad,
                   lay.has_blocks, lay.has_soc, lay.has_rsoc, lanes=False)

    @classmethod
    def stack(cls, specs, n_pad: int | None = None) -> "PaddedConeLayout":
        """Stack per-lane ConeSpecs into one batched layout of shape
        (B, n_pad) with suite-wide flags."""
        lays = [ConeLayout(s) for s in specs]
        n_pad = max(lay.n for lay in lays) if n_pad is None else n_pad
        nb_pad = max(lay.num_blocks for lay in lays)
        padded = [cls.from_layout(lay, n_pad, nb_pad) for lay in lays]
        return cls(specs, np.stack([p.kind for p in padded]),
                   np.stack([p.seg for p in padded]),
                   np.stack([p.head for p in padded]), n_pad, nb_pad,
                   any(lay.has_blocks for lay in lays),
                   any(lay.has_soc for lay in lays),
                   any(lay.has_rsoc for lay in lays), lanes=True)

    def operands(self, device=None) -> ConeOperands:
        """The `ConeOperands` on `device`: without a lane axis for
        `from_layout`, with one (`code`/`blk` `(B, n_pad)`, block rows
        `(B, nb_pad)`, the body table `(B, nb_pad, L)`) for `stack`."""
        lanes = [_padded_operands_np(s, self.n, self.num_blocks)
                 for s in self.specs]
        L = max(lane[5].shape[1] for lane in lanes)
        lanes = [lane[:5] + (np.pad(
            lane[5], ((0, 0), (0, L - lane[5].shape[1])),
            constant_values=self.n),) for lane in lanes]
        fields = (zip(*lanes) if self.lanes else lanes[0])
        return ConeOperands(*[
            torch.from_numpy(np.ascontiguousarray(
                np.stack(f) if self.lanes else f)).to(device)
            for f in fields])

    def interior_point(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """Cone-aware cold start (`source/abip.c:925-976`): SOC/RSOC
        heads and nonneg elements start at 1, the rest (padding
        included) at 0."""
        one = (self.kind == _NONNEG) | (self.head > 0)
        return torch.as_tensor(one.astype(np.float64), dtype=dtype,
                               device=device)

    def segment_mean_tie(self, e: torch.Tensor) -> torch.Tensor:
        """See `ConeLayout.segment_mean_tie` (`qcp_config.c:194-212`)."""
        if not self.has_blocks:
            return e
        return _mean_tie(e, self.operands(e.device))


def layout_operands(layout, device=None) -> ConeOperands:
    """The `ConeOperands` of a `ConeLayout` or `PaddedConeLayout`."""
    if isinstance(layout, PaddedConeLayout):
        return layout.operands(device)
    return cone_operands(layout.spec, device)


def _mean_tie(e, co: ConeOperands):
    bl = Blocks.of(co)
    sums = bl.head(e) + bl.head2(e) + bl.body_sum(e)
    means = sums / co.length.to(e.dtype)
    return torch.where(co.code >= E_SOC_H, bl.gather(means), e)


class Blocks(NamedTuple):
    """Gathers over the blocks of `ConeOperands` for `(B, n)` rows: block
    scalars come out as `(B, nb)`, per-block values go back to the
    elements.  Operands shared by every lane index each row alike;
    operands with a lane axis (a `PaddedConeLayout`'s) index row b by
    lane b's own blocks (`torch.gather` along dim 1)."""

    start: torch.Tensor
    start2: torch.Tensor
    soc: torch.Tensor
    blk: torch.Tensor
    body: torch.Tensor

    @staticmethod
    def of(co: ConeOperands) -> "Blocks":
        start = co.start.long()
        return Blocks(start, start + 1, co.soc > 0, co.blk.long(), co.body)

    @property
    def per_lane(self) -> bool:
        return self.blk.dim() == 2

    def _take(self, x, idx):
        if self.per_lane:
            return x.gather(1, idx)
        return x[:, idx]

    def head(self, x):
        return self._take(x, self.start)

    def head2(self, x):
        """RSOC second heads; 0 on SOC blocks (whose element after the
        head is a body element)."""
        return torch.where(self.soc, torch.zeros((), dtype=x.dtype,
                                                 device=x.device),
                           self._take(x, self.start2))

    def body_sum(self, x):
        ext = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
        if self.per_lane:
            B, nb, L = self.body.shape
            return ext.gather(1, self.body.reshape(B, nb * L)).reshape(
                B, nb, L).sum(-1)
        return ext[:, self.body].sum(-1)

    def gather(self, v):
        """Per-block `(B, nb)` values at each element of their block."""
        return self._take(v, self.blk)

    def scatter(self, h1, h2, sc, x, code):
        """Per element: block head -> h1, RSOC second head -> h2, body
        -> sc * x."""
        return torch.where((code == E_SOC_H) | (code == E_RSOC_H1),
                           self.gather(h1),
                           torch.where(code == E_RSOC_H2, self.gather(h2),
                                       self.gather(sc) * x))


# -------------------------------------------------------------------- #
# prox kernels                                                         #
# -------------------------------------------------------------------- #
def _nonneg_prox(t, lam):
    """Positive-orthant barrier prox (`cones.c:279-289`):
    the positive root of u^2 - t*u - lam = 0, branch-free and stable."""
    pos = 0.5 * (t + torch.sqrt(t * t + 4.0 * lam))
    neg = 2.0 * lam / (-t * (1.0 + torch.sqrt(1.0 + 4.0 * lam / (t * t + _TINY))) + _TINY)
    return torch.where(t >= 0, pos, neg)


def _soc_blocks(t, lam_e, co: ConeOperands):
    """SOC barrier prox on all SOC blocks at once (`cones.c:130-161`).

    t, lam_e: `(B, n)`.  Returns the prox value for elements in SOC
    blocks (garbage elsewhere)."""
    bl = Blocks.of(co)
    bsq = bl.body_sum(t * t)                     # ||b||^2
    a = bl.head(t)                               # t[0]
    lam = torch.clamp(bl.head(lam_e), min=_TINY)

    # branch |a| <= tol  (`cones.c:137-140`)
    x0_zero = torch.sqrt(2.0 * lam + bsq / 4.0)
    scale_zero = 0.5

    # branch |a| > tol  (`cones.c:141-159`)
    denom_r = 8.0 * lam - a * a + bsq
    r = 16.0 * a * a / (
        denom_r + torch.sqrt(denom_r * denom_r + 32.0 * a * a * lam) + _TINY
    )
    disc = torch.sqrt(torch.clamp(r * (r + 8.0), min=0.0))
    s1 = (r - disc) / 2.0
    s2 = (r + disc) / 2.0
    s = torch.where(a > 0, s2, s1)
    s_safe = torch.where(torch.abs(s) < _TINY, torch.full_like(s, _TINY), s)
    eta = (s + 2.0) * a / s_safe
    scale_pos = (s + 2.0) / (s + 4.0)

    small_a = torch.abs(a) <= _SOC_TOL
    x0 = torch.where(small_a, x0_zero, eta)
    scale = torch.where(small_a, torch.full_like(scale_pos, scale_zero),
                        scale_pos)

    # scatter back
    return bl.scatter(x0, x0, scale, t, co.code)


def _rsoc_blocks(t, lam_e, co: ConeOperands):
    """RSOC barrier prox on all RSOC blocks at once (`cones.c:169-248`).

    K = {(t1,t2,x) : 2 t1 t2 >= ||x||^2, t1,t2 >= 0}.
    """
    bl = Blocks.of(co)
    ze = bl.head(t)                              # zeta_eta
    zn = bl.head2(t)                             # zeta_nu
    zxsq = bl.body_sum(t * t)
    lam = torch.clamp(bl.head(lam_e), min=_TINY)

    sum_zz = ze + zn
    d = 2.0 * ze * zn - zxsq          # the discriminating quantity
    g = d / (2.0 * lam)               # appears throughout `cones.c:191-215`
    one = torch.ones_like(g)
    g_neg = torch.where(g < 0, -g, one)  # guard: used only when d < 0
    g_pos = torch.where(g > 0, g, one)   # guard: used only when d > 0
    q = 4.0 * (ze * ze + zn * zn + zxsq) / lam + 16.0

    # w for d < 0 (`cones.c:192-202`)
    w_neg = (2.0 * sum_zz * sum_zz / lam) / g_neg / (
        1.0 + 4.0 / g_neg + torch.sqrt(1.0 + q / (g_neg * g_neg))
    )
    # w for d >= 0 (`cones.c:204-214`)
    w_pos = g_pos * (1.0 - 4.0 / g_pos + torch.sqrt(1.0 + q / (g_pos * g_pos))) / 2.0
    w = torch.where(d < 0, w_neg, w_pos)

    root = torch.sqrt(torch.clamp(w * (w + 4.0), min=0.0))
    # sum_zz > 0 branch (`cones.c:216-221`)
    s_a = (w + root) / 2.0
    # sum_zz <= 0, w > 10 (`cones.c:223-228`): s near 0 via conjugate form
    s_b = 2.0 / (w + 2.0 + root + _TINY)
    # sum_zz <= 0, w <= 10 (`cones.c:229-235`)
    s_c = (w - root) / 2.0

    def guard(den):
        return torch.where(torch.abs(den) < _TINY, torch.full_like(den, _TINY),
                           den)

    def heads_std(s):
        den = guard(s * (s + 2.0))
        x1 = (ze * (s + 1.0) ** 2 + zn * (s + 1.0)) / den
        x2 = (zn * (s + 1.0) ** 2 + ze * (s + 1.0)) / den
        return x1, x2, (s + 1.0) / (s + 2.0)

    def heads_b(s):
        den = guard((s - 1.0) * (s + 1.0))
        x1 = (ze * s * s + zn * s) / den
        x2 = (zn * s * s + ze * s) / den
        return x1, x2, s / (s + 1.0)

    xa1, xa2, sca = heads_std(s_a)
    xb1, xb2, scb = heads_b(s_b)
    xc1, xc2, scc = heads_std(s_c)

    pos_branch = sum_zz > 0
    b_branch = (~pos_branch) & (w > 10.0)
    x1 = torch.where(pos_branch, xa1, torch.where(b_branch, xb1, xc1))
    x2 = torch.where(pos_branch, xa2, torch.where(b_branch, xb2, xc2))
    sc = torch.where(pos_branch, sca, torch.where(b_branch, scb, scc))

    # degenerate sum_zz == 0 branch (`cones.c:181-188`), completed as the
    # reference package completes it: x1 = x2 + ze
    x2_deg = (-ze + torch.sqrt(ze * ze + 4.0 * lam + zxsq)) / 2.0
    deg = sum_zz == 0
    x1 = torch.where(deg, x2_deg + ze, x1)
    x2 = torch.where(deg, x2_deg, x2)
    sc = torch.where(deg, torch.full_like(sc, 0.5), sc)

    return bl.scatter(x1, x2, sc, t, co.code)


def cone_barrier_prox(t: torch.Tensor, lam_e: torch.Tensor,
                      layout: ConeLayout, co: ConeOperands = None
                      ) -> torch.Tensor:
    """Full cone-tail barrier prox (`solve_barrier_subproblem`,
    `source/abip.c:326-413`) for all cone classes at once.

    t: `(B, n)`; lam_e: per-element lambda = mu/(beta*rho_i), `(B, n)`
    or broadcastable to it; `layout` a `ConeLayout` or a
    `PaddedConeLayout`.  `co` is the layout's `ConeOperands` on t's
    device: a caller that applies the prox on every iteration builds it
    once and passes it, so that no call copies the layout to the device;
    without it the call builds its own.
    """
    lam_e = torch.broadcast_to(lam_e, t.shape)
    if co is None:
        co = layout_operands(layout, t.device)
    code = co.code
    out = torch.where(code == E_NN, _nonneg_prox(t, lam_e), t)  # free: identity
    out = torch.where(code == E_ZERO, torch.zeros_like(out), out)
    if layout.has_soc:
        out = torch.where((code == E_SOC_H) | (code == E_SOC_B),
                          _soc_blocks(t, lam_e, co), out)
    if layout.has_rsoc:
        out = torch.where(code >= E_RSOC_H1, _rsoc_blocks(t, lam_e, co), out)
    return out


# -------------------------------------------------------------------- #
# Euclidean projection                                                 #
# -------------------------------------------------------------------- #
_PROJ_TINY = 1e-300  # the reference's `_TINY` guard of nu


def cone_project(z: torch.Tensor, layout: ConeLayout, dual: bool = False,
                 co: ConeOperands = None) -> torch.Tensor:
    """Euclidean projection Pi_K(z), or onto the dual cone K* with
    `dual` (port of `abip_tpu/cones.py:477-536`); `z` is `(..., n)`.

    Per block (self-dual blocks project identically under `dual`):
      free:   z            (dual cone of free is {0})
      zero:   0            (dual cone of {0} is free)
      nonneg: max(z, 0)
      SOC (t, u), nu = ||u||:  z if nu <= t;  0 if nu <= -t;
          else ((t+nu)/2) * (1, u/nu)                (Moreau three-branch)
      RSOC: conjugate by the orthogonal rotation H mapping
          (t1, t2) -> ((t1+t2)/sqrt2, (t1-t2)/sqrt2): Pi_R = H Pi_SOC H.
    `co` is the layout's `ConeOperands` on z's device (built when None).
    """
    if co is None:
        co = cone_operands(layout.spec, z.device)
    x = z.reshape(-1, layout.n)
    code = co.code
    free_k, zero_k = (E_ZERO, E_FREE) if dual else (E_FREE, E_ZERO)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = torch.where(code == E_NN, torch.clamp(x, min=0.0), x)
    out = torch.where(code == zero_k, zero, out)
    out = torch.where(code == free_k, x, out)
    if not layout.has_blocks:
        return out.reshape(z.shape)

    bl = Blocks.of(co)
    rt2 = torch.sqrt(torch.tensor(2.0, dtype=x.dtype, device=x.device))
    rsoc = ~bl.soc
    t1b, t2b = bl.head(x), bl.head2(x)
    # the SOC head in rotated coordinates; the rotated RSOC "b" component
    # joins the body norm
    t_blk = torch.where(rsoc, (t1b + t2b) / rt2, t1b)
    b_rot = (t1b - t2b) / rt2
    bsq = bl.body_sum(x * x) + torch.where(rsoc, b_rot * b_rot, zero)
    nu = torch.sqrt(bsq)
    keep = nu <= t_blk
    kill = nu <= -t_blk
    alpha = 0.5 * (t_blk + nu)
    head_out = torch.where(keep, t_blk, torch.where(kill, zero, alpha))
    fac = torch.where(keep, torch.ones_like(nu), torch.where(
        kill, zero, alpha / torch.clamp(nu, min=_PROJ_TINY)))
    b_out = b_rot * fac
    head1 = torch.where(rsoc, (head_out + b_out) / rt2, head_out)
    head2 = (head_out - b_out) / rt2
    blocks = bl.scatter(head1, head2, fac, x, code)
    out = torch.where(code >= E_SOC_H, blocks, out)
    return out.reshape(z.shape)


def cone_membership_violation(x: torch.Tensor,
                              layout: ConeLayout) -> torch.Tensor:
    """Max violation of K-membership (port of `abip_tpu/cones.py:448-474`)
    per row of an `(..., n)` tensor.

    zero: |x|; nonneg: max(-x, 0); soc: ||b|| - t; rsoc: ||b||^2 - 2 t1 t2.
    """
    co = cone_operands(layout.spec, x.device)
    r = x.reshape(-1, layout.n)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    viol = torch.where(co.code == E_NN, torch.clamp(-r, min=0.0),
                       zero).amax(-1)
    viol = torch.maximum(viol, torch.where(co.code == E_ZERO, r.abs(),
                                           zero).amax(-1))
    if layout.has_blocks:
        bl = Blocks.of(co)
        bsq = bl.body_sum(r * r)
        t0, t1 = bl.head(r), bl.head2(r)
        viol = torch.maximum(viol, torch.where(
            bl.soc, torch.sqrt(bsq) - t0, zero).amax(-1))
        viol = torch.maximum(viol, torch.where(
            ~bl.soc, bsq - 2.0 * t0 * t1, zero).amax(-1))
    return viol.reshape(x.shape[:-1])
