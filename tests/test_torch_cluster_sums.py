"""The sums the cluster kernels rewrite, transcribed in torch and held to
the plain versions on the CPU.

A cluster kernel (`csrc/conic_delta.cu`, K3; `csrc/admm_sprint.cu`, K6
and K7; `csrc/conic_ladder.cu` and `csrc/conic_sprint.cu`, K2 and K4)
spreads a lane over C CTAs, each owning a slice of the columns, and
rewrites some sums so that fewer cluster exchanges are needed:

* K3: a cone block's body sum sum(2 t0 d + d^2) of the prox argument
  d = d0 - c rx, c = alpha dtau_t, is P0 - 2 c P1 + c^2 P2 with
  P0 = sum(2 t0 d0 + d0^2), P1 = sum((t0 + d0) rx), P2 = sum(rx^2), each
  summed over the CTAs' slices in rank order;
* K2/K4 (`csrc/conic_cluster.cuh`): every x-side sum and every partial
  m-vector (A t, A zx, A x, A x / tau) summed over the CTAs' slices in
  rank order; a straddling block's body sum of t = d0 - c rx,
  c = alpha tau_t, as P0 - 2 d P1 + d^2 P2 about a shift s known before
  tau_t (alpha times the previous tau_t), e = d0 - s rx, d = c - s,
  P0 = sum e^2, P1 = sum e rx (the "shifted" form; K3's form, s = 0, is
  "unshifted"; "exchange" is a fourth exchange of the exact sum); the
  inner criterion's and the error ratio's x-side sums and maxes in one
  probe exchange;
* K6/K7: <qx, gx> = <u, gx> - rtau <hx, gx> with u = x + vx, and
  <qy, gy> = rho_y (<y, gy> + <vy, gy>) - rtau <hy, gy>, so that the
  rank-1 weight is known when an iteration starts.  (K1's further
  rewrite A wx = (rtau + coef) A hx - A u is not taken: on the absolute
  iterate of a sprint it lands up to 2.7x the plain version's distance
  from an f64 run, `test_k6_one_exchange_form_loses_digits`.)

Each transcription runs the iteration of the plain version with the
rewritten sums.  In f64 it equals the plain f64 run to rounding (the
rewrites are identities); in f32 it is held to the plain f32 version at
the kernels' parity tolerance (`chip_smoke.compare_conic`: rtol 2e-5
plus 1e-5 of each output's scale, times 1/rho_y for the conic y; 1e-4
for the LP sprints' absolute iterates) and to at most 3x the plain
version's distance from an f64 run, the bound the kernels are held to on
the card.  The conic cases are the smoke's dim-1020 batch (two lanes),
whose blocks straddle CTAs at the plan's C=8, and the small primal-form
batch with a diagonal Q.
"""
import functools

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import chip_smoke  # noqa: E402
from abip_tpu_torch.cones import (E_RSOC_H1, E_RSOC_H2, E_SOC_H, Blocks,  # noqa: E402
                                  ConeSpec, cone_operands)
from abip_tpu_torch.ops import admm_sprint as sp  # noqa: E402
from abip_tpu_torch.ops import conic_delta as cd  # noqa: E402
from abip_tpu_torch.ops.admm_delta import _mv, _rmv  # noqa: E402
from abip_tpu_torch.ops import conic_dr as cdr  # noqa: E402
from abip_tpu_torch.ops.conic_dr import _bsum, _elementwise_prox, solve_S  # noqa: E402

DEV = torch.device("cpu")
CLUSTER = 8


def _slice_sums(bl, x, n, cluster):
    """Each block's body sum of x as K3 forms it: the partial sum over
    each CTA's columns, added in rank order."""
    nc = cd.delta_cols_per_cta(n, cluster)
    cols = torch.arange(n)
    total = None
    for r in range(cluster):
        part = bl.body_sum(torch.where((cols // nc) == r, x, torch.zeros_like(x)))
        total = part if total is None else total + part
    return total


def _k3_body(anc, co, woodbury, cluster=CLUSTER):
    """One conic DR iteration on the deltas (`_conic_delta_compute`'s
    `iter_body`) with K3's block sums."""
    sc = anc.scal

    def col(k):
        return sc[:, k:k + 1]

    rho_y, rho_x, rho_tau = col(cd.C_RHOY), col(cd.C_RHOX), col(cd.C_RHOT)
    a_coef, lam, alpha = col(cd.C_ACOEF), col(cd.C_LAM), col(cd.C_ALPHA)
    b0s, c0s, s0s = col(cd.C_B0), col(cd.C_C0), col(cd.C_S0)
    t0t, ett, etau, evtau = (col(cd.C_T0T), col(cd.C_ETT), col(cd.C_ETAU),
                             col(cd.C_EVTAU))
    inv_ry, lam_x, lam_tau = 1.0 / rho_y, lam / rho_x, lam / rho_tau
    A, n = anc.A, anc.A.shape[2]
    bl = Blocks.of(co)
    k = cd._block_anchor(anc.t0x, lam_x, bl)
    P2 = bl.body_sum(anc.rx * anc.rx)   # once per launch, over the block
    code = co.code

    def body(dy, dx, dvy, dvx, dtau, dkap):
        dwy = rho_y * (dy + dvy)
        dwx = rho_x * (dx + dvx)
        deta = rho_tau * (dtau + dkap)
        dzx = solve_S(A, anc.Minv, anc.Hinv, dwx + inv_ry * _rmv(A, dwy),
                      woodbury)
        dzy = inv_ry * (dwy - _mv(A, dzx))
        # the prox argument before the tau correction, and its block sums
        d0 = ((alpha * dzx + (1.0 - alpha) * dx) - dvx) + anc.etx
        P0 = _slice_sums(bl, 2.0 * anc.t0x * d0 + d0 * d0, n, cluster)
        P1 = _slice_sums(bl, (anc.t0x + d0) * anc.rx, n, cluster)
        db = (_bsum(anc.ry * dwy) + _bsum(anc.rx * dwx)
              - 2.0 * (rho_y * _bsum(anc.ry * dzy)
                       + rho_x * _bsum(anc.rx * dzx)) - deta)
        dc = -(2.0 * _bsum(anc.Qz0 * dzx) + _bsum(dzx * anc.Qd * dzx))
        bc, cc = b0s + db, c0s + dc
        s_cur = torch.sqrt(torch.clamp(bc * bc - 4.0 * a_coef * cc, min=0.0))
        ds = ((b0s + bc) * db - 4.0 * a_coef * dc) / (s_cur + s0s + cd._TINY)
        dtau_t = (-db + ds) / (2.0 * a_coef)
        drel_y = alpha * (dzy - dtau_t * anc.ry) + (1.0 - alpha) * dy
        drel_x = alpha * (dzx - dtau_t * anc.rx) + (1.0 - alpha) * dx
        drel_t = alpha * dtau_t + (1.0 - alpha) * dtau
        dtx = drel_x - dvx + anc.etx
        c = alpha * dtau_t
        dbsq = (P0 - 2.0 * c * P1) + c * c * P2
        # `_cone_prox_delta` with that body sum
        out = _elementwise_prox(dtx, code,
                                cd._prox_nn_delta(dtx, anc.t0x, lam_x))
        da, dS2 = bl.head(dtx), bl.head2(dtx)
        de_soc, dsc_soc = cd._soc_delta(k.a0, k.bsq0, da, dbsq, lam_x, k.soc0)
        dr1, dr2, dsc_r = cd._rsoc_delta(k.a0, k.S20, k.bsq0, da, dS2, dbsq,
                                         lam_x, k.rsoc0)
        dh1 = torch.where(bl.soc, de_soc, dr1)
        dsc = torch.where(bl.soc, dsc_soc, dsc_r)
        g = bl.gather
        blk_val = torch.where(
            (code == E_SOC_H) | (code == E_RSOC_H1), g(dh1),
            torch.where(code == E_RSOC_H2, g(dr2),
                        g(k.sc0) * dtx + g(dsc) * (anc.t0x + dtx)))
        px = torch.where(code >= E_SOC_H, blk_val, out)
        dy_n = anc.e_y + (drel_y - dvy)
        dx_n = anc.e_x + px
        dtau_n = etau + cd._prox_nn_delta(drel_t - dkap + ett, t0t, lam_tau)
        return (dy_n, dx_n, dvy + dy_n - drel_y + anc.e_vy,
                dvx + dx_n - drel_x + anc.e_vx, dtau_n,
                dkap + dtau_n - drel_t + evtau)

    return body


def _run_k3(anc, co, T, woodbury):
    body = _k3_body(anc, co, woodbury)
    B, dt = anc.A.shape[0], anc.A.dtype
    zs = torch.zeros((B, 1), dtype=dt)
    state = (torch.zeros_like(anc.e_y), torch.zeros_like(anc.e_x),
             torch.zeros_like(anc.e_y), torch.zeros_like(anc.e_x), zs, zs)
    for _ in range(T):
        state = body(*state)
    return state


def _plain_k3(anc, co, T, woodbury):
    tm = torch.full((anc.A.shape[0],), T, dtype=torch.int32)
    dy, dx, dvy, dvx, row = cd._conic_delta_compute(anc, co, tm, probe=8,
                                                    woodbury=woodbury)
    return dy, dx, dvy, dvx, row[:, 0:1], row[:, 1:2]


@functools.lru_cache(maxsize=None)
def _dim1020():
    """The anchor phase 1 hands to the endgame on two lanes of the
    smoke's dim-1020 batch, and its cone operands."""
    cones, stacks, _ = chip_smoke.conic_batch(8400, count=2)
    P = chip_smoke.conic_prepared(torch, cones, stacks, DEV)
    st = chip_smoke.conic_phase1_state(torch, P, cones)
    return chip_smoke.conic_anchor(torch, P, cones, st, 0.0), \
        cone_operands(cones, DEV)


def test_k3_blocks_straddle_at_dim1020():
    """At the plan's C=8 (nc=128) the second SOC(125) block spans CTAs 0
    and 1 and the RSOC(20) block CTAs 1 and 2: their rewritten sums are
    exchanged."""
    _, co = _dim1020()
    assert cd.conic_delta_launch_plan(340, 1020, 3).cluster == CLUSTER
    spans, _ = cd.cluster_block_spans(co.start, co.length, 1020, CLUSTER)
    assert spans == [(0, 0), (0, 1), (1, 2)]


def test_k3_rewritten_block_sums_are_an_identity_in_f64():
    anc, co = _dim1020()
    anc64 = cd.ConicDeltaAnchor(*[x.double() for x in anc])
    rw = _run_k3(anc64, co, 64, True)
    plain = _plain_k3(anc64, co, 64, True)
    for r, p in zip(rw, plain):
        assert float((r - p).abs().max()) <= 1e-9 * max(1.0, float(p.abs().max()))


def test_k3_rewritten_block_sums_match_the_plain_chunk_in_f32():
    """T=64 at dim-1020: the stated tolerance against the plain f32
    chunk, and at most 3x its distance from the f64 run."""
    anc, co = _dim1020()
    rw = _run_k3(anc, co, 64, True)
    plain = _plain_k3(anc, co, 64, True)
    exact = _plain_k3(cd.ConicDeltaAnchor(*[x.double() for x in anc]), co, 64,
                      True)
    names = ("dy", "dx", "dvy", "dvx", "dtau", "dkap")
    chip_smoke.compare_conic(rw, plain, names, "K3 rewritten sums")
    chip_smoke.accuracy_vs_f64(rw, plain, exact, "K3 rewritten sums")


# -- K6 / K7 --------------------------------------------------------------

def _k6_body(op, dt, one_exchange=False):
    """One LP ADMM iteration (`_sprint_compute`'s `iter_body`) with K6's
    sums: the rank-1 weight from u = x + vx and the launch-constant sums.
    `one_exchange`: A wx as K1 forms it, from A u and A hx."""
    def col(k):
        return op.scal[:, k:k + 1].to(dt)

    A, Ninv = op.A.to(dt), op.Ninv.to(dt)
    hy, hx, gy, gx, mask, vy = (x.to(dt) for x in (op.hy, op.hx, op.gy,
                                                  op.gx, op.maskx, op.vy))
    rho_y, inv_gth1, lam, alpha = (col(sp.S_RHOY), col(sp.S_IGTH),
                                   col(sp.S_LAM), col(sp.S_ALPHA))
    Ahx = _mv(A, hx)
    hg, hyg, vyg = _bsum(hx * gx), _bsum(hy * gy), _bsum(vy * gy)

    def body(y, x, vx, tau, kappa):
        rtau = tau + kappa
        u = x + vx
        pw = (rho_y * (_bsum(y * gy) + vyg) - rtau * hyg) + (_bsum(u * gx)
                                                              - rtau * hg)
        coef = pw * inv_gth1
        wx = -((u - rtau * hx) - coef * hx)
        Awx = (rtau + coef) * Ahx - _mv(A, u) if one_exchange else _mv(A, wx)
        rhs = ((rho_y * (y + vy) - rtau * hy) - coef * hy) + Awx
        z_y = _mv(Ninv, rhs)
        z_x = _rmv(A, z_y) - wx
        tau_t = (rtau + _bsum(z_y * hy)) + _bsum(z_x * hx)
        rel_x = alpha * z_x + (1.0 - alpha) * x
        rel_tau = alpha * tau_t + (1.0 - alpha) * tau
        x_new = sp.prox(rel_x - vx, lam) * mask
        tau_new = sp.prox(rel_tau - kappa, lam)
        return (z_y - vy, x_new, (vx + x_new) - rel_x, tau_new,
                (kappa + tau_new) - rel_tau)

    return body


def _run_k6(op, T, dt, one_exchange=False):
    body = _k6_body(op, dt, one_exchange)
    state = (op.y.to(dt), op.x.to(dt), op.vx.to(dt),
             op.scal[:, sp.S_TAU0:sp.S_TAU0 + 1].to(dt),
             op.scal[:, sp.S_KAPPA0:sp.S_KAPPA0 + 1].to(dt))
    for _ in range(T):
        state = body(*state)
    return state


def _plain_k6(op, T):
    tm = torch.full((op.A.shape[0],), T, dtype=torch.int32)
    y, x, vx, row = sp._sprint_compute(op, tm, 0)
    return y, x, vx, row[:, 0:1], row[:, 1:2]


@functools.lru_cache(maxsize=None)
def _smoke_sprint_state():
    _, stacks = chip_smoke.smoke_batch(500, 16)
    return chip_smoke.mid_solve_state(torch, stacks, DEV, steps=60,
                                      sprint=True)


@pytest.mark.parametrize("where", ["mid-solve", "cold"])
def test_k6_rewritten_sums_match_the_plain_sprint(where):
    """T=32 at the smoke shape (m=50, n=2000): an identity in f64; in f32
    within the LP sprints' tolerance of the plain version and at most 3x
    its distance from the f64 run."""
    S, u, v = _smoke_sprint_state()
    if where == "cold":
        u, v = chip_smoke.lp_cold_state(torch, S)
        lam = chip_smoke.LP_COLD_LAM
    else:
        lam = chip_smoke.SPRINT_LAM
    op = chip_smoke.lp_sprint_operands(torch, S, u, v, 0.0, lam=lam)
    op64 = sp.SprintOperands(*[x.double() for x in op])
    exact = _plain_k6(op64, 32)
    for r, p in zip(_run_k6(op, 32, torch.float64), exact):
        assert float((r - p).abs().max()) <= 1e-9 * max(1.0, float(p.abs().max()))
    rw, plain = _run_k6(op, 32, torch.float32), _plain_k6(op, 32)
    chip_smoke.compare_conic(rw, plain, ("y", "x", "vx", "tau", "kappa"),
                             "K6 rewritten sums", amplified=(),
                             rel_scale=chip_smoke.LP_SPRINT_REL_SCALE)
    chip_smoke.accuracy_vs_f64(rw, plain, exact, "K6 rewritten sums")


def test_k6_one_exchange_form_loses_digits():
    """Why K6 makes two exchanges an iteration: K1's form of A wx, from
    the exchanged A u and A hx, is an identity (f64) but in f32 from the
    cold start of the B=16 smoke lands more than 2x the plain version's
    distance from an f64 run after 32 iterations; the direct A wx stays
    within 1.5x."""
    S, _, _ = _smoke_sprint_state()
    u, v = chip_smoke.lp_cold_state(torch, S)
    op = chip_smoke.lp_sprint_operands(torch, S, u, v, 0.0,
                                       lam=chip_smoke.LP_COLD_LAM)
    exact = _plain_k6(sp.SprintOperands(*[x.double() for x in op]), 32)

    def dist(out):
        return max(float((o.double() - e).abs().max())
                   for o, e in zip(out, exact))

    plain = dist(_plain_k6(op, 32))
    assert dist(_run_k6(op, 32, torch.float32, one_exchange=True)) > 2 * plain
    assert dist(_run_k6(op, 32, torch.float32)) < 1.5 * plain


# -- K2 / K4 ---------------------------------------------------------------

DR_FORMS = ("shifted", "unshifted", "exchange")


def _cols(n, cluster):
    """The CTAs' column slices, in rank order."""
    nc = cd.delta_cols_per_cta(n, cluster)
    return [slice(r * nc, min(n, (r + 1) * nc)) for r in range(cluster)
            if r * nc < n]


def _xsum(v, cols):
    """An x-side sum as a cluster forms it: each CTA's partial, added in
    rank order."""
    total = _bsum(v[:, cols[0]])
    for s in cols[1:]:
        total = total + _bsum(v[:, s])
    return total


def _a_cols(A, x, cols):
    """A x as an exchange forms it: each CTA's partial product over its
    columns, added in rank order."""
    total = _mv(A[:, :, cols[0]], x[:, cols[0]])
    for s in cols[1:]:
        total = total + _mv(A[:, :, s], x[:, s])
    return total


def _amax(v):
    return torch.abs(v).amax(-1, keepdim=True)


def _cone_prox_bsq(tx, lam_x, co, bl, bsq):
    """`conic_dr._cone_prox` with the blocks' body sums given."""
    out = _elementwise_prox(tx, co.code, cdr._prox_nn(tx, lam_x))
    if co.start.numel() == 0:
        return out
    a, s2 = bl.head(tx), bl.head2(tx)
    soc_h, soc_s = cdr._soc_rows(a, bsq, lam_x)
    rs1, rs2, rs_s = cdr._rsoc_rows(a, s2, bsq, lam_x)
    return torch.where(co.code >= E_SOC_H, bl.scatter(
        torch.where(bl.soc, soc_h, rs1), rs2, torch.where(bl.soc, soc_s, rs_s),
        tx, co.code), out)


def _cluster_dr(op, co, scal, woodbury, cluster, form, record=None):
    """`(iter_body, probe)`: K2/K4's iteration (`_make_dr_fns`'s) and probe
    (the inner criterion and, where asked, the error ratio) with the
    cluster's sums.  `scal` = (rho_y, rho_x, rho_tau, a_coef, alpha, k0,
    and for the ratio sc_b, sc_c, nm_b, nm_c, eps) as `(B, 1)` columns.
    `record`, a list, gets per iteration each form's relative error of
    the straddling blocks' body sums against an f64 sum of the same f32
    inputs."""
    rho_y, rho_x, rho_tau, a_coef, alpha, k0 = scal[:6]
    A, ry, rx, b, c, Qd = op.A, op.ry, op.rx, op.b, op.c, op.Qd
    n = A.shape[2]
    cols = _cols(n, cluster)
    bl = Blocks.of(co)
    spans, _ = cd.cluster_block_spans(co.start, co.length, n, cluster)
    strad = torch.tensor([lo != hi for lo, hi in spans], dtype=torch.bool)
    P2 = bl.body_sum(rx * rx)
    inv_ry, oma = 1.0 / rho_y, 1.0 - alpha
    prev = [None]   # alpha times the previous tau_t

    def shifted_sum(zx, x, vx, cc, s):
        e = ((alpha * zx + oma * x) - vx) - s * rx
        d = cc - s
        return ((_slice_sums(bl, e * e, n, cluster)
                 - 2.0 * d * _slice_sums(bl, e * rx, n, cluster))
                + d * d * P2)

    def iter_body(lam, i, state):
        y, x, vy, vx, tau, kappa = state
        lam_x, lam_tau = lam / rho_x, lam / rho_tau
        wy = rho_y * (y + vy)
        wx = rho_x * (x + vx)
        eta = rho_tau * (tau + kappa)
        rhs = wx + inv_ry * _rmv(A, wy)
        if woodbury:   # exchanges 1 and 2
            t = op.Hinv * rhs
            zx = t - op.Hinv * _rmv(A, _mv(op.Minv, _a_cols(A, t, cols)))
        else:
            zx = _rmv(op.Minv, rhs)
        zy = inv_ry * (wy - _a_cols(A, zx, cols))   # exchange 3
        b_coef = ((_bsum(ry * wy) + _xsum(rx * wx, cols))
                  - 2.0 * (rho_y * _bsum(ry * zy) + rho_x * _xsum(rx * zx, cols))
                  ) - eta
        c_coef = -_xsum(zx * Qd * zx, cols)
        disc = torch.clamp(b_coef * b_coef - 4.0 * a_coef * c_coef, min=0.0)
        tau_t = (-b_coef + torch.sqrt(disc)) / (2.0 * a_coef)
        tau_t = torch.where(k0 + i.to(tau_t.dtype) > 0, tau_t,
                            torch.ones_like(tau_t))
        rel_y = alpha * (zy - tau_t * ry) + oma * y
        rel_x = alpha * (zx - tau_t * rx) + oma * x
        rel_tau = alpha * tau_t + oma * tau
        tx = rel_x - vx
        cc = alpha * tau_t
        s = alpha * tau if prev[0] is None else prev[0]
        if form == "exchange":
            sbs = _slice_sums(bl, tx * tx, n, cluster)
        else:
            sbs = shifted_sum(zx, x, vx, cc,
                              torch.zeros_like(cc) if form == "unshifted" else s)
        if record is not None and bool(strad.any()):
            d = [v.double() for v in (alpha, zx, tau_t, rx, x, vx)]
            tx64 = (d[0] * (d[1] - d[2] * d[3]) + (1.0 - d[0]) * d[4]) - d[5]
            ex = bl.body_sum(tx64 * tx64)[:, strad]

            def rel(v):
                return float(((v[:, strad].double() - ex).abs() / ex).max())

            record.append(dict(
                direct=rel(bl.body_sum(tx * tx)),
                shifted=rel(shifted_sum(zx, x, vx, cc, s)),
                unshifted=rel(shifted_sum(zx, x, vx, cc, torch.zeros_like(cc)))))
        prev[0] = cc
        sb = torch.where(strad, sbs, bl.body_sum(tx * tx))
        x_new = _cone_prox_bsq(tx, lam_x, co, bl, sb)
        y_new = rel_y - vy
        tau_new = cdr._prox_nn(rel_tau - kappa, lam_tau)
        return (y_new, x_new, vy + y_new - rel_y, vx + x_new - rel_x,
                tau_new, kappa + tau_new - rel_tau)

    def probe(y, x, vy, vx, tau, kappa, ratio):
        Mu_y = _a_cols(A, x, cols)   # the probe's exchange
        Mu_x = Qd * x - _rmv(A, y)
        Qu_y, Qu_x = Mu_y - b * tau, Mu_x + c * tau
        tau_safe = torch.where(torch.abs(tau) < cdr._EPS_TAU,
                               torch.full_like(tau, cdr._EPS_TAU), tau)
        von_y, von_x, von_tau = rho_y * vy, rho_x * vx, rho_tau * kappa
        Qu_tau = ((-(_bsum(y * Mu_y) + _xsum(x * Mu_x, cols)) / tau_safe
                   + _bsum(y * b)) - _xsum(x * c, cols))
        d2 = ((_bsum((Qu_y - von_y) ** 2) + _xsum((Qu_x - von_x) ** 2, cols))
              + (Qu_tau - von_tau) ** 2)
        qn = torch.sqrt((_bsum(Qu_y * Qu_y) + _xsum(Qu_x * Qu_x, cols))
                        + Qu_tau * Qu_tau)
        vn = torch.sqrt((_bsum(von_y * von_y) + _xsum(von_x * von_x, cols))
                        + von_tau * von_tau)
        err = torch.sqrt(d2) / ((1.0 + qn) + vn)
        if not ratio:
            return err, None
        sc_b, sc_c, nm_b, nm_c, eps = scal[6:]
        D, E = op.D, op.E
        tau_s = torch.clamp(torch.abs(tau), min=1e-18)
        xs, ys = x / tau_s, y / tau_s
        Ax = _a_cols(A, xs, cols)   # the same exchange
        res_pri = _amax(D * (Ax - b)) / (
            sc_b + torch.maximum(_amax(D * Ax), sc_b * nm_b))
        Qx = Qd * xs
        dres = ((Qx - _rmv(A, ys)) + c) - rho_x * vx / tau_s
        res_dual = _amax(E * dres) / (
            sc_c + torch.maximum(sc_c * nm_c, _amax(E * Qx)))
        inv_bc = 1.0 / (sc_b * sc_c)
        xQx_2 = 0.5 * _xsum(xs * Qx, cols) * inv_bc
        cTx = _xsum(c * xs, cols) * inv_bc
        bTy = _bsum(b * ys) * inv_bc
        rel_gap = torch.abs((2.0 * xQx_2 + cTx) - bTy) / (
            1.0 + torch.maximum(2.0 * xQx_2, torch.maximum(torch.abs(cTx),
                                                           torch.abs(bTy))))
        return err, torch.maximum(res_pri, torch.maximum(res_dual, rel_gap)) / eps

    return iter_body, probe


def _run_cluster(op, co, t_max, *, ladder, woodbury, form, cluster=CLUSTER,
                 probe=8, psi=1.0, record=None):
    """K2 (`ladder`) or K4 as a cluster forms its sums: the trip loop of
    `_dr_ladder_compute` / `_dr_sprint_compute` around `_cluster_dr`.
    Returns (y, x, vy, vx, row) as the plain versions do."""
    def col(k):
        return op.scal[:, k:k + 1]

    if ladder:
        names = ("RHOY", "RHOX", "RHOT", "ACOEF", "ALPHA", "K0", "SCB", "SCC",
                 "NMB", "NMC", "EPS")
        scal = [col(getattr(cdr, "L_" + k)) for k in names]
        tau0, kap0 = col(cdr.L_TAU), col(cdr.L_KAPPA)
        mu, tol, mu_stop = col(cdr.L_MU), col(cdr.L_TOL), col(cdr.L_MUSTOP)
    else:
        scal = [col(getattr(cdr, "C_" + k)) for k in ("RHOY", "RHOX", "RHOT",
                                                      "ACOEF", "ALPHA", "K0")]
        tau0, kap0 = col(cdr.C_TAU), col(cdr.C_KAPPA)
        mu, thresh = col(cdr.C_LAM), col(cdr.C_THRESH)
    iter_body, probe_fn = _cluster_dr(op, co, scal, woodbury, cluster, form,
                                      record)
    B = op.A.shape[0]
    t_max = t_max.to(torch.int32).reshape(B, 1)
    state = (op.y, op.x, op.vy, op.vx, tau0, kap0)
    t = torch.zeros((B, 1), dtype=torch.int32)
    stages = torch.zeros_like(t)
    e = torch.full_like(mu, float("inf"))
    while True:
        run = (t < t_max) & ((mu >= mu_stop) if ladder else (e >= thresh))
        if not bool(run.any()):
            break
        new = state
        for j in range(probe):
            new = iter_body(mu, t + j, new)
        e_new, ratio = probe_fn(*new, ladder)
        state = tuple(torch.where(run, a, s) for a, s in zip(new, state))
        if ladder:
            mu2, tol2 = cdr._adjust_barrier_f32(mu, ratio, scal[-1], psi)
            adv = run & (e_new < tol)
            mu = torch.where(adv, mu2, mu)
            tol = torch.where(adv, tol2, tol)
            stages = stages + adv.to(torch.int32)
        e = torch.where(run, e_new, e)
        t = torch.where(run, t + probe, t)
    y, x, vy, vx, tau, kappa = state
    row = [tau, kappa, e, t.to(e.dtype)]
    if ladder:
        row += [mu, tol, stages.to(e.dtype)]
    return y, x, vy, vx, torch.cat(row, dim=1)


@functools.lru_cache(maxsize=None)
def _dr_case(label):
    """(ladder operands from the cold start, sprint operands at k0 = 64
    from the plain sprint's state after 64 iterations, cone operands,
    woodbury) of the dim-1020 batch (two lanes) or the small primal
    batch."""
    case = dict(seed0=8400, count=2) if label == "dim-1020" else \
        chip_smoke.CONIC_CASES[1][1]
    cones, stacks, _ = chip_smoke.conic_batch(**case)
    P = chip_smoke.conic_prepared(torch, cones, stacks, DEV)
    co = cone_operands(cones, DEV)
    wb = P.dss.form == "woodbury"
    lad = chip_smoke.cold_ladder_operands(torch, P, cones)
    u = chip_smoke.conic_cold_state(torch, P, cones)
    op = chip_smoke.conic_sprint_operands(torch, P, u, u, 1.0, 0.0, 0.0)
    tm = torch.full((P.A.shape[0],), 64, dtype=torch.int32)
    y, x, vy, vx, row = cdr._dr_sprint_compute(op, co, tm, probe=8,
                                               woodbury=wb)
    u = torch.cat([y, x, row[:, :1]], 1)
    v = torch.cat([vy, vx, row[:, 1:2]], 1)
    spr = chip_smoke.conic_sprint_operands(torch, P, u, v, 0.2, 0.0, 64.0)
    return lad, spr, co, wb


def _dr_runs(label, kernel, form):
    """(transcription f32, plain f32, plain f64, transcription f64) of K2
    (phase 1 from the cold start) or K4 (T=64 at k0 = 64)."""
    lad, spr, co, wb = _dr_case(label)
    ladder = kernel == "K2"
    op = lad if ladder else spr
    op64 = type(op)(*[x.double() for x in op])
    tm = torch.full((op.A.shape[0],), 2048 if ladder else 64,
                    dtype=torch.int32)
    plain = (cdr._dr_ladder_compute if ladder else cdr._dr_sprint_compute)
    kw = dict(probe=8, woodbury=wb, **(dict(psi=1.0) if ladder else {}))
    run = dict(ladder=ladder, woodbury=wb, form=form)
    return (_run_cluster(op, co, tm, **run), plain(op, co, tm, **kw),
            plain(op64, co, tm, **kw), _run_cluster(op64, co, tm, **run))


def test_k2k4_plan_and_straddling_blocks_at_dim1020():
    """K2's and K4's plan at dim-1020 is C=8 with A resident (nc=128): the
    second SOC(125) block spans CTAs 0 and 1 and the RSOC(20) block CTAs
    1 and 2, so their body sums travel in exchange 3."""
    _, _, co, _ = _dr_case("dim-1020")
    plan = cdr.dr_launch_plan(340, 1020, 3)
    assert (plan.cluster, plan.resident) == (CLUSTER, True)
    spans, _ = cd.cluster_block_spans(co.start, co.length, 1020, CLUSTER)
    assert spans == [(0, 0), (0, 1), (1, 2)]


@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("label", ["dim-1020", "small primal"])
def test_k2k4_rewritten_sums_are_an_identity_in_f64(label, kernel):
    *_, exact, rw64 = _dr_runs(label, kernel, "shifted")
    for r, p in zip(rw64, exact):
        assert float((r - p).abs().max()) <= 1e-9 * max(1.0, float(p.abs().max()))


@pytest.mark.parametrize("form", DR_FORMS)
@pytest.mark.parametrize("kernel", ["K2", "K4"])
@pytest.mark.parametrize("label", ["dim-1020", "small primal"])
def test_k2k4_rewritten_sums_match_the_plain_version_in_f32(label, kernel,
                                                           form):
    """Each straddling-block form with the cluster's other sums: the
    plain version's decisions (t_done; K2's stages and mu); x, vy, vx and
    the row within the stated tolerance of the plain version; every
    output, and y alone, at most 3x the plain version's distance from the
    f64 run.  (y, the free block, amplifies f32 rounding by 1/rho_y: on
    these two dim-1020 lanes the plain f32 version's y is 8.2e-2 (K2) and
    2.2e-1 (K4) from the f64 run's, the size of the stated tolerance
    itself, and the transcription as far on the other side, so y is held
    to the f64 run.)"""
    rw, plain, exact, _ = _dr_runs(label, kernel, form)
    for c in ((3, 4, 6) if kernel == "K2" else (3,)):
        assert torch.equal(rw[4][:, c], plain[4][:, c])
    name = f"{kernel} {label} {form}"
    chip_smoke.compare_conic(rw[1:], plain[1:], ("x", "vy", "vx", "row"), name)
    chip_smoke.accuracy_vs_f64(rw, plain, exact, name)
    chip_smoke.accuracy_vs_f64(rw[:1], plain[:1], exact[:1], name + " y")


def test_k2k4_unshifted_rewrite_loses_digits_in_the_body_sums():
    """Why the kernels shift the rewrite: on the ladder's absolute
    iterates at dim-1020, K3's unshifted form of a straddling block's
    body sum lands more than 2x further from the f64 sum of the same f32
    inputs than the shifted one, which is within 1.5x of the direct sum
    of squares."""
    lad, _, co, wb = _dr_case("dim-1020")
    rec = []
    tm = torch.full((lad.A.shape[0],), 2048, dtype=torch.int32)
    _run_cluster(lad, co, tm, ladder=True, woodbury=wb, form="shifted",
                 record=rec)
    worst = {k: max(r[k] for r in rec) for k in rec[0]}
    assert worst["unshifted"] > 2.0 * worst["shifted"], worst
    assert worst["shifted"] < 1.5 * worst["direct"], worst


def _fuzz_case(cls):
    """The fuzz_conic batch of `cls` (18 lanes, free and zero blocks,
    dim 21, m 7, the Woodbury form), prepared as the tool's batched call
    prepares it."""
    cones, stacks, _ = chip_smoke.conic_batch(fuzz=cls, count=18)
    P = chip_smoke.conic_prepared(torch, cones, stacks, DEV)
    return cones, P, cone_operands(cones, DEV), P.dss.form == "woodbury"


@pytest.mark.parametrize("cls", ["zero_mixed", "mixed"])
def test_k2_sums_at_fuzz_shapes_sit_within_the_f32_noise_floor(cls):
    """On fuzz_conic's small batches the plain f32 ladder itself sits
    further from an f64 run than the stated absolute term (1e-5 of the
    scale), so K2 is held there with the noise floor
    (`chip_smoke.ladder_parity(noise_floor=True)`): K2's sums, in the
    launch plan's cluster, take the plain version's decisions, land
    within the stated tolerance with each absolute term at least 3x the
    plain version's distance from f64 (the row's per continuous slot,
    none on its decisions), and at most 3x that distance from the f64
    run, y alone too."""
    cones, P, co, wb = _fuzz_case(cls)
    op = chip_smoke.cold_ladder_operands(torch, P, cones)
    plan = cdr.dr_launch_plan(P.A.shape[1], P.A.shape[2], co.start.shape[0])
    assert plan.cluster == CLUSTER and P.A.shape[2] == 21 and wb
    tm = torch.full((op.A.shape[0],), 2048, dtype=torch.int32)
    kw = dict(probe=8, woodbury=wb, psi=1.0)
    plain = cdr._dr_ladder_compute(op, co, tm, **kw)
    exact = cdr._dr_ladder_compute(type(op)(*[x.double() for x in op]), co,
                                   tm, **kw)
    rw = _run_cluster(op, co, tm, ladder=True, woodbury=wb, form="shifted")
    x_noise = float((plain[1].double() - exact[1]).abs().max())
    assert x_noise > chip_smoke.REL_SCALE * float(plain[1].abs().max())
    for c in (3, 4, 6):
        assert torch.equal(rw[4][:, c], plain[4][:, c])
    names = ("y", "x", "vy", "vx", "row")
    floor = chip_smoke.ladder_noise_floor(names, plain, exact)
    assert (floor["row"][[3, 4, 6]] == 0).all()
    chip_smoke.compare_conic(rw, plain, names, cls, floor=floor)
    chip_smoke.accuracy_vs_f64(rw, plain, exact, cls)
    chip_smoke.accuracy_vs_f64(rw[:1], plain[:1], exact[:1], cls + " y")


@pytest.mark.parametrize("cls", ["zero_mixed", "mixed"])
def test_k2_first_fuzz_iteration_in_trips_of_one(cls):
    """K2 as fuzz_conic launches it (inner_crit_period=1, so trips of 1),
    over its first iteration, whose end takes the first stage decision
    (`chip_smoke.ladder_parity(T=1, probe=1)`): K2's sums take the plain
    version's decisions and land within the stated tolerance, with no
    noise floor, and at most 3x its distance from the f64 run."""
    cones, P, co, wb = _fuzz_case(cls)
    op = chip_smoke.cold_ladder_operands(torch, P, cones)
    tm = torch.ones((op.A.shape[0],), dtype=torch.int32)
    kw = dict(probe=1, woodbury=wb, psi=1.0)
    plain = cdr._dr_ladder_compute(op, co, tm, **kw)
    exact = cdr._dr_ladder_compute(type(op)(*[x.double() for x in op]), co,
                                   tm, **kw)
    rw = _run_cluster(op, co, tm, ladder=True, woodbury=wb, form="shifted",
                      probe=1)
    assert (plain[4][:, 6] == 1).all()
    for c in (3, 4, 6):
        assert torch.equal(rw[4][:, c], plain[4][:, c])
    chip_smoke.compare_conic(rw, plain, ("y", "x", "vy", "vx", "row"), cls)
    chip_smoke.accuracy_vs_f64(rw, plain, exact, cls)


@pytest.mark.parametrize("cls", ["zero_mixed", "mixed"])
def test_k3_first_launch_at_fuzz_shapes(cls):
    """K3's first launch in fuzz_conic's run: one iteration
    (inner_crit_period=1) from the state its phase 1 hands over, with
    K3's block sums, within the stated tolerance of the plain chunk and
    at most 3x its distance from the f64 run."""
    cones, P, co, wb = _fuzz_case(cls)
    st = chip_smoke.conic_phase1_state(torch, P, cones, inner_crit_period=1)
    anc = chip_smoke.conic_anchor(torch, P, cones, st, 0.0)
    tm = torch.full((anc.A.shape[0],), 1, dtype=torch.int32)
    names = ("dy", "dx", "dvy", "dvx", "dtau", "dkap")

    def plain_chunk(a):
        dy, dx, dvy, dvx, row = cd._conic_delta_compute(a, co, tm, probe=1,
                                                        woodbury=wb)
        return dy, dx, dvy, dvx, row[:, 0:1], row[:, 1:2]

    rw = _run_k3(anc, co, 1, wb)
    plain = plain_chunk(anc)
    exact = plain_chunk(cd.ConicDeltaAnchor(*[x.double() for x in anc]))
    chip_smoke.compare_conic(rw, plain, names, f"K3 {cls}")
    chip_smoke.accuracy_vs_f64(rw, plain, exact, f"K3 {cls}")
