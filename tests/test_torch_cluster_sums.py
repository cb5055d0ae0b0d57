"""The sums the cluster kernels rewrite, transcribed in torch and held to
the plain versions on the CPU.

A cluster kernel (`csrc/conic_delta.cu`, K3; `csrc/admm_sprint.cu`, K6
and K7) spreads a lane over C CTAs, each owning a slice of the columns,
and rewrites some sums so that fewer cluster exchanges are needed:

* K3: a cone block's body sum sum(2 t0 d + d^2) of the prox argument
  d = d0 - c rx, c = alpha dtau_t, is P0 - 2 c P1 + c^2 P2 with
  P0 = sum(2 t0 d0 + d0^2), P1 = sum((t0 + d0) rx), P2 = sum(rx^2), each
  summed over the CTAs' slices in rank order;
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
the card.  The conic case is the smoke's dim-1020 batch (two lanes),
whose blocks straddle CTAs at the plan's C=8.
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
