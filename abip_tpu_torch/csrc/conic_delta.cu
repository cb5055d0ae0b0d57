// Anchored-delta conic DR chunk for Hopper (sm_90a), one thread block per lane.
//
// Replaces the TPU kernel `_conic_delta_kernel_batched` of
// `abip_tpu/ops/conic_delta.py` (Pallas, grid over lanes).  It computes what
// `abip_tpu_torch/ops/conic_delta.py:_conic_delta_compute` computes: up to
// t_max[b] f32 conic DR iterations of lane b in the DELTA frame of an f64
// anchor (`docs/conic_delta_design.md`), probing the delta-frame inner
// criterion every `probe` iterations and stopping the lane once it drops
// below the lane's threshold.
//
// Per iteration: the linear pipeline on deltas (the products of
// csrc/conic_ladder.cu: four A passes and one G^-1 pass in the Woodbury
// form), the tau-quadratic delta, the telescoped cone prox deltas, the dual
// update.  The cone blocks are walked with one warp per block: the body sum
// of (2 t0 dt + dt^2) by warp reduction, then one thread runs the block's SOC
// or RSOC delta chain.  The anchor's block values (head values, body sum of
// squares, body scale) are computed once per launch.  Where anchor and
// current point sit on different branches the chains fall back to the direct
// difference of the recomputed chain values; the RSOC chain marks a mismatch
// with NaN and then replaces every NaN delta, sentinel or genuine, by the
// direct difference (so `isnan` must survive the build).
//
// Layout and what bounds it on this card are as in csrc/conic_ladder.cu: the
// vectors in shared memory, A and the inverse through L2, one SM per lane.

#include "conic_common.cuh"

using namespace conic;

namespace {

// scal slots, `ops/conic_delta.py` C_*
enum {
  C_RHOY, C_RHOX, C_RHOT, C_ACOEF, C_LAM, C_ALPHA, C_THRESH, C_QINIT, C_B0, C_C0, C_S0,
  C_TAU0, C_KAP0, C_T0T, C_ETT, C_ETAU, C_EVTAU, C_N0T, C_E0T, C_QU0T, C_QN0, C_VN0,
  C_TAUT0, C_COUNT
};
// operand order of the C entry (ConicDeltaAnchor, then t_max, then the cones)
enum {
  I_SCAL, I_A, I_MINV, I_HINV, I_RY, I_RX, I_B, I_C, I_QD, I_T0X, I_ETX, I_EY, I_EX, I_EVX,
  I_EVY, I_QZ0, I_QX0, I_E0Y, I_E0X, I_QU0Y, I_QU0X, I_VON0Y, I_VON0X, I_TMAX, I_CODE,
  I_BLK, I_START, I_LEN, I_SOC, I_COUNT
};
enum { O_DY, O_DX, O_DVY, O_DVX, O_ROW, O_COUNT };
constexpr int kRowWidth = 4;  // [dtau, dkappa, err, t_done]
constexpr int kRed = 9;       // widest block reduction

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  Cones cones;
  float* out[O_COUNT];
  int m, n, probe, woodbury;
};

// ---------------------------------------------------------------------------
// the absolute chains and their deltas (`ops/conic_delta.py`), scalar
// ---------------------------------------------------------------------------

struct SocChain {
  float x0z, den, R, D, r, disc, s, s_safe, eta, sc;
  bool small;
};

__device__ SocChain soc_chain(float a, float bsq, float lam) {
  SocChain c;
  c.x0z = sqrtf(2.0f * lam + bsq / 4.0f);
  c.den = 8.0f * lam - a * a + bsq;
  c.R = sqrtf(c.den * c.den + 32.0f * a * a * lam);
  c.D = c.den + c.R + kTiny;
  c.r = 16.0f * a * a / c.D;
  c.disc = sqrtf(max0(c.r * (c.r + 8.0f)));
  c.s = (a > 0.f) ? (c.r + c.disc) / 2.0f : (c.r - c.disc) / 2.0f;
  c.s_safe = (fabsf(c.s) < kTiny) ? kTiny : c.s;
  c.small = fabsf(a) <= kSocTol;
  c.eta = c.small ? c.x0z : (c.s + 2.0f) * a / c.s_safe;
  c.sc = c.small ? 0.5f : (c.s + 2.0f) / (c.s + 4.0f);
  return c;
}

// (d_eta, d_sc) of the SOC chain; the direct difference on a branch mismatch
__device__ __noinline__ void soc_delta(float a0, float bsq0, float da, float dbsq, float lam,
                                       float* d_eta, float* d_sc) {
  const SocChain c0 = soc_chain(a0, bsq0, lam);
  const float a = a0 + da, bsq = bsq0 + dbsq;
  const SocChain c = soc_chain(a, bsq, lam);
  const float dx0z = (dbsq / 4.0f) / (c.x0z + c0.x0z + kTiny);
  const float dden = -(a0 + a) * da + dbsq;
  const float dR = ((c0.den + c.den) * dden + 32.0f * lam * (a0 + a) * da) / (c.R + c0.R + kTiny);
  const float dD = dden + dR;
  const float dr = (16.0f * (a0 + a) * da - c0.r * dD) / c.D;
  const float ddisc = (c0.r + c.r + 8.0f) * dr / (c.disc + c0.disc + kTiny);
  const float sgn = (a > 0.f) ? 1.0f : -1.0f;
  const float ds = (dr + sgn * ddisc) / 2.0f;
  // eta = a + 2a/s  ->  d = da + 2 (da s0 - a0 ds) / (s s0)
  float de = da + 2.0f * (da * c0.s_safe - a0 * ds) / (c.s_safe * c0.s_safe);
  float dsc = 2.0f * ds / ((c.s + 4.0f) * (c0.s + 4.0f));
  if (c0.small && c.small) {  // small-|a| branch: eta = x0_zero, sc = 1/2
    de = dx0z;
    dsc = 0.f;
  }
  if ((c0.small != c.small) || ((a0 > 0.f) != (a > 0.f))) {
    de = c.eta - c0.eta;
    dsc = c.sc - c0.sc;
  }
  *d_eta = de;
  *d_sc = dsc;
}

struct RsocChain {
  float x1, x2, sc;
  bool pb, bb, dg;  // sum > 0 (branch a), branch b, degenerate
};

__device__ RsocChain rsoc_chain(float ze, float zn, float zxsq, float lam) {
  RsocChain c;
  const float sum_zz = ze + zn;
  const float w = rsoc_w(ze, zn, zxsq, lam);
  const float root = sqrtf(max0(w * (w + 4.0f)));
  c.pb = sum_zz > 0.f;
  c.bb = !c.pb && (w > 10.0f);
  c.dg = sum_zz == 0.f;
  if (c.pb)
    rsoc_heads_std(ze, zn, (w + root) / 2.0f, &c.x1, &c.x2, &c.sc);
  else if (c.bb)
    rsoc_heads_b(ze, zn, 2.0f / (w + 2.0f + root + kTiny), &c.x1, &c.x2, &c.sc);
  else
    rsoc_heads_std(ze, zn, (w - root) / 2.0f, &c.x1, &c.x2, &c.sc);
  if (c.dg) {
    const float x2d = (-ze + sqrtf(ze * ze + 4.0f * lam + zxsq)) / 2.0f;
    c.x1 = x2d + ze;
    c.x2 = x2d;
    c.sc = 0.5f;
  }
  return c;
}

// deltas of the heads and scale through a root delta, standard form
__device__ void d_heads_std(float ze0, float zn0, float dze, float dzn, float s0, float sc,
                            float ds, float* dx1, float* dx2, float* dscale) {
  const float den0 = tiny_guard(s0 * (s0 + 2.0f));
  const float denc = tiny_guard(sc * (sc + 2.0f));
  const float dden = (s0 + sc + 2.0f) * ds;
  const float s01 = s0 + 1.0f, sc1 = sc + 1.0f;
  const float x10 = (ze0 * (s01 * s01) + zn0 * s01) / den0;
  const float x20 = (zn0 * (s01 * s01) + ze0 * s01) / den0;
  const float dsq = (s0 + sc + 2.0f) * ds;  // d (s+1)^2
  const float dn1 = dze * (sc1 * sc1) + ze0 * dsq + dzn * sc1 + zn0 * ds;
  const float dn2 = dzn * (sc1 * sc1) + zn0 * dsq + dze * sc1 + ze0 * ds;
  *dx1 = (dn1 - x10 * dden) / denc;
  *dx2 = (dn2 - x20 * dden) / denc;
  *dscale = ds / ((sc + 2.0f) * (s0 + 2.0f));
}

// the same for the conjugate form (branch b)
__device__ void d_heads_b(float ze0, float zn0, float dze, float dzn, float s0, float sc,
                          float ds, float* dx1, float* dx2, float* dscale) {
  const float den0 = tiny_guard((s0 - 1.0f) * (s0 + 1.0f));
  const float denc = tiny_guard((sc - 1.0f) * (sc + 1.0f));
  const float dden = (s0 + sc) * ds;
  const float x10 = (ze0 * s0 * s0 + zn0 * s0) / den0;
  const float x20 = (zn0 * s0 * s0 + ze0 * s0) / den0;
  const float dsq = (s0 + sc) * ds;
  const float dn1 = dze * sc * sc + ze0 * dsq + dzn * sc + zn0 * ds;
  const float dn2 = dzn * sc * sc + zn0 * dsq + dze * sc + ze0 * ds;
  *dx1 = (dn1 - x10 * dden) / denc;
  *dx2 = (dn2 - x20 * dden) / denc;
  *dscale = ds / ((sc + 1.0f) * (s0 + 1.0f));
}

// (d_x1, d_x2, d_sc) of the RSOC chain (`cones.c:169-248`)
__device__ __noinline__ void rsoc_delta(float ze0, float zn0, float zx0, float dze, float dzn,
                                        float dzx, float lam, float* o_dx1, float* o_dx2,
                                        float* o_dsc) {
  const RsocChain ch0 = rsoc_chain(ze0, zn0, zx0, lam);
  const float ze = ze0 + dze, zn = zn0 + dzn, zx = zx0 + dzx;
  const RsocChain chc = rsoc_chain(ze, zn, zx, lam);

  const float sum0 = ze0 + zn0, sumc = ze + zn, dsum = dze + dzn;
  const float d0 = 2.0f * ze0 * zn0 - zx0;
  const float dc = 2.0f * zn0 * dze + 2.0f * ze * dzn - dzx;  // exact telescope
  const float d_c = d0 + dc;
  const float dg = dc / (2.0f * lam);
  const float g0 = d0 / (2.0f * lam);
  const float gc = d_c / (2.0f * lam);
  const float q0 = 4.0f * (ze0 * ze0 + zn0 * zn0 + zx0) / lam + 16.0f;
  const float dq = 4.0f * ((ze0 + ze) * dze + (zn0 + zn) * dzn + dzx) / lam;
  const float qc = q0 + dq;

  // w, negative-d branch: w = (N u) / E, N = 2 sum^2/lam, u = 1/g_neg,
  // E = 1 + 4u + sqrt(1 + q u^2)
  const float gn0 = (g0 < 0.f) ? -g0 : 1.0f;
  const float gnc = (gc < 0.f) ? -gc : 1.0f;
  const float dgn = (g0 < 0.f && gc < 0.f) ? -dg : gnc - gn0;
  const float u0 = 1.0f / gn0, uc = 1.0f / gnc;
  const float du = -dgn / (gn0 * gnc);
  const float N0 = 2.0f * sum0 * sum0 / lam;
  const float dN = 2.0f * (sum0 + sumc) * dsum / lam;
  const float h0 = sqrtf(1.0f + q0 * u0 * u0);
  const float hc = sqrtf(1.0f + qc * uc * uc);
  const float dh = (dq * uc * uc + q0 * (u0 + uc) * du) / (h0 + hc);
  const float E0 = 1.0f + 4.0f * u0 + h0;
  const float Ec = 1.0f + 4.0f * uc + hc;
  const float dE = 4.0f * du + dh;
  const float dNu = dN * uc + N0 * du;
  const float w_neg0 = (N0 * u0) / E0;
  const float dw_neg = (dNu - w_neg0 * dE) / Ec;

  // w, positive-d branch: w = (g - 4 + sqrt(g^2 + q)) / 2
  const float gp0 = (g0 > 0.f) ? g0 : 1.0f;
  const float gpc = (gc > 0.f) ? gc : 1.0f;
  const float dgp = (g0 > 0.f && gc > 0.f) ? dg : gpc - gp0;
  const float S0 = sqrtf(gp0 * gp0 + q0);
  const float Sc = sqrtf(gpc * gpc + qc);
  const float dS = ((gp0 + gpc) * dgp + dq) / (S0 + Sc);
  const float dw_pos = (dgp + dS) / 2.0f;

  const bool neg0 = d0 < 0.f, negc = d_c < 0.f;
  const float w_abs0 = neg0 ? w_neg0 : (gp0 - 4.0f + S0) / 2.0f;
  float dw = (neg0 && negc) ? dw_neg : ((!neg0 && !negc) ? dw_pos : NAN);
  const float w_absc =
      negc ? (2.0f * sumc * sumc / lam) / gnc / (1.0f + 4.0f / gnc + hc) : (gpc - 4.0f + Sc) / 2.0f;
  if (isnan(dw)) dw = w_absc - w_abs0;

  const float root0 = sqrtf(max0(w_abs0 * (w_abs0 + 4.0f)));
  const float rootc = sqrtf(max0(w_absc * (w_absc + 4.0f)));
  const float droot = (w_abs0 + w_absc + 4.0f) * dw / (root0 + rootc + kTiny);

  float dx1 = NAN, dx2 = NAN, dsc = NAN;
  if (ch0.pb && chc.pb) {
    d_heads_std(ze0, zn0, dze, dzn, (w_abs0 + root0) / 2.0f, (w_absc + rootc) / 2.0f,
                (dw + droot) / 2.0f, &dx1, &dx2, &dsc);
  } else if (ch0.bb && chc.bb) {
    const float e0 = w_abs0 + 2.0f + root0 + kTiny, ec = w_absc + 2.0f + rootc + kTiny;
    d_heads_b(ze0, zn0, dze, dzn, 2.0f / e0, 2.0f / ec, -2.0f * (dw + droot) / (e0 * ec), &dx1,
              &dx2, &dsc);
  } else if (!ch0.pb && !chc.pb && !ch0.bb && !chc.bb) {
    d_heads_std(ze0, zn0, dze, dzn, (w_abs0 - root0) / 2.0f, (w_absc - rootc) / 2.0f,
                (dw - droot) / 2.0f, &dx1, &dx2, &dsc);
  }
  if (ch0.dg && chc.dg) {  // sum_zz == 0: x2 = (-ze + sqrt(ze^2 + 4 lam + zx)) / 2
    const float T0 = sqrtf(ze0 * ze0 + 4.0f * lam + zx0);
    const float Tc = sqrtf(ze * ze + 4.0f * lam + zx);
    const float dT = ((ze0 + ze) * dze + dzx) / (T0 + Tc);
    const float dx2d = (-dze + dT) / 2.0f;
    dx1 = dx2d + dze;
    dx2 = dx2d;
    dsc = 0.f;
  }
  // any remaining NaN (mismatch sentinel or genuine): direct difference
  *o_dx1 = isnan(dx1) ? chc.x1 - ch0.x1 : dx1;
  *o_dx2 = isnan(dx2) ? chc.x2 - ch0.x2 : dx2;
  *o_dsc = isnan(dsc) ? chc.sc - ch0.sc : dsc;
}

// orthant barrier-prox delta, cancellation-free
__device__ __forceinline__ float prox_nn_delta(float dt, float t0, float lam) {
  const float s0 = sqrtf(t0 * t0 + 4.0f * lam);
  const float t = t0 + dt;
  const float s = sqrtf(t * t + 4.0f * lam);
  const float ds = dt * (t0 + t) / (s + s0);
  if (t >= 0.f) return 0.5f * (dt + ds);
  return 2.0f * lam * (dt - ds) / ((s - t) * (s0 - t0) + kTiny);
}

__global__ void __launch_bounds__(kThreads) conic_delta_kernel(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe, nb = a.cones.nb;
  const bool woodbury = a.woodbury != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int mk = woodbury ? m : n;

  float* s_dy = smem;         // m: dy
  float* s_dvy = s_dy + m;    // m: dvy
  float* s_wy = s_dvy + m;    // m: dwy
  float* s_at = s_wy + m;     // m: A t
  float* s_u = s_at + m;      // m: G^-1 A t
  float* s_zy = s_u + m;      // m: dzy
  float* s_dx = s_zy + m;     // n: dx
  float* s_dvx = s_dx + n;    // n: dvx
  float* s_t = s_dvx + n;     // n: drhs or t, then the prox argument delta dtx
  float* s_zx = s_t + n;      // n: dzx, then drel_x
  float* s_a0 = s_zx + n;     // nb: anchor head value
  float* s_s20 = s_a0 + nb;   // nb: anchor RSOC second head
  float* s_bsq0 = s_s20 + nb; // nb: anchor body sum of squares
  float* s_sc0 = s_bsq0 + nb; // nb: anchor body scale
  float* s_dh1 = s_sc0 + nb;  // nb: head delta
  float* s_dr2 = s_dh1 + nb;  // nb: RSOC second-head delta
  float* s_dsc = s_dr2 + nb;  // nb: body-scale delta
  float* red = s_dsc + nb;    // kWarps * kRed

  const float* sc = a.in[I_SCAL] + b * C_COUNT;
  const float* A = a.in[I_A] + b * m * n;
  const float* Minv = a.in[I_MINV] + b * mk * mk;
  const float* hinv = a.in[I_HINV] + b * n;
  const float* ry = a.in[I_RY] + b * m;
  const float* rx = a.in[I_RX] + b * n;
  const float* bv = a.in[I_B] + b * m;
  const float* cv = a.in[I_C] + b * n;
  const float* qd = a.in[I_QD] + b * n;
  const float* t0x = a.in[I_T0X] + b * n;
  const float* etx = a.in[I_ETX] + b * n;
  const float* e_y = a.in[I_EY] + b * m;
  const float* e_x = a.in[I_EX] + b * n;
  const float* e_vx = a.in[I_EVX] + b * n;
  const float* e_vy = a.in[I_EVY] + b * m;
  const float* qz0 = a.in[I_QZ0] + b * n;
  const float* qx0 = a.in[I_QX0] + b * n;
  const float* e0y = a.in[I_E0Y] + b * m;
  const float* e0x = a.in[I_E0X] + b * n;
  const float* qu0y = a.in[I_QU0Y] + b * m;
  const float* qu0x = a.in[I_QU0X] + b * n;
  const float* von0y = a.in[I_VON0Y] + b * m;
  const float* von0x = a.in[I_VON0X] + b * n;
  const Cones& cn = a.cones;

  const float rho_y = sc[C_RHOY], rho_x = sc[C_RHOX], rho_tau = sc[C_RHOT];
  const float a_coef = sc[C_ACOEF], lam = sc[C_LAM], alpha = sc[C_ALPHA];
  const float thresh = sc[C_THRESH];
  const float b0s = sc[C_B0], c0s = sc[C_C0], s0s = sc[C_S0];
  const float tau0 = sc[C_TAU0], kap0 = sc[C_KAP0], t0t = sc[C_T0T], ett = sc[C_ETT];
  const float etau = sc[C_ETAU], evtau = sc[C_EVTAU], n0t = sc[C_N0T];
  const float e0t = sc[C_E0T], qu0t = sc[C_QU0T], qn0 = sc[C_QN0], vn0 = sc[C_VN0];
  const float inv_ry = 1.0f / rho_y, oma = 1.0f - alpha;
  const float lam_x = lam / rho_x, lam_tau = lam / rho_tau;
  const int t_max = a.t_max[b];

  for (int i = tid; i < m; i += kThreads) { s_dy[i] = 0.f; s_dvy[i] = 0.f; }
  for (int j = tid; j < n; j += kThreads) { s_dx[j] = 0.f; s_dvx[j] = 0.f; }
  for (int k = warp; k < nb; k += kWarps) {  // the anchor's block values, once
    const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
    const float bsq0 = body_sum(st, len, is_soc ? 1 : 2, lane, [&](int e) {
      const float v = __ldg(t0x + e);
      return v * v;
    });
    if (lane == 0) {
      const float a0 = t0x[st], s20 = is_soc ? 0.f : t0x[st + 1];
      s_a0[k] = a0;
      s_s20[k] = s20;
      s_bsq0[k] = bsq0;
      s_sc0[k] = is_soc ? soc_chain(a0, bsq0, lam_x).sc : rsoc_chain(a0, s20, bsq0, lam_x).sc;
    }
  }
  float dtau = 0.f, dkap = 0.f;
  __syncthreads();

  // One conic DR iteration on the deltas.
  auto step = [&]() {
    // p: <ry,dwy>, <rx,dwx>, <ry,dzy>, <rx,dzx>, <Qz0,dzx>, <dzx,Qd dzx>
    float p[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < m; k += kThreads) {
      const float w = rho_y * (s_dy[k] + s_dvy[k]);
      s_wy[k] = w;
      p[0] += ry[k] * w;
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {  // drhs = dwx + A'(dwy / rho_y)
      const float wx = rho_x * (s_dx[j] + s_dvx[j]);
      p[1] += rx[j] * wx;
      const float r = wx + inv_ry * col_dot(A, s_wy, m, n, j);
      s_t[j] = woodbury ? hinv[j] * r : r;
    }
    __syncthreads();
    if (woodbury) {
      for (int k = warp; k < m; k += kWarps) {
        const float acc = row_dot(A + (size_t)k * n, s_t, n, lane);
        if (lane == 0) s_at[k] = acc;
      }
      __syncthreads();
      for (int k = warp; k < m; k += kWarps) {
        const float acc = row_dot(Minv + (size_t)k * m, s_at, m, lane);
        if (lane == 0) s_u[k] = acc;
      }
      __syncthreads();
    }
    for (int j = tid; j < n; j += kThreads) {
      const float z = woodbury ? s_t[j] - hinv[j] * col_dot(A, s_u, m, n, j)
                               : col_dot(Minv, s_t, n, n, j);
      s_zx[j] = z;
      p[3] += rx[j] * z;
      p[4] += qz0[j] * z;
      p[5] += z * qd[j] * z;
    }
    __syncthreads();
    for (int k = warp; k < m; k += kWarps) {  // dzy = (dwy - A dzx) / rho_y
      const float acc = row_dot(A + (size_t)k * n, s_zx, n, lane);
      if (lane == 0) {
        const float z = inv_ry * (s_wy[k] - acc);
        s_zy[k] = z;
        p[2] += ry[k] * z;
      }
    }
    block_sum(p, red);
    // the tau-quadratic delta
    const float deta = rho_tau * (dtau + dkap);
    const float db = ((p[0] + p[1]) - 2.0f * (rho_y * p[2] + rho_x * p[3])) - deta;
    const float dc = -(2.0f * p[4] + p[5]);
    const float bc = b0s + db, cc = c0s + dc;
    const float s_cur = sqrtf(max0(bc * bc - 4.0f * a_coef * cc));
    const float ds = ((b0s + bc) * db - 4.0f * a_coef * dc) / (s_cur + s0s + kTiny);
    const float dtau_t = (-db + ds) / (2.0f * a_coef);
    for (int k = tid; k < m; k += kThreads) {
      const float drel = alpha * (s_zy[k] - dtau_t * ry[k]) + oma * s_dy[k];
      const float dyn = e_y[k] + (drel - s_dvy[k]);
      s_dvy[k] = ((s_dvy[k] + dyn) - drel) + e_vy[k];
      s_dy[k] = dyn;
    }
    for (int j = tid; j < n; j += kThreads) {
      const float drel = alpha * (s_zx[j] - dtau_t * rx[j]) + oma * s_dx[j];
      s_t[j] = (drel - s_dvx[j]) + etx[j];
      s_zx[j] = drel;
    }
    const float drel_t = alpha * dtau_t + oma * dtau;
    const float dtt = (drel_t - dkap) + ett;
    __syncthreads();
    for (int k = warp; k < nb; k += kWarps) {  // the cone blocks' delta chains
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const float dbsq = body_sum(st, len, is_soc ? 1 : 2, lane, [&](int e) {
        const float d = s_t[e];
        return 2.0f * __ldg(t0x + e) * d + d * d;
      });
      if (lane == 0) {
        if (is_soc) {
          soc_delta(s_a0[k], s_bsq0[k], s_t[st], dbsq, lam_x, &s_dh1[k], &s_dsc[k]);
          s_dr2[k] = 0.f;
        } else {
          rsoc_delta(s_a0[k], s_s20[k], s_bsq0[k], s_t[st], s_t[st + 1], dbsq, lam_x,
                     &s_dh1[k], &s_dr2[k], &s_dsc[k]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      const float dt = s_t[j];
      const int blk = cn.blk[j];
      float pd;
      switch (cn.code[j]) {
        case E_NN: pd = prox_nn_delta(dt, t0x[j], lam_x); break;
        case E_FREE: pd = dt; break;
        case E_SOC_H:
        case E_RSOC_H1: pd = s_dh1[blk]; break;
        case E_RSOC_H2: pd = s_dr2[blk]; break;
        case E_SOC_B:
        case E_RSOC_B: pd = s_sc0[blk] * dt + s_dsc[blk] * (t0x[j] + dt); break;
        default: pd = 0.f;  // zero cone
      }
      const float dxn = e_x[j] + pd;
      s_dvx[j] = ((s_dvx[j] + dxn) - s_zx[j]) + e_vx[j];
      s_dx[j] = dxn;
    }
    const float dtau_n = etau + prox_nn_delta(dtt, t0t, lam_tau);
    dkap = ((dkap + dtau_n) - drel_t) + evtau;
    dtau = dtau_n;
    __syncthreads();
  };

  // the inner criterion at anchor + delta (`qcp_config.c:518-557`)
  auto err_delta = [&]() -> float {
    // p: |r1|^2 + |r2|^2, <Qu0,dQ>, |dQ|^2, <von0,dvon>, |dvon|^2, <dy,b>,
    //    <Qx0,dx>, <dx,Qd dx>, <dx,c>
    float p[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = warp; k < m; k += kWarps) {  // dQy = A dx - b dtau
      const float acc = row_dot(A + (size_t)k * n, s_dx, n, lane);
      if (lane == 0) {
        const float dq = acc - bv[k] * dtau;
        const float dvon = rho_y * s_dvy[k];
        const float r1 = (e0y[k] + dq) - dvon;
        p[0] += r1 * r1;
        p[1] += qu0y[k] * dq;
        p[2] += dq * dq;
        p[3] += von0y[k] * dvon;
        p[4] += dvon * dvon;
        p[5] += s_dy[k] * bv[k];
      }
    }
    for (int j = tid; j < n; j += kThreads) {  // dQx = Qd dx - A'dy + c dtau
      const float dx = s_dx[j];
      const float dq = (qd[j] * dx - col_dot(A, s_dy, m, n, j)) + cv[j] * dtau;
      const float dvon = rho_x * s_dvx[j];
      const float r2 = (e0x[j] + dq) - dvon;
      p[0] += r2 * r2;
      p[1] += qu0x[j] * dq;
      p[2] += dq * dq;
      p[3] += von0x[j] * dvon;
      p[4] += dvon * dvon;
      p[6] += qx0[j] * dx;
      p[7] += dx * qd[j] * dx;
      p[8] += dx * cv[j];
    }
    block_sum(p, red);
    // N = x'Qx; Qu_tau = -N/tau + y.b - x.c
    const float dN = 2.0f * p[6] + p[7];
    const float tau = tau0 + dtau;
    const float tau_safe = (fabsf(tau) < kEpsTau) ? kEpsTau : tau;
    const float dqt = (-(dN - n0t * dtau) / tau_safe + p[5]) - p[8];
    const float dvont = rho_tau * dkap;
    const float r3 = (e0t + dqt) - dvont;
    const float d2 = p[0] + r3 * r3;
    const float qn = sqrtf(max0(qn0 * qn0 + 2.0f * (p[1] + qu0t * dqt) + p[2] + dqt * dqt));
    const float vn =
        sqrtf(max0(vn0 * vn0 + 2.0f * (p[3] + rho_tau * kap0 * dvont) + p[4] + dvont * dvont));
    return sqrtf(max0(d2)) / ((1.0f + qn) + vn);
  };

  int t = 0;
  float e = sc[C_QINIT];
  while (t < t_max && e >= thresh) {
    for (int it = 0; it < probe; ++it) step();
    t += probe;
    e = err_delta();
  }

  for (int k = tid; k < m; k += kThreads) {
    a.out[O_DY][b * m + k] = s_dy[k];
    a.out[O_DVY][b * m + k] = s_dvy[k];
  }
  for (int j = tid; j < n; j += kThreads) {
    a.out[O_DX][b * n + j] = s_dx[j];
    a.out[O_DVX][b * n + j] = s_dvx[j];
  }
  if (tid == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = dtau; row[1] = dkap; row[2] = e; row[3] = (float)t;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) with nb cone blocks needs.
long long abip_conic_delta_smem_bytes(int m, int n, int nb) {
  return (6LL * m + 4LL * n + 7LL * nb + (long long)kWarps * kRed) * sizeof(float);
}

int abip_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches one chunk over B lanes on `stream`; returns the CUDA error code.
// in: the 23 f32 ConicDeltaAnchor operands, t_max (int32, B), then the int32
// cone rows code, blk (n) and start, length, soc (nb); out: dy, dx, dvy, dvx,
// row.  All contiguous, lane-major.  `psi` is unused (the ladder's signature).
int abip_conic_delta(void* const* in, void* const* out, int B, int m, int n, int nb, int probe,
                     float psi, int woodbury, void* stream) {
  (void)psi;
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  a.cones.code = static_cast<const int*>(in[I_CODE]);
  a.cones.blk = static_cast<const int*>(in[I_BLK]);
  a.cones.start = static_cast<const int*>(in[I_START]);
  a.cones.length = static_cast<const int*>(in[I_LEN]);
  a.cones.soc = static_cast<const int*>(in[I_SOC]);
  a.cones.nb = nb;
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  a.m = m;
  a.n = n;
  a.probe = probe;
  a.woodbury = woodbury;
  const int smem = (int)abip_conic_delta_smem_bytes(m, n, nb);
  cudaError_t err = cudaFuncSetAttribute(conic_delta_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conic_delta_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
