// Anchored-delta conic DR chunk for Hopper (sm_90a), one thread-block
// cluster per lane.
//
// Replaces the TPU kernel `_conic_delta_kernel_batched` of
// `abip_tpu/ops/conic_delta.py` (Pallas, grid over lanes).  It computes what
// `abip_tpu_torch/ops/conic_delta.py:_conic_delta_compute` computes: up to
// t_max[b] f32 conic DR iterations of lane b in the DELTA frame of an f64
// anchor (`docs/conic_delta_design.md`), probing the delta-frame inner
// criterion every `probe` iterations and stopping the lane once it drops
// below the lane's threshold.  Per iteration: the linear pipeline on deltas
// (the Woodbury form applies G^-1 (m x m) between two A passes, the direct
// form S^-1 (n x n)), the tau-quadratic delta, the telescoped cone prox
// deltas, the dual update.  Where anchor and current point sit on different
// branches the chains fall back to the direct difference of the recomputed
// chain values; the RSOC chain marks a mismatch with NaN and then replaces
// every NaN delta, sentinel or genuine, by the direct difference (so `isnan`
// must survive the build).
//
// Layout (K1's, csrc/admm_delta.cu).  Lane b is cluster b of C CTAs
// (launched with cudaLaunchKernelEx; C and the residency from
// `conic_delta_launch_plan` in the wrapper).  CTA r owns the columns
// [r nc, (r+1) nc) (nc a multiple of 4) and the x-side state of those
// columns; the m-side state (dy, dvy and the projection's m-vectors) is
// replicated in every CTA, which all compute it alike.  Resident (kRes),
// each CTA holds its column slice of A and its slices of the operands in
// shared memory for the whole launch; otherwise they are read through L2
// and the m-side state lives in a global workspace; spilled, the streaming
// form's shared-memory layout lies in that workspace too (the other CTAs
// read it from L2), so that the kernel takes every shape.  G^-1 (or S^-1) is
// read through L2: holding a CTA's rows of it too was no faster (PERF.md).
// Every array of the layout is padded to 16 bytes, pads hold zeros.
//
// Exchanges (a cluster barrier, then reads of the other CTAs' shared memory,
// each sum in rank order, so every CTA holds the same bits and takes the
// same stop decision; cluster_common.cuh), per iteration in the Woodbury
// form:
//   1. A t, t = H^-1 (dwx + A' dwy / rho_y): a partial m-vector from each
//      CTA's columns, summed;
//   2. u = G^-1 (A t): each CTA computes its rows, the others read them;
//   3. A zx, the four x-side sums of the tau quadratic, and the block sums
//      of the cone blocks that straddle CTAs.
// The direct form gathers dwx + A' dwy / rho_y (each CTA applies its column
// slice of S^-1 to the whole vector) and then makes exchange 3.  A probe
// takes one exchange: A dx and the criterion's eight x-side sums.
//
// The cone blocks (SOC, then RSOC, first in x; `cones.py`) are walked one
// warp per block.  A block's body sum of squares of the prox argument,
// sum(2 t0 d + d^2) with d = d0 - c rx, c = alpha dtau_t and d0 the
// argument before the tau correction, is rewritten as
//   P0 - 2 c P1 + c^2 P2,  P0 = sum(2 t0 d0 + d0^2), P1 = sum((t0 + d0) rx),
//   P2 = sum(rx^2)
// (P2 once per launch): P0 and P1 are known before dtau_t is, so a block
// that straddles CTAs has them summed in exchange 3 with its head values,
// and no further exchange is needed.  Every CTA that holds a part of such a
// block runs its chain on the same bits (the CTAs' partials added by one
// warp's butterfly, alike in each).  The anchor's side of each chain is
// computed once per launch.  A column dot over the m rows is split over up
// to kMaxSplit threads a column.
//
// What bounds it on this card: latency and the shared-memory passes over A
// (four a iteration), not HBM: three cluster barriers with their rounds of
// remote loads, and the dependent chain of the tau quadratic and the cone
// prox, per iteration.

#include "conic_cluster.cuh"

namespace {

using cluster_ops::block_sum;
using cluster_ops::cols_per_cta;
using cluster_ops::rank_read;
using cluster_ops::rank_sum4;
using cluster_ops::rows_dot;
using cluster_ops::warp_sum;
using conic_cluster::col_total;
using conic_cluster::first_block_ending_after;
using conic_cluster::first_block_from;
using conic_cluster::kThreads;
using conic_cluster::kWarps;
using conic_cluster::res_lda;
using conic_cluster::split_col_dots;
using conic_cluster::thread_rows_dot;
using conic::body_sum;
using conic::Cones;
using conic::kEpsTau;
using conic::kSocTol;
using conic::kTiny;
using conic::max0;
using conic::rsoc_heads_b;
using conic::rsoc_heads_std;
using conic::rsoc_w;
using conic::tiny_guard;
using conic::E_NN;
using conic::E_FREE;
using conic::E_SOC_H;
using conic::E_SOC_B;
using conic::E_RSOC_H1;
using conic::E_RSOC_H2;
using conic::E_RSOC_B;

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

constexpr int kRed = 12;     // reduction scratch per warp
constexpr int kSlot = 24;    // one exchange slot: sums, then two block entries
constexpr int kSlotL = 8;    // the block that holds this CTA's first column
constexpr int kSlotR = 16;   // the block that holds its last column
constexpr int kMVecs = 5;    // dy, dvy, wy, A t, zy (u, read by the others, apart)
constexpr int kXState = 4;   // dx, dvx, t, zx
constexpr int kXOps = 8;     // hinv, rx, qd, qz0, t0x, etx, e_x, e_vx
constexpr int kMOps = 3;     // ry, e_y, e_vy: the m-side operands an iteration reads
// per block of this CTA: anchor head values, body sums of squares, scale,
// P2, P0, P1, and the chain's outputs; then the anchor's chain (kAnc
// floats a block), computed once per launch
enum { V_A0, V_S20, V_BSQ0, V_SC0, V_P2, V_P0, V_P1, V_DH1, V_DR2, V_DSC, V_COUNT };
constexpr int kAnc = 20;
// an exchanged block entry: P0, P1, then (zx, dx, dvx) of each head
enum { X_P0, X_P1, X_H1, X_H2 = X_H1 + 3, X_COUNT = X_H2 + 3 };

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  Cones cones;
  float* out[O_COUNT];
  float* work;      // streaming form: wfl floats per CTA
  long long wfl;    // the m-side vectors, then (spilled) the layout
  int m, n, nc, mr, probe, woodbury;
};

using cluster_ops::al4;

// Shared memory of one CTA, in floats: the reduction scratch, the exchange
// slots and sums, the exchange buffers of the partial m-vectors, u, the
// x-side state, the gathered rhs (direct form), the block values and
// anchor chains (at most min(nb, nc) blocks touch nc columns), the split
// column dots' partials; resident, the other m-side vectors
// (else in a global workspace), A's slice, the x-side operand slices and
// the m-side operands an iteration reads.  Streaming at C = 16 this is less
// than the one-block kernel's 6 m + 4 n + 7 nb floats for every shape.
__host__ __device__ inline long long smem_floats(int m, int n, int nb, int nc, bool res,
                                                 bool woodbury) {
  const long long mp = al4(m);
  const long long nbl = nb < nc ? nb : nc;
  long long f = (long long)kWarps * kRed + 3LL * kSlot + 3 * mp + (long long)kXState * nc +
                (woodbury ? 0 : al4(n)) + al4((V_COUNT + kAnc) * nbl) +
                (nc > kThreads ? nc : kThreads);
  if (res) f += (kMVecs + kMOps) * mp + (long long)m * res_lda(nc) + (long long)kXOps * nc;
  return f;
}

// Global workspace of one CTA of the streaming form, in floats: the m-side
// vectors, and in the spilled form the shared-memory layout after them.
inline long long work_floats(int m, int n, int nb, int nc, bool woodbury, bool spill) {
  return kMVecs * al4(m) + (spill ? al4(smem_floats(m, n, nb, nc, false, woodbury)) : 0);
}

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

// (d_eta, d_sc) of the SOC chain from the anchor's chain c0 (at a0, bsq0);
// the direct difference on a branch mismatch
__device__ __noinline__ void soc_delta(const SocChain& c0, float a0, float bsq0, float da,
                                       float dbsq, float lam, float* d_eta, float* d_sc) {
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

// The anchor's side of the RSOC delta chain: its chain and every
// intermediate of `rsoc_delta` that depends on the anchor alone.
struct RsocAnchor {
  RsocChain ch;
  float d0, g0, q0, gn0, u0, N0, h0, E0, w_neg0, gp0, S0, w_abs0, root0, T0;
};

__device__ RsocAnchor rsoc_anchor(float ze0, float zn0, float zx0, float lam) {
  RsocAnchor a;
  a.ch = rsoc_chain(ze0, zn0, zx0, lam);
  const float sum0 = ze0 + zn0;
  a.d0 = 2.0f * ze0 * zn0 - zx0;
  a.g0 = a.d0 / (2.0f * lam);
  a.q0 = 4.0f * (ze0 * ze0 + zn0 * zn0 + zx0) / lam + 16.0f;
  a.gn0 = (a.g0 < 0.f) ? -a.g0 : 1.0f;
  a.u0 = 1.0f / a.gn0;
  a.N0 = 2.0f * sum0 * sum0 / lam;
  a.h0 = sqrtf(1.0f + a.q0 * a.u0 * a.u0);
  a.E0 = 1.0f + 4.0f * a.u0 + a.h0;
  a.w_neg0 = (a.N0 * a.u0) / a.E0;
  a.gp0 = (a.g0 > 0.f) ? a.g0 : 1.0f;
  a.S0 = sqrtf(a.gp0 * a.gp0 + a.q0);
  a.w_abs0 = (a.d0 < 0.f) ? a.w_neg0 : (a.gp0 - 4.0f + a.S0) / 2.0f;
  a.root0 = sqrtf(max0(a.w_abs0 * (a.w_abs0 + 4.0f)));
  a.T0 = sqrtf(ze0 * ze0 + 4.0f * lam + zx0);
  return a;
}

// (d_x1, d_x2, d_sc) of the RSOC chain (`cones.c:169-248`) from the
// anchor's side A0 (at ze0, zn0, zx0)
__device__ __noinline__ void rsoc_delta(const RsocAnchor& A0, float ze0, float zn0, float zx0,
                                        float dze, float dzn, float dzx, float lam,
                                        float* o_dx1, float* o_dx2, float* o_dsc) {
  const RsocChain& ch0 = A0.ch;
  const float ze = ze0 + dze, zn = zn0 + dzn, zx = zx0 + dzx;
  const RsocChain chc = rsoc_chain(ze, zn, zx, lam);

  const float sum0 = ze0 + zn0, sumc = ze + zn, dsum = dze + dzn;
  const float d0 = A0.d0;
  const float dc = 2.0f * zn0 * dze + 2.0f * ze * dzn - dzx;  // exact telescope
  const float d_c = d0 + dc;
  const float dg = dc / (2.0f * lam);
  const float g0 = A0.g0;
  const float gc = d_c / (2.0f * lam);
  const float q0 = A0.q0;
  const float dq = 4.0f * ((ze0 + ze) * dze + (zn0 + zn) * dzn + dzx) / lam;
  const float qc = q0 + dq;

  // w, negative-d branch: w = (N u) / E, N = 2 sum^2/lam, u = 1/g_neg,
  // E = 1 + 4u + sqrt(1 + q u^2)
  const float gn0 = A0.gn0;
  const float gnc = (gc < 0.f) ? -gc : 1.0f;
  const float dgn = (g0 < 0.f && gc < 0.f) ? -dg : gnc - gn0;
  const float u0 = A0.u0, uc = 1.0f / gnc;
  const float du = -dgn / (gn0 * gnc);
  const float N0 = A0.N0;
  const float dN = 2.0f * (sum0 + sumc) * dsum / lam;
  const float h0 = A0.h0;
  const float hc = sqrtf(1.0f + qc * uc * uc);
  const float dh = (dq * uc * uc + q0 * (u0 + uc) * du) / (h0 + hc);
  const float Ec = 1.0f + 4.0f * uc + hc;
  const float dE = 4.0f * du + dh;
  const float dNu = dN * uc + N0 * du;
  const float w_neg0 = A0.w_neg0;
  const float dw_neg = (dNu - w_neg0 * dE) / Ec;

  // w, positive-d branch: w = (g - 4 + sqrt(g^2 + q)) / 2
  const float gp0 = A0.gp0;
  const float gpc = (gc > 0.f) ? gc : 1.0f;
  const float dgp = (g0 > 0.f && gc > 0.f) ? dg : gpc - gp0;
  const float S0 = A0.S0;
  const float Sc = sqrtf(gpc * gpc + qc);
  const float dS = ((gp0 + gpc) * dgp + dq) / (S0 + Sc);
  const float dw_pos = (dgp + dS) / 2.0f;

  const bool neg0 = d0 < 0.f, negc = d_c < 0.f;
  const float w_abs0 = A0.w_abs0;
  float dw = (neg0 && negc) ? dw_neg : ((!neg0 && !negc) ? dw_pos : NAN);
  const float w_absc =
      negc ? (2.0f * sumc * sumc / lam) / gnc / (1.0f + 4.0f / gnc + hc) : (gpc - 4.0f + Sc) / 2.0f;
  if (isnan(dw)) dw = w_absc - w_abs0;

  const float root0 = A0.root0;
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
    const float T0 = A0.T0;
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

static_assert(sizeof(SocChain) <= kAnc * sizeof(float), "SOC anchor record");
static_assert(sizeof(RsocAnchor) <= kAnc * sizeof(float), "RSOC anchor record");

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1) conic_delta_cluster_kernel(Args a) {
  constexpr bool kRes = kForm == cluster_ops::kResident;
  constexpr bool kSpill = kForm == cluster_ops::kSpilled;
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = a.m, n = a.n, nc = a.nc, mr = a.mr, probe = a.probe;
  const bool woodbury = a.woodbury != 0;
  const Cones& cn = a.cones;
  const int c0 = rank * nc;
  const int ncol = max(0, min(nc, n - c0));  // this CTA's columns
  const int i0 = rank * mr;
  const int nrow = max(0, min(mr, m - i0));  // this CTA's rows of G^-1
  const int mp = (int)al4(m);
  const int nbl = min(cn.nb, nc);            // block capacity
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x / C;
  const int mk = woodbury ? m : n;

  // the blocks that touch this CTA's columns: [k_lo, k_hi)
  const int k_lo = ncol > 0 ? first_block_ending_after(cn, c0) : 0;
  const int k_hi = ncol > 0 ? first_block_from(cn, c0 + ncol) : 0;

  // streaming: this CTA's workspace; spilled, the layout lies in it too,
  // and `peer` is the stride between the cluster's copies
  float* ws = kRes ? nullptr : a.work + (size_t)blockIdx.x * a.wfl;
  const long long peer = kSpill ? a.wfl : 0;
  float* base = kSpill ? ws + kMVecs * mp : smem;
  float* red = base;                           // kWarps * kRed
  float* slots = red + kWarps * kRed;          // 2 x kSlot, by parity
  float* s_sums = slots + 2 * kSlot;           // kSlot: an exchange's sums
  float* xbuf = s_sums + kSlot;                // 2 x mp partial m-vectors
  float* s_u = xbuf + 2 * mp;                  // mp: G^-1 A t
  float* s_dx = s_u + mp;                      // the x-side state, nc each
  float* s_dvx = s_dx + nc;
  float* s_t = s_dvx + nc;                     // rhs, or t = H^-1 rhs
  float* s_zx = s_t + nc;
  float* s_rhs = s_zx + nc;                    // direct form: the whole rhs
  float* s_blk = s_rhs + (woodbury ? 0 : al4(n));  // V_COUNT x nbl
  float* s_anc = s_blk + V_COUNT * nbl;        // kAnc x nbl: anchor chains
  float* s_part = s_blk + al4((V_COUNT + kAnc) * nbl);  // split column dots
  float* s_mv = s_part + max(nc, kThreads);    // resident: kMVecs x mp
  float* s_A = s_mv + (kRes ? kMVecs * mp : 0);     // resident: m x res_lda(nc)
  float* s_xo = s_A + (kRes ? (size_t)m * res_lda(nc) : 0);  // resident: kXOps x nc
  float* s_mo = s_xo + (kRes ? (size_t)kXOps * nc : 0);  // resident: kMOps x mp
  // the other m-side vectors (replicated in every CTA), mp each
  float* mv = kRes ? s_mv : ws;
  float* s_dy = mv;
  float* s_dvy = mv + mp;
  float* s_wy = mv + 2 * mp;
  float* s_at = mv + 3 * mp;  // A t
  float* s_zy = mv + 4 * mp;
  auto bv_ = [&](int v, int kl) -> float& { return s_blk[v * nbl + kl]; };

  const float* sc = a.in[I_SCAL] + b * C_COUNT;
  const float* gA = a.in[I_A] + b * m * n;
  const float* gM = a.in[I_MINV] + b * (size_t)mk * mk;
  const float* ry = kRes ? s_mo : a.in[I_RY] + b * m;
  const float* bv = a.in[I_B] + b * m;
  const float* e_y = kRes ? s_mo + mp : a.in[I_EY] + b * m;
  const float* e_vy = kRes ? s_mo + 2 * mp : a.in[I_EVY] + b * m;
  const float* e0y = a.in[I_E0Y] + b * m;
  const float* qu0y = a.in[I_QU0Y] + b * m;
  const float* von0y = a.in[I_VON0Y] + b * m;
  // whole x-side rows, for the blocks' anchor values and head arguments
  const float* t0x_row = a.in[I_T0X] + b * n;
  const float* rx_row = a.in[I_RX] + b * n;
  const float* etx_row = a.in[I_ETX] + b * n;
  // this CTA's slices of the x-side operands the iteration reads
  const int kXOpIndex[kXOps] = {I_HINV, I_RX, I_QD, I_QZ0, I_T0X, I_ETX, I_EX, I_EVX};
  const float* xop[kXOps];
#pragma unroll
  for (int k = 0; k < kXOps; ++k)
    xop[k] = kRes ? s_xo + (size_t)k * nc : a.in[kXOpIndex[k]] + b * n + c0;
  const float *hinv = xop[0], *rx = xop[1], *qd = xop[2], *qz0 = xop[3];
  const float *t0x = xop[4], *etx = xop[5], *e_x = xop[6], *e_vx = xop[7];
  // and those only a probe reads
  const float* cv = a.in[I_C] + b * n + c0;
  const float* qx0 = a.in[I_QX0] + b * n + c0;
  const float* e0x = a.in[I_E0X] + b * n + c0;
  const float* qu0x = a.in[I_QU0X] + b * n + c0;
  const float* von0x = a.in[I_VON0X] + b * n + c0;
  const int* code = cn.code + c0;
  const int* blk = cn.blk + c0;
  // A's slice (row stride lda), from shared memory or through L2
  const float* Ab = kRes ? s_A : gA + c0;
  const int lda = kRes ? res_lda(nc) : n;
  const int alen = kRes ? nc : ncol;  // the row dots' length
  // A's row dots over this CTA's columns: resident, one thread a row; else
  // one warp a row, coalesced through L2
  auto a_rows = [&](const float* Am, int ld, const float* w, int len, int rows, float* out) {
    if (kRes)
      thread_rows_dot<false>(Am, ld, w, nullptr, len, rows, out, nullptr);
    else
      rows_dot<false, false, kThreads>(Am, ld, w, nullptr, len, rows, out, nullptr);
  };

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

  if (kRes) {  // the launch's one load of this CTA's operands
    cluster_ops::load_slice<kThreads>(s_A, lda, gA + c0, n, m, ncol);
    const int kMIn[kMOps] = {I_RY, I_EY, I_EVY};
#pragma unroll
    for (int k = 0; k < kMOps; ++k)
      cluster_ops::load_slice<kThreads>(s_mo + (size_t)k * mp, mp, a.in[kMIn[k]] + b * m, 0, 1, m);
#pragma unroll
    for (int k = 0; k < kXOps; ++k)
      cluster_ops::load_slice<kThreads>(s_xo + (size_t)k * nc, nc, a.in[kXOpIndex[k]] + b * n + c0, 0, 1,
                              ncol);
  }
  cluster_ops::cp_async_commit();
  for (int i = tid; i < kMVecs * mp; i += kThreads) mv[i] = 0.f;
  for (int i = tid; i < mp; i += kThreads) s_u[i] = 0.f;
  for (int i = tid; i < 2 * mp; i += kThreads) xbuf[i] = 0.f;  // pads stay 0
  for (int j = tid; j < 4 * nc; j += kThreads) s_dx[j] = 0.f;  // every x-state slice
  cluster_ops::cp_async_wait();
  // the anchor's values of this CTA's blocks, once per launch, over the
  // whole block (every CTA that touches a block computes the same bits)
  for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
    const int k = k_lo + kl;
    const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
    const int off = is_soc ? 1 : 2;
    const float bsq0 = body_sum(st, len, off, lane, [&](int e) {
      const float v = __ldg(t0x_row + e);
      return v * v;
    });
    const float p2 = body_sum(st, len, off, lane, [&](int e) {
      const float v = __ldg(rx_row + e);
      return v * v;
    });
    if (lane == 0) {
      const float a0 = t0x_row[st], s20 = is_soc ? 0.f : t0x_row[st + 1];
      bv_(V_A0, kl) = a0;
      bv_(V_S20, kl) = s20;
      bv_(V_BSQ0, kl) = bsq0;
      bv_(V_P2, kl) = p2;
      float* rec = s_anc + (size_t)kl * kAnc;
      if (is_soc) {
        const SocChain c0 = soc_chain(a0, bsq0, lam_x);
        *reinterpret_cast<SocChain*>(rec) = c0;
        bv_(V_SC0, kl) = c0.sc;
      } else {
        const RsocAnchor r0 = rsoc_anchor(a0, s20, bsq0, lam_x);
        *reinterpret_cast<RsocAnchor*>(rec) = r0;
        bv_(V_SC0, kl) = r0.ch.sc;
      }
    }
  }
  __syncthreads();

  int e = 0;  // parity of the next exchange
  float dtau = 0.f, dkap = 0.f;

  // One conic DR iteration on the deltas.
  auto step = [&]() {
    // p: <ry,dwy> (this CTA: every row), then this CTA's columns' <rx,dwx>,
    // <rx,dzx>, <Qz0,dzx>, <dzx,Qd dzx>
    float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < m; i += kThreads) {
      const float w = rho_y * (s_dy[i] + s_dvy[i]);
      s_wy[i] = w;
      p[0] += ry[i] * w;
    }
    __syncthreads();
    int S = split_col_dots(Ab, lda, s_wy, m, ncol, s_part);
    for (int j = tid; j < ncol; j += kThreads) {  // drhs = dwx + A'(dwy / rho_y)
      const float wx = rho_x * (s_dx[j] + s_dvx[j]);
      p[1] += rx[j] * wx;
      const float r = wx + inv_ry * col_total(s_part, S, ncol, j);
      s_t[j] = woodbury ? hinv[j] * r : r;
    }
    __syncthreads();
    if (woodbury) {
      // exchange 1: A t over the cluster's columns
      float* part = xbuf + e * mp;
      a_rows(Ab, lda, s_t, alen, m, part);
      cluster_ops::sync();
      for (int i4 = tid; i4 < mp / 4; i4 += kThreads)
        reinterpret_cast<float4*>(s_at)[i4] = rank_sum4(part, i4, C, peer);
      __syncthreads();
      e ^= 1;
      // exchange 2: this CTA's rows of u = G^-1 (A t), read by the others
      if (kRes && (m & 3) == 0)
        rows_dot<false, true, kThreads>(gM + (size_t)i0 * m, m, s_at, nullptr, m, nrow, s_u + i0, nullptr);
      else
        rows_dot<false, false, kThreads>(gM + (size_t)i0 * m, m, s_at, nullptr, m, nrow, s_u + i0, nullptr);
      cluster_ops::sync();
      for (int i = tid; i < m; i += kThreads)
        if (i / mr != rank) s_u[i] = rank_read(s_u, i, i / mr, peer);
    } else {
      // the whole rhs, gathered from the cluster's slices
      cluster_ops::sync();
      for (int k = tid; k < n; k += kThreads) s_rhs[k] = rank_read(s_t, k % nc, k / nc, peer);
    }
    __syncthreads();
    // Woodbury: zx = t - H^-1 (A'u); direct: zx = rhs S^-1 (its columns)
    S = woodbury ? split_col_dots(Ab, lda, s_u, m, ncol, s_part)
                 : split_col_dots(gM + c0, n, s_rhs, n, ncol, s_part);
    for (int j = tid; j < ncol; j += kThreads) {
      const float ct = col_total(s_part, S, ncol, j);
      const float z = woodbury ? s_t[j] - hinv[j] * ct : ct;
      s_zx[j] = z;
      p[2] += rx[j] * z;
      p[3] += qz0[j] * z;
      p[4] += z * qd[j] * z;
    }
    __syncthreads();
    // exchange 3: A zx, the x-side sums, the block sums of straddling blocks
    float* part = xbuf + e * mp;
    float* slot = slots + e * kSlot;
    a_rows(Ab, lda, s_zx, alen, m, part);
    for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
      const int k = k_lo + kl;
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const int lo = max(st + (is_soc ? 1 : 2), c0), hi = min(st + len, c0 + ncol);
      float q0 = 0.f, q1 = 0.f;
      for (int g = lo + lane; g < hi; g += 32) {
        const int j = g - c0;
        const float d0 = ((alpha * s_zx[j] + oma * s_dx[j]) - s_dvx[j]) + etx[j];
        q0 += 2.0f * t0x[j] * d0 + d0 * d0;
        q1 += (t0x[j] + d0) * rx[j];
      }
      q0 = warp_sum(q0);
      q1 = warp_sum(q1);
      if (lane == 0) {
        bv_(V_P0, kl) = q0;
        bv_(V_P1, kl) = q1;
        if (st / nc != (st + len - 1) / nc) {  // it straddles CTAs
          float ent[X_COUNT] = {q0, q1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jh = st + h - c0;
            if ((h == 0 || !is_soc) && jh >= 0 && jh < ncol) {
              ent[X_H1 + 3 * h] = s_zx[jh];
              ent[X_H1 + 3 * h + 1] = s_dx[jh];
              ent[X_H1 + 3 * h + 2] = s_dvx[jh];
            }
          }
#pragma unroll
          for (int x = 0; x < X_COUNT; ++x) {
            if (st <= c0) slot[kSlotL + x] = ent[x];
            if (st + len >= c0 + ncol) slot[kSlotR + x] = ent[x];
          }
        }
      }
    }
    block_sum<kThreads>(p, red);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) slot[k] = p[k + 1];
    }
    cluster_ops::sync();
    for (int i4 = tid; i4 < mp / 4 + 1; i4 += kThreads) {
      if (i4 == mp / 4) {
        reinterpret_cast<float4*>(s_sums)[0] = rank_sum4(slot, 0, C, peer);
        continue;
      }
      const float4 az = rank_sum4(part, i4, C, peer);  // dzy = (dwy - A dzx) / rho_y
      const float a4[4] = {az.x, az.y, az.z, az.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * i4 + q;
        if (i < m) s_zy[i] = inv_ry * (s_wy[i] - a4[q]);
      }
    }
    __syncthreads();
    // <ry, dzy>, by every warp alike
    float p2 = 0.f;
    for (int i = lane; i < m; i += 32) p2 += ry[i] * s_zy[i];
    p2 = warp_sum(p2);
    // the tau-quadratic delta
    const float deta = rho_tau * (dtau + dkap);
    const float db = ((p[0] + s_sums[0]) - 2.0f * (rho_y * p2 + rho_x * s_sums[1])) - deta;
    const float dc = -(2.0f * s_sums[2] + s_sums[3]);
    const float bc = b0s + db, cc = c0s + dc;
    const float s_cur = sqrtf(max0(bc * bc - 4.0f * a_coef * cc));
    const float ds = ((b0s + bc) * db - 4.0f * a_coef * dc) / (s_cur + s0s + kTiny);
    const float dtau_t = (-db + ds) / (2.0f * a_coef);
    for (int i = tid; i < m; i += kThreads) {
      const float drel = alpha * (s_zy[i] - dtau_t * ry[i]) + oma * s_dy[i];
      const float dyn = e_y[i] + (drel - s_dvy[i]);
      s_dvy[i] = ((s_dvy[i] + dyn) - drel) + e_vy[i];
      s_dy[i] = dyn;
    }
    // the cone blocks' delta chains: the body sum from P0, P1, P2; the head
    // arguments as the element pass forms them
    const float cdt = alpha * dtau_t;
    auto head_arg = [&](float zx, float dx, float dvx, int g) {
      return ((alpha * (zx - dtau_t * rx_row[g]) + oma * dx) - dvx) + etx_row[g];
    };
    for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
      const int k = k_lo + kl;
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const int r_lo = st / nc, r_hi = (st + len - 1) / nc;
      float P0 = bv_(V_P0, kl), P1 = bv_(V_P1, kl), da, ds2 = 0.f;
      if (r_lo != r_hi) {
        // one round of remote loads: lane l the partials of CTA r_lo + l,
        // lanes 0-5 the head values; the same butterfly sum in every CTA
        const float* sl = slots + e * kSlot;
        float q0 = 0.f, q1 = 0.f, hv = 0.f;
        if (lane <= r_hi - r_lo) {
          const int o = (lane == 0) ? kSlotR : kSlotL;
          q0 = rank_read(sl, o + X_P0, r_lo + lane, peer);
          q1 = rank_read(sl, o + X_P1, r_lo + lane, peer);
        }
        const int r2 = (st + 1) / nc;
        if (lane < 3)
          hv = rank_read(sl, kSlotR + X_H1 + lane, r_lo, peer);
        else if (lane < 6 && !is_soc)
          hv = rank_read(sl, ((r2 == r_lo) ? kSlotR : kSlotL) + X_H2 + lane - 3, r2, peer);
        P0 = warp_sum(q0);
        P1 = warp_sum(q1);
        float h[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) h[i] = __shfl_sync(0xffffffffu, hv, i);
        da = head_arg(h[0], h[1], h[2], st);
        if (!is_soc) ds2 = head_arg(h[3], h[4], h[5], st + 1);
      } else {
        const int j = st - c0;
        da = head_arg(s_zx[j], s_dx[j], s_dvx[j], st);
        if (!is_soc) ds2 = head_arg(s_zx[j + 1], s_dx[j + 1], s_dvx[j + 1], st + 1);
      }
      if (lane == 0) {
        const float dbsq = (P0 - 2.0f * cdt * P1) + cdt * cdt * bv_(V_P2, kl);
        const float* rec = s_anc + (size_t)kl * kAnc;
        if (is_soc) {
          soc_delta(*reinterpret_cast<const SocChain*>(rec), bv_(V_A0, kl), bv_(V_BSQ0, kl), da,
                    dbsq, lam_x, &bv_(V_DH1, kl), &bv_(V_DSC, kl));
          bv_(V_DR2, kl) = 0.f;
        } else {
          rsoc_delta(*reinterpret_cast<const RsocAnchor*>(rec), bv_(V_A0, kl), bv_(V_S20, kl),
                     bv_(V_BSQ0, kl), da, ds2, dbsq, lam_x, &bv_(V_DH1, kl), &bv_(V_DR2, kl),
                     &bv_(V_DSC, kl));
        }
      }
    }
    e ^= 1;
    __syncthreads();
    for (int j = tid; j < ncol; j += kThreads) {
      const float drel = alpha * (s_zx[j] - dtau_t * rx[j]) + oma * s_dx[j];
      const float dt = (drel - s_dvx[j]) + etx[j];
      const int kl = blk[j] - k_lo;
      float pd;
      switch (code[j]) {
        case E_NN: pd = prox_nn_delta(dt, t0x[j], lam_x); break;
        case E_FREE: pd = dt; break;
        case E_SOC_H:
        case E_RSOC_H1: pd = bv_(V_DH1, kl); break;
        case E_RSOC_H2: pd = bv_(V_DR2, kl); break;
        case E_SOC_B:
        case E_RSOC_B: pd = bv_(V_SC0, kl) * dt + bv_(V_DSC, kl) * (t0x[j] + dt); break;
        default: pd = 0.f;  // zero cone
      }
      const float dxn = e_x[j] + pd;
      s_dvx[j] = ((s_dvx[j] + dxn) - drel) + e_vx[j];
      s_dx[j] = dxn;
    }
    const float drel_t = alpha * dtau_t + oma * dtau;
    const float dtt = (drel_t - dkap) + ett;
    const float dtau_n = etau + prox_nn_delta(dtt, t0t, lam_tau);
    dkap = ((dkap + dtau_n) - drel_t) + evtau;
    dtau = dtau_n;
    __syncthreads();
  };

  // the inner criterion at anchor + delta (`qcp_config.c:518-557`), through
  // one exchange: A dx and the x-side sums
  auto err_delta = [&]() -> float {
    float* part = xbuf + e * mp;
    a_rows(Ab, lda, s_dx, alen, m, part);
    // p: |r2|^2, <Qu0x,dQx>, |dQx|^2, <von0x,dvonx>, |dvonx|^2, <Qx0,dx>,
    //    <dx,Qd dx>, <dx,c>
    float p[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int S = split_col_dots(Ab, lda, s_dy, m, ncol, s_part);
    for (int j = tid; j < ncol; j += kThreads) {  // dQx = Qd dx - A'dy + c dtau
      const float dx = s_dx[j];
      const float dq = (qd[j] * dx - col_total(s_part, S, ncol, j)) + cv[j] * dtau;
      const float dvon = rho_x * s_dvx[j];
      const float r2 = (e0x[j] + dq) - dvon;
      p[0] += r2 * r2;
      p[1] += qu0x[j] * dq;
      p[2] += dq * dq;
      p[3] += von0x[j] * dvon;
      p[4] += dvon * dvon;
      p[5] += qx0[j] * dx;
      p[6] += dx * qd[j] * dx;
      p[7] += dx * cv[j];
    }
    block_sum<kThreads>(p, red);
    float* slot = slots + e * kSlot;
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) slot[k] = p[k];
    }
    cluster_ops::sync();
    // the y side, in every CTA: |r1|^2, <Qu0y,dQy>, |dQy|^2, <von0y,dvony>,
    // |dvony|^2, <dy,b>
    float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i4 = tid; i4 < mp / 4 + 2; i4 += kThreads) {
      if (i4 >= mp / 4) {
        const int k = i4 - mp / 4;
        reinterpret_cast<float4*>(s_sums)[k] = rank_sum4(slot, k, C, peer);
        continue;
      }
      const float4 ax = rank_sum4(part, i4, C, peer);
      const float a4[4] = {ax.x, ax.y, ax.z, ax.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 4 * i4 + q;
        if (i >= m) break;
        const float dq = a4[q] - bv[i] * dtau;  // dQy = A dx - b dtau
        const float dvon = rho_y * s_dvy[i];
        const float r1 = (e0y[i] + dq) - dvon;
        r[0] += r1 * r1;
        r[1] += qu0y[i] * dq;
        r[2] += dq * dq;
        r[3] += von0y[i] * dvon;
        r[4] += dvon * dvon;
        r[5] += s_dy[i] * bv[i];
      }
    }
    e ^= 1;
    block_sum<kThreads>(r, red);  // its barrier also publishes s_sums
    // N = x'Qx; Qu_tau = -N/tau + y.b - x.c
    const float dN = 2.0f * s_sums[5] + s_sums[6];
    const float tau = tau0 + dtau;
    const float tau_safe = (fabsf(tau) < kEpsTau) ? kEpsTau : tau;
    const float dqt = (-(dN - n0t * dtau) / tau_safe + r[5]) - s_sums[7];
    const float dvont = rho_tau * dkap;
    const float r3 = (e0t + dqt) - dvont;
    const float d2 = (r[0] + s_sums[0]) + r3 * r3;
    const float qn = sqrtf(
        max0(qn0 * qn0 + 2.0f * ((r[1] + s_sums[1]) + qu0t * dqt) + (r[2] + s_sums[2]) + dqt * dqt));
    const float vn = sqrtf(max0(vn0 * vn0 + 2.0f * ((r[3] + s_sums[3]) + rho_tau * kap0 * dvont) +
                                (r[4] + s_sums[4]) + dvont * dvont));
    return sqrtf(max0(d2)) / ((1.0f + qn) + vn);
  };

  int t = 0;
  float err = sc[C_QINIT];
  while (t < t_max && err >= thresh) {  // the same decision in every CTA
    for (int it = 0; it < probe; ++it) step();
    t += probe;
    err = err_delta();
  }

  for (int j = tid; j < ncol; j += kThreads) {
    a.out[O_DX][b * n + c0 + j] = s_dx[j];
    a.out[O_DVX][b * n + c0 + j] = s_dvx[j];
  }
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) {
      a.out[O_DY][b * m + i] = s_dy[i];
      a.out[O_DVY][b * m + i] = s_dvy[i];
    }
    if (tid == 0) {
      float* row = a.out[O_ROW] + b * kRowWidth;
      row[0] = dtau; row[1] = dkap; row[2] = err; row[3] = (float)t;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster_ops::sync();
}

// the kernel of (resident, spill)
inline void (*kernel_of(int resident, int spill))(Args) {
  switch (cluster_ops::form_of(resident, spill)) {
    case cluster_ops::kResident: return conic_delta_cluster_kernel<cluster_ops::kResident>;
    case cluster_ops::kStreaming: return conic_delta_cluster_kernel<cluster_ops::kStreaming>;
    default: return conic_delta_cluster_kernel<cluster_ops::kSpilled>;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for shape (m, n) with nb cone blocks in
// clusters of C CTAs, A's slice and the operands resident or not.
long long abip_conic_delta_smem_bytes(int m, int n, int nb, int C, int resident, int woodbury,
                                      int spill) {
  if (spill) return 0;
  return smem_floats(m, n, nb, cols_per_cta(n, C), resident != 0, woodbury != 0) *
         (long long)sizeof(float);
}

// Floats of global workspace per CTA the streaming or spilled form needs.
long long abip_conic_delta_work_floats(int m, int n, int nb, int woodbury, int C, int spill) {
  return work_floats(m, n, nb, cols_per_cta(n, C), woodbury != 0, spill != 0);
}

int abip_row_width() { return kRowWidth; }

int abip_conic_delta_threads() { return kThreads; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How many clusters of C CTAs of this shape and residency the card holds at
// once (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA
// error.
int abip_conic_delta_max_active_clusters(int m, int n, int nb, int C, int resident, int woodbury,
                                         int spill, int* clusters) {
  const int smem = (int)abip_conic_delta_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::max_active<kThreads>(kernel_of(resident, spill), C, smem, clusters);
}

// Launches one chunk over B lanes, one cluster of C CTAs per lane, on
// `stream`; returns the CUDA error code.  in: the 23 f32 ConicDeltaAnchor
// operands, t_max (int32, B), then the int32 cone rows code, blk (n) and
// start, length, soc (nb); out: dy, dx, dvy, dvx, row.  All contiguous,
// lane-major.  work: B * C * abip_conic_delta_work_floats(...) floats,
// 16-byte aligned, for the streaming and spilled forms (unused when
// resident).
int abip_conic_delta(void* const* in, void* const* out, void* work, int B, int m, int n, int nb,
                     int probe, int woodbury, int C, int resident, int spill, void* stream) {
  if (C < 1 || C > cluster_ops::kMaxCluster || (!resident && work == nullptr))
    return (int)cudaErrorInvalidValue;
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
  a.work = static_cast<float*>(work);
  a.m = m;
  a.n = n;
  a.nc = cols_per_cta(n, C);
  a.mr = (m + C - 1) / C;
  a.probe = probe;
  a.woodbury = woodbury;
  spill = spill != 0 && !resident;
  a.wfl = work_floats(m, n, nb, a.nc, woodbury != 0, spill != 0);
  const int smem = (int)abip_conic_delta_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::launch<kThreads>(kernel_of(resident, spill), a, B, C, smem, stream);
}

}  // extern "C"
