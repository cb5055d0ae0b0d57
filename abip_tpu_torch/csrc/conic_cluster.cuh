// What the conic cluster kernels share (csrc/conic_delta.cu, K3;
// csrc/conic_ladder.cu, K2; csrc/conic_sprint.cu, K4): the column dots and
// row dots over a CTA's column slice, the cone-block search, and one lane's
// f32 conic Douglas-Rachford iteration with its inner criterion and error
// ratio as a thread-block cluster (`ClusterDrLane`, the iteration of
// `ops/conic_dr.py:_make_dr_fns`).
//
// Layout (K3's).  Lane b is cluster b of C CTAs of kThreads threads.  CTA r
// owns the columns [r nc, (r+1) nc) (nc a multiple of 4) and the x-side
// state of those columns (x, vx, t, zx); the m-side state (y, vy, wy, A t,
// zy) is replicated in every CTA, which all compute it alike.  Resident
// (cluster_ops::kResident), each CTA holds A's column slice (rows at a
// stride of 4 mod 8 floats), its slices of hinv, rx, qd, c, E and the
// m-side operands ry, b, D in shared memory for the whole launch; streaming,
// they are read through L2 and the m-side state lies in a global workspace;
// spilled, the streaming form's shared-memory layout lies in that workspace
// too (the other CTAs read it from L2), so that every shape runs.  G^-1 (or
// S^-1, direct form) stays in L2; each CTA applies its rows of it.
//
// Exchanges (a cluster barrier, then reads of the other CTAs' copies, each
// sum in rank order: every CTA holds the same bits and takes the same stop
// and barrier decisions; a CTA that decided otherwise would hang the next
// barrier), per Woodbury iteration:
//   1. A t, t = H^-1 (wx + A' wy / rho_y): a partial m-vector per CTA;
//   2. u = G^-1 (A t): each CTA computes its rows, the others read them;
//   3. A zx, the x-side sums of the tau quadratic (<rx,wx>, <rx,zx>,
//      <zx,Qd zx>) and the body sums and head values of the cone blocks
//      that straddle CTAs.
// The direct form gathers the rhs and makes exchange 3.  A probe makes one
// exchange: A x (and A (x / tau) for the error ratio) with the x-side sums
// of the inner criterion (and the x-side maxes and sums of the ratio).
//
// Straddling blocks.  A block's body sum of squares of the prox argument
// t_j = d0_j - c rx_j (c = alpha tau_t, d0 = alpha zx + (1-alpha) x - vx) is
// needed after tau_t, which exchange 3 gives.  About a shift s known before
// it (alpha times the previous iteration's tau_t; alpha tau at a launch's
// first), with e_j = d0_j - s rx_j and d = c - s,
//   sum t^2 = P0 - 2 d P1 + d^2 P2,  P0 = sum e^2, P1 = sum e rx,
//   P2 = sum rx^2 (once per launch),
// so P0 and P1 ride exchange 3.  tau_t moves little from one iteration to
// the next, so e is close to t and the correction small: the sum is as
// exact as the direct one (`tests/test_torch_cluster_sums.py`; K3's
// unshifted form, s = 0, lands several times further from an f64 run on
// the absolute iterate).  Every CTA holding a part of such a block runs the
// block's prox on the same bits.  Non-straddling blocks sum t^2 directly.
//
// Numerics: plain IEEE f32 `sqrtf` and `/`, and `isnan` (conic_common.cuh):
// build without -use_fast_math.

#pragma once

#include "cluster_common.cuh"
#include "conic_common.cuh"

namespace conic_cluster {

using cluster_ops::al4;

// 384 threads a CTA, so that a thread may hold 168 registers (512 would cap
// it at 128, and the iteration's state spills there)
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;  // threads a column dot is split over

// Row stride of a resident A slice of nc columns: 4 mod 8 floats, so that
// the eight threads of a quarter warp that read one float4 each of eight
// consecutive rows hit eight distinct groups of four banks.
__host__ __device__ inline int res_lda(int nc) { return nc % 8 == 4 ? nc : nc + 4; }

// the first block k of [0, nb) whose end (start + length) exceeds `col`
__device__ __forceinline__ int first_block_ending_after(const conic::Cones& cn, int col) {
  int lo = 0, hi = cn.nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (cn.start[mid] + cn.length[mid] > col) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// the first block k of [0, nb) that starts at or after `col`
__device__ __forceinline__ int first_block_from(const conic::Cones& cn, int col) {
  int lo = 0, hi = cn.nb;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (cn.start[mid] >= col) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// sum_i M[i, j] y[i] over the rows [i0, i1), four partial sums in flight;
// i0 a multiple of 4 and y 16-byte aligned, so that four of y's values
// come in one (broadcast) load
__device__ __forceinline__ float col_dot_range(const float* M, int ld, const float* y, int i0,
                                               int i1, int j) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int i = i0;
  for (; i + 4 <= i1; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(y + i);
    acc[0] += M[(size_t)i * ld + j] * v.x;
    acc[1] += M[(size_t)(i + 1) * ld + j] * v.y;
    acc[2] += M[(size_t)(i + 2) * ld + j] * v.z;
    acc[3] += M[(size_t)(i + 3) * ld + j] * v.w;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (i + k < i1) acc[k] += M[(size_t)(i + k) * ld + j] * y[i + k];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// The column dots sum_i M[i, j] y[i] (i < rows) of this CTA's ncol columns,
// each split over S threads that sum contiguous row ranges into `part`;
// returns S.  After the call's barrier, `col_total` adds a column's S
// partials in range order.
__device__ __forceinline__ int split_col_dots(const float* M, int ld, const float* y, int rows,
                                              int ncol, float* part) {
  const int S = ncol > 0 ? max(1, min(kMaxSplit, kThreads / ncol)) : 1;
  const int per = ((rows + S - 1) / S + 3) / 4 * 4;  // a multiple of 4
  for (int t = threadIdx.x; t < S * ncol; t += kThreads) {
    const int q = t / ncol, j = t - q * ncol;
    part[t] = col_dot_range(M, ld, y, min(rows, q * per), min(rows, (q + 1) * per), j);
  }
  __syncthreads();
  return S;
}

__device__ __forceinline__ float col_total(const float* part, int S, int ncol, int j) {
  float s = part[j];
  for (int q = 1; q < S; ++q) s += part[q * ncol + j];
  return s;
}

__device__ __forceinline__ float hsum(float4 a) { return (a.x + a.y) + (a.z + a.w); }

// out0[i] = sum_j M[i, j] w0[j] (and out1 with w1 where kTwo) for the rows
// i < rows, j < len: one thread a row, four accumulators of float4 products
// (M, w0, w1 16-byte aligned, ld and len multiples of 4; see res_lda for
// ld).  A resident slice's row dots.
template <bool kTwo>
__device__ __forceinline__ void thread_rows_dot(const float* M, int ld, const float* w0,
                                                const float* w1, int len, int rows, float* out0,
                                                float* out1) {
  const float4* u4 = reinterpret_cast<const float4*>(w0);
  const float4* v4 = reinterpret_cast<const float4*>(kTwo ? w1 : w0);
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const float4* row = reinterpret_cast<const float4*>(M + (size_t)i * ld);
    float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll 4
    for (int k = 0; k < len / 4; ++k) {
      const float4 a = row[k], u = u4[k];
      a0.x += a.x * u.x;
      a0.y += a.y * u.y;
      a0.z += a.z * u.z;
      a0.w += a.w * u.w;
      if (kTwo) {
        const float4 v = v4[k];
        a1.x += a.x * v.x;
        a1.y += a.y * v.y;
        a1.z += a.z * v.z;
        a1.w += a.w * v.w;
      }
    }
    out0[i] = hsum(a0);
    if (kTwo) out1[i] = hsum(a1);
  }
}

// Block-wide max of each v[k] (NaN-propagating, so its bits do not depend
// on the order); every thread gets the result.  `red` as block_sum's.
template <int K>
__device__ __forceinline__ void block_max(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = conic::warp_max(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = red[k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = conic::nan_max(s, red[w * K + k]);
    v[k] = s;
  }
}

// ---------------------------------------------------------------------------
// one lane's conic DR iteration as a cluster (K2, K4)
// ---------------------------------------------------------------------------

constexpr int kRed = 8;      // reduction scratch per warp
constexpr int kSlot = 28;    // one exchange slot: 8 sums, 2 maxes (4 floats), two block entries
constexpr int kSlotMax = 8;  // the probe's two maxes
constexpr int kSlotL = 12;   // the block that holds this CTA's first column
constexpr int kSlotR = 20;   // the block that holds its last column
constexpr int kSums = 12;    // an exchange's sums and maxes, as read
constexpr int kXBuf = 2;     // partial m-vectors an exchange carries (A x, A x/tau)
constexpr int kMVecs = 5;    // y, vy, wy, A t, zy (u, read by the others, apart)
constexpr int kXState = 4;   // x, vx, t, zx
constexpr int kXOps = 5;     // hinv, rx, qd, c, E: the x-side operand slices
constexpr int kMOps = 3;     // ry, b, D: the m-side operands
// per block that touches this CTA: head values, body scale, P2
enum { V_BH1, V_BH2, V_BSC, V_P2, V_COUNT };
// an exchanged block entry: P0, P1, then (zx, x, vx) of each head
enum { X_P0, X_P1, X_H1, X_H2 = X_H1 + 3, X_COUNT = X_H2 + 3 };
static_assert(kSlotL + X_COUNT <= kSlotR && kSlotR + X_COUNT <= kSlot, "slot layout");

// Shared memory of one CTA, in floats, every array 16-byte padded: the
// reduction scratch, two exchange slots and the sums read, two exchange
// buffers of kXBuf partial m-vectors, u, the x-side state, the direct
// form's whole rhs, the block values (at most min(nb, nc) blocks touch nc
// columns), the split column dots' partials; resident, the m-side state,
// A's slice, the x-side and m-side operands.
__host__ __device__ inline long long dr_smem_floats(int m, int n, int nb, int nc, bool res,
                                                    bool woodbury) {
  const long long mp = al4(m);
  const long long nbl = nb < nc ? nb : nc;
  long long f = (long long)kWarps * kRed + 2LL * kSlot + kSums + 2LL * kXBuf * mp + mp +
                (long long)kXState * nc + (woodbury ? 0 : al4(n)) + al4(V_COUNT * nbl) +
                (nc > kThreads ? nc : kThreads);
  if (res) f += (kMVecs + kMOps) * mp + (long long)m * res_lda(nc) + (long long)kXOps * nc;
  return f;
}

// Global workspace of one CTA of the streaming form, in floats: the m-side
// state, and in the spilled form the shared-memory layout after it.
__host__ __device__ inline long long dr_work_floats(int m, int n, int nb, int nc, bool woodbury,
                                                    bool spill) {
  return kMVecs * al4(m) + (spill ? al4(dr_smem_floats(m, n, nb, nc, false, woodbury)) : 0);
}

// lane b's operand rows (D and E only for the ladder's error ratio)
struct DrRows {
  const float *A, *Minv, *hinv, *ry, *rx, *b, *c, *qd, *D, *E;
};

// the launch geometry every CTA of a lane shares
struct DrShape {
  float* work;    // streaming and spilled forms: wfl floats per CTA
  long long wfl;
  int m, n, nc, mr, woodbury;
  conic::Cones cones;
};

// Dynamic shared memory of one CTA of a launch, in bytes (0 spilled).
inline long long dr_smem_bytes(int m, int n, int nb, int C, int resident, int woodbury,
                               int spill) {
  if (spill) return 0;
  return dr_smem_floats(m, n, nb, cluster_ops::cols_per_cta(n, C), resident != 0,
                        woodbury != 0) *
         (long long)sizeof(float);
}

// The launch geometry of a C entry: the int32 cone rows code, blk, start,
// length, soc at `cones`, the column split over C CTAs and the workspace
// stride (the streaming and spilled forms).
inline DrShape dr_shape(void* const* cones, void* work, int m, int n, int nb, int C,
                        int woodbury, bool spill) {
  DrShape sh;
  sh.cones.code = static_cast<const int*>(cones[0]);
  sh.cones.blk = static_cast<const int*>(cones[1]);
  sh.cones.start = static_cast<const int*>(cones[2]);
  sh.cones.length = static_cast<const int*>(cones[3]);
  sh.cones.soc = static_cast<const int*>(cones[4]);
  sh.cones.nb = nb;
  sh.work = static_cast<float*>(work);
  sh.m = m;
  sh.n = n;
  sh.nc = cluster_ops::cols_per_cta(n, C);
  sh.mr = (m + C - 1) / C;
  sh.woodbury = woodbury;
  sh.wfl = dr_work_floats(m, n, nb, sh.nc, woodbury != 0, spill);
  return sh;
}

// the error ratio's scalars (`calc_qcp_residuals`)
struct RatioScal {
  float sc_b, sc_c, nm_b, nm_c, eps;
};

template <int kForm>
struct ClusterDrLane {
  static constexpr bool kRes = kForm == cluster_ops::kResident;
  static constexpr bool kSpill = kForm == cluster_ops::kSpilled;

  int C, rank, m, n, nc, mr, ncol, c0, i0, nrow, mp, nbl, k_lo, k_hi, lda, alen, e;
  long long peer;
  bool woodbury;
  float *red, *slots, *s_sums, *xbuf, *s_u, *s_x, *s_vx, *s_t, *s_zx, *s_rhs, *s_blk, *s_part;
  float *s_y, *s_vy, *s_wy, *s_at, *s_zy;
  const float *Ab, *gM, *hinv, *rx, *qd, *cv, *Ev, *ry, *bv, *Dv, *rx_row;
  const int *code, *blk;
  conic::Cones cn;
  float rho_y, rho_x, rho_tau, a_coef, alpha, k0, inv_ry, oma;
  float tau, kappa, shift;

  __device__ float& bval(int v, int kl) { return s_blk[v * nbl + kl]; }

  // Carve this CTA's layout, load its operands (resident) and lane b's
  // iterate: y, vy in every CTA, x, vx of its columns.  Ends with a barrier.
  __device__ void init(float* smem, const DrShape& sh, const DrRows& op, const float* y,
                       const float* x, const float* vy, const float* vx, float tau0,
                       float kappa0) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    C = (int)cluster.num_blocks();
    rank = (int)cluster.block_rank();
    m = sh.m;
    n = sh.n;
    nc = sh.nc;
    mr = sh.mr;
    woodbury = sh.woodbury != 0;
    cn = sh.cones;
    c0 = rank * nc;
    ncol = max(0, min(nc, n - c0));
    i0 = rank * mr;
    nrow = max(0, min(mr, m - i0));
    mp = (int)al4(m);
    nbl = min(cn.nb, nc);
    k_lo = ncol > 0 ? first_block_ending_after(cn, c0) : 0;
    k_hi = ncol > 0 ? first_block_from(cn, c0 + ncol) : 0;
    e = 0;
    float* ws = kRes ? nullptr : sh.work + (size_t)blockIdx.x * sh.wfl;
    peer = kSpill ? sh.wfl : 0;
    float* base = kSpill ? ws + kMVecs * mp : smem;
    red = base;
    slots = red + kWarps * kRed;
    s_sums = slots + 2 * kSlot;
    xbuf = s_sums + kSums;
    s_u = xbuf + 2 * kXBuf * mp;
    s_x = s_u + mp;
    s_vx = s_x + nc;
    s_t = s_vx + nc;
    s_zx = s_t + nc;
    s_rhs = s_zx + nc;
    s_blk = s_rhs + (woodbury ? 0 : al4(n));
    s_part = s_blk + al4(V_COUNT * nbl);
    float* s_mv = s_part + max(nc, kThreads);
    float* s_A = s_mv + (kRes ? kMVecs * mp : 0);
    float* s_xo = s_A + (kRes ? (size_t)m * res_lda(nc) : 0);
    float* s_mo = s_xo + (kRes ? (size_t)kXOps * nc : 0);
    float* mv = kRes ? s_mv : ws;
    s_y = mv;
    s_vy = mv + mp;
    s_wy = mv + 2 * mp;
    s_at = mv + 3 * mp;
    s_zy = mv + 4 * mp;

    const float* xrow[kXOps] = {op.hinv, op.rx, op.qd, op.c, op.E};
    const float* mrow[kMOps] = {op.ry, op.b, op.D};
    if (kRes) {  // the launch's one load of this CTA's operands
      cluster_ops::load_slice<kThreads>(s_A, res_lda(nc), op.A + c0, n, m, ncol);
#pragma unroll
      for (int k = 0; k < kXOps; ++k)
        if (xrow[k]) cluster_ops::load_slice<kThreads>(s_xo + (size_t)k * nc, nc, xrow[k] + c0, 0, 1, ncol);
#pragma unroll
      for (int k = 0; k < kMOps; ++k)
        if (mrow[k]) cluster_ops::load_slice<kThreads>(s_mo + (size_t)k * mp, mp, mrow[k], 0, 1, m);
    }
    cluster_ops::cp_async_commit();
    Ab = kRes ? s_A : op.A + c0;
    lda = kRes ? res_lda(nc) : n;
    alen = kRes ? nc : ncol;
    gM = op.Minv;
    hinv = kRes ? s_xo : op.hinv + c0;
    rx = kRes ? s_xo + nc : op.rx + c0;
    qd = kRes ? s_xo + 2 * nc : op.qd + c0;
    cv = kRes ? s_xo + 3 * nc : op.c + c0;
    Ev = op.E ? (kRes ? s_xo + 4 * nc : op.E + c0) : nullptr;
    ry = kRes ? s_mo : op.ry;
    bv = kRes ? s_mo + mp : op.b;
    Dv = op.D ? (kRes ? s_mo + 2 * mp : op.D) : nullptr;
    rx_row = op.rx;
    code = cn.code + c0;
    blk = cn.blk + c0;
    inv_ry = 1.0f / rho_y;
    oma = 1.0f - alpha;
    tau = tau0;
    kappa = kappa0;
    shift = alpha * tau0;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < kMVecs * mp; i += kThreads) mv[i] = 0.f;  // pads stay 0
    for (int i = tid; i < mp; i += kThreads) s_u[i] = 0.f;
    for (int i = tid; i < 2 * kXBuf * mp; i += kThreads) xbuf[i] = 0.f;
    for (int j = tid; j < kXState * nc; j += kThreads) s_x[j] = 0.f;
    __syncthreads();
    for (int i = tid; i < m; i += kThreads) {
      s_y[i] = y[i];
      s_vy[i] = vy[i];
    }
    for (int j = tid; j < ncol; j += kThreads) {
      s_x[j] = x[c0 + j];
      s_vx[j] = vx[c0 + j];
    }
    // P2 of the blocks that touch this CTA, over the whole block body
    for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
      const int k = k_lo + kl;
      const int st = cn.start[k], len = cn.length[k];
      const float* r = rx_row;
      const float p2 = conic::body_sum(st, len, cn.soc[k] ? 1 : 2, lane, [r](int g) {
        const float v = __ldg(r + g);
        return v * v;
      });
      if (lane == 0) bval(V_P2, kl) = p2;
    }
    cluster_ops::cp_async_wait();
    __syncthreads();
  }

  // A's row dots over this CTA's columns into out0 (and out1): resident,
  // one thread a row; else one warp a row, coalesced through L2.
  template <bool kTwo>
  __device__ void a_rows(const float* w0, const float* w1, float* out0, float* out1) {
    if (kRes)
      thread_rows_dot<kTwo>(Ab, lda, w0, w1, alen, m, out0, out1);
    else
      cluster_ops::rows_dot<kTwo, false, kThreads>(Ab, lda, w0, w1, alen, m, out0, out1);
  }

  // the prox argument of element g from its (zx, x, vx), as the element
  // pass forms it
  __device__ float prox_arg(float zx, float x, float vx, float tau_t, int g) const {
    return (alpha * (zx - tau_t * __ldg(rx_row + g)) + oma * x) - vx;
  }

  // One conic DR iteration at barrier `lam`; `i` is the launch-local index.
  __device__ void step(float lam, int i) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float lam_x = lam / rho_x, lam_tau = lam / rho_tau;
    // p: <ry,wy> (every row, alike in every CTA), then this CTA's columns'
    // <rx,wx>, <rx,zx>, <zx,Qd zx>
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < m; k += kThreads) {
      const float w = rho_y * (s_y[k] + s_vy[k]);
      s_wy[k] = w;
      p[0] += ry[k] * w;
    }
    __syncthreads();
    int S = split_col_dots(Ab, lda, s_wy, m, ncol, s_part);
    for (int j = tid; j < ncol; j += kThreads) {  // rhs = wx + A'(wy / rho_y)
      const float wx = rho_x * (s_x[j] + s_vx[j]);
      p[1] += rx[j] * wx;
      const float r = wx + inv_ry * col_total(s_part, S, ncol, j);
      s_t[j] = woodbury ? hinv[j] * r : r;
    }
    __syncthreads();
    if (woodbury) {
      // exchange 1: A t over the cluster's columns
      float* part = xbuf + e * kXBuf * mp;
      a_rows<false>(s_t, nullptr, part, nullptr);
      cluster_ops::sync();
      for (int i4 = tid; i4 < mp / 4; i4 += kThreads)
        reinterpret_cast<float4*>(s_at)[i4] = cluster_ops::rank_sum4(part, i4, C, peer);
      __syncthreads();
      e ^= 1;
      // exchange 2: this CTA's rows of u = G^-1 (A t), read by the others
      if (kRes && (m & 3) == 0)
        cluster_ops::rows_dot<false, true, kThreads>(gM + (size_t)i0 * m, m, s_at, nullptr, m,
                                                     nrow, s_u + i0, nullptr);
      else
        cluster_ops::rows_dot<false, false, kThreads>(gM + (size_t)i0 * m, m, s_at, nullptr, m,
                                                      nrow, s_u + i0, nullptr);
      cluster_ops::sync();
      for (int k = tid; k < m; k += kThreads)
        if (k / mr != rank) s_u[k] = cluster_ops::rank_read(s_u, k, k / mr, peer);
    } else {
      // the whole rhs, gathered from the cluster's slices
      cluster_ops::sync();
      for (int k = tid; k < n; k += kThreads)
        s_rhs[k] = cluster_ops::rank_read(s_t, k % nc, k / nc, peer);
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
      p[3] += z * qd[j] * z;
    }
    __syncthreads();
    // exchange 3: A zx, the x-side sums, the straddling blocks' P0, P1 and
    // head values
    float* part = xbuf + e * kXBuf * mp;
    float* slot = slots + e * kSlot;
    a_rows<false>(s_zx, nullptr, part, nullptr);
    const float sft = shift;
    for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
      const int k = k_lo + kl;
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      if (st / nc == (st + len - 1) / nc) continue;  // within this CTA
      const int lo = max(st + (is_soc ? 1 : 2), c0), hi = min(st + len, c0 + ncol);
      float q0 = 0.f, q1 = 0.f;
      for (int g = lo + lane; g < hi; g += 32) {
        const int j = g - c0;
        const float d = ((alpha * s_zx[j] + oma * s_x[j]) - s_vx[j]) - sft * rx[j];
        q0 += d * d;
        q1 += d * rx[j];
      }
      q0 = conic::warp_sum(q0);
      q1 = conic::warp_sum(q1);
      if (lane == 0) {
        float ent[X_COUNT] = {q0, q1, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jh = st + h - c0;
          if ((h == 0 || !is_soc) && jh >= 0 && jh < ncol) {
            ent[X_H1 + 3 * h] = s_zx[jh];
            ent[X_H1 + 3 * h + 1] = s_x[jh];
            ent[X_H1 + 3 * h + 2] = s_vx[jh];
          }
        }
#pragma unroll
        for (int q = 0; q < X_COUNT; ++q) {
          if (st <= c0) slot[kSlotL + q] = ent[q];
          if (st + len >= c0 + ncol) slot[kSlotR + q] = ent[q];
        }
      }
    }
    cluster_ops::block_sum<kThreads>(p, red);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) slot[k] = p[k + 1];
    }
    cluster_ops::sync();
    for (int i4 = tid; i4 < mp / 4 + 1; i4 += kThreads) {
      if (i4 == mp / 4) {
        reinterpret_cast<float4*>(s_sums)[0] = cluster_ops::rank_sum4(slot, 0, C, peer);
        continue;
      }
      const float4 az = cluster_ops::rank_sum4(part, i4, C, peer);  // zy = (wy - A zx) / rho_y
      const float a4[4] = {az.x, az.y, az.z, az.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * i4 + q;
        if (k < m) s_zy[k] = inv_ry * (s_wy[k] - a4[q]);
      }
    }
    __syncthreads();
    // <ry, zy>, by every warp alike
    float p2 = 0.f;
    for (int k = lane; k < m; k += 32) p2 += ry[k] * s_zy[k];
    p2 = conic::warp_sum(p2);
    const float eta = rho_tau * (tau + kappa);
    const float b_coef = ((p[0] + s_sums[0]) - 2.0f * (rho_y * p2 + rho_x * s_sums[1])) - eta;
    const float c_coef = -s_sums[2];
    const float disc = conic::max0(b_coef * b_coef - 4.0f * a_coef * c_coef);
    float tau_t = (-b_coef + sqrtf(disc)) / (2.0f * a_coef);
    if (!(k0 + (float)i > 0.f)) tau_t = 1.0f;  // the first-ever iteration
    for (int k = tid; k < m; k += kThreads) {  // free-cone head + dual
      const float rel = alpha * (s_zy[k] - tau_t * ry[k]) + oma * s_y[k];
      const float yn = rel - s_vy[k];
      s_vy[k] = (s_vy[k] + yn) - rel;
      s_y[k] = yn;
    }
    for (int j = tid; j < ncol; j += kThreads) {
      const float rel = alpha * (s_zx[j] - tau_t * rx[j]) + oma * s_x[j];
      s_t[j] = rel - s_vx[j];
      s_zx[j] = rel;
    }
    const float rel_tau = alpha * tau_t + oma * tau;
    const float c = alpha * tau_t;
    __syncthreads();
    // the cone blocks: a straddling one from the exchanged P0, P1 and head
    // values (one round of remote loads, the same butterfly sum in every
    // CTA), the others from this CTA's t
    for (int kl = warp; kl < k_hi - k_lo; kl += kWarps) {
      const int k = k_lo + kl;
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const int r_lo = st / nc, r_hi = (st + len - 1) / nc;
      float a, s2 = 0.f, bsq;
      if (r_lo != r_hi) {
        const float* sl = slots + e * kSlot;
        float q0 = 0.f, q1 = 0.f, hv = 0.f;
        if (lane <= r_hi - r_lo) {
          const int o = (lane == 0) ? kSlotR : kSlotL;
          q0 = cluster_ops::rank_read(sl, o + X_P0, r_lo + lane, peer);
          q1 = cluster_ops::rank_read(sl, o + X_P1, r_lo + lane, peer);
        }
        const int r2 = (st + 1) / nc;
        if (lane < 3)
          hv = cluster_ops::rank_read(sl, kSlotR + X_H1 + lane, r_lo, peer);
        else if (lane < 6 && !is_soc)
          hv = cluster_ops::rank_read(sl, ((r2 == r_lo) ? kSlotR : kSlotL) + X_H2 + lane - 3, r2,
                                      peer);
        const float P0 = conic::warp_sum(q0), P1 = conic::warp_sum(q1);
        float h[6];
#pragma unroll
        for (int q = 0; q < 6; ++q) h[q] = __shfl_sync(0xffffffffu, hv, q);
        a = prox_arg(h[0], h[1], h[2], tau_t, st);
        if (!is_soc) s2 = prox_arg(h[3], h[4], h[5], tau_t, st + 1);
        const float d = c - sft;
        bsq = (P0 - 2.0f * d * P1) + d * d * bval(V_P2, kl);
      } else {
        const float* t = s_t - c0;
        bsq = conic::body_sum(st, len, is_soc ? 1 : 2, lane, [t](int g) {
          const float v = t[g];
          return v * v;
        });
        a = s_t[st - c0];
        if (!is_soc) s2 = s_t[st + 1 - c0];
      }
      if (lane == 0) {
        if (is_soc) {
          conic::soc_rows(a, bsq, lam_x, &bval(V_BH1, kl), &bval(V_BSC, kl));
          bval(V_BH2, kl) = 0.f;
        } else {
          conic::rsoc_rows(a, s2, bsq, lam_x, &bval(V_BH1, kl), &bval(V_BH2, kl),
                           &bval(V_BSC, kl));
        }
      }
    }
    e ^= 1;
    shift = c;
    __syncthreads();
    for (int j = tid; j < ncol; j += kThreads) {
      const float xn = conic::cone_prox_elem(code[j], blk[j] - k_lo, s_t[j], lam_x,
                                             s_blk + V_BH1 * nbl, s_blk + V_BH2 * nbl,
                                             s_blk + V_BSC * nbl);
      s_vx[j] = (s_vx[j] + xn) - s_zx[j];
      s_x[j] = xn;
    }
    const float tau_n = conic::prox_nn(rel_tau - kappa, lam_tau);
    kappa = (kappa + tau_n) - rel_tau;
    tau = tau_n;
    __syncthreads();
  }

  // The probe, through one exchange: the f32 inner criterion
  // (`qcp_inner_conv_check`) and, where kRatio, the error ratio max(res /
  // eps) of `calc_qcp_residuals` into *ratio.
  template <bool kRatio>
  __device__ float probe(const RatioScal& rs, float* ratio) {
    const int tid = threadIdx.x;
    const float tau_s = conic::nan_max(fabsf(tau), 1e-18f);
    float* part = xbuf + e * kXBuf * mp;
    float* slot = slots + e * kSlot;
    if (kRatio) {  // ys = y / tau in wy, xs = x / tau in t
      for (int k = tid; k < m; k += kThreads) s_wy[k] = s_y[k] / tau_s;
      for (int j = tid; j < ncol; j += kThreads) s_t[j] = s_x[j] / tau_s;
      __syncthreads();
    }
    a_rows<kRatio>(s_x, s_t, part, part + mp);  // A x (and A xs)
    // q: <x,Mu_x>, <x,c>, |Qu_x - von_x|^2, |Qu_x|^2, |von_x|^2, then the
    //    ratio's <xs,Qxs>, <c,xs>;  mx: |E dres|, |E Qxs|
    float q[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float mx[2] = {0.f, 0.f};
    int S = split_col_dots(Ab, lda, s_y, m, ncol, s_part);
    for (int j = tid; j < ncol; j += kThreads) {  // Mu_x = Qd x - A'y
      const float x = s_x[j];
      const float mu_x = qd[j] * x - col_total(s_part, S, ncol, j);
      const float qu = mu_x + cv[j] * tau;
      const float von = rho_x * s_vx[j];
      q[0] += x * mu_x;
      q[1] += x * cv[j];
      q[2] += (qu - von) * (qu - von);
      q[3] += qu * qu;
      q[4] += von * von;
    }
    if (kRatio) {
      __syncthreads();
      S = split_col_dots(Ab, lda, s_wy, m, ncol, s_part);
      for (int j = tid; j < ncol; j += kThreads) {
        const float xs = s_t[j];
        const float qx = qd[j] * xs;
        const float ss = rho_x * s_vx[j] / tau_s;
        const float dres = ((qx - col_total(s_part, S, ncol, j)) + cv[j]) - ss;
        mx[0] = conic::nan_max(mx[0], fabsf(Ev[j] * dres));
        mx[1] = conic::nan_max(mx[1], fabsf(Ev[j] * qx));
        q[5] += xs * qx;
        q[6] += cv[j] * xs;
      }
    }
    cluster_ops::block_sum<kThreads>(q, red);
    __syncthreads();
    if (kRatio) block_max(mx, red);
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 7; ++k) slot[k] = q[k];
      slot[kSlotMax] = mx[0];
      slot[kSlotMax + 1] = mx[1];
    }
    cluster_ops::sync();
    // the y side, in every CTA: <y,Mu_y>, <y,b>, |Qu_y - von_y|^2, |Qu_y|^2,
    // |von_y|^2, the ratio's <b,ys>;  my: |D (A xs - b)|, |D A xs|
    float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float my[2] = {0.f, 0.f};
    for (int i4 = tid; i4 < mp / 4 + 2; i4 += kThreads) {
      if (i4 >= mp / 4) {
        const int k = i4 - mp / 4;
        reinterpret_cast<float4*>(s_sums)[k] = cluster_ops::rank_sum4(slot, k, C, peer);
        continue;
      }
      const float4 ax = cluster_ops::rank_sum4(part, i4, C, peer);
      const float a4[4] = {ax.x, ax.y, ax.z, ax.w};
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      if (kRatio) {
        const float4 as = cluster_ops::rank_sum4(part + mp, i4, C, peer);
        s4[0] = as.x;
        s4[1] = as.y;
        s4[2] = as.z;
        s4[3] = as.w;
      }
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int k = 4 * i4 + w;
        if (k >= m) break;
        const float y = s_y[k];
        const float qu = a4[w] - bv[k] * tau;
        const float von = rho_y * s_vy[k];
        r[0] += y * a4[w];
        r[1] += y * bv[k];
        r[2] += (qu - von) * (qu - von);
        r[3] += qu * qu;
        r[4] += von * von;
        if (kRatio) {
          r[5] += bv[k] * s_wy[k];
          my[0] = conic::nan_max(my[0], fabsf(Dv[k] * (s4[w] - bv[k])));
          my[1] = conic::nan_max(my[1], fabsf(Dv[k] * s4[w]));
        }
      }
    }
    if (kRatio && tid == kThreads - 1) {  // the cluster's maxes
      float m0 = 0.f, m1 = 0.f;
      for (int q2 = 0; q2 < C; ++q2) {
        m0 = conic::nan_max(m0, cluster_ops::rank_read(slot, kSlotMax, q2, peer));
        m1 = conic::nan_max(m1, cluster_ops::rank_read(slot, kSlotMax + 1, q2, peer));
      }
      s_sums[kSlotMax] = m0;
      s_sums[kSlotMax + 1] = m1;
    }
    e ^= 1;
    cluster_ops::block_sum<kThreads>(r, red);  // its barrier also publishes s_sums
    __syncthreads();
    if (kRatio) block_max(my, red);
    const float* sx = s_sums;  // the x side's sums and maxes over the cluster
    const float tau_safe = (fabsf(tau) < conic::kEpsTau) ? conic::kEpsTau : tau;
    const float qu_tau = (-(r[0] + sx[0]) / tau_safe + r[1]) - sx[1];
    const float von_tau = rho_tau * kappa;
    const float d2 = (r[2] + sx[2]) + (qu_tau - von_tau) * (qu_tau - von_tau);
    const float qn = sqrtf((r[3] + sx[3]) + qu_tau * qu_tau);
    const float vn = sqrtf((r[4] + sx[4]) + von_tau * von_tau);
    if (kRatio) {  // the x side's maxes over the cluster are in sx[kSlotMax:]
      const float res_pri = my[0] / (rs.sc_b + conic::nan_max(my[1], rs.sc_b * rs.nm_b));
      const float res_dual =
          sx[kSlotMax] / (rs.sc_c + conic::nan_max(rs.sc_c * rs.nm_c, sx[kSlotMax + 1]));
      const float inv_bc = 1.0f / (rs.sc_b * rs.sc_c);
      const float xqx_2 = 0.5f * sx[5] * inv_bc;
      const float ctx = sx[6] * inv_bc, bty = r[5] * inv_bc;
      const float rel_gap = fabsf((2.0f * xqx_2 + ctx) - bty) /
                            (1.0f + conic::nan_max(2.0f * xqx_2,
                                                   conic::nan_max(fabsf(ctx), fabsf(bty))));
      *ratio = conic::nan_max(res_pri, conic::nan_max(res_dual, rel_gap)) / rs.eps;
    }
    __syncthreads();  // red and s_sums are rewritten by the next step
    return sqrtf(d2) / ((1.0f + qn) + vn);
  }

  // Write lane b's iterate: x, vx of this CTA's columns; y, vy from rank 0.
  __device__ void store(float* y, float* x, float* vy, float* vx) const {
    const int tid = threadIdx.x;
    for (int j = tid; j < ncol; j += kThreads) {
      x[c0 + j] = s_x[j];
      vx[c0 + j] = s_vx[j];
    }
    if (rank == 0) {
      for (int k = tid; k < m; k += kThreads) {
        y[k] = s_y[k];
        vy[k] = s_vy[k];
      }
    }
  }
};

}  // namespace conic_cluster
