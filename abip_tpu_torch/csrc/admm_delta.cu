// Anchored-delta LP ADMM chunk for Hopper (sm_90a), one thread-block
// cluster per lane.
//
// Replaces the TPU kernel `_delta_kernel_batched` of
// `abip_tpu/ops/admm_delta.py` (Pallas, grid over lanes).  It computes what
// `abip_tpu_torch/ops/admm_delta.py:_delta_compute` computes: up to t_max[b]
// f32 ADMM iterations in the delta frame of an f64 anchor, with the
// delta-frame inner criterion probed every `probe` iterations on the current
// and the averaged iterate, and each lane stopping on its own threshold.
//
// Layout.  Lane b is cluster b of C CTAs (launched with cudaLaunchKernelEx
// and a cluster dimension; C from `delta_launch_plan` in the wrapper).  CTA r
// owns the columns [r nc, (r+1) nc), nc = ceil(n / C) rounded up to a
// multiple of 4 (its resident slices are zero-padded to nc columns, so
// that the row dots read them as 16-byte vectors).  In the resident form
// (kRes) it holds, for the whole launch, in shared memory: its column slice
// of A (m x nc), Ninv (transposed, so that one thread walks one row), its
// slices of the x-side operands and of the x-side state (dx, dvx, dsx,
// dsvx), loaded once with cp.async and written back once at the end, and
// the m-side state, replicated in every CTA.  Where that does not fit, the
// streaming form (!kRes) is the same code reading A, Ninv and the x-side
// operands through L2 and keeping the state in global memory (the outputs,
// and a per-CTA workspace for the m-side); its shared memory (the exchange
// buffers, 4 m floats, and one x slice) stays within what one block per
// lane needed (n + 5 m floats).  Where even that does not fit, the spilled
// form is the streaming form with its shared-memory layout in the global
// workspace too (the other CTAs read its exchange buffers from L2), so
// that the kernel takes every shape.
//
// One cluster exchange per iteration.  The step needs three sums over the
// lane's columns: <dqx, gx> for the rank-1 weight, A dwx, and <dz_x, hx> for
// tau.  With dqx = u - drtau hx and dwx = -(dqx - dcoef hx), u = dx + dvx:
//   <dqx, gx> = <u, gx> - drtau <hx, gx>,
//   A dwx     = -A u + (drtau + dcoef) A hx,
// and u is known at the end of the previous iteration.  So one exchange at
// the end of each iteration carries A u (a partial m-vector from each CTA's
// columns), <u, gx> and <dz_x, hx>; A hx and <hx, gx> are exchanged once per
// launch.  Ninv drhs (m^2 MACs) is computed by every CTA; A' dz_y is local
// to each CTA's columns.  A probe evaluates the current and the averaged
// criterion together, through one more exchange.  An exchange writes the
// partials into this CTA's shared memory (the last warp folds the scalar
// sums while the others form A u), passes one cluster barrier and reads the
// C partials through distributed shared memory in rank order, all in one
// round of remote loads (cluster_common.cuh), so every CTA holds
// bit-identical sums and takes the same stop decision.  The exchange
// buffers are double-buffered by the exchange's parity: a buffer is written
// again only after the next exchange's barrier, which every CTA passes
// after its reads.  Products with one vector: no tensor-core work.
//
// What bounds it on this card: latency, not bytes.  Each iteration is a
// chain of dependent steps (drhs, Ninv drhs, the column dots and the prox,
// the row dots, the cluster barrier, the remote reads, the tau prox), each
// separated by a barrier, with A read twice from shared memory.  Its
// largest fixed pieces are the cluster barrier's arrive, the round of
// remote loads and the IEEE divisions of the two prox chains (PERF.md has
// the cycles of each piece, measured on an H100).
//
// Numerics: plain IEEE f32 `sqrtf` and `/` (build without -use_fast_math);
// the cancellation-free prox delta is only accurate with correctly rounded
// square root and division.  FMA contraction is allowed.

#include <cuda_runtime.h>

#include "cluster_common.cuh"

namespace {

using cluster_ops::block_sum;
using cluster_ops::col_dot;
using cluster_ops::cols_per_cta;
using cluster_ops::cp_async4;
using cluster_ops::kThreads;
using cluster_ops::kWarps;
using cluster_ops::rows_dot;
using cluster_ops::warp_sum;

constexpr int kRed = 12;   // widest block reduction: a probe's 2 x 6 x-sums
constexpr int kSlot = 16;  // floats of one scalar exchange slot
constexpr int kXOps = 13;  // x-side operand slices held in shared memory
constexpr int kXState = 4; // dx, dvx, dsx, dsvx
constexpr int kMVecs = 5;  // m-side vectors outside the exchange buffers

// per-lane scalar slots, the order of the reference's packed scalar row
enum {
  S_RHOY, S_IGTH, S_LAM, S_ALPHA, S_THRESH, S_TAU0, S_KAPPA0, S_T0T, S_SAT,
  S_ETT, S_ETAU, S_EVTAU, S_Q30, S_UN0, S_VN0, S_SJ, S_C0TAU, S_C0KAP,
  S_QINIT, S_EYTAU, S_COUNT
};

// operand order of the C entry (the DeltaAnchor field order, then t_max)
enum {
  I_SCAL, I_A, I_NINV, I_HY, I_HX, I_GY, I_GX, I_MASKX, I_EY, I_EX, I_EVX,
  I_T0X, I_SAX, I_ETX, I_Q10, I_Q20, I_Y0, I_X0, I_VX0, I_C0Y, I_C0X, I_C0VX,
  I_TMAX, I_COUNT
};
enum { O_DY, O_DX, O_DVX, O_DSY, O_DSX, O_DSVX, O_ROW, O_COUNT };
constexpr int kRowWidth = 7;  // [dtau, dkap, dstau, dskap, qres, t_done, avg]

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  float* out[O_COUNT];
  float* work;      // streaming form: wfl floats per CTA
  long long wfl;    // the m-side vectors, then (spilled) the layout
  int m, n, nc, probe;
};

// Shared memory of one CTA, in floats: the reduction scratch, the scalar
// slots and the exchanged sums, one x slice (the row dots' operand), two
// exchange buffers of 2 m, and in the resident form A's slice, the x-side
// slices, Ninv and the m-side vectors (the 16-byte aligned pieces first).
inline long long smem_floats(int m, int nc, bool res) {
  long long f = (long long)kWarps * kRed + 3 * kSlot + nc + 4LL * m;
  if (res)
    f += (long long)m * nc + (long long)(kXOps + kXState) * nc +
         (long long)m * m + (long long)kMVecs * m;
  return f;
}

using cluster_ops::al4;

// Global workspace of one CTA of the streaming form, in floats: the m-side
// vectors, and in the spilled form the shared-memory layout after them.
inline long long work_floats(int m, int nc, bool spill) {
  return al4((long long)kMVecs * m) + (spill ? al4(smem_floats(m, nc, false)) : 0);
}

// prox(t0 + dt, lam) - prox(t0, lam) without cancellation; s0 is
// sqrt(t0^2 + 4 lam).  The branch follows the current argument's sign.
__device__ __forceinline__ float prox_delta(float dt, float t0, float s0,
                                            float lam) {
  const float t = t0 + dt;
  const float s = sqrtf(t * t + 4.0f * lam);
  const float ds = dt * (t0 + t) / (s + s0);
  if (t >= 0.f) return 0.5f * (dt + ds);
  return 2.0f * lam * (dt - ds) / ((s - t) * (s0 - t0));
}

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1)
delta_cluster_kernel(Args a) {
  constexpr bool kRes = kForm == cluster_ops::kResident;
  constexpr bool kSpill = kForm == cluster_ops::kSpilled;
  extern __shared__ __align__(16) float smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int m = a.m, n = a.n, nc = a.nc, probe = a.probe;
  const int c0 = rank * nc;
  const int ncol = max(0, min(nc, n - c0));  // this CTA's columns
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x / C;
  // streaming: this CTA's workspace; spilled, the layout lies in it too,
  // and `peer` is the stride between the cluster's copies
  float* ws = kRes ? nullptr : a.work + (size_t)blockIdx.x * a.wfl;
  const long long peer = kSpill ? a.wfl : 0;
  float* base = kSpill ? ws + al4((long long)kMVecs * m) : smem;

  // exchange buffers: parity e holds xbuf[e] (2 m) and slots[e] (kSlot)
  float* red = base;                           // kWarps * kRed
  float* slots = red + kWarps * kRed;          // 2 x kSlot
  float* s_sums = slots + 2 * kSlot;           // kSlot: an exchange's sums
  float* s_w = s_sums + kSlot;                 // nc: x operand of row dots
  float* xbuf = s_w + nc;                      // 2 x 2m
  float* s_A = xbuf + 4 * (size_t)m;           // resident: m x nc
  float* s_x = s_A + (size_t)m * nc;           // resident: 17 slices of nc
  float* s_Ninv = s_x + (size_t)(kXOps + kXState) * nc;  // resident: Ninv'
  float* s_mv = s_Ninv + (size_t)m * m;        // resident: kMVecs m-vectors
  // the m-side vectors (replicated in every CTA)
  float* mv = kRes ? s_mv : ws;
  float* s_dy = mv;           // y deltas
  float* s_dsy = mv + m;      // y delta sums
  float* s_rhs = mv + 2 * m;  // the exchanged A u, then drhs
  float* s_zy = mv + 3 * m;   // dz_y; probe: the averaged y
  float* s_ah = mv + 4 * m;   // A hx, once per launch

  const float* sc = a.in[I_SCAL] + b * S_COUNT;
  const float* gA = a.in[I_A] + b * m * n;
  const float* gNinv = a.in[I_NINV] + b * m * m;
  const float* hy = a.in[I_HY] + b * m;
  const float* gy = a.in[I_GY] + b * m;
  const float* ey = a.in[I_EY] + b * m;
  const float* q10 = a.in[I_Q10] + b * m;
  const float* y0 = a.in[I_Y0] + b * m;
  const float* c0y = a.in[I_C0Y] + b * m;

  // this CTA's column slice of each x-side operand (in the order a
  // resident CTA holds them), and of the x-state
  const int kXOpIndex[kXOps] = {I_HX,  I_GX,  I_MASKX, I_EX,  I_EVX,
                                I_T0X, I_SAX, I_ETX,   I_Q20, I_X0,
                                I_VX0, I_C0X, I_C0VX};
  const float* xop[kXOps];
#pragma unroll
  for (int k = 0; k < kXOps; ++k)
    xop[k] = kRes ? s_x + (size_t)k * nc : a.in[kXOpIndex[k]] + b * n + c0;
  const float *hx = xop[0], *gx = xop[1], *maskx = xop[2], *ex = xop[3];
  const float *evx = xop[4], *t0x = xop[5], *sax = xop[6], *etx = xop[7];
  const float *q20 = xop[8], *x0 = xop[9], *vx0 = xop[10], *c0x = xop[11];
  const float* c0vx = xop[12];
  float* gdx = a.out[O_DX] + b * n + c0;
  float* gdvx = a.out[O_DVX] + b * n + c0;
  float* gdsx = a.out[O_DSX] + b * n + c0;
  float* gdsvx = a.out[O_DSVX] + b * n + c0;
  float* dx = kRes ? s_x + (size_t)(kXOps + 0) * nc : gdx;
  float* dvx = kRes ? s_x + (size_t)(kXOps + 1) * nc : gdvx;
  float* dsx = kRes ? s_x + (size_t)(kXOps + 2) * nc : gdsx;
  float* dsvx = kRes ? s_x + (size_t)(kXOps + 3) * nc : gdsvx;
  // A's slice (row stride lda), from shared memory or through L2
  const float* Ab = kRes ? s_A : gA + c0;
  const int lda = kRes ? nc : n;

  const float rho_y = sc[S_RHOY], inv_gth1 = sc[S_IGTH], lam = sc[S_LAM];
  const float alpha = sc[S_ALPHA], thresh = sc[S_THRESH];
  const float tau0 = sc[S_TAU0], kappa0 = sc[S_KAPPA0];
  const float t0t = sc[S_T0T], sat = sc[S_SAT], ett = sc[S_ETT];
  const float etau = sc[S_ETAU], evtau = sc[S_EVTAU], q30 = sc[S_Q30];
  const float un0 = sc[S_UN0], vn0 = sc[S_VN0], sj_prev = sc[S_SJ];
  const float c0tau = sc[S_C0TAU], c0kap = sc[S_C0KAP];
  const float one_m_alpha = 1.0f - alpha;
  const int t_max = a.t_max[b];

  if (kRes) {  // the launch's one load of this CTA's operands
    // the slices' pad columns [ncol, nc) hold zeros
    cluster_ops::load_slice(s_A, nc, gA + c0, n, m, ncol);
    for (int e = tid; e < m * m; e += kThreads) {  // transposed
      const int i = e / m, k = e - i * m;
      cp_async4(s_Ninv + (size_t)k * m + i, gNinv + e);
    }
#pragma unroll
    for (int k = 0; k < kXOps; ++k) {
      const float* src = a.in[kXOpIndex[k]] + b * n + c0;
      for (int j = tid; j < nc; j += kThreads) {
        if (j < ncol)
          cp_async4(s_x + (size_t)k * nc + j, src + j);
        else
          s_x[(size_t)k * nc + j] = 0.f;
      }
    }
    cluster_ops::cp_async_commit();
  }
  for (int j = tid; j < (kRes ? nc : ncol); j += kThreads) {
    dx[j] = 0.f; dvx[j] = 0.f; dsx[j] = 0.f; dsvx[j] = 0.f;
  }
  for (int j = tid; j < nc; j += kThreads) s_w[j] = 0.f;
  for (int i = tid; i < m; i += kThreads) {
    s_dy[i] = 0.f; s_dsy[i] = 0.f; s_rhs[i] = 0.f;  // A u = 0 at u = 0
  }
  if (kRes) cluster_ops::cp_async_wait();
  // every CTA of the cluster has started and loaded before any reads
  // another's shared memory
  cluster_ops::sync();

  int e = 0;  // parity of the next exchange

  // once per launch: A hx and <hx, gx> over the cluster, <hy, gy> here
  float hg, hyg;
  {
    float* part = xbuf + e * 2 * (size_t)m;
    rows_dot<false, kRes>(Ab, lda, hx, nullptr, kRes ? nc : ncol, m, part,
                          nullptr);
    float p[2] = {0.f, 0.f};
    for (int j = tid; j < ncol; j += kThreads) p[0] += hx[j] * gx[j];
    for (int i = tid; i < m; i += kThreads) p[1] += hy[i] * gy[i];
    block_sum(p, red);
    hyg = p[1];
    float* slot = slots + e * kSlot;
    if (tid == 0) slot[0] = p[0];
    cluster_ops::sync();
    for (int i = tid; i < m + 1; i += kThreads) {
      if (i < m)
        s_ah[i] = cluster_ops::rank_sum(part, i, C, peer);
      else
        s_sums[0] = cluster_ops::rank_sum(slot, 0, C, peer);
    }
    __syncthreads();
    hg = s_sums[0];
    e ^= 1;
  }
  // the exchanged sums the next iteration starts from (u = 0, dy = 0)
  float ug = 0.f, dyg = 0.f;
  float dtau = 0.f, dkap = 0.f, dstau = 0.f, dskap = 0.f;

  // One ADMM iteration on the deltas (`abip.c:539-584`, `:717-748`).
  auto step = [&]() {
    const float drtau = dtau + dkap;
    // the rank-1 weight: <dqy, gy> + <dqx, gx>, dqy = rho_y dy - drtau hy
    const float pw = (rho_y * dyg - drtau * hyg) + (ug - drtau * hg);
    const float dcoef = pw * inv_gth1;
    const float cw = drtau + dcoef;
    // drhs = dqy - dcoef hy + A dwx, A dwx = (drtau + dcoef) A hx - A u
    for (int i = tid; i < m; i += kThreads)
      s_rhs[i] = ((rho_y * s_dy[i] - drtau * hy[i]) - dcoef * hy[i]) +
                 (cw * s_ah[i] - s_rhs[i]);
    __syncthreads();
    // dz_y = Ninv drhs, in every CTA: resident, one thread a row down the
    // transposed Ninv; else one warp a row through L2
    if (kRes) {
      for (int i = tid; i < m; i += kThreads)
        s_zy[i] = col_dot(s_Ninv, m, s_rhs, m, i);
    } else {
      rows_dot<false, false>(gNinv, m, s_rhs, nullptr, m, m, s_zy, nullptr);
    }
    __syncthreads();
    // y update (replicated) by warp 0, with its sums <dz_y, hy>, <dy, gy>,
    // published through s_sums by the exchange's barriers
    float p[2] = {0.f, 0.f};
    if (tid < 32) {
      float py[2] = {0.f, 0.f};
      for (int i = tid; i < m; i += 32) {
        const float zy = s_zy[i];
        const float ny = ey[i] + zy;
        py[0] += zy * hy[i];
        py[1] += ny * gy[i];
        s_dy[i] = ny;
        s_dsy[i] += ny;
      }
      py[0] = warp_sum(py[0]);
      py[1] = warp_sum(py[1]);
      if (tid == 0) { s_sums[2] = py[0]; s_sums[3] = py[1]; }
    }
    // A' dz_y on this CTA's columns, the x update; <dz_x, hx>, <u, gx>
    for (int j = tid; j < ncol; j += kThreads) {
      const float acc = col_dot(Ab, lda, s_zy, m, j);
      const float hj = hx[j];
      const float dxj = dx[j], dvxj = dvx[j];
      const float dwx = -(((dxj + dvxj) - drtau * hj) - dcoef * hj);
      const float dzx = acc - dwx;
      p[0] += dzx * hj;
      const float drel = alpha * dzx + one_m_alpha * dxj;
      const float dt = (drel - dvxj) + etx[j];
      const float pxj = prox_delta(dt, t0x[j], sax[j], lam) * maskx[j];
      const float dxn = ex[j] + pxj;
      const float dvxn = ((dvxj + dxn) - drel) + evx[j];
      dx[j] = dxn;
      dvx[j] = dvxn;
      dsx[j] += dxn;
      dsvx[j] += dvxn;
      const float u = dxn + dvxn;
      s_w[j] = u;
      p[1] += u * gx[j];
    }
    p[0] = warp_sum(p[0]);
    p[1] = warp_sum(p[1]);
    if ((tid & 31) == 0) {
      red[2 * (tid >> 5)] = p[0];
      red[2 * (tid >> 5) + 1] = p[1];
    }
    __syncthreads();
    // the last warp folds this CTA's x-side sums into the exchange slot
    // while the others form A u on this CTA's columns, for the next
    // iteration
    float* slot = slots + e * kSlot;
    if (tid == kThreads - 32) {
      float f[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        f[0] += red[2 * w];
        f[1] += red[2 * w + 1];
      }
      slot[0] = f[0];
      slot[1] = f[1];
    }
    float* part = xbuf + e * 2 * (size_t)m;
    rows_dot<false, kRes>(Ab, lda, s_w, nullptr, kRes ? nc : ncol, m, part,
                          nullptr);
    // the exchange: A u, <dz_x, hx> and <u, gx> summed over the cluster,
    // all read in one round of remote loads
    cluster_ops::sync();
    for (int i = tid; i < m + 2; i += kThreads) {
      if (i < m)
        s_rhs[i] = cluster_ops::rank_sum(part, i, C, peer);
      else
        s_sums[i - m] = cluster_ops::rank_sum(slot, i - m, C, peer);
    }
    __syncthreads();
    e ^= 1;
    ug = s_sums[1];
    dyg = s_sums[3];
    const float dtau_t = drtau + (s_sums[2] + s_sums[0]);
    const float drel_t = alpha * dtau_t + one_m_alpha * dtau;
    const float dtt = (drel_t - dkap) + ett;
    const float dtau_n = etau + prox_delta(dtt, t0t, sat, lam);
    const float dkap_n = ((dkap + dtau_n) - drel_t) + evtau;
    dtau = dtau_n;
    dkap = dkap_n;
    dstau += dtau_n;
    dskap += dkap_n;
  };

  // HSD-operator residual at anchor + delta (`abip.c:1951-1996`) of the
  // current iterate and of the stage average with divisor `dom`, through
  // one exchange.
  auto qres_both = [&](float dom, float& q_cur, float& q_avg) {
    const float at[2] = {dtau, (c0tau + dstau) / dom};
    const float ak[2] = {dkap, (c0kap + dskap) / dom};
    for (int j = tid; j < ncol; j += kThreads) s_w[j] = (c0x[j] + dsx[j]) / dom;
    for (int i = tid; i < m; i += kThreads) s_zy[i] = (c0y[i] + s_dsy[i]) / dom;
    __syncthreads();
    // A x partials of the current (dx) and the averaged (s_w) iterate
    float* part = xbuf + e * 2 * (size_t)m;
    rows_dot<true, kRes>(Ab, lda, dx, s_w, kRes ? nc : ncol, m, part,
                         part + m);
    // x-side sums, six per iterate: |q2|^2, <x,hx>, <x0,x>, |x|^2,
    // <vx0,vx>, |vx|^2
    float p[kRed];
#pragma unroll
    for (int k = 0; k < kRed; ++k) p[k] = 0.f;
    for (int j = tid; j < ncol; j += kThreads) {
      float ac = 0.f, aa = 0.f;  // A' y of both iterates
      for (int i = 0; i < m; ++i) {
        const float aij = Ab[(size_t)i * lda + j];
        ac += aij * s_dy[i];
        aa += aij * s_zy[i];
      }
      const float ax[2] = {dx[j], s_w[j]};
      const float avx[2] = {dvx[j], (c0vx[j] + dsvx[j]) / dom};
      const float ay[2] = {ac, aa};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float q2 = q20[j] + ((ay[s] + avx[s]) - at[s] * hx[j]) * maskx[j];
        p[6 * s + 0] += q2 * q2;
        p[6 * s + 1] += ax[s] * hx[j];
        p[6 * s + 2] += x0[j] * ax[s];
        p[6 * s + 3] += ax[s] * ax[s];
        p[6 * s + 4] += vx0[j] * avx[s];
        p[6 * s + 5] += avx[s] * avx[s];
      }
    }
    block_sum(p, red);
    float* slot = slots + e * kSlot;
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < kRed; ++k) slot[k] = p[k];
    }
    cluster_ops::sync();
    // the exchange's reads (both A x, the twelve x-side sums) in one round
    // of remote loads, with the y-side sums, four per iterate: |q1|^2,
    // <y,hy>, <y0,y>, |y|^2
    float r[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < m + kRed; i += kThreads) {
      if (i >= m) {
        s_sums[i - m] = cluster_ops::rank_sum(slot, i - m, C, peer);
        continue;
      }
      const float axs[2] = {cluster_ops::rank_sum(part, i, C, peer),
                            cluster_ops::rank_sum(part + m, i, C, peer)};
      const float ys[2] = {s_dy[i], s_zy[i]};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float q1 = (q10[i] + axs[s]) + at[s] * hy[i];
        r[4 * s + 0] += q1 * q1;
        r[4 * s + 1] += ys[s] * hy[i];
        r[4 * s + 2] += y0[i] * ys[s];
        r[4 * s + 3] += ys[s] * ys[s];
      }
    }
    e ^= 1;
    block_sum(r, red);  // its barrier also publishes s_sums
#pragma unroll
    for (int k = 0; k < kRed; ++k) p[k] = s_sums[k];
    float q[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float* px = p + 6 * s;
      const float* ry = r + 4 * s;
      const float q3 = (q30 - (ry[1] + px[1])) - ak[s];
      const float qsq = (ry[0] + px[0]) + q3 * q3;
      const float un =
          ((un0 + 2.0f * ((ry[2] + px[2]) + tau0 * at[s])) + (ry[3] + px[3])) +
          at[s] * at[s];
      const float vn =
          ((vn0 + 2.0f * (px[4] + kappa0 * ak[s])) + px[5]) + ak[s] * ak[s];
      float nrm = un + vn;
      nrm = (nrm < 0.f) ? 0.f : nrm;  // max(., 0) that keeps a NaN
      q[s] = sqrtf(qsq) / (1.0f + sqrtf(nrm));
    }
    q_cur = q[0];
    q_avg = q[1];
  };

  int t = 0;
  float q = sc[S_QINIT], avg_crit = 0.f;
  while (t < t_max && q >= thresh) {  // the same decision in every CTA
    for (int it = 0; it < probe; ++it) step();
    t += probe;
    const float dom = fmaxf(sj_prev + (float)t, 1.0f);
    float q_cur, q_avg;
    qres_both(dom, q_cur, q_avg);
    avg_crit = (q_avg < q_cur) ? 1.f : 0.f;
    q = (q_avg != q_avg || q_cur != q_cur) ? q_avg + q_cur
                                           : fminf(q_avg, q_cur);
  }

  if (kRes) {
    for (int j = tid; j < ncol; j += kThreads) {
      gdx[j] = dx[j]; gdvx[j] = dvx[j]; gdsx[j] = dsx[j]; gdsvx[j] = dsvx[j];
    }
  }
  if (rank == 0) {
    float* dy = a.out[O_DY] + b * m;
    float* dsy = a.out[O_DSY] + b * m;
    for (int i = tid; i < m; i += kThreads) {
      dy[i] = s_dy[i];
      dsy[i] = s_dsy[i];
    }
    if (tid == 0) {
      float* row = a.out[O_ROW] + b * kRowWidth;
      row[0] = dtau; row[1] = dkap; row[2] = dstau; row[3] = dskap;
      row[4] = q; row[5] = (float)t; row[6] = avg_crit;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster_ops::sync();
}

// the kernel of (resident, spill)
inline void (*kernel_of(int resident, int spill))(Args) {
  switch (cluster_ops::form_of(resident, spill)) {
    case cluster_ops::kResident:
      return delta_cluster_kernel<cluster_ops::kResident>;
    case cluster_ops::kStreaming:
      return delta_cluster_kernel<cluster_ops::kStreaming>;
    default:
      return delta_cluster_kernel<cluster_ops::kSpilled>;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for shape (m, n) in clusters of C CTAs,
// resident (A's slice, Ninv, the x-side slices and the m-side state in
// shared memory), streaming, or spilled (none).
long long abip_delta_smem_bytes(int m, int n, int C, int resident, int spill) {
  if (spill) return 0;
  const int nc = cols_per_cta(n, C);
  return smem_floats(m, nc, resident != 0) * (long long)sizeof(float);
}

// Floats of global workspace per CTA the streaming or spilled form needs.
long long abip_delta_work_floats(int m, int n, int C, int spill) {
  return work_floats(m, cols_per_cta(n, C), spill != 0);
}

int abip_delta_row_width() { return kRowWidth; }

int abip_delta_threads() { return kThreads; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// How many clusters of C CTAs of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
int abip_delta_max_active_clusters(int m, int n, int C, int resident,
                                   int spill, int* clusters) {
  const int smem = (int)abip_delta_smem_bytes(m, n, C, resident, spill);
  return cluster_ops::max_active(kernel_of(resident, spill), C, smem,
                                 clusters);
}

// Launches one chunk over B lanes, one cluster of C CTAs per lane, on
// `stream`; returns the CUDA error code.  in: the 22 f32 DeltaAnchor
// operands then t_max (int32, B); out: dy, dx, dvx, dsy, dsx, dsvx, row.
// All contiguous, lane-major.  work: B * C * abip_delta_work_floats(...)
// floats, 16-byte aligned, for the streaming and spilled forms (unused
// when resident).
int abip_delta_chunk(void* const* in, void* const* out, void* work, int B,
                     int m, int n, int probe, int C, int resident, int spill,
                     void* stream) {
  if (C < 1 || C > cluster_ops::kMaxCluster) return (int)cudaErrorInvalidValue;
  if (!resident && work == nullptr) return (int)cudaErrorInvalidValue;
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  a.work = static_cast<float*>(work);
  a.m = m;
  a.n = n;
  a.nc = cols_per_cta(n, C);
  a.probe = probe;
  spill = spill != 0 && !resident;
  a.wfl = work_floats(m, a.nc, spill != 0);
  const int smem = (int)abip_delta_smem_bytes(m, n, C, resident, spill);
  return cluster_ops::launch(kernel_of(resident, spill), a, B, C, smem, stream);
}

}  // extern "C"
