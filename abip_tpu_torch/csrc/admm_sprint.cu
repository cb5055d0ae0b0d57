// Pure-f32 LP ADMM sprints for Hopper (sm_90a), one thread-block cluster
// per lane.
//
// Replaces two TPU kernels of `abip_tpu/ops/admm_pallas.py` (Pallas):
//   * `_sprint_stop_kernel_batched` (grid over lanes; entry
//     `fused_admm_sprint_stop`): up to t_max[b] iterations of lane b, the
//     HSD-operator residual qres (`abip.c:1951-1996`) probed every `probe`
//     iterations, the lane stopping at qres < thresh; the x prox masked.
//     `sprint_cluster_kernel<kRes, true>`.
//   * `_sprint_kernel` (entry `fused_admm_sprint`): exactly t_max[b]
//     iterations, no probe.  `sprint_cluster_kernel<kRes, false>`.
// Both compute what `abip_tpu_torch/ops/admm_sprint.py:_sprint_compute`
// computes: projection with the rank-1 tau correction, N^-1 apply,
// back-substitution (`abip.c:539-562`), barrier prox and dual update
// (`:567-584`, `:717-748`).
//
// Layout: that of csrc/admm_delta.cu (K1), whose shape (m=50, n=2000 at the
// smoke) these kernels share.  Lane b is cluster b of C CTAs (C from
// `sprint_launch_plan` in the wrapper); CTA r owns the columns
// [r nc, (r+1) nc).  Resident (kRes), each CTA holds for the whole launch
// its column slice of A, Ninv (transposed), its slices of hx, gx, the mask
// and of the x-side state (x, vx), and the m-side vectors, replicated.
// Streaming (!kRes), the same code reads A, Ninv and the x-side operands
// through L2 and keeps x, vx in the outputs and the m-side vectors in a
// global workspace; spilled, its shared-memory layout lies in that
// workspace too, so that the kernels take every shape.
//
// Two cluster exchanges per iteration.  With u = x + vx and qx = u - rtau
// hx, the rank-1 weight's sum over the columns is rewritten as
//   <qx, gx> = <u, gx> - rtau <hx, gx>,
// u being known at the end of the previous iteration, and the m-side sum
// <qy, gy> = rho_y (<y, gy> + <vy, gy>) - rtau <hy, gy> is kept by every
// CTA; so each CTA forms wx = -(qx - coef hx) on its columns at once, and
// the first exchange carries A wx (a partial m-vector from each CTA's
// columns), the second <u, gx> and <z_x, hx>.  (K1's one exchange, which
// carries A u and forms A wx = (rtau + coef) A hx - A u, loses too many
// digits here: the sprints iterate the absolute iterate, whose A u and
// (rtau + coef) A hx nearly cancel.)  <hx, gx> is exchanged once per
// launch.  Ninv rhs (m^2 MACs) is computed by every CTA, A' z_y is local
// to each CTA's columns; a probe takes one more exchange (A x and four
// x-side sums).  Every sum over the cluster is read in rank order
// (cluster_common.cuh), so all CTAs take the same stop decision.  Products
// with one vector: no tensor-core work.
//
// What bounds it on this card: latency, as K1: a chain of dependent steps
// per iteration, two cluster barriers and their rounds of remote loads
// among them.
//
// Numerics: plain IEEE f32 `sqrtf` and `/` (build without -use_fast_math).
// The barrier prox takes the cancellation-free form for t < 0,
// 2 lam / (sqrt(t^2 + 4 lam) - t), not the reference's guarded form, which
// is wrong by up to 1e5x for |t| < 1e-15.  FMA contraction is allowed.

#include <math.h>

#include "cluster_common.cuh"

namespace {

using cluster_ops::block_sum;
using cluster_ops::col_dot;
using cluster_ops::cols_per_cta;
using cluster_ops::cp_async4;
using cluster_ops::kThreads;
using cluster_ops::kWarps;
using cluster_ops::rank_sum;
using cluster_ops::rows_dot;
using cluster_ops::warp_sum;

// the shared-memory plan of csrc/admm_delta.cu, with this kernel's slices
constexpr int kRed = 12;    // reduction scratch per warp (K1's)
constexpr int kSlot = 16;   // floats of one scalar exchange slot
constexpr int kXOps = 3;    // hx, gx, maskx
constexpr int kXState = 2;  // x, vx
constexpr int kMVecs = 4;   // y, vy, rhs, zy

// per-lane scalar slots, `ops/admm_sprint.py` S_*
enum { S_RHOY, S_IGTH, S_LAM, S_ALPHA, S_TAU0, S_KAPPA0, S_THRESH, S_COUNT = 8 };
// operand order of the C entry (SprintOperands, then t_max)
enum {
  I_SCAL, I_A, I_NINV, I_HY, I_HX, I_GY, I_GX, I_MASKX, I_Y, I_X, I_VY, I_VX,
  I_TMAX, I_COUNT
};
enum { O_Y, O_X, O_VX, O_ROW, O_COUNT };
constexpr int kRowWidth = 4;  // [tau, kappa, qres, t_done]

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  float* out[O_COUNT];
  float* work;      // streaming form: wfl floats per CTA
  long long wfl;    // the m-side vectors, then (spilled) the layout
  int m, n, nc, probe;
};

// Shared memory of one CTA, in floats, as csrc/admm_delta.cu counts it.
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

// the positive root of u^2 - t u - lam = 0, without cancellation for t < 0
__device__ __forceinline__ float prox(float t, float lam) {
  const float s = sqrtf(t * t + 4.0f * lam);
  return (t >= 0.f) ? 0.5f * (t + s) : 2.0f * lam / (s - t);
}

template <int kForm, bool kStop>
__global__ void __launch_bounds__(kThreads, 1)
sprint_cluster_kernel(Args a) {
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
  float* s_w = s_sums + kSlot;                 // nc: wx, the row dots' operand
  float* xbuf = s_w + nc;                      // 2 x 2m
  float* s_A = xbuf + 4 * (size_t)m;           // resident: m x nc
  float* s_x = s_A + (size_t)m * nc;           // resident: 5 slices of nc
  float* s_Ninv = s_x + (size_t)(kXOps + kXState) * nc;  // resident: Ninv'
  float* s_mv = s_Ninv + (size_t)m * m;        // resident: kMVecs m-vectors
  // the m-side vectors (replicated in every CTA)
  float* mv = kRes ? s_mv : ws;
  float* s_y = mv;
  float* s_vy = mv + m;
  float* s_rhs = mv + 2 * m;
  float* s_zy = mv + 3 * m;

  const float* sc = a.in[I_SCAL] + b * S_COUNT;
  const float* gA = a.in[I_A] + b * m * n;
  const float* gNinv = a.in[I_NINV] + b * m * m;
  const float* hy = a.in[I_HY] + b * m;
  const float* gy = a.in[I_GY] + b * m;

  const int kXOpIndex[kXOps] = {I_HX, I_GX, I_MASKX};
  const float* xop[kXOps];
#pragma unroll
  for (int k = 0; k < kXOps; ++k)
    xop[k] = kRes ? s_x + (size_t)k * nc : a.in[kXOpIndex[k]] + b * n + c0;
  const float *hx = xop[0], *gx = xop[1], *maskx = xop[2];
  const float* x_in = a.in[I_X] + b * n + c0;
  const float* vx_in = a.in[I_VX] + b * n + c0;
  float* gxo = a.out[O_X] + b * n + c0;
  float* gvxo = a.out[O_VX] + b * n + c0;
  float* x = kRes ? s_x + (size_t)kXOps * nc : gxo;
  float* vx = kRes ? s_x + (size_t)(kXOps + 1) * nc : gvxo;
  const float* Ab = kRes ? s_A : gA + c0;
  const int lda = kRes ? nc : n;
  const int len = kRes ? nc : ncol;  // the row dots' length

  const float rho_y = sc[S_RHOY], inv_gth1 = sc[S_IGTH], lam = sc[S_LAM];
  const float alpha = sc[S_ALPHA], thresh = sc[S_THRESH];
  const float oma = 1.0f - alpha;
  const int t_max = a.t_max[b];

  if (kRes) {  // the launch's one load of this CTA's operands and state
    cluster_ops::load_slice(s_A, nc, gA + c0, n, m, ncol);
    for (int e = tid; e < m * m; e += kThreads) {  // transposed
      const int i = e / m, k = e - i * m;
      cp_async4(s_Ninv + (size_t)k * m + i, gNinv + e);
    }
    const int kIn[kXOps + kXState] = {I_HX, I_GX, I_MASKX, I_X, I_VX};
#pragma unroll
    for (int k = 0; k < kXOps + kXState; ++k)
      cluster_ops::load_slice(s_x + (size_t)k * nc, nc,
                              a.in[kIn[k]] + b * n + c0, 0, 1, ncol);
    cluster_ops::cp_async_commit();
  } else {
    for (int j = tid; j < ncol; j += kThreads) {
      x[j] = x_in[j];
      vx[j] = vx_in[j];
    }
  }
  for (int i = tid; i < m; i += kThreads) {
    s_y[i] = a.in[I_Y][b * m + i];
    s_vy[i] = a.in[I_VY][b * m + i];
  }
  if (kRes) cluster_ops::cp_async_wait();
  __syncthreads();
  for (int j = tid; j < nc; j += kThreads) s_w[j] = 0.f;  // pads stay 0

  int e = 0;  // parity of the next exchange

  // once per launch: <hx, gx> and <u, gx> over the cluster (the exchange's
  // barrier is the first cluster barrier: every CTA has started before any
  // reads another's shared memory); here <hy, gy>, <vy, gy>, |vy|^2 and
  // <y, gy>
  float hg, ug, hyg, vyg, vy2, yg;
  {
    float p[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = tid; j < ncol; j += kThreads) {
      p[0] += hx[j] * gx[j];
      p[1] += (x[j] + vx[j]) * gx[j];
    }
    for (int i = tid; i < m; i += kThreads) {
      p[2] += hy[i] * gy[i];
      p[3] += s_vy[i] * gy[i];
      p[4] += s_vy[i] * s_vy[i];
      p[5] += s_y[i] * gy[i];
    }
    block_sum(p, red);
    hyg = p[2];
    vyg = p[3];
    vy2 = p[4];
    yg = p[5];
    float* slot = slots + e * kSlot;
    if (tid == 0) {
      slot[0] = p[0];
      slot[1] = p[1];
    }
    cluster_ops::sync();
    if (tid < 2) s_sums[tid] = rank_sum(slot, tid, C, peer);
    __syncthreads();
    hg = s_sums[0];
    ug = s_sums[1];
    e ^= 1;
  }
  float tau = sc[S_TAU0], kappa = sc[S_KAPPA0];

  // One ADMM iteration (`abip.c:539-584`, `:717-748`).
  auto step = [&]() {
    const float rtau = tau + kappa;
    const float pw = (rho_y * (yg + vyg) - rtau * hyg) + (ug - rtau * hg);
    const float coef = pw * inv_gth1;
    for (int j = tid; j < ncol; j += kThreads) {
      const float hj = hx[j];
      s_w[j] = -(((x[j] + vx[j]) - rtau * hj) - coef * hj);
    }
    __syncthreads();
    // the first exchange: rhs = (qy - coef hy) + A wx, A wx over the cluster
    float* part = xbuf + e * 2 * (size_t)m;
    rows_dot<false, kRes>(Ab, lda, s_w, nullptr, len, m, part, nullptr);
    cluster_ops::sync();
    for (int i = tid; i < m; i += kThreads)
      s_rhs[i] = ((rho_y * (s_y[i] + s_vy[i]) - rtau * hy[i]) - coef * hy[i]) +
                 rank_sum(part, i, C, peer);
    __syncthreads();
    e ^= 1;
    // z_y = Ninv rhs, in every CTA: resident, one thread a row down the
    // transposed Ninv; else one warp a row through L2
    if (kRes) {
      for (int i = tid; i < m; i += kThreads)
        s_zy[i] = col_dot(s_Ninv, m, s_rhs, m, i);
    } else {
      rows_dot<false, false>(gNinv, m, s_rhs, nullptr, m, m, s_zy, nullptr);
    }
    __syncthreads();
    // y = z_y - vy (replicated) by warp 0, with <z_y, hy> and <y, gy>,
    // published through s_sums by the exchange's barriers
    if (tid < 32) {
      float py[2] = {0.f, 0.f};
      for (int i = tid; i < m; i += 32) {
        const float zy = s_zy[i];
        const float yn = zy - s_vy[i];
        py[0] += zy * hy[i];
        py[1] += yn * gy[i];
        s_y[i] = yn;
      }
      py[0] = warp_sum(py[0]);
      py[1] = warp_sum(py[1]);
      if (tid == 0) {
        s_sums[2] = py[0];
        s_sums[3] = py[1];
      }
    }
    // A' z_y on this CTA's columns, the x update; <z_x, hx>, <u, gx>
    float p[2] = {0.f, 0.f};
    for (int j = tid; j < ncol; j += kThreads) {
      const float acc = col_dot(Ab, lda, s_zy, m, j);
      const float hj = hx[j];
      const float xj = x[j], vxj = vx[j];
      const float zx = acc - s_w[j];
      p[0] += zx * hj;
      const float rel = alpha * zx + oma * xj;
      float xn = prox(rel - vxj, lam);
      if (kStop) xn *= maskx[j];
      const float vxn = (vxj + xn) - rel;
      x[j] = xn;
      vx[j] = vxn;
      p[1] += (xn + vxn) * gx[j];
    }
    p[0] = warp_sum(p[0]);
    p[1] = warp_sum(p[1]);
    if ((tid & 31) == 0) {
      red[2 * (tid >> 5)] = p[0];
      red[2 * (tid >> 5) + 1] = p[1];
    }
    __syncthreads();
    // the second exchange: <z_x, hx> and <u, gx> summed over the cluster
    float* slot = slots + e * kSlot;
    if (tid == 0) {
      float f[2] = {0.f, 0.f};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        f[0] += red[2 * w];
        f[1] += red[2 * w + 1];
      }
      slot[0] = f[0];
      slot[1] = f[1];
    }
    cluster_ops::sync();
    if (tid < 2) s_sums[tid] = rank_sum(slot, tid, C, peer);
    __syncthreads();
    e ^= 1;
    ug = s_sums[1];
    yg = s_sums[3];
    const float tau_t = (rtau + s_sums[2]) + s_sums[0];
    const float rel_tau = alpha * tau_t + oma * tau;
    const float tau_n = prox(rel_tau - kappa, lam);
    kappa = (kappa + tau_n) - rel_tau;
    tau = tau_n;
  };

  // HSD-operator residual (`abip.c:1951-1996`; h = (-b; c)) through one
  // exchange: A x and the x-side sums |q2|^2, <x,hx>, |x|^2, |vx|^2
  auto qres = [&]() -> float {
    float* part = xbuf + e * 2 * (size_t)m;
    rows_dot<false, kRes>(Ab, lda, x, nullptr, len, m, part, nullptr);
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = tid; j < ncol; j += kThreads) {
      const float xj = x[j], vxj = vx[j];
      const float q2 =
          ((col_dot(Ab, lda, s_y, m, j) + vxj) - tau * hx[j]) * maskx[j];
      p[0] += q2 * q2;
      p[1] += xj * hx[j];
      p[2] += xj * xj;
      p[3] += vxj * vxj;
    }
    block_sum(p, red);
    float* slot = slots + e * kSlot;
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) slot[k] = p[k];
    }
    cluster_ops::sync();
    // the y side, in every CTA: |q1|^2, <y,hy>, |y|^2
    float r[3] = {0.f, 0.f, 0.f};
    for (int i = tid; i < m + 4; i += kThreads) {
      if (i >= m) {
        s_sums[i - m] = rank_sum(slot, i - m, C, peer);
        continue;
      }
      const float q1 = rank_sum(part, i, C, peer) + tau * hy[i];
      const float y = s_y[i];
      r[0] += q1 * q1;
      r[1] += y * hy[i];
      r[2] += y * y;
    }
    e ^= 1;
    block_sum(r, red);  // its barrier also publishes s_sums
    const float q3 = (-r[1] - s_sums[1]) - kappa;
    const float qsq = (r[0] + s_sums[0]) + q3 * q3;
    const float un = (r[2] + s_sums[2]) + tau * tau;
    const float vn = (vy2 + s_sums[3]) + kappa * kappa;
    return sqrtf(qsq) / (1.0f + sqrtf(un + vn));
  };

  int t = 0;
  float q = INFINITY;
  if (kStop) {
    while (t < t_max && q >= thresh) {  // the same decision in every CTA
      for (int it = 0; it < probe; ++it) step();
      t += probe;
      q = qres();
    }
  } else {
    for (; t < t_max; ++t) step();
  }

  if (kRes) {
    for (int j = tid; j < ncol; j += kThreads) {
      gxo[j] = x[j];
      gvxo[j] = vx[j];
    }
  }
  if (rank == 0) {
    for (int i = tid; i < m; i += kThreads) a.out[O_Y][b * m + i] = s_y[i];
    if (tid == 0) {
      float* row = a.out[O_ROW] + b * kRowWidth;
      row[0] = tau; row[1] = kappa; row[2] = q; row[3] = (float)t;
    }
  }
  // no CTA leaves while another may still read its shared memory
  cluster_ops::sync();
}

// the kernel of (resident, spill), stopping or not
template <bool kStop>
void (*kernel_of(int resident, int spill))(Args) {
  switch (cluster_ops::form_of(resident, spill)) {
    case cluster_ops::kResident:
      return sprint_cluster_kernel<cluster_ops::kResident, kStop>;
    case cluster_ops::kStreaming:
      return sprint_cluster_kernel<cluster_ops::kStreaming, kStop>;
    default:
      return sprint_cluster_kernel<cluster_ops::kSpilled, kStop>;
  }
}

inline void (*kernel_of(int resident, int spill, bool stop))(Args) {
  return stop ? kernel_of<true>(resident, spill) : kernel_of<false>(resident, spill);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for shape (m, n) in clusters of C CTAs,
// resident (A's slice, Ninv, the x-side slices and the m-side vectors in
// shared memory), streaming, or spilled (none).
long long abip_sprint_smem_bytes(int m, int n, int C, int resident, int spill) {
  if (spill) return 0;
  return smem_floats(m, cols_per_cta(n, C), resident != 0) *
         (long long)sizeof(float);
}

// Floats of global workspace per CTA the streaming or spilled form needs.
long long abip_sprint_work_floats(int m, int n, int C, int spill) {
  return work_floats(m, cols_per_cta(n, C), spill != 0);
}

int abip_sprint_row_width() { return kRowWidth; }

int abip_sprint_threads() { return kThreads; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// How many clusters of C CTAs of this shape the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
int abip_sprint_max_active_clusters(int m, int n, int C, int resident,
                                    int spill, int* clusters) {
  const int smem = (int)abip_sprint_smem_bytes(m, n, C, resident, spill);
  return cluster_ops::max_active(kernel_of(resident, spill, true), C, smem,
                                 clusters);
}

// Launches one sprint over B lanes, one cluster of C CTAs per lane, on
// `stream`; returns the CUDA error code.  in: the 12 f32 SprintOperands then
// t_max (int32, B); out: y, x, vx, row.  All contiguous, lane-major.
// `probe` > 0: the stopping sprint, probing every `probe` iterations;
// `probe` == 0: the plain sprint.  work: B * C * abip_sprint_work_floats(...)
// floats, 16-byte aligned, for the streaming and spilled forms (unused
// when resident).
int abip_sprint(void* const* in, void* const* out, void* work, int B, int m,
                int n, int probe, int C, int resident, int spill,
                void* stream) {
  if (C < 1 || C > cluster_ops::kMaxCluster || probe < 0)
    return (int)cudaErrorInvalidValue;
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
  const int smem = (int)abip_sprint_smem_bytes(m, n, C, resident, spill);
  return cluster_ops::launch(kernel_of(resident, spill, probe > 0), a, B, C,
                             smem, stream);
}

}  // extern "C"
