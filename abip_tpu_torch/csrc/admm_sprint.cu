// Pure-f32 LP ADMM sprints for Hopper (sm_90a), one thread block per lane.
//
// Replaces two TPU kernels of `abip_tpu/ops/admm_pallas.py` (Pallas):
//   * `_sprint_stop_kernel_batched` (grid over lanes; entry
//     `fused_admm_sprint_stop`): up to t_max[b] iterations of lane b, the
//     HSD-operator residual qres (`abip.c:1951-1996`) probed every `probe`
//     iterations, the lane stopping at qres < thresh; the x prox masked.
//     Entry `abip_sprint_stop`.
//   * `_sprint_kernel` (entry `fused_admm_sprint`): exactly t_max[b]
//     iterations, no probe.  Entry `abip_sprint`.
// Both compute what `abip_tpu_torch/ops/admm_sprint.py:_sprint_compute`
// computes: projection with the rank-1 tau correction, N^-1 apply,
// back-substitution (`abip.c:539-562`), barrier prox and dual update
// (`:567-584`, `:717-748`).
//
// Layout, as `csrc/admm_delta.cu`; the block reductions and the products
// with one vector are those of `csrc/conic_common.cuh`.  Block b owns lane
// b.  Thread `tid` owns the x-side coordinates j = tid, tid + 1024, ...; x
// and vx live in the output buffers and only their owner touches them.  The
// m-length vectors
// (y, vy and the projection's scratch) and one n-length vector (the x-side
// operand of the row dots) live in shared memory.  A (m x n) and Ninv (m x m)
// stay in device memory and are read through L2: a lane's A is 400 KB at the
// smoke shape (m=50, n=2000), beyond a block's 227 KB of shared memory, while
// all 16 lanes' A (6.4 MB) sit in the 50 MB L2.  Per iteration A is read
// twice (A wx as one warp per row, A' z_y as one thread per column) and Ninv
// once; a probe reads A twice more.  These are products with one vector, so
// there is no tensor-core work.  Block-wide sums fold the per-warp partials
// in one order on every thread, so all threads take the same stop decision.
//
// What bounds it on this card: the A passes through L2 into ONE SM per lane,
// and occupancy (B=16 lanes busy 16 of the H100's 132 SMs), as for the delta
// kernel.
//
// Numerics: plain IEEE f32 `sqrtf` and `/` (build without -use_fast_math).
// The barrier prox takes the cancellation-free form for t < 0,
// 2 lam / (sqrt(t^2 + 4 lam) - t), not the reference's guarded form, which
// is wrong by up to 1e5x for |t| < 1e-15.  FMA contraction is allowed.

#include "conic_common.cuh"

using conic::block_sum;
using conic::col_dot;
using conic::kThreads;
using conic::kWarps;
using conic::row_dot;

namespace {

constexpr int kRed = 5;  // widest block reduction: the probe's 5 sums

// per-lane scalar slots, `ops/admm_sprint.py` S_*
enum { S_RHOY, S_IGTH, S_LAM, S_ALPHA, S_TAU0, S_KAPPA0, S_THRESH, S_COUNT = 8 };
// operand order of the C entries (SprintOperands, then t_max)
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
  int m, n, probe;
};

// the positive root of u^2 - t u - lam = 0, without cancellation for t < 0
__device__ __forceinline__ float prox(float t, float lam) {
  const float s = sqrtf(t * t + 4.0f * lam);
  return (t >= 0.f) ? 0.5f * (t + s) : 2.0f * lam / (s - t);
}

template <bool kStop>
__global__ void __launch_bounds__(kThreads) sprint_kernel(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;

  float* s_w = smem;         // n: x-side operand of the row dots
  float* s_y = s_w + n;      // m: y
  float* s_vy = s_y + m;     // m: vy (constant)
  float* s_qy = s_vy + m;    // m: projected y rhs
  float* s_v = s_qy + m;     // m: Ninv rhs
  float* s_zy = s_v + m;     // m: z_y
  float* red = s_zy + m;     // kWarps * kRed

  const float* sc = a.in[I_SCAL] + b * S_COUNT;
  const float* A = a.in[I_A] + b * m * n;
  const float* Ninv = a.in[I_NINV] + b * m * m;
  const float* hy = a.in[I_HY] + b * m;
  const float* gy = a.in[I_GY] + b * m;
  const float* hx = a.in[I_HX] + b * n;
  const float* gx = a.in[I_GX] + b * n;
  const float* maskx = a.in[I_MASKX] + b * n;
  float* x = a.out[O_X] + b * n;
  float* vx = a.out[O_VX] + b * n;

  const float rho_y = sc[S_RHOY], inv_gth1 = sc[S_IGTH], lam = sc[S_LAM];
  const float alpha = sc[S_ALPHA], thresh = sc[S_THRESH];
  const float oma = 1.0f - alpha;
  const int t_max = a.t_max[b];

  for (int j = tid; j < n; j += kThreads) {
    x[j] = a.in[I_X][b * n + j];
    vx[j] = a.in[I_VX][b * n + j];
  }
  float vy2[1] = {0.f};
  for (int i = tid; i < m; i += kThreads) {
    s_y[i] = a.in[I_Y][b * m + i];
    const float w = a.in[I_VY][b * m + i];
    s_vy[i] = w;
    vy2[0] += w * w;
  }
  block_sum(vy2, red);  // its barriers also publish s_y, s_vy
  float tau = sc[S_TAU0], kappa = sc[S_KAPPA0];

  // One ADMM iteration (`abip.c:539-584`, `:717-748`).
  auto step = [&]() {
    const float rtau = tau + kappa;
    float p[1] = {0.f};
    for (int i = tid; i < m; i += kThreads) {
      const float q = rho_y * (s_y[i] + s_vy[i]) - rtau * hy[i];
      s_qy[i] = q;
      p[0] += q * gy[i];
    }
    for (int j = tid; j < n; j += kThreads)
      p[0] += ((x[j] + vx[j]) - rtau * hx[j]) * gx[j];
    block_sum(p, red);
    const float coef = p[0] * inv_gth1;
    for (int j = tid; j < n; j += kThreads) {
      const float hj = hx[j];
      s_w[j] = -(((x[j] + vx[j]) - rtau * hj) - coef * hj);  // wx
    }
    for (int i = tid; i < m; i += kThreads) s_qy[i] -= coef * hy[i];
    __syncthreads();
    for (int i = warp; i < m; i += kWarps) {  // rhs = qy + A wx
      const float acc = row_dot(A + (size_t)i * n, s_w, n, lane);
      if (lane == 0) s_v[i] = s_qy[i] + acc;
    }
    __syncthreads();
    for (int i = warp; i < m; i += kWarps) {  // z_y = Ninv rhs
      const float acc = row_dot(Ninv + (size_t)i * m, s_v, m, lane);
      if (lane == 0) s_zy[i] = acc;
    }
    __syncthreads();
    p[0] = 0.f;
    for (int i = tid; i < m; i += kThreads) p[0] += s_zy[i] * hy[i];
    for (int j = tid; j < n; j += kThreads) {
      const float zx = col_dot(A, s_zy, m, n, j) - s_w[j];
      p[0] += zx * hx[j];
      const float rel = alpha * zx + oma * x[j];
      float xn = prox(rel - vx[j], lam);
      if (kStop) xn *= maskx[j];
      vx[j] = (vx[j] + xn) - rel;
      x[j] = xn;
    }
    block_sum(p, red);
    const float tau_t = rtau + p[0];
    for (int i = tid; i < m; i += kThreads) s_y[i] = s_zy[i] - s_vy[i];
    const float rel_tau = alpha * tau_t + oma * tau;
    const float tau_n = prox(rel_tau - kappa, lam);
    kappa = (kappa + tau_n) - rel_tau;
    tau = tau_n;
    __syncthreads();
  };

  // HSD-operator residual (`abip.c:1951-1996`; h = (-b; c))
  auto qres = [&]() -> float {
    for (int j = tid; j < n; j += kThreads) s_w[j] = x[j];
    __syncthreads();
    // p: |q1|^2, |q2|^2, <y,hy>+<x,hx>, |y|^2+|x|^2, |vx|^2
    float p[kRed] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = warp; i < m; i += kWarps) {
      const float acc = row_dot(A + (size_t)i * n, s_w, n, lane);
      if (lane == 0) {
        const float q1 = acc + tau * hy[i];
        p[0] += q1 * q1;
      }
    }
    for (int i = tid; i < m; i += kThreads) {
      const float y = s_y[i];
      p[2] += y * hy[i];
      p[3] += y * y;
    }
    for (int j = tid; j < n; j += kThreads) {
      const float xj = s_w[j], vxj = vx[j];
      const float q2 = ((col_dot(A, s_y, m, n, j) + vxj) - tau * hx[j]) * maskx[j];
      p[1] += q2 * q2;
      p[2] += xj * hx[j];
      p[3] += xj * xj;
      p[4] += vxj * vxj;
    }
    block_sum(p, red);
    const float q3 = -p[2] - kappa;
    const float qsq = (p[0] + p[1]) + q3 * q3;
    const float un = p[3] + tau * tau;
    const float vn = (vy2[0] + p[4]) + kappa * kappa;
    return sqrtf(qsq) / (1.0f + sqrtf(un + vn));
  };

  int t = 0;
  float q = INFINITY;
  if (kStop) {
    while (t < t_max && q >= thresh) {
      for (int it = 0; it < probe; ++it) step();
      t += probe;
      q = qres();
    }
  } else {
    for (; t < t_max; ++t) step();
  }

  for (int i = tid; i < m; i += kThreads) a.out[O_Y][b * m + i] = s_y[i];
  if (tid == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = tau; row[1] = kappa; row[2] = q; row[3] = (float)t;
  }
}

template <bool kStop>
int launch(void* const* in, void* const* out, int B, int m, int n, int probe,
           void* stream);

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) needs.
long long abip_sprint_smem_bytes(int m, int n) {
  return ((long long)n + 5LL * m + (long long)kWarps * kRed) * sizeof(float);
}

int abip_sprint_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launch one sprint over B lanes on `stream`; return the CUDA error code.
// in: the 12 f32 SprintOperands then t_max (int32, B); out: y, x, vx, row.
// All contiguous, lane-major.  `abip_sprint_stop` probes every `probe`
// iterations; `abip_sprint` ignores `probe`.
int abip_sprint_stop(void* const* in, void* const* out, int B, int m, int n,
                     int probe, void* stream) {
  return launch<true>(in, out, B, m, n, probe, stream);
}

int abip_sprint(void* const* in, void* const* out, int B, int m, int n,
                int probe, void* stream) {
  return launch<false>(in, out, B, m, n, probe, stream);
}

}  // extern "C"

namespace {

template <bool kStop>
int launch(void* const* in, void* const* out, int B, int m, int n, int probe,
           void* stream) {
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  a.m = m;
  a.n = n;
  a.probe = probe;
  const int smem = (int)abip_sprint_smem_bytes(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      sprint_kernel<kStop>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sprint_kernel<kStop><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
