// Anchored-delta LP ADMM chunk for Hopper (sm_90a), one thread block per lane.
//
// Replaces the TPU kernel `_delta_kernel_batched` of
// `abip_tpu/ops/admm_delta.py` (Pallas, grid over lanes).  It computes what
// `abip_tpu_torch/ops/admm_delta.py:_delta_compute` computes: up to t_max[b]
// f32 ADMM iterations in the delta frame of an f64 anchor, with the
// delta-frame inner criterion probed every `probe` iterations on the current
// and the averaged iterate, and each lane stopping on its own threshold.
//
// Layout.  Block b owns lane b.  Thread `tid` owns the x-side coordinates
// j = tid, tid + 1024, ...; their deltas and delta sums (dx, dvx, dsx, dsvx)
// live in the output buffers and are only ever touched by their owner, so no
// thread reads another's x-state.  The m-length state (dy, dsy) and the
// scratch vectors live in shared memory, together with one n-length vector
// (the x-side operand of the row dots).  A (m x n) and Ninv (m x m) stay in
// device memory and are read through L2: a lane's A is 400 KB at the smoke
// shape (m=50, n=2000), beyond the 227 KB of shared memory a block can have,
// while all 16 lanes' A (6.4 MB) sit in the 50 MB L2.
//
// Per iteration A is read twice: A*dwx as one warp per row (coalesced, the
// operand from shared memory) and A'*dz_y as one thread per column.  A probe
// reads A four more times.  These are products with one vector, so there is
// no tensor-core work.  Block-wide sums go through warp shuffles and shared
// memory, and every thread folds the per-warp partials in the same order, so
// all threads hold bit-identical sums and take the same stop decision.
//
// What bounds it on this card: the A passes through L2, about 2.5 per
// iteration (~1 MB per lane at the smoke shape) into ONE SM per lane, and
// occupancy, since B=16 lanes busy only 16 of the H100's 132 SMs.  At the
// smoke shape an iteration takes ~22 us, ~45 GB/s into the SM.  1024 threads
// per block hide L2 latency better than 512 (1.5x); more loads in flight per
// thread, `__restrict__`, or the x-state in shared memory gained nothing
// further worth keeping.  Splitting a lane's A across a thread-block
// cluster's distributed shared memory, so that it is read from SMEM instead
// of L2 and more SMs work per lane, is later work.
//
// Numerics: plain IEEE f32 `sqrtf` and `/` (build without -use_fast_math);
// the cancellation-free prox delta is only accurate with correctly rounded
// square root and division.  FMA contraction is allowed.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 7;  // widest block reduction: the probe's 7 sums

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
  int m, n, probe;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each v[k] over the block; every thread gets the same bits.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * K + k];
    v[k] = s;
  }
  __syncthreads();
}

// sum_j Mi[j] * w[j] over one row, by one warp; all lanes get the sum
__device__ __forceinline__ float row_dot(const float* __restrict__ Mi,
                                         const float* w, int n, int lane) {
  float acc = 0.f;
  for (int j = lane; j < n; j += 32) acc += __ldg(Mi + j) * w[j];
  return warp_sum(acc);
}

// sum_i M[i, j] * y[i] down one column, by one thread
__device__ __forceinline__ float col_dot(const float* __restrict__ M,
                                         const float* y, int m, int n, int j) {
  float acc = 0.f;
  for (int i = 0; i < m; ++i) acc += __ldg(M + (size_t)i * n + j) * y[i];
  return acc;
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

__global__ void __launch_bounds__(kThreads)
delta_chunk_kernel(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;

  float* s_w = smem;        // n: x-side operand of the row dots
  float* s_dy = s_w + n;    // m: y deltas
  float* s_dsy = s_dy + m;  // m: y delta sums
  float* s_dqy = s_dsy + m; // m: projected y rhs
  float* s_v = s_dqy + m;   // m: Ninv rhs, then y-side operand of column dots
  float* s_zy = s_v + m;    // m: dz_y
  float* red = s_zy + m;    // kWarps * kRed

  const float* sc = a.in[I_SCAL] + b * S_COUNT;
  const float* A = a.in[I_A] + b * m * n;
  const float* Ninv = a.in[I_NINV] + b * m * m;
  const float* hy = a.in[I_HY] + b * m;
  const float* gy = a.in[I_GY] + b * m;
  const float* ey = a.in[I_EY] + b * m;
  const float* q10 = a.in[I_Q10] + b * m;
  const float* y0 = a.in[I_Y0] + b * m;
  const float* c0y = a.in[I_C0Y] + b * m;
  const float* hx = a.in[I_HX] + b * n;
  const float* gx = a.in[I_GX] + b * n;
  const float* maskx = a.in[I_MASKX] + b * n;
  const float* ex = a.in[I_EX] + b * n;
  const float* evx = a.in[I_EVX] + b * n;
  const float* t0x = a.in[I_T0X] + b * n;
  const float* sax = a.in[I_SAX] + b * n;
  const float* etx = a.in[I_ETX] + b * n;
  const float* q20 = a.in[I_Q20] + b * n;
  const float* x0 = a.in[I_X0] + b * n;
  const float* vx0 = a.in[I_VX0] + b * n;
  const float* c0x = a.in[I_C0X] + b * n;
  const float* c0vx = a.in[I_C0VX] + b * n;
  float* dx = a.out[O_DX] + b * n;
  float* dvx = a.out[O_DVX] + b * n;
  float* dsx = a.out[O_DSX] + b * n;
  float* dsvx = a.out[O_DSVX] + b * n;

  const float rho_y = sc[S_RHOY], inv_gth1 = sc[S_IGTH], lam = sc[S_LAM];
  const float alpha = sc[S_ALPHA], thresh = sc[S_THRESH];
  const float tau0 = sc[S_TAU0], kappa0 = sc[S_KAPPA0];
  const float t0t = sc[S_T0T], sat = sc[S_SAT], ett = sc[S_ETT];
  const float etau = sc[S_ETAU], evtau = sc[S_EVTAU], q30 = sc[S_Q30];
  const float un0 = sc[S_UN0], vn0 = sc[S_VN0], sj_prev = sc[S_SJ];
  const float c0tau = sc[S_C0TAU], c0kap = sc[S_C0KAP];
  const float one_m_alpha = 1.0f - alpha;
  const int t_max = a.t_max[b];

  for (int j = tid; j < n; j += kThreads) {
    dx[j] = 0.f; dvx[j] = 0.f; dsx[j] = 0.f; dsvx[j] = 0.f;
  }
  for (int i = tid; i < m; i += kThreads) { s_dy[i] = 0.f; s_dsy[i] = 0.f; }
  float dtau = 0.f, dkap = 0.f, dstau = 0.f, dskap = 0.f;
  __syncthreads();

  // One ADMM iteration on the deltas (`abip.c:539-584`, `:717-748`).
  auto step = [&]() {
    const float drtau = dtau + dkap;
    float p[1] = {0.f};
    for (int i = tid; i < m; i += kThreads) {
      const float q = rho_y * s_dy[i] - drtau * hy[i];
      s_dqy[i] = q;
      p[0] += q * gy[i];
    }
    for (int j = tid; j < n; j += kThreads)
      p[0] += ((dx[j] + dvx[j]) - drtau * hx[j]) * gx[j];
    block_sum(p, red);
    const float dcoef = p[0] * inv_gth1;
    for (int j = tid; j < n; j += kThreads) {
      const float hj = hx[j];
      s_w[j] = -(((dx[j] + dvx[j]) - drtau * hj) - dcoef * hj);  // dwx
    }
    for (int i = tid; i < m; i += kThreads) s_dqy[i] -= dcoef * hy[i];
    __syncthreads();
    for (int i = warp; i < m; i += kWarps) {  // drhs = dqy + A dwx
      const float acc = row_dot(A + (size_t)i * n, s_w, n, lane);
      if (lane == 0) s_v[i] = s_dqy[i] + acc;
    }
    __syncthreads();
    for (int i = warp; i < m; i += kWarps) {  // dz_y = Ninv drhs
      const float acc = row_dot(Ninv + (size_t)i * m, s_v, m, lane);
      if (lane == 0) s_zy[i] = acc;
    }
    __syncthreads();
    p[0] = 0.f;
    for (int i = tid; i < m; i += kThreads) p[0] += s_zy[i] * hy[i];
    for (int j = tid; j < n; j += kThreads) {
      const float dzx = col_dot(A, s_zy, m, n, j) - s_w[j];
      p[0] += dzx * hx[j];
      const float dxj = dx[j], dvxj = dvx[j];
      const float drel = alpha * dzx + one_m_alpha * dxj;
      const float dt = (drel - dvxj) + etx[j];
      const float px = prox_delta(dt, t0x[j], sax[j], lam) * maskx[j];
      const float dxn = ex[j] + px;
      const float dvxn = ((dvxj + dxn) - drel) + evx[j];
      dx[j] = dxn;
      dvx[j] = dvxn;
      dsx[j] += dxn;
      dsvx[j] += dvxn;
    }
    block_sum(p, red);
    const float dtau_t = drtau + p[0];
    for (int i = tid; i < m; i += kThreads) {
      const float ny = ey[i] + s_zy[i];
      s_dy[i] = ny;
      s_dsy[i] += ny;
    }
    const float drel_t = alpha * dtau_t + one_m_alpha * dtau;
    const float dtt = (drel_t - dkap) + ett;
    const float dtau_n = etau + prox_delta(dtt, t0t, sat, lam);
    const float dkap_n = ((dkap + dtau_n) - drel_t) + evtau;
    dtau = dtau_n;
    dkap = dkap_n;
    dstau += dtau_n;
    dskap += dkap_n;
  };

  // HSD-operator residual at anchor + delta (`abip.c:1951-1996`), of the
  // current iterate or of the stage average with divisor `dom`.
  auto qres_delta = [&](bool avg, float dom) -> float {
    const float at = avg ? (c0tau + dstau) / dom : dtau;
    const float ak = avg ? (c0kap + dskap) / dom : dkap;
    for (int j = tid; j < n; j += kThreads)
      s_w[j] = avg ? (c0x[j] + dsx[j]) / dom : dx[j];
    for (int i = tid; i < m; i += kThreads)
      s_v[i] = avg ? (c0y[i] + s_dsy[i]) / dom : s_dy[i];
    __syncthreads();
    // p: |q1|^2, |q2|^2, <y,hy>+<x,hx>, <y0,y>+<x0,x>, |y|^2+|x|^2,
    //    <vx0,vx>, |vx|^2
    float p[kRed] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = warp; i < m; i += kWarps) {
      const float acc = row_dot(A + (size_t)i * n, s_w, n, lane);
      if (lane == 0) {
        const float q1 = (q10[i] + acc) + at * hy[i];
        p[0] += q1 * q1;
      }
    }
    for (int i = tid; i < m; i += kThreads) {
      const float ay = s_v[i];
      p[2] += ay * hy[i];
      p[3] += y0[i] * ay;
      p[4] += ay * ay;
    }
    for (int j = tid; j < n; j += kThreads) {
      const float ax = s_w[j];
      const float avx = avg ? (c0vx[j] + dsvx[j]) / dom : dvx[j];
      const float q2 =
          q20[j] + ((col_dot(A, s_v, m, n, j) + avx) - at * hx[j]) * maskx[j];
      p[1] += q2 * q2;
      p[2] += ax * hx[j];
      p[3] += x0[j] * ax;
      p[4] += ax * ax;
      p[5] += vx0[j] * avx;
      p[6] += avx * avx;
    }
    block_sum(p, red);
    const float q3 = (q30 - p[2]) - ak;
    const float qsq = (p[0] + p[1]) + q3 * q3;
    const float un = ((un0 + 2.0f * (p[3] + tau0 * at)) + p[4]) + at * at;
    const float vn = ((vn0 + 2.0f * (p[5] + kappa0 * ak)) + p[6]) + ak * ak;
    float nrm = un + vn;
    nrm = (nrm < 0.f) ? 0.f : nrm;  // max(., 0) that keeps a NaN
    return sqrtf(qsq) / (1.0f + sqrtf(nrm));
  };

  int t = 0;
  float q = sc[S_QINIT], avg_crit = 0.f;
  while (t < t_max && q >= thresh) {
    for (int it = 0; it < probe; ++it) step();
    t += probe;
    const float dom = fmaxf(sj_prev + (float)t, 1.0f);
    const float q_cur = qres_delta(false, dom);
    const float q_avg = qres_delta(true, dom);
    avg_crit = (q_avg < q_cur) ? 1.f : 0.f;
    q = (q_avg != q_avg || q_cur != q_cur) ? q_avg + q_cur
                                           : fminf(q_avg, q_cur);
  }

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

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) needs.
long long abip_delta_smem_bytes(int m, int n) {
  return ((long long)n + 5LL * m + (long long)kWarps * kRed) * sizeof(float);
}

int abip_delta_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches one chunk over B lanes on `stream`; returns the CUDA error code.
// in: the 22 f32 DeltaAnchor operands then t_max (int32, B); out: dy, dx,
// dvx, dsy, dsx, dsvx, row.  All contiguous, lane-major.
int abip_delta_chunk(void* const* in, void* const* out, int B, int m, int n,
                     int probe, void* stream) {
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  a.m = m;
  a.n = n;
  a.probe = probe;
  const int smem = (int)abip_delta_smem_bytes(m, n);
  cudaError_t err = cudaFuncSetAttribute(
      delta_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  delta_chunk_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
