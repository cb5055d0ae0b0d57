// Conic DR barrier ladder for Hopper (sm_90a): conic phase 1, one thread
// block per lane.
//
// Replaces the TPU kernel `_ladder_kernel_batched` of
// `abip_tpu/ops/conic_pallas.py` (Pallas, grid over lanes).  It computes what
// `abip_tpu_torch/ops/conic_dr.py:_dr_ladder_compute` computes: up to
// t_max[b] f32 Douglas-Rachford iterations of lane b -- projection with the
// quadratic-formula tau (`source/abip.c:186-254`), cone barrier prox
// (`cones.c:130-289`), dual update -- in trips of `probe` iterations at the
// current barrier mu.  After each trip the f32 inner criterion
// (`qcp_config.c:518-557`) and the f32 error ratio (`calc_qcp_residuals`)
// feed the `adjust_barrier` tables (`source/abip.c:994-1071`): when the
// criterion is met, (mu, tol) advance one stage.  The lane stops once
// mu < mu_stop or at t_max.
//
// Layout.  Block b owns lane b; the vectors of the iteration live in shared
// memory (~13 rows of m or n floats, 25 KB at m=340, n=1020).  Where a
// block's shared memory does not hold them, the spilled form keeps them in
// the lane's slice of a global workspace (`conic::dr_layout`), read alike.
// A lane's A (1.39 MB at that shape) and its explicit inverse G^-1 (m x m, Woodbury
// form) or S^-1 (n x n, primal form) stay in device memory and are read
// through L2.  Per iteration in the Woodbury form: A'wy, A t, G^-1 (A t),
// A'u and A zx, four A passes and one G^-1 pass; per trip four more A passes
// (the criterion and the error ratio).  The cone prox walks the SOC/RSOC
// blocks with one warp per block (head values from shared memory, the body
// sum of squares by warp reduction) into per-block scalars in shared memory,
// then applies them elementwise: no indicator-matrix products.  The
// iteration and the inner criterion are `conic::DrLane` (conic_common.cuh),
// which the sprint kernel (conic_sprint.cu) shares.
//
// What bounds it on this card: the A passes through L2 into ONE SM per lane,
// and occupancy (B=16 lanes busy 16 of the H100's 132 SMs).  Splitting a
// lane's A across a thread-block cluster is later work.

#include "conic_common.cuh"

using namespace conic;

namespace {

// ladder scal slots, `ops/conic_dr.py` L_*
enum {
  L_RHOY, L_RHOX, L_RHOT, L_ACOEF, L_MU, L_ALPHA, L_TAU, L_KAPPA, L_TOL, L_K0,
  L_MUSTOP, L_EPS, L_SCB, L_SCC, L_NMB, L_NMC, L_COUNT
};
// operand order of the C entry (LadderOperands, then t_max, then the cones)
enum {
  I_SCAL, I_A, I_MINV, I_HINV, I_RY, I_RX, I_B, I_C, I_QD, I_D, I_E, I_Y, I_X, I_VY,
  I_VX, I_TMAX, I_CODE, I_BLK, I_START, I_LEN, I_SOC, I_COUNT
};
enum { O_Y, O_X, O_VY, O_VX, O_ROW, O_COUNT };
constexpr int kRowWidth = 7;  // [tau, kappa, err, t_done, mu, tol, stages]

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  Cones cones;
  float* out[O_COUNT];
  float* work;  // spilled form: dr_work_floats floats per lane, else null
  int m, n, probe, woodbury;
  float psi;
};

// `adjust_barrier` (`source/abip.c:994-1071`) as f32 table walks; a ratio
// above 100 falls to 0.5 (the reference's quirk)
__device__ __forceinline__ void adjust_barrier(float mu, float err_ratio, float eps, float psi,
                                               float* mu_new, float* tol) {
  const float redges[14] = {5e-5f, 1e-4f, 5e-4f, 1e-3f, 5e-3f, 1e-2f, 5e-2f,
                            1e-1f, 0.5f,  1.0f,  5.0f,  10.0f, 50.0f, 100.0f};
  const float rvals[15] = {0.5f, 0.6f, 0.6f, 0.7f, 0.7f, 0.8f, 0.8f, 0.9f,
                           0.9f, 1.0f, 1.1f, 1.2f, 1.3f, 1.5f, 0.5f};
  const float medges[10] = {1.5f, 2.0f, 3.0f, 4.0f, 6.0f, 8.0f, 12.0f, 15.0f, 18.0f, 22.0f};
  const float gmul[11] = {2.4f, 2.6f, 2.8f, 3.2f, 3.4f, 3.4f, 3.6f, 3.8f, 4.0f, 4.2f, 4.4f};
  const float sigv[11] = {0.85f, 0.85f, 0.85f, 0.83f, 0.82f, 0.81f, 0.8f, 0.8f, 0.8f, 0.8f, 0.8f};
  const float ratio = mu / eps;
  float gamma = rvals[0];
#pragma unroll
  for (int k = 0; k < 14; ++k)
    if (ratio >= redges[k]) gamma = rvals[k + 1];
  float gm = gmul[0], sg = sigv[0];
#pragma unroll
  for (int k = 0; k < 10; ++k)
    if (err_ratio >= medges[k]) { gm = gmul[k + 1]; sg = sigv[k + 1]; }
  const float mn = sg * 0.2f * mu;
  *mu_new = mn;
  *tol = gamma * gm * (psi == 1.0f ? mn : powf(mn, psi));
}

// One lane, its vectors in shared memory or (kSpill) in its slice of the
// global workspace.
template <bool kSpill>
__device__ __forceinline__ void ladder_lane(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int mk = a.woodbury ? m : n;
  const float* sc = a.in[I_SCAL] + b * L_COUNT;

  DrLane L;
  L.op = {a.in[I_A] + b * m * n, a.in[I_MINV] + b * mk * mk, a.in[I_HINV] + b * n,
          a.in[I_RY] + b * m,    a.in[I_RX] + b * n,         a.in[I_B] + b * m,
          a.in[I_C] + b * n,     a.in[I_QD] + b * n};
  L.cn = a.cones;
  L.m = m;
  L.n = n;
  L.woodbury = a.woodbury != 0;
  L.rho_y = sc[L_RHOY];
  L.rho_x = sc[L_RHOX];
  L.rho_tau = sc[L_RHOT];
  L.a_coef = sc[L_ACOEF];
  L.alpha = sc[L_ALPHA];
  L.k0 = sc[L_K0];
  L.init(dr_layout<kSpill>(smem, a.work, m, n, a.cones.nb), a.in[I_Y] + b * m,
         a.in[I_X] + b * n, a.in[I_VY] + b * m, a.in[I_VX] + b * n, sc[L_TAU], sc[L_KAPPA]);
  float* s_y = L.s_y;
  float* s_wy = L.s_wy;  // y / tau
  float* s_x = L.s_x;
  float* s_vx = L.s_vx;
  float* s_t = L.s_t;    // x / tau
  float* red = L.red;

  const float* A = L.op.A;
  const float* bv = L.op.bv;
  const float* cv = L.op.cv;
  const float* qd = L.op.qd;
  const float* Dv = a.in[I_D] + b * m;
  const float* Ev = a.in[I_E] + b * n;
  const float rho_x = L.rho_x;
  const float mu_stop = sc[L_MUSTOP], eps = sc[L_EPS];
  const float sc_b = sc[L_SCB], sc_c = sc[L_SCC], nm_b = sc[L_NMB], nm_c = sc[L_NMC];
  const int t_max = a.t_max[b];
  float mu = sc[L_MU], tol = sc[L_TOL];

  // max(res / eps) of `calc_qcp_residuals` in f32
  auto error_ratio = [&]() -> float {
    const float tau_s = nan_max(fabsf(L.tau), 1e-18f);
    for (int k = tid; k < m; k += kThreads) s_wy[k] = s_y[k] / tau_s;
    for (int j = tid; j < n; j += kThreads) s_t[j] = s_x[j] / tau_s;
    __syncthreads();
    // mx: |D (Ax - b)|, |D Ax|, |E dres|, |E Qx|;  p: <b,ys>, <xs,Qx>, <c,xs>
    float mx[4] = {0.f, 0.f, 0.f, 0.f};
    float p[3] = {0.f, 0.f, 0.f};
    for (int k = warp; k < m; k += kWarps) {
      const float ax = row_dot(A + (size_t)k * n, s_t, n, lane);
      if (lane == 0) {
        mx[0] = nan_max(mx[0], fabsf(Dv[k] * (ax - bv[k])));
        mx[1] = nan_max(mx[1], fabsf(Dv[k] * ax));
      }
    }
    for (int k = tid; k < m; k += kThreads) p[0] += bv[k] * s_wy[k];
    for (int j = tid; j < n; j += kThreads) {
      const float xs = s_t[j];
      const float qx = qd[j] * xs;
      const float ss = rho_x * s_vx[j] / tau_s;
      const float dres = ((qx - col_dot(A, s_wy, m, n, j)) + cv[j]) - ss;
      mx[2] = nan_max(mx[2], fabsf(Ev[j] * dres));
      mx[3] = nan_max(mx[3], fabsf(Ev[j] * qx));
      p[1] += xs * qx;
      p[2] += cv[j] * xs;
    }
    block_max(mx, red);
    block_sum(p, red);
    const float res_pri = mx[0] / (sc_b + nan_max(mx[1], sc_b * nm_b));
    const float res_dual = mx[2] / (sc_c + nan_max(sc_c * nm_c, mx[3]));
    const float inv_bc = 1.0f / (sc_b * sc_c);
    const float xqx_2 = 0.5f * p[1] * inv_bc;
    const float ctx = p[2] * inv_bc, bty = p[0] * inv_bc;
    const float rel_gap = fabsf((2.0f * xqx_2 + ctx) - bty) /
                          (1.0f + nan_max(2.0f * xqx_2, nan_max(fabsf(ctx), fabsf(bty))));
    return nan_max(res_pri, nan_max(res_dual, rel_gap)) / eps;
  };

  // one flat loop of trips: `probe` iterations at the current mu, then the
  // criterion decides whether the barrier advances
  int t = 0, stages = 0;
  float e = INFINITY;
  while (t < t_max && mu >= mu_stop) {
    for (int it = 0; it < probe; ++it) L.step(mu, t + it);
    t += probe;
    e = L.err_inner();
    const float ratio = error_ratio();
    float mu2, tol2;
    adjust_barrier(mu, ratio, eps, a.psi, &mu2, &tol2);
    if (e < tol) {
      mu = mu2;
      tol = tol2;
      ++stages;
    }
  }

  L.store(a.out[O_Y] + b * m, a.out[O_X] + b * n, a.out[O_VY] + b * m, a.out[O_VX] + b * n);
  if (tid == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = L.tau; row[1] = L.kappa; row[2] = e; row[3] = (float)t;
    row[4] = mu; row[5] = tol; row[6] = (float)stages;
  }
}

// The two forms as kernels of their own, each bounded to one block of
// kThreads per SM: without the bound ptxas built K4's shared form with 32
// registers and spills, 1.7x slower on an H100.
__global__ void __launch_bounds__(kThreads, 1) conic_ladder_kernel(Args a) {
  ladder_lane<false>(a);
}
__global__ void __launch_bounds__(kThreads, 1) conic_ladder_spilled_kernel(Args a) {
  ladder_lane<true>(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) with nb cone blocks needs.
long long abip_conic_ladder_smem_bytes(int m, int n, int nb) {
  return dr_layout_floats(m, n, nb) * (long long)sizeof(float);
}

// Floats of global workspace per lane the spilled form needs.
long long abip_conic_ladder_work_floats(int m, int n, int nb) {
  return dr_work_floats(m, n, nb);
}

int abip_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the ladder over B lanes on `stream`; returns the CUDA error code.
// in: the 15 f32 LadderOperands, t_max (int32, B), then the int32 cone rows
// code, blk (n) and start, length, soc (nb); out: y, x, vy, vx, row.  All
// contiguous, lane-major.  work: B * abip_conic_ladder_work_floats(m, n, nb)
// floats for the spilled form, where a block's shared memory does not hold
// the lane's layout; null otherwise.
int abip_conic_ladder(void* const* in, void* const* out, void* work, int B, int m, int n, int nb,
                      int probe, float psi, int woodbury, void* stream) {
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
  a.psi = psi;
  a.work = static_cast<float*>(work);
  return work ? dr_launch(conic_ladder_spilled_kernel, a, B, work, stream)
              : dr_launch(conic_ladder_kernel, a, B, work, stream);
}

}  // extern "C"
