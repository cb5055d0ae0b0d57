// Conic DR barrier ladder for Hopper (sm_90a): conic phase 1, one
// thread-block cluster per lane.
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
// Layout and exchanges are `conic_cluster::ClusterDrLane`'s
// (csrc/conic_cluster.cuh), shared with the sprint (csrc/conic_sprint.cu):
// lane b is cluster b of C CTAs (launched with cudaLaunchKernelEx; C and the
// residency from `ops/conic_dr.py:dr_launch_plan`), each owning a column
// slice of A, resident in its shared memory where it fits; three cluster
// exchanges per Woodbury iteration; a probe's criterion and error ratio
// share one exchange (A x and A (x / tau) with the x side's sums and maxes).
// Every CTA takes the barrier decision on the same bits.
//
// What bounds it on this card: latency, not HBM: per iteration four passes
// over A's slice, one over the CTA's rows of G^-1, three cluster barriers
// with their rounds of remote loads, and the dependent chain of the tau
// quadratic and the cone prox.

#include "conic_cluster.cuh"

using namespace conic_cluster;

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
  float* out[O_COUNT];
  DrShape sh;
  int probe;
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

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1) conic_ladder_cluster_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int m = a.sh.m, n = a.sh.n, probe = a.probe;
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const size_t b = blockIdx.x / C;
  const int mk = a.sh.woodbury ? m : n;
  const float* sc = a.in[I_SCAL] + b * L_COUNT;
  const DrRows rows = {a.in[I_A] + b * m * n, a.in[I_MINV] + b * mk * mk, a.in[I_HINV] + b * n,
                       a.in[I_RY] + b * m,    a.in[I_RX] + b * n,         a.in[I_B] + b * m,
                       a.in[I_C] + b * n,     a.in[I_QD] + b * n,         a.in[I_D] + b * m,
                       a.in[I_E] + b * n};

  ClusterDrLane<kForm> L;
  L.rho_y = sc[L_RHOY];
  L.rho_x = sc[L_RHOX];
  L.rho_tau = sc[L_RHOT];
  L.a_coef = sc[L_ACOEF];
  L.alpha = sc[L_ALPHA];
  L.k0 = sc[L_K0];
  L.init(smem, a.sh, rows, a.in[I_Y] + b * m, a.in[I_X] + b * n, a.in[I_VY] + b * m,
         a.in[I_VX] + b * n, sc[L_TAU], sc[L_KAPPA]);
  const RatioScal rs = {sc[L_SCB], sc[L_SCC], sc[L_NMB], sc[L_NMC], sc[L_EPS]};
  const float mu_stop = sc[L_MUSTOP], eps = sc[L_EPS];
  const int t_max = a.t_max[b];
  float mu = sc[L_MU], tol = sc[L_TOL];

  // one flat loop of trips: `probe` iterations at the current mu, then the
  // criterion decides whether the barrier advances (alike in every CTA)
  int t = 0, stages = 0;
  float e = INFINITY;
  while (t < t_max && mu >= mu_stop) {
    for (int it = 0; it < probe; ++it) L.step(mu, t + it);
    t += probe;
    float ratio;
    e = L.template probe<true>(rs, &ratio);
    float mu2, tol2;
    adjust_barrier(mu, ratio, eps, a.psi, &mu2, &tol2);
    if (e < tol) {
      mu = mu2;
      tol = tol2;
      ++stages;
    }
  }

  L.store(a.out[O_Y] + b * m, a.out[O_X] + b * n, a.out[O_VY] + b * m, a.out[O_VX] + b * n);
  if (L.rank == 0 && threadIdx.x == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = L.tau; row[1] = L.kappa; row[2] = e; row[3] = (float)t;
    row[4] = mu; row[5] = tol; row[6] = (float)stages;
  }
  // no CTA leaves while another may still read its shared memory
  cluster_ops::sync();
}

// the kernel of (resident, spill)
inline void (*kernel_of(int resident, int spill))(Args) {
  switch (cluster_ops::form_of(resident, spill)) {
    case cluster_ops::kResident: return conic_ladder_cluster_kernel<cluster_ops::kResident>;
    case cluster_ops::kStreaming: return conic_ladder_cluster_kernel<cluster_ops::kStreaming>;
    default: return conic_ladder_cluster_kernel<cluster_ops::kSpilled>;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for shape (m, n) with nb cone blocks in
// clusters of C CTAs, A's slice and the operands resident or not (0 spilled).
long long abip_conic_ladder_smem_bytes(int m, int n, int nb, int C, int resident, int woodbury,
                                       int spill) {
  return dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
}

// Floats of global workspace per CTA the streaming or spilled form needs.
long long abip_conic_ladder_work_floats(int m, int n, int nb, int woodbury, int C, int spill) {
  return dr_work_floats(m, n, nb, cluster_ops::cols_per_cta(n, C), woodbury != 0, spill != 0);
}

int abip_row_width() { return kRowWidth; }

int abip_conic_ladder_threads() { return kThreads; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How many clusters of C CTAs of this shape and form the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
int abip_conic_ladder_max_active_clusters(int m, int n, int nb, int C, int resident,
                                          int woodbury, int spill, int* clusters) {
  const int smem = (int)dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::max_active<kThreads>(kernel_of(resident, spill), C, smem, clusters);
}

// Launches the ladder over B lanes, one cluster of C CTAs per lane, on
// `stream`; returns the CUDA error code.  in: the 15 f32 LadderOperands,
// t_max (int32, B), then the int32 cone rows code, blk (n) and start,
// length, soc (nb); out: y, x, vy, vx, row.  All contiguous, lane-major.
// work: B * C * abip_conic_ladder_work_floats(...) floats, 16-byte aligned,
// for the streaming and spilled forms (unused when resident).
int abip_conic_ladder(void* const* in, void* const* out, void* work, int B, int m, int n, int nb,
                      int probe, float psi, int woodbury, int C, int resident, int spill,
                      void* stream) {
  if (C < 1 || C > cluster_ops::kMaxCluster || (!resident && work == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  spill = spill != 0 && !resident;
  a.sh = dr_shape(in + I_CODE, work, m, n, nb, C, woodbury, spill != 0);
  a.probe = probe;
  a.psi = psi;
  const int smem = (int)dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::launch<kThreads>(kernel_of(resident, spill), a, B, C, smem, stream);
}

}  // extern "C"
