// Conic DR sprint for Hopper (sm_90a): up to T f32 iterations at one barrier,
// stopping on the inner criterion, one thread-block cluster per lane.
//
// Replaces the TPU kernel `_dr_kernel_batched` of
// `abip_tpu/ops/conic_pallas.py` (Pallas, grid over lanes; entry
// `fused_dr_sprint_stop`).  It computes what
// `abip_tpu_torch/ops/conic_dr.py:_dr_sprint_compute` computes: trips of
// `probe` f32 Douglas-Rachford iterations of lane b at its fixed barrier lam
// -- projection with the quadratic-formula tau (`source/abip.c:186-254`),
// cone barrier prox (`cones.c:130-289`), dual update -- each followed by the
// f32 inner criterion (`qcp_config.c:518-557`), while t < t_max[b] and
// err >= thresh.  The first iteration ever (k0 + i == 0) takes tau_t = 1.
//
// Layout and exchanges are `conic_cluster::ClusterDrLane`'s
// (csrc/conic_cluster.cuh), shared with the ladder (csrc/conic_ladder.cu):
// lane b is cluster b of C CTAs (launched with cudaLaunchKernelEx; C and the
// residency from `ops/conic_dr.py:dr_launch_plan`), each owning a column
// slice of A, resident in its shared memory where it fits; three cluster
// exchanges per Woodbury iteration, one per probe.  Every CTA takes the
// stop decision on the same bits.
//
// What bounds it on this card: latency, not HBM: per iteration four passes
// over A's slice (shared memory or L2), one over the CTA's rows of G^-1
// (L2), three cluster barriers with their rounds of remote loads, and the
// dependent chain of the tau quadratic and the cone prox.

#include "conic_cluster.cuh"

using namespace conic_cluster;

namespace {

// sprint scal slots, `ops/conic_dr.py` C_*
enum {
  C_RHOY, C_RHOX, C_RHOT, C_ACOEF, C_LAM, C_ALPHA, C_TAU, C_KAPPA, C_THRESH, C_K0,
  C_COUNT
};
// operand order of the C entry (DrSprintOperands, then t_max, then the cones)
enum {
  I_SCAL, I_A, I_MINV, I_HINV, I_RY, I_RX, I_B, I_C, I_QD, I_Y, I_X, I_VY, I_VX, I_TMAX,
  I_CODE, I_BLK, I_START, I_LEN, I_SOC, I_COUNT
};
enum { O_Y, O_X, O_VY, O_VX, O_ROW, O_COUNT };
constexpr int kRowWidth = 4;  // [tau, kappa, err, t_done]

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  float* out[O_COUNT];
  DrShape sh;
  int probe;
};

template <int kForm>
__global__ void __launch_bounds__(kThreads, 1) conic_sprint_cluster_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int m = a.sh.m, n = a.sh.n, probe = a.probe;
  const int C = (int)cooperative_groups::this_cluster().num_blocks();
  const size_t b = blockIdx.x / C;
  const int mk = a.sh.woodbury ? m : n;
  const float* sc = a.in[I_SCAL] + b * C_COUNT;
  const DrRows rows = {a.in[I_A] + b * m * n, a.in[I_MINV] + b * mk * mk, a.in[I_HINV] + b * n,
                       a.in[I_RY] + b * m,    a.in[I_RX] + b * n,         a.in[I_B] + b * m,
                       a.in[I_C] + b * n,     a.in[I_QD] + b * n,         nullptr,
                       nullptr};

  ClusterDrLane<kForm> L;
  L.rho_y = sc[C_RHOY];
  L.rho_x = sc[C_RHOX];
  L.rho_tau = sc[C_RHOT];
  L.a_coef = sc[C_ACOEF];
  L.alpha = sc[C_ALPHA];
  L.k0 = sc[C_K0];
  L.init(smem, a.sh, rows, a.in[I_Y] + b * m, a.in[I_X] + b * n, a.in[I_VY] + b * m,
         a.in[I_VX] + b * n, sc[C_TAU], sc[C_KAPPA]);
  const float lam = sc[C_LAM], thresh = sc[C_THRESH];
  const int t_max = a.t_max[b];
  const RatioScal none = {};

  int t = 0;
  float e = INFINITY;
  while (t < t_max && e >= thresh) {  // the same decision in every CTA
    for (int it = 0; it < probe; ++it) L.step(lam, t + it);
    t += probe;
    e = L.template probe<false>(none, nullptr);
  }

  L.store(a.out[O_Y] + b * m, a.out[O_X] + b * n, a.out[O_VY] + b * m, a.out[O_VX] + b * n);
  if (L.rank == 0 && threadIdx.x == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = L.tau; row[1] = L.kappa; row[2] = e; row[3] = (float)t;
  }
  // no CTA leaves while another may still read its shared memory
  cluster_ops::sync();
}

// the kernel of (resident, spill)
inline void (*kernel_of(int resident, int spill))(Args) {
  switch (cluster_ops::form_of(resident, spill)) {
    case cluster_ops::kResident: return conic_sprint_cluster_kernel<cluster_ops::kResident>;
    case cluster_ops::kStreaming: return conic_sprint_cluster_kernel<cluster_ops::kStreaming>;
    default: return conic_sprint_cluster_kernel<cluster_ops::kSpilled>;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for shape (m, n) with nb cone blocks in
// clusters of C CTAs, A's slice and the operands resident or not (0 spilled).
long long abip_conic_sprint_smem_bytes(int m, int n, int nb, int C, int resident, int woodbury,
                                       int spill) {
  return dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
}

// Floats of global workspace per CTA the streaming or spilled form needs.
long long abip_conic_sprint_work_floats(int m, int n, int nb, int woodbury, int C, int spill) {
  return dr_work_floats(m, n, nb, cluster_ops::cols_per_cta(n, C), woodbury != 0, spill != 0);
}

int abip_row_width() { return kRowWidth; }

int abip_conic_sprint_threads() { return kThreads; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// How many clusters of C CTAs of this shape and form the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
int abip_conic_sprint_max_active_clusters(int m, int n, int nb, int C, int resident,
                                          int woodbury, int spill, int* clusters) {
  const int smem = (int)dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::max_active<kThreads>(kernel_of(resident, spill), C, smem, clusters);
}

// Launches the sprint over B lanes, one cluster of C CTAs per lane, on
// `stream`; returns the CUDA error code.  in: the 13 f32 DrSprintOperands,
// t_max (int32, B), then the int32 cone rows code, blk (n) and start,
// length, soc (nb); out: y, x, vy, vx, row.  All contiguous, lane-major.
// work: B * C * abip_conic_sprint_work_floats(...) floats, 16-byte aligned,
// for the streaming and spilled forms (unused when resident).  `psi` is not
// used (the barrier is fixed).
int abip_conic_sprint(void* const* in, void* const* out, void* work, int B, int m, int n, int nb,
                      int probe, float psi, int woodbury, int C, int resident, int spill,
                      void* stream) {
  (void)psi;
  if (C < 1 || C > cluster_ops::kMaxCluster || (!resident && work == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  for (int k = 0; k < I_TMAX; ++k) a.in[k] = static_cast<const float*>(in[k]);
  a.t_max = static_cast<const int*>(in[I_TMAX]);
  for (int k = 0; k < O_COUNT; ++k) a.out[k] = static_cast<float*>(out[k]);
  spill = spill != 0 && !resident;
  a.sh = dr_shape(in + I_CODE, work, m, n, nb, C, woodbury, spill != 0);
  a.probe = probe;
  const int smem = (int)dr_smem_bytes(m, n, nb, C, resident, woodbury, spill);
  return cluster_ops::launch<kThreads>(kernel_of(resident, spill), a, B, C, smem, stream);
}

}  // extern "C"
