// Conic DR sprint for Hopper (sm_90a): up to T f32 iterations at one barrier,
// stopping on the inner criterion, one thread block per lane.
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
// Layout, residency and bound are the ladder's (csrc/conic_ladder.cu): the
// iteration and the criterion are `conic::DrLane` of conic_common.cuh; the
// vectors in shared memory (spilled: a global workspace), A and G^-1
// (Woodbury) or S^-1 (primal) read
// through L2, four A passes and one G^-1 pass per Woodbury iteration and two
// more A passes per trip.  The A passes through L2 into ONE SM per lane bound
// it, with B=16 lanes busy on 16 of the H100's 132 SMs.

#include "conic_common.cuh"

using namespace conic;

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
  Cones cones;
  float* out[O_COUNT];
  float* work;  // spilled form: dr_work_floats floats per lane, else null
  int m, n, probe, woodbury;
};

// One lane, its vectors in shared memory or (kSpill) in its slice of the
// global workspace.
template <bool kSpill>
__device__ __forceinline__ void sprint_lane(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe;
  const size_t b = blockIdx.x;
  const int mk = a.woodbury ? m : n;
  const float* sc = a.in[I_SCAL] + b * C_COUNT;

  DrLane L;
  L.op = {a.in[I_A] + b * m * n, a.in[I_MINV] + b * mk * mk, a.in[I_HINV] + b * n,
          a.in[I_RY] + b * m,    a.in[I_RX] + b * n,         a.in[I_B] + b * m,
          a.in[I_C] + b * n,     a.in[I_QD] + b * n};
  L.cn = a.cones;
  L.m = m;
  L.n = n;
  L.woodbury = a.woodbury != 0;
  L.rho_y = sc[C_RHOY];
  L.rho_x = sc[C_RHOX];
  L.rho_tau = sc[C_RHOT];
  L.a_coef = sc[C_ACOEF];
  L.alpha = sc[C_ALPHA];
  L.k0 = sc[C_K0];
  L.init(dr_layout<kSpill>(smem, a.work, m, n, a.cones.nb), a.in[I_Y] + b * m,
         a.in[I_X] + b * n, a.in[I_VY] + b * m, a.in[I_VX] + b * n, sc[C_TAU], sc[C_KAPPA]);
  const float lam = sc[C_LAM], thresh = sc[C_THRESH];
  const int t_max = a.t_max[b];

  int t = 0;
  float e = INFINITY;
  while (t < t_max && e >= thresh) {
    for (int it = 0; it < probe; ++it) L.step(lam, t + it);
    t += probe;
    e = L.err_inner();
  }

  L.store(a.out[O_Y] + b * m, a.out[O_X] + b * n, a.out[O_VY] + b * m, a.out[O_VX] + b * n);
  if (threadIdx.x == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = L.tau; row[1] = L.kappa; row[2] = e; row[3] = (float)t;
  }
}

// The two forms as kernels of their own, each bounded to one block of
// kThreads per SM: without the bound ptxas built K4's shared form with 32
// registers and spills, 1.7x slower on an H100.
__global__ void __launch_bounds__(kThreads, 1) conic_sprint_kernel(Args a) {
  sprint_lane<false>(a);
}
__global__ void __launch_bounds__(kThreads, 1) conic_sprint_spilled_kernel(Args a) {
  sprint_lane<true>(a);
}

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) with nb cone blocks needs.
long long abip_conic_sprint_smem_bytes(int m, int n, int nb) {
  return dr_layout_floats(m, n, nb) * (long long)sizeof(float);
}

// Floats of global workspace per lane the spilled form needs.
long long abip_conic_sprint_work_floats(int m, int n, int nb) {
  return dr_work_floats(m, n, nb);
}

int abip_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the sprint over B lanes on `stream`; returns the CUDA error code.
// in: the 13 f32 DrSprintOperands, t_max (int32, B), then the int32 cone rows
// code, blk (n) and start, length, soc (nb); out: y, x, vy, vx, row.  All
// contiguous, lane-major.  work: B * abip_conic_sprint_work_floats(m, n, nb)
// floats for the spilled form, where a block's shared memory does not hold
// the lane's layout; null otherwise.  `psi` is not used (the barrier is fixed).
int abip_conic_sprint(void* const* in, void* const* out, void* work, int B, int m, int n, int nb,
                      int probe, float psi, int woodbury, void* stream) {
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
  a.work = static_cast<float*>(work);
  return work ? dr_launch(conic_sprint_spilled_kernel, a, B, work, stream)
              : dr_launch(conic_sprint_kernel, a, B, work, stream);
}

}  // extern "C"
