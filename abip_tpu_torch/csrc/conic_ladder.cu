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
// memory (~13 rows of m or n floats, 25 KB at m=340, n=1020).  A lane's A
// (1.39 MB at that shape) and its explicit inverse G^-1 (m x m, Woodbury
// form) or S^-1 (n x n, primal form) stay in device memory and are read
// through L2.  Per iteration in the Woodbury form: A'wy, A t, G^-1 (A t),
// A'u and A zx, four A passes and one G^-1 pass; per trip four more A passes
// (the criterion and the error ratio).  The cone prox walks the SOC/RSOC
// blocks with one warp per block (head values from shared memory, the body
// sum of squares by warp reduction) into per-block scalars in shared memory,
// then applies them elementwise: no indicator-matrix products.
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
constexpr int kRed = 6;       // widest block reduction

struct Args {
  const float* in[I_TMAX];
  const int* t_max;
  Cones cones;
  float* out[O_COUNT];
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

__global__ void __launch_bounds__(kThreads) conic_ladder_kernel(Args a) {
  extern __shared__ float smem[];
  const int m = a.m, n = a.n, probe = a.probe, nb = a.cones.nb;
  const bool woodbury = a.woodbury != 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const int mk = woodbury ? m : n;

  float* s_y = smem;         // m: y
  float* s_vy = s_y + m;     // m: vy
  float* s_wy = s_vy + m;    // m: wy, then y / tau (error ratio)
  float* s_at = s_wy + m;    // m: A t
  float* s_u = s_at + m;     // m: G^-1 A t
  float* s_zy = s_u + m;     // m: zy
  float* s_x = s_zy + m;     // n: x
  float* s_vx = s_x + n;     // n: vx
  float* s_t = s_vx + n;     // n: rhs or t, then the prox argument tx, then x / tau
  float* s_zx = s_t + n;     // n: zx, then rel_x
  float* s_bh1 = s_zx + n;   // nb: per-block head value
  float* s_bh2 = s_bh1 + nb; // nb: RSOC second head
  float* s_bsc = s_bh2 + nb; // nb: body scale
  float* red = s_bsc + nb;   // kWarps * kRed

  const float* sc = a.in[I_SCAL] + b * L_COUNT;
  const float* A = a.in[I_A] + b * m * n;
  const float* Minv = a.in[I_MINV] + b * mk * mk;
  const float* hinv = a.in[I_HINV] + b * n;
  const float* ry = a.in[I_RY] + b * m;
  const float* rx = a.in[I_RX] + b * n;
  const float* bv = a.in[I_B] + b * m;
  const float* cv = a.in[I_C] + b * n;
  const float* qd = a.in[I_QD] + b * n;
  const float* Dv = a.in[I_D] + b * m;
  const float* Ev = a.in[I_E] + b * n;
  const Cones& cn = a.cones;

  const float rho_y = sc[L_RHOY], rho_x = sc[L_RHOX], rho_tau = sc[L_RHOT];
  const float a_coef = sc[L_ACOEF], alpha = sc[L_ALPHA], k0 = sc[L_K0];
  const float mu_stop = sc[L_MUSTOP], eps = sc[L_EPS];
  const float sc_b = sc[L_SCB], sc_c = sc[L_SCC], nm_b = sc[L_NMB], nm_c = sc[L_NMC];
  const float inv_ry = 1.0f / rho_y, oma = 1.0f - alpha;
  const int t_max = a.t_max[b];

  for (int i = tid; i < m; i += kThreads) {
    s_y[i] = a.in[I_Y][b * m + i];
    s_vy[i] = a.in[I_VY][b * m + i];
  }
  for (int j = tid; j < n; j += kThreads) {
    s_x[j] = a.in[I_X][b * n + j];
    s_vx[j] = a.in[I_VX][b * n + j];
  }
  float tau = sc[L_TAU], kappa = sc[L_KAPPA], mu = sc[L_MU], tol = sc[L_TOL];
  __syncthreads();

  // One conic DR iteration at barrier `lam`; `i` is the launch-local index.
  auto step = [&](float lam, int i) {
    const float lam_x = lam / rho_x, lam_tau = lam / rho_tau;
    // p: <ry,wy>, <rx,wx>, <ry,zy>, <rx,zx>, <zx,Qd zx>
    float p[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = tid; k < m; k += kThreads) {
      const float w = rho_y * (s_y[k] + s_vy[k]);
      s_wy[k] = w;
      p[0] += ry[k] * w;
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {  // rhs = wx + A'(wy / rho_y)
      const float wx = rho_x * (s_x[j] + s_vx[j]);
      p[1] += rx[j] * wx;
      const float r = wx + inv_ry * col_dot(A, s_wy, m, n, j);
      s_t[j] = woodbury ? hinv[j] * r : r;
    }
    __syncthreads();
    if (woodbury) {
      for (int k = warp; k < m; k += kWarps) {  // A t
        const float acc = row_dot(A + (size_t)k * n, s_t, n, lane);
        if (lane == 0) s_at[k] = acc;
      }
      __syncthreads();
      for (int k = warp; k < m; k += kWarps) {  // u = G^-1 (A t)
        const float acc = row_dot(Minv + (size_t)k * m, s_at, m, lane);
        if (lane == 0) s_u[k] = acc;
      }
      __syncthreads();
    }
    for (int j = tid; j < n; j += kThreads) {
      // Woodbury: zx = t - H^-1 (A'u); primal: zx = rhs S^-1
      const float z = woodbury ? s_t[j] - hinv[j] * col_dot(A, s_u, m, n, j)
                               : col_dot(Minv, s_t, n, n, j);
      s_zx[j] = z;
      p[3] += rx[j] * z;
      p[4] += z * qd[j] * z;
    }
    __syncthreads();
    for (int k = warp; k < m; k += kWarps) {  // zy = (wy - A zx) / rho_y
      const float acc = row_dot(A + (size_t)k * n, s_zx, n, lane);
      if (lane == 0) {
        const float z = inv_ry * (s_wy[k] - acc);
        s_zy[k] = z;
        p[2] += ry[k] * z;
      }
    }
    block_sum(p, red);
    const float eta = rho_tau * (tau + kappa);
    const float b_coef = ((p[0] + p[1]) - 2.0f * (rho_y * p[2] + rho_x * p[3])) - eta;
    const float c_coef = -p[4];
    const float disc = max0(b_coef * b_coef - 4.0f * a_coef * c_coef);
    float tau_t = (-b_coef + sqrtf(disc)) / (2.0f * a_coef);
    if (!(k0 + (float)i > 0.f)) tau_t = 1.0f;  // the first-ever iteration
    for (int k = tid; k < m; k += kThreads) {  // free-cone head + dual
      const float rel = alpha * (s_zy[k] - tau_t * ry[k]) + oma * s_y[k];
      const float yn = rel - s_vy[k];
      s_vy[k] = (s_vy[k] + yn) - rel;
      s_y[k] = yn;
    }
    for (int j = tid; j < n; j += kThreads) {
      const float rel = alpha * (s_zx[j] - tau_t * rx[j]) + oma * s_x[j];
      s_t[j] = rel - s_vx[j];
      s_zx[j] = rel;
    }
    const float rel_tau = alpha * tau_t + oma * tau;
    __syncthreads();
    for (int k = warp; k < nb; k += kWarps) {  // the cone blocks
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const float bsq = body_sum(st, len, is_soc ? 1 : 2, lane, [&](int e) {
        const float v = s_t[e];
        return v * v;
      });
      if (lane == 0) {
        if (is_soc) {
          soc_rows(s_t[st], bsq, lam_x, &s_bh1[k], &s_bsc[k]);
          s_bh2[k] = 0.f;
        } else {
          rsoc_rows(s_t[st], s_t[st + 1], bsq, lam_x, &s_bh1[k], &s_bh2[k], &s_bsc[k]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      const float xn = cone_prox_elem(cn.code[j], cn.blk[j], s_t[j], lam_x, s_bh1, s_bh2, s_bsc);
      s_vx[j] = (s_vx[j] + xn) - s_zx[j];
      s_x[j] = xn;
    }
    const float tau_n = prox_nn(rel_tau - kappa, lam_tau);
    kappa = (kappa + tau_n) - rel_tau;
    tau = tau_n;
    __syncthreads();
  };

  // `qcp_inner_conv_check` in f32
  auto err_inner = [&]() -> float {
    // q: <y,Mu_y> + <x,Mu_x>, <y,b>, <x,c>, |Qu - von|^2 (y and x blocks),
    //    |Qu|^2, |von|^2
    float q[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = warp; k < m; k += kWarps) {  // Mu_y = A x
      const float mu_y = row_dot(A + (size_t)k * n, s_x, n, lane);
      if (lane == 0) {
        const float y = s_y[k];
        const float qu = mu_y - bv[k] * tau;
        const float von = rho_y * s_vy[k];
        q[0] += y * mu_y;
        q[1] += y * bv[k];
        q[3] += (qu - von) * (qu - von);
        q[4] += qu * qu;
        q[5] += von * von;
      }
    }
    for (int j = tid; j < n; j += kThreads) {  // Mu_x = Qd x - A'y
      const float x = s_x[j];
      const float mu_x = qd[j] * x - col_dot(A, s_y, m, n, j);
      const float qu = mu_x + cv[j] * tau;
      const float von = rho_x * s_vx[j];
      q[0] += x * mu_x;
      q[2] += x * cv[j];
      q[3] += (qu - von) * (qu - von);
      q[4] += qu * qu;
      q[5] += von * von;
    }
    block_sum(q, red);
    const float tau_safe = (fabsf(tau) < kEpsTau) ? kEpsTau : tau;
    const float qu_tau = (-q[0] / tau_safe + q[1]) - q[2];
    const float von_tau = rho_tau * kappa;
    const float d2 = q[3] + (qu_tau - von_tau) * (qu_tau - von_tau);
    const float qn = sqrtf(q[4] + qu_tau * qu_tau);
    const float vn = sqrtf(q[5] + von_tau * von_tau);
    return sqrtf(d2) / ((1.0f + qn) + vn);
  };

  // max(res / eps) of `calc_qcp_residuals` in f32
  auto error_ratio = [&]() -> float {
    const float tau_s = nan_max(fabsf(tau), 1e-18f);
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
    for (int it = 0; it < probe; ++it) step(mu, t + it);
    t += probe;
    e = err_inner();
    const float ratio = error_ratio();
    float mu2, tol2;
    adjust_barrier(mu, ratio, eps, a.psi, &mu2, &tol2);
    if (e < tol) {
      mu = mu2;
      tol = tol2;
      ++stages;
    }
  }

  for (int k = tid; k < m; k += kThreads) {
    a.out[O_Y][b * m + k] = s_y[k];
    a.out[O_VY][b * m + k] = s_vy[k];
  }
  for (int j = tid; j < n; j += kThreads) {
    a.out[O_X][b * n + j] = s_x[j];
    a.out[O_VX][b * n + j] = s_vx[j];
  }
  if (tid == 0) {
    float* row = a.out[O_ROW] + b * kRowWidth;
    row[0] = tau; row[1] = kappa; row[2] = e; row[3] = (float)t;
    row[4] = mu; row[5] = tol; row[6] = (float)stages;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one lane of shape (m, n) with nb cone blocks needs.
long long abip_conic_ladder_smem_bytes(int m, int n, int nb) {
  return (6LL * m + 4LL * n + 3LL * nb + (long long)kWarps * kRed) * sizeof(float);
}

int abip_row_width() { return kRowWidth; }

const char* abip_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Launches the ladder over B lanes on `stream`; returns the CUDA error code.
// in: the 15 f32 LadderOperands, t_max (int32, B), then the int32 cone rows
// code, blk (n) and start, length, soc (nb); out: y, x, vy, vx, row.  All
// contiguous, lane-major.
int abip_conic_ladder(void* const* in, void* const* out, int B, int m, int n, int nb,
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
  const int smem = (int)abip_conic_ladder_smem_bytes(m, n, nb);
  cudaError_t err = cudaFuncSetAttribute(conic_ladder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  conic_ladder_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
