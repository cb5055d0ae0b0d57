// What the conic kernels share (csrc/conic_ladder.cu, csrc/conic_sprint.cu,
// and for its cone formulas csrc/conic_delta.cu): block-wide reductions that
// give every thread the same bits, the A and explicit-inverse products with
// one vector, the cone-block walk, the f32 cone prox formulas of
// `abip_tpu_torch/ops/conic_dr.py`, and one lane's f32 DR iteration with its
// inner criterion (`DrLane`).
//
// The ladder and the sprint run one block of kThreads threads per lane.  A
// lane's A (m x n) and its explicit inverse stay in device memory and are
// read through L2; the vectors live in shared memory.  Products with one
// vector have no tensor-core work:
//   * M v, one warp per row (coalesced along the row; v from shared memory);
//   * M' v, one thread per column (coalesced across the warp).
// No library call computes any of them.  (csrc/conic_delta.cu runs a
// cluster per lane with csrc/cluster_common.cuh instead.)
//
// Numerics: plain IEEE f32 `sqrtf` and `/`, and `isnan` (the RSOC delta uses
// NaN as a branch-mismatch sentinel): build without -use_fast_math and without
// finite-math flags.  FMA contraction is allowed.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace conic {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// element classes, as `ops/conic_dr.py` E_*
enum { E_NN, E_FREE, E_ZERO, E_SOC_H, E_SOC_B, E_RSOC_H1, E_RSOC_H2, E_RSOC_B };

// the TPU kernels' f32 guards (they differ from the f64 prox's on purpose)
constexpr float kTiny = 1e-30f;
constexpr float kSocTol = 1e-6f;
constexpr float kEpsTau = 1e-18f;

// The per-lane cone structure (shared by every lane of a launch).
struct Cones {
  const int* code;    // (n) element class
  const int* blk;     // (n) block of each SOC/RSOC element
  const int* start;   // (nb) head element of each block
  const int* length;  // (nb)
  const int* soc;     // (nb) 1 for SOC, 0 for RSOC
  int nb;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max that propagates a NaN from either side, as jnp.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// max(x, 0) that keeps a NaN, as jnp.maximum(x, 0.0) does
__device__ __forceinline__ float max0(float x) { return (x < 0.f) ? 0.f : x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sums each v[k] over the block.  Every thread folds the per-warp partials in
// the same order, so all threads hold the same bits and take the same branch
// decisions; a thread that decided otherwise would hang the next barrier.
// `red` holds kWarps * K floats.
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

// Block-wide max of each v[k] (NaN-propagating), same discipline.
template <int K>
__device__ __forceinline__ void block_max(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_max(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp * K + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = red[k];
    for (int w = 1; w < kWarps; ++w) s = nan_max(s, red[w * K + k]);
    v[k] = s;
  }
  __syncthreads();
}

// sum_j Mi[j] * w[j] over one row, by one warp; every lane gets the sum
__device__ __forceinline__ float row_dot(const float* __restrict__ Mi, const float* w,
                                         int cols, int lane) {
  float acc = 0.f;
  for (int j = lane; j < cols; j += 32) acc += __ldg(Mi + j) * w[j];
  return warp_sum(acc);
}

// sum_i M[i, j] * y[i] down one column of a (rows x cols) matrix, by one thread
__device__ __forceinline__ float col_dot(const float* __restrict__ M, const float* y,
                                         int rows, int cols, int j) {
  float acc = 0.f;
  for (int i = 0; i < rows; ++i) acc += __ldg(M + (size_t)i * cols + j) * y[i];
  return acc;
}

// Sum over a block's body elements [start + off, start + len) of f(element),
// by one warp; every lane gets the sum.
template <typename F>
__device__ __forceinline__ float body_sum(int start, int len, int off, int lane, F f) {
  float acc = 0.f;
  for (int q = off + lane; q < len; q += 32) acc += f(start + q);
  return warp_sum(acc);
}

// ---------------------------------------------------------------------------
// f32 prox formulas (`cones.c:130-289`), the reference's branch-free selects
// evaluated as branches: every selected value is the same.
// ---------------------------------------------------------------------------

// positive-orthant barrier prox: the positive root of u^2 - t u - lam = 0
__device__ __forceinline__ float prox_nn(float t, float lam) {
  if (t >= 0.f) return 0.5f * (t + sqrtf(t * t + 4.0f * lam));
  return 2.0f * lam / (-t * (1.0f + sqrtf(1.0f + 4.0f * lam / (t * t + kTiny))) + kTiny);
}

// SOC prox of one block from (head a, body sum of squares bsq):
// head value and body scale
__device__ __forceinline__ void soc_rows(float a, float bsq, float lam, float* head,
                                         float* scale) {
  if (fabsf(a) <= kSocTol) {
    *head = sqrtf(2.0f * lam + bsq / 4.0f);
    *scale = 0.5f;
    return;
  }
  const float denom_r = 8.0f * lam - a * a + bsq;
  const float r = 16.0f * a * a / (denom_r + sqrtf(denom_r * denom_r + 32.0f * a * a * lam) + kTiny);
  const float disc = sqrtf(max0(r * (r + 8.0f)));
  const float s = (a > 0.f) ? (r + disc) / 2.0f : (r - disc) / 2.0f;
  const float s_safe = (fabsf(s) < kTiny) ? kTiny : s;
  *head = (s + 2.0f) * a / s_safe;
  *scale = (s + 2.0f) / (s + 4.0f);
}

__device__ __forceinline__ float tiny_guard(float den) {
  return (fabsf(den) < kTiny) ? kTiny : den;
}

// heads and scale for a root s of the standard form (branches a and c)
__device__ __forceinline__ void rsoc_heads_std(float ze, float zn, float s, float* x1,
                                               float* x2, float* sc) {
  const float den = tiny_guard(s * (s + 2.0f));
  const float s1 = s + 1.0f;
  *x1 = (ze * (s1 * s1) + zn * s1) / den;
  *x2 = (zn * (s1 * s1) + ze * s1) / den;
  *sc = s1 / (s + 2.0f);
}

// heads and scale for the conjugate form (branch b)
__device__ __forceinline__ void rsoc_heads_b(float ze, float zn, float s, float* x1,
                                             float* x2, float* sc) {
  const float den = tiny_guard((s - 1.0f) * (s + 1.0f));
  *x1 = (ze * s * s + zn * s) / den;
  *x2 = (zn * s * s + ze * s) / den;
  *sc = s / (s + 1.0f);
}

// branch codes of the RSOC chain
enum { RB_A, RB_B, RB_C, RB_DEG };

// The w of the RSOC chain (`cones.c:191-215`).
__device__ __forceinline__ float rsoc_w(float ze, float zn, float zxsq, float lam) {
  const float sum_zz = ze + zn;
  const float d = 2.0f * ze * zn - zxsq;
  const float g = d / (2.0f * lam);
  const float q = 4.0f * (ze * ze + zn * zn + zxsq) / lam + 16.0f;
  if (d < 0.f) {
    const float g_neg = (g < 0.f) ? -g : 1.0f;
    return (2.0f * sum_zz * sum_zz / lam) / g_neg /
           (1.0f + 4.0f / g_neg + sqrtf(1.0f + q / (g_neg * g_neg)));
  }
  const float g_pos = (g > 0.f) ? g : 1.0f;
  return g_pos * (1.0f - 4.0f / g_pos + sqrtf(1.0f + q / (g_pos * g_pos))) / 2.0f;
}

// RSOC prox of one block (`cones.c:169-248`): heads, body scale, branch
__device__ __forceinline__ int rsoc_rows(float ze, float zn, float zxsq, float lam, float* x1,
                                         float* x2, float* sc) {
  const float sum_zz = ze + zn;
  if (sum_zz == 0.f) {
    const float x2d = (-ze + sqrtf(ze * ze + 4.0f * lam + zxsq)) / 2.0f;
    *x1 = x2d + ze;
    *x2 = x2d;
    *sc = 0.5f;
    return RB_DEG;
  }
  const float w = rsoc_w(ze, zn, zxsq, lam);
  const float root = sqrtf(max0(w * (w + 4.0f)));
  if (sum_zz > 0.f) {
    rsoc_heads_std(ze, zn, (w + root) / 2.0f, x1, x2, sc);
    return RB_A;
  }
  if (w > 10.0f) {
    rsoc_heads_b(ze, zn, 2.0f / (w + 2.0f + root + kTiny), x1, x2, sc);
    return RB_B;
  }
  rsoc_heads_std(ze, zn, (w - root) / 2.0f, x1, x2, sc);
  return RB_C;
}

// The cone prox of one element after the block walk: `bh1`, `bh2`, `bsc` hold
// each block's head values and body scale.
__device__ __forceinline__ float cone_prox_elem(int code, int blk, float t, float lam,
                                                const float* bh1, const float* bh2,
                                                const float* bsc) {
  switch (code) {
    case E_NN: return prox_nn(t, lam);
    case E_FREE: return t;
    case E_SOC_H:
    case E_RSOC_H1: return bh1[blk];
    case E_RSOC_H2: return bh2[blk];
    case E_SOC_B:
    case E_RSOC_B: return bsc[blk] * t;
    default: return 0.f;  // zero cone
  }
}

// ---------------------------------------------------------------------------
// One lane's conic Douglas-Rachford iteration and its f32 inner criterion,
// shared by the ladder (csrc/conic_ladder.cu) and the sprint
// (csrc/conic_sprint.cu): `_make_dr_fns` of `ops/conic_dr.py`.
// ---------------------------------------------------------------------------

// The f32 operand rows of one lane (LadderOperands / SprintConicOperands
// without their scalars).
struct DrOperands {
  const float *A, *Minv, *hinv, *ry, *rx, *bv, *cv, *qd;
};

// Floats of dynamic shared memory a DrLane of shape (m, n) with nb cone
// blocks carves, before the reduction scratch.
__host__ __device__ constexpr long long dr_smem_floats(int m, int n, int nb) {
  return 6LL * m + 4LL * n + 3LL * nb;
}

// Widest block reduction of `err_inner` (and of the ladder's error ratio).
constexpr int kDrRed = 6;

// Floats of a lane's layout with its reduction scratch: its dynamic shared
// memory, or, in the spilled form (where a block's shared memory does not
// hold it), its slice of a global workspace, 16-byte padded.
__host__ __device__ constexpr long long dr_layout_floats(int m, int n, int nb) {
  return dr_smem_floats(m, n, nb) + (long long)kWarps * kDrRed;
}
__host__ __device__ constexpr long long dr_work_floats(int m, int n, int nb) {
  return (dr_layout_floats(m, n, nb) + 3) / 4 * 4;
}

// Where lane b's layout lies: in shared memory, or spilled in its slice of
// the global workspace.  The iteration reads it alike; kSpill is a template
// argument so that the shared form's addresses keep their state space.
template <bool kSpill>
__device__ __forceinline__ float* dr_layout(float* smem, float* work, int m, int n, int nb) {
  return kSpill ? work + (size_t)blockIdx.x * dr_work_floats(m, n, nb) : smem;
}

// The launch of a kernel of one block per lane over B lanes: `smem` bytes
// of dynamic shared memory, or none when spilled (work not null; `kernel`
// is then the spilled kernel).
template <typename Kernel, typename Args>
int dr_launch(Kernel kernel, const Args& a, int B, const void* work, void* stream) {
  const int smem =
      work ? 0 : (int)(dr_layout_floats(a.m, a.n, a.cones.nb) * (long long)sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

struct DrLane {
  // shared memory: the iterate, the projection's scratch, the block scalars
  float *s_y, *s_vy, *s_wy, *s_at, *s_u, *s_zy;  // m each
  float *s_x, *s_vx, *s_t, *s_zx;                // n each
  float *s_bh1, *s_bh2, *s_bsc;                  // nb each
  float* red;                                    // kWarps * kDrRed
  DrOperands op;
  Cones cn;
  int m, n;
  bool woodbury;
  float rho_y, rho_x, rho_tau, a_coef, alpha, k0, inv_ry, oma;
  float tau, kappa;

  // Carve the shared memory at `smem` and load lane b's iterate (y, x, vy,
  // vx rows of the inputs; tau, kappa) into it.  Ends with a barrier.
  __device__ void init(float* smem, const float* y, const float* x, const float* vy,
                       const float* vx, float tau0, float kappa0) {
    s_y = smem;
    s_vy = s_y + m;
    s_wy = s_vy + m;  // wy, then y / tau (error ratio)
    s_at = s_wy + m;  // A t
    s_u = s_at + m;   // G^-1 A t
    s_zy = s_u + m;
    s_x = s_zy + m;
    s_vx = s_x + n;
    s_t = s_vx + n;   // rhs or t, then the prox argument tx, then x / tau
    s_zx = s_t + n;   // zx, then rel_x
    s_bh1 = s_zx + n;
    s_bh2 = s_bh1 + cn.nb;
    s_bsc = s_bh2 + cn.nb;
    red = s_bsc + cn.nb;
    inv_ry = 1.0f / rho_y;
    oma = 1.0f - alpha;
    const int tid = threadIdx.x;
    for (int i = tid; i < m; i += kThreads) {
      s_y[i] = y[i];
      s_vy[i] = vy[i];
    }
    for (int j = tid; j < n; j += kThreads) {
      s_x[j] = x[j];
      s_vx[j] = vx[j];
    }
    tau = tau0;
    kappa = kappa0;
    __syncthreads();
  }

  // One conic DR iteration at barrier `lam`; `i` is the launch-local index.
  __device__ void step(float lam, int i) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float *A = op.A, *Minv = op.Minv, *hinv = op.hinv, *ry = op.ry, *rx = op.rx,
                *qd = op.qd;
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
    for (int k = warp; k < cn.nb; k += kWarps) {  // the cone blocks
      const int st = cn.start[k], len = cn.length[k], is_soc = cn.soc[k];
      const float* t = s_t;
      const float bsq = body_sum(st, len, is_soc ? 1 : 2, lane, [t](int e) {
        const float v = t[e];
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
  }

  // `qcp_inner_conv_check` in f32
  __device__ float err_inner() {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float *A = op.A, *bv = op.bv, *cv = op.cv, *qd = op.qd;
    // q: <y,Mu_y> + <x,Mu_x>, <y,b>, <x,c>, |Qu - von|^2 (y and x blocks),
    //    |Qu|^2, |von|^2
    float q[kDrRed] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
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
  }

  // Write lane b's iterate rows (y, x, vy, vx outputs of one lane).
  __device__ void store(float* y, float* x, float* vy, float* vx) const {
    const int tid = threadIdx.x;
    for (int k = tid; k < m; k += kThreads) {
      y[k] = s_y[k];
      vy[k] = s_vy[k];
    }
    for (int j = tid; j < n; j += kThreads) {
      x[j] = s_x[j];
      vx[j] = s_vx[j];
    }
  }
};

}  // namespace conic
