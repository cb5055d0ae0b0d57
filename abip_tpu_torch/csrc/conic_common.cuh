// What the conic kernels share (csrc/conic_ladder.cu, csrc/conic_delta.cu):
// block-wide reductions that give every thread the same bits, the A and
// explicit-inverse products with one vector, the cone-block walk, and the
// f32 cone prox formulas of `abip_tpu_torch/ops/conic_dr.py`.
//
// Both kernels run one block of kThreads threads per lane.  A lane's A
// (m x n) and its explicit inverse stay in device memory and are read
// through L2; the vectors live in shared memory.  Products with one vector
// have no tensor-core work:
//   * M v, one warp per row (coalesced along the row; v from shared memory);
//   * M' v, one thread per column (coalesced across the warp).
// No library call computes any of them.
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

}  // namespace conic
