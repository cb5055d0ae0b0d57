// What the cluster kernels share (csrc/admm_delta.cu, csrc/admm_sprint.cu,
// csrc/conic_delta.cu): the thread-block cluster barrier in its split form,
// sums over the cluster read in rank order (from shared memory, or from a
// global workspace in a kernel's spilled form), the CTA-wide reductions,
// the products with one vector over a CTA's column slice, and the launch.
//
// A lane is one cluster of C CTAs of kThreads threads.  The cluster's CTAs
// run together on neighbouring SMs of one GPC and can read each other's
// shared memory (distributed shared memory).  The sums here read every CTA's
// partial in rank order 0, 1, ..., C-1, so every CTA of the cluster holds
// bit-identical sums: a kernel whose CTAs take a decision (stop or go on)
// from such a sum takes the same one in all of them, which it must, since a
// CTA that leaves its loop early would never reach the next cluster barrier.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cluster_ops {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;  // threads a CTA, unless a kernel passes NT
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows a warp dots at once
constexpr int kMaxCluster = 16;  // the largest cluster Hopper allows

// barrier.cluster in two halves: `arrive` releases this thread's earlier
// shared-memory writes to the cluster, `wait` blocks until every thread of
// every CTA has arrived and acquires their writes.  Every thread of the
// CTA must call both, in convergent control flow.
__device__ __forceinline__ void arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void sync() {
  arrive();
  wait();
}

// What the cluster's CTAs read of each other lies in their shared memory
// (peer == 0), read through distributed shared memory, or, in a kernel's
// spilled form, in a global workspace of `peer` floats per CTA, a lane's C
// CTAs side by side, read from L2 past L1 (the cluster barrier's release
// and acquire order global memory as they order shared memory).  vec is
// this CTA's address of the buffer in either case.
__device__ __forceinline__ const float* peer_ptr(const float* vec, int r,
                                                 long long peer) {
  cg::cluster_group cl = cg::this_cluster();
  if (peer) return vec + (long long)(r - (int)cl.block_rank()) * peer;
  return cl.map_shared_rank(const_cast<float*>(vec), r);
}
__device__ __forceinline__ float peer_load(const float* vec, int i, int r,
                                           long long peer) {
  const float* p = peer_ptr(vec, r, peer) + i;
  return peer ? __ldcg(p) : *p;
}
__device__ __forceinline__ float4 peer_load4(const float* vec, int i4, int r,
                                             long long peer) {
  const float4* p = reinterpret_cast<const float4*>(peer_ptr(vec, r, peer)) + i4;
  return peer ? __ldcg(p) : *p;
}

// Sum over the cluster's C ranks, in rank order 0..C-1, of vec[i] in each
// CTA's copy of the buffer (see peer_ptr); the C loads are all issued
// before the first add.  Call after a cluster barrier that follows the
// writes.
__device__ __forceinline__ float rank_sum(const float* vec, int i, int C,
                                          long long peer = 0) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = (r < C) ? peer_load(vec, i, r, peer) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) s += v[r];
  return s;
}

// The float4 at vec + 4 i4 summed over the cluster's C ranks, each
// component in rank order (the bits of four `rank_sum`s); one load per
// rank instead of four.  vec is 16-byte aligned (and so is peer * 4 B).
__device__ __forceinline__ float4 rank_sum4(const float* vec, int i4, int C,
                                            long long peer = 0) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int r0 = 0; r0 < kMaxCluster; r0 += 8) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      v[q] = (r0 + q < C) ? peer_load4(vec, i4, r0 + q, peer)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (r0 + q < C) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
  }
  return s;
}

// vec[i] in the copy of the cluster's CTA of rank r.
__device__ __forceinline__ float rank_read(const float* vec, int i, int r,
                                           long long peer = 0) {
  return peer_load(vec, i, r, peer);
}

// A cluster kernel's form, a template argument so that each form's
// addresses keep their state space: A's slice and the state in shared
// memory (kResident); A and the operands read through L2, the exchange
// buffers in shared memory (kStreaming); the streaming form with its whole
// layout in a global workspace, for shapes no shared memory holds
// (kSpilled).
enum Form { kResident, kStreaming, kSpilled };

__host__ __device__ inline int form_of(int resident, int spill) {
  return resident ? kResident : (spill ? kSpilled : kStreaming);
}

// Columns a CTA of a cluster of C owns: ceil(n / C) rounded up to a multiple
// of 4, so that every row of a resident slice starts 16-byte aligned.
__host__ __device__ inline int cols_per_cta(int n, int C) {
  return ((n + C - 1) / C + 3) / 4 * 4;
}

// x rounded up to a multiple of 4 floats (16 bytes)
__host__ __device__ inline long long al4(long long x) { return (x + 3) / 4 * 4; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums each v[k] over the CTA; every thread gets the same bits.  `red`
// (NT / 32 * K floats) is read after the call returns, so a CTA barrier must
// pass before the next block_sum writes it (every caller's next one is
// behind a __syncthreads or a cluster barrier).
template <int NT = kThreads, int K>
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
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += red[w * K + k];
    v[k] = s;
  }
}

// sum_i M[i, j] y[i] down column j of M (row stride ld), i < m: four
// partial sums over i mod 4, so that four loads and FMAs are in flight,
// folded in a fixed order.
__device__ __forceinline__ float col_dot(const float* M, int ld,
                                         const float* y, int m, int j) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 4 <= m; i += 4) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] += M[(size_t)(i + k) * ld + j] * y[i + k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (i + k < m) acc[k] += M[(size_t)(i + k) * ld + j] * y[i + k];
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

__device__ __forceinline__ float dot4(float4 a, float4 w) {
  return (a.x * w.x + a.y * w.y) + (a.z * w.z + a.w * w.w);
}

// out0[i] = sum_j M[i, j] w0[j] (and out1 with w1 where kTwo) for the rows
// i < rows, j < len; kRowsPerWarp rows per warp at a time, one pass over
// the columns for all of them.  M has row stride ld.  kVec: M, w0 and w1
// are 16-byte aligned, ld and len multiples of 4, and each lane takes four
// columns a load.
template <bool kTwo, bool kVec, int NT = kThreads>
__device__ __forceinline__ void rows_dot(const float* M, int ld,
                                         const float* w0, const float* w1,
                                         int len, int rows, float* out0,
                                         float* out1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i0 = warp * kRowsPerWarp; i0 < rows; i0 += NT / 32 * kRowsPerWarp) {
    float a0[kRowsPerWarp], a1[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) a0[r] = a1[r] = 0.f;
    if (kVec) {
      for (int j = lane; j < len / 4; j += 32) {
        const float4 u = reinterpret_cast<const float4*>(w0)[j];
        const float4 v = kTwo ? reinterpret_cast<const float4*>(w1)[j] : u;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (i0 + r < rows) {
            const float4 a =
                reinterpret_cast<const float4*>(M + (size_t)(i0 + r) * ld)[j];
            a0[r] += dot4(a, u);
            if (kTwo) a1[r] += dot4(a, v);
          }
        }
      }
    } else {
      for (int j = lane; j < len; j += 32) {
        const float u = w0[j];
        const float v = kTwo ? w1[j] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          if (i0 + r < rows) {
            const float a = M[(size_t)(i0 + r) * ld + j];
            a0[r] += a * u;
            if (kTwo) a1[r] += a * v;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      a0[r] = warp_sum(a0[r]);
      if (kTwo) a1[r] = warp_sum(a1[r]);
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (i0 + r < rows) {
          out0[i0 + r] = a0[r];
          if (kTwo) out1[i0 + r] = a1[r];
        }
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst[i * ldd + j] = src[i * lds + j] for i < rows, j < cols, and zeros in
// the pad columns [cols, ldd): a CTA's slice of a row-major matrix into its
// shared memory, by cp.async (commit and wait are the caller's).
template <int NT = kThreads>
__device__ __forceinline__ void load_slice(float* dst, int ldd,
                                           const float* src, size_t lds,
                                           int rows, int cols) {
  for (int e = threadIdx.x; e < rows * ldd; e += NT) {
    const int i = e / ldd, j = e - i * ldd;
    if (j < cols)
      cp_async4(dst + (size_t)i * ldd + j, src + (size_t)i * lds + j);
    else
      dst[(size_t)i * ldd + j] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// the launch: B lanes, one cluster of C CTAs each
// ---------------------------------------------------------------------------

template <int NT, typename Kernel>
cudaError_t configure(Kernel kernel, int C, int smem, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int B, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->gridDim = dim3(B * C);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of C CTAs with `smem` bytes each the card holds at once
// (cudaOccupancyMaxActiveClusters) into *clusters; returns the CUDA error.
template <int NT = kThreads, typename Kernel>
int max_active(Kernel kernel, int C, int smem, int* clusters) {
  *clusters = 0;
  if (C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<NT>(kernel, C, smem, &cfg, attr, 1, nullptr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// One launch over B lanes; returns the CUDA error of the launch.
template <int NT = kThreads, typename Kernel, typename Args>
int launch(Kernel kernel, const Args& a, int B, int C, int smem,
           void* stream) {
  if (B < 1 || C < 1 || C > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<NT>(kernel, C, smem, &cfg, attr, B, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace cluster_ops
