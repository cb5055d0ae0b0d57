// Sparse matrix-vector product for Hopper (sm_90a) over the stored entries
// only: y = A @ x.
//
// Replaces the TPU kernel `_bcsr_kernel` of `abip_tpu/ops/spmv_pallas.py`
// (Pallas, grid (block rows, max blocks), the x tile gathered through the
// scalar-prefetched block-column ids).  It computes what
// `abip_tpu_torch/ops/spmv.py:_csr_ref` computes:
//
//   y[i] = sum_{k in [rowptr[i], rowptr[i+1])} vals[k] * x[colidx[k]]
//
// from the compact rows that `BCSRMatrix.from_scipy` packs beside the
// (8, 128) tiles.  The tiles' product is the same for finite x; it also
// multiplies each tile's unstored zeros by x, so a non-finite x at a column
// a row does not store reaches that row there and not here.
//
// Layout.  A group of G threads takes one row (G a power of two, 4..256,
// fixed per matrix from its mean row length); a block of 512 threads holds
// 512 / G rows, so A (1000 rows of ~900 entries, G = 256) gives 500 blocks
// and A' (10,000 rows of ~90, G = 32) 625, enough for 132 SMs.  A thread
// takes the entries start + lane, start + lane + G, ... of its row: first
// the few before the first 16-byte boundary, then 16-byte vectors of vals
// (and the matching int32 vector of colidx), then the tail.  x is read
// through the read-only path.  The group sums by warp shuffles, and through
// shared memory in a fixed order where G > 32.  No atomics: a launch is
// deterministic.  Only the columns a row stores are read, so nothing past
// x's end is touched.
//
// What bounds it on this card: every stored entry is read once (8 + 4 bytes
// in f64) for 2 flops, so device memory bandwidth, 3.35 TB/s on an H100
// SXM: 10.9 MB of vals, colidx and rowptr for A or A' of the host LP's
// m=1000, n=10000 instance (900,310 entries), 3.25 us.  In the solver loop
// A and A' (21.8 MB together) alternate and can stay in the 50 MB L2, so no
// evict-first hint is given; x (80 KB) stays in L1/L2.
//
// Why CUDA C++ and not Triton: it builds and binds like the other kernels
// (nvcc into a plain C library, ctypes), and the gather by colidx is a
// scalar-indexed load that a thread does directly.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroupMin = 4, kGroupMax = 256;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kW = 4;  // entries per 16 bytes
  static __device__ __forceinline__ float dot(const float* v, const int* c,
                                              const float* __restrict__ x) {
    const float4 a = *reinterpret_cast<const float4*>(v);
    const int4 j = *reinterpret_cast<const int4*>(c);
    float s = a.x * __ldg(x + j.x);
    s += a.y * __ldg(x + j.y);
    s += a.z * __ldg(x + j.z);
    s += a.w * __ldg(x + j.w);
    return s;
  }
};
template <>
struct Vec<double> {
  static constexpr int kW = 2;
  static __device__ __forceinline__ double dot(const double* v, const int* c,
                                               const double* __restrict__ x) {
    const double2 a = *reinterpret_cast<const double2*>(v);
    const int2 j = *reinterpret_cast<const int2*>(c);
    double s = a.x * __ldg(x + j.x);
    s += a.y * __ldg(x + j.y);
    return s;
  }
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
csr_spmv_kernel(const int* __restrict__ rowptr, const int* __restrict__ colidx,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int m) {
  constexpr int W = Vec<T>::kW;
  constexpr int kRows = kThreads / G;
  constexpr int kWarpsPerRow = G > 32 ? G / 32 : 1;
  __shared__ T part[kThreads / 32];
  const int g = threadIdx.x / G, l = threadIdx.x % G;
  const int row = blockIdx.x * kRows + g;

  T acc = T(0);
  if (row < m) {
    const int start = rowptr[row], end = rowptr[row + 1];
    // vals and colidx start 16-byte aligned, so index k is aligned where
    // k is a multiple of W
    const int head = min(end, (start + W - 1) / W * W);
    for (int k = start + l; k < head; k += G)
      acc += vals[k] * __ldg(x + colidx[k]);
    const int nvec = (end - head) / W;
    for (int v = l; v < nvec; v += G)
      acc += Vec<T>::dot(vals + head + v * W, colidx + head + v * W, x);
    for (int k = head + nvec * W + l; k < end; k += G)
      acc += vals[k] * __ldg(x + colidx[k]);
  }
#pragma unroll
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (G > 32) {
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (l == 0) {
      acc = part[g * kWarpsPerRow];
#pragma unroll
      for (int w = 1; w < kWarpsPerRow; ++w) acc += part[g * kWarpsPerRow + w];
    }
  }
  if (l == 0 && row < m) y[row] = acc;
}

template <typename T, int G>
int launch_g(const int* rowptr, const int* colidx, const T* vals, const T* x,
             T* y, int m, cudaStream_t stream) {
  const int blocks = (m + kThreads / G - 1) / (kThreads / G);
  csr_spmv_kernel<T, G><<<blocks, kThreads, 0, stream>>>(rowptr, colidx, vals,
                                                        x, y, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* rowptr, const void* colidx, const void* vals,
           const void* x, void* y, int m, int group, void* stream) {
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const int* rp = static_cast<const int*>(rowptr);
  const int* ci = static_cast<const int*>(colidx);
  const T* v = static_cast<const T*>(vals);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4: return launch_g<T, 4>(rp, ci, v, xp, yp, m, s);
    case 8: return launch_g<T, 8>(rp, ci, v, xp, yp, m, s);
    case 16: return launch_g<T, 16>(rp, ci, v, xp, yp, m, s);
    case 32: return launch_g<T, 32>(rp, ci, v, xp, yp, m, s);
    case 64: return launch_g<T, 64>(rp, ci, v, xp, yp, m, s);
    case 128: return launch_g<T, 128>(rp, ci, v, xp, yp, m, s);
    case 256: return launch_g<T, 256>(rp, ci, v, xp, yp, m, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The group sizes this source was built for, as 1000 * smallest + largest.
int abip_csr_group_range() { return kGroupMin * 1000 + kGroupMax; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y (m) = A @ x for A as rowptr (m + 1), colidx (nnz) int32 and vals (nnz),
// all contiguous and 16-byte aligned on the device, `group` threads a row;
// launches on `stream` and returns the CUDA error code.
int abip_csr_spmv_f32(const void* rowptr, const void* colidx, const void* vals,
                      const void* x, void* y, int m, int group, void* stream) {
  return launch<float>(rowptr, colidx, vals, x, y, m, group, stream);
}

int abip_csr_spmv_f64(const void* rowptr, const void* colidx, const void* vals,
                      const void* x, void* y, int m, int group, void* stream) {
  return launch<double>(rowptr, colidx, vals, x, y, m, group, stream);
}

}  // extern "C"
