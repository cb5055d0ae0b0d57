// BCSR sparse matrix-vector product for Hopper (sm_90a): y = A @ x.
//
// Replaces the TPU kernel `_bcsr_kernel` of `abip_tpu/ops/spmv_pallas.py`
// (Pallas, grid (block rows, max blocks), the x tile gathered through the
// scalar-prefetched block-column ids).  It computes what
// `abip_tpu_torch/ops/spmv.py:_bcsr_ref` computes:
//
//   y[8i + r] = sum_k sum_j data[i, k, r, j] * x_pad[128 * cols[i, k] + j]
//
// for every block row i, with x_pad the zero-padded x; only rows 8i + r < m
// are written.
//
// Layout.  One thread block per block row, one warp per tile row (8 warps).
// Lane `l` of warp r owns columns 4l .. 4l + 3 of the 128 in every tile of
// its row: it reads them as one 16-byte (f32) or two 16-byte (f64) loads, so
// a warp reads a whole 512- or 1024-byte tile row contiguously.  The lane
// accumulates its four columns over k in k order; a warp-shuffle reduction
// folds the 32 lanes and the four columns in a fixed order, so a launch is
// deterministic.  Four tiles are loaded before any is accumulated, to keep
// more loads in flight per thread.  A column at or beyond n reads no x (it
// counts as the zero padding), so x needs no padded copy and whatever lies
// past its end never reaches y.  A padded tile (all zeros, column 0) adds
// zeros unless x[0..127] holds inf or NaN, as in the reference.
//
// What bounds it on this card: the tiles are streamed once per launch and
// each element is used once (2 flops per 8 bytes in f64), so device memory
// bandwidth bounds it, 3.35 TB/s on an H100 SXM; x (at most a few hundred
// KB) stays in L1/L2.  At the host LP driver's shape (m=1000, n=10000,
// density 0.1) A packs to 125 x 72 tiles (73.7 MB in f64) and A' to 1250 x 8
// (81.9 MB); A gives only 125 blocks for 132 SMs.  Splitting a block row's
// tiles over several blocks, or more rows per block for A', is later work.
//
// Why CUDA C++ and not Triton: it builds and binds like K1-K3 (nvcc into a
// plain C library, ctypes), and the gather by `cols` is a scalar-indexed
// load that a thread does directly.

#include <cuda_runtime.h>

namespace {

constexpr int kBR = 8;       // tile rows
constexpr int kBC = 128;     // tile columns
constexpr int kLanes = 32;
constexpr int kPer = kBC / kLanes;   // columns per lane: 4
constexpr int kUnroll = 4;           // tiles in flight per thread

template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec4<double> {
  static __device__ __forceinline__ void load(const double* p, double* v) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBR * kLanes)
bcsr_spmv_kernel(const T* __restrict__ data, const int* __restrict__ cols,
                 const T* __restrict__ x, T* __restrict__ y, int maxk, int m,
                 int n) {
  const int i = blockIdx.x;
  const int r = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int j0 = lane * kPer;
  const T* tiles = data + ((size_t)i * maxk * kBR + r) * kBC + j0;
  const int* ci = cols + (size_t)i * maxk;

  T acc[kPer] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < maxk; k0 += kUnroll) {
    T a[kUnroll][kPer];
    T xv[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + u;
      if (k < maxk) {
        Vec4<T>::load(tiles + (size_t)k * kBR * kBC, a[u]);
        const int base = ci[k] * kBC + j0;
#pragma unroll
        for (int t = 0; t < kPer; ++t)
          xv[u][t] = (base + t < n) ? x[base + t] : T(0);
      } else {
#pragma unroll
        for (int t = 0; t < kPer; ++t) a[u][t] = xv[u][t] = T(0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int t = 0; t < kPer; ++t) acc[t] += a[u][t] * xv[u][t];
  }
  T s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  const int row = i * kBR + r;
  if (lane == 0 && row < m) y[row] = s;
}

template <typename T>
int launch(const void* data, const void* cols, const void* x, void* y,
           int nbr, int maxk, int m, int n, void* stream) {
  if (nbr <= 0 || maxk <= 0) return (int)cudaErrorInvalidValue;
  bcsr_spmv_kernel<T><<<nbr, kBR * kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int*>(cols),
      static_cast<const T*>(x), static_cast<T*>(y), maxk, m, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The tile shape this source was built for, as 1000 * rows + columns.
int abip_bcsr_tile() { return kBR * 1000 + kBC; }

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// y (m) = A @ x (n) for A packed as data (nbr, maxk, 8, 128) and cols
// (nbr, maxk) int32, all contiguous on the device; launches on `stream` and
// returns the CUDA error code.
int abip_bcsr_spmv_f32(const void* data, const void* cols, const void* x,
                       void* y, int nbr, int maxk, int m, int n,
                       void* stream) {
  return launch<float>(data, cols, x, y, nbr, maxk, m, n, stream);
}

int abip_bcsr_spmv_f64(const void* data, const void* cols, const void* x,
                       void* y, int nbr, int maxk, int m, int n,
                       void* stream) {
  return launch<double>(data, cols, x, y, nbr, maxk, m, n, stream);
}

}  // extern "C"
