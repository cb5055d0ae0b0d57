// Fused barrier step for Hopper (sm_90a): over-relaxation, log-barrier prox
// and dual update, elementwise, f32 and f64.
//
// Replaces the TPU kernel `_kernel` of `abip_tpu/ops/prox_pallas.py` (entry
// `fused_barrier_step`).  It computes what
// `abip_tpu_torch/ops/prox.py:_ref_impl` computes, per element:
//   rel = alpha u_t + (1 - alpha) u_prev;  t = rel - v
//   u_new = prox(t, lam);                 v_new = v + u_new - rel
// Three reads and two writes: 40 bytes per element in f64, 20 in f32, and
// some 30 operations, so HBM bandwidth bounds it at every length (at the
// lengths the port meets, a few 1e4, the launch does).
//
// Design for the bytes: each thread moves 16-byte vectors (float4, double2)
// with streaming cache hints (__ldcs, __stcs: every byte is touched once),
// over an aligned body that `ops/prox.py:step_plan` cuts out of the
// operands, with the scalar head before it and the scalar tail after it
// (fewer than one vector each).  Operands whose addresses differ modulo 16
// bytes take the same loop one element at a time (vec 1).  The grid is the
// card's SMs times the blocks resident on each (the occupancy API,
// `abip_barrier_step_residency`), so every SM keeps enough loads in flight
// to cover HBM latency; each thread strides over the body.
//
// Numerics: IEEE `sqrt` and `/` (build without -use_fast_math).  The prox
// takes the cancellation-free form for t < 0, 2 lam / (sqrt(t^2 + 4 lam) - t);
// the reference's guarded form is wrong for |t| below ~1e-15 (f32) or
// ~1e-150 (f64).  1 - alpha is formed in double and rounded, as the plain
// version forms it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecBytes = 16;

// The type a thread loads: T itself, or the 16-byte vector of T.
template <typename T, int VEC> struct Vec { using type = T; };
template <> struct Vec<float, 4> { using type = float4; };
template <> struct Vec<double, 2> { using type = double2; };

template <typename T>
__device__ __forceinline__ void step(T ut, T up, T vi, T lam, T alpha, T oma,
                                     T& un, T& vn) {
  const T rel = alpha * ut + oma * up;
  const T t = rel - vi;
  const T s = sqrt(t * t + T(4) * lam);
  un = (t >= T(0)) ? T(0.5) * (t + s) : T(2) * lam / (s - t);
  vn = (vi + un) - rel;
}

// Elements [0, head) and [head + VEC nvec, n) one at a time, the nvec
// vectors of VEC elements from element `head` on (16-byte aligned for
// VEC > 1) a vector at a time.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
barrier_step_kernel(const T* __restrict__ u_t, const T* __restrict__ u_prev,
                    const T* __restrict__ v, T* __restrict__ u_new,
                    T* __restrict__ v_new, long long n, long long head,
                    long long nvec, T lam, T alpha, T oma) {
  using V = typename Vec<T, VEC>::type;
  const long long gid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long body_end = head + nvec * VEC;
  if (gid < head)
    step(u_t[gid], u_prev[gid], v[gid], lam, alpha, oma, u_new[gid],
         v_new[gid]);
  if (body_end + gid < n) {
    const long long i = body_end + gid;
    step(u_t[i], u_prev[i], v[i], lam, alpha, oma, u_new[i], v_new[i]);
  }
  const V* a = reinterpret_cast<const V*>(u_t + head);
  const V* b = reinterpret_cast<const V*>(u_prev + head);
  const V* c = reinterpret_cast<const V*>(v + head);
  V* un = reinterpret_cast<V*>(u_new + head);
  V* vn = reinterpret_cast<V*>(v_new + head);
  for (long long j = gid; j < nvec; j += stride) {
    const V av = __ldcs(a + j), bv = __ldcs(b + j), cv = __ldcs(c + j);
    V uo, vo;
    const T* ae = reinterpret_cast<const T*>(&av);
    const T* be = reinterpret_cast<const T*>(&bv);
    const T* ce = reinterpret_cast<const T*>(&cv);
    T* ue = reinterpret_cast<T*>(&uo);
    T* ve = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      step(ae[k], be[k], ce[k], lam, alpha, oma, ue[k], ve[k]);
    __stcs(un + j, uo);
    __stcs(vn + j, vo);
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % kVecBytes == 0;
}

template <typename T, int VEC>
int launch_as(const T* u_t, const T* u_prev, const T* v, T* u_new, T* v_new,
              long long n, long long head, long long nvec, int blocks,
              double lam, double alpha, cudaStream_t stream) {
  if (VEC > 1 && !(aligned(u_t + head) && aligned(u_prev + head) &&
                   aligned(v + head) && aligned(u_new + head) &&
                   aligned(v_new + head)))
    return (int)cudaErrorMisalignedAddress;
  barrier_step_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      u_t, u_prev, v, u_new, v_new, n, head, nvec, (T)lam, (T)alpha,
      (T)(1.0 - alpha));
  return (int)cudaGetLastError();
}

// One launch of the plan (vec, head, nvec, blocks) over n elements.
template <typename T>
int launch(const void* u_t, const void* u_prev, const void* v, void* u_new,
           void* v_new, long long n, long long head, long long nvec, int vec,
           int blocks, double lam, double alpha, void* stream) {
  constexpr int kVec = kVecBytes / sizeof(T);
  if (n <= 0) return 0;
  if (head < 0 || nvec < 0 || blocks < 1 || head + nvec * vec > n ||
      (vec != 1 && vec != kVec) || (vec == 1 && (head != 0 || nvec != n)) ||
      n - head - nvec * vec > (long long)blocks * kThreads ||
      head > (long long)blocks * kThreads)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const T*>(u_t), b = static_cast<const T*>(u_prev),
       c = static_cast<const T*>(v);
  auto un = static_cast<T*>(u_new), vn = static_cast<T*>(v_new);
  return vec == 1
      ? launch_as<T, 1>(a, b, c, un, vn, n, head, nvec, blocks, lam, alpha, s)
      : launch_as<T, kVec>(a, b, c, un, vn, n, head, nvec, blocks, lam, alpha,
                           s);
}

template <typename T>
int residency(int vec, int* resident, int* sms) {
  constexpr int kVec = kVecBytes / sizeof(T);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (vec == 1)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        resident, barrier_step_kernel<T, 1>, kThreads, 0);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      resident, barrier_step_kernel<T, kVec>, kThreads, 0);
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch over n elements on `stream`: the scalar head [0, head), nvec
// vectors of `vec` elements, the scalar tail, on `blocks` blocks of 256
// threads; returns the CUDA error code.
int abip_barrier_step_f32(const void* u_t, const void* u_prev, const void* v,
                          void* u_new, void* v_new, long long n,
                          long long head, long long nvec, int vec, int blocks,
                          double lam, double alpha, void* stream) {
  return launch<float>(u_t, u_prev, v, u_new, v_new, n, head, nvec, vec,
                       blocks, lam, alpha, stream);
}

int abip_barrier_step_f64(const void* u_t, const void* u_prev, const void* v,
                          void* u_new, void* v_new, long long n,
                          long long head, long long nvec, int vec, int blocks,
                          double lam, double alpha, void* stream) {
  return launch<double>(u_t, u_prev, v, u_new, v_new, n, head, nvec, vec,
                        blocks, lam, alpha, stream);
}

// The current device's SM count and the blocks of the kernel of this type
// and vector width that one SM holds at once.
int abip_barrier_step_residency(int f64, int vec, int* resident, int* sms) {
  return f64 ? residency<double>(vec, resident, sms)
             : residency<float>(vec, resident, sms);
}

// An empty kernel, <<<1, 32>>>: the launch floor a short kernel cannot go
// under when timed the same way.
int abip_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
