// Fused barrier step for Hopper (sm_90a): over-relaxation, log-barrier prox
// and dual update, elementwise, f32 and f64.
//
// Replaces the TPU kernel `_kernel` of `abip_tpu/ops/prox_pallas.py` (entry
// `fused_barrier_step`).  It computes what
// `abip_tpu_torch/ops/prox.py:_ref_impl` computes, per element:
//   rel = alpha u_t + (1 - alpha) u_prev;  t = rel - v
//   u_new = prox(t, lam);                 v_new = v + u_new - rel
// One thread per element (grid-stride), three reads and two writes: 40 bytes
// per element in f64, 20 in f32, so HBM bandwidth bounds it, and at the
// lengths the port meets (n up to a few 1e4) the launch does.
//
// Numerics: IEEE `sqrt` and `/` (build without -use_fast_math).  The prox
// takes the cancellation-free form for t < 0, 2 lam / (sqrt(t^2 + 4 lam) - t);
// the reference's guarded form is wrong for |t| below ~1e-15 (f32) or
// ~1e-150 (f64).  1 - alpha is formed in double and rounded, as the plain
// version forms it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
barrier_step_kernel(const T* __restrict__ u_t, const T* __restrict__ u_prev,
                    const T* __restrict__ v, T* __restrict__ u_new,
                    T* __restrict__ v_new, long long n, T lam, T alpha, T oma) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const T vi = v[i];
    const T rel = alpha * u_t[i] + oma * u_prev[i];
    const T t = rel - vi;
    const T s = sqrt(t * t + T(4) * lam);
    const T un = (t >= T(0)) ? T(0.5) * (t + s) : T(2) * lam / (s - t);
    u_new[i] = un;
    v_new[i] = (vi + un) - rel;
  }
}

template <typename T>
int launch(const void* u_t, const void* u_prev, const void* v, void* u_new,
           void* v_new, long long n, double lam, double alpha, void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // grid-stride beyond that
  barrier_step_kernel<T><<<(int)blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u_t), static_cast<const T*>(u_prev),
      static_cast<const T*>(v), static_cast<T*>(u_new), static_cast<T*>(v_new),
      n, (T)lam, (T)alpha, (T)(1.0 - alpha));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch over n elements on `stream`; returns the CUDA error code.
int abip_barrier_step_f32(const void* u_t, const void* u_prev, const void* v,
                          void* u_new, void* v_new, long long n, double lam,
                          double alpha, void* stream) {
  return launch<float>(u_t, u_prev, v, u_new, v_new, n, lam, alpha, stream);
}

int abip_barrier_step_f64(const void* u_t, const void* u_prev, const void* v,
                          void* u_new, void* v_new, long long n, double lam,
                          double alpha, void* stream) {
  return launch<double>(u_t, u_prev, v, u_new, v_new, n, lam, alpha, stream);
}

}  // extern "C"
