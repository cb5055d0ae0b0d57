// The LASSO operator's Schur PCG iteration on Hopper (sm_90a), f64: two
// kernels an iteration, F1 (the S-apply's pass over X) and F2 (the vector
// step), replayed in the Schur PCG's block graph (`linsys.schur`).
//
// Replaces no TPU kernel: the JAX package runs this PCG as XLA ops.  It takes
// the place of `linsys.cg.pcg_block`'s ~36 torch launches and two cuBLAS
// `gemv`s a PCG iteration on `problems.lasso_operator`'s products, and
// computes what `abip_tpu_torch/ops/lasso_pcg.py:f1_plain` and `f2_plain`
// compute (the twin of `cg._pcg_iteration` over `CGSchurSolver._S`).
//
// The operator is A_s = D^-1 A E^-1 with A = [[1,0,0,0,0], [0,0,I,X,-X]] over
// z = (t1, t2, r in R^m, w+ in R^n, w- in R^n), q = 2 + m + 2n.  Its Schur
// apply S p = A_s' (ry_inv o A_s p) + rho_x o p reads X through
//   w   = p_w+ / E_w+ - p_w- / E_w-                       (n)
//   v_i = (ry_inv_1+i ((p_r,i / E_r,i + (X w)_i) / D_1+i)) / D_1+i   (m)
//   X'v                                                   (n)
// and v_i depends on row i of X alone.
//
// F1, bound by reading X (m n 8 bytes, 40 MB at m = 1000, n = 5000: 12 us at
// 3.35 TB/s): one pass over X.  The grid is G clusters of C CTAs of 1024
// threads; CTA b = g C + rank holds the rows [b m / (G C), (b+1) m / (G C)).
// Thread t owns the columns t + 1024 k, k < K (K <= 8, a template argument),
// so its share of X'v stays in K registers.  Rows stream through two row
// stages in shared memory, filled by cp.async, so the next row is in flight
// while one is summed (more stages measured slower); a thread copies and
// reads its own columns only, so the stages need no barrier.  A
// row's dot with w (w in shared memory) is one CTA reduction, v_i follows,
// and v_i X_i,: is added from the stage that holds the row.  X is read once.
// At the end the C CTAs' partial X'v are summed in rank order over
// distributed shared memory, and cluster g writes one partial row
// partials[g, :].  F1 also writes v.
//
// F2, bound by latency (a few 88 KB vectors and G partial rows, all in L2):
// one cluster of ceil((n + 2 + m) / 1024) <= 8 CTAs, a thread for each pair
// (w+_j, w-_j) and each entry of (t1, t2, r).  A thread loads its unit's
// state, then F1's output for it (the partial rows, summed in order
// 0..G-1, or v), forms its share of S p, then alpha = <z, r> / <p, S p>, x, r, z = M o r, <z, r>,
// ||r||, beta and p, with two cluster-wide sums (block sums, then the CTAs'
// in rank order over distributed shared memory, so every CTA holds the same
// bits), and writes the next iteration's w for F1, <z, r>, the count and the
// running flag (count < cap and ||r|| >= tol).
//
// Each kernel may start before the one before it in the stream ends
// (programmatic dependent launch): F1 stages its first rows of X, which no
// kernel writes, while F2 of the iteration before runs, and F2 loads the
// state that the F2 before it wrote while F1 runs; each waits for the grid
// before it (griddepcontrol.wait) before it reads what that grid writes.
//
// The loop's state lives on the card: flag = [running, count] (int64), the
// block graph's flag that the host reads once a block.  Both kernels read
// it (after issuing loads, which change nothing) and return where the loop
// has stopped, so x, r, p, <z, r> and the count stay those of the
// iteration that stopped it.  No
// floating-point atomics: every sum has a fixed order, so the same inputs
// give the same bits on every run.  IEEE division and sqrt (no fast math).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;   // CTAs of a cluster of either kernel
                                 // at most (a portable size)
constexpr int kMaxSmem = 231424; // dynamic shared memory F1 may take, bytes
constexpr int kChunk = 8;        // partial rows F2 loads at once
constexpr int kStages = 2;       // F1's row stages in shared memory
static_assert(kWarps == 32, "a CTA's warp sums are one warp's lanes");

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Programmatic dependent launch: wait for the grid before this one in the
// stream to end (its writes visible), and let the grid after this one start.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// A butterfly sum: partners add the same two values, so every lane ends
// with the same bits.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sum of v, the same bits in every thread; `s_warp` holds the
// warps' sums and is read after one barrier (a caller that sums again
// passes another buffer, or a barrier lies between).
__device__ __forceinline__ double block_sum(double v, double* s_warp) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_sum(s_warp[threadIdx.x & 31]);
}

// block_sum of two values at once, with one barrier.
__device__ __forceinline__ void block_sum2(double& u, double& v, double* s_u,
                                           double* s_v) {
  u = warp_sum(u);
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) {
    s_u[threadIdx.x >> 5] = u;
    s_v[threadIdx.x >> 5] = v;
  }
  __syncthreads();
  u = warp_sum(s_u[threadIdx.x & 31]);
  v = warp_sum(s_v[threadIdx.x & 31]);
}

// The cluster's sum of the CTAs' `s_slot[k]`, in rank order 0..C-1, the same
// bits in every thread of every CTA.  Call after a cluster barrier that
// follows the writes.
__device__ __forceinline__ double cluster_total(double* s_slot, int k, int C) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const double mine = lane < C ? *cl.map_shared_rank(s_slot + k, lane) : 0.0;
  double s = 0.0;
  for (int r = 0; r < C; ++r) s += __shfl_sync(0xffffffffu, mine, r);
  return s;
}

struct F1Args {
  const double* X;          // (m, n), rows contiguous
  const double* D;          // (1 + m)
  const double* E;          // (q)
  const double* ry_inv;     // (1 + m)
  const double* p;          // (q)
  const double* w;          // (n)
  const long long* flag;    // [running, count]
  double* v;                // (m)
  double* partials;         // (G, n)
  int m, n;
};

// cp.async of 8 bytes from global to shared memory, its commit and wait
__device__ __forceinline__ void copy8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row i of X into a stage: thread t's columns t + 1024 k, each thread
// copying (and later reading) its own columns only.
template <int K>
__device__ __forceinline__ void stage_row(const double* X, int n, int i,
                                          double* stage) {
  const double* row = X + (size_t)i * n;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < n) copy8(stage + j, row + j);
  }
}

// Row t of the CTA (row r0 + t of X), in `stage`: its dot with w (s_w), one
// CTA sum, v from the row's scalars (s_row: p_r,i / E_r,i, D_1+i,
// ry_inv_1+i), then acc += v_i X_i,:.  s_red[t & 1] holds the warps' sums:
// the barrier of row t + 1 lies between row t's reads and row t + 2's
// writes of one buffer.
template <int K>
__device__ __forceinline__ void take_row(const double* stage, int t, int r0,
                                         double (&acc)[K], int n,
                                         const double* s_w,
                                         const double* s_row,
                                         double (*s_red)[kWarps], double* v) {
  const int tid = threadIdx.x, lane = tid & 31;
  double d = 0.0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * kThreads;
    if (j < n) d += stage[j] * s_w[j];
  }
  d = warp_sum(d);
  double* red = s_red[t & 1];
  if (lane == 0) red[tid >> 5] = d;
  __syncthreads();
  const double xw = warp_sum(red[lane]);
  const double dd = s_row[3 * t + 1];
  const double vi = (s_row[3 * t + 2] * ((s_row[3 * t] + xw) / dd)) / dd;
  if (tid == 0) v[r0 + t] = vi;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * kThreads;
    if (j < n) acc[k] += vi * stage[j];
  }
}

// K columns a thread
template <int K>
__global__ void __launch_bounds__(kThreads, 1) f1_kernel(F1Args a) {
  // w, then this CTA's X'v (n); kStages row stages (n each); the rows'
  // scalars
  extern __shared__ double s_buf[];
  __shared__ double s_red[2][kWarps];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int m = a.m, n = a.n;
  const int b = blockIdx.x;
  const int r0 = (int)((long long)b * m / gridDim.x);
  const int rows = (int)((long long)(b + 1) * m / gridDim.x) - r0;
  double* s_x = s_buf + n;
  double* s_row = s_x + (size_t)kStages * n;

  // the first kStages - 1 rows go out before the kernel before ends (X does
  // not change); one commit group a row, empty past the last
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    if (q < rows) stage_row<K>(a.X, n, r0 + q, s_x + (size_t)q * n);
    commit();
  }
  for (int t = tid; t < rows; t += kThreads) {
    s_row[3 * t + 1] = a.D[1 + r0 + t];
    s_row[3 * t + 2] = a.ry_inv[1 + r0 + t];
  }
  // what the kernel before wrote (F2: p, w, the flag) is read after it ends
  grid_wait();
  if (a.flag[0] == 0) {  // the loop has stopped: change nothing
    wait_groups<0>();
    return;
  }
  grid_launch_dependents();  // F2 may start; it waits for this grid's end
  // a thread reads w at its own columns only
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * kThreads;
    if (j < n) s_buf[j] = a.w[j];
  }
  for (int t = tid; t < rows; t += kThreads)
    s_row[3 * t] = a.p[2 + r0 + t] / a.E[2 + r0 + t];
  __syncthreads();  // the rows' scalars

  double acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0;
  for (int t = 0; t < rows; ++t) {
    // row t + kStages - 1 into the stage row t - 1 left (this thread's
    // columns, which it has read)
    const int q = t + kStages - 1;
    if (q < rows)
      stage_row<K>(a.X, n, r0 + q, s_x + (size_t)(q % kStages) * n);
    commit();
    wait_groups<kStages - 1>();  // row t has landed
    take_row<K>(s_x + (size_t)(t % kStages) * n, t, r0, acc, n, s_buf, s_row,
                s_red, a.v);
  }

  // X'v over w's place: a thread writes its own columns, which only it read
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * kThreads;
    if (j < n) s_buf[j] = acc[k];
  }
  cluster_sync();
  // rank r sums its slice of the columns over the cluster, in rank order
  const int cs = (n + C - 1) / C;
  const int j1 = min(n, (rank + 1) * cs);
  double* out = a.partials + (size_t)(b / C) * n;
  for (int j = rank * cs + tid; j < j1; j += kThreads) {
    double vals[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      vals[r] = r < C ? *cl.map_shared_rank(s_buf + j, r) : 0.0;
    double s = 0.0;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) s += vals[r];
    out[j] = s;
  }
  cluster_sync();  // no CTA leaves while another reads its shared memory
}

struct F2Args {
  const double* partials;   // (G, n)
  const double* v;          // (m)
  const double* D;          // (1 + m)
  const double* E;          // (q)
  const double* ry_inv;     // (1 + m)
  const double* rho_x;      // (q)
  const double* M;          // (q)
  const double* tol;        // ()
  const long long* cap;     // ()
  double* x;                // (q)
  double* r;                // (q)
  double* p;                // (q)
  double* w;                // (n)
  double* ipzr;             // (): <z, r>
  long long* flag;          // [running, count]
  int m, n, G;
};

// Thread u of the cluster (u = rank 1024 + tid) owns one unit: for u < n
// the pair w+_u, w-_u, for n <= u < n + 2 + m the head entry u - n (t1, t2,
// r), and nothing beyond (the plan takes C 1024 >= n + 2 + m).  The state
// loads go out before F1 ends and F1's output right after, so the step
// waits on memory once past F1; the rest is two cluster sums.
__global__ void __launch_bounds__(kThreads, 1) f2_kernel(F2Args a) {
  __shared__ double s_w1[kWarps], s_w2[kWarps], s_w3[kWarps];
  __shared__ double s_slot[3];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int m = a.m, n = a.n, head = 2 + m;
  const int u = rank * kThreads + tid;
  const bool pair = u < n, single = !pair && u < n + head;
  const int i1 = pair ? head + u : u - n, i2 = head + n + u;

  // the next F1 may start: until this grid ends it only reads X
  grid_launch_dependents();
  // what F2 of the iteration before wrote is complete (F1 waited for it
  // before letting this grid start); CTA 0 writes the flag and <z, r> after
  // the last cluster barrier
  const long long run = a.flag[0], its = a.flag[1];
  const double ipzr = *a.ipzr;
  double p1 = 0.0, E1 = 1.0, rho1 = 0.0, x1 = 0.0, r1 = 0.0, M1 = 0.0;
  double p2 = 0.0, E2 = 1.0, rho2 = 0.0, x2 = 0.0, r2 = 0.0, M2 = 0.0;
  double u1 = 0.0;  // the unit's A_s'(ry_inv o A_s p) before / E: X'v, pairs
  if (pair || single) {
    p1 = a.p[i1]; E1 = a.E[i1]; rho1 = a.rho_x[i1];
    x1 = a.x[i1]; r1 = a.r[i1]; M1 = a.M[i1];
  }
  if (pair) {
    p2 = a.p[i2]; E2 = a.E[i2]; rho2 = a.rho_x[i2];
    x2 = a.x[i2]; r2 = a.r[i2]; M2 = a.M[i2];
  }
  const double t1 = single && i1 == 0
                        ? (a.ry_inv[0] * ((p1 / E1) / a.D[0])) / a.D[0]
                        : 0.0;
  grid_wait();  // F1's partial rows and v
  if (pair) {
    for (int c0 = 0; c0 < a.G; c0 += kChunk) {  // kChunk loads in flight
      double part[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        part[c] = c0 + c < a.G ? a.partials[(size_t)(c0 + c) * n + u] : 0.0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (c0 + c < a.G) u1 += part[c];
    }
  } else if (single) {
    u1 = i1 >= 2 ? a.v[i1 - 2] : t1;
  }
  if (run == 0) return;  // the loop has stopped: change nothing

  // S p, and <p, S p>
  const double s1 = u1 / E1 + rho1 * p1;
  const double s2 = (-u1) / E2 + rho2 * p2;
  double ps = 0.0;
  if (pair || single) ps += p1 * s1;
  if (pair) ps += p2 * s2;
  ps = block_sum(ps, s_w1);
  if (tid == 0) s_slot[0] = ps;
  cluster_sync();
  const double alpha = ipzr / cluster_total(s_slot, 0, C);

  // x, r, z = M o r, <z, r> and ||r||^2
  const double xn1 = x1 + alpha * p1, rn1 = r1 - alpha * s1, z1 = M1 * rn1;
  const double xn2 = x2 + alpha * p2, rn2 = r2 - alpha * s2, z2 = M2 * rn2;
  double zr = 0.0, rr = 0.0;
  if (pair || single) {
    zr += z1 * rn1;
    rr += rn1 * rn1;
  }
  if (pair) {
    zr += z2 * rn2;
    rr += rn2 * rn2;
  }
  block_sum2(zr, rr, s_w2, s_w3);
  if (tid == 0) {
    s_slot[1] = zr;
    s_slot[2] = rr;
  }
  cluster_sync();
  const double ipzr_new = cluster_total(s_slot, 1, C);
  const double rr_all = cluster_total(s_slot, 2, C);
  const double beta = ipzr_new / ipzr;

  // p = z + beta p, and the next iteration's w
  const double pn1 = z1 + beta * p1, pn2 = z2 + beta * p2;
  if (pair || single) {
    a.x[i1] = xn1;
    a.r[i1] = rn1;
    a.p[i1] = pn1;
  }
  if (pair) {
    a.x[i2] = xn2;
    a.r[i2] = rn2;
    a.p[i2] = pn2;
    a.w[u] = pn1 / E1 - pn2 / E2;
  }
  cluster_sync();  // every CTA has read the slots
  if (rank == 0 && tid == 0) {
    const long long next = its + 1;
    *a.ipzr = ipzr_new;
    a.flag[1] = next;
    a.flag[0] = (next < *a.cap && sqrt(rr_all) >= *a.tol) ? 1 : 0;
  }
}

using F1Kernel = void (*)(F1Args);

F1Kernel f1_of(int n) {
  switch ((n + kThreads - 1) / kThreads) {
    case 1: return f1_kernel<1>;
    case 2: return f1_kernel<2>;
    case 3: return f1_kernel<3>;
    case 4: return f1_kernel<4>;
    case 5: return f1_kernel<5>;
    case 6: return f1_kernel<6>;
    case 7: return f1_kernel<7>;
    case 8: return f1_kernel<8>;
    default: return nullptr;
  }
}

// F1's dynamic shared memory over `ctas` CTAs: w (then X'v), the row
// stages and the most rows' scalars any CTA holds; -1 past the limit
int f1_smem(int m, int n, int ctas) {
  const long long rows = ((long long)m + ctas - 1) / ctas;
  const long long bytes = ((long long)n * (1 + kStages) + 3 * rows) *
                          (long long)sizeof(double);
  return bytes > kMaxSmem ? -1 : (int)bytes;
}

// A launch of `grid` CTAs in clusters of C that may start before the
// kernel before it in the stream ends (it waits in grid_wait).
void configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid,
               int C, int smem, void* stream) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg->gridDim = dim3(grid);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  cfg->attrs = attr;
  cfg->numAttrs = 2;
}

}  // namespace

extern "C" {

const char* abip_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Lets F1's kernel for width n take all of a CTA's shared memory (outside
// any capture, once a shape), and writes how
// many clusters of C CTAs of F1 for m rows the card holds at once into
// *clusters; returns the CUDA error.
int abip_lasso_pcg_prepare(int m, int n, int C, int* clusters) {
  const F1Kernel kernel = f1_of(n);
  const int smem = f1_smem(m, n, C);
  if (kernel == nullptr || C < 1 || C > kMaxCluster || smem < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  configure(&cfg, attr, C, C, smem, nullptr);
  cfg.numAttrs = 1;  // the cluster alone
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

// F1 over G clusters of C CTAs on `stream`; returns the CUDA error.
int abip_lasso_pcg_f1(const void* X, const void* D, const void* E,
                      const void* ry_inv, const void* p, const void* w,
                      const void* flag, void* v, void* partials, int m, int n,
                      int G, int C, void* stream) {
  const F1Kernel kernel = f1_of(n);
  const int smem = f1_smem(m, n, G * C);
  if (kernel == nullptr || G < 1 || C < 1 || C > kMaxCluster || smem < 0)
    return (int)cudaErrorInvalidValue;
  F1Args a;
  a.X = static_cast<const double*>(X);
  a.D = static_cast<const double*>(D);
  a.E = static_cast<const double*>(E);
  a.ry_inv = static_cast<const double*>(ry_inv);
  a.p = static_cast<const double*>(p);
  a.w = static_cast<const double*>(w);
  a.flag = static_cast<const long long*>(flag);
  a.v = static_cast<double*>(v);
  a.partials = static_cast<double*>(partials);
  a.m = m;
  a.n = n;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  configure(&cfg, attr, G * C, C, smem, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// F2 as one cluster of C CTAs, C 1024 >= n + 2 + m, on `stream`; returns
// the CUDA error.
int abip_lasso_pcg_f2(const void* partials, const void* v, const void* D,
                      const void* E, const void* ry_inv, const void* rho_x,
                      const void* M, const void* tol, const void* cap,
                      void* x, void* r, void* p, void* w, void* ipzr,
                      void* flag, int m, int n, int G, int C, void* stream) {
  if (G < 1 || C < 1 || C > kMaxCluster
      || (long long)C * kThreads < (long long)n + 2 + m)
    return (int)cudaErrorInvalidValue;
  F2Args a;
  a.partials = static_cast<const double*>(partials);
  a.v = static_cast<const double*>(v);
  a.D = static_cast<const double*>(D);
  a.E = static_cast<const double*>(E);
  a.ry_inv = static_cast<const double*>(ry_inv);
  a.rho_x = static_cast<const double*>(rho_x);
  a.M = static_cast<const double*>(M);
  a.tol = static_cast<const double*>(tol);
  a.cap = static_cast<const long long*>(cap);
  a.x = static_cast<double*>(x);
  a.r = static_cast<double*>(r);
  a.p = static_cast<double*>(p);
  a.w = static_cast<double*>(w);
  a.ipzr = static_cast<double*>(ipzr);
  a.flag = static_cast<long long*>(flag);
  a.m = m;
  a.n = n;
  a.G = G;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  configure(&cfg, attr, C, C, 0, stream);
  cudaError_t err = cudaLaunchKernelEx(&cfg, f2_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
