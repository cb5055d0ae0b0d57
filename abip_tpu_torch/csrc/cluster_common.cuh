// Thread-block cluster helpers for Hopper (sm_90a): the cluster barrier in
// its split form, and sums over the cluster read in rank order.
//
// A cluster's CTAs run together on neighbouring SMs of one GPC and can read
// each other's shared memory (distributed shared memory).  The sums here
// read every CTA's partial in rank order 0, 1, ..., C-1, so every CTA of the
// cluster holds bit-identical sums: a kernel whose CTAs take a decision
// (stop or go on) from such a sum takes the same one in all of them, which
// it must, since a CTA that leaves its loop early would never reach the
// next cluster barrier.

#pragma once

#include <cooperative_groups.h>

namespace cluster_ops {

namespace cg = cooperative_groups;

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

constexpr int kMaxCluster = 16;  // the largest cluster Hopper allows

// Sum over the cluster's C ranks, in rank order 0..C-1, of vec[i] in each
// CTA's shared memory (vec is this CTA's address of the buffer); the C
// remote loads are all issued before the first add.  Call after a cluster
// barrier that follows the writes.
__device__ __forceinline__ float rank_sum(const float* vec, int i, int C) {
  cg::cluster_group cl = cg::this_cluster();
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    v[r] = (r < C) ? cl.map_shared_rank(const_cast<float*>(vec), r)[i] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < C) s += v[r];
  return s;
}

}  // namespace cluster_ops
