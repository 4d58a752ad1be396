// The thread-block-cluster pieces shared by the row-tile kernels K4
// (csrc/fused_step_batched.cu) and K6 (csrc/rollout_batched.cu), and the
// exchange through st.async and mbarriers of K5 (csrc/fused_step_hetero.cu).
//
// Both give a tile of state rows to a cluster of C blocks. Block c of the
// cluster owns the output columns [c*cw, (c+1)*cw) of every iteration and
// keeps that column slab of the rung in its shared memory, transposed so
// that a thread reads 16 bytes of its column at a time (`load_slab`). Every
// block holds the tile's whole rows of y, double buffered; an iteration
// computes the block's (rows, cw) piece and stores it 16 bytes at a time
// into the next buffer of every block of the cluster (`push16`), and one
// `cluster.sync()` ends the iteration: after it every piece has landed
// everywhere, and every read of the current buffer is done.
//
// Barrier rules: every block of a cluster reaches every cluster barrier,
// and no block exits while a peer may still write into its shared memory
// (a variant of K4 with __syncthreads() in place of its last cluster
// barrier failed with "unspecified launch failure").

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "tiers.cuh"

namespace {

// Elements in 16 bytes: 4 floats, 2 doubles or 8 bf16.
template <typename T> struct Vec16 { static constexpr int n = 16 / sizeof(T); };

// 16-byte loads of operand entries each thread has in flight while copying a
// slab into shared memory.
constexpr int kSlabCopyAhead = 4;

// The row stride of a transposed slab in shared memory: Dp plus 16 bytes,
// so that the 16-byte reads of neighbouring columns fall in distinct banks.
template <typename WT> __host__ __device__ inline int slab_stride(int dp) {
  return dp + Vec16<WT>::n;
}

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// n consecutive operand entries (n = 16 bytes of the state type) from
// shared memory: 16 bytes of fp32/fp64, 8 bytes of bf16.
__device__ __forceinline__ void loadw(const float* p, float (&v)[4]) { load16(p, v); }
__device__ __forceinline__ void loadw(const double* p, double (&v)[2]) { load16(p, v); }
__device__ __forceinline__ void loadw(const __nv_bfloat16* p, __nv_bfloat16 (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
  v[0] = e[0], v[1] = e[1], v[2] = e[2], v[3] = e[3];
}

// Rows i < dp, columns [0, cw) of the row-major (dp, dp) rung that `w`
// points into (w = rung + c*cw), into `slab` transposed: column jl at
// slab + jl * slab_stride(dp). Read 16 bytes at a time (cw is a whole
// number of 16-byte groups), kSlabCopyAhead loads in flight per thread;
// the block's threads share the work. The caller synchronizes after it.
template <typename WT>
__device__ void load_slab(WT* slab, const WT* w, int dp, int cw) {
  constexpr int VW = Vec16<WT>::n;
  const int wst = slab_stride<WT>(dp);
  const int cv = cw / VW;
  const int nvec = dp * cv;
  const int nt = blockDim.x;
  for (int t0 = threadIdx.x; t0 < nvec; t0 += kSlabCopyAhead * nt) {
    uint4 v[kSlabCopyAhead];
#pragma unroll
    for (int u = 0; u < kSlabCopyAhead; ++u) {
      const int t = t0 + u * nt;
      if (t < nvec)
        v[u] = *reinterpret_cast<const uint4*>(w + (size_t)(t / cv) * dp + (t % cv) * VW);
    }
#pragma unroll
    for (int u = 0; u < kSlabCopyAhead; ++u) {
      const int t = t0 + u * nt;
      if (t < nvec) {
        const int i = t / cv, j0 = (t % cv) * VW;
        const WT* e = reinterpret_cast<const WT*>(&v[u]);
#pragma unroll
        for (int q = 0; q < VW; ++q) slab[(size_t)(j0 + q) * wst + i] = e[q];
      }
    }
  }
}

// Stores the 16 bytes `v` at offset `at` of the shared buffer `local` in
// every block of the cluster (distributed shared memory), the block's own
// included.
template <typename T, int N>
__device__ __forceinline__ void push16(cooperative_groups::cluster_group& cluster, T* local,
                                       size_t at, const T (&v)[N]) {
  const int C = (int)cluster.num_blocks();
  for (int q = 0; q < C; ++q) store16(cluster.map_shared_rank(local, q) + at, v);
}

// Exchanges without a cluster barrier (K5): a block stores 16 bytes
// into a peer's shared memory with st.async, which completes that many
// bytes of the transaction count of an mbarrier in the peer; the peer waits
// on its own mbarrier's phase instead of on a cluster.sync(). One phase
// takes one arrival (the receiver's own expect_tx, which arms the phase
// with the bytes it will receive) and those bytes, in either order. The
// receiver learns only that its own data has landed, so the exchange costs
// a fraction of stores followed by a cluster.sync(), whose release and
// acquire wait for every block.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory location in block `rank`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// One thread initialises the block's mbarriers (one arrival per phase) and
// makes them visible to the cluster; a cluster.sync() must follow before
// any peer stores into the block.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar + i)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arms the current phase of `bar` with the bytes it is to receive (and the
// phase's one arrival).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed; what the
// peers stored for it is then visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "W: mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra W;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ uint4 bits16(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 bits16(const double (&v)[2]) {
  return make_uint4((unsigned)__double2loint(v[0]), (unsigned)__double2hiint(v[0]),
                    (unsigned)__double2loint(v[1]), (unsigned)__double2hiint(v[1]));
}

// Stores the 16 bytes `v` at offset `at` of `buf` in block q (the same
// offset of the same buffer as in this block), completing 16 bytes on q's
// `bar`.
template <typename T>
__device__ __forceinline__ void send16(T* buf, size_t at, const uint4& v, uint64_t* bar, int q) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(peer_addr(smem_addr(buf + at), q)),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(peer_addr(smem_addr(bar), q))
      : "memory");
}

}  // namespace
