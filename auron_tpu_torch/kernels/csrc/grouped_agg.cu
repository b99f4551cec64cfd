// Dense grouped (sum, count) over a bounded key domain, for Hopper (sm_90a).
//
// Replaces: the Pallas VMEM-accumulate kernel of the JAX package,
// auron_tpu/kernels/grouped_agg.py `_vmem_agg_kernel` (launched by
// `pallas_sum_count`). Same contract: k int32[n], v f32[n] with nulls
// zeroed, c f32[n] 0/1; out sums, counts f32[key_domain]; rows whose key
// lies outside [0, key_domain) contribute nothing.
//
// Bound: the function must read 12 B per row and write 8 B per key, and
// does 2 adds per row, so bytes bound it. At 3.35 TB/s (H100 SXM) that is
// about 3.9 us for 2^20 rows x 2^16 keys and 15.2 us for 2^22 rows; at
// 2.0 TB/s (H100 PCIe) about 6.6 us and 25.4 us.
//
// Design: the TPU kernel accumulates [gh, 256] grids in VMEM across a
// sequential grid. Hopper blocks run in parallel in no order, and the
// 512 KB of f32 sum + count state for 2^16 keys exceeds a block's 227 KB
// of shared memory, so this first version keeps both grids in global
// memory, where they stay resident in the 50 MB L2, and folds every row
// in with float atomics from a grid-stride loop. Reads are coalesced and
// each row is read once; the cost is one L2 atomic per non-zero input.
// An add of zero is skipped: the accumulators start at +0.0 and can never
// become -0.0, so x + 0 == x for every value they take and the result is
// unchanged. Counts are exact below 2^24; float sums are summed in an
// order that changes from run to run, and are bit-exact only where every
// partial sum is (integer values, per-key totals below 2^24).
// Worst case: all rows on one key serialise on one address. Privatising
// key tiles in shared memory and warp-aggregating atomics is the next
// design.

#include <cuda_runtime.h>

namespace {

__global__ void dense_sum_count_kernel(const int* __restrict__ k,
                                       const float* __restrict__ v,
                                       const float* __restrict__ c,
                                       long long n, int key_domain,
                                       float* __restrict__ sums,
                                       float* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int key = k[i];
    // one unsigned compare rejects negative keys and keys >= key_domain
    if ((unsigned)key >= (unsigned)key_domain) continue;
    const float val = v[i];
    const float cnt = c[i];
    if (val != 0.0f) atomicAdd(sums + key, val);
    if (cnt != 0.0f) atomicAdd(counts + key, cnt);
  }
}

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks per SM

}  // namespace

// Launches on `stream` and returns cudaGetLastError(); sums and counts
// must be zeroed by the caller.
extern "C" int cuda_dense_sum_count(const void* k, const void* v,
                                    const void* c, long long n,
                                    int key_domain, void* sums,
                                    void* counts, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  dense_sum_count_kernel<<<(int)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)k, (const float*)v, (const float*)c, n, key_domain,
      (float*)sums, (float*)counts);
  return (int)cudaGetLastError();
}
