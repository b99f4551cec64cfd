// Dense grouped (sum, count) over a bounded key domain, for Hopper (sm_90a).
//
// Replaces: the Pallas VMEM-accumulate kernel of the JAX package,
// auron_tpu/kernels/grouped_agg.py `_vmem_agg_kernel` (launched by
// `pallas_sum_count`). Same contract: k int32[n], v f32[n] with nulls
// zeroed, c f32[n] 0/1; out (sum, count) f32 per key; rows whose key lies
// outside [0, key_domain) contribute nothing.
//
// Bound: the function must read 12 B per row and write 8 B per key, and
// does 2 adds per row, so bytes bound it. At 3.35 TB/s (H100 SXM) that is
// about 3.9 us for 2^20 rows x 2^16 keys and 15.2 us for 2^22 rows.
//
// What held the first design back, and what this one does about it
// (times: PERF.md):
//
// 1. Two scalar L2 atomics per kept row, on two arrays. The state is one
//    interleaved float2 (sum, count) per key, one 8-byte slot on one
//    cache line, and a row goes in with ONE vector atomic,
//    `atomicAdd(float2*, float2)` (global memory, compute capability
//    9.x), which compiles to one `REDG.E.ADD.F32x2.FTZ.RN.STRONG.GPU`
//    (cuobjdump -sass; the first design issued two
//    `REDG.E.ADD.F32.FTZ.RN.STRONG.GPU`). A row that adds (0, 0) is
//    skipped: the accumulators start at +0.0 and never become -0.0, so
//    x + 0 == x for every value they take.
// 2. Scalar loads, one row per thread. Each thread loads 4 consecutive
//    rows per pass as one int4 and two float4 (16-byte loads), in a
//    grid-stride loop; a scalar loop in the same kernel takes the n % 4
//    tail, and all rows when an operand is not 16-byte aligned. The grid
//    is the device's SM count times the resident blocks per SM, from
//    cudaDeviceGetAttribute and cudaOccupancyMaxActiveBlocksPerMultiprocessor
//    (the wrapper's `_plan` turns them into a launch; `threads` and
//    `shared_threads` come from cuda_dense_sum_count_props too).
// 3. Equal keys serialised on one address (a single group took ~100x the
//    time of spread keys). Equal keys are combined before the atomic:
//    a thread's 4 rows fold runs of equal keys; `__match_any_sync` finds
//    the lanes of the warp that hold the same key, a shuffle tree sums
//    their (sum, count), and the lowest such lane alone goes on. A key
//    the warp held on two lanes or more is hot: it claims a slot of a
//    64-entry per-block table in shared memory (`ATOMS.CAS`) and adds
//    there, so a hot key costs one L2 atomic per block, not one per warp.
//    The match costs instructions where peers are rare (spread keys), so
//    it runs only where a vote finds a duplicate: lane 0's key on another
//    lane, a thread that merged rows, or a key of the hot table. Matching
//    always, without the vote, was 6-8% slower on spread keys at 2^20
//    rows and 8-13% faster on skewed ones (PERF.md); the flagship's keys
//    are spread.
// 4. Hopper's shared memory. Where the domain's float2 state fits a
//    block's dynamic shared memory and each block sees a row per key or
//    more, every block (1024 threads, two per SM) keeps a private copy,
//    folds its rows into it with shared-memory atomics after the same
//    combining (float adds there are `ATOMS.CAST.SPIN` compare-and-swap
//    loops: Hopper has no native shared-memory float add), and flushes
//    its non-zero entries with step 1's vector atomic. The flagship's
//    2^16 keys (512 KB) do not fit 227 KB, so it stays on the global
//    path. A cluster's distributed shared memory does not pay there
//    either: four CTAs x 128 KB would hold the domain, but 33 clusters
//    flushing 2^16 float2 each is ~2.2M atomics, more than the ~0.72M
//    that 2^20 rows need.
//
// Numbers: counts are exact below 2^24; float sums are summed in an order
// that changes from run to run (atomics, combining), and are bit-exact
// only where every partial sum is (integer values, per-key totals below
// 2^24). A NaN in v reaches its own key only.
//
// `dense_sum_count_pr1` is the first design's loop, kept unchanged as the
// yardstick that chip_smoke.py times against this one; nothing on the
// main path reaches it.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // global path
constexpr int kSharedThreads = 1024;  // shared path
constexpr int kHotSlots = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

}  // namespace

// the block's private accumulators on the shared-memory path
extern __shared__ float2 block_acc[];
// the global path's per-block table of hot keys: a key that a warp found
// on two lanes or more claims the slot key % kHotSlots if it is free, and
// later hot rows of that key in the block add here instead of in L2
__shared__ int hot_key[kHotSlots];
__shared__ float2 hot_acc[kHotSlots];

namespace {

// A row's key, or -1 where the row adds nothing: its key lies outside
// [0, key_domain) (one unsigned compare), or it adds (0, 0).
__device__ __forceinline__ int live_key(int key, float val, float cnt,
                                        int key_domain) {
  return ((unsigned)key < (unsigned)key_domain &&
          (val != 0.0f || cnt != 0.0f)) ? key : -1;
}

// Sums (s, c) over the lanes of the warp that hold the same key >= 0, in
// a shuffle tree of log2(peers) steps; returns the number of such lanes
// on the lowest of them, which alone holds the total, and 0 on every
// other lane. All 32 lanes call it together.
__device__ __forceinline__ int combine_peers(int key, float& s, float& c) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned peers = __match_any_sync(kFull, key);
  if (key < 0) peers = 0u;
  const unsigned below = peers & ((1u << lane) - 1u);
  unsigned above = peers & ~((2u << lane) - 1u);
  unsigned rank = __popc(below);
  while (__any_sync(kFull, above != 0u)) {
    // each lane adds the partial of the next peer above it that is still
    // live; then the peers of odd rank are spent
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? (int)lane : next;
    const float ts = __shfl_sync(kFull, s, src);
    const float tc = __shfl_sync(kFull, c, src);
    if (next >= 0) {
      s += ts;
      c += tc;
    }
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return key >= 0 && below == 0u ? __popc(peers) : 0;
}

// One vector reduction into L2; an add of (0, 0) is skipped.
__device__ __forceinline__ void add_global(float2* acc, int key, float s,
                                           float c) {
  if (s != 0.0f || c != 0.0f) atomicAdd(acc + key, make_float2(s, c));
}

struct GlobalSink {
  float2* acc;
  // a key this block's table holds (a racy read: only a hint)
  __device__ __forceinline__ bool known_hot(int key) const {
    return key >= 0 &&
           reinterpret_cast<volatile int*>(hot_key)[key & (kHotSlots - 1)]
               == key;
  }
  // `hot`: the warp held the key on two lanes or more
  __device__ __forceinline__ void add(int key, float s, float c,
                                      bool hot) const {
    if (hot) {
      const int slot = key & (kHotSlots - 1);
      const int owner = atomicCAS(&hot_key[slot], -1, key);
      if (owner == -1 || owner == key) {
        atomicAdd(&hot_acc[slot].x, s);
        atomicAdd(&hot_acc[slot].y, c);
        return;
      }
    }
    add_global(acc, key, s, c);
  }
};

struct SharedSink {
  __device__ __forceinline__ bool known_hot(int) const { return false; }
  __device__ __forceinline__ void add(int key, float s, float c,
                                      bool) const {
    if (s != 0.0f) atomicAdd(&block_acc[key].x, s);
    if (c != 0.0f) atomicAdd(&block_acc[key].y, c);
  }
};

// Folds one slot of the warp into `sink`. The match is skipped where a
// cheap vote finds no duplicate in the warp: no lane holds lane 0's key,
// no thread merged rows, and no lane holds a key of the hot table.
template <class Sink>
__device__ __forceinline__ void emit(int key, float s, float c, bool merged,
                                     const Sink& sink) {
  const int first = __shfl_sync(kFull, key, 0);
  const bool dup = __any_sync(
      kFull, merged || sink.known_hot(key) ||
                 ((threadIdx.x & 31u) != 0u && key >= 0 && key == first));
  if (!dup) {
    if (key >= 0) sink.add(key, s, c, false);
    return;
  }
  const int lanes = combine_peers(key, s, c);
  if (lanes > 0) sink.add(key, s, c, lanes > 1);
}

// The shared path's blocks are 1024 threads, two resident per SM: fewer
// private copies to flush than 256-thread blocks, as many warps in flight.
template <bool kShared>
__global__ void __launch_bounds__(kShared ? kSharedThreads : kThreads,
                                  kShared ? 2 : 1)
dense_sum_count_kernel(const int* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ c, long long n,
                       int key_domain, float2* __restrict__ acc) {
  if (kShared) {
    for (int i = threadIdx.x; i < key_domain; i += blockDim.x)
      block_acc[i] = make_float2(0.0f, 0.0f);
  } else if (threadIdx.x < kHotSlots) {
    hot_key[threadIdx.x] = -1;
    hot_acc[threadIdx.x] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const GlobalSink to_global{acc};
  const SharedSink to_shared{};
  const unsigned lane = threadIdx.x & 31u;
  const long long stride = (long long)gridDim.x * blockDim.x;
  // loops run per warp, so every lane takes part in the warp's votes
  const long long warp0 =
      (long long)blockIdx.x * blockDim.x + (threadIdx.x & ~31u);

  const bool aligned = ((reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(c)) & 15u) == 0;
  const long long nvec = aligned ? n / 4 : 0;
  const int4* k4 = reinterpret_cast<const int4*>(k);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  for (long long base = warp0; base < nvec; base += stride) {
    const long long i = base + lane;
    int key[4] = {-1, -1, -1, -1};
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float cn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (i < nvec) {
      const int4 kk = __ldg(k4 + i);
      const float4 vv = __ldg(v4 + i);
      const float4 cc = __ldg(c4 + i);
      s[0] = vv.x; s[1] = vv.y; s[2] = vv.z; s[3] = vv.w;
      cn[0] = cc.x; cn[1] = cc.y; cn[2] = cc.z; cn[3] = cc.w;
      key[0] = live_key(kk.x, s[0], cn[0], key_domain);
      key[1] = live_key(kk.y, s[1], cn[1], key_domain);
      key[2] = live_key(kk.z, s[2], cn[2], key_domain);
      key[3] = live_key(kk.w, s[3], cn[3], key_domain);
    }
    // a run of equal keys folds into its first row, right to left
    bool merged = false;
#pragma unroll
    for (int j = 3; j > 0; --j) {
      if (key[j] >= 0 && key[j] == key[j - 1]) {
        s[j - 1] += s[j];
        cn[j - 1] += cn[j];
        key[j] = -1;
        merged = true;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kShared) emit(key[j], s[j], cn[j], merged, to_shared);
      else emit(key[j], s[j], cn[j], merged, to_global);
    }
  }
  for (long long base = nvec * 4 + warp0; base < n; base += stride) {
    const long long i = base + lane;
    int key = -1;
    float s = 0.0f, cn = 0.0f;
    if (i < n) {
      s = v[i];
      cn = c[i];
      key = live_key(k[i], s, cn, key_domain);
    }
    if (kShared) emit(key, s, cn, false, to_shared);
    else emit(key, s, cn, false, to_global);
  }
  __syncthreads();
  if (kShared) {
    for (int i = threadIdx.x; i < key_domain; i += blockDim.x)
      add_global(acc, i, block_acc[i].x, block_acc[i].y);
  } else if (threadIdx.x < kHotSlots && hot_key[threadIdx.x] >= 0) {
    add_global(acc, hot_key[threadIdx.x], hot_acc[threadIdx.x].x,
               hot_acc[threadIdx.x].y);
  }
}

// The first design, unchanged: one row per thread, two scalar
// atomics per kept row into separate sum and count arrays.
__global__ void dense_sum_count_pr1(const int* __restrict__ k,
                                    const float* __restrict__ v,
                                    const float* __restrict__ c,
                                    long long n, int key_domain,
                                    float* __restrict__ sums,
                                    float* __restrict__ counts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int key = k[i];
    if ((unsigned)key >= (unsigned)key_domain) continue;
    const float val = v[i];
    const float cnt = c[i];
    if (val != 0.0f) atomicAdd(sums + key, val);
    if (cnt != 0.0f) atomicAdd(counts + key, cnt);
  }
}
constexpr int kPr1MaxBlocks = 132 * 16;

struct DeviceSetup {
  bool ready;
  int sms;
  int smem_optin;
};
DeviceSetup g_setup[kMaxDevices];

// Makes `device` current until the end of the scope, and reads its SM
// count and opt-in shared memory once; the shared-path kernel is allowed
// that much dynamic shared memory then.
class OnDevice {
 public:
  explicit OnDevice(int device) : device_(device) {
    if (device_ < 0 || device_ >= kMaxDevices) {
      err_ = cudaErrorInvalidDevice;
      return;
    }
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) {
      err_ = cudaSetDevice(device_);
      switched_ = err_ == cudaSuccess;
    }
    if (err_ == cudaSuccess && !g_setup[device_].ready) err_ = setup();
  }
  ~OnDevice() {
    if (switched_) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }
  const DeviceSetup& setup_of() const { return g_setup[device_]; }

 private:
  cudaError_t setup() {
    DeviceSetup& d = g_setup[device_];
    cudaError_t err = cudaDeviceGetAttribute(
        &d.sms, cudaDevAttrMultiProcessorCount, device_);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device_);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          dense_sum_count_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, d.smem_optin);
    if (err == cudaSuccess) d.ready = true;
    return err;
  }
  int device_;
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_;
};

// Zeroes acc (float2[key_domain]) on `st`, once `on` made its device
// current.
cudaError_t zero_acc(const OnDevice& on, void* acc, int key_domain,
                     cudaStream_t st) {
  const cudaError_t err = on.error();
  if (err != cudaSuccess) return err;
  return cudaMemsetAsync(acc, 0, (size_t)key_domain * sizeof(float2), st);
}

}  // namespace

// The launch inputs of `device`: out[0] SM count, out[1] opt-in dynamic
// shared memory per block (bytes), out[2] resident blocks per SM of the
// global-path kernel, out[3] of the shared-path kernel with `smem_bytes`
// of dynamic shared memory (0: does not fit), out[4] and out[5] the
// threads per block of the global and the shared path.
extern "C" int cuda_dense_sum_count_props(int device, int smem_bytes,
                                          int* out) {
  const OnDevice on(device);
  cudaError_t err = on.error();
  if (err != cudaSuccess) return (int)err;
  const DeviceSetup& d = on.setup_of();
  out[0] = d.sms;
  out[1] = d.smem_optin;
  out[3] = 0;
  out[4] = kThreads;
  out[5] = kSharedThreads;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[2], dense_sum_count_kernel<false>, kThreads, 0);
  if (err == cudaSuccess && smem_bytes <= d.smem_optin)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], dense_sum_count_kernel<true>, kSharedThreads, smem_bytes);
  return (int)err;
}

// Zeroes acc (float2[key_domain]) and launches `blocks` blocks on `stream`
// of `device`: the shared-memory path with `smem_bytes` of dynamic shared
// memory where smem_bytes > 0, else the global path (the wrapper's plan).
// Returns the first CUDA error, the launch's cudaGetLastError() last.
extern "C" int cuda_dense_sum_count(int device, const void* k, const void* v,
                                    const void* c, long long n,
                                    int key_domain, void* acc, int blocks,
                                    int smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || key_domain <= 0 || blocks <= 0 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  const cudaError_t err = zero_acc(on, acc, key_domain, st);
  if (err != cudaSuccess || n == 0) return (int)err;
  if (smem_bytes > 0)
    dense_sum_count_kernel<true><<<blocks, kSharedThreads, smem_bytes, st>>>(
        (const int*)k, (const float*)v, (const float*)c, n, key_domain,
        (float2*)acc);
  else
    dense_sum_count_kernel<false><<<blocks, kThreads, 0, st>>>(
        (const int*)k, (const float*)v, (const float*)c, n, key_domain,
        (float2*)acc);
  return (int)cudaGetLastError();
}

// The first design's launch, for chip_smoke.py's comparison: zeroes acc
// (float[2 key_domain]) and writes sums to acc[0, key_domain) and counts
// to acc[key_domain, 2 key_domain).
extern "C" int cuda_dense_sum_count_pr1(int device, const void* k,
                                        const void* v, const void* c,
                                        long long n, int key_domain,
                                        void* acc, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 0 || key_domain <= 0) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  const cudaError_t err = zero_acc(on, acc, key_domain, st);
  if (err != cudaSuccess || n == 0) return (int)err;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kPr1MaxBlocks) blocks = kPr1MaxBlocks;
  float* sums = (float*)acc;
  dense_sum_count_pr1<<<(int)blocks, kThreads, 0, st>>>(
      (const int*)k, (const float*)v, (const float*)c, n, key_domain, sums,
      sums + key_domain);
  return (int)cudaGetLastError();
}
