// Batched set-associative cache simulation for Hopper (sm_90a): the scan
// of the batched cache engine, one lane a CTA.
//
// Replaces: src/repro/core/cachesim_jax.py::_lane_scan and _scan_kernel
// (the jitted, vmapped lax.scan at :293), which XLA compiles; it has no
// pallas_call. Same function: every lane starts cold and steps its access
// stream through LRU, FIFO, random or prob set-associative state, one hit
// bit an access. For LRU and FIFO the bits are the reference oracle's; the
// random and prob victims come from the uniforms `u` that the caller draws,
// so the kernel matches its plain version (kernels/ref.py) bit for bit on
// every lane.
//
// Bound on an H100 SXM: latency, not bytes or operations. The bytes (13 of
// input and 1 of output an access) take 14 * B * K / 3.35 TB/s, 4.4 us for
// 16 lanes of 2^16 accesses, and the operations (two integer operations a
// way of the accessed set) a few us more on the CUDA cores. But each access
// of a lane depends on the state the one before left, so a lane takes K
// dependent steps, each at least one shared-memory round trip: the K steps
// of one lane are the least time (chip_smoke.py computes all three).
//
// Design. One CTA a lane; its tag and stamp planes (int32, T x W of the
// lane's own sets and widest set) in shared memory; the threads over the
// ways, each thread owning ways tid, tid + blockDim, ... for the whole run,
// so that a way's tag and stamp are read and written by one thread only
// and the planes need no barrier. A step: each thread looks for the line
// in its ways and keeps the least key of its ways, where an empty way's
// key is its index and a filled way's is (stamp + 1) << 32 | index, so the
// least key names the first empty way while the set is filling (the cold
// fill of the reference, whose empty ways are always the last ones) and
// then the first least-recently stamped way (jnp.argmin's first minimum);
// a warp reduction (a ballot for the hit, shuffles for the key), one
// barrier, and every thread reduces the warps' results. Random and prob
// lanes take their victim from u, the prob lanes through the cumulative
// way weights that the caller computes once in float32. Stamps restamp on
// hit and insert under LRU, on insert only under FIFO, never under random
// and prob. The access streams are staged in shared memory CHUNK steps at
// a time. A lane whose planes do not fit the CTA's opt-in shared memory is
// refused (the wrapper raises).

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int CHUNK = 512;                      // staged steps of the streams
constexpr int STAGE_BYTES = CHUNK * (4 + 4 + 4 + 4);
constexpr int SLOT_BYTES = 2 * MAX_WARPS * (8 + 4);   // per-warp results, 2 steps
constexpr unsigned long long EMPTY_KEY = ~0ull;

__host__ __device__ constexpr long long lane_smem_bytes(int t, int w) {
  // tags and stamps (T x W each), the ways of each set, the cumulative
  // weights, the staged streams and the per-warp slots
  return 8ll * t * w + 4ll * t + 4ll * w + STAGE_BYTES + SLOT_BYTES;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other < v ? other : v;
  }
  return v;
}

// ways (B, T): each set's way count, 0 past the lane's sets; policy (B,):
// 0 lru, 1 fifo, 2 random, 3 prob; cum (B, W): cumulative way weights of
// the prob lanes; sets, lines (B, K) int32, valid (B, K) bool, u (B, K)
// f32; hits (B, K) bool.
__global__ void __launch_bounds__(MAX_THREADS)
batch_cache_kernel(const int* __restrict__ ways, const int* __restrict__ policy,
                   const float* __restrict__ cum, const int* __restrict__ sets,
                   const int* __restrict__ lines, const bool* __restrict__ valid,
                   const float* __restrict__ u, bool* __restrict__ hits, int tmax, int wmax,
                   long long k_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int* lane_ways = ways + static_cast<long long>(lane) * tmax;

  // the lane's own T (sets with ways) and W (its widest set), which every
  // thread reads alike
  int T = 0, W = 0;
  for (int i = 0; i < tmax; ++i)
    if (lane_ways[i] > 0) {
      T = i + 1;
      W = lane_ways[i] > W ? lane_ways[i] : W;
    }

  auto* slot_key = reinterpret_cast<unsigned long long*>(smem);          // [2][MAX_WARPS]
  auto* slot_hit = reinterpret_cast<int*>(smem + 2 * MAX_WARPS * 8);     // [2][MAX_WARPS]
  auto* s_sets = reinterpret_cast<int*>(smem + SLOT_BYTES);
  auto* s_lines = s_sets + CHUNK;
  auto* s_u = reinterpret_cast<float*>(s_lines + CHUNK);
  auto* s_valid = reinterpret_cast<int*>(s_u + CHUNK);
  auto* tags = s_valid + CHUNK;                                          // [T][W]
  auto* stamps = tags + static_cast<long long>(T) * W;                   // [T][W]
  auto* s_ways = stamps + static_cast<long long>(T) * W;                 // [T]
  auto* s_cum = reinterpret_cast<float*>(s_ways + T);                    // [W]

  for (long long i = tid; i < static_cast<long long>(T) * W; i += blockDim.x) {
    tags[i] = -1;
    stamps[i] = 0;
  }
  for (int i = tid; i < T; i += blockDim.x) s_ways[i] = lane_ways[i];
  for (int i = tid; i < W; i += blockDim.x) s_cum[i] = cum[static_cast<long long>(lane) * wmax + i];
  const int pol = policy[lane];
  const bool restamp_hit = pol == 0;
  const bool restamp_ins = pol == 0 || pol == 1;
  const long long row = static_cast<long long>(lane) * k_steps;
  int clock = 1;

  for (long long c0 = 0; c0 < k_steps; c0 += CHUNK) {
    const int n = static_cast<int>(k_steps - c0 < CHUNK ? k_steps - c0 : CHUNK);
    __syncthreads();                    // the previous chunk is read
    for (int i = tid; i < n; i += blockDim.x) {
      s_sets[i] = sets[row + c0 + i];
      s_lines[i] = lines[row + c0 + i];
      s_u[i] = u[row + c0 + i];
      s_valid[i] = valid[row + c0 + i] ? 1 : 0;
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      if (!s_valid[i]) {                // a padded step: no state change, no hit
        if (tid == 0) hits[row + c0 + i] = false;
        continue;
      }
      const int s = s_sets[i];
      const int line = s_lines[i];
      const int wl = s_ways[s];
      int* set_tags = tags + static_cast<long long>(s) * W;
      int* set_stamps = stamps + static_cast<long long>(s) * W;
      int mine = -1;                    // my way that holds the line
      unsigned long long key = EMPTY_KEY;
      for (int w = tid; w < wl; w += blockDim.x) {
        const int tg = set_tags[w];
        if (tg == line) mine = w;
        const unsigned long long kw =
            tg < 0 ? static_cast<unsigned long long>(w)
                   : (static_cast<unsigned long long>(set_stamps[w]) + 1ull) << 32 |
                         static_cast<unsigned long long>(w);
        key = kw < key ? kw : key;
      }
      const unsigned hit_ballot = __ballot_sync(0xffffffffu, mine >= 0);
      key = warp_min(key);
      const int p = clock & 1;          // the slots of every other valid step
      if ((tid & 31) == 0) {
        slot_key[p * MAX_WARPS + warp] = key;
        slot_hit[p * MAX_WARPS + warp] = hit_ballot != 0;
      }
      __syncthreads();
      bool hit = false;
      key = EMPTY_KEY;
      for (int q = 0; q < nwarps; ++q) {
        hit |= slot_hit[p * MAX_WARPS + q] != 0;
        const unsigned long long kq = slot_key[p * MAX_WARPS + q];
        key = kq < key ? kq : key;
      }
      if (hit) {
        if (mine >= 0 && restamp_hit) set_stamps[mine] = clock;
      } else {
        int way = static_cast<int>(key & 0xffffffffull);
        if (key >> 32 != 0) {           // the set is full: evict
          const float uu = s_u[i];
          if (pol == 2) {
            way = static_cast<int>(uu * static_cast<float>(wl));
            way = way < wl - 1 ? way : (wl - 1 > 0 ? wl - 1 : 0);
          } else if (pol == 3) {
            const float thr = uu * s_cum[wl - 1];
            way = 0;
            for (int j = 0; j < wl; ++j)
              if (s_cum[j] >= thr) {
                way = j;
                break;
              }
          }
        }
        if (way % static_cast<int>(blockDim.x) == tid) {
          set_tags[way] = line;
          if (restamp_ins) set_stamps[way] = clock;
        }
      }
      if (tid == 0) hits[row + c0 + i] = hit;
      ++clock;
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one CTA needs for a lane of T sets whose widest set has W
// ways, in bytes.
long long repro_batch_cache_smem_bytes(int t, int w) { return lane_smem_bytes(t, w); }

// The shared memory a CTA of the current device may opt in to, in bytes.
int repro_batch_cache_max_smem() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return bytes;
}

// Simulate `lanes` lanes of k_steps accesses each (one CTA a lane, `threads`
// threads, a multiple of 32 up to 256, `smem` bytes of dynamic shared memory:
// the most any lane needs, from repro_batch_cache_smem_bytes). Every
// pointer is on the card; the arrays are row-major as listed at the kernel.
// One launch; returns cudaGetLastError() after it (0 on success),
// asynchronous on `stream`.
int repro_batch_cache(const void* ways, const void* policy, const void* cum, const void* sets,
                      const void* lines, const void* valid, const void* u, void* hits,
                      int lanes, int tmax, int wmax, long long k_steps, int threads,
                      long long smem, void* stream) {
  if (lanes < 0 || tmax < 1 || wmax < 1 || k_steps < 0 || threads < 32 ||
      threads > MAX_THREADS || threads % 32 || smem < lane_smem_bytes(0, 0) ||
      smem > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (lanes == 0 || k_steps == 0) return (int)cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      batch_cache_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return (int)err;
  batch_cache_kernel<<<lanes, threads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ways), static_cast<const int*>(policy),
      static_cast<const float*>(cum), static_cast<const int*>(sets),
      static_cast<const int*>(lines), static_cast<const bool*>(valid),
      static_cast<const float*>(u), static_cast<bool*>(hits), tmax, wmax, k_steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
