// The designs that copy_sweep.py (at the repository root) times against
// torch's copy_, for memcpy.cu and dbuf_copy.cu: the paper's knobs of a copy
// (§5.1, Table 6 and Fig 12) as arguments. No wrapper launches these; the
// port's copies are memcpy.cu and dbuf_copy.cu, each the fastest design
// here on an H100 SXM (PERF.md). Both entries take 16-byte aligned pointers
// only.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

// -- memcpy: the threads issue the loads and stores ---------------------------

constexpr int MAX_THREADS = 512;

// Which threads share a span of the array: the whole grid (a grid-stride
// loop), a CTA, or a warp.
enum Span { GRID = 0, CTA_SPAN = 1, WARP_SPAN = 2 };

// Cache policies of the loads: 0 the default; 1 no L1 allocation; 2 no L1
// allocation and 256-byte prefetch into L2; 3 an L2 evict-first policy.
template <int H>
__device__ __forceinline__ uint4 load16(const uint4* p, uint64_t policy) {
  uint4 v;
  if constexpr (H == 0) {
    v = *p;
  } else if constexpr (H == 1) {
    asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else if constexpr (H == 2) {
    asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(policy));
  }
  return v;
}

// Cache policies of the stores: 0 the default; 1 streaming (.cs); 2 an L2
// evict-first policy; 3 an L2 evict-last policy.
template <int H>
__device__ __forceinline__ void store16(uint4* p, const uint4& v, uint64_t policy) {
  if constexpr (H == 0) {
    *p = v;
  } else if constexpr (H == 1) {
    asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
                 : : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
  } else {
    asm volatile("st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
                 : : "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "l"(policy)
                 : "memory");
  }
}

// Each group of threads (the grid, a CTA or a warp) owns a contiguous run of
// batches; in a batch each thread loads N 16-byte vectors, one per
// group-wide slice, then stores them. The array's last batch is predicated.
template <int N, int LH, int SH>
__global__ void __launch_bounds__(MAX_THREADS)
memcpy_variant(const uint8_t* __restrict__ bytes_in, uint8_t* __restrict__ bytes_out,
               size_t nbytes, int span) {
  const auto* src = reinterpret_cast<const uint4*>(bytes_in);
  auto* dst = reinterpret_cast<uint4*>(bytes_out);
  const size_t n16 = nbytes / 16;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid < nbytes % 16) bytes_out[n16 * 16 + tid] = bytes_in[n16 * 16 + tid];
  uint64_t load_policy = 0, store_policy = 0;
  if constexpr (LH == 3)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(load_policy));
  if constexpr (SH == 2)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(store_policy));
  if constexpr (SH == 3)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(store_policy));
  size_t group, groups, lane, width;
  if (span == GRID) {
    group = 0, groups = 1, width = static_cast<size_t>(gridDim.x) * blockDim.x, lane = tid;
  } else if (span == CTA_SPAN) {
    group = blockIdx.x, groups = gridDim.x, width = blockDim.x, lane = threadIdx.x;
  } else {
    const unsigned warps = blockDim.x / 32;
    group = static_cast<size_t>(blockIdx.x) * warps + threadIdx.x / 32;
    groups = static_cast<size_t>(gridDim.x) * warps, width = 32, lane = threadIdx.x % 32;
  }
  const size_t batch = N * width;
  const size_t batches = (n16 + batch - 1) / batch;
  const size_t end = batches * (group + 1) / groups;
  for (size_t b = batches * group / groups; b < end; ++b) {
    const size_t first = b * batch + lane;
    uint4 v[N];
    if ((b + 1) * batch <= n16) {
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = load16<LH>(src + first + u * width, load_policy);
#pragma unroll
      for (int u = 0; u < N; ++u) store16<SH>(dst + first + u * width, v[u], store_policy);
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u)
        if (first + u * width < n16) v[u] = load16<LH>(src + first + u * width, load_policy);
#pragma unroll
      for (int u = 0; u < N; ++u)
        if (first + u * width < n16) store16<SH>(dst + first + u * width, v[u], store_policy);
    }
  }
}

using MemcpyVariant = void (*)(const uint8_t*, uint8_t*, size_t, int);

// The (load, store) hint pairs the sweep times: both default, one side
// hinted at a time.
template <int N>
MemcpyVariant memcpy_hinted(int load_hint, int store_hint) {
  switch (load_hint * 4 + store_hint) {
    case 0: return memcpy_variant<N, 0, 0>;
    case 4: return memcpy_variant<N, 1, 0>;
    case 8: return memcpy_variant<N, 2, 0>;
    case 12: return memcpy_variant<N, 3, 0>;
    case 1: return memcpy_variant<N, 0, 1>;
    case 2: return memcpy_variant<N, 0, 2>;
    case 3: return memcpy_variant<N, 0, 3>;
    default: return nullptr;
  }
}

MemcpyVariant memcpy_design(int ilp, int load_hint, int store_hint) {
  switch (ilp) {
    case 1: return memcpy_hinted<1>(load_hint, store_hint);
    case 2: return memcpy_hinted<2>(load_hint, store_hint);
    case 4: return memcpy_hinted<4>(load_hint, store_hint);
    case 8: return memcpy_hinted<8>(load_hint, store_hint);
    case 16: return memcpy_hinted<16>(load_hint, store_hint);
    default: return nullptr;
  }
}

// -- dbuf_copy: a pipeline of TMA bulk copies on each SM ----------------------

constexpr int BAR_BYTES = 128;                    // the stages' mbarriers
constexpr int MAX_SMEM = 232448;                  // 227 KB a CTA may opt in to
constexpr int MAX_STAGES = BAR_BYTES / 8;         // one 8-byte mbarrier a stage

// A CTA's tiles: every grid-th (the Pallas grid order), a contiguous run,
// or claimed one by one from a counter on the card.
enum Tiles { INTERLEAVED = 0, CONTIGUOUS_RUNS = 1, CLAIMED = 2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return static_cast<long long>(t);
}

// Wait for a stage's inbound copy; trap after two seconds.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = global_ns();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && global_ns() - t0 > 2000000000LL) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, bool hint, uint64_t policy) {
  if (hint)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;"
        : : "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy) : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        : : "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes, bool hint,
                                           uint64_t policy) {
  if (hint)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
                 : : "l"(dst), "r"(src), "r"(bytes), "l"(policy) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 : : "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" : : : "memory");
}

// Wait until at most n outbound copies still read shared memory (n is an
// immediate in PTX, hence the switch).
__device__ __forceinline__ void drain_all_but(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;" : : : "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;" : : : "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;" : : : "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;" : : : "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;" : : : "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;" : : : "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group.read 6;" : : : "memory"); break;
    case 7: asm volatile("cp.async.bulk.wait_group.read 7;" : : : "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 8;" : : : "memory"); break;
  }
}

// dbuf_copy.cu's pipeline with its constants as arguments: every stage
// starts full; step i stores the i-th tile, then refills the stage of tile
// i - lag once at most `lag` newer stores still read shared memory.
__global__ void __launch_bounds__(32)
dbuf_variant(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes, int nb,
             int tile, int lag, int tiles, int hint, unsigned long long* counter) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const long long full = nbytes / tile;
  const uint32_t last = static_cast<uint32_t>(nbytes % tile) & ~15u;
  const long long ntiles = full + (last ? 1 : 0);
  const long long cta = blockIdx.x, grid = gridDim.x;
  long long first = cta, step = grid, count = ntiles > cta ? (ntiles - 1 - cta) / grid + 1 : 0;
  if (tiles == CONTIGUOUS_RUNS)
    first = ntiles * cta / grid, step = 1, count = ntiles * (cta + 1) / grid - first;
  long long claimed = 0;
  auto claim = [&]() -> long long {
    if (tiles == CLAIMED) return static_cast<long long>(atomicAdd(counter, 1ull));
    return claimed < count ? first + (claimed++) * step : ntiles;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + BAR_BYTES;
  uint64_t policy = 0;
  if (hint) asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));

  for (int s = 0; s < nb; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" : : "r"(smem_addr(&bars[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  asm volatile("fence.proxy.async.shared::cta;" : : : "memory");

  long long tile_of[MAX_STAGES];
  long long loaded = 0;
  bool more = true;
  auto in_copy = [&]() {
    const long long t = claim();
    if (t >= ntiles) return false;
    const int slot = static_cast<int>(loaded++ % nb);
    const uint32_t bytes = t < full ? tile : last;
    const uint32_t bar = smem_addr(&bars[slot]);
    tile_of[slot] = t;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 : : "r"(bar), "r"(bytes) : "memory");
    bulk_load(smem_addr(stages + slot * tile), src + t * tile, bytes, bar, hint, policy);
    return true;
  };

  for (int k = 0; k < nb && more; ++k) more = in_copy();
  for (long long i = 0; i < loaded; ++i) {
    const int slot = static_cast<int>(i % nb);
    const long long t = tile_of[slot];
    bar_wait(smem_addr(&bars[slot]), static_cast<uint32_t>((i / nb) & 1));
    bulk_store(dst + t * tile, smem_addr(stages + slot * tile), t < full ? tile : last, hint,
               policy);
    if (more && i >= lag) {
      drain_all_but(lag);
      more = in_copy();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" : : : "memory");

  if (cta == 0)
    for (long long b = full * tile + last; b < nbytes; ++b) dst[b] = src[b];
  if (tiles == CLAIMED) {
    __threadfence();
    if (atomicAdd(counter + 1, 1ull) == static_cast<unsigned long long>(grid - 1)) {
      counter[0] = 0;
      counter[1] = 0;
      __threadfence();
    }
  }
}

}  // namespace

extern "C" {

// Copy nbytes (16-byte aligned pointers on the card, not overlapping) with
// at most `ctas` CTAs of `threads` threads (a multiple of 32, at most 512),
// ILP 16-byte loads a thread in flight (1, 2, 4, 8 or 16), the threads of a
// span as `span` says (0 grid, 1 CTA, 2 warp) and the cache policies
// `load_hint` and `store_hint` (0-3, one of them 0). One launch; returns
// cudaGetLastError() after it, asynchronous on `stream`.
int repro_memcpy_variant(const void* src, void* dst, long long nbytes, int ctas, int threads,
                         int ilp, int span, int load_hint, int store_hint, void* stream) {
  const MemcpyVariant kernel = memcpy_design(ilp, load_hint, store_hint);
  if (nbytes <= 0 || ctas <= 0 || threads <= 0 || threads > MAX_THREADS || threads % 32 ||
      span < GRID || span > WARP_SPAN || kernel == nullptr ||
      reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  const auto n = static_cast<size_t>(nbytes);
  const size_t per_cta = static_cast<size_t>(threads) * ilp;
  const size_t need = (n / 16 + per_cta - 1) / per_cta;
  const size_t grid = need < 1 ? 1 : need < static_cast<size_t>(ctas) ? need : ctas;
  kernel<<<static_cast<int>(grid), threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), n, span);
  return (int)cudaGetLastError();
}

// Copy nbytes (16-byte aligned pointers on the card, not overlapping)
// through `num_buffers` stages of `tile_bytes` (a multiple of 128) in each
// of at most `ctas` CTAs, one pipeline a CTA: `lag` (below num_buffers, at
// most 8) newest outbound copies stay in flight at a refill; a CTA's tiles
// as `tiles` says (0 every ctas-th, 1 a contiguous run, 2 claimed from
// `counter`: two zeroed 8-byte words, zero again after the launch); the bulk
// copies carry an L2 evict-first hint or none. One launch; returns
// cudaGetLastError() after it, asynchronous on `stream`.
int repro_dbuf_copy_variant(const void* src, void* dst, long long nbytes, int num_buffers,
                            int ctas, int tile_bytes, int lag, int tiles, int hint,
                            void* counter, void* stream) {
  if (nbytes <= 0 || ctas <= 0 || num_buffers < 1 || num_buffers > MAX_STAGES ||
      tile_bytes <= 0 || tile_bytes % 128 ||
      BAR_BYTES + static_cast<long long>(num_buffers) * tile_bytes > MAX_SMEM || lag < 0 ||
      lag >= num_buffers || lag > 8 || tiles < INTERLEAVED || tiles > CLAIMED ||
      (tiles == CLAIMED && counter == nullptr) ||
      reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (nbytes + tile_bytes - 1) / tile_bytes;
  const int grid = static_cast<int>(ntiles < ctas ? ntiles : ctas);
  const int smem = BAR_BYTES + num_buffers * tile_bytes;
  cudaError_t err =
      cudaFuncSetAttribute(dbuf_variant, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dbuf_variant<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes, num_buffers,
      tile_bytes, lag, tiles, hint, static_cast<unsigned long long*>(counter));
  return (int)cudaGetLastError();
}

}  // extern "C"
