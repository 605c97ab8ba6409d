// Multi-buffered copy for Hopper (sm_90a): Little's law made explicit (§5.1,
// Fig 12).
//
// Replaces: src/repro/kernels/dbuf_copy.py::_dbuf_kernel, the Pallas TPU
// kernel (pallas_call at :75), a hand-rolled num_buffers-deep DMA pipeline
// HBM -> VMEM -> HBM. Same function (out = x, bit for bit) and the same
// knob: num_buffers is the number of shared-memory stages in flight on each
// SM, one pipeline an SM; with one stage the copy is serial.
//
// Bound on an H100 SXM: bytes, as for memcpy: 2 * bytes / 3.35 TB/s, 0.641
// ms for 1 GiB.
//
// Design. The copies are 1-D TMA bulk copies (cp.async.bulk) of 24 KB
// tiles; the last may be shorter (a multiple of 16 bytes), and the final
// size % 16 bytes are copied by plain loads and stores. One thread of each of
// the SM-count CTAs issues them all. Inbound copies complete on one mbarrier
// a stage (expect_tx with the tile's bytes, waited on by phase parity);
// outbound copies are bulk groups, drained with cp.async.bulk.wait_group
// .read. Every stage starts full. Step i waits for the i-th tile, starts its
// outbound copy, then refills the stage of tile i - lag once at most `lag`
// newer outbound copies still read shared memory: a stage is always drained
// before an inbound copy reuses it (the Pallas schedule reuses one before;
// ROADMAP.md), and the newest `lag` stores may stay in flight.
//
// A CTA claims its tiles one at a time from a counter on the card (atomicAdd;
// the last CTA to finish sets it back to 0), so an SM that the memory system
// serves faster copies more tiles. That, not the order of the copies, is what
// the previous design lacked: with fixed shares (tiles c, c + grid, ..., the
// Pallas grid order, or contiguous runs) the copy ended with the slowest SM's
// share and ran 3-5% longer than torch's copy_ on an H100 SXM at every depth
// and order. An L2 evict_first hint on the bulk copies gained nothing, and
// tiles below 20 KB lost (a sweep of the designs timed in turns with
// copy_; PERF.md).
//
// Bulk copies need 16-byte-aligned addresses on both sides. The destination
// is always aligned (the wrapper allocates it). A source whose start is not
// takes dbuf_shifted_kernel, in the same one launch: the same pipeline of
// claimed tiles, whose inbound bulk copies load the 16-byte-aligned span
// that holds each tile into stages one granule wider, and whose warp stores
// the tile from there shifted to the source's offset, 16 bytes a thread
// (an outbound bulk copy would need an aligned shared-memory source). The
// span's first and last granules reach past the array's ends, but never
// past the granules that hold its first and last bytes, and a 16-byte
// granule never crosses a page.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int TILE_BYTES = 24 * 1024;
constexpr int BAR_BYTES = 128;                    // the stages' mbarriers
constexpr int MAX_SMEM = 232448;                  // 227 KB a CTA may opt in to
constexpr int MAX_BUFFERS = (MAX_SMEM - BAR_BYTES) / TILE_BYTES;
constexpr int SHIFTED_STAGE = TILE_BYTES + 16;    // a tile's aligned span
static_assert(BAR_BYTES + MAX_BUFFERS * SHIFTED_STAGE <= MAX_SMEM,
              "the shifted stages fit as many buffers");
static_assert(MAX_BUFFERS * 8 <= BAR_BYTES, "one 8-byte mbarrier a stage");

// Stores left in flight at a refill, the sweep's best at each depth: half
// the stages at depth 3 and 4; none at depth 2, where the inbound copies
// need both stages, nor from depth 6, where the loads alone hold 144 KB or
// more in flight on each SM.
__host__ __device__ constexpr int lag_for(int nb) { return nb == 3 || nb == 4 ? nb / 2 : 0; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" : : "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               : : "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return static_cast<long long>(t);
}

// Wait for a stage's inbound copy. A copy that has not landed after two
// seconds never will: trap, so that the launch fails instead of hanging.
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
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      : : "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               : : "l"(dst), "r"(src), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" : : : "memory");
}

// Wait until at most `lag` outbound copies are still reading shared memory
// (an immediate in PTX, hence the switch over lag_for's values).
__device__ __forceinline__ void drain_all_but(int lag) {
  switch (lag) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;" : : : "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;" : : : "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 2;" : : : "memory"); break;
  }
}

// One pipeline: thread 0 of the CTA issues every copy of the tiles it
// claims from counter[0]; counter[1] counts the CTAs that are done.
__global__ void __launch_bounds__(32)
dbuf_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes, int nb,
            unsigned long long* counter) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const long long full = nbytes / TILE_BYTES;
  const uint32_t last = static_cast<uint32_t>(nbytes % TILE_BYTES) & ~15u;
  const long long ntiles = full + (last ? 1 : 0);
  const int lag = lag_for(nb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + BAR_BYTES;

  for (int s = 0; s < nb; ++s) bar_init(smem_addr(&bars[s]));
  asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  asm volatile("fence.proxy.async.shared::cta;" : : : "memory");

  long long tile_of[MAX_BUFFERS];  // the tile each stage holds
  long long loaded = 0;            // inbound copies started
  bool more = true;
  // claim the next tile and start its inbound copy, into the stage of copy
  // number `loaded`; false when the tiles have run out
  auto in_copy = [&]() {
    const long long t = static_cast<long long>(atomicAdd(counter, 1ull));
    if (t >= ntiles) return false;
    const int slot = static_cast<int>(loaded++ % nb);
    const uint32_t bytes = t < full ? TILE_BYTES : last;
    const uint32_t bar = smem_addr(&bars[slot]);
    tile_of[slot] = t;
    bar_expect_tx(bar, bytes);
    bulk_load(smem_addr(stages + slot * TILE_BYTES), src + t * TILE_BYTES, bytes, bar);
    return true;
  };

  // every stage starts full; step i stores the i-th tile, then refills the
  // stage of tile i - lag, drained once at most `lag` newer stores still
  // read shared memory
  for (int k = 0; k < nb && more; ++k) more = in_copy();
  for (long long i = 0; i < loaded; ++i) {
    const int slot = static_cast<int>(i % nb);
    const long long t = tile_of[slot];
    bar_wait(smem_addr(&bars[slot]), static_cast<uint32_t>((i / nb) & 1));
    bulk_store(dst + t * TILE_BYTES, smem_addr(stages + slot * TILE_BYTES),
               t < full ? TILE_BYTES : last);
    if (more && i >= lag) {
      drain_all_but(lag);
      more = in_copy();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" : : : "memory");

  if (blockIdx.x == 0)
    for (long long b = full * TILE_BYTES + last; b < nbytes; ++b) dst[b] = src[b];
  // the last CTA to finish sets the counter back to 0 for the next launch
  __threadfence();
  if (atomicAdd(counter + 1, 1ull) == gridDim.x - 1ull) {
    counter[0] = 0;
    counter[1] = 0;
    __threadfence();
  }
}

// The same pipeline for a source that is not 16-byte aligned (dst is): the
// 32 threads of the CTA take part. Thread 0 claims the tiles and issues the
// inbound copies of each tile's aligned span; every thread keeps the same
// books (the claimed tile is broadcast), waits for the stage, and stores 16
// bytes at a time, each assembled from five 4-byte words of the stage
// shifted by the source's offset; the tile's last bytes % 16 one a thread.
// The stores read shared memory synchronously, so a stage is refilled as
// soon as the warp has stored it.
__global__ void __launch_bounds__(32)
dbuf_shifted_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                    long long nbytes, int nb, unsigned long long* counter) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int lane = threadIdx.x;
  const uint32_t off = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src) & 15u);
  const uint8_t* base = src - off;                 // 16-byte aligned
  const long long ntiles = (nbytes + TILE_BYTES - 1) / TILE_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + BAR_BYTES;

  if (lane == 0) {
    for (int s = 0; s < nb; ++s) bar_init(smem_addr(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
    asm volatile("fence.proxy.async.shared::cta;" : : : "memory");
  }
  __syncwarp();

  long long tile_of[MAX_BUFFERS];
  long long loaded = 0;
  bool more = true;
  auto in_copy = [&]() {
    const long long t = static_cast<long long>(
        __shfl_sync(0xffffffffu, lane == 0 ? atomicAdd(counter, 1ull) : 0ull, 0));
    if (t >= ntiles) return false;
    const int slot = static_cast<int>(loaded++ % nb);
    tile_of[slot] = t;
    if (lane == 0) {
      const long long left = nbytes - t * TILE_BYTES;
      const uint32_t bytes = static_cast<uint32_t>(left < TILE_BYTES ? left : TILE_BYTES);
      const uint32_t span = (off + bytes + 15u) & ~15u;
      const uint32_t bar = smem_addr(&bars[slot]);
      bar_expect_tx(bar, span);
      bulk_load(smem_addr(stages + slot * SHIFTED_STAGE), base + t * TILE_BYTES, span, bar);
    }
    return true;
  };

  const uint32_t q0 = off >> 2, sh = (off & 3u) * 8u;
  for (int k = 0; k < nb && more; ++k) more = in_copy();
  for (long long i = 0; i < loaded; ++i) {
    const int slot = static_cast<int>(i % nb);
    const long long t = tile_of[slot];
    bar_wait(smem_addr(&bars[slot]), static_cast<uint32_t>((i / nb) & 1));
    const long long left = nbytes - t * TILE_BYTES;
    const int bytes = static_cast<int>(left < TILE_BYTES ? left : TILE_BYTES);
    const uint32_t* words = reinterpret_cast<const uint32_t*>(stages + slot * SHIFTED_STAGE);
    uint4* out = reinterpret_cast<uint4*>(dst + t * TILE_BYTES);
    for (int v = lane; v < bytes / 16; v += 32) {
      const uint32_t* w = words + q0 + 4 * v;
      uint4 o;
      if (sh == 0) {
        o = make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        o.x = __funnelshift_r(w[0], w[1], sh);
        o.y = __funnelshift_r(w[1], w[2], sh);
        o.z = __funnelshift_r(w[2], w[3], sh);
        o.w = __funnelshift_r(w[3], w[4], sh);
      }
      out[v] = o;
    }
    const int done = bytes / 16 * 16;
    if (lane < bytes - done)
      dst[t * TILE_BYTES + done + lane] = stages[slot * SHIFTED_STAGE + off + done + lane];
    __syncwarp();
    if (more) {
      if (lane == 0) asm volatile("fence.proxy.async.shared::cta;" : : : "memory");
      more = in_copy();
    }
  }

  if (lane == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1ull) == gridDim.x - 1ull) {
      counter[0] = 0;
      counter[1] = 0;
      __threadfence();
    }
  }
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (both on the card, dst 16-byte aligned, not
// overlapping) through `num_buffers` stages of TILE_BYTES in each of at most
// `num_sms` CTAs, one pipeline a CTA, whose tiles are claimed one by one from
// `counter` (two zeroed 8-byte words on the card, zero again after the
// launch). One launch; returns cudaGetLastError() after it (0 on success),
// asynchronous on `stream`.
int repro_dbuf_copy(const void* src, void* dst, long long nbytes, int num_buffers, int num_sms,
                    void* counter, void* stream) {
  if (nbytes < 0 || num_sms <= 0 || num_buffers < 1 || num_buffers > MAX_BUFFERS ||
      counter == nullptr || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  const bool shifted = reinterpret_cast<uintptr_t>(src) % 16 != 0;
  if (nbytes == 0) return (int)cudaSuccess;
  const long long ntiles = (nbytes + TILE_BYTES - 1) / TILE_BYTES;
  const int grid = static_cast<int>(ntiles < num_sms ? ntiles : num_sms);
  // devices the shared-memory attribute is set on, for each kernel
  static unsigned set_on[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int stage = shifted ? SHIFTED_STAGE : TILE_BYTES;
  if (!(set_on[shifted] >> dev & 1u)) {
    err = cudaFuncSetAttribute(shifted ? dbuf_shifted_kernel : dbuf_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BAR_BYTES + MAX_BUFFERS * stage);
    if (err != cudaSuccess) return (int)err;
    set_on[shifted] |= 1u << dev;
  }
  const int smem = BAR_BYTES + num_buffers * stage;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  const auto ctr = static_cast<unsigned long long*>(counter);
  if (shifted)
    dbuf_shifted_kernel<<<grid, 32, smem, s>>>(in, out, nbytes, num_buffers, ctr);
  else
    dbuf_kernel<<<grid, 32, smem, s>>>(in, out, nbytes, num_buffers, ctr);
  return (int)cudaGetLastError();
}

// The deepest pipeline a CTA's shared memory holds.
int repro_dbuf_max_buffers() { return MAX_BUFFERS; }

// The bytes of one tile (one stage).
int repro_dbuf_tile_bytes() { return TILE_BYTES; }

}  // extern "C"
