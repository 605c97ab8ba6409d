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
// tiles below 20 KB lost (copy_sweep.py at the repository root, whose
// designs are in copy_variants.cu; PERF.md). Both pointers must be 16-byte
// aligned, as bulk copies require (the wrapper checks).

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int TILE_BYTES = 24 * 1024;
constexpr int BAR_BYTES = 128;                    // the stages' mbarriers
constexpr int MAX_SMEM = 232448;                  // 227 KB a CTA may opt in to
constexpr int MAX_BUFFERS = (MAX_SMEM - BAR_BYTES) / TILE_BYTES;
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

}  // namespace

extern "C" {

// Copy nbytes from src to dst (both on the card, 16-byte aligned, not
// overlapping) through `num_buffers` stages of TILE_BYTES in each of at most
// `num_sms` CTAs, one pipeline a CTA, whose tiles are claimed one by one from
// `counter` (two zeroed 8-byte words on the card, zero again after the
// launch). One launch; returns cudaGetLastError() after it (0 on success),
// asynchronous on `stream`.
int repro_dbuf_copy(const void* src, void* dst, long long nbytes, int num_buffers, int num_sms,
                    void* counter, void* stream) {
  if (nbytes < 0 || num_sms <= 0 || num_buffers < 1 || num_buffers > MAX_BUFFERS ||
      counter == nullptr || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  const long long ntiles = (nbytes + TILE_BYTES - 1) / TILE_BYTES;
  const int grid = static_cast<int>(ntiles < num_sms ? ntiles : num_sms);
  static unsigned set_on = 0;       // devices the shared-memory attribute is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(set_on >> dev & 1u)) {
    err = cudaFuncSetAttribute(dbuf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BAR_BYTES + MAX_BUFFERS * TILE_BYTES);
    if (err != cudaSuccess) return (int)err;
    set_on |= 1u << dev;
  }
  const int smem = BAR_BYTES + num_buffers * TILE_BYTES;
  dbuf_kernel<<<grid, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes, num_buffers,
      static_cast<unsigned long long*>(counter));
  return (int)cudaGetLastError();
}

// The deepest pipeline a CTA's shared memory holds.
int repro_dbuf_max_buffers() { return MAX_BUFFERS; }

// The bytes of one tile (one stage).
int repro_dbuf_tile_bytes() { return TILE_BYTES; }

}  // extern "C"
