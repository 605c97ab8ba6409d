// Multi-buffered copy for Hopper (sm_90a): Little's law made explicit (§5.1,
// Fig 12).
//
// Replaces: src/repro/kernels/dbuf_copy.py::_dbuf_kernel, the Pallas TPU
// kernel (pallas_call at :75), a hand-rolled num_buffers-deep DMA pipeline
// HBM -> VMEM -> HBM. Same function (out = x, bit for bit) and the same
// schedule, per CTA, over the CTA's own tiles:
//   * the prologue starts the inbound copies of tiles 0 .. nb-2;
//   * step i starts the inbound copy of tile i + nb - 1 ahead, waits for
//     tile i to arrive and starts its outbound copy;
//   * a stage is drained (its outbound copy has finished reading shared
//     memory) before an inbound copy reuses it;
//   * the trailing outbound copies are waited on at the end.
// The Pallas schedule starts tile i + nb - 1's inbound copy into the stage
// of tile i - 1 without waiting for that tile's outbound copy (it waits for
// it only at step i + nb - 1); here the stage is drained first, so an
// inbound copy never overwrites bytes still being sent.
// num_buffers is thus the depth in flight: with one stage the copy is
// serial, with more the inbound copies overlap the outbound ones.
//
// Bound on an H100 SXM: bytes, as for memcpy: 2 * bytes / 3.35 TB/s, 0.641
// ms for 1 GiB.
//
// Design: the copies are 1-D TMA bulk copies (cp.async.bulk). One thread of
// each CTA issues them all: inbound copies complete on one mbarrier per
// stage (expect_tx with the tile's bytes, waited on by phase parity);
// outbound copies are bulk groups, drained with cp.async.bulk.wait_group
// .read. The grid is one CTA per SM and CTA c copies tiles c, c + grid, ...,
// so that the depth of one CTA's pipeline is the depth per SM. A tile is 16
// KB; the last one may be shorter (a multiple of 16 bytes), and the final
// size % 16 bytes are copied by plain loads and stores. Both pointers must
// be 16-byte aligned, as bulk copies require (the wrapper checks).

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int TILE_BYTES = 16 * 1024;
constexpr int BAR_BYTES = 128;                    // the stages' mbarriers
constexpr int MAX_SMEM = 232448;                  // 227 KB a CTA may opt in to
constexpr int MAX_BUFFERS = (MAX_SMEM - BAR_BYTES) / TILE_BYTES;

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

__global__ void __launch_bounds__(32)
dbuf_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long nbytes,
            int nb) {
  extern __shared__ __align__(128) uint8_t smem[];
  if (threadIdx.x != 0) return;
  const long long full = nbytes / TILE_BYTES;
  const uint32_t last = static_cast<uint32_t>(nbytes % TILE_BYTES) & ~15u;
  const long long ntiles = full + (last ? 1 : 0);
  const long long cta = blockIdx.x, grid = gridDim.x;
  const long long count = ntiles > cta ? (ntiles - 1 - cta) / grid + 1 : 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* stages = smem + BAR_BYTES;

  for (int s = 0; s < nb; ++s) bar_init(smem_addr(&bars[s]));
  asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  asm volatile("fence.proxy.async.shared::cta;" : : : "memory");

  auto in_copy = [&](long long i) {
    const long long t = cta + i * grid;
    const int slot = static_cast<int>(i % nb);
    const uint32_t bytes = t < full ? TILE_BYTES : last;
    const uint32_t bar = smem_addr(&bars[slot]);
    bar_expect_tx(bar, bytes);
    bulk_load(smem_addr(stages + slot * TILE_BYTES), src + t * TILE_BYTES, bytes, bar);
  };

  const long long ahead = nb - 1 < count ? nb - 1 : count;
  for (long long k = 0; k < ahead; ++k) in_copy(k);
  for (long long i = 0; i < count; ++i) {
    const long long nxt = i + nb - 1;
    if (nxt < count) {
      // the stage of tile nxt last held tile i - 1: drain it first
      if (i >= 1) asm volatile("cp.async.bulk.wait_group.read 0;" : : : "memory");
      in_copy(nxt);
    }
    const long long t = cta + i * grid;
    const int slot = static_cast<int>(i % nb);
    bar_wait(smem_addr(&bars[slot]), static_cast<uint32_t>((i / nb) & 1));
    bulk_store(dst + t * TILE_BYTES, smem_addr(stages + slot * TILE_BYTES),
               t < full ? TILE_BYTES : last);
  }
  asm volatile("cp.async.bulk.wait_group 0;" : : : "memory");

  if (cta == 0)
    for (long long b = full * TILE_BYTES + last; b < nbytes; ++b) dst[b] = src[b];
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (both on the card, 16-byte aligned, not
// overlapping) through num_buffers shared-memory stages per CTA, with at
// most num_sms CTAs. Returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
int repro_dbuf_copy(const void* src, void* dst, long long nbytes, int num_buffers, int num_sms,
                    void* stream) {
  if (nbytes < 0 || num_sms <= 0 || num_buffers < 1 || num_buffers > MAX_BUFFERS ||
      reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  const long long ntiles = (nbytes + TILE_BYTES - 1) / TILE_BYTES;
  const int ctas = static_cast<int>(ntiles < num_sms ? ntiles : num_sms);
  const int smem = BAR_BYTES + num_buffers * TILE_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(dbuf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dbuf_kernel<<<ctas, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes, num_buffers);
  return (int)cudaGetLastError();
}

// The deepest pipeline a CTA's shared memory holds.
int repro_dbuf_max_buffers() { return MAX_BUFFERS; }

// The bytes of one tile (one stage).
int repro_dbuf_tile_bytes() { return TILE_BYTES; }

}  // extern "C"
