// Fine-grained P-chase for Hopper (sm_90a): the paper's Listing 3.
//
// Replaces: src/repro/kernels/pchase.py::_pchase_kernel, the Pallas TPU
// kernel (pallas_call at :59). Same function: a serial chase j = A[j] from
// `start` over an int32 array padded by line_elems zeros, writing the t-th
// visited index to out_index[t]. Where the TPU kernel had no counter (its
// latency came from host-side differential timing), this one also stamps
// every access with clock64() deltas, as the paper's s_tvalue[] does.
//
// Load path: each dereference is one inline-asm `ld.global.ca.u32`, which
// is cached in L1 (and L2). The asm is volatile with a memory clobber, so
// no load is merged, hoisted or reordered against the clock reads. The
// shared-memory carveout is set explicitly to cudaSharedmemCarveoutMaxL1 (0
// percent requested): the driver rounds it up to the smallest configuration
// that holds this kernel's 8 KB of static shared memory, and what is left of
// the SM's 256 KB is the L1 that the chase measures.
//
// Bound on an H100 SXM: the chase is one dependent load at a time, so its
// least time is `iterations` x the latency of the level that holds the
// footprint (about 30-40 SM cycles in L1, a few hundred in L2 and in device
// memory at 1.98 GHz). Bytes (4 read and 4 + 4 written per access) and
// operations are negligible beside it. The ratio of kernel time to that
// bound is the instrument's own overhead per step.
//
// Design: one thread chases, as in the paper; it is lane 0 of one warp.
// Each iteration reads the SM clock, loads, stores the loaded index into
// s_index[] and only then reads the clock again: the store needs the loaded
// value, so the end stamp waits for the load. Index and cycle delta go to
// shared memory (s_index[], s_tvalue[]); every CHUNK accesses the warp
// flushes both buffers to device memory between timed stretches. The flush
// writes through L2, so a footprint that lives in L2 shares it with 8 KB of
// trace per chunk. `clocks`, when given, receives the kernel's elapsed SM
// cycles and %globaltimer nanoseconds, from which the caller reads the SM
// clock of the run.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int CHUNK = 1024;    // accesses recorded in shared memory per flush
constexpr int THREADS = 32;    // lane 0 chases; the whole warp flushes
constexpr int CARVEOUT = cudaSharedmemCarveoutMaxL1;

__device__ __forceinline__ uint32_t load_ca(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.ca.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ long long sm_clock() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return static_cast<long long>(t);
}

__global__ void __launch_bounds__(THREADS)
pchase_kernel(const uint32_t* __restrict__ a, uint32_t start, int iterations,
              int32_t* __restrict__ out_index, uint32_t* __restrict__ out_cycles,
              long long* __restrict__ clocks) {
  __shared__ uint32_t s_index[CHUNK];
  __shared__ uint32_t s_tvalue[CHUNK];
  const int lane = threadIdx.x;
  uint32_t j = start;
  long long c0 = 0, g0 = 0;
  if (lane == 0) {
    c0 = sm_clock();
    g0 = global_ns();
  }
  for (int base = 0; base < iterations; base += CHUNK) {
    const int n = min(CHUNK, iterations - base);
    if (lane == 0) {
      for (int t = 0; t < n; ++t) {
        const long long t0 = sm_clock();
        j = load_ca(a + j);
        s_index[t] = j;                    // needs the loaded value ...
        const long long t1 = sm_clock();   // ... so this stamp waits for it
        s_tvalue[t] = static_cast<uint32_t>(t1 - t0);
      }
    }
    __syncwarp();
    for (int t = lane; t < n; t += THREADS) {
      out_index[base + t] = static_cast<int32_t>(s_index[t]);
      if (out_cycles) out_cycles[base + t] = s_tvalue[t];
    }
    __syncwarp();
  }
  if (lane == 0 && clocks) {
    clocks[0] = sm_clock() - c0;
    clocks[1] = global_ns() - g0;
  }
}

}  // namespace

extern "C" {

// a: the padded int32 chase array on the card; out_index: int32[iterations];
// out_cycles (may be null): uint32[iterations]; clocks (may be null):
// int64[2]. Returns cudaGetLastError() after the launch (0 on success); the
// launch is asynchronous on `stream`.
int repro_pchase(const void* a, int start, int iterations, void* out_index, void* out_cycles,
                 void* clocks, void* stream) {
  if (iterations <= 0 || start < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      pchase_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, CARVEOUT);
  if (err != cudaSuccess) return (int)err;
  pchase_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<uint32_t>(start), iterations,
      static_cast<int32_t*>(out_index), static_cast<uint32_t*>(out_cycles),
      static_cast<long long*>(clocks));
  return (int)cudaGetLastError();
}

// The carveout requested (percent of the largest shared-memory size).
int repro_pchase_carveout() { return CARVEOUT; }

// Static shared memory of one CTA, in bytes.
int repro_pchase_smem_bytes() { return (int)(2 * CHUNK * sizeof(uint32_t)); }

// Accesses recorded between two flushes.
int repro_pchase_chunk() { return CHUNK; }

}  // extern "C"
