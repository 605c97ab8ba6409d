// Streaming copy for Hopper (sm_90a): the paper's global-memory copy (§5.1,
// Table 6).
//
// Replaces: src/repro/kernels/memcpy.py::_memcpy_kernel, the Pallas TPU
// kernel (pallas_call at :37), which copies a (rows, cols) array through
// VMEM in (block_rows, cols) tiles. Same function: out = x, bit for bit, for
// any element type. The (block_rows, cols) tiling is the TPU's; the wrapper
// keeps its divisibility contract and this kernel tiles by its own grid.
//
// Bound on an H100 SXM: bytes. Each byte is read once and written once, so
// the least time is 2 * bytes / 3.35 TB/s: 0.641 ms for 1 GiB. There are no
// operations to speak of.
//
// What this simple design does about that bound: many CTAs (8 per SM, 256
// threads each) stream the array in a grid-stride loop with 16-byte vector
// loads and stores, four independent ones in flight per thread before the
// stores, so that enough bytes are in flight to cover the memory latency
// (Little's law). When either pointer is not 16-byte aligned, or for the
// last bytes of a size that is not a multiple of 16, it copies single bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CTAS_PER_SM = 8;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
memcpy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, size_t nbytes,
              int vector) {
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t nthreads = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t done = 0;
  if (vector) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const size_t n16 = nbytes / 16;
    size_t i = tid;
    for (; i + (UNROLL - 1) * nthreads < n16; i += UNROLL * nthreads) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = s[i + u * nthreads];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) d[i + u * nthreads] = v[u];
    }
    for (; i < n16; i += nthreads) d[i] = s[i];
    done = n16 * 16;
  }
  for (size_t b = done + tid; b < nbytes; b += nthreads) dst[b] = src[b];
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (both on the card, not overlapping) with
// `num_sms` x 8 CTAs at most. Returns cudaGetLastError() after the launch
// (0 on success); the launch is asynchronous on `stream`.
int repro_memcpy(const void* src, void* dst, long long nbytes, int num_sms, void* stream) {
  if (nbytes < 0 || num_sms <= 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  const int vector = (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  const long long per_cta = static_cast<long long>(THREADS) * UNROLL * (vector ? 16 : 1);
  const long long need = (nbytes + per_cta - 1) / per_cta;
  const int ctas = static_cast<int>(need < num_sms * CTAS_PER_SM ? need : num_sms * CTAS_PER_SM);
  memcpy_kernel<<<ctas, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<size_t>(nbytes), vector);
  return (int)cudaGetLastError();
}

}  // extern "C"
