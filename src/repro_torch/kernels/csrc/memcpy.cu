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
// Design. The threads issue the loads and stores themselves (the paper's
// knobs are #CTAs x CTA size x ILP, the 16-byte loads a thread has in flight
// before its stores). Each CTA of 256 threads copies one contiguous 8 KB
// batch: two 16-byte loads a thread, one per half of the batch, then the two
// stores. The grid has as many CTAs as the array has batches, so the card's
// block scheduler hands batches out as SMs free up and an SM that the memory
// system serves faster copies more of them. Persistent grids that give each
// SM a fixed share, the previous design (8 CTAs of 256 threads an SM in a
// grid-stride loop of four loads) among them, end with the slowest share
// and ran 5-8% longer than torch's copy_ on an H100 SXM; cache hints on the
// loads or stores gained nothing (a sweep of the designs timed in turns
// with copy_; PERF.md). The array's last batch is predicated, so the
// ragged end needs no loop of its own.
//
// One launch a call. When either pointer is not 16-byte aligned, that launch
// is a kernel that copies single bytes: a path only kept right, never timed.
// Otherwise the first nbytes % 16 threads of the grid also copy the last
// bytes, one each.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ILP = 2;
constexpr size_t BATCH = static_cast<size_t>(THREADS) * ILP;   // 16-byte vectors

__global__ void __launch_bounds__(THREADS)
memcpy_kernel(const uint8_t* __restrict__ bytes_in, uint8_t* __restrict__ bytes_out,
              size_t nbytes) {
  const auto* src = reinterpret_cast<const uint4*>(bytes_in);
  auto* dst = reinterpret_cast<uint4*>(bytes_out);
  const size_t n16 = nbytes / 16;
  const size_t tid = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (tid < nbytes % 16) bytes_out[n16 * 16 + tid] = bytes_in[n16 * 16 + tid];
  const size_t first = blockIdx.x * BATCH + threadIdx.x;
  uint4 v[ILP];
  if ((blockIdx.x + 1) * BATCH <= n16) {
#pragma unroll
    for (int u = 0; u < ILP; ++u) v[u] = src[first + u * THREADS];
#pragma unroll
    for (int u = 0; u < ILP; ++u) dst[first + u * THREADS] = v[u];
  } else {  // the array's last batch
#pragma unroll
    for (int u = 0; u < ILP; ++u)
      if (first + u * THREADS < n16) v[u] = src[first + u * THREADS];
#pragma unroll
    for (int u = 0; u < ILP; ++u)
      if (first + u * THREADS < n16) dst[first + u * THREADS] = v[u];
  }
}

// Any alignment: one byte a thread per grid-stride step.
__global__ void memcpy_bytes(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                             size_t nbytes) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t b = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; b < nbytes;
       b += stride)
    dst[b] = src[b];
}

}  // namespace

extern "C" {

// Copy nbytes from src to dst (both on the card, not overlapping). One
// launch; returns cudaGetLastError() after it (0 on success). The launch is
// asynchronous on `stream`.
int repro_memcpy(const void* src, void* dst, long long nbytes, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  if (nbytes == 0) return (int)cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto n = static_cast<size_t>(nbytes);
  const auto in = static_cast<const uint8_t*>(src);
  const auto out = static_cast<uint8_t*>(dst);
  if (reinterpret_cast<uintptr_t>(src) % 16 || reinterpret_cast<uintptr_t>(dst) % 16) {
    const size_t need = (n + THREADS - 1) / THREADS;
    memcpy_bytes<<<static_cast<unsigned>(need < 1024 * 1024 ? need : 1024 * 1024), THREADS, 0,
                   s>>>(in, out, n);
  } else {
    // at least one CTA, whose first threads copy the last n % 16 bytes
    const size_t batches = (n / 16 + BATCH - 1) / BATCH;
    memcpy_kernel<<<static_cast<unsigned>(batches < 1 ? 1 : batches), THREADS, 0, s>>>(in, out,
                                                                                     n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
