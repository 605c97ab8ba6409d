// Strided shared-memory gather for Hopper (sm_90a): the paper's Listing 4
// bank-conflict probe (§6.2, Table 8).
//
// Replaces: src/repro/kernels/strided.py::_strided_kernel, the Pallas TPU
// kernel (pallas_call at :34), which gathers out[i] = x[(i * stride) % n]
// over the leading axis inside one VMEM block. Same function, bit for bit,
// for any element type.
//
// Bound on an H100 SXM: bytes, 2 * bytes / 3.35 TB/s, which at the probe's
// sizes (n <= 128 rows of 1 KB) is well under the few microseconds a launch
// takes: the kernel is launch-bound, and one CTA uses one SM of 132.
//
// Design: one CTA stages x, (n, w) units of 4, 2 or 1 bytes, in shared
// memory with a row pitch of w + 1 units, then thread i reads row
// (i * stride) % n and writes it to out[i]. With 4-byte units and w a
// multiple of 32, the pitch puts row r's first word in bank r % 32, so the
// 32 threads of a warp, each on its own row, reading one column together,
// hit bank (i * stride) % 32 plus a constant: the gcd(stride, 32)-way
// conflicts of Listing 4's sdata[tid * stride]. The wrapper raises
// ValueError when x does not fit in one CTA's shared memory (227 KB), as the
// Pallas kernel is one VMEM block too.

#include <cstdint>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int MAX_SMEM = 232448;    // 227 KB a CTA may opt in to

template <typename U>
__global__ void strided_kernel(const U* __restrict__ x, U* __restrict__ out, int n, int w,
                               int stride) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  U* s = reinterpret_cast<U*>(smem_raw);
  const int pitch = w + 1;
  for (int e = threadIdx.x; e < n * w; e += blockDim.x) {
    const int r = e / w;
    s[r * pitch + (e - r * w)] = x[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = static_cast<int>((static_cast<long long>(i) * stride) % n);
    const U* src = s + row * pitch;
    U* dst = out + static_cast<size_t>(i) * w;
    for (int c = 0; c < w; ++c) dst[c] = src[c];
  }
}

template <typename U>
cudaError_t launch(const void* x, void* out, int n, int w, int stride, cudaStream_t stream) {
  const int smem = static_cast<int>(n * (w + 1) * sizeof(U));
  cudaError_t err = cudaFuncSetAttribute(strided_kernel<U>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = n >= 1024 ? 1024 : ((n + 31) / 32) * 32;
  strided_kernel<U><<<1, threads, smem, stream>>>(static_cast<const U*>(x),
                                                  static_cast<U*>(out), n, w, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: n rows of w units of unit_bytes (4, 2 or 1) each, contiguous, on
// the card; 0 <= stride < n. Returns cudaGetLastError() after the launch (0
// on success); the launch is asynchronous on `stream`.
int repro_strided_gather(const void* x, void* out, int n, int w, int unit_bytes, int stride,
                         void* stream) {
  if (n <= 0 || w <= 0 || stride < 0 || stride >= n ||
      static_cast<long long>(n) * (w + 1) * unit_bytes > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (unit_bytes == 4) return (int)launch<uint32_t>(x, out, n, w, stride, st);
  if (unit_bytes == 2) return (int)launch<uint16_t>(x, out, n, w, stride, st);
  if (unit_bytes == 1) return (int)launch<uint8_t>(x, out, n, w, stride, st);
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA may hold, in bytes.
int repro_strided_max_smem() { return MAX_SMEM; }

}  // extern "C"
