// Strided shared-memory gather for Hopper (sm_90a): the paper's Listing 4
// bank-conflict probe (§6.2, Table 8).
//
// Replaces: src/repro/kernels/strided.py::_strided_kernel, the Pallas TPU
// kernel (pallas_call at :34), which gathers out[i] = x[(i * stride) % n]
// over the leading axis inside one VMEM block. Same function, bit for bit,
// for units of 4, 2 and 1 bytes.
//
// Bound on an H100 SXM: bytes, 2 * bytes / 3.35 TB/s: 0.078 us at the
// probe's (128, 256) float32. The kernel is one CTA, as the Pallas kernel
// is one VMEM block and Listing 4 one thread block, so the quantity it
// exists to show is not that bound but the shared-memory reads of the
// gather: 32,768 four-byte reads at (128, 256), issued as 1,024 warp reads,
// each split into as many wavefronts as it has distinct addresses in one
// bank. At about one wavefront a cycle (1.98 GHz) that is about 0.5 us
// 1-way and 16.5 us 32-way. Everything around those reads is built so that
// it takes less:
//   * Staging: x goes into shared memory with a row pitch of w + 1 units,
//     read as 16-byte vectors by 1,024 threads (512 for 1-byte units, whose
//     kernel needs more registers), eight vectors a thread in flight, each
//     vector scattered into its row(s) (a scalar tail where x is not
//     16-byte aligned or not whole vectors).
//   * Gather: a warp owns 32 output rows g0 .. g0 + 31 and 32 columns
//     c0 .. c0 + 31. Lane L reads source row (g0 + L) * stride % n, column
//     c0 + k, for k = 0 .. 31, all 32 lanes on one column together:
//     Listing 4's sdata[tid * stride]. With 4-byte units and w a multiple
//     of 32, the pitch puts (row, col) in bank (row + col) % 32, so the
//     conflict degree is the most distinct rows of the 32 that share a
//     bank: gcd(stride, 32) when the 32 rows are distinct, fewer where
//     (i * stride) % n repeats within a warp (at n = 128, stride 32 reads
//     4 distinct rows: 4-way). With 2- and 1-byte units the pitch of w + 1
//     units moves a row by less than a bank, and rows whose pitch is a
//     multiple of 128 bytes all start in one bank: those reads conflict
//     more.
//   * Stores: a 32 x 32 transpose in registers (two lane-dependent
//     rotations and 32 shuffles) hands lane L column c0 + L of each of the
//     32 output rows, so that every warp store writes 32 consecutive units
//     of one output row.
// On an H100 at 700 W (PERF.md) it takes about 10 us at stride 1, set by
// the staging and the transpose, and 32-way conflicts add about 15 us at
// (1024, 32) f32. The wrapper raises ValueError when x does not fit in one
// CTA's shared memory (227 KB), as the Pallas kernel is one VMEM block too.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int MAX_SMEM = 232448;    // 227 KB a CTA may opt in to
constexpr int BATCH = 8;            // 16-byte loads a thread keeps in flight

// 1024 threads (64 registers each) where the kernel fits in them; the
// byte kernel needs more registers and takes 512.
template <typename U>
__host__ __device__ constexpr int threads() { return sizeof(U) == 1 ? 512 : 1024; }

// v[k] <- v[(k + r) % 32] for a lane-dependent r: five steps of static moves.
__device__ __forceinline__ void rotate_left(uint32_t (&v)[32], int r) {
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const bool on = (r >> b) & 1;
    uint32_t t[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) t[k] = on ? v[(k + (1 << b)) & 31] : v[k];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = t[k];
  }
}

// Lane L holds row L of a 32 x 32 block in v; afterwards it holds column L.
__device__ __forceinline__ void transpose32(uint32_t (&v)[32], int lane) {
  rotate_left(v, lane);                     // v[k] = M[L][(L + k) % 32]
  uint32_t d[32];
#pragma unroll
  for (int k = 0; k < 32; ++k)              // d[k] = M[(L - k) % 32][L]
    d[k] = __shfl_sync(0xffffffffu, v[k], (lane - k) & 31);
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = d[(32 - k) & 31];
  rotate_left(v, (32 - lane) & 31);         // v[j] = M[j][L]
}

template <typename U>
__global__ void __launch_bounds__(threads<U>(), 1)
strided_kernel(const U* __restrict__ x, U* __restrict__ out, int n, int w, int stride) {
  constexpr int THREADS = threads<U>();
  extern __shared__ __align__(16) uint8_t smem_raw[];
  U* s = reinterpret_cast<U*>(smem_raw);
  const int pitch = w + 1;
  const int total = n * w;

  // staging: 16-byte vectors, BATCH of them in flight a thread
  constexpr int VU = 16 / sizeof(U);
  int staged = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int nvec = total / VU;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += BATCH * THREADS) {
      uint4 val[BATCH];
#pragma unroll
      for (int b = 0; b < BATCH; ++b)
        if (v0 + b * THREADS < nvec) val[b] = xv[v0 + b * THREADS];
#pragma unroll
      for (int b = 0; b < BATCH; ++b) {
        const int vi = v0 + b * THREADS;
        if (vi >= nvec) break;
        U parts[VU];
        memcpy(parts, &val[b], 16);
        int r = vi * VU / w;
        int c = vi * VU - r * w;
#pragma unroll
        for (int u = 0; u < VU; ++u) {
          s[r * pitch + c] = parts[u];
          if (++c == w) {
            c = 0;
            ++r;
          }
        }
      }
    }
    staged = nvec * VU;
  }
  for (int e = staged + threadIdx.x; e < total; e += THREADS) {
    const int r = e / w;
    s[r * pitch + (e - r * w)] = x[e];
  }
  __syncthreads();

  // gather in Listing 4's pattern, then coalesced stores
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunks = (w + 31) / 32;
  const int items = (n + 31) / 32 * chunks;
  for (int item = warp; item < items; item += THREADS / 32) {
    const int g0 = item / chunks * 32;
    const int c0 = item % chunks * 32;
    const int i = g0 + lane;
    const int row = i < n ? static_cast<int>(static_cast<long long>(i) * stride % n) : 0;
    const U* src = s + row * pitch + c0;
    uint32_t v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = c0 + k < w ? static_cast<uint32_t>(src[k]) : 0u;
    transpose32(v, lane);
    if (c0 + lane < w) {
      U* dst = out + static_cast<size_t>(g0) * w + c0 + lane;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (g0 + k < n) dst[static_cast<size_t>(k) * w] = static_cast<U>(v[k]);
    }
  }
}

template <typename U>
cudaError_t launch(const void* x, void* out, int n, int w, int stride, cudaStream_t stream) {
  static unsigned set_on = 0;       // devices the shared-memory attribute is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(set_on >> dev & 1u)) {
    err = cudaFuncSetAttribute(strided_kernel<U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    set_on |= 1u << dev;
  }
  const int smem = static_cast<int>(n * (w + 1) * sizeof(U));
  strided_kernel<U><<<1, threads<U>(), smem, stream>>>(static_cast<const U*>(x),
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
