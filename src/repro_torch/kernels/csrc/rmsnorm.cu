// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::_rmsnorm_kernel, the Pallas TPU
// kernel (pallas_call at :32), which streams (block_rows, d) tiles of x
// through VMEM and writes x * rsqrt(mean(x^2) + eps) * scale, all in float32,
// cast once to x's type. Same function, in the same order: the sum of squares
// in float32, r = 1 / sqrt(sum / d + eps) (IEEE sqrt and division, as the
// plain version computes it), then (x * r) * scale in float32 and one cast
// (round to nearest even). The Pallas block_rows tiling is the TPU's; the
// wrapper keeps its divisibility contract and this kernel tiles by row.
//
// Bound on an H100 SXM: bytes. x is read once and out written once, scale
// (d values) read once: (2 * rows * d + d) * itemsize / 3.35 TB/s, 0.3205 ms
// for (65536, 4096) bf16. About 3 operations per element is far below the
// card's rate.
//
// Design: one CTA of 256 threads per row. Where a row is a whole number of
// 16-byte vectors and both pointers are 16-byte aligned, each thread loads
// its share of the row as 16-byte vectors into registers (VPT of them, a
// power of two chosen by the host so that 256 * VPT vectors cover the row),
// sums the squares in float32, and the CTA reduces with warp shuffles and
// then shared memory across the 8 warps; the second pass scales the vectors
// still held in registers, so x is read from device memory once. Otherwise
// (a d whose row is not a multiple of 16 bytes, or a row longer than 16
// vectors a thread) a scalar kernel reads the row twice, the second time
// from L1/L2. scale is read per element through the read-only path; at
// (d,) it stays in L1/L2 across the rows.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_VPT = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Sum of `v` over the CTA; every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[WARPS];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  // a full butterfly, so that every lane (not only the first WARPS) ends
  // with the total
  float t = lane < WARPS ? part[lane] : 0.0f;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

template <typename TX, typename TS, int VPT>
__global__ void __launch_bounds__(THREADS)
rmsnorm_vector(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
               int d, float eps) {
  constexpr int E = 16 / sizeof(TX);  // elements in a 16-byte vector
  const int nvec = d / E;
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  uint4* ov = reinterpret_cast<uint4*>(out + base);

  uint4 buf[VPT];
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * THREADS;
    if (v < nvec) {
      buf[i] = xv[v];
      const TX* e = reinterpret_cast<const TX*>(&buf[i]);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  }
  const float r = 1.0f / sqrtf(block_sum(ss) / static_cast<float>(d) + eps);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * THREADS;
    if (v < nvec) {
      const TX* e = reinterpret_cast<const TX*>(&buf[i]);
      uint4 o;
      TX* oe = reinterpret_cast<TX*>(&o);
#pragma unroll
      for (int j = 0; j < E; ++j)
        oe[j] = from_f32<TX>(to_f32(e[j]) * r * to_f32(__ldg(scale + v * E + j)));
      ov[v] = o;
    }
  }
}

template <typename TX, typename TS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_scalar(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
               int d, float eps) {
  const size_t base = static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < d; c += THREADS) {
    const float f = to_f32(x[base + c]);
    ss += f * f;
  }
  const float r = 1.0f / sqrtf(block_sum(ss) / static_cast<float>(d) + eps);
  for (int c = threadIdx.x; c < d; c += THREADS)
    out[base + c] = from_f32<TX>(to_f32(x[base + c]) * r * to_f32(__ldg(scale + c)));
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  TX* op = static_cast<TX*>(out);
  constexpr int E = 16 / sizeof(TX);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int nvec = d / E;
  int vpt = 1;
  while (vpt * THREADS < nvec) vpt *= 2;
  if (!aligned || d % E != 0 || vpt > MAX_VPT) {
    rmsnorm_scalar<TX, TS><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps);
  } else {
    switch (vpt) {
      case 1: rmsnorm_vector<TX, TS, 1><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps); break;
      case 2: rmsnorm_vector<TX, TS, 2><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps); break;
      case 4: rmsnorm_vector<TX, TS, 4><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps); break;
      case 8: rmsnorm_vector<TX, TS, 8><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps); break;
      default: rmsnorm_vector<TX, TS, 16><<<rows, THREADS, 0, stream>>>(xp, sp, op, d, eps);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale, in float32, cast
// to x's type. x and out are (rows, d) row-major on the card; scale is (d,).
// x_dtype and scale_dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launch (0 on success); the launch is asynchronous on `stream`.
int repro_rmsnorm(const void* x, const void* scale, void* out, int rows, int d, int x_dtype,
                  int scale_dtype, float eps, void* stream) {
  if (rows < 0 || d <= 0 || x_dtype < 0 || x_dtype > 1 || scale_dtype < 0 || scale_dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return scale_dtype == 0 ? launch<float, float>(x, scale, out, rows, d, eps, s)
                            : launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return scale_dtype == 0 ? launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s)
                          : launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, s);
}

// Which kernel a call takes: 1 the register-held vector kernel, 0 the scalar
// one (reported by chip_smoke.py beside the check).
int repro_rmsnorm_vector_path(long long x_addr, long long out_addr, int d, int x_dtype) {
  const int e = x_dtype == 0 ? 4 : 8;
  if (x_addr % 16 || out_addr % 16 || d % e) return 0;
  int vpt = 1;
  while (vpt * THREADS < d / e) vpt *= 2;
  return vpt <= MAX_VPT;
}

}  // extern "C"
