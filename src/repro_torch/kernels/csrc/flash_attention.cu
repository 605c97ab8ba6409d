// Flash attention forward for Hopper (sm_90a), f32 FMAs on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// TPU kernel (pallas_call at :109). Same function: online-softmax attention
// with f32 running max, running sum and accumulator, mask value -1e30,
// output acc / max(l, 1e-30) cast to the input type, GQA through
//   kv_row(bh) = (bh / H) * Hkv + (bh % H) / (H / Hkv)
// with no KV replication, and a top-left causal mask (row >= col from 0)
// whose wholly masked kv tiles are skipped.
// Layout: q (B*H, Sq, D); k, v (B*Hkv, Sk, D); f32 or bf16; D <= 128.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores), at
// the serving path's shapes (granite-8b: H = 32, Hkv = 8, D = 128, bf16):
//   * S = 256, one prompt, per layer: q + k + v + o = 5.2 MB, 0.54 GFLOP
//     causal -> memory-bound, about 1.6 us.
//   * S = 2048 causal, B*H = 32: 34 GFLOP against 21 MB -> compute-bound,
//     about 35 us, but only on the tensor cores.
//
// What this simple design does about that bound, which is little yet: it
// reads each q tile once and each k/v tile once per q tile (no S x S scores
// in device memory), so its device-memory traffic is near the bytes bound.
// The products run as f32 FMAs on the CUDA cores (67 TFLOP/s peak, not 989),
// tiles are staged by plain loads with no cp.async/TMA overlap, and nothing
// is pipelined; tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Design: one CTA of 256 threads owns one (bh, 64-row q tile) and loops over
// the 64-row kv tiles itself, carrying each row's m, l and accumulator in
// registers (the TPU grid carried them in VMEM scratch across sequential kv
// steps; Hopper runs CTAs in parallel and in no order). Thread (ty, tx) of
// the 16 x 16 layout owns rows ty*4 .. ty*4+3 of the tile, score columns
// tx + 16*j and output columns tx + 16*c. Row max and row sum reduce over
// the 16 lanes of a half-warp with shuffles. Q and K tiles are padded by one
// float per row so that the column reads hit distinct banks. The P tile
// reuses the K tile's shared memory where it fits. Ragged edges (Sq, Sk not
// multiples of 64, D not a multiple of 16) are masked: loads fill zeros,
// columns past Sk score -1e30 with p = 0, and rows past Sq are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int BQ = 64;                 // q rows per CTA
constexpr int BK = 64;                 // kv rows per tile
constexpr int TX = 16;                 // threads along columns
constexpr int TY = 16;                 // threads along rows
constexpr int NTHREADS = TX * TY;
constexpr int RM = BQ / TY;            // rows per thread
constexpr int CN = BK / TX;            // score columns per thread
constexpr int PS = BK + 1;             // padded row stride of the P tile
constexpr float NEG_BIG = -1e30f;

__host__ __device__ constexpr int padded(int dp) { return dp + 1; }
__host__ __device__ constexpr bool p_in_k(int dp) {
  return BQ * PS <= BK * padded(dp);
}
__host__ __device__ constexpr int smem_floats(int dp) {
  return BQ * padded(dp) + BK * padded(dp) + BK * dp + (p_in_k(dp) ? 0 : BQ * PS);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// DP: head dim padded up to a multiple of 16 (16, 32, 64 or 128).
template <typename T, int DP>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int num_q_heads, int num_kv_heads, int sq, int sk, int d,
          int causal, float scale) {
  constexpr int QS = padded(DP);       // padded row stride of the Q and K tiles
  constexpr int NJ = DP / TX;          // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                   // [BQ][QS]
  float* s_k = s_q + BQ * QS;          // [BK][QS]
  float* s_v = s_k + BK * QS;          // [BK][DP]
  float* s_p = p_in_k(DP) ? s_k : s_v + BK * DP;   // [BQ][PS]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int group = num_q_heads / num_kv_heads;
  const int kv_bh = (bh / num_q_heads) * num_kv_heads + (bh % num_q_heads) / group;
  const T* qb = q + (size_t)bh * sq * d;
  const T* kb = k + (size_t)kv_bh * sk * d;
  const T* vb = v + (size_t)kv_bh * sk * d;
  T* ob = o + (size_t)bh * sq * d;

  for (int i = tid; i < BQ * DP; i += NTHREADS) {
    const int r = i / DP, c = i % DP, row = q0 + r;
    s_q[r * QS + c] = (row < sq && c < d) ? to_f32(qb[(size_t)row * d + c]) : 0.f;
  }

  float m[RM], l[RM], acc[RM][NJ];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  int n_kv = (sk + BK - 1) / BK;
  if (causal) {                        // skip tiles wholly above the diagonal
    const int last_row = min(q0 + BQ, sq) - 1;
    n_kv = min(n_kv, last_row / BK + 1);
  }

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();                   // the previous tile's P and V are consumed
    for (int i = tid; i < BK * DP; i += NTHREADS) {
      const int r = i / DP, c = i % DP, col = k0 + r;
      const bool ok = col < sk && c < d;
      s_k[r * QS + c] = ok ? to_f32(kb[(size_t)col * d + c]) : 0.f;
      s_v[r * DP + c] = ok ? to_f32(vb[(size_t)col * d + c]) : 0.f;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      float qa[RM], ka[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = s_q[(ty * RM + i) * QS + dd];
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) ka[jj] = s_k[(tx + TX * jj) * QS + dd];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int jj = 0; jj < CN; ++jj) s[i][jj] = fmaf(qa[i], ka[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty * RM + i;
      bool valid[CN];
      float mx = NEG_BIG;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        const int col = k0 + tx + TX * jj;
        valid[jj] = col < sk && (!causal || row >= col);
        s[i][jj] = valid[jj] ? s[i][jj] * scale : NEG_BIG;
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) {
        s[i][jj] = valid[jj] ? expf(s[i][jj] - m_new) : 0.f;
        rs += s[i][jj];
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= alpha;
    }

    if (p_in_k(DP)) __syncthreads();   // every read of the K tile is done
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int jj = 0; jj < CN; ++jj) s_p[(ty * RM + i) * PS + tx + TX * jj] = s[i][jj];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[RM], va[NJ];
#pragma unroll
      for (int i = 0; i < RM; ++i) pa[i] = s_p[(ty * RM + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NJ; ++c) va[c] = s_v[kk * DP + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int col = tx + TX * c;
      if (col < d) ob[(size_t)row * d + col] = from_f32<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int num_q_heads, int num_kv_heads, int sq, int sk, int d, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats(DP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd<T, DP><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), num_q_heads, num_kv_heads, sq, sk, d, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int bh,
                     int num_q_heads, int num_kv_heads, int sq, int sk, int d, int causal,
                     float scale, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 16>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
int repro_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int bh,
                              int num_q_heads, int num_kv_heads, int sq, int sk, int d,
                              int causal, float scale, int dtype, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || num_kv_heads <= 0 ||
      num_q_heads % num_kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal,
                                scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d,
                                        causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one CTA takes at head dim d (0 for d > 128).
int repro_flash_attention_smem_bytes(int d) {
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0;
  return dp ? smem_floats(dp) * (int)sizeof(float) : 0;
}

}  // extern "C"
