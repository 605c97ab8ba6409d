// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores
// (wgmma, TMA), float32 as f32 FMAs on the CUDA cores.
//
// Replaces: src/repro/kernels/flash_attention.py::_flash_kernel, the Pallas
// TPU kernel (pallas_call at :109). Same function on both routes:
// online-softmax attention with f32 running max, running sum and
// accumulator, mask value -1e30, output acc / max(l, 1e-30) cast to the
// input type, GQA through
//   kv_row(bh) = (bh / H) * Hkv + (bh % H) / (H / Hkv)
// with no KV replication, and a top-left causal mask (row >= col from 0)
// whose wholly masked kv tiles are skipped. Ragged Sq and Sk are masked in
// the kernel's own tiles. Layout: q (B*H, Sq, D); k, v (B*Hkv, Sk, D).
// The wrapper picks the route by dtype; there is no fallback between them.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense on the tensor
// cores), at the serving path's shapes (granite-8b: H = 32, Hkv = 8,
// D = 128, bf16):
//   * S = 256, one prompt, per layer: q + k + v + o = 5.2 MB, 0.54 GFLOP
//     causal -> bytes, about 1.6 us; a batch of 4 prompts, 6.3 us.
//   * S = 2048 causal, B*H = 32: 34 GFLOP against 21 MB -> operations,
//     about 35 us, reachable only on the tensor cores.
//
// bf16 route (flash_wgmma). A CTA owns one (bh, q tile) of 64 rows for each
// of its 1 or 2 consumer warpgroups, and one producer warp:
//   * The producer brings the CTA's Q tile in once and the K and V tiles of
//     64 kv rows through a ring of 2 or 3 stages by TMA
//     (cp.async.bulk.tensor, 128-byte swizzle), each stage waited on with a
//     "full" mbarrier (transaction bytes) and released by an "empty" one
//     that every consumer warp arrives on. The tensor maps are 3-D over
//     (bh, S, D) with a box of (1, 64, 64), built on the host by
//     cuTensorMapEncodeTiled and passed as __grid_constant__ parameters, so
//     rows past S (and columns past D, when D < 64) are zero-filled by the
//     hardware and never come from the next head. D = 128 is two 64-column
//     boxes, each its own swizzled [64][64] block.
//   * A consumer warpgroup computes S = Q K^T with wgmma.m64n64k16 (Q and K
//     K-major from shared memory, f32 accumulators in registers; the
//     descriptors are made once and stepped by constants, in uniform
//     registers), then the online softmax on the accumulator fragments:
//     each thread holds two rows, and a row's max reduces over the 4 lanes
//     that hold it (its sum stays per lane until the epilogue). The max is
//     taken over raw scores and p = exp2(s * scale * log2 e - m) is one FFMA
//     and one MUFU; only tiles that hold a column past Sk or above the
//     diagonal run the masking variant (-1e30, p = 0), and the O rescale is
//     skipped where no row's max moved.
//   * P is rounded to bf16 in registers and is the register-A operand of
//     O += P V (wgmma.m64n{64,128}k16); V is read from shared memory as it
//     lies, D-contiguous, through the descriptor's transpose bit for 16-bit
//     types. The Pallas kernel keeps P in f32 for that product: rounding P
//     to bf16 is the one rounding this route adds, a relative error of at
//     most 2^-9 on each weight, inside the 2e-2 bf16 tolerance
//     (tests/test_kernels.py:95).
//   * Software pipeline: S of tile j is issued with P V of tile j - 1
//     behind it, and the softmax of tile j runs while that P V does.
//   * The epilogue writes O, scaled by 1 / max(l, 1e-30), as bf16 into the
//     warpgroup's own Q boxes in the same swizzle and stores each box with
//     one TMA store: whole 128-byte lines, rows past Sq and columns past D
//     clipped by the map (stores of bf16 pairs straight from the fragments
//     write half-filled sectors, and were slower on the card).
//   * Causal q tiles go heaviest first (the last q tile of every head is
//     launched first). Past 256 rows a CTA takes 2 consumer warpgroups (128
//     q rows sharing one K/V stream); up to 256, one, so that two CTAs
//     share an SM: the dense engine's per-request prefill (bh 32, S <= 255)
//     runs up to 128 CTAs of 64 rows and the loop's (bh 128, S 256) 512.
// A negative scale reaches the kernel as -q with -scale (the wrapper), so
// that the max over raw scores is the max over scaled ones.
// Tried in trial builds on the card and not kept (PERF.md): kv tiles
// of 128 rows (S = Q K^T as m64n128, slower at the shapes tried, also with
// setmaxnreg moving a producer warpgroup's registers to the consumers) and
// FA3's ping-pong of the two warpgroups' GEMMs on named barriers (no gain).
// f32 route (flash_fwd), unchanged since it was first written: TF32 would
// break the 2e-5 float32 tolerance. One CTA of 256 threads owns one
// (bh, 64-row q tile) and loops over the 64-row kv tiles, carrying each
// row's m, l and accumulator in registers (the TPU grid carried them in
// VMEM scratch across sequential kv steps; Hopper runs CTAs in parallel and
// in no order). Thread (ty, tx) of the 16 x 16 layout owns rows
// ty*4 .. ty*4+3 of the tile, score columns tx + 16*j and output columns
// tx + 16*c. Row max and row sum reduce over the 16 lanes of a half-warp
// with shuffles. Q and K tiles are padded by one float per row so that the
// column reads hit distinct banks. The P tile reuses the K tile's shared
// memory where it fits. Ragged edges (Sq, Sk not multiples of 64, D not a
// multiple of 16) are masked: loads fill zeros, columns past Sk score -1e30
// with p = 0, and rows past Sq are not stored. Its products run as f32 FMAs
// (67 TFLOP/s peak), staged by plain loads with no overlap.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c_api.cuh"

// ---------------------------------------------------------------------------
// f32 route: f32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

namespace fma_route {


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

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int bh,
                   int num_q_heads, int num_kv_heads, int sq, int sk, int d, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = smem_floats(DP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<float, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  flash_fwd<float, DP><<<grid, NTHREADS, smem, stream>>>(q, k, v, o, num_q_heads, num_kv_heads,
                                                         sq, sk, d, causal, scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v, float* o, int bh,
                     int num_q_heads, int num_kv_heads, int sq, int sk, int d, int causal,
                     float scale, cudaStream_t stream) {
  if (d <= 16)
    return launch<16>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 32)
    return launch<32>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 64)
    return launch<64>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  if (d <= 128)
    return launch<128>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d, causal, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fma_route

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores, TMA into swizzled shared memory
// ---------------------------------------------------------------------------

namespace wgmma_route {

constexpr int BM = 64;                    // q rows of one consumer warpgroup
constexpr int BN = 64;                    // kv rows of one tile
constexpr int BOX = 64 * 128;             // one TMA box: [64 rows][64 cols] bf16, 8 KB
constexpr float NEG_BIG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// NWG consumer warpgroups of 64 q rows, head dim padded to DP (64 or
// 128). Byte offsets are from the 1 KB-aligned base of dynamic shared
// memory.
template <int NWG, int DP>
struct Layout {
  static constexpr int NC = DP / 64;                          // 64-column boxes per row
  static constexpr int STAGES = NWG == 2 ? 3 : 2;             // K/V ring depth
  static constexpr int THREADS = NWG * 128 + 32;              // + the producer warp
  static constexpr int Q = 0;                                 // [NWG][NC] boxes
  static constexpr int K = Q + NWG * NC * BOX;                // [STAGES][NC]
  static constexpr int V = K + STAGES * NC * BOX;             // [STAGES][NC]
  static constexpr int BAR = V + STAGES * NC * BOX;           // q, full[STAGES], empty[STAGES]
  static constexpr int ALLOC = BAR + 8 * (1 + 2 * STAGES) + 1024;   // + room to align
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completion counts its
// bytes on `bar`. Coordinates are (column, row, head), innermost first.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
         "r"(head)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Placed after a wait: keeps the compiler from reading an accumulator, or
// reusing an operand's registers, before the wgmma that uses them is done.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(d[i][r]) :: "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64 x n64, f32) = A (m64 x k16, bf16, smem, K-major) * B (k16 x n64,
// bf16, smem, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_m64n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

template <int DP>
__device__ __forceinline__ void pv_step(float (&acc)[DP / 2], const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void pv_step<64>(float (&acc)[32], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n64_tb(acc, a, db);
}
template <>
__device__ __forceinline__ void pv_step<128>(float (&acc)[64], const uint32_t (&a)[4], uint64_t db) {
  wgmma_rs_m64n128_tb(acc, a, db);
}

// S (m64 x n64) = Q K^T over D in k16 steps; a step is 32 bytes into a
// 128-byte row, and every 4 steps the next 64-column box. The descriptors
// of the tiles' starts are made once; a step adds its offset (in 16-byte
// units) to their address field, which no step carries out of.
template <int DP>
__device__ __forceinline__ void qk_mma(float (&sc)[32], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t off = ((kk / 4) * BOX + (kk % 4) * 32) >> 4;
    wgmma_ss_m64n64(sc, dq + off, dk + off, kk > 0);
  }
}

// O += P V. V is D-contiguous (MN-major): a k16 step is 16 rows of 128
// bytes, and the next 64 columns of D are the next box (leading offset).
template <int DP>
__device__ __forceinline__ void pv_mma(float (&acc)[DP / 2], const uint32_t (&pa)[BN / 16][4],
                                       uint64_t dv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) pv_step<DP>(acc, pa[kk], dv + ((kk * 16 * 128) >> 4));
}

// Online softmax of one tile, in place: sc (raw scores) becomes P; m (in
// the base-2 domain, scores times scale_log2 > 0) and this lane's l are
// carried; alpha is each row's rescale factor. Fragment i of a thread is
// row row0 + 8 * ((i % 4) / 2), column k0 + 8 * (i / 4) + cq + i % 2; a
// row's BN columns lie on 4 lanes. The row max is taken over raw scores
// (the scale is positive), so that p = exp2(s * scale_log2 - m) is one FFMA
// and one MUFU. MASKED tiles (past Sk, or across the diagonal) give their
// masked columns -1e30 and p = 0; the others skip the test.
template <bool MASKED>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int causal, int sk, int k0,
                                             int row0, int cq, float scale_log2) {
  float mx[2] = {NEG_BIG, NEG_BIG};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if constexpr (MASKED) {
      const int col = k0 + 8 * (i / 4) + cq + i % 2;
      const int row = row0 + 8 * ((i % 4) / 2);
      if (col >= sk || (causal && row < col)) sc[i] = NEG_BIG;
    }
    mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
  }
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h] * scale_log2);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
    neg_m[h] = -m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i % 4) / 2;
    float p = exp2_approx(fmaf(sc[i], scale_log2, neg_m[h]));
    if constexpr (MASKED) {
      if (sc[i] == NEG_BIG) p = 0.f;                // also where m is still NEG_BIG
    }
    sc[i] = p;
    l[h] += p;
  }
}

// The softmax of the tile at k0: the masked variant only where a column
// lies past Sk or above the diagonal of this warpgroup's rows.
__device__ __forceinline__ void softmax(float (&sc)[32], float (&m)[2], float (&l)[2],
                                        float (&alpha)[2], int causal, int sk, int k0,
                                        int wg_row, int row0, int cq, float scale_log2) {
  if (k0 + BN > sk || (causal && k0 + BN - 1 > wg_row))
    softmax_tile<true>(sc, m, l, alpha, causal, sk, k0, row0, cq, scale_log2);
  else
    softmax_tile<false>(sc, m, l, alpha, causal, sk, k0, row0, cq, scale_log2);
}

// P in bf16 as the register A operand: the accumulator layout of columns
// 16 kk .. 16 kk + 15 is the A fragment of k step kk.
__device__ __forceinline__ void to_operand(const float (&sc)[32], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

// NWG consumer warpgroups of 64 q rows each, then one producer warp.
// DP: D padded up to 64 or 128 (zero columns from the TMA fill).
template <int NWG, int DP>
__global__ void __launch_bounds__(Layout<NWG, DP>::THREADS, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
            int bh_count, int num_q_heads, int num_kv_heads, int sq, int sk, int causal,
            float scale_log2) {
  using L = Layout<NWG, DP>;
  constexpr int NC = L::NC;
  constexpr int STAGES = L::STAGES;
  constexpr int BQ = NWG * BM;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::BAR;
  const uint32_t bar_full = bar_q + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;    // + 8 * stage

  // heaviest first: block b takes the (b / bh_count)-th q tile from the end
  const int n_qt = (sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int group = num_q_heads / num_kv_heads;
  const int kv_bh = (bh / num_q_heads) * num_kv_heads + (bh % num_q_heads) / group;
  int n_kv = (sk + BN - 1) / BN;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, sq) - 1) / BN + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * 128) {                              // the producer
    if (tid == NWG * 128) {
      mbar_expect_tx(bar_q, NWG * NC * BOX);
      for (int w = 0; w < NWG; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(base + L::Q + (w * NC + c) * BOX, &tm_q, bar_q, 64 * c, q0 + BM * w, bh);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, (j / STAGES - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * NC * BOX);
        for (int c = 0; c < NC; ++c) {
          tma_load(base + L::K + (s * NC + c) * BOX, &tm_k, bar_full + 8 * s, 64 * c,
                   BN * j, kv_bh);
          tma_load(base + L::V + (s * NC + c) * BOX, &tm_v, bar_full + 8 * s, 64 * c,
                   BN * j, kv_bh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg_row .. wg_row + 63 (read from lane 0, so
  // that the compiler sees it uniform and keeps descriptors in uniform
  // registers)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int wg_row = q0 + BM * wg;
  const int row0 = wg_row + 16 * warp + lane / 4;      // this thread's rows: row0, row0 + 8
  const int cq = 2 * (lane % 4);                       // its column in each 8-column group
  const uint32_t q_smem = base + L::Q + wg * NC * BOX;

  const uint64_t dq = desc_sw128(q_smem, 16, 1024);
  const uint64_t dk0 = desc_sw128(base + L::K, 16, 1024);
  const uint64_t dv0 = desc_sw128(base + L::V, BOX, 1024);
  constexpr uint32_t STAGE_STEP = (NC * BOX) >> 4;    // one stage, in 16-byte units

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_BIG, NEG_BIG};
  float l[2] = {0.f, 0.f};                             // this lane's part of each row sum
  float sc[32];                                        // S, then P, of one tile
  uint32_t pa[BN / 16][4];                             // P in bf16, the A operand of P V
  float alpha[2];

  // Software pipeline: S of tile j runs with P V of tile j - 1 behind it,
  // and the softmax of tile j overlaps that P V.
  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  wgmma_fence();
  qk_mma<DP>(sc, dq, dk0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(sc, m, l, alpha, causal, sk, 0, wg_row, row0, cq, scale_log2);
  to_operand(sc, pa);
  int stage = 0;                                       // tile j - 1's stage
  uint32_t phase = 0;                                  // parity of tile j's fill
  for (int j = 1; j < n_kv; ++j) {
    const int prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
    mbar_wait(bar_full + 8 * stage, phase);
    wgmma_fence();
    qk_mma<DP>(sc, dq, dk0 + stage * STAGE_STEP);
    wgmma_commit();
    pv_mma<DP>(acc, pa, dv0 + prev * STAGE_STEP);
    wgmma_commit();
    wgmma_wait<1>();                                   // S of tile j is in
    fence_regs(sc);
    softmax(sc, m, l, alpha, causal, sk, BN * j, wg_row, row0, cq, scale_log2);
    wgmma_wait<0>();                                   // P V of tile j - 1 is in
    fence_regs(acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(bar_empty + 8 * prev);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i % 4) / 2];
    }
    to_operand(sc, pa);
  }
  wgmma_fence();
  pv_mma<DP>(acc, pa, dv0 + stage * STAGE_STEP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
  // O through this warpgroup's Q boxes, which its last QK^T has read, in
  // the same 128-byte swizzle, then one TMA store a box: whole lines, and
  // rows past Sq and columns past D clipped by the tensor map
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
#pragma unroll
    for (int jj = 0; jj < DP / 8; ++jj) {
      const uint32_t addr = q_smem + (jj / 8) * BOX + r * 128 + (((jj % 8) ^ (r % 8)) << 4) + 2 * cq;
      const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * jj + 2 * h] * inv[h],
                                                     acc[4 * jj + 2 * h + 1] * inv[h]);
      asm volatile("st.shared.b32 [%0], %1;\n"
                   :: "r"(addr), "r"(*reinterpret_cast<const uint32_t*>(&v)) : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");   // this warpgroup's rows
  if (tid % 128 == 0) {
    for (int c = 0; c < NC; ++c)
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
          :: "l"(reinterpret_cast<uint64_t>(&tm_o)), "r"(q_smem + c * BOX), "r"(64 * c),
             "r"(wg_row), "r"(bh)
          : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");   // before smem goes
  }
}

// cuTensorMapEncodeTiled, from libcuda; the wrapper hands its address in.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled = nullptr;

// (heads, rows, d) bf16, box (1, 64, 64), 128-byte swizzle. A load fills
// out-of-range rows and columns with zeros; a store skips them.
CUresult make_map(CUtensorMap* map, const void* ptr, int heads, int rows, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 2 consumer warpgroups (128 q rows, one K/V stream for both) a CTA past
// 256 rows; up to 256, CTAs of one warpgroup, two of which share an SM,
// hide the latency of their few kv tiles better (PERF.md).
int warpgroups(int sq) { return sq > 256 ? 2 : 1; }

template <int NWG, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh,
                   int num_q_heads, int num_kv_heads, int sq, int sk, int d, int causal,
                   float scale, cudaStream_t stream) {
  using L = Layout<NWG, DP>;
  const int bhkv = bh / num_q_heads * num_kv_heads;
  CUtensorMap mq, mk, mv, mo;
  CUresult r = make_map(&mq, q, bh, sq, d);
  if (r == CUDA_SUCCESS) r = make_map(&mk, k, bhkv, sk, d);
  if (r == CUDA_SUCCESS) r = make_map(&mv, v, bhkv, sk, d);
  if (r == CUDA_SUCCESS) r = make_map(&mo, o, bh, sq, d);
  if (r != CUDA_SUCCESS) return static_cast<cudaError_t>(-static_cast<int>(r));
  static unsigned set_on = 0;                           // devices the attribute is set on
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(set_on >> dev & 1u)) {
    err = cudaFuncSetAttribute(flash_wgmma<NWG, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::ALLOC);
    if (err != cudaSuccess) return err;
    set_on |= 1u << dev;
  }
  const int blocks = bh * ((sq + NWG * BM - 1) / (NWG * BM));
  flash_wgmma<NWG, DP><<<blocks, L::THREADS, L::ALLOC, stream>>>(
      mq, mk, mv, mo, bh, num_q_heads, num_kv_heads, sq, sk, causal, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wgmma_route

extern "C" {

// float32 route. Returns cudaGetLastError() after the launch (0 on
// success); the launch is asynchronous on `stream`.
int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o, int bh,
                              int num_q_heads, int num_kv_heads, int sq, int sk, int d,
                              int causal, float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || num_kv_heads <= 0 ||
      num_q_heads % num_kv_heads != 0)
    return (int)cudaErrorInvalidValue;
  return (int)fma_route::dispatch(static_cast<const float*>(q), static_cast<const float*>(k),
                                  static_cast<const float*>(v), static_cast<float*>(o), bh,
                                  num_q_heads, num_kv_heads, sq, sk, d, causal, scale,
                                  static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one CTA of the float32 route takes at head dim d
// (0 for d > 128).
int repro_flash_attention_smem_bytes(int d) {
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 0;
  return dp ? fma_route::smem_floats(dp) * (int)sizeof(float) : 0;
}

// libcuda's cuTensorMapEncodeTiled, which the bf16 route needs.
void repro_flash_set_encoder(void* fn) {
  wgmma_route::encode_tiled = reinterpret_cast<wgmma_route::EncodeTiled>(fn);
}

// bf16 route. d a multiple of 8 up to 128; q, k, v, o 16-byte aligned;
// scale >= 0 (the row max is taken over unscaled scores). Returns
// cudaGetLastError() after the launch (0 on success), or -r when
// cuTensorMapEncodeTiled returned r.
int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int bh,
                               int num_q_heads, int num_kv_heads, int sq, int sk, int d,
                               int causal, float scale, void* stream) {
  using namespace wgmma_route;
  if (bh <= 0 || sq <= 0 || sk <= 0 || d <= 0 || d > 128 || d % 8 || num_kv_heads <= 0 ||
      num_q_heads % num_kv_heads != 0 || !(scale >= 0.f) || encode_tiled == nullptr ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool two = warpgroups(sq) == 2;
  if (d <= 64)
    return (int)(two ? launch<2, 64>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d,
                                        causal, scale, st)
                     : launch<1, 64>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d,
                                        causal, scale, st));
  return (int)(two ? launch<2, 128>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d,
                                       causal, scale, st)
                   : launch<1, 128>(q, k, v, o, bh, num_q_heads, num_kv_heads, sq, sk, d,
                                       causal, scale, st));
}

// Consumer warpgroups (64 q rows each) a CTA of the bf16 route takes at
// sq, and that CTA's dynamic shared memory at head dim d <= 128.
int repro_flash_bf16_warpgroups(int sq) { return wgmma_route::warpgroups(sq); }
int repro_flash_bf16_smem_bytes(int sq, int d) {
  using wgmma_route::Layout;
  const bool two = wgmma_route::warpgroups(sq) == 2;
  if (d <= 64) return two ? Layout<2, 64>::ALLOC : Layout<1, 64>::ALLOC;
  return two ? Layout<2, 128>::ALLOC : Layout<1, 128>::ALLOC;
}

}  // extern "C"
