// Paged decode attention for Hopper (sm_90a): one query a row against its
// own pages of a paged KV pool, read where they lie through the page table.
//
// Replaces no TPU kernel. The JAX package's paged path
// (src/repro/models/layers.py, apply_attention's page_table branch) gathers
// every slot's whole page-table row into a dense (B, P * page_len) copy and
// attends through the masked plain branch; it has no pallas_call. This
// kernel computes the function that branch computes for one query a row:
//   o[b, h] = softmax_t(q[b, h] . k[b, t] * D^-0.5) v[b, t],  t = 0..pos[b]
// with k[b, t] = k_pool[table[b, t / page_len], t % page_len, h / G], G =
// H / Hkv, q's type bf16 or f32, widened in registers; q.k, the softmax and
// P.v in f32 with P kept in f32; the output cast once (round to nearest).
// A row whose first table entry is page 0 (the engine's scratch page, which
// it points every idle row at and which a live row never maps at position
// 0) reads nothing and is written as zeros.
//
// Bound on an H100 SXM: bytes. Each live position's K and V row of one KV
// head is read once: 2 * Hkv * D * itemsize a position and layer, 4 KB at
// granite-8b's 8 KV heads of 128 in bf16. A GQA group of 4 does 4 * 2 * D
// MACs against 4 * D bytes, about 2 FLOPs a byte, far below the card's 295
// (bf16) or 20 (f32 on the CUDA cores). The granite-8b.chat cell's ~30k
// live positions a tick are 123 MB a layer: 37 us at 3.35 TB/s, 1.3 ms over
// 36 layers.
//
// Design:
//   * Work items. An item is (row b, KV head h, split sp): the positions
//     [sp * split_len, min((sp + 1) * split_len, pos[b] + 1)) of one KV head
//     (split_len is a whole number of pages, 256 positions or more). Only
//     live items exist: each CTA reads the positions and first table entries
//     of all rows, counts each live row's splits and scans them into row
//     starts in shared memory (no host sync, no list made on the host), then
//     walks the items blockIdx.x, blockIdx.x + gridDim.x, ... The grid is the
//     CTAs the card holds at once, so the skewed lengths of a chat mix (a
//     4,095-position row beside many short ones) spread over all SMs, and no
//     CTA is launched for an idle row or a position past a row's end. Items
//     go with the KV head fastest, so neighbouring CTAs read the same pages.
//   * Loads. An item streams its positions in tiles of 64 through a ring of
//     2 stages in shared memory with 16-byte cp.async.cg (L2 only; each byte
//     is read once): 2 stages let 3 CTAs share an SM, which read faster than
//     2 CTAs of 3 stages on the card. A tile row is one head's D values, 256
//     B for bf16 at D 128, at a stride of Hkv * D in the pool. The item's
//     table entries are copied to shared memory first, so that the threads
//     issuing a tile's copies look each row's page up there and not in L2
//     between one copy and the next. Rows are stored with their
//     16-byte chunks XOR-swizzled by the row's parity, so that the four lanes
//     of two positions read eight distinct bank groups. Rows whose bytes are
//     not a whole number of 16-byte chunks, or a pool not 16-byte aligned,
//     take a scalar load path into the same layout.
//   * q.k. Four lanes share a position, each summing a quarter of D's
//     8-element groups, for two positions (p and p + 32) at once, so each
//     q value read from shared memory (f32, loaded once an item) serves two
//     keys; the four partial sums reduce with two shuffles.
//   * Softmax. The tile's max and sum of each query head reduce over the
//     warp with shuffles and over the 4 warps through shared memory; every
//     thread keeps the running max m and sum l. P goes to shared memory in
//     f32.
//   * P.v. Each thread owns two output columns for every query head of the
//     group and a share of the tile's positions, rescales its accumulators
//     by exp(m_old - m_new) once a tile and adds p * v in f32.
//   * Combine. An item writes its unnormalised accumulator and (m, l) to a
//     scratch buffer the wrapper allocates; a second kernel, one CTA a query
//     head and row, merges a row's splits (rescaled to their common max),
//     divides by the sum and writes the output, or zeros for an idle row.
//   * Group and head dim. Groups up to 4 take the kernel built for 4, up to
//     16 the one built for 16 (a head of the group past G is skipped, not
//     computed); D up to 128.

#include <algorithm>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "c_api.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int LANES_PER_POS = 4;                      // lanes sharing one key
constexpr int POS_PER_THREAD = 2;                     // keys a lane group takes
constexpr int TILE = THREADS / LANES_PER_POS * POS_PER_THREAD;   // 64
constexpr int STAGES = 2;
constexpr int MAX_D = 128;
constexpr int COMBINE_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;

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

// D rounded up to a multiple of 32: the q.k loop's 8-element groups, a
// quarter of them a lane.
__host__ __device__ __forceinline__ int padded_d(int d) { return (d + 31) / 32 * 32; }

// Row bytes of a stage and whether its chunks are swizzled (8 or more
// 16-byte chunks a row).
__host__ __device__ __forceinline__ int row_bytes(int d, int itemsize) {
  return padded_d(d) * itemsize;
}

// Entries of the item's page-table slice in shared memory: even, so that
// what follows it stays 16-byte aligned.
__host__ __device__ __forceinline__ int ptab_len(int split_pages) {
  return (split_pages + 1) / 2 * 2;
}

__device__ __forceinline__ int swz(int r, bool on) { return on ? (r & 1) << 2 : 0; }

// Byte offset of element byte `byte` of row r in a stage.
__device__ __forceinline__ int stage_off(int r, int byte, int rb, bool on) {
  return r * rb + ((((byte >> 4) ^ swz(r, on))) << 4) + (byte & 15);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1) : "memory");
}

// 8 consecutive elements (one 8-element group, 16-byte aligned in the
// stage's layout) as f32.
__device__ __forceinline__ void load8(const char* p, float* out, __nv_bfloat16*) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const char* p, float* out, float*) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// Two consecutive elements at an even element index, as f32.
__device__ __forceinline__ float2 load2(const char* p, __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const char* p, float*) {
  return *reinterpret_cast<const float2*>(p);
}

struct Args {
  const void* q;            // (B, H, D)
  const void* k;            // (num_pages, page_len, Hkv, D)
  const void* v;
  const long long* table;   // (B, P)
  const long long* pos;     // (B,)
  float* part_acc;          // (B * Hkv * NS, G, D)
  float* part_ml;           // (B * Hkv * NS, G, 2)
  void* out;                // (B, H, D)
  int B, H, Hkv, G, D, P, page_len, pl_shift, split_len, split_pages, NS;
  float scale;
  int vec;                  // 16-byte cp.async loads (else scalar)
};

// Positions of row b (0 for an idle row).
__device__ __forceinline__ int row_len(const Args& a, int b) {
  const long long first = a.table[static_cast<size_t>(b) * a.P];
  long long n = a.pos[b] + 1;
  const long long cap = static_cast<long long>(a.P) * a.page_len;
  if (first == 0 || n <= 0) return 0;
  return static_cast<int>(n < cap ? n : cap);
}

template <int GM>
__host__ __device__ __forceinline__ size_t stage_bytes(int d, int itemsize) {
  const size_t stages = static_cast<size_t>(STAGES) * 2 * TILE * row_bytes(d, itemsize);
  // the item's closing reduction reuses the stages: NSET sets x GM x 2 CP
  const int cp = (d + 1) / 2;
  const size_t red = static_cast<size_t>(THREADS / cp) * GM * 2 * cp * sizeof(float);
  const size_t m = stages > red ? stages : red;
  return (m + 127) / 128 * 128;
}

template <int GM>
__host__ __device__ __forceinline__ size_t smem_bytes(int d, int itemsize, int rows,
                                                      int split_pages) {
  return stage_bytes<GM>(d, itemsize)
         + static_cast<size_t>(ptab_len(split_pages)) * sizeof(long long)   // pages
         + static_cast<size_t>(GM) * padded_d(d) * sizeof(float)   // q
         + static_cast<size_t>(TILE) * GM * sizeof(float)          // p
         + 2 * static_cast<size_t>(WARPS) * GM * sizeof(float)     // warp max, sum
         + (2 * static_cast<size_t>(rows) + 1) * sizeof(int);      // row starts, lengths
}

template <typename T, int GM>
__global__ void __launch_bounds__(THREADS)
paged_decode_split(const Args a) {
  extern __shared__ __align__(128) char smem[];
  constexpr int ES = sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, G = a.G, Hkv = a.Hkv;
  const int DR = padded_d(D);
  const int RB = row_bytes(D, ES);
  const bool sw = (RB >> 4) % 8 == 0;
  const size_t SB = stage_bytes<GM>(D, ES);
  const int tile_bytes = TILE * RB;

  char* stages = smem;
  long long* ptab = reinterpret_cast<long long*>(smem + SB);
  float* qs = reinterpret_cast<float*>(ptab + ptab_len(a.split_pages));
  float* ps = qs + GM * DR;
  float* wmax = ps + TILE * GM;
  float* wsum = wmax + WARPS * GM;
  int* rowstart = reinterpret_cast<int*>(wsum + WARPS * GM);
  int* rowlen = rowstart + a.B + 1;

  // -- live rows: their lengths and split counts, scanned into row starts
  for (int b = tid; b < a.B; b += THREADS) rowlen[b] = row_len(a, b);
  __syncthreads();
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) rowstart[0] = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int b = base + lane;
      int n = b < a.B ? (rowlen[b] + a.split_len - 1) / a.split_len : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, n, off);
        if (lane >= off) n += t;
      }
      if (b < a.B) rowstart[b + 1] = carry + n;
      carry += __shfl_sync(FULL, n, 31);
    }
  }
  __syncthreads();
  const int items = rowstart[a.B] * Hkv;

  // -- per-thread roles
  const int quarter = tid & (LANES_PER_POS - 1);    // q.k: which 8-element groups
  const int rp = tid / LANES_PER_POS;               // q.k: positions rp, rp + 32
  const int CP = (D + 1) / 2;                       // P.v: column pairs
  const int NSET = THREADS / CP;
  const int pset = tid / CP, pcol = tid % CP;
  const bool pv_on = pset < NSET;
  // loads: CH 16-byte chunks (or D elements) a row, RPI rows a round
  const int CH = a.vec ? D * ES / 16 : D;
  const int RPI = THREADS / CH;
  const int lrow = tid / CH, lcol = tid % CH;
  const bool ld_on = lrow < RPI;
  const size_t head_stride = static_cast<size_t>(Hkv) * D;
  const char* kpool = static_cast<const char*>(a.k);
  const char* vpool = static_cast<const char*>(a.v);

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int h = item % Hkv;
    const int rs = item / Hkv;
    int lo = 0, hi = a.B;                           // last b with rowstart[b] <= rs
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (rowstart[mid] <= rs) lo = mid; else hi = mid;
    }
    const int b = lo, sp = rs - rowstart[b];
    const int start = sp * a.split_len;
    const int end = min(start + a.split_len, rowlen[b]);
    const int ntiles = (end - start + TILE - 1) / TILE;
    const long long* trow = a.table + static_cast<size_t>(b) * a.P;
    const int page0 = sp * a.split_pages;

    __syncthreads();           // the previous item is done with every buffer
    for (int i = tid; i < a.split_pages && page0 + i < a.P; i += THREADS)
      ptab[i] = trow[page0 + i];
    const T* qrow = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.H + h * G) * D;
    for (int i = tid; i < GM * DR; i += THREADS) {
      const int g = i / DR, d = i % DR;
      qs[i] = (g < G && d < D) ? to_f32(qrow[g * D + d]) : 0.0f;
    }
    if (DR != D) {             // columns past D read as zeros in q.k and P.v
      for (int i = tid; i < STAGES * 2 * TILE; i += THREADS)
        for (int byte = D * ES; byte < RB; byte += ES)
          *reinterpret_cast<T*>(stages + static_cast<size_t>(i / TILE) * tile_bytes
                                + stage_off(i % TILE, byte, RB, sw)) = from_f32<T>(0.0f);
    }
    __syncthreads();           // the item's pages are in shared memory

    auto load_tile = [&](int t) {
      const int t0 = start + t * TILE;
      const int nv = min(TILE, end - t0);
      char* kst = stages + static_cast<size_t>(t % STAGES) * 2 * tile_bytes;
      char* vst = kst + tile_bytes;
      if (!ld_on) return;
      for (int r = lrow; r < nv; r += RPI) {
        const int p = t0 + r;
        const int pg = a.pl_shift >= 0 ? p >> a.pl_shift : p / a.page_len;
        const int off = p - pg * a.page_len;
        const size_t row =
            (static_cast<size_t>(ptab[pg - page0]) * a.page_len + off) * head_stride
            + static_cast<size_t>(h) * D;
        if (a.vec) {
          const int so = stage_off(r, lcol * 16, RB, sw);
          cp_async16(kst + so, kpool + row * ES + lcol * 16);
          cp_async16(vst + so, vpool + row * ES + lcol * 16);
        } else {
          const int so = stage_off(r, lcol * ES, RB, sw);
          *reinterpret_cast<T*>(kst + so) = reinterpret_cast<const T*>(kpool)[row + lcol];
          *reinterpret_cast<T*>(vst + so) = reinterpret_cast<const T*>(vpool)[row + lcol];
        }
      }
    };

    float m[GM], l[GM], acc[GM][2];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = -INFINITY;
      l[g] = 0.0f;
      acc[g][0] = acc[g][1] = 0.0f;
    }

#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
      if (t < ntiles) load_tile(t);
      cp_async_commit();
    }
    for (int t = 0; t < ntiles; ++t) {
      if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
      cp_async_commit();
      cp_async_wait_ahead();
      __syncthreads();
      const int nv = min(TILE, end - (start + t * TILE));
      const char* kst = stages + static_cast<size_t>(t % STAGES) * 2 * tile_bytes;
      const char* vst = kst + tile_bytes;

      // -- q.k for positions rp and rp + 32
      float s[POS_PER_THREAD][GM];
#pragma unroll
      for (int j = 0; j < POS_PER_THREAD; ++j)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[j][g] = 0.0f;
      const int r0 = rp, r1 = rp + TILE / 2;
      for (int grp = quarter; grp < DR / 8; grp += LANES_PER_POS) {
        float k0[8], k1[8];
        const int byte = grp * 8 * ES;
        load8(kst + stage_off(r0, byte, RB, sw), k0, static_cast<T*>(nullptr));
        load8(kst + stage_off(r1, byte, RB, sw), k1, static_cast<T*>(nullptr));
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(qs + g * DR + grp * 8);
            const float4 qb = *reinterpret_cast<const float4*>(qs + g * DR + grp * 8 + 4);
            const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              s[0][g] = fmaf(qv[e], k0[e], s[0][g]);
              s[1][g] = fmaf(qv[e], k1[e], s[1][g]);
            }
          }
        }
      }
      // rows past nv hold stale data: their scores are -inf and p = 0
      const bool ok0 = r0 < nv, ok1 = r1 < nv;
      float alpha[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
#pragma unroll
          for (int j = 0; j < POS_PER_THREAD; ++j) {
            s[j][g] += __shfl_xor_sync(FULL, s[j][g], 1);
            s[j][g] += __shfl_xor_sync(FULL, s[j][g], 2);
          }
          s[0][g] = ok0 ? s[0][g] * a.scale : -INFINITY;
          s[1][g] = ok1 ? s[1][g] * a.scale : -INFINITY;
          float mx = fmaxf(s[0][g], s[1][g]);
#pragma unroll
          for (int off = LANES_PER_POS; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
          if (lane == 0) wmax[warp * GM + g] = mx;
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float mx = wmax[g];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, wmax[w * GM + g]);
          const float mn = fmaxf(m[g], mx);
          alpha[g] = expf(m[g] - mn);
          m[g] = mn;
          const float p0 = ok0 ? expf(s[0][g] - mn) : 0.0f;
          const float p1 = ok1 ? expf(s[1][g] - mn) : 0.0f;
          if (quarter == 0) {
            ps[r0 * GM + g] = p0;
            ps[r1 * GM + g] = p1;
          }
          float sum = p0 + p1;
#pragma unroll
          for (int off = LANES_PER_POS; off < 32; off <<= 1)
            sum += __shfl_xor_sync(FULL, sum, off);
          if (lane == 0) wsum[warp * GM + g] = sum;
        } else {
          alpha[g] = 1.0f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          float sum = wsum[g];
#pragma unroll
          for (int w = 1; w < WARPS; ++w) sum += wsum[w * GM + g];
          l[g] = l[g] * alpha[g] + sum;
        }
      }

      // -- P.v: columns 2 pcol, 2 pcol + 1 over positions pset, pset + NSET, ...
      if (pv_on) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          acc[g][0] *= alpha[g];
          acc[g][1] *= alpha[g];
        }
        const int byte = 2 * pcol * ES;
        for (int r = pset; r < nv; r += NSET) {
          const float2 vv = load2(vst + stage_off(r, byte, RB, sw), static_cast<T*>(nullptr));
          const float* pr = ps + r * GM;
#pragma unroll
          for (int g4 = 0; g4 < GM; g4 += 4) {
            const float4 p4 = *reinterpret_cast<const float4*>(pr + g4);
            const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (g4 + e < G) {
                acc[g4 + e][0] = fmaf(pv[e], vv.x, acc[g4 + e][0]);
                acc[g4 + e][1] = fmaf(pv[e], vv.y, acc[g4 + e][1]);
              }
            }
          }
        }
      }
      __syncthreads();         // the stage and ps are free for the next tile
    }

    // -- the item's partials: the sets' accumulators summed, m and l
    float* red = reinterpret_cast<float*>(stages);
    const int W2 = 2 * CP;
    if (pv_on) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          red[(pset * GM + g) * W2 + 2 * pcol] = acc[g][0];
          red[(pset * GM + g) * W2 + 2 * pcol + 1] = acc[g][1];
        }
      }
    }
    __syncthreads();
    const size_t slot = (static_cast<size_t>(b) * Hkv + h) * a.NS + sp;
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float t = 0.0f;
      for (int st = 0; st < NSET; ++st) t += red[(st * GM + g) * W2 + d];
      a.part_acc[slot * G * D + i] = t;
    }
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g < G) {
          a.part_ml[(slot * G + g) * 2] = m[g];
          a.part_ml[(slot * G + g) * 2 + 1] = l[g];
        }
      }
    }
  }
}

// One CTA a (query head, row): the row's splits merged at their common max,
// divided by the sum; zeros for an idle row.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_decode_combine(const Args a) {
  const int hq = blockIdx.x, b = blockIdx.y;
  T* o = static_cast<T*>(a.out) + (static_cast<size_t>(b) * a.H + hq) * a.D;
  const int n = row_len(a, b);
  if (n == 0) {
    for (int d = threadIdx.x; d < a.D; d += COMBINE_THREADS) o[d] = from_f32<T>(0.0f);
    return;
  }
  const int ns = (n + a.split_len - 1) / a.split_len;
  const int g = hq % a.G;
  const size_t base = (static_cast<size_t>(b) * a.Hkv + hq / a.G) * a.NS;
  float mx = -INFINITY;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, a.part_ml[((base + s) * a.G + g) * 2]);
  float sum = 0.0f;
  for (int s = 0; s < ns; ++s) {
    const float* ml = a.part_ml + ((base + s) * a.G + g) * 2;
    sum += ml[1] * expf(ml[0] - mx);
  }
  for (int d = threadIdx.x; d < a.D; d += COMBINE_THREADS) {
    float t = 0.0f;
    for (int s = 0; s < ns; ++s) {
      const float w = expf(a.part_ml[((base + s) * a.G + g) * 2] - mx);
      t = fmaf(a.part_acc[((base + s) * a.G + g) * a.D + d], w, t);
    }
    o[d] = from_f32<T>(t / sum);
  }
}

// The current device, as an index below MAX_DEVICES; negative: a CUDA error.
constexpr int MAX_DEVICES = 64;
int current_device() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < 0 || dev >= MAX_DEVICES) return -static_cast<int>(cudaErrorInvalidDevice);
  return dev;
}

template <typename T, int GM>
int ctas_per_sm(int dev, size_t smem) {
  // kept per device, whose context holds the raised limit; the last answer
  // is kept too: a serving path asks at one shape every call
  static bool raised[MAX_DEVICES] = {};
  static size_t last_smem[MAX_DEVICES] = {};
  static int last[MAX_DEVICES] = {};
  if (!raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split<T, GM>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return -static_cast<int>(err);
    raised[dev] = true;
  }
  if (smem == last_smem[dev] && last[dev] > 0) return last[dev];
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, paged_decode_split<T, GM>, THREADS, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  last_smem[dev] = smem;
  last[dev] = n;
  return n;
}

template <typename T, int GM>
int launch(const Args& a, cudaStream_t stream) {
  const int dev = current_device();
  if (dev < 0) return -dev;
  const size_t smem = smem_bytes<GM>(a.D, sizeof(T), a.B, a.split_pages);
  const int per_sm = ctas_per_sm<T, GM>(dev, smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  static int sms[MAX_DEVICES] = {};
  if (sms[dev] == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long most = static_cast<long long>(a.B) * a.Hkv * a.NS;
  const long long grid = std::min<long long>(static_cast<long long>(sms[dev]) * per_sm, most);
  paged_decode_split<T, GM><<<static_cast<int>(grid), THREADS, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_combine<T><<<dim3(a.H, a.B), COMBINE_THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int group_bucket(int g) { return g <= 4 ? 4 : 16; }

}  // namespace

extern "C" {

// o = attention of q (B, H, D) over each row's positions 0 .. pos[b] of the
// pools k, v (num_pages, page_len, Hkv, D), read through table (B, P) int64;
// pos is (B,) int64; o is (B, H, D) of q's type. part is the wrapper's f32
// scratch of B * Hkv * ns * G * (D + 2) values, ns = ceil(P * page_len /
// split_len). dtype: 0 float32, 1 bfloat16; vec: 1 when D * itemsize is a
// multiple of 16 and both pools are 16-byte aligned. Returns
// cudaGetLastError() after the launches (0 on success); asynchronous on
// `stream`.
int repro_paged_decode(const void* q, const void* k, const void* v, const void* table,
                       const void* pos, void* out, void* part, int B, int H, int Hkv, int D,
                       int P, int page_len, int split_len, int dtype, float scale, int vec,
                       void* stream) {
  if (B < 0 || H <= 0 || Hkv <= 0 || H % Hkv || H / Hkv > 16 || D <= 0 || D > MAX_D ||
      P <= 0 || page_len <= 0 || split_len <= 0 || split_len % page_len || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  Args a;
  a.q = q; a.k = k; a.v = v;
  a.table = static_cast<const long long*>(table);
  a.pos = static_cast<const long long*>(pos);
  a.out = out;
  a.B = B; a.H = H; a.Hkv = Hkv; a.G = H / Hkv; a.D = D; a.P = P;
  a.page_len = page_len;
  a.pl_shift = (page_len & (page_len - 1)) == 0 ? __builtin_ctz(page_len) : -1;
  a.split_len = split_len;
  a.split_pages = split_len / page_len;
  a.NS = static_cast<int>((static_cast<long long>(P) * page_len + split_len - 1) / split_len);
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc + static_cast<size_t>(B) * Hkv * a.NS * a.G * D;
  a.scale = scale;
  a.vec = vec;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gm = group_bucket(a.G);
  if (dtype == 0) return gm == 4 ? launch<float, 4>(a, s) : launch<float, 16>(a, s);
  return gm == 4 ? launch<__nv_bfloat16, 4>(a, s) : launch<__nv_bfloat16, 16>(a, s);
}

// The split kernel's dynamic shared memory and CTAs an SM (chip_smoke.py
// reports them beside the kernel's times); negative: a CUDA error.
long long repro_paged_decode_smem_bytes(int dtype, int G, int D, int B, int split_pages) {
  const int es = dtype == 0 ? 4 : 2;
  return group_bucket(G) == 4 ? static_cast<long long>(smem_bytes<4>(D, es, B, split_pages))
                              : static_cast<long long>(smem_bytes<16>(D, es, B, split_pages));
}

int repro_paged_decode_ctas_per_sm(int dtype, int G, int D, int B, int split_pages) {
  const int dev = current_device();
  if (dev < 0) return dev;
  const size_t smem =
      static_cast<size_t>(repro_paged_decode_smem_bytes(dtype, G, D, B, split_pages));
  const bool four = group_bucket(G) == 4;
  if (dtype == 0)
    return four ? ctas_per_sm<float, 4>(dev, smem) : ctas_per_sm<float, 16>(dev, smem);
  return four ? ctas_per_sm<__nv_bfloat16, 4>(dev, smem)
              : ctas_per_sm<__nv_bfloat16, 16>(dev, smem);
}

}  // extern "C"
