// Attn-PIM flash-decode GQA attention for Hopper (sm_90a): the body shared
// by the dense kernel (decode_attention.cu) and the paged one
// (paged_decode_attention.cu).
//
// Computes, per request b and KV head h, softmax(q k^T / sqrt(hd)) v over
// the first lens[b] LOGICAL KV positions, for R = t*g query rows laid out
// (window, group)-row-major: row r = w*g + gg sits at absolute position
// lens - t + w and sees KV position j iff j < lens - (t - 1) + w
// (intra-window causal; t = 1 is the plain ragged mask).
//
// Where position j's K/V row lives is the only difference between the two
// layouts, so the body is templated on a KV row addressing policy, which
// names the row (of nkv * HD elements) that holds position j of request b:
//   DenseKV:  b * S + j                                         (a slab)
//   PagedKV:  tables[b, j / page] * page + j % page
// Both walk logical positions in the same AT_BK-wide tiles (a tile may span
// two pages), so on identical contents the paged kernel does exactly the
// dense kernel's arithmetic and its output is bit-equal for any page size.
//
// Bound on this card: the BYTES of K and V streamed from HBM (2 * lens *
// hd * itemsize per (b, h)); ~2*R FLOPs per KV element is far below the
// ridge, so decode attention is memory-bound at any batch.
//
// Design against that bound:
//  * one block per (b, kv_head) and tile of AT_RT query rows: a t = 1
//    decode (g = 7 rows) is one row tile, so each KV byte is read once;
//    a chunk wave's t*g rows (448 at t = 64) spread over gridDim.y, and a
//    block loops over further row tiles past the grid's limit;
//  * K/V tiles arrive as 16-byte vector loads;
//  * the KV loop stops at cdiv(min(lens[b], capacity), AT_BK): positions
//    past a request's length are never read (the block skip of the TPU
//    kernels; for the paged layout, table entries past the length are never
//    read either);
//  * the online-softmax recurrence of the TPU kernel, in f32, with the same
//    NEG_INF = -1e30 masking: m starts at NEG_INF, a masked score
//    contributes exp(NEG_INF - m) = 0, the output is acc / max(l, 1e-30),
//    so lens == 0 returns zeros;
//  * p is rounded to the cache dtype before the p @ v product, as the TPU
//    kernel does, and the output is written in q's dtype.
// Simple on purpose: no split-S, wgmma or TMA yet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AT_RT 16        // query rows per tile
#define AT_BK 32        // KV positions per tile (= warp width)
#define AT_THREADS 128  // 4 warps
#define AT_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// p rounded to the value dtype (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// A policy gives the positions a request can hold (capacity), the first
// row of request b's storage (base_row) and the row of its position j
// counted from there (row).
//
// K/V [b, S, nkv, HD]: position j of request b is row b * S + j.
struct DenseKV {
  int S;
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ size_t base_row(int b) const {
    return (size_t)b * S;
  }
  __device__ __forceinline__ size_t row(int, int j) const { return (size_t)j; }
};

// K/V pages [num_pages, page_size, nkv, HD] with tables [b, max_blocks]:
// position j of request b is row j % page_size of page tables[b, j / page].
struct PagedKV {
  const int* tables;
  int page_size, max_blocks;
  __device__ __forceinline__ int capacity() const {
    return max_blocks * page_size;
  }
  __device__ __forceinline__ size_t base_row(int) const { return 0; }
  __device__ __forceinline__ size_t row(int b, int j) const {
    const int blk = j / page_size;
    const size_t page = (size_t)tables[(size_t)b * max_blocks + blk];
    return page * page_size + (j - blk * page_size);
  }
};

// One block: request bi = blockIdx.x / nkv, KV head h, row tiles from
// blockIdx.y.  q/out: [b, nkv, R, HD]; lens: [b].
template <typename T, int HD, typename KV>
__device__ __forceinline__ void decode_attention_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lens, T* __restrict__ out, int nkv, int R,
    int q_rows, float scale, const KV& kv) {
  constexpr int GROUPS = AT_THREADS / HD;     // row groups in the PV mapping
  constexpr int ROWS_PER = AT_RT / GROUPS;    // rows a thread accumulates
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load
  constexpr int VPR = HD / VEC;               // vectors per KV row
  constexpr int PER = AT_BK * VPR / AT_THREADS;  // vectors per thread
  static_assert(AT_BK * VPR % AT_THREADS == 0, "tile must split evenly");
  __shared__ float qs[AT_RT][HD + 1];
  __shared__ float ks[AT_BK][HD + 1];
  __shared__ float vs[AT_BK][HD + 1];
  __shared__ float ps[AT_RT][AT_BK + 1];
  __shared__ float m_s[AT_RT], l_s[AT_RT], a_s[AT_RT];

  const int bh = blockIdx.x;
  const int bi = bh / nkv, h = bh - bi * nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lens[bi];
  const int g = R / q_rows;
  const int kv_end = min(max(len, 0), kv.capacity());
  const int nkb = (kv_end + AT_BK - 1) / AT_BK;   // block skip
  const size_t kv_row = (size_t)nkv * HD;          // stride between rows
  const T* kb_ptr = k + kv.base_row(bi) * kv_row + (size_t)h * HD;
  const T* vb_ptr = v + kv.base_row(bi) * kv_row + (size_t)h * HD;
  const T* qb = q + (size_t)bh * R * HD;
  T* ob = out + (size_t)bh * R * HD;
  const int d = tid % HD, rg = tid / HD;

  for (int r0 = blockIdx.y * AT_RT; r0 < R; r0 += gridDim.y * AT_RT) {
    for (int i = tid; i < AT_RT * HD; i += AT_THREADS) {
      const int r = i / HD, dd = i - r * HD;
      qs[r][dd] = (r0 + r < R) ? to_f32(qb[(size_t)(r0 + r) * HD + dd]) : 0.f;
    }
    if (tid < AT_RT) {
      m_s[tid] = AT_NEG_INF;
      l_s[tid] = 0.f;
    }
    float acc[ROWS_PER];
#pragma unroll
    for (int i = 0; i < ROWS_PER; ++i) acc[i] = 0.f;
    __syncthreads();

    for (int kb = 0; kb < nkb; ++kb) {
      const int j0 = kb * AT_BK;
      // the tile's K and V rows as 16-byte vectors, loaded before any is
      // used (memory-level parallelism).  The loads are unconditional: a
      // row past kv_end reloads the last live row (for the paged layout,
      // through a table entry the request owns) and is zeroed when stored.
      // Predicated loads let ptxas issue the second row's loads after the
      // first row's stores, which cost 16% at t = 1 on an H100.
      uint4 kreg[PER], vreg[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * AT_THREADS;
        const int j = idx / VPR, c = idx - j * VPR;
        const size_t o = kv.row(bi, min(j0 + j, kv_end - 1)) * kv_row + c * VEC;
        kreg[i] = *reinterpret_cast<const uint4*>(kb_ptr + o);
        vreg[i] = *reinterpret_cast<const uint4*>(vb_ptr + o);
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * AT_THREADS;
        const int j = idx / VPR, c = idx - j * VPR;
        const bool live = j0 + j < kv_end;
        const T* ke = reinterpret_cast<const T*>(&kreg[i]);
        const T* ve = reinterpret_cast<const T*>(&vreg[i]);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          ks[j][c * VEC + u] = live ? to_f32(ke[u]) : 0.f;
          vs[j][c * VEC + u] = live ? to_f32(ve[u]) : 0.f;
        }
      }
      __syncthreads();

      // scores, masked: row r sees j iff j < len - (t-1) + (r0+r)/g
      for (int i = tid; i < AT_RT * AT_BK; i += AT_THREADS) {
        const int r = i / AT_BK, j = i - r * AT_BK;
        float s = 0.f;
#pragma unroll 16
        for (int dd = 0; dd < HD; ++dd) s = fmaf(qs[r][dd], ks[j][dd], s);
        s *= scale;
        const int limit = len - (q_rows - 1) + (r0 + r) / g;
        ps[r][j] = (j0 + j < limit) ? s : AT_NEG_INF;
      }
      __syncthreads();

      // online softmax: warp w owns rows w, w+4, ...; lane = KV position
      for (int r = warp; r < AT_RT; r += AT_THREADS / 32) {
        const float s = ps[r][lane];
        float mx = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float p = expf(s - m_new);
        float sum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        ps[r][lane] = round_to<T>(p);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + p @ v; thread owns column d of rows rg + i*GROUPS
#pragma unroll
      for (int i = 0; i < ROWS_PER; ++i) {
        const int r = rg + i * GROUPS;
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < AT_BK; ++j) pv = fmaf(ps[r][j], vs[j][d], pv);
        acc[i] = acc[i] * a_s[r] + pv;
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < ROWS_PER; ++i) {
      const int r = rg + i * GROUPS;
      if (r0 + r < R)
        ob[(size_t)(r0 + r) * HD + d] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
    __syncthreads();
  }
}

template <typename T, int HD, typename KV>
__global__ void __launch_bounds__(AT_THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lens,
                    T* __restrict__ out, int nkv, int R, int q_rows,
                    float scale, KV kv) {
  decode_attention_body<T, HD>(q, k, v, lens, out, nkv, R, q_rows, scale, kv);
}

template <typename T, int HD, typename KV>
static int launch_hd(const void* q, const void* k, const void* v,
                     const int* lens, void* out, int b, int nkv, int R,
                     int q_rows, KV kv, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  const int row_tiles = (R + AT_RT - 1) / AT_RT;
  dim3 grid(b * nkv, row_tiles < 65535 ? row_tiles : 65535);
  flash_decode_kernel<T, HD, KV><<<grid, AT_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lens, (T*)out, nkv, R, q_rows,
      scale, kv);
  return (int)cudaGetLastError();
}

// Launch over either layout.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() of the launch.
template <typename KV>
static int launch_flash_decode(const void* q, const void* k, const void* v,
                               const void* lens, void* out, int b, int nkv,
                               int R, int hd, int q_rows, int dtype, KV kv,
                               void* stream) {
  if (b < 1 || nkv < 1 || R < 1 || q_rows < 1 || R % q_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* l = (const int*)lens;
#define AT_CASE(T, HD) \
  case HD: return launch_hd<T, HD>(q, k, v, l, out, b, nkv, R, q_rows, kv, s)
  if (dtype == 0) {
    switch (hd) {
      AT_CASE(float, 32);
      AT_CASE(float, 64);
      AT_CASE(float, 128);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (hd) {
      AT_CASE(__nv_bfloat16, 32);
      AT_CASE(__nv_bfloat16, 64);
      AT_CASE(__nv_bfloat16, 128);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef AT_CASE
  return (int)cudaErrorInvalidValue;
}
