// Attn-PIM flash-decode GQA attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// TPU kernel, body `_kernel`).  Computes, per request b and KV head h,
// softmax(q k^T / sqrt(hd)) v over the first lens[b] cached positions of a
// dense slab, for R = t*g query rows laid out (window, group)-row-major:
// row r = w*g + gg sits at absolute position lens - t + w and sees KV
// position j iff j < lens - (t - 1) + w (intra-window causal; t = 1 is the
// plain ragged mask).
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
//  * K/V tiles arrive as 16-byte vector loads, all issued before use;
//  * the KV loop stops at cdiv(lens[b], AT_BK): tiles past a request's
//    length are never read (the block skip of the TPU kernel);
//  * the online-softmax recurrence of the TPU kernel, in f32, with the same
//    NEG_INF = -1e30 masking: m starts at NEG_INF, a masked score
//    contributes exp(NEG_INF - m) = 0, the output is acc / max(l, 1e-30),
//    so lens == 0 returns zeros;
//  * p is rounded to the cache dtype before the p @ v product, as the TPU
//    kernel does, and the output is written in q's dtype.
// Simple on purpose: no split-S, wgmma or TMA yet.
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

// q/out: [b, nkv, R, HD]; k/v: [b, S, nkv, HD]; lens: [b]
template <typename T, int HD>
__global__ void __launch_bounds__(AT_THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lens,
                        T* __restrict__ out, int nkv, int R, int S,
                        int q_rows, float scale) {
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
  const int kv_end = min(max(len, 0), S);
  const int nkb = (kv_end + AT_BK - 1) / AT_BK;   // block skip
  const size_t kv_row = (size_t)nkv * HD;          // stride between positions
  const T* kb_ptr = k + (size_t)bi * S * kv_row + (size_t)h * HD;
  const T* vb_ptr = v + (size_t)bi * S * kv_row + (size_t)h * HD;
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
      // the tile's K and V rows as 16-byte vectors, all loads issued
      // before any is used (memory-level parallelism), zero past the end
      uint4 kreg[PER], vreg[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * AT_THREADS;
        const int j = idx / VPR, c = idx - j * VPR;
        kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
        if (j0 + j < kv_end) {
          const size_t o = (size_t)(j0 + j) * kv_row + c * VEC;
          kreg[i] = *reinterpret_cast<const uint4*>(kb_ptr + o);
          vreg[i] = *reinterpret_cast<const uint4*>(vb_ptr + o);
        }
      }
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int idx = tid + i * AT_THREADS;
        const int j = idx / VPR, c = idx - j * VPR;
        const T* ke = reinterpret_cast<const T*>(&kreg[i]);
        const T* ve = reinterpret_cast<const T*>(&vreg[i]);
#pragma unroll
        for (int u = 0; u < VEC; ++u) {
          ks[j][c * VEC + u] = to_f32(ke[u]);
          vs[j][c * VEC + u] = to_f32(ve[u]);
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

template <typename T, int HD>
static int launch(const void* q, const void* k, const void* v, const int* lens,
                  void* out, int b, int nkv, int R, int S, int q_rows,
                  cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)HD);
  const int row_tiles = (R + AT_RT - 1) / AT_RT;
  dim3 grid(b * nkv, row_tiles < 65535 ? row_tiles : 65535);
  decode_attention_kernel<T, HD><<<grid, AT_THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lens, (T*)out, nkv, R, S, q_rows,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch_hd(const void* q, const void* k, const void* v,
                       const int* lens, void* out, int b, int nkv, int R,
                       int hd, int S, int q_rows, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, lens, out, b, nkv, R, S, q_rows, s);
    case 64: return launch<T, 64>(q, k, v, lens, out, b, nkv, R, S, q_rows, s);
    case 128: return launch<T, 128>(q, k, v, lens, out, b, nkv, R, S, q_rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lens,
                                       void* out, int b, int nkv, int R, int hd,
                                       int S, int q_rows, int dtype,
                                       void* stream) {
  if (b < 1 || nkv < 1 || R < 1 || S < 1 || q_rows < 1 || R % q_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* l = (const int*)lens;
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, l, out, b, nkv, R, hd, S, q_rows, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, l, out, b, nkv, R, hd, S,
                                      q_rows, s);
  return (int)cudaErrorInvalidValue;
}
