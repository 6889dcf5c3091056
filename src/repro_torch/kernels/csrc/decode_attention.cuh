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
// two pages) and split them at the same tiles, so on identical contents the
// paged kernel does exactly the dense kernel's arithmetic and its output is
// bit-equal for any page size.
//
// Bound on this card: the BYTES of K and V streamed from HBM (2 * lens *
// hd * itemsize per (b, h)); ~2*R FLOPs per KV element is far below the
// ridge, so decode attention is memory-bound at any batch.  At the decode
// shapes those bytes are a few MB, so what a call really costs is the
// latency of its longest serial chain of tiles.
//
// Design against that (split-S, i.e. flash-decoding):
//  * the grid is (b * nkv, row tiles, NS).  Split s of request b takes the
//    contiguous tiles [s * nkb / NS, (s + 1) * nkb / NS) of its
//    nkb = cdiv(min(lens[b], capacity), AT_BK) tiles, computed on the
//    device, so a 2048-token request is NS short chains on NS SMs.  NS
//    comes from the host as a function of the shapes alone (the wrapper's
//    `num_splits`), never of lens or of the KV capacity;
//  * each split writes f32 partials (running max m, sum l and the
//    unnormalised acc[rows, hd]) to scratch the wrapper allocates; a second
//    kernel (attn_merge_kernel) merges them per (request, head, row) in
//    split order: M = max m_s, out = sum acc_s e^(m_s - M) /
//    max(sum l_s e^(m_s - M), 1e-30).  No atomics: the output is
//    deterministic.  With NS = 1 the split pass writes the output itself
//    and the merge is not launched;
//  * bf16 runs on tensor cores (attn_split_mma_kernel): q k^T and p @ v as
//    mma.sync m16n8k16 / m16n8k8 with f32 accumulation, 16 query rows per
//    block (the mma's M) and KV positions spread over the 4 warps, whose
//    softmax states are merged at the end of the split.  bf16 products are
//    exact in f32 and p is rounded to bf16 before p @ v, so the result
//    differs from CUDA-core arithmetic only in summation order;
//  * f32 stays on CUDA cores (attn_split_kernel; no TF32, which would not
//    hold 1e-4), with a row tile of RT = 4 * RPW rows (RPW in {1, 2, 4})
//    fitted to R: a t = 1 decode at g = 7 takes RT = 8, g = 1 takes RT = 4.
//    Warp w owns rows w*RPW .. +RPW: lane = KV position for the scores, so
//    the online softmax runs in registers with warp shuffles; for p @ v the
//    lane owns hd/32 columns;
//  * a chunk wave's t*g rows (448 at t = 64) spread over gridDim.y in row
//    tiles (a block loops over further row tiles past the grid's limit);
//  * K/V tiles stay in the cache dtype in a two-stage shared-memory ring,
//    filled with 16-byte cp.async copies: tile k+1 is in flight while tile
//    k is scored, one __syncthreads per tile.  Rows past the length are
//    zero-filled, not read, and their address is clamped to a live row: for
//    the paged layout a table entry past a request's length is never read.
//    The table entries of tile k+2 are loaded while tile k is computed;
//  * the online-softmax recurrence of the TPU kernel, in f32, with the same
//    NEG_INF = -1e30 masking; a masked position's p is exactly 0 (it is
//    e^(NEG_INF - m) = 0 in the reference once any position is live), so a
//    split or row that sees no live position carries l = 0 and acc = 0,
//    and lens == 0 returns zeros;
//  * p is rounded to the cache dtype before the p @ v product, as the TPU
//    kernel does, and the output is written in q's dtype.
// Not done yet: wgmma, TMA for the K/V tiles (a page is a natural TMA box),
// deeper rings, a persistent grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define AT_BK 32        // KV positions per tile (= warp width)
#define AT_WARPS 4
#define AT_THREADS 128  // 4 warps
#define AT_NEG_INF (-1e30f)
#define AT_MAX_SPLITS 32  // splits one merge warp holds, one per lane

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// N consecutive floats (N in {1, 2, 4}, aligned to 4N bytes) in one load.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

// 16-byte global -> shared copy that bypasses L1; src_bytes = 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// A policy gives the positions a request can hold (capacity), the first
// row of request b's storage (base_row), and the row of its position j
// counted from there in two steps: entry(b, j) is the value that has to
// come from memory (the table entry; issued a tile early), row(j, e) the
// row it names.
//
// K/V [b, S, nkv, HD]: position j of request b is row b * S + j.
struct DenseKV {
  int S;
  __host__ __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ size_t base_row(int b) const {
    return (size_t)b * S;
  }
  __device__ __forceinline__ int entry(int, int) const { return 0; }
  __device__ __forceinline__ size_t row(int j, int) const { return (size_t)j; }
};

// K/V pages [num_pages, page_size, nkv, HD] with tables [b, max_blocks]:
// position j of request b is row j % page_size of page tables[b, j / page].
struct PagedKV {
  const int* tables;
  int page_size, max_blocks;
  __host__ __device__ __forceinline__ int capacity() const {
    return max_blocks * page_size;
  }
  __device__ __forceinline__ size_t base_row(int) const { return 0; }
  __device__ __forceinline__ int entry(int b, int j) const {
    return tables[(size_t)b * max_blocks + j / page_size];
  }
  __device__ __forceinline__ size_t row(int j, int page) const {
    return (size_t)page * page_size + (j % page_size);
  }
};

// The K/V tiles of one block's split, and how they reach shared memory.
// Split s of request bi holds tiles [kb_lo, kb_hi).  The ring holds two
// stages of K then two of V, in the cache dtype, rows padded by 16 bytes so
// that 8 consecutive rows start in distinct banks.  Chunk i of a thread in
// a tile is row j = idx / VPR, 16-byte column c.  A row past kv_end is
// clamped to the last live row (so its table entry is one the request
// owns) and zero-filled without being read.
template <typename T, int HD, typename KV>
struct SplitTiles {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements per 16 bytes
  static constexpr int ROW = HD + VEC;              // padded row, elements
  static constexpr int STAGE = AT_BK * ROW;         // elements
  static constexpr int VPR = HD / VEC;              // chunks per row
  static constexpr int PER = AT_BK * VPR / AT_THREADS;  // chunks per thread
  static constexpr size_t ring_bytes = 2 * 2 * STAGE * sizeof(T);
  static_assert(AT_BK * VPR % AT_THREADS == 0, "tile must split evenly");

  KV kv;
  const T* kp;
  const T* vp;
  size_t kv_row;                                    // stride between rows
  int bi, len, kv_end, kb_lo, kb_hi;
  int ent[PER];                                     // entries of the next tile

  __device__ __forceinline__ SplitTiles(const T* k, const T* v,
                                        const int* lens, int nkv, int ns,
                                        const KV& kv_)
      : kv(kv_), kv_row((size_t)nkv * HD) {
    bi = blockIdx.x / nkv;
    const int h = blockIdx.x - bi * nkv;
    len = lens[bi];
    kv_end = min(max(len, 0), kv.capacity());
    const int nkb = (kv_end + AT_BK - 1) / AT_BK;   // block skip
    kb_lo = (int)((long long)blockIdx.z * nkb / ns);
    kb_hi = (int)((long long)(blockIdx.z + 1) * nkb / ns);
    kp = k + kv.base_row(bi) * kv_row + (size_t)h * HD;
    vp = v + kv.base_row(bi) * kv_row + (size_t)h * HD;
  }
  __device__ __forceinline__ void fetch(int kb) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = (threadIdx.x + i * AT_THREADS) / VPR;
      ent[i] = kv.entry(bi, min(kb * AT_BK + j, kv_end - 1));
    }
  }
  __device__ __forceinline__ void issue(T* ring, int kb, int stage) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = threadIdx.x + i * AT_THREADS;
      const int j = idx / VPR, c = idx - j * VPR;
      const int jj = kb * AT_BK + j;
      const size_t o = kv.row(min(jj, kv_end - 1), ent[i]) * kv_row + c * VEC;
      const int bytes = jj < kv_end ? 16 : 0;
      T* dst = ring + stage * STAGE + j * ROW + c * VEC;
      cp_async16(dst, kp + o, bytes);
      cp_async16(dst + 2 * STAGE, vp + o, bytes);
    }
    cp_async_commit();
  }
  // before the split's tile loop: tile kb_lo in flight, kb_lo + 1's entries
  __device__ __forceinline__ void start(T* ring) {
    if (kb_lo < kb_hi) {
      fetch(kb_lo);
      issue(ring, kb_lo, 0);
      if (kb_lo + 1 < kb_hi) fetch(kb_lo + 1);
    }
  }
  // at the top of tile kb: wait for it, then put kb + 1 in flight into the
  // stage that tile kb - 1 used; returns kb's stage
  __device__ __forceinline__ int arrive(T* ring, int kb) {
    const int st = (kb - kb_lo) & 1;
    cp_async_wait_all();
    __syncthreads();    // tile kb visible to all; tile kb-1 done by all
    if (kb + 1 < kb_hi) {
      issue(ring, kb + 1, st ^ 1);
      if (kb + 2 < kb_hi) fetch(kb + 2);
    }
    return st;
  }
};

// Where a split's result goes: with ns == 1 the normalised output row, else
// the partials (acc [b*nkv, ns, R, HD], then m and l [b*nkv, ns, R], f32).
template <typename T, int HD>
struct SplitOut {
  T* out;
  float* part;
  int R, ns;
  __device__ __forceinline__ size_t prow(int r) const {
    return ((size_t)blockIdx.x * ns + blockIdx.z) * R + r;
  }
  // columns [c, c + N) of row r, acc unnormalised
  template <int N>
  __device__ __forceinline__ void cols(int r, int c, const float* acc,
                                       float l) const {
    if (ns == 1) {
      T* o = out + ((size_t)blockIdx.x * R + r) * HD + c;
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = from_f32<T>(acc[e] / fmaxf(l, 1e-30f));
    } else {
      float* pa = part + prow(r) * HD + c;
#pragma unroll
      for (int e = 0; e < N; ++e) pa[e] = acc[e];
    }
  }
  __device__ __forceinline__ void stats(int r, float m, float l) const {
    if (ns > 1) {
      const size_t P = (size_t)gridDim.x * ns * R;   // partial rows
      part[P * HD + prow(r)] = m;
      part[P * HD + P + prow(r)] = l;
    }
  }
};

extern __shared__ __align__(16) unsigned char at_smem[];

// First pass on CUDA cores (f32).  Block (bh, y, s): request bh / nkv, KV
// head bh % nkv, row tiles of RT = 4 * RPW rows from blockIdx.y, split s.
// q/out: [b, nkv, R, HD]; lens: [b].  Warp w owns rows w*RPW .. +RPW: the
// lane is the KV position for the scores (online softmax in registers,
// with warp shuffles) and owns HD/32 columns for p @ v.  Shared memory:
// the ring, the row tile's q [RT][HD] and each warp's p [RT][AT_BK], f32.
template <int HD, int RPW>
struct ScalarSmem {
  static constexpr size_t bytes = SplitTiles<float, HD, DenseKV>::ring_bytes +
                                  (size_t)AT_WARPS * RPW * (HD + AT_BK) * 4;
};

template <int HD, int RPW, typename KV>
__global__ void __launch_bounds__(AT_THREADS)
attn_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ lens,
                  float* __restrict__ out, float* __restrict__ part, int nkv,
                  int R, int q_rows, int ns, float scale, KV kv) {
  using T = float;
  using Tiles = SplitTiles<T, HD, KV>;
  constexpr int RT = AT_WARPS * RPW, ROW = Tiles::ROW, VEC = Tiles::VEC;
  constexpr int DPL = HD / 32;                   // columns per lane in p @ v
  static_assert(HD % 32 == 0, "a lane owns HD / 32 columns");
  Tiles tl(k, v, lens, nkv, ns, kv);
  if (ns > 1 && tl.kb_lo == tl.kb_hi) return;    // the merge skips it too
  const SplitOut<T, HD> so{out, part, R, ns};
  T* ring = reinterpret_cast<T*>(at_smem);
  float* qs = reinterpret_cast<float*>(at_smem + Tiles::ring_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* pw = qs + RT * HD + warp * RPW * AT_BK;  // this warp's rows of p
  const int g = R / q_rows;
  const T* qb = q + (size_t)blockIdx.x * R * HD;

  for (int r0 = blockIdx.y * RT; r0 < R; r0 += gridDim.y * RT) {
    tl.start(ring);
    for (int i = tid; i < RT * HD; i += AT_THREADS) {
      const int r = i / HD;
      qs[i] = (r0 + r < R) ? qb[(size_t)r0 * HD + i] : 0.f;
    }
    float m[RPW], l[RPW], acc[RPW][DPL];
    int limit[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = AT_NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
      // row r sees j iff j < len - (t-1) + r/g, and only positions stored
      limit[i] = min(tl.len - (q_rows - 1) + (r0 + warp * RPW + i) / g,
                     tl.kv_end);
    }

    for (int kb = tl.kb_lo; kb < tl.kb_hi; ++kb) {
      const int st = tl.arrive(ring, kb);
      const T* kt = ring + st * Tiles::STAGE;
      const T* vt = kt + 2 * Tiles::STAGE;

      // scores: lane = KV position, the warp's RPW rows
      float s[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) s[i] = 0.f;
#pragma unroll
      for (int c = 0; c < HD / VEC; ++c) {
        float kf[VEC];
        load_vec<VEC>(kt + lane * ROW + c * VEC, kf);
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float4* qv = reinterpret_cast<const float4*>(
              qs + (warp * RPW + i) * HD + c * VEC);
#pragma unroll
          for (int u = 0; u < VEC / 4; ++u) {
            const float4 qq = qv[u];
            s[i] = fmaf(qq.x, kf[4 * u], s[i]);
            s[i] = fmaf(qq.y, kf[4 * u + 1], s[i]);
            s[i] = fmaf(qq.z, kf[4 * u + 2], s[i]);
            s[i] = fmaf(qq.w, kf[4 * u + 3], s[i]);
          }
        }
      }

      // online softmax in registers (m, l replicated over the warp's lanes)
      const int j = kb * AT_BK + lane;
      float alpha[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const bool live = j < limit[i];
        const float sv = live ? s[i] * scale : AT_NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sv));
        const float p = live ? expf(sv - m_new) : 0.f;
        alpha[i] = expf(m[i] - m_new);
        l[i] = l[i] * alpha[i] + warp_sum(p);
        m[i] = m_new;
        pw[i * AT_BK + lane] = p;
      }
      __syncwarp();

      // acc = acc * alpha + p @ v; lane owns columns lane*DPL .. +DPL
      float pv[RPW][DPL];
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int e = 0; e < DPL; ++e) pv[i][e] = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < AT_BK; j4 += 4) {
        float4 p4[RPW];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          p4[i] = *reinterpret_cast<const float4*>(pw + i * AT_BK + j4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float vf[DPL];
          load_vec<DPL>(vt + (j4 + u) * ROW + lane * DPL, vf);
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const float pj = u == 0 ? p4[i].x : u == 1 ? p4[i].y
                             : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
            for (int e = 0; e < DPL; ++e) pv[i][e] = fmaf(pj, vf[e], pv[i][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = acc[i][e] * alpha[i] + pv[i][e];
    }

#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + warp * RPW + i;
      if (r >= R) continue;
      so.template cols<DPL>(r, lane * DPL, acc[i], l[i]);
      if (lane == 0) so.stats(r, m[i], l[i]);
    }
    __syncthreads();      // q and the ring are refilled for the next row tile
  }
}

// bf16 tensor-core operations (sm_80+ mma.sync; f32 accumulate).
__device__ __forceinline__ void mma_m16n8k16(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_m16n8k8(float* c, const uint32_t* a,
                                            uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
// four 8x8 b16 matrices, transposed: lane i names row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ uint32_t ld_b32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// two f32 rounded to bf16, the first in the low half (an mma operand pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// First pass on tensor cores (bf16).  Block (bh, y, s) as above, with row
// tiles of 16 (the mma's M; rows past R are zeros).  Warp w takes KV
// positions [8w, 8w + 8) of every tile: s = q k^T is HD/16 m16n8k16 mmas
// (q's fragments stay in registers), the online softmax of the 8 scores a
// thread quad holds per row runs with quad shuffles, and the scores' f32
// fragment, rounded to bf16, is the A fragment of p @ v (HD/8 m16n8k8
// mmas, V's fragments by ldmatrix.trans).  Each warp keeps its own (m, l,
// acc) over the split; at its end the four are merged in warp order through
// shared memory laid over the ring.  Products of bf16 are exact in f32, so
// this differs from the CUDA-core arithmetic only in summation order.
template <int HD>
struct MmaSmem {
  static constexpr int RS = HD + 8;     // f32 row stride of the warp merge
  static constexpr size_t ring =
      SplitTiles<__nv_bfloat16, HD, DenseKV>::ring_bytes;
  static_assert((size_t)AT_WARPS * 16 * RS * 4 <= ring, "merge over ring");
  static constexpr size_t bytes = ring + AT_WARPS * 2 * 16 * 4;
};

template <int HD, typename KV>
__global__ void __launch_bounds__(AT_THREADS)
attn_split_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ lens,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, int nkv, int R, int q_rows,
                      int ns, float scale, KV kv) {
  using T = __nv_bfloat16;
  using Tiles = SplitTiles<T, HD, KV>;
  constexpr int ROW = Tiles::ROW, KS = HD / 16, NB = HD / 8;
  constexpr int RS = MmaSmem<HD>::RS;
  static_assert(NB % 4 == 0, "ldmatrix takes 4 column blocks");
  Tiles tl(k, v, lens, nkv, ns, kv);
  if (ns > 1 && tl.kb_lo == tl.kb_hi) return;    // the merge skips it too
  const SplitOut<T, HD> so{out, part, R, ns};
  T* ring = reinterpret_cast<T*>(at_smem);
  float* red = reinterpret_cast<float*>(at_smem);  // [4][16][RS], after
  float* ml = reinterpret_cast<float*>(at_smem + MmaSmem<HD>::ring);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;       // mma group, thread in group
  const int g = R / q_rows;
  const T* qb = q + (size_t)blockIdx.x * R * HD;

  for (int r0 = blockIdx.y * 16; r0 < R; r0 += gridDim.y * 16) {
    // q's A fragments: rows r0 + gq (regs 0, 2) and r0 + gq + 8 (1, 3),
    // loaded while the first tile's table entries are fetched
    uint32_t qa[KS][4];
    const bool lo_in = r0 + gq < R, hi_in = r0 + gq + 8 < R;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const T* q0 = qb + (size_t)(r0 + gq) * HD + kk * 16 + tq * 2;
      qa[kk][0] = lo_in ? ld_b32(q0) : 0u;
      qa[kk][1] = hi_in ? ld_b32(q0 + 8 * HD) : 0u;
      qa[kk][2] = lo_in ? ld_b32(q0 + 8) : 0u;
      qa[kk][3] = hi_in ? ld_b32(q0 + 8 * HD + 8) : 0u;
    }
    tl.start(ring);
    float m[2], l[2], acc[NB][4];
    int limit[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m[hh] = AT_NEG_INF;
      l[hh] = 0.f;
      limit[hh] = min(tl.len - (q_rows - 1) + (r0 + gq + 8 * hh) / g,
                      tl.kv_end);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

    for (int kb = tl.kb_lo; kb < tl.kb_hi; ++kb) {
      const int st = tl.arrive(ring, kb);
      const T* kt = ring + st * Tiles::STAGE + 8 * warp * ROW;
      const T* vt = kt + 2 * Tiles::STAGE;

      // s[16 rows, 8 positions]: c0,c1 row gq, c2,c3 row gq+8, positions
      // 8w + 2tq + {0, 1}
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const T* kr = kt + gq * ROW + kk * 16 + tq * 2;
        mma_m16n8k16(s, qa[kk], ld_b32(kr), ld_b32(kr + 8));
      }
      const int j = kb * AT_BK + 8 * warp + 2 * tq;
      float p[4], alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bool l0 = j < limit[hh], l1 = j + 1 < limit[hh];
        const float v0 = l0 ? s[2 * hh] * scale : AT_NEG_INF;
        const float v1 = l1 ? s[2 * hh + 1] * scale : AT_NEG_INF;
        float mx = fmaxf(v0, v1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        p[2 * hh] = l0 ? expf(v0 - m_new) : 0.f;
        p[2 * hh + 1] = l1 ? expf(v1 - m_new) : 0.f;
        float sum = p[2 * hh] + p[2 * hh + 1];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[hh] = expf(m[hh] - m_new);
        l[hh] = l[hh] * alpha[hh] + sum;
        m[hh] = m_new;
      }
      const uint32_t pa[2] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3])};
#pragma unroll
      for (int nb4 = 0; nb4 < NB; nb4 += 4) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (lane & 7) * ROW + (nb4 + (lane >> 3)) * 8);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float* c = acc[nb4 + u];
          c[0] *= alpha[0];
          c[1] *= alpha[0];
          c[2] *= alpha[1];
          c[3] *= alpha[1];
          mma_m16n8k8(c, pa, vb[u]);
        }
      }
    }

    // merge the four warps' (m, l, acc) in warp order
    __syncthreads();                             // the ring is free
    if (tq == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        ml[(warp * 2) * 16 + gq + 8 * hh] = m[hh];
        ml[(warp * 2 + 1) * 16 + gq + 8 * hh] = l[hh];
      }
    }
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = gq + 8 * hh;
      float M = AT_NEG_INF;
#pragma unroll
      for (int w = 0; w < AT_WARPS; ++w) M = fmaxf(M, ml[w * 32 + r]);
      const float f = expf(m[hh] - M);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float2 x = make_float2(acc[nb][2 * hh] * f, acc[nb][2 * hh + 1] * f);
        *reinterpret_cast<float2*>(red + (warp * 16 + r) * RS + nb * 8 + tq * 2) = x;
      }
    }
    __syncthreads();
    for (int i = tid; i < 16 * HD; i += AT_THREADS) {
      const int r = i / HD, c = i - r * HD;
      if (r0 + r >= R) continue;
      float M = AT_NEG_INF;
#pragma unroll
      for (int w = 0; w < AT_WARPS; ++w) M = fmaxf(M, ml[w * 32 + r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < AT_WARPS; ++w) {
        L = fmaf(ml[w * 32 + 16 + r], expf(ml[w * 32 + r] - M), L);
        A += red[(w * 16 + r) * RS + c];
      }
      so.template cols<1>(r0 + r, c, &A, L);
      if (c == 0) so.stats(r0 + r, M, L);
    }
    __syncthreads();      // the ring is refilled for the next row tile
  }
}

// Whether split s of ns holds any of a request's nkb tiles.
__device__ __forceinline__ bool split_holds(int s, int nkb, int ns) {
  return (long long)s * nkb / ns < (long long)(s + 1) * nkb / ns;
}

// Second pass (ns > 1, at most AT_MAX_SPLITS): one warp per output row
// (bh, r).  Every load is issued at once (lane s's split statistics and
// all the splits' columns the lane owns), so the pass costs one memory
// latency.  Lane s then holds split s's weight e^(m_s - M); every lane adds
// the l_s and acc columns in split order.  A split that held no tile wrote
// nothing and is dropped; a request with no tile (lens == 0) merges
// nothing and writes zeros.
template <typename T, int HD>
__global__ void __launch_bounds__(AT_THREADS)
attn_merge_kernel(const float* __restrict__ part, const int* __restrict__ lens,
                  T* __restrict__ out, int nkv, int R, int ns, int capacity,
                  int rows) {
  constexpr int DPL = HD / 32;
  const int row = blockIdx.x * AT_WARPS + (threadIdx.x >> 5);  // bh * R + r
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int bh = row / R, r = row - bh * R;
  const size_t P = (size_t)rows * ns;            // partial rows
  const float* pm = part + P * HD;
  const float* pl = pm + P;
  const size_t p0 = (size_t)bh * ns * R + r;     // split s at p0 + s * R
  const size_t mine = p0 + (size_t)min(lane, ns - 1) * R;
  const float mv = pm[mine], lv = pl[mine];
  float a[AT_MAX_SPLITS][DPL];
#pragma unroll
  for (int u = 0; u < AT_MAX_SPLITS; ++u)
    if (u < ns) load_vec<DPL>(part + (p0 + (size_t)u * R) * HD + lane * DPL, a[u]);
  const int kv_end = min(max(lens[bh / nkv], 0), capacity);
  const int nkb = (kv_end + AT_BK - 1) / AT_BK;
  const bool held = lane < ns && split_holds(lane, nkb, ns);
  const float M = warp_max(held ? mv : AT_NEG_INF);
  const float w = held ? expf(mv - M) : 0.f;
  const float lw = lv * w;
  float L = 0.f, A[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) A[e] = 0.f;
#pragma unroll
  for (int u = 0; u < AT_MAX_SPLITS; ++u) {
    if (u >= ns) break;
    const bool hu = __shfl_sync(0xffffffffu, (int)held, u);
    const float wu = __shfl_sync(0xffffffffu, w, u);
    const float lu = __shfl_sync(0xffffffffu, lw, u);
    if (hu) {
      L += lu;
#pragma unroll
      for (int e = 0; e < DPL; ++e) A[e] = fmaf(a[u][e], wu, A[e]);
    }
  }
  T* o = out + (size_t)row * HD + lane * DPL;
#pragma unroll
  for (int e = 0; e < DPL; ++e) o[e] = from_f32<T>(A[e] / fmaxf(L, 1e-30f));
}

// The merge, when there is one, after a split pass that launched cleanly.
template <typename T, int HD, typename KV>
static int launch_merge(int err, const int* lens, void* out, float* part,
                        int b, int nkv, int R, int ns, const KV& kv,
                        cudaStream_t stream) {
  if (err || ns == 1) return err;
  const int rows = b * nkv * R;
  attn_merge_kernel<T, HD><<<(rows + AT_WARPS - 1) / AT_WARPS, AT_THREADS, 0,
                             stream>>>(part, lens, (T*)out, nkv, R, ns,
                                       kv.capacity(), rows);
  return (int)cudaGetLastError();
}

template <int HD, int RPW, typename KV>
static int launch_f32(const void* q, const void* k, const void* v,
                      const int* lens, void* out, float* part, int b, int nkv,
                      int R, int q_rows, int ns, KV kv, cudaStream_t stream) {
  constexpr size_t smem = ScalarSmem<HD, RPW>::bytes;
  auto kern = attn_split_kernel<HD, RPW, KV>;
  if constexpr (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const int row_tiles = (R + 4 * RPW - 1) / (4 * RPW);
  dim3 grid(b * nkv, row_tiles < 65535 ? row_tiles : 65535, ns);
  kern<<<grid, AT_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, lens, (float*)out,
      part, nkv, R, q_rows, ns, 1.0f / sqrtf((float)HD), kv);
  return launch_merge<float, HD>((int)cudaGetLastError(), lens, out, part, b,
                                 nkv, R, ns, kv, stream);
}

template <int HD, typename KV>
static int launch_bf16(const void* q, const void* k, const void* v,
                       const int* lens, void* out, float* part, int b,
                       int nkv, int R, int q_rows, int ns, KV kv,
                       cudaStream_t stream) {
  using T = __nv_bfloat16;
  const int row_tiles = (R + 15) / 16;
  dim3 grid(b * nkv, row_tiles < 65535 ? row_tiles : 65535, ns);
  attn_split_mma_kernel<HD, KV>
      <<<grid, AT_THREADS, MmaSmem<HD>::bytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, lens, (T*)out, part, nkv, R,
          q_rows, ns, 1.0f / sqrtf((float)HD), kv);
  return launch_merge<T, HD>((int)cudaGetLastError(), lens, out, part, b, nkv,
                             R, ns, kv, stream);
}

// Launch over either layout: the split pass and, when ns > 1, the merge.
// dtype: 0 = float32 (CUDA cores, row_tile in {4, 8, 16}), 1 = bfloat16
// (tensor cores, row_tile 16); part: f32 scratch of b * nkv * ns * R *
// (hd + 2) floats (unused when ns == 1).  Returns the first non-zero
// cudaGetLastError() of the launches.
template <typename KV>
static int launch_flash_decode(const void* q, const void* k, const void* v,
                               const void* lens, void* out, void* part, int b,
                               int nkv, int R, int hd, int q_rows,
                               int row_tile, int ns, int dtype, KV kv,
                               void* stream) {
  if (b < 1 || nkv < 1 || R < 1 || q_rows < 1 || R % q_rows || ns < 1 ||
      ns > AT_MAX_SPLITS || (ns > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int* l = (const int*)lens;
  float* p = (float*)part;
#define AT_F32(HD, RPW) \
  launch_f32<HD, RPW>(q, k, v, l, out, p, b, nkv, R, q_rows, ns, kv, s)
#define AT_F32_CASE(HD)                           \
  case HD:                                        \
    switch (row_tile) {                           \
      case 4: return AT_F32(HD, 1);               \
      case 8: return AT_F32(HD, 2);               \
      case 16: return AT_F32(HD, 4);              \
      default: return (int)cudaErrorInvalidValue; \
    }
#define AT_BF16_CASE(HD) \
  case HD: return launch_bf16<HD>(q, k, v, l, out, p, b, nkv, R, q_rows, ns, kv, s)
  if (dtype == 0) {
    switch (hd) {
      AT_F32_CASE(32)
      AT_F32_CASE(64)
      AT_F32_CASE(128)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 1 && row_tile == 16) {
    switch (hd) {
      AT_BF16_CASE(32);
      AT_BF16_CASE(64);
      AT_BF16_CASE(128);
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef AT_F32
#undef AT_F32_CASE
#undef AT_BF16_CASE
  return (int)cudaErrorInvalidValue;
}
