// FC-PIM weight-streaming skinny matmul for Hopper (sm_90a):
//   y_i[m, N_i] = x[m, K] @ w_i[K, N_i]   for 1..FC_MAX_W weights sharing x
// (q/k/v, gate/up), f32 sums, y in x's dtype or in f32, in ONE launch.
//
// Replaces: src/repro/kernels/fc_gemv.py:86 (`fc_gemv`, the Pallas TPU
// kernel; its body `_kernel` carries an f32 accumulator over K blocks in
// scratch).  On the decode path m = max_slots (8), so the product does 2m
// FLOPs per weight element and is bound by the BYTES of w streamed from
// HBM (K*N*itemsize), far below the card's ~295 bf16 FLOP/byte ridge.  At
// the served models' widths one call streams 0.2-34 MB: it lasts a few
// microseconds, so launches, load latency and idle SMs cost as much as the
// bytes.
//
// Design against that:
//  * grid: clusters of CS blocks (thread-block clusters, CS <= 8, the
//    portable size) over the BN-column tiles of every weight of the group.
//    Rank r of a cluster takes rows [r*KS, min(K, (r+1)*KS)) of K for the
//    cluster's tile.  (CS, KS) come from K alone (the wrapper's planner)
//    and every block adds its rows in k order, so a column's sum depends
//    neither on the group it was launched in, nor on BN, nor on m: a
//    weight launched in a group gives the same bits as alone, and two runs
//    give the same bits.
//  * the slice streams through a ring of FC_STAGES shared-memory stages
//    (FC_STAGE_BYTES of w each, with the x columns of the same k rows)
//    filled by 16-byte cp.async copies: up to five stages (~40 KB) are in
//    flight while the sixth is used, and a stage is refilled as soon as
//    every warp is done with it.
//  * bf16 runs on tensor cores: warp v owns the tile's columns
//    [16v, 16v + 16).  Per 16 rows of k it loads the weight block as mma
//    operand A (16 columns x 16 k) with ldmatrix.trans from the row-major
//    w tile, and issues one mma.sync m16n8k16 (f32 accumulate) per 8-row
//    tile of x, whose rows are operand B (x^T: 16 k x 8 rows), against the
//    same A fragment.  Products of bf16 are exact in f32, so only the
//    summation order differs from the plain version.  f32 runs on CUDA
//    cores (no TF32): lane l of warp v owns column 16v + l % 16 and rows
//    l / 16 + 2e (e < 4) of each 8-row tile.
//  * the K split is reduced inside the cluster, with no second kernel and
//    no partial tensor in device memory: each block parks its f32 partial
//    tile in its own shared memory (over the ring); after a barrier over
//    the cluster, rank r sums columns [r*ceil(BN/CS), ...) of the tile
//    over the CS ranks' partials, read through distributed shared memory
//    IN RANK ORDER (deterministic, no atomics), and writes y.  A second
//    barrier keeps every block alive until its peers have read it.
//  * m rows go through in passes of MB <= 64 rows (MT <= FC_MT tiles of
//    8): W crosses device memory once for any m <= MB.  Past that, every
//    pass streams the block's weight slice again, which is then re-read
//    from the 50 MB L2 (the decode path's m = 8 takes one pass, in the
//    MT = 1 instance, whose few accumulators leave registers for more
//    blocks per SM, hence more bytes in flight).
//  * ragged K and N are zero-filled in shared memory.  A w whose rows are
//    not 16-byte aligned (N % 8 != 0 in bf16, N % 4 != 0 in f32, or a view
//    at an odd offset), or such an x, takes the bounds-checked element copy
//    (template flag VEC = false) into the same ring; the arithmetic is the
//    same, so the bits are too.
// Not done yet: TMA, wgmma (its 64-row tiles do not fit m = 8), the q/k/v
// biases folded into the store.  A persistent grid (the resident clusters
// walking the tiles, a five-stage ring) was built and measured slower than
// this design at every served shape (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FC_MAX_W 3           // weights one launch takes
#define FC_STAGES 6          // ring depth
#define FC_STAGE_BYTES 8192  // bytes of w per ring stage
#define FC_MT 8              // 8-row tiles of x per pass (MB <= 64)

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// bf16 mma.sync m16n8k16 with f32 accumulate (c += a b)
__device__ __forceinline__ void mma_m16n8k16(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// thread-block cluster (sm_90): this block's rank, the cluster's size, a
// barrier over all its threads (release / acquire: shared-memory writes
// before it are seen by every block after it), and loads from a peer's
// shared memory (distributed shared memory)
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of `smem` (this block's) in the shared memory of rank `rank`
__device__ __forceinline__ unsigned map_rank(const void* smem, int rank) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(unsigned addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// The weights of one launch: tile_end[i] counts the column tiles of
// weights 0..i (entries past the group repeat the total); y_f32 stores
// every y in f32 whatever x's dtype (a partial product that is summed
// over ranks before its one rounding).
struct FcGroup {
  const void* w[FC_MAX_W];
  void* y[FC_MAX_W];
  int n[FC_MAX_W];
  int tile_end[FC_MAX_W];
  int y_f32;
};

// One block's shared memory, agreed by host and device: FC_STAGES stages
// of [BK][WS] w then [MB][XS] x; after the stream the same bytes hold the
// f32 partial tile [MB][RS].  Every row is padded by 16 bytes, which makes
// ldmatrix and the x fragment loads conflict-free.
template <typename T, int BN>
struct FcLayout {
  static constexpr int EPC = 16 / sizeof(T);          // elements per copy
  static constexpr int BK = FC_STAGE_BYTES / (BN * (int)sizeof(T));
  static constexpr int WS = BN + EPC;
  static constexpr int XS = BK + EPC;
  static constexpr int RS = BN + 4;
  static constexpr int THREADS = 2 * BN;              // a warp per 16 columns
  static_assert(BK % 16 == 0, "a stage holds whole k16 steps");
  __host__ __device__ static int stage_elems(int mb) {
    return BK * WS + mb * XS;
  }
  __host__ __device__ static size_t bytes(int mb) {
    const size_t ring = (size_t)FC_STAGES * stage_elems(mb) * sizeof(T);
    const size_t red = (size_t)mb * RS * sizeof(float);
    return ring > red ? ring : red;
  }
};

// acc[t] += w tile (BK rows, the warp's 16 columns) x rows of tile t, over
// the first kr rows of the stage: tensor cores (bf16)
template <int BK, int WS, int XS, int MT>
__device__ __forceinline__ void mac(float (&acc)[MT][4],
                                    const __nv_bfloat16* ws,
                                    const __nv_bfloat16* xs, int kr, int mt,
                                    int lane, int warp) {
  const int gq = lane >> 2, tq = lane & 3;   // mma group, thread in group
  const int mat = lane >> 3;                 // ldmatrix matrix of this lane
  // matrix j: k rows +8*(j >> 1), columns +8*(j & 1) -> A regs a0..a3
  const __nv_bfloat16* a_src =
      ws + ((mat >> 1) * 8 + (lane & 7)) * WS + warp * 16 + (mat & 1) * 8;
  const __nv_bfloat16* b_src = xs + gq * XS + 2 * tq;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    if (kk < kr) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, a_src + kk * WS);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < mt) {
          const __nv_bfloat16* b = b_src + t * 8 * XS + kk;
          mma_m16n8k16(acc[t], a, ld_b32(b), ld_b32(b + 8));
        }
      }
    }
  }
}

// the same on CUDA cores (f32, no TF32), one k row at a time
template <int BK, int WS, int XS, int MT>
__device__ __forceinline__ void mac(float (&acc)[MT][4], const float* ws,
                                    const float* xs, int kr, int mt, int lane,
                                    int warp) {
  const int c = warp * 16 + (lane & 15), h = lane >> 4;
  for (int kk = 0; kk < kr; ++kk) {
    const float wv = ws[kk * WS + c];
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      if (t < mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[t][e] = fmaf(xs[(t * 8 + h + 2 * e) * XS + kk], wv, acc[t][e]);
      }
    }
  }
}

// the partial tile [row][col] of the accumulators, in the mma's fragment
// layout (bf16: c0..c3 = column gq / gq + 8, rows 2tq / 2tq + 1) or the
// CUDA-core one (f32)
template <int MT>
__device__ __forceinline__ void park(const float (&acc)[MT][4], float* red,
                                     int RS, int mt, int lane, int warp,
                                     __nv_bfloat16) {
  const int gq = lane >> 2, tq = lane & 3, col = warp * 16 + gq;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (t < mt) {
      float* r0 = red + (t * 8 + 2 * tq) * RS + col;
      r0[0] = acc[t][0];
      r0[RS] = acc[t][1];
      r0[8] = acc[t][2];
      r0[RS + 8] = acc[t][3];
    }
  }
}
template <int MT>
__device__ __forceinline__ void park(const float (&acc)[MT][4], float* red,
                                     int RS, int mt, int lane, int warp,
                                     float) {
  const int c = warp * 16 + (lane & 15), h = lane >> 4;
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    if (t < mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(t * 8 + h + 2 * e) * RS + c] = acc[t][e];
    }
  }
}

// grid = (column tiles of the group) * CS blocks in clusters of CS;
// block = 2 * BN threads; dynamic shared memory FcLayout<T, BN>::bytes(mb);
// mb <= 8 * MT.  The m <= 8 instance is held to the registers that let
// as many blocks share an SM as its shared memory does (four of 128
// columns, three of 64 or 32): unbounded, ptxas gave the 128-column one
// 108 registers a thread, room for two blocks.
template <typename T, int BN, int MT, bool VEC>
__global__ void __launch_bounds__(2 * BN, MT == 1 ? (BN == 128 ? 4 : 3) : 1)
fc_gemv_kernel(const T* __restrict__ x, const FcGroup g, int m, int K,
               int ks, int mb) {
  using L = FcLayout<T, BN>;
  constexpr int BK = L::BK, WS = L::WS, XS = L::XS, RS = L::RS;
  constexpr int THREADS = L::THREADS, EPC = L::EPC;
  extern __shared__ __align__(16) unsigned char fc_smem[];
  T* ring = reinterpret_cast<T*>(fc_smem);
  float* red = reinterpret_cast<float*>(fc_smem);

  const int cs = cluster_size(), rank = cluster_rank();
  const int tile = blockIdx.x / cs;
  const int wi = tile < g.tile_end[0] ? 0 : tile < g.tile_end[1] ? 1 : 2;
  const T* w = static_cast<const T*>(wi == 0 ? g.w[0] : wi == 1 ? g.w[1] : g.w[2]);
  void* y = wi == 0 ? g.y[0] : wi == 1 ? g.y[1] : g.y[2];
  const int N = wi == 0 ? g.n[0] : wi == 1 ? g.n[1] : g.n[2];
  const int first = wi == 0 ? 0 : wi == 1 ? g.tile_end[0] : g.tile_end[1];
  const int n0 = (tile - first) * BN;
  const int k0 = rank * ks, k1 = min(K, k0 + ks);
  const int kn = k1 - k0;                  // >= 1: no rank is left empty
  const int chunks = (kn + BK - 1) / BK;
  const int stage = L::stage_elems(mb);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // rows [k0 + c*BK, +BK) of w's column tile and of the pass's x rows into
  // ring stage st; everything outside [k0, k1) x [0, N) x [0, m) is zero
  auto load = [&](int c, int st, int m0) {
    T* ws = ring + st * stage;
    T* xs = ws + BK * WS;
    const int kc = k0 + c * BK;
    if (VEC) {
      constexpr int CPR = BN / EPC;          // copies per w row
#pragma unroll
      for (int j = 0; j < BK * CPR / THREADS; ++j) {
        const int i = tid + j * THREADS;
        const int r = i / CPR, p = i % CPR;
        const int k = kc + r, n = n0 + p * EPC;
        const bool in = k < k1 && n < N;
        cp_async16(ws + r * WS + p * EPC, in ? w + (size_t)k * N + n : w,
                   in ? 16 : 0);
      }
      constexpr int CPX = BK / EPC;          // copies per x row
      for (int i = tid; i < mb * CPX; i += THREADS) {
        const int r = i / CPX, p = i % CPX;
        const int row = m0 + r, k = kc + p * EPC;
        const bool in = row < m && k < k1;
        cp_async16(xs + r * XS + p * EPC, in ? x + (size_t)row * K + k : x,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BK * BN; i += THREADS) {
        const int r = i / BN, cc = i % BN;
        const int k = kc + r, n = n0 + cc;
        ws[r * WS + cc] = k < k1 && n < N ? w[(size_t)k * N + n] : from_f32<T>(0.f);
      }
      for (int i = tid; i < mb * BK; i += THREADS) {
        const int r = i / BK, kk = i % BK;
        const int row = m0 + r, k = kc + kk;
        xs[r * XS + kk] = row < m && k < k1 ? x[(size_t)row * K + k] : from_f32<T>(0.f);
      }
    }
  };

  for (int m0 = 0; m0 < m; m0 += mb) {
    const int rows = min(mb, m - m0);
    const int mt = (rows + 7) >> 3;
#pragma unroll 1
    for (int s = 0; s < FC_STAGES - 1; ++s) {
      if (s < chunks) load(s, s, m0);
      cp_async_commit();
    }
    float acc[MT][4];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;

    for (int c = 0; c < chunks; ++c) {
      cp_async_wait<FC_STAGES - 2>();        // chunk c has landed (mine)
      __syncthreads();                       // ... everyone's; stage c-1 free
      const int next = c + FC_STAGES - 1;
      if (next < chunks) load(next, next % FC_STAGES, m0);
      cp_async_commit();
      const T* ws = ring + (c % FC_STAGES) * stage;
      mac<BK, WS, XS, MT>(acc, ws, ws + BK * WS, min(BK, kn - c * BK), mt,
                          lane, warp);
    }
    cp_async_wait<0>();
    __syncthreads();                         // the ring becomes the partials
    park(acc, red, RS, mt, lane, warp, T());
    cluster_sync();

    // rank r sums columns [c_lo, c_lo + nc) of the tile over the ranks'
    // partials, in rank order
    const int cw = (BN + cs - 1) / cs;
    const int c_lo = rank * cw;
    const int nc = max(0, min(BN, c_lo + cw) - c_lo);
    unsigned peer[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) peer[q] = map_rank(red, q < cs ? q : 0);
    for (int i = tid; i < rows * nc; i += THREADS) {
      const int r = i / nc, cc = c_lo + i - r * nc;
      if (n0 + cc < N) {
        float v[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          v[q] = q < cs ? ld_cluster(peer[q] + 4u * (r * RS + cc)) : 0.f;
        float s = v[0];
#pragma unroll
        for (int q = 1; q < 8; ++q)
          if (q < cs) s += v[q];
        const size_t at = (size_t)(m0 + r) * N + n0 + cc;
        if (g.y_f32)
          static_cast<float*>(y)[at] = s;
        else
          static_cast<T*>(y)[at] = from_f32<T>(s);
      }
    }
    cluster_sync();                          // peers are done reading mine
  }
}

template <typename T, int BN, int MT, bool VEC>
static cudaError_t launch_as(const void* x, const FcGroup& g, int tiles,
                             int m, int K, int cs, int ks, int mb,
                             cudaStream_t stream) {
  using L = FcLayout<T, BN>;
  void (*kern)(const T*, FcGroup, int, int, int, int) =
      fc_gemv_kernel<T, BN, MT, VEC>;
  const size_t smem = L::bytes(mb);
  static size_t allowed = 48 * 1024;         // dynamic bytes allowed so far
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * cs));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, (const T*)x, g, m, K, ks, mb);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int BN>
static cudaError_t launch_bn(const void* x, const FcGroup& g, int tiles,
                             int m, int K, int cs, int ks, int mb, bool vec,
                             cudaStream_t s) {
  if (mb == 8)
    return vec ? launch_as<T, BN, 1, true>(x, g, tiles, m, K, cs, ks, mb, s)
               : launch_as<T, BN, 1, false>(x, g, tiles, m, K, cs, ks, mb, s);
  return vec ? launch_as<T, BN, FC_MT, true>(x, g, tiles, m, K, cs, ks, mb, s)
             : launch_as<T, BN, FC_MT, false>(x, g, tiles, m, K, cs, ks, mb, s);
}

template <typename T>
static cudaError_t launch(const void* x, const FcGroup& g, int tiles, int m,
                          int K, int cs, int ks, int bn, int mb, bool vec,
                          cudaStream_t s) {
  switch (bn) {
    case 32: return launch_bn<T, 32>(x, g, tiles, m, K, cs, ks, mb, vec, s);
    case 64: return launch_bn<T, 64>(x, g, tiles, m, K, cs, ks, mb, vec, s);
    case 128: return launch_bn<T, 128>(x, g, tiles, m, K, cs, ks, mb, vec, s);
  }
  return cudaErrorInvalidValue;
}

// y_i = x @ w_i for the first `count` (1..3) of (w_i, y_i, n_i); x [m, K],
// w_i [K, n_i], y_i [m, n_i], all row-major, dtype 0 = float32, 1 =
// bfloat16 (of x and w, and of y unless y_f32: then y is float32).  The
// plan: `cluster` ranks of `k_slice` rows each (a multiple
// of 16, no rank empty), `col_tile` in {32, 64, 128} columns per block,
// `m_rows` (8..64, a multiple of 8) rows of x per pass.  Returns the
// cudaError_t of the launch.
extern "C" int fc_gemv_launch(const void* x, int m, int K, int count,
                              const void* w0, const void* w1, const void* w2,
                              void* y0, void* y1, void* y2, int n0, int n1,
                              int n2, int cluster, int k_slice, int col_tile,
                              int m_rows, int dtype, int y_f32,
                              void* stream) {
  const void* ws[FC_MAX_W] = {w0, w1, w2};
  void* ys[FC_MAX_W] = {y0, y1, y2};
  const int ns[FC_MAX_W] = {n0, n1, n2};
  if (m < 1 || K < 1 || count < 1 || count > FC_MAX_W || cluster < 1 ||
      cluster > 8 || k_slice < 16 || k_slice % 16 != 0 ||
      (long long)(cluster - 1) * k_slice >= K ||
      (long long)cluster * k_slice < K || m_rows < 8 || m_rows > 8 * FC_MT ||
      m_rows % 8 != 0 || (dtype != 0 && dtype != 1) ||
      (col_tile != 32 && col_tile != 64 && col_tile != 128))
    return (int)cudaErrorInvalidValue;
  const int esize = dtype == 0 ? 4 : 2, epc = 16 / esize;
  bool vec = (uintptr_t)x % 16 == 0 && K % epc == 0;
  FcGroup g;
  long long tiles = 0;
  for (int i = 0; i < FC_MAX_W; ++i) {
    if (i < count) {
      if (ns[i] < 1 || ws[i] == nullptr || ys[i] == nullptr)
        return (int)cudaErrorInvalidValue;
      vec = vec && (uintptr_t)ws[i] % 16 == 0 && ns[i] % epc == 0;
      tiles += (ns[i] + col_tile - 1) / col_tile;
    }
    g.w[i] = i < count ? ws[i] : ws[0];
    g.y[i] = i < count ? ys[i] : ys[0];
    g.n[i] = i < count ? ns[i] : ns[0];
    g.tile_end[i] = (int)tiles;
  }
  g.y_f32 = y_f32 != 0;
  if (tiles * cluster > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, g, (int)tiles, m, K, cluster, k_slice,
                              col_tile, m_rows, vec, s);
  return (int)launch<__nv_bfloat16>(x, g, (int)tiles, m, K, cluster, k_slice,
                                    col_tile, m_rows, vec, s);
}
