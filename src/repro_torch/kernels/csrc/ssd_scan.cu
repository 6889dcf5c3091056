// Mamba2 SSD chunk scan for Hopper (sm_90a):
//   per (batch, head), chunks of cs rows in order, state S [hp, n] f32:
//     y_c = (C_c B_c^T o L_c) dtx_c + (e^{cum_c} o C_c) S^T
//     S  <- e^{cum_last} S + (e^{cum_last - cum_c} o dtx_c)^T B_c
//   cum = inclusive within-chunk cumsum of the log-decay lt (f32, taken by
//   the wrapper as the Pallas wrapper takes it, so that the kernel and the
//   plain version see the same values: at cs = 256 |cum| reaches hundreds,
//   and two summation orders would differ in e^{cum_i - cum_j} by more than
//   the f32 tolerance), L_c[i, j] = e^{cum_i - cum_j} for j <= i, else 0.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan (Pallas TPU kernel, body
// `_kernel`; grid (b, nh, nc) with the state in VMEM scratch across the
// sequential chunk axis).  Unlike it, this kernel also starts from a given
// state (null = zeros) and writes the state after the last chunk, which the
// serving path needs.
//
// Bound: at the main path's shapes (b=8, nh=64, l=512, hp=64, n=128 or 64,
// cs=256; dtx f32, B/C/y bf16) a call moves ~137 MB (0.041 ms at 3.35 TB/s)
// and does ~13 GFLOP: C B^T once per batch row and chunk (bf16 tensor
// cores), its product with dtx and the inter-chunk term (TF32), the state
// update (3xTF32: twice the TF32 operations of a plain product).  Those
// take ~0.035 ms at the tensor-core rates, so the bytes bound it (PERF.md).
//
// Design, two launches a call, no atomics, every sum in a fixed order (two
// runs give the same bits):
//  * ssd_cb_kernel: C B^T is shared by every head (B and C are one group),
//    so it is computed once per (batch row, chunk): one block per 64 x 64
//    tile pair j <= i writes C_i B_j^T in f32 to scratch the wrapper
//    allocates ([b, nc, csp, csp], csp = cs rounded up to 64; 4.2 MB at the
//    main path's shapes, read back from the 50 MB L2).  bf16 B/C run on
//    tensor cores (mma.sync m16n8k16, f32 accumulate: products of bf16 are
//    exact in f32, only the summation order changes); f32 B/C on CUDA cores.
//  * ssd_scan_kernel: one block (8 warps) per (batch, head) loops over the
//    chunks and carries S in shared memory in f32.  Per chunk:
//    - y (phase A), in 64-row tiles i.  Where y is bf16 the products run on
//      tensor cores in TF32 (mma.sync m16n8k8, f32 accumulate): P = (C B^T)_ij
//      o L_ij, dtx_j, C and S are rounded to TF32 (2^-11).  bf16 operands
//      (2^-9) were tried first and missed the 5e-2 rule on y by 1.28x where
//      the state carries across chunks (slow decay: the P dtx sum cancels);
//      TF32 leaves the error at about the size of y's own bf16 store
//      (PERF.md).  Where y is f32 (the all-f32 mix) every product is f32 on
//      CUDA cores, no TF32 (tolerance 1e-4).  The (i, j) tile pairs run in
//      order: the next pair's dtx tile is copied by cp.async into the other
//      of two stages and its (C B^T) tile fetched into registers while the
//      current pair's mma runs; at a row tile's first pair the next C tile
//      follows.  On the diagonal tile a warp skips the columns past its rows
//      (P is zero there).
//    - the state (phase B) keeps f32 accuracy, because it feeds every decode
//      step after it (tolerance 1e-4).  Where y is bf16 at hp x n >= 4096 it
//      runs on tensor cores as 3xTF32: w_j dtx_j (and B, if f32) is split
//      into a TF32 high part and a TF32 remainder, and hi*hi + hi*lo + lo*hi
//      are accumulated in f32 (B in bf16 is exact in TF32: two mmas).  The
//      all-f32 mix, and the smoke shapes, take CUDA-core f32 FMAs in 8 x 8
//      register tiles (2 x 1 at the smoke shape) whose row groups group 0
//      adds in order.  The dtx and B tiles stream through two cp.async
//      stages.
//  * the dtype mixes (dtx, B/C and y each f32 or bf16) and the (hp, n) pairs
//    of the three shape sets are template instances; exp is taken only of
//    j <= i terms (seg = cum_i - cum_j > 0 for j > i would overflow, and
//    inf * 0 is NaN); rows past cs are zero-filled and masked.
//  * shared memory at the main path's mix is 106 KB (n = 128) and 80 KB
//    (n = 64) a block, and __launch_bounds__ holds registers to 128 a thread,
//    so two blocks share an SM (one block an SM measured 27% slower).
// Not done yet: wgmma, TMA, fewer exps (P factorised per tile).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define SSD_RT 64        // chunk rows per tile
#define SSD_NT 256       // threads per block: 8 warps
// The choices `chip_ab.py --ssd` sweeps (with -D): the blocks an SM is
// meant to hold (registers are capped at 65536 / (256 x this)), the state
// update on CUDA cores where it would take tensor cores (1), and the rows of
// the CUDA-core state update's register tile (x 8 columns) at hp x n >= 4096.
#ifndef SSD_MIN_BLOCKS
#define SSD_MIN_BLOCKS 2
#endif
#ifndef SSD_STATE_FMA
#define SSD_STATE_FMA 0
#endif
#ifndef SSD_STATE_TP
#define SSD_STATE_TP 8
#endif

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// four 8x8 b16 matrices; lane i names row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
// TF32 mma.sync m16n8k8 with f32 accumulate (c += a b)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// a value as a TF32 operand: f32 rounded to nearest, bf16 exact
__device__ __forceinline__ uint32_t tf32_of(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ uint32_t tf32_of(bf16 v) {
  return (uint32_t)__bfloat16_as_ushort(v) << 16;
}

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Rows [0, rows) of a row-major [*, COLS] source into dst (leading dimension
// LD elements); rows at or past `valid` are zero.  The same type into a
// 16-byte-aligned layout goes by cp.async (the caller commits and waits);
// anything else element by element into f32.
template <typename TS, typename TD, int COLS, int LD>
__device__ __forceinline__ void load_rows(const TS* __restrict__ src, int rows,
                                          int valid, TD* dst) {
  if constexpr (std::is_same<TS, TD>::value &&
                (LD * sizeof(TD)) % 16 == 0) {
    constexpr int EPC = 16 / sizeof(TS);
    constexpr int CPR = COLS / EPC;
    static_assert(COLS % EPC == 0, "rows are whole 16-byte copies");
    for (int i = threadIdx.x; i < rows * CPR; i += SSD_NT) {
      const int r = i / CPR, p = i % CPR;
      const bool in = r < valid;
      cp_async16(dst + r * LD + p * EPC,
                 in ? src + (long)r * COLS + p * EPC : src, in ? 16 : 0);
    }
  } else {
    static_assert(std::is_same<TD, float>::value, "converted into f32");
    for (int i = threadIdx.x; i < rows * COLS; i += SSD_NT) {
      const int r = i / COLS, c = i % COLS;
      dst[r * LD + c] = r < valid ? to_f(src[(long)r * COLS + c]) : 0.f;
    }
  }
}

// CNT consecutive shared elements from p as f32 (16-byte loads where whole)
template <typename T, int CNT>
__device__ __forceinline__ void load_f(const T* p, float* out) {
  if constexpr (std::is_same<T, float>::value && CNT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < CNT; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
    }
  } else if constexpr (std::is_same<T, bf16>::value && CNT % 8 == 0) {
#pragma unroll
    for (int i = 0; i < CNT; i += 8) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
        out[i + 2 * k] = f.x;
        out[i + 2 * k + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < CNT; ++i) out[i] = to_f(p[i]);
  }
}

// ---------------------------------------------------------------------------
// Pass 1: C_i B_j^T, one block per (tile pair j <= i, chunk, batch row)
template <typename TBC, int N>
struct CbLayout {
  static constexpr bool TC = std::is_same<TBC, bf16>::value;
  static constexpr int LD = TC ? N + 8 : N + 1;   // conflict-free rows
  static constexpr size_t bytes = 2 * align16(SSD_RT * LD * sizeof(TBC));
};

template <typename TBC, int N>
__global__ void __launch_bounds__(SSD_NT)
    ssd_cb_kernel(const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                  float* __restrict__ cb, int l, int cs, int csp) {
  using L = CbLayout<TBC, N>;
  constexpr int LD = L::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  TBC* Ct = reinterpret_cast<TBC*>(smem);
  TBC* Bt = reinterpret_cast<TBC*>(smem + L::bytes / 2);
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= (int)blockIdx.x) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z, nc = l / cs;
  const int i0 = it * SSD_RT, j0 = jt * SSD_RT;
  const long base = ((long)b * l + (long)c * cs) * N;
  load_rows<TBC, TBC, N, LD>(Cm + base + (long)i0 * N, SSD_RT, cs - i0, Ct);
  load_rows<TBC, TBC, N, LD>(Bm + base + (long)j0 * N, SSD_RT, cs - j0, Bt);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = cb + (((long)b * nc + c) * csp + i0) * csp + j0;
  const int tid = threadIdx.x;
  if constexpr (L::TC) {
    // warp (wr, wc) owns rows [16 wr, +16) x columns [32 wc, +32)
    const int lane = tid & 31, warp = tid >> 5, wr = warp & 3, wc = warp >> 2;
    const int g = lane >> 2, t = lane & 3;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, Ct + (16 * wr + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD +
                         k0 + 8 * (lane >> 4));
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t bq[4];
        ldmatrix_x4(bq, Bt + (32 * wc + 16 * pr + (lane & 7) +
                              8 * (lane >> 4)) * LD +
                            k0 + 8 * ((lane >> 3) & 1));
        mma_bf16(acc[2 * pr], a, bq[0], bq[1]);
        mma_bf16(acc[2 * pr + 1], a, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float* o = out + (long)(16 * wr + g) * csp + 32 * wc + 8 * q + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(o + 8L * csp) =
          make_float2(acc[q][2], acc[q][3]);
    }
  } else {
    // a 16 x 16 thread grid, rows ty + 16a, columns tx + 16q
    const int tx = tid % 16, ty = tid / 16;
    float p[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q) p[a][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = Ct[(ty + 16 * a) * LD + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bt[(tx + 16 * q) * LD + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) p[a][q] += av[a] * bv[q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        out[(long)(ty + 16 * a) * csp + tx + 16 * q] = p[a][q];
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the scan.  One block's shared memory, agreed by host and device:
// the state S [HP][LDS] f32, the chunk's cumsum [csp] f32 (the decay-to-end
// weights in phase B), then one region that phase A and phase B use in turn:
//   phase A: the C tile [64][LDC], the P tile [64][LDP] f32, then (tensor
//     cores) two dtx stages [64][LXS] or (f32) one dtx tile [64][HP+1] f32;
//   phase B: two stages of a dtx tile [64][LXS] and a B tile [64][LBS]
//     (CUDA cores: later the group partials [KS-1][HP][N] f32).
// The paddings make every mma fragment load conflict-free (row strides of
// 4 or 8 words mod 32).
template <typename TX, typename TBC, typename TY, int HP, int N>
struct ScanLayout {
  static constexpr bool TC = std::is_same<TY, bf16>::value;  // y products
  static constexpr bool TCS =                                // the state
      TC && HP * N >= 4096 && !SSD_STATE_FMA;
  using TCt = typename std::conditional<TC, TBC, float>::type;
  static constexpr int LDS = TC ? N + 4 : N + 1;
  static constexpr int LDC = TC ? N + 16 / (int)sizeof(TBC) : N + 1;
  static constexpr int LDP = TC ? SSD_RT + 4 : SSD_RT + 1;
  static constexpr int LDX = HP + 1;                 // the f32 path's dtx
  static constexpr int LXS = HP + 32 / (int)sizeof(TX);
  static constexpr int LBS = N + 32 / (int)sizeof(TBC);
  // CUDA-core state: a TP x TN register tile per thread, TPG threads cover
  // S, KS groups of them split a tile's rows
  static constexpr int TP = HP * N >= 4096 ? SSD_STATE_TP : 2;
  static constexpr int TN = HP * N >= 4096 ? 8 : 1;
  static constexpr int TPG = HP * N / (TP * TN);
  static constexpr int KS = SSD_NT / TPG;
  static_assert(TPG * KS == SSD_NT && SSD_RT % KS == 0, "state tiling");
  static_assert(HP % 32 == 0 && N % 16 == 0, "mma tiling");

  __host__ __device__ static constexpr size_t s_bytes() {
    return align16((size_t)HP * LDS * 4);
  }
  __host__ __device__ static size_t cum_bytes(int csp) {
    return align16((size_t)csp * 4);
  }
  __host__ __device__ static constexpr size_t ca_bytes() {
    return align16((size_t)SSD_RT * LDC * sizeof(TCt));
  }
  __host__ __device__ static constexpr size_t pa_bytes() {
    return align16((size_t)SSD_RT * LDP * 4);
  }
  __host__ __device__ static constexpr size_t xs_bytes() {
    return align16((size_t)SSD_RT * LXS * sizeof(TX));
  }
  __host__ __device__ static constexpr size_t bs_bytes() {
    return align16((size_t)SSD_RT * LBS * sizeof(TBC));
  }
  __host__ __device__ static constexpr size_t a_bytes() {
    return ca_bytes() + pa_bytes() +
           (TC ? 2 * xs_bytes() : align16((size_t)SSD_RT * LDX * 4));
  }
  __host__ __device__ static constexpr size_t b_bytes() {
    return !TCS && (size_t)(KS - 1) * HP * N * 4 > 2 * (xs_bytes() + bs_bytes())
               ? (size_t)(KS - 1) * HP * N * 4
               : 2 * (xs_bytes() + bs_bytes());
  }
  __host__ __device__ static size_t bytes(int csp) {
    return s_bytes() + cum_bytes(csp) +
           (a_bytes() > b_bytes() ? a_bytes() : b_bytes());
  }
};

// the (C B^T) tile (i0, j0) of the chunk: 16 floats a thread (row e / 16,
// columns 4 (e % 16) ..+3 of e = tid + 256 q), fetched into registers
__device__ __forceinline__ void fetch_cb(float4 (&pre)[4],
                                         const float* __restrict__ cbc,
                                         int csp, int i0, int j0) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + SSD_NT * q, r = e >> 4, c4 = (e & 15) * 4;
    pre[q] = *reinterpret_cast<const float4*>(cbc + (long)(i0 + r) * csp +
                                              j0 + c4);
  }
}

// P = (C B^T) o L of the fetched tile into Pt [64][LDP], f32 (TF32: rounded
// to nearest TF32 once here, as the mma's A operand)
template <int LDP, bool TF32>
__device__ __forceinline__ void store_p(const float4 (&pre)[4], float* Pt,
                                        const float* cum, int i0, int j0,
                                        int cs) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int e = threadIdx.x + SSD_NT * q, r = e >> 4, c4 = (e & 15) * 4;
    const int i = i0 + r;
    const float ci = i < cs ? cum[i] : 0.f;
    const float src[4] = {pre[q].x, pre[q].y, pre[q].z, pre[q].w};
    const float4 cj4 = *reinterpret_cast<const float4*>(cum + j0 + c4);
    const float cj[4] = {cj4.x, cj4.y, cj4.z, cj4.w};
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + c4 + u;
      // only j <= i < cs: exp never sees a positive exponent
      v[u] = (j <= i && i < cs) ? src[u] * __expf(ci - cj[u]) : 0.f;
      if (TF32) v[u] = __uint_as_float(tf32_of(v[u]));
    }
    if constexpr (LDP % 4 == 0)
      *reinterpret_cast<float4*>(Pt + r * LDP + c4) =
          make_float4(v[0], v[1], v[2], v[3]);
    else
#pragma unroll
      for (int u = 0; u < 4; ++u) Pt[r * LDP + c4 + u] = v[u];
  }
}

// Phase A on tensor cores (y bf16), TF32 products with f32 sums: y rows of
// the chunk, tile by tile.  The (it, jt) pairs run in order; pair k's dtx
// tile sits in stage k & 1 while pair k + 1's is copied, with its (C B^T)
// tile fetched into registers and, at a row tile's first pair, the next C
// tile.
template <typename L, typename TX, typename TBC, int HP, int N>
__device__ __forceinline__ void phase_a_tc(
    const TX* __restrict__ xsrc, const TBC* __restrict__ csrc,
    const float* __restrict__ cbc, bf16* __restrict__ ydst, const float* S,
    const float* cum, unsigned char* region, int cs, int ntile) {
  constexpr int LXS = L::LXS, LDC = L::LDC, LDP = L::LDP, LDS = L::LDS;
  constexpr int NT8 = HP / 16;         // n8 tiles of a warp's HP/2 columns
  const int csp = ntile * SSD_RT;
  TBC* Ct = reinterpret_cast<TBC*>(region);
  float* Pt = reinterpret_cast<float*>(region + L::ca_bytes());
  auto xstage = [&](int st) {
    return reinterpret_cast<TX*>(region + L::ca_bytes() + L::pa_bytes() +
                                 st * L::xs_bytes());
  };
  load_rows<TBC, TBC, N, LDC>(csrc, SSD_RT, cs, Ct);
  load_rows<TX, TX, HP, LXS>(xsrc, SSD_RT, cs, xstage(0));
  cp_async_commit();
  float4 pre[4];
  fetch_cb(pre, cbc, csp, 0, 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = warp & 3, wc = warp >> 2, g = lane >> 2, t = lane & 3;
  const int col0 = (HP / 2) * wc;      // the warp's first column of y
  int pair = 0;
  for (int it = 0; it < ntile; ++it) {
    const int i0 = it * SSD_RT;
    cp_async_wait<0>();
    __syncthreads();                   // C_i and the pair's dtx have landed
    float acc[NT8][4];
#pragma unroll
    for (int q = 0; q < NT8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    // inter-chunk term: C_i S^T
#pragma unroll 4
    for (int k0 = 0; k0 < N; k0 += 8) {
      const TBC* cp = Ct + (16 * wr + g) * LDC + k0 + t;
      const uint32_t a[4] = {tf32_of(cp[0]), tf32_of(cp[8 * LDC]),
                             tf32_of(cp[4]), tf32_of(cp[8 * LDC + 4])};
#pragma unroll
      for (int qq = 0; qq < NT8 / 2; ++qq) {
        uint32_t bq[4];
        ldmatrix_x4(bq, S + (col0 + 16 * qq + 8 * (lane >> 4) + (lane & 7)) *
                                LDS + k0 + 4 * ((lane >> 3) & 1));
        mma_tf32(acc[2 * qq], a, tf32_of(__uint_as_float(bq[0])),
                 tf32_of(__uint_as_float(bq[1])));
        mma_tf32(acc[2 * qq + 1], a, tf32_of(__uint_as_float(bq[2])),
                 tf32_of(__uint_as_float(bq[3])));
      }
    }
    {
      const int ra = i0 + 16 * wr + g, rb = ra + 8;
      const float ea = ra < cs ? __expf(cum[ra]) : 0.f;
      const float eb = rb < cs ? __expf(cum[rb]) : 0.f;
#pragma unroll
      for (int q = 0; q < NT8; ++q) {
        acc[q][0] *= ea; acc[q][1] *= ea;
        acc[q][2] *= eb; acc[q][3] *= eb;
      }
    }
    __syncthreads();                   // every warp is done with Ct

    // intra-chunk terms of the tiles j <= i: P_ij dtx_j
    for (int jt = 0; jt <= it; ++jt, ++pair) {
      store_p<LDP, true>(pre, Pt, cum, i0, jt * SSD_RT, cs);
      const int nit = jt < it ? it : it + 1, njt = jt < it ? jt + 1 : 0;
      if (nit < ntile) {
        load_rows<TX, TX, HP, LXS>(xsrc + (long)njt * SSD_RT * HP, SSD_RT,
                                   cs - njt * SSD_RT, xstage((pair + 1) & 1));
        if (jt == 0 && it + 1 < ntile)
          load_rows<TBC, TBC, N, LDC>(csrc + (long)(i0 + SSD_RT) * N, SSD_RT,
                                      cs - i0 - SSD_RT, Ct);
        fetch_cb(pre, cbc, csp, nit * SSD_RT, njt * SSD_RT);
      }
      cp_async_commit();
      cp_async_wait<1>();              // this pair's dtx tile (mine)
      __syncthreads();                 // ... everyone's, and P
      const TX* xs = xstage(pair & 1);
      const int kend = jt == it ? 16 * (wr + 1) : SSD_RT;  // P = 0 past it
      for (int k0 = 0; k0 < kend; k0 += 8) {
        uint32_t a[4];
        ldmatrix_x4(a, Pt + (16 * wr + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                LDP + k0 + 4 * (lane >> 4));
        const TX* xp = xs + (k0 + t) * LXS + col0 + g;
#pragma unroll
        for (int q = 0; q < NT8; ++q)
          mma_tf32(acc[q], a, tf32_of(xp[8 * q]), tf32_of(xp[8 * q + 4 * LXS]));
      }
      __syncthreads();                 // Pt and the stage are rewritten next
    }
    const int ra = i0 + 16 * wr + g, rb = ra + 8;
#pragma unroll
    for (int q = 0; q < NT8; ++q) {
      const int col = col0 + 8 * q + 2 * t;
      if (ra < cs)
        *reinterpret_cast<uint32_t*>(ydst + (long)ra * HP + col) =
            pack_bf16(acc[q][0], acc[q][1]);
      if (rb < cs)
        *reinterpret_cast<uint32_t*>(ydst + (long)rb * HP + col) =
            pack_bf16(acc[q][2], acc[q][3]);
    }
  }
  cp_async_wait<0>();
}

// Phase A on CUDA cores (y f32: every product in f32, no TF32)
template <typename L, typename TX, typename TBC, int HP, int N>
__device__ __forceinline__ void phase_a_f32(
    const TX* __restrict__ xsrc, const TBC* __restrict__ csrc,
    const float* __restrict__ cbc, float* __restrict__ ydst, const float* S,
    const float* cum, unsigned char* region, int cs, int ntile) {
  constexpr int LDX = L::LDX, LDC = L::LDC, LDP = L::LDP, LDS = L::LDS;
  constexpr int TH = HP / 16;
  const int csp = ntile * SSD_RT;
  float* Ct = reinterpret_cast<float*>(region);
  float* Pt = reinterpret_cast<float*>(region + L::ca_bytes());
  float* Xt = reinterpret_cast<float*>(region + L::ca_bytes() +
                                       L::pa_bytes());
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int it = 0; it < ntile; ++it) {
    const int i0 = it * SSD_RT;
    load_rows<TBC, float, N, LDC>(csrc + (long)i0 * N, SSD_RT, cs - i0, Ct);
    __syncthreads();
    float acc[4][TH];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < TH; ++q) acc[a][q] = 0.f;
#pragma unroll 4
    for (int k = 0; k < N; ++k) {
      float av[4], bv[TH];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = Ct[(ty + 16 * a) * LDC + k];
#pragma unroll
      for (int q = 0; q < TH; ++q) bv[q] = S[(tx + 16 * q) * LDS + k];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < TH; ++q) acc[a][q] += av[a] * bv[q];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      const float e = i < cs ? __expf(cum[i]) : 0.f;
#pragma unroll
      for (int q = 0; q < TH; ++q) acc[a][q] *= e;
    }
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * SSD_RT;
      load_rows<TX, float, HP, LDX>(xsrc + (long)j0 * HP, SSD_RT, cs - j0, Xt);
      float4 pre[4];
      fetch_cb(pre, cbc, csp, i0, j0);
      store_p<LDP, false>(pre, Pt, cum, i0, j0, cs);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < SSD_RT; ++j) {
        float av[4], bv[TH];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = Pt[(ty + 16 * a) * LDP + j];
#pragma unroll
        for (int q = 0; q < TH; ++q) bv[q] = Xt[j * LDX + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < TH; ++q) acc[a][q] += av[a] * bv[q];
      }
      __syncthreads();                 // Xt / Pt / Ct are reloaded next
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i < cs) {
#pragma unroll
        for (int q = 0; q < TH; ++q)
          ydst[(long)i * HP + tx + 16 * q] = acc[a][q];
      }
    }
  }
}

// Phase B's tile stream: tile jt of the chunk's dtx and B rows into stage
// st (rows past cs zero)
template <typename L, typename TX, typename TBC, int HP, int N>
struct StateStages {
  unsigned char* region;
  const TX* xsrc;
  const TBC* bsrc;
  int cs;
  __device__ TX* x(int st) const {
    return reinterpret_cast<TX*>(region + st * (L::xs_bytes() + L::bs_bytes()));
  }
  __device__ TBC* b(int st) const {
    return reinterpret_cast<TBC*>(region + st * (L::xs_bytes() + L::bs_bytes()) +
                                  L::xs_bytes());
  }
  __device__ void load(int jt, int st) const {
    const int j0 = jt * SSD_RT;
    load_rows<TX, TX, HP, L::LXS>(xsrc + (long)j0 * HP, SSD_RT, cs - j0, x(st));
    load_rows<TBC, TBC, N, L::LBS>(bsrc + (long)j0 * N, SSD_RT, cs - j0, b(st));
  }
};

// Phase B on tensor cores: D[p][n] = sum_j (w_j dtx_j[p]) B_j[n] as 3xTF32
// (each operand split into a TF32 high part and a TF32 remainder; the
// remainders' product is dropped, and B in bf16 has none): f32 accuracy.
// Warps 4 (16 rows of p) x 2 (N/2 columns of n); S = e^{last} S + D.
template <typename L, typename TX, typename TBC, int HP, int N>
__device__ __forceinline__ void phase_b_tc(const StateStages<L, TX, TBC, HP, N>& st,
                                           float* S, const float* w,
                                           float last, int ntile) {
  constexpr int LXS = L::LXS, LBS = L::LBS, LDS = L::LDS;
  constexpr int NTS = N / 16;          // n8 tiles of a warp's N/2 columns
  constexpr bool BLO = !std::is_same<TBC, bf16>::value;
  static_assert(HP == 64 && N % 16 == 0, "4 x 2 warps of 16 x N/2");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * (warp & 3), n0 = (N / 2) * (warp >> 2);
  float acc[NTS][4];
#pragma unroll
  for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  st.load(0, 0);
  cp_async_commit();
  for (int jt = 0; jt < ntile; ++jt) {
    if (jt + 1 < ntile) st.load(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile jt has landed (mine)
    __syncthreads();                   // ... everyone's, and the weights
    const TX* xs = st.x(jt & 1);
    const TBC* bs = st.b(jt & 1);
    const float* wt = w + jt * SSD_RT;
#pragma unroll 2
    for (int k0 = 0; k0 < SSD_RT; k0 += 8) {
      const float w0 = wt[k0 + t], w1 = wt[k0 + t + 4];
      uint32_t ah[4], al[4];
      {
        const TX* xp = xs + (k0 + t) * LXS + m0 + g;
        const float v[4] = {to_f(xp[0]) * w0, to_f(xp[8]) * w0,
                            to_f(xp[4 * LXS]) * w1, to_f(xp[4 * LXS + 8]) * w1};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[e] = tf32_of(v[e]);
          al[e] = tf32_of(v[e] - __uint_as_float(ah[e]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTS; ++nt) {
        const TBC* bp = bs + (k0 + t) * LBS + n0 + 8 * nt + g;
        const uint32_t bh0 = tf32_of(bp[0]), bh1 = tf32_of(bp[4 * LBS]);
        mma_tf32(acc[nt], al, bh0, bh1);
        if constexpr (BLO) {
          const uint32_t bl0 = tf32_of(to_f(bp[0]) - __uint_as_float(bh0));
          const uint32_t bl1 = tf32_of(to_f(bp[4 * LBS]) - __uint_as_float(bh1));
          mma_tf32(acc[nt], ah, bl0, bl1);
        }
        mma_tf32(acc[nt], ah, bh0, bh1);
      }
    }
    __syncthreads();                   // the stage is refilled next
  }
  const float G = expf(last);
#pragma unroll
  for (int nt = 0; nt < NTS; ++nt) {
    float* s0 = S + (m0 + g) * LDS + n0 + 8 * nt + 2 * t;
    float* s1 = s0 + 8 * LDS;
    s0[0] = G * s0[0] + acc[nt][0];
    s0[1] = G * s0[1] + acc[nt][1];
    s1[0] = G * s1[0] + acc[nt][2];
    s1[1] = G * s1[1] + acc[nt][3];
  }
}

// Phase B on CUDA cores (f32 FMAs): thread q of group grp owns S rows
// [tp TP, +TP) x [tn TN, +TN) over the group's rows of every tile; group 0
// adds the other groups' partials in group order.
template <typename L, typename TX, typename TBC, int HP, int N>
__device__ __forceinline__ void phase_b_f32(const StateStages<L, TX, TBC, HP, N>& st,
                                            float* S, const float* w,
                                            float last, int ntile) {
  constexpr int LXS = L::LXS, LBS = L::LBS, LDS = L::LDS;
  constexpr int TP = L::TP, TN = L::TN, TPG = L::TPG, KS = L::KS;
  constexpr int RPG = SSD_RT / KS;     // rows of a tile per group
  const int grp = threadIdx.x / TPG, q = threadIdx.x % TPG;
  const int tn = q % (N / TN), tp = q / (N / TN);
  float s[TP][TN];
#pragma unroll
  for (int a = 0; a < TP; ++a)
#pragma unroll
    for (int u = 0; u < TN; ++u) s[a][u] = 0.f;
  st.load(0, 0);
  cp_async_commit();
  for (int jt = 0; jt < ntile; ++jt) {
    if (jt + 1 < ntile) st.load(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();                // tile jt has landed (mine)
    __syncthreads();                   // ... everyone's, and the weights
    const TX* xs = st.x(jt & 1) + tp * TP;
    const TBC* bs = st.b(jt & 1) + tn * TN;
    const float* wt = w + jt * SSD_RT;
#pragma unroll 2
    for (int jr = grp * RPG; jr < (grp + 1) * RPG; ++jr) {
      float xv[TP], bv[TN];
      load_f<TX, TP>(xs + jr * LXS, xv);
      load_f<TBC, TN>(bs + jr * LBS, bv);
      const float wj = wt[jr];
#pragma unroll
      for (int a = 0; a < TP; ++a) {
        const float xw = xv[a] * wj;
#pragma unroll
        for (int u = 0; u < TN; ++u) s[a][u] = fmaf(xw, bv[u], s[a][u]);
      }
    }
    __syncthreads();                   // the stage is refilled next
  }
  float* stg = reinterpret_cast<float*>(st.region);
  if (grp > 0) {
#pragma unroll
    for (int a = 0; a < TP; ++a)
#pragma unroll
      for (int u = 0; u < TN; ++u)
        stg[((grp - 1) * HP + tp * TP + a) * N + tn * TN + u] = s[a][u];
  }
  __syncthreads();
  if (grp == 0) {
    const float G = expf(last);
#pragma unroll
    for (int a = 0; a < TP; ++a)
#pragma unroll
      for (int u = 0; u < TN; ++u) {
        const int p = tp * TP + a, n = tn * TN + u;
        float v = s[a][u];
#pragma unroll
        for (int k = 1; k < KS; ++k) v += stg[((k - 1) * HP + p) * N + n];
        S[p * LDS + n] = G * S[p * LDS + n] + v;
      }
  }
}

template <typename TX, typename TBC, typename TY, int HP, int N>
__global__ void __launch_bounds__(SSD_NT, SSD_MIN_BLOCKS)
    ssd_scan_kernel(const TX* __restrict__ dtx, const float* __restrict__ cumg,
                    const TBC* __restrict__ Bm, const TBC* __restrict__ Cm,
                    const float* __restrict__ cb,
                    const float* __restrict__ init, TY* __restrict__ y,
                    float* __restrict__ final_state, int nh, int l, int cs) {
  using L = ScanLayout<TX, TBC, TY, HP, N>;
  constexpr int LDS = L::LDS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ntile = (cs + SSD_RT - 1) / SSD_RT, csp = ntile * SSD_RT;
  float* S = reinterpret_cast<float*>(smem);
  float* cum = reinterpret_cast<float*>(smem + L::s_bytes());
  unsigned char* region = smem + L::s_bytes() + L::cum_bytes(csp);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / nh, nc = l / cs;
  const long xoff = (long)bh * l * HP;  // dtx / y rows of this (b, h)
  const long loff = (long)bh * l;       // cum
  const long boff = (long)b * l * N;    // B / C rows of this batch row
  const long soff = (long)bh * HP * N;  // init / final state

  for (int e = tid; e < HP * N; e += SSD_NT)
    S[(e / N) * LDS + e % N] = init ? init[soff + e] : 0.f;

  for (int c = 0; c < nc; ++c) {
    const int r0 = c * cs;
    __syncthreads();                    // the last chunk is done with S/cum
    for (int e = tid; e < csp; e += SSD_NT)
      cum[e] = e < cs ? cumg[loff + r0 + e] : 0.f;
    __syncthreads();
    const float* cbc = cb + ((long)b * nc + c) * csp * csp;
    if constexpr (L::TC)
      phase_a_tc<L, TX, TBC, HP, N>(dtx + xoff + (long)r0 * HP,
                                    Cm + boff + (long)r0 * N, cbc,
                                    y + xoff + (long)r0 * HP, S, cum, region,
                                    cs, ntile);
    else
      phase_a_f32<L, TX, TBC, HP, N>(dtx + xoff + (long)r0 * HP,
                                     Cm + boff + (long)r0 * N, cbc,
                                     y + xoff + (long)r0 * HP, S, cum, region,
                                     cs, ntile);

    // phase B: S = e^{cum_last} S + sum_j e^{cum_last - cum_j} dtx_j^T B_j
    const float last = cum[cs - 1];
    __syncthreads();                    // phase A is done with region / cum
    for (int e = tid; e < csp; e += SSD_NT)
      cum[e] = e < cs ? __expf(last - cum[e]) : 0.f;
    const StateStages<L, TX, TBC, HP, N> st{
        region, dtx + xoff + (long)r0 * HP, Bm + boff + (long)r0 * N, cs};
    if constexpr (L::TCS)
      phase_b_tc<L, TX, TBC, HP, N>(st, S, cum, last, ntile);
    else
      phase_b_f32<L, TX, TBC, HP, N>(st, S, cum, last, ntile);
  }
  __syncthreads();
  for (int e = tid; e < HP * N; e += SSD_NT)
    final_state[soff + e] = S[(e / N) * LDS + e % N];
}

// ---------------------------------------------------------------------------
struct SsdArgs {
  const void *dtx, *cum, *B, *C, *init;
  void *y, *fin, *cb;
  int batch, nh, l, cs;
  cudaStream_t stream;
};

// Sets both kernels' shared-memory size for (cs) (once per instance and
// size); with `launch`, then launches the C B^T pass and the scan.
template <typename TX, typename TBC, typename TY, int HP, int N>
static int run(const SsdArgs& a, bool launch) {
  using L = ScanLayout<TX, TBC, TY, HP, N>;
  const int ntile = (a.cs + SSD_RT - 1) / SSD_RT, csp = ntile * SSD_RT;
  const size_t cb_smem = CbLayout<TBC, N>::bytes, smem = L::bytes(csp);
  static size_t cb_allowed = 48 * 1024, allowed = 48 * 1024;
  cudaError_t err;
  if (cb_smem > cb_allowed) {
    err = cudaFuncSetAttribute(ssd_cb_kernel<TBC, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cb_smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the next launch must not read it
      return (int)err;
    }
    cb_allowed = cb_smem;
  }
  if (smem > allowed) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<TX, TBC, TY, HP, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    allowed = smem;
  }
  if (!launch) return 0;
  const int nc = a.l / a.cs;
  ssd_cb_kernel<TBC, N>
      <<<dim3(ntile * (ntile + 1) / 2, nc, a.batch), SSD_NT, cb_smem,
         a.stream>>>((const TBC*)a.B, (const TBC*)a.C, (float*)a.cb, a.l,
                     a.cs, csp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<TX, TBC, TY, HP, N><<<a.batch * a.nh, SSD_NT, smem,
                                        a.stream>>>(
      (const TX*)a.dtx, (const float*)a.cum, (const TBC*)a.B,
      (const TBC*)a.C, (const float*)a.cb, (const float*)a.init, (TY*)a.y,
      (float*)a.fin, a.nh, a.l, a.cs);
  return (int)cudaGetLastError();
}

template <int HP, int N>
static int run_types(const SsdArgs& a, bool launch, int xb, int bcb, int yb) {
#define SSD_TYPES(TX, TBC, TY) return run<TX, TBC, TY, HP, N>(a, launch);
  if (xb) {
    if (bcb) {
      if (yb) { SSD_TYPES(bf16, bf16, bf16) } else { SSD_TYPES(bf16, bf16, float) }
    } else {
      if (yb) { SSD_TYPES(bf16, float, bf16) } else { SSD_TYPES(bf16, float, float) }
    }
  } else {
    if (bcb) {
      if (yb) { SSD_TYPES(float, bf16, bf16) } else { SSD_TYPES(float, bf16, float) }
    } else {
      if (yb) { SSD_TYPES(float, float, bf16) } else { SSD_TYPES(float, float, float) }
    }
  }
#undef SSD_TYPES
}

static int dispatch(const SsdArgs& a, bool launch, int hp, int n, int xb,
                    int bcb, int yb) {
  if (a.batch < 1 || a.nh < 1 || a.cs < 1 || a.l < a.cs || a.l % a.cs != 0)
    return (int)cudaErrorInvalidValue;
#define SSD_CASE(H, NN) \
  if (hp == H && n == NN) return run_types<H, NN>(a, launch, xb, bcb, yb);
  SSD_CASE(32, 16)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}

// Sets the shared-memory size the two kernels need at chunk cs; returns the
// error (a chunk too long for a block's shared memory fails here, before the
// wrapper allocates the C B^T scratch).
extern "C" int ssd_scan_prepare(int batch, int nh, int l, int cs, int hp,
                                int n, int x_bf16, int bc_bf16, int y_bf16) {
  SsdArgs a = {};
  a.batch = batch; a.nh = nh; a.l = l; a.cs = cs;
  return dispatch(a, false, hp, n, x_bf16, bc_bf16, y_bf16);
}

// Layouts: dtx / y [b, nh, l, hp], cum [b, nh, l] f32 (the inclusive
// cumsum of lt within each chunk of cs rows), B / C [b, l, n],
// init / fin [b, nh, hp, n] f32 (init may be null: zeros), cb the f32
// scratch [b, l / cs, csp, csp] (csp = cs rounded up to 64).  x_bf16,
// bc_bf16 and y_bf16 select bfloat16 (1) or float32 (0) for dtx, B/C and y;
// dtx, B and C 16-byte aligned.  Two launches on `stream` (C B^T, then the
// scan); returns the first error.
extern "C" int ssd_scan_launch(const void* dtx, const void* cum, const void* B,
                               const void* C, const void* init, void* y,
                               void* fin, void* cb, int batch, int nh, int l,
                               int cs, int hp, int n, int x_bf16, int bc_bf16,
                               int y_bf16, void* stream) {
  SsdArgs a = {dtx, cum, B, C, init, y, fin, cb, batch, nh, l, cs,
               (cudaStream_t)stream};
  return dispatch(a, true, hp, n, x_bf16, bc_bf16, y_bf16);
}
