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
// cs=256) the kernel reads dtx (f32) and writes y (bf16) once, and does
// ~13 GFLOP of f32 products (C B^T, its product with dtx, the inter-chunk
// term and the state update); on CUDA cores that is the larger of the two
// bounds (see PERF.md).
//
// Design:
//  * one block per (batch, head) loops over the chunks and carries S in
//    shared memory: blocks carry nothing between them, and 8 x 64 = 512
//    blocks fill the 132 SMs;
//  * a chunk (256 rows at full width) does not fit a block's 227 KB as the
//    Pallas kernel holds it (C B^T alone is 256 KB in f32), so rows are
//    tiled SSD_RT = 64 at a time: for each row tile i, the tiles j <= i of
//    B and dtx are loaded in turn and (C_i B_j^T o L_ij) dtx_j is added to
//    the tile's f32 registers; the state update then walks the tiles again;
//  * exp is taken only of j <= i terms (seg = cum_i - cum_j > 0 for j > i
//    would overflow, and inf * 0 is NaN), rows past cs are zero and masked;
//  * every product is a 16 x 16 thread grid over the output, each thread
//    owning rows ty + 16a and columns tx + 16c; shared rows are padded to
//    an odd length so the operands read across a row are conflict-free;
//  * dtx, B/C and y are each f32 or bf16 at run time (converted on load or
//    store, sums in f32), so one build serves the f32 and bf16 models; the
//    (hp, n) pairs of the three shape sets are template instances.
// Simple on purpose: CUDA-core FMAs, no wgmma, TMA or cp.async yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSD_RT 64        // chunk rows per tile
#define SSD_NT 256       // threads per block: a 16 x 16 grid

__device__ __forceinline__ float load_f(const void* p, long i, int bf16) {
  return bf16 ? __bfloat162float(((const __nv_bfloat16*)p)[i])
              : ((const float*)p)[i];
}

__device__ __forceinline__ void store_f(void* p, long i, float v, int bf16) {
  if (bf16)
    ((__nv_bfloat16*)p)[i] = __float2bfloat16(v);
  else
    ((float*)p)[i] = v;
}

// rows [0, SSD_RT) of a [rows, cols] row-major source into dst (leading
// dimension ld), as f32; rows at or past `valid` are zero
__device__ __forceinline__ void load_tile(const void* src, long base, int cols,
                                          int valid, int bf16, float* dst,
                                          int ld) {
  for (int e = threadIdx.x; e < SSD_RT * cols; e += SSD_NT) {
    const int r = e / cols, c = e % cols;
    dst[r * ld + c] =
        r < valid ? load_f(src, base + (long)r * cols + c, bf16) : 0.f;
  }
}

template <int HP, int N>
__global__ void __launch_bounds__(SSD_NT)
    ssd_scan_kernel(const void* __restrict__ dtx, const float* __restrict__ cumg,
                    const void* __restrict__ Bm, const void* __restrict__ Cm,
                    const float* __restrict__ init, void* __restrict__ y,
                    float* __restrict__ final_state, int nh, int l, int cs,
                    int x_bf16, int bc_bf16, int y_bf16) {
  constexpr int LDN = N + 1, LDH = HP + 1, LDR = SSD_RT + 1;
  constexpr int TH = HP / 16, TN = N / 16;
  extern __shared__ float smem[];
  float* S = smem;                      // [HP][LDN]   the carried state
  float* Ct = S + HP * LDN;             // [RT][LDN]   C rows of tile i
  float* Bt = Ct + SSD_RT * LDN;        // [RT][LDN]   B rows of tile j
  float* Xt = Bt + SSD_RT * LDN;        // [RT][LDH]   dtx rows of tile j
  float* Pt = Xt + SSD_RT * LDH;        // [RT][LDR]   C_i B_j^T o L_ij
  float* cum = Pt + SSD_RT * LDR;       // [cs]  this chunk's cumsum

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x, b = bh / nh;
  const long xoff = (long)bh * l * HP;  // dtx / y rows of this (b, h)
  const long loff = (long)bh * l;       // cum
  const long boff = (long)b * l * N;    // B / C rows of this batch row
  const long soff = (long)bh * HP * N;  // init / final state

  for (int e = tid; e < HP * N; e += SSD_NT)
    S[(e / N) * LDN + e % N] = init ? init[soff + e] : 0.f;

  const int nc = l / cs, ntile = (cs + SSD_RT - 1) / SSD_RT;
  for (int c = 0; c < nc; ++c) {
    const int r0 = c * cs;
    __syncthreads();                    // the last chunk is done with cum/S
    for (int e = tid; e < cs; e += SSD_NT) cum[e] = cumg[loff + r0 + e];
    __syncthreads();

    for (int it = 0; it < ntile; ++it) {
      const int i0 = it * SSD_RT;
      const int ivalid = min(SSD_RT, cs - i0);
      load_tile(Cm, boff + (long)(r0 + i0) * N, N, ivalid, bc_bf16, Ct, LDN);
      __syncthreads();

      // inter-chunk term from the carried state: e^{cum_i} C_i . S_p
      float acc[4][TH];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < TH; ++q) acc[a][q] = 0.f;
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        float av[4], bv[TH];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = Ct[(ty + 16 * a) * LDN + k];
#pragma unroll
        for (int q = 0; q < TH; ++q) bv[q] = S[(tx + 16 * q) * LDN + k];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < TH; ++q) acc[a][q] += av[a] * bv[q];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const float g = i < ivalid ? expf(cum[i0 + i]) : 0.f;
#pragma unroll
        for (int q = 0; q < TH; ++q) acc[a][q] *= g;
      }

      // intra-chunk terms of the tiles j <= i
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * SSD_RT;
        const int jvalid = min(SSD_RT, cs - j0);
        load_tile(Bm, boff + (long)(r0 + j0) * N, N, jvalid, bc_bf16, Bt, LDN);
        load_tile(dtx, xoff + (long)(r0 + j0) * HP, HP, jvalid, x_bf16, Xt,
                  LDH);
        __syncthreads();
        float p[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int q = 0; q < 4; ++q) p[a][q] = 0.f;
#pragma unroll 4
        for (int k = 0; k < N; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = Ct[(ty + 16 * a) * LDN + k];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = Bt[(tx + 16 * q) * LDN + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < 4; ++q) p[a][q] += av[a] * bv[q];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = j0 + tx + 16 * q;
            // only j <= i < cs: exp never sees a positive exponent
            const float w = (j <= i && i < cs) ? expf(cum[i] - cum[j]) : 0.f;
            Pt[(ty + 16 * a) * LDR + tx + 16 * q] = p[a][q] * w;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int j = 0; j < SSD_RT; ++j) {
          float av[4], bv[TH];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = Pt[(ty + 16 * a) * LDR + j];
#pragma unroll
          for (int q = 0; q < TH; ++q) bv[q] = Xt[j * LDH + tx + 16 * q];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int q = 0; q < TH; ++q) acc[a][q] += av[a] * bv[q];
        }
        __syncthreads();                // Bt / Xt / Pt are reloaded next
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        if (i < ivalid) {
#pragma unroll
          for (int q = 0; q < TH; ++q)
            store_f(y, xoff + (long)(r0 + i0 + i) * HP + tx + 16 * q,
                    acc[a][q], y_bf16);
        }
      }
    }

    // state update: S = e^{cum_last} S + sum_j e^{cum_last - cum_j} dtx_j B_j
    const float last = cum[cs - 1];
    float s[TH][TN];
    const float g = expf(last);
#pragma unroll
    for (int a = 0; a < TH; ++a)
#pragma unroll
      for (int q = 0; q < TN; ++q)
        s[a][q] = g * S[(ty + 16 * a) * LDN + tx + 16 * q];
    for (int jt = 0; jt < ntile; ++jt) {
      const int j0 = jt * SSD_RT;
      const int jvalid = min(SSD_RT, cs - j0);
      // Pt's first column holds this tile's decay-to-end weights
      if (tid < SSD_RT)
        Pt[tid * LDR] = tid < jvalid ? expf(last - cum[j0 + tid]) : 0.f;
      __syncthreads();
      load_tile(Bm, boff + (long)(r0 + j0) * N, N, jvalid, bc_bf16, Bt, LDN);
      for (int e = tid; e < SSD_RT * HP; e += SSD_NT) {
        const int r = e / HP, cc = e % HP;
        Xt[r * LDH + cc] =
            r < jvalid ? load_f(dtx, xoff + (long)(r0 + j0 + r) * HP + cc,
                                x_bf16) * Pt[r * LDR]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < SSD_RT; ++j) {
        float av[TH], bv[TN];
#pragma unroll
        for (int a = 0; a < TH; ++a) av[a] = Xt[j * LDH + ty + 16 * a];
#pragma unroll
        for (int q = 0; q < TN; ++q) bv[q] = Bt[j * LDN + tx + 16 * q];
#pragma unroll
        for (int a = 0; a < TH; ++a)
#pragma unroll
          for (int q = 0; q < TN; ++q) s[a][q] += av[a] * bv[q];
      }
      __syncthreads();
    }
#pragma unroll
    for (int a = 0; a < TH; ++a)
#pragma unroll
      for (int q = 0; q < TN; ++q) S[(ty + 16 * a) * LDN + tx + 16 * q] = s[a][q];
  }
  __syncthreads();
  for (int e = tid; e < HP * N; e += SSD_NT)
    final_state[soff + e] = S[(e / N) * LDN + e % N];
}

// Dynamic shared memory of one block, in the kernel's carve-up: the state
// [HP][N+1], the C and B row tiles [RT][N+1], the dtx tile [RT][HP+1], the
// masked C B^T tile [RT][RT+1] and the chunk's cumsum [cs], all f32.
template <int HP, int N>
static int smem_bytes(int cs) {
  return (int)sizeof(float) *
         (HP * (N + 1) + 2 * SSD_RT * (N + 1) + SSD_RT * (HP + 1) +
          SSD_RT * (SSD_RT + 1) + cs);
}

template <int HP, int N>
static int launch(const void* dtx, const float* cum, const void* B,
                  const void* C, const float* init, void* y, float* fin,
                  int batch, int nh, int l, int cs, int xb, int bcb, int yb,
                  cudaStream_t stream) {
  // a chunk too long for a block's shared memory fails here, as an error
  const int smem = smem_bytes<HP, N>(cs);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<HP, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch must not read it
    return (int)err;
  }
  ssd_scan_kernel<HP, N><<<batch * nh, SSD_NT, smem, stream>>>(
      dtx, cum, B, C, init, y, fin, nh, l, cs, xb, bcb, yb);
  return (int)cudaGetLastError();
}

// Layouts: dtx / y [b, nh, l, hp], cum [b, nh, l] f32 (the inclusive
// cumsum of lt within each chunk of cs rows), B / C [b, l, n],
// init / fin [b, nh, hp, n] f32 (init may be null: zeros).  x_bf16, bc_bf16
// and y_bf16 select bfloat16 (1) or float32 (0) for dtx, B/C and y.
// Returns the error of setting the shared-memory size, else
// cudaGetLastError() of the launch.
extern "C" int ssd_scan_launch(const void* dtx, const void* cum, const void* B,
                               const void* C, const void* init, void* y,
                               void* fin, int batch, int nh, int l, int cs,
                               int hp, int n, int x_bf16, int bc_bf16,
                               int y_bf16, void* stream) {
  if (batch < 1 || nh < 1 || cs < 1 || l < cs || l % cs != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* cumf = (const float*)cum;
  const float* initf = (const float*)init;
  float* finf = (float*)fin;
#define SSD_CASE(H, NN)                                                    \
  if (hp == H && n == NN)                                                  \
    return launch<H, NN>(dtx, cumf, B, C, initf, y, finf, batch, nh, l, cs,\
                         x_bf16, bc_bf16, y_bf16, s);
  SSD_CASE(32, 16)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
