// FC-PIM weight-streaming skinny matmul for Hopper (sm_90a):
//   y[m, N] = x[m, K] @ w[K, N], f32 accumulation, y in x's dtype.
//
// Replaces: src/repro/kernels/fc_gemv.py::fc_gemv (Pallas TPU kernel, body
// `_kernel`).  m = RLP*TLP is small on the decode path (the engine's
// max_slots), so the product does ~2*m FLOPs per weight element and is
// bound by the BYTES of `w` streamed from HBM (K*N*itemsize), far below
// the card's ~295 bf16 FLOP/byte ridge.
//
// Design against that bound:
//  * each block owns a tile of FC_BN = 128 output columns and one K slice;
//    a warp walks the slice's rows FC_UK at a time, lane l reading columns
//    4l..4l+3 of each row as one vector (when N % 4 == 0; else columns l,
//    l+32, l+64, l+96), so a warp reads a row's 128 columns in one
//    coalesced instruction, FC_UK rows of loads are in flight at once, and
//    every weight element is read from HBM exactly once;
//  * the m activation rows of the slice sit in shared memory (as f32) and
//    are broadcast to the warp; sums stay in f32 registers, FC_MT rows at a
//    time, so any m is served by looping over row tiles;
//  * K and N need not be multiples of anything: the ragged column tile and
//    K slice are bounds-checked;
//  * one column tile alone gives too few blocks to fill 132 SMs (7 for
//    N = 896, 1 for the k/v projections' N = 128), and a block that walks
//    a long K serially waits on one load latency after another, so the
//    wrapper splits K into slices of FC_NW * FC_UK rows over gridDim.y: a
//    block's warps then issue ALL their weight loads at once.  Each split
//    writes f32 partial sums (they stay in the 50 MB L2) and a second
//    kernel adds them IN SPLIT ORDER, so results are the same from run to
//    run (no atomics).
// Simple on purpose: no wgmma, TMA or cp.async pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FC_BN 128        // output columns per block (32 lanes x 4)
#define FC_NW 8          // warps per block
#define FC_MT 8          // activation rows per register tile
#define FC_UK 16         // weight rows a warp loads before using any
#define FC_KS_MAX 256    // longest K slice one block holds in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// four adjacent elements of T as one 8-byte (bf16) or 16-byte (f32) load
template <typename T> struct Vec4;
template <> struct Vec4<__nv_bfloat16> {
  typedef uint2 Raw;
  static __device__ __forceinline__ Raw zero() { return make_uint2(0u, 0u); }
};
template <> struct Vec4<float> {
  typedef uint4 Raw;
  static __device__ __forceinline__ Raw zero() {
    return make_uint4(0u, 0u, 0u, 0u);
  }
};

// grid = (cdiv(N, FC_BN), splits); block = FC_NW * 32 threads.
// splits == 1: writes y directly; else writes partial[split, m, N] (f32).
template <typename T, bool VEC4>
__global__ void __launch_bounds__(FC_NW * 32)
fc_gemv_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, float* __restrict__ partial,
               int m, int K, int N, int k_split) {
  __shared__ float xs[FC_MT][FC_KS_MAX];
  __shared__ float red[FC_NW][FC_MT][FC_BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * FC_BN;
  const int split = blockIdx.y;
  const int k0 = split * k_split;
  const int k1 = min(K, k0 + k_split);
  const int kn = k1 - k0;
  // column of the tile lane `lane` owns in slot j: four adjacent columns
  // (one 4-element vector load per row) when N % 4 == 0, else strided
  auto col = [lane](int j) { return VEC4 ? 4 * lane + j : lane + 32 * j; };

  for (int mt = 0; mt < m; mt += FC_MT) {
    const int rows = min(FC_MT, m - mt);
    // stage the row tile's K slice of x (zero rows past m)
#pragma unroll
    for (int r = 0; r < FC_MT; ++r)
      for (int kk = threadIdx.x; kk < kn; kk += blockDim.x)
        xs[r][kk] = r < rows ? to_f32(x[(size_t)(mt + r) * K + k0 + kk]) : 0.f;
    __syncthreads();

    float acc[FC_MT][4];
#pragma unroll
    for (int r = 0; r < FC_MT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    // warp w takes FC_UK consecutive rows at a time; all FC_UK * 4 loads
    // are issued before the first is used (memory-level parallelism)
    for (int kk0 = warp * FC_UK; kk0 < kn; kk0 += FC_NW * FC_UK) {
      float wv[FC_UK][4];
#pragma unroll
      for (int u = 0; u < FC_UK; ++u) {
        const T* wrow = w + (size_t)(k0 + kk0 + u) * N + n0;
        if (VEC4) {
          typename Vec4<T>::Raw raw = Vec4<T>::zero();
          if (kk0 + u < kn && n0 + col(3) < N)
            raw = *reinterpret_cast<const typename Vec4<T>::Raw*>(
                wrow + col(0));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[u][j] = to_f32(e[j]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[u][j] = (kk0 + u < kn && n0 + col(j) < N)
                           ? to_f32(wrow[col(j)]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < FC_UK; ++u) {
        if (kk0 + u >= kn) break;
#pragma unroll
        for (int r = 0; r < FC_MT; ++r) {
          const float xv = xs[r][kk0 + u];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[r][j] = fmaf(xv, wv[u][j], acc[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < FC_MT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[warp][r][col(j)] = acc[r][j];
    __syncthreads();

    // cross-warp sum in warp order; thread t owns column t of the tile
    for (int i = threadIdx.x; i < FC_MT * FC_BN; i += blockDim.x) {
      const int r = i / FC_BN, c = i - r * FC_BN;
      if (r < rows && n0 + c < N) {
        float s = 0.f;
#pragma unroll
        for (int ww = 0; ww < FC_NW; ++ww) s += red[ww][r][c];
        const size_t o = (size_t)(mt + r) * N + n0 + c;
        if (gridDim.y == 1) {
          y[o] = from_f32<T>(s);
        } else {
          partial[(size_t)split * m * N + o] = s;
        }
      }
    }
    __syncthreads();
  }
}

// y[i] = sum over splits, added in split order (deterministic)
template <typename T>
__global__ void fc_gemv_reduce_kernel(const float* __restrict__ partial,
                                      T* __restrict__ y, int mn, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) s += partial[(size_t)sp * mn + i];
    y[i] = from_f32<T>(s);
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* y, void* partial, int m,
                  int K, int N, int k_split, cudaStream_t stream) {
  const int splits = (K + k_split - 1) / k_split;
  dim3 grid((N + FC_BN - 1) / FC_BN, splits);
  // vector loads need every row start aligned to 4 elements
  const bool vec4 = N % 4 == 0 && (uintptr_t)w % (4 * sizeof(T)) == 0;
  if (vec4)
    fc_gemv_kernel<T, true><<<grid, FC_NW * 32, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, (float*)partial, m, K, N, k_split);
  else
    fc_gemv_kernel<T, false><<<grid, FC_NW * 32, 0, stream>>>(
        (const T*)x, (const T*)w, (T*)y, (float*)partial, m, K, N, k_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int mn = m * N;
  int blocks = (mn + 255) / 256;
  if (blocks > 1024) blocks = 1024;
  fc_gemv_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
      (const float*)partial, (T*)y, mn, splits);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.  `partial` holds splits*m*N floats and
// may be null when k_split >= K.  Returns cudaGetLastError() of the launches.
extern "C" int fc_gemv_launch(const void* x, const void* w, void* y,
                              void* partial, int m, int K, int N, int k_split,
                              int dtype, void* stream) {
  if (m < 1 || K < 1 || N < 1 || k_split < 1 || k_split > FC_KS_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(x, w, y, partial, m, K, N, k_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, y, partial, m, K, N, k_split, s);
  return (int)cudaErrorInvalidValue;
}
