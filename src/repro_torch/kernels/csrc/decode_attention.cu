// Attn-PIM flash-decode GQA attention over a dense KV slab, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// TPU kernel, body `_kernel`).  q/out [b, nkv, R, hd], K/V [b, S, nkv, hd],
// lens [b]; the body, its bound and its split-S design are in
// decode_attention.cuh, shared with the paged kernel
// (paged_decode_attention.cu).
#include "decode_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16; row_tile in {4, 8, 16}; ns splits, with
// `part` f32 scratch of b * nkv * ns * R * (hd + 2) floats when ns > 1.
// Launches the split pass and, when ns > 1, the merge.  Returns the first
// non-zero cudaGetLastError() of the launches.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lens,
                                       void* out, void* part, int b, int nkv,
                                       int R, int hd, int S, int q_rows,
                                       int row_tile, int ns, int dtype,
                                       void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  DenseKV kv{S};
  return launch_flash_decode(q, k, v, lens, out, part, b, nkv, R, hd, q_rows,
                             row_tile, ns, dtype, kv, stream);
}
