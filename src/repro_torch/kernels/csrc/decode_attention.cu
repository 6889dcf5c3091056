// Attn-PIM flash-decode GQA attention over a dense KV slab, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (Pallas
// TPU kernel, body `_kernel`).  q/out [b, nkv, R, hd], K/V [b, S, nkv, hd],
// lens [b]; the body, its bound and its design are in decode_attention.cuh,
// shared with the paged kernel (paged_decode_attention.cu).
#include "decode_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() of the launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lens,
                                       void* out, int b, int nkv, int R, int hd,
                                       int S, int q_rows, int dtype,
                                       void* stream) {
  if (S < 1) return (int)cudaErrorInvalidValue;
  DenseKV kv{S};
  return launch_flash_decode(q, k, v, lens, out, b, nkv, R, hd, q_rows, dtype,
                             kv, stream);
}
