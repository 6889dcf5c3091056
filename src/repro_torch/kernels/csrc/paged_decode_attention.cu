// Attn-PIM flash-decode GQA attention over bank-row pages, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py::
// paged_decode_attention (Pallas TPU kernel, body `_paged_kernel`, which
// runs the dense body with block_k = page_size and resolves the physical
// page tables[i, kb] in the K/V index_map before each DMA).
//
// q/out [b, nkv, R, hd], K/V pages [num_pages, page_size, nkv, hd], lens
// [b], tables [b, max_blocks] int32.  The body is decode_attention.cuh's,
// with the PagedKV addressing policy: each K/V row is fetched from the page
// its table entry names, at logical position j, in the dense kernel's
// AT_BK = 32 tiles and the dense kernel's splits (the split count comes
// from the shapes alone, never from the capacity), so on identical contents
// the output is bit-equal to the dense kernel's for any page size.
//
// Garbage-page contract: the KV loop stops at
// cdiv(min(lens[b], max_blocks * page_size), AT_BK), and rows at or past
// the length are zero-filled through an address clamped to the last live
// row, so a table entry past a request's length is never read; idle slots'
// entries (the garbage page 0) never reach the output.
//
// Bound on this card: BYTES — 2 * sum(lens) * nkv * hd * itemsize of K/V,
// plus q and out (2 * b * nkv * R * hd * itemsize) and the table entries
// read (cdiv(lens, page_size) * 4 bytes per request).  The design is the
// shared split-S one: NS splits per (request, KV head, row tile), each a
// short chain of cp.async double-buffered tiles (bf16 on tensor cores),
// merged by a second kernel.  A tile's table entries are loaded one tile
// ahead of its copies; only the first tile of a split waits for its
// entries.  Not done yet: TMA (a page is a natural TMA box), wgmma, a
// deeper ring.
#include "decode_attention.cuh"

// dtype: 0 = float32, 1 = bfloat16; row_tile in {4, 8, 16}; ns splits, with
// `part` f32 scratch of b * nkv * ns * R * (hd + 2) floats when ns > 1.
// Launches the split pass and, when ns > 1, the merge.  Returns the first
// non-zero cudaGetLastError() of the launches.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, const void* lens,
    const void* tables, void* out, void* part, int b, int nkv, int R, int hd,
    int page_size, int max_blocks, int q_rows, int row_tile, int ns,
    int dtype, void* stream) {
  if (page_size < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  PagedKV kv{(const int*)tables, page_size, max_blocks};
  return launch_flash_decode(q, k_pages, v_pages, lens, out, part, b, nkv, R,
                             hd, q_rows, row_tile, ns, dtype, kv, stream);
}
