// One-token GQA attention over a paged int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention_int8_paged.  Shapes:
//   k, v          (NB, bs, KV, hd)  int8 physical blocks
//   ks, vs        (NB, bs, KV)      f32 per-(slot, head) scales
//   block_tables  (B, MB)           int32: logical slot s of row b lives in
//                                   block tables[b, s / bs] at offset s % bs
//   valid_len     (B,)              int32, in logical slots (< MB * bs)
// and q, k_new, v_new, out, work and counters as for the contiguous kernel.
//
// The TPU kernel made the block table a scalar-prefetch operand and gave
// each physical block one step of the sequential grid axis.  Here the
// table only changes addressing: the body of decode_attention_int8.cuh cuts
// each row into the same LOGICAL chunks and warp tiles as the contiguous
// kernel, and one lane per slot maps it through the table once per tile
// when the tile's K/V rows and scales are fetched.  So whatever the block
// size, a row computes the very bits it would from the gathered contiguous
// view -- which the engine's bit parity with its contiguous batch-1
// reference needs.  Table entries past a row's frontier (trash block 0) are
// never read: no slot at or past valid_len is touched.
//
// What bounds it: as the contiguous kernel, the valid K/V bytes and their
// scales, plus one table entry per valid slot.
#include "decode_attention_int8.cuh"

// Plain C entry point, bound with ctypes.  k_new / v_new may both be null
// (no append column).  Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_int8_paged(const void* q, int q_bf16, const void* k,
                                           const void* v, const void* ks, const void* vs,
                                           const void* valid_len, const void* block_tables,
                                           const void* k_new, const void* v_new, void* out,
                                           void* work, void* counters, int B, int MB, int BS,
                                           int KV, int G, int HD, float sm_scale,
                                           void* stream) {
  const PagedSlots slots{static_cast<const int*>(block_tables), MB, BS};
  return launch_decode_attention_int8(q, q_bf16, k, v, ks, vs, valid_len, k_new, v_new, out,
                                      work, counters, B, MB * BS, KV, G, HD, sm_scale, slots,
                                      stream);
}
