// One-token GQA attention over a contiguous int8 KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention_int8 (body _decode_attn_kernel).  The kernel body, its
// design (each row's slots split into chunks across blocks, combined in
// chunk order in the same launch) and what bounds it are in
// decode_attention_int8.cuh, shared with the paged cache's kernel; here
// slot s of row b is cache row (b, s):
//   k, v       (B, S, KV, hd)  int8 cache slots
//   ks, vs     (B, S, KV)      f32 per-(token, head) scales
#include "decode_attention_int8.cuh"

// Plain C entry point, bound with ctypes.  k_new / v_new may both be null
// (no append column).  work and counters are the split's scratch (sizes in
// the .cuh); the counters must be 0, and the kernel leaves them so.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_int8(const void* q, int q_bf16, const void* k, const void* v,
                                     const void* ks, const void* vs, const void* valid_len,
                                     const void* k_new, const void* v_new, void* out,
                                     void* work, void* counters, int B, int S, int KV, int G,
                                     int HD, float sm_scale, void* stream) {
  return launch_decode_attention_int8(q, q_bf16, k, v, ks, vs, valid_len, k_new, v_new, out,
                                      work, counters, B, S, KV, G, HD, sm_scale,
                                      ContiguousSlots{S}, stream);
}
