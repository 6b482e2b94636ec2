// One-token GQA attention over an int8 KV cache, for Hopper (sm_90a): the
// kernel body shared by the contiguous and the paged cache.
//
// Included by decode_attention_int8.cu (replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention_int8) and
// decode_attention_int8_paged.cu (replaces ::decode_attention_int8_paged).
// The two differ only in where slot s of row b lives, which the `Slots`
// functor answers with a physical slot index p: K/V row (p, kvh) starts at
// (p * KV + kvh) * HD, its scale at p * KV + kvh.  Everything else -- the
// 128-slot logical tiles, the online-softmax update, the skipped tiles past
// valid_len, the final acc / max(l, 1e-30) -- is this one body, so a row
// read through a block table computes exactly the bits of the same row
// read from a contiguous cache.
//
// Shapes:
//   q          (B, KV, G, hd)  bf16 or f32 -- one query token, grouped per kv head
//   k, v       (P, KV, hd)     int8 cache slots, P physical slots
//   ks, vs     (P, KV)         f32 per-(slot, head) scales
//   valid_len  (B,)            int32 -- logical slots < valid_len[b] take part
//   k_new,     (B, KV, hd)     f32, optional: the append column (the current
//   v_new                      token's k/v, folded in after the cache)
//   out        (B, KV, G, hd)  f32
//
// The TPU kernel swept the slot tiles as the sequential grid axis, carrying
// the online-softmax state in scratch.  Here one block owns one (b, kv head)
// and the sweep is a loop inside the block; nothing crosses blocks.  Per
// tile of TS logical slots:
//   1. each thread owns one slot, reads its int8 K row (16-byte loads) and
//      computes the G scores against q (staged in shared memory), times
//      sm_scale * ks -- the k scale folds into the score column, so no
//      dequantized K is ever written;
//   2. the V tile is staged in shared memory as int8;
//   3. one warp per query row updates the running max m and sum l, and
//      stores p * vs -- the v scale folds into the probability column;
//   4. thread d updates acc[g][d] for all g from the staged V tile.
// Tiles wholly past valid_len[b] are skipped: in the reference they only
// add masked zeros, so skipping them changes no bit of the result.  At the
// end the optional append column joins the softmax as one more score, and
// the output is acc / max(l, 1e-30), as the reference does.
//
// What bounds it: the cache bytes it must read (int8 K and V of the valid
// slots plus their scales).  At decode those are tens of KB per (b, head),
// so at the serving shapes launch latency dominates, and only B * KV
// blocks run (16 at full width on 132 SMs).  Splitting the slot sweep
// across blocks is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TS = THREADS;  // slots per tile: one slot per thread in phase 1
constexpr int MAXG = 16;
constexpr int MAXHD = 128;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Contiguous cache (B, S, KV, hd): slot s of row b is physical slot b * S + s.
struct ContiguousSlots {
  int S;
  __device__ __forceinline__ size_t operator()(int b, int s) const {
    return (size_t)b * S + s;
  }
};

// Paged cache (NB, bs, KV, hd): slot s of row b lies in block
// tables[b, s / bs] at offset s % bs.
struct PagedSlots {
  const int* tables;  // (B, MB) int32, entries in [0, NB)
  int MB, BS;
  __device__ __forceinline__ size_t operator()(int b, int s) const {
    return (size_t)tables[(size_t)b * MB + s / BS] * BS + s % BS;
  }
};

// S is the row's logical capacity (contiguous: the cache length; paged:
// MB * bs); valid_len is clamped to it.
template <typename QT, typename Slots>
__global__ void __launch_bounds__(THREADS)
decode_attention_int8_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v, const float* __restrict__ ks,
                             const float* __restrict__ vs, const int* __restrict__ valid_len,
                             const float* __restrict__ k_new, const float* __restrict__ v_new,
                             float* __restrict__ out, int S, int KV, int G, int HD,
                             float sm_scale, Slots slots) {
  __shared__ float qs[MAXG][MAXHD];
  __shared__ float sc[MAXG][TS];  // scores, then p * vs
  __shared__ __align__(16) int8_t vt[TS][MAXHD];
  __shared__ float m_run[MAXG], l_run[MAXG], alpha[MAXG];

  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t head = (size_t)b * KV + kvh;

  const QT* qb = q + head * G * HD;
  for (int i = tid; i < G * HD; i += THREADS) qs[i / HD][i % HD] = to_f32(qb[i]);
  if (tid < G) {
    m_run[tid] = NEG_INF;
    l_run[tid] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  const int vl = min(max(valid_len[b], 0), S);
  __syncthreads();

  // element (p, kvh, :) of k / v starts at (p * KV + kvh) * HD, its scale
  // at p * KV + kvh, for p = slots(b, s)
  const int8_t* kh = k + (size_t)kvh * HD;
  const int8_t* vh = v + (size_t)kvh * HD;
  const float* ksh = ks + kvh;
  const float* vsh = vs + kvh;
  const size_t slot_stride = (size_t)KV * HD;
  const int vecs = HD / 16;

  for (int s0 = 0; s0 < vl; s0 += TS) {
    // 1. scores: thread tid owns slot s0 + tid
    const int s = s0 + tid;
    if (s < vl) {
      const size_t p = slots(b, s);
      float dots[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) dots[g] = 0.f;
      const int4* kr = reinterpret_cast<const int4*>(kh + p * slot_stride);
      for (int c = 0; c < vecs; ++c) {
        const int4 pk = kr[c];
        const int words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          // byte e of the 16, sign-extended (little-endian)
          const float kf = float((words[e >> 2] << (24 - 8 * (e & 3))) >> 24);
          const int d = c * 16 + e;
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) dots[g] = fmaf(qs[g][d], kf, dots[g]);
        }
      }
      const float kscale = ksh[p * KV];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) sc[g][tid] = dots[g] * sm_scale * kscale;
    } else {
      for (int g = 0; g < G; ++g) sc[g][tid] = NEG_INF;
    }
    // 2. stage the V tile (rows past vl are never read)
    const int rows = min(TS, vl - s0);
    for (int i = tid; i < rows * vecs; i += THREADS) {
      const int r = i / vecs, c = i % vecs;
      reinterpret_cast<int4*>(&vt[r][0])[c] =
          reinterpret_cast<const int4*>(vh + slots(b, s0 + r) * slot_stride)[c];
    }
    __syncthreads();
    // 3. online softmax, one warp per query row
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int j = lane; j < TS; j += 32) mx = fmaxf(mx, sc[g][j]);
      mx = warp_max(mx);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < TS; j += 32) {
        const bool ok = j < rows;
        const float p = ok ? expf(sc[g][j] - m_new) : 0.f;
        sum += p;
        sc[g][j] = ok ? p * vsh[slots(b, s0 + j) * KV] : 0.f;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        l_run[g] = l_run[g] * a + sum;
        m_run[g] = m_new;
        alpha[g] = a;
      }
    }
    __syncthreads();
    // 4. acc[g][d] = acc[g][d] * alpha[g] + sum_j (p * vs)[g][j] * v[j][d]
    if (tid < HD) {
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] *= alpha[g];
      for (int j = 0; j < rows; ++j) {
        const float vf = float(vt[j][tid]);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) acc[g] = fmaf(sc[g][j], vf, acc[g]);
      }
    }
    __syncthreads();
  }

  if (k_new != nullptr) {
    // append column: the current token's k/v join the softmax last; with
    // an empty cache (m = -1e30) the output is exactly v_new
    const float* knb = k_new + head * HD;
    const float* vnb = v_new + head * HD;
    for (int g = warp; g < G; g += WARPS) {
      float d = 0.f;
      for (int j = lane; j < HD; j += 32) d += qs[g][j] * knb[j];
      d = warp_sum(d);
      if (lane == 0) {
        const float s_new = d * sm_scale;
        const float m_fin = fmaxf(m_run[g], s_new);
        const float a = expf(m_run[g] - m_fin);
        const float p_new = expf(s_new - m_fin);
        l_run[g] = l_run[g] * a + p_new;
        alpha[g] = a;
        sc[g][0] = p_new;
      }
    }
    __syncthreads();
    if (tid < HD) {
      const float vn = vnb[tid];
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = acc[g] * alpha[g] + sc[g][0] * vn;
    }
  }

  if (tid < HD) {
    float* ob = out + head * G * HD;
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) ob[(size_t)g * HD + tid] = acc[g] / fmaxf(l_run[g], 1e-30f);
  }
}

// Launch over (KV, B) blocks on `stream`; q is bf16 when q_bf16 is set,
// else f32.  Returns cudaGetLastError() after the launch.
template <typename Slots>
int launch_decode_attention_int8(const void* q, int q_bf16, const void* k, const void* v,
                                 const void* ks, const void* vs, const void* valid_len,
                                 const void* k_new, const void* v_new, void* out, int B,
                                 int S, int KV, int G, int HD, float sm_scale, Slots slots,
                                 void* stream) {
  const dim3 grid(KV, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k8 = static_cast<const int8_t*>(k);
  const auto* v8 = static_cast<const int8_t*>(v);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vl = static_cast<const int*>(valid_len);
  const auto* kn = static_cast<const float*>(k_new);
  const auto* vn = static_cast<const float*>(v_new);
  auto* o = static_cast<float*>(out);
  if (q_bf16)
    decode_attention_int8_kernel<__nv_bfloat16, Slots><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), k8, v8, ksf, vsf, vl, kn, vn, o, S, KV, G, HD,
        sm_scale, slots);
  else
    decode_attention_int8_kernel<float, Slots><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(q), k8, v8, ksf, vsf, vl, kn, vn, o, S, KV, G, HD, sm_scale,
        slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
