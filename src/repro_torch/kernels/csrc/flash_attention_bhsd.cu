// Fused causal / sliding-window attention for Hopper (sm_90a):
// out = softmax(mask(q k^T * sm_scale)) v, f32 inside, bf16 or f32 out.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention_bhsd (body
// _flash_kernel).  q is (BH, Sq, hd), k and v are (BH, Skv, hd), all bf16
// with the heads already expanded to H; hd is a multiple of 8 up to 256.
// A key at position kpos is seen by the query at position qpos when
// kpos < kv_len, and (causal) kpos <= qpos, and (window > 0)
// kpos > qpos - window.  Masked scores are -1e30 and their probabilities
// 0; the output is acc / max(l, 1e-30), so a row with no valid key is 0.
//
// What bounds it: the bytes are q + k + v + out, read and written once;
// the operations are 4 * hd per (query, valid key) pair.  At the service
// curve's prefill (BH = 384, Sq = Skv = 32, hd 128) that is 12.6 MB and
// 0.4 GFLOP per call: bytes and latency bound it, a few microseconds.  The
// design keeps what the TPU kernel keeps out of device memory -- the
// scores, the probabilities and the running max / sum / context -- in
// registers, and puts the products on the tensor cores:
//
// - One block owns one bh and BQ = 32 queries: two groups of 16 query
//   rows.  The TPU grid walks the KV blocks in order on one core, carrying
//   acc/m/l in VMEM scratch; here the KV sweep is a loop inside the block.
//   The kernel is templated on the largest head size it takes, HD = 128
//   or 256.  At HD = 128 a group is one warp: at the serve shapes that is
//   384 blocks of 64 threads and 43 KB of shared memory, all resident at
//   once on the 132 SMs (five fit on one).  At HD = 256 (recurrentgemma's
//   head_dim) a group is two warps, 128 threads a block: each warp of the
//   pair computes the whole S = Q K^T over the 256 dims and the softmax
//   (the same instructions on the same data, so the same bits in both),
//   then P V for its own 128 context columns, so each thread keeps the
//   hd-128 instance's 16 n8 tiles of context and spills nothing.  Its
//   rows of 264 elements make Q and two buffers of K and V 84.5 KB of
//   shared memory, above the 48 KB a static array may take: the shared
//   memory is dynamic in both instances, its size set once per instance
//   with cudaFuncSetAttribute.
// - Q, the first K tile and the first V tile are issued together with
//   cp.async; for longer sequences the next K/V tile is copied while the
//   current one is used (two buffers).  Key tiles are BKV = 32 keys, the
//   serve shapes' whole sequence, and a tile's products cover only the
//   keys that exist (n8 tiles of scores, k16 steps of the context), so
//   Skv = 32 computes no empty half tile.  hd is padded to 16 in shared
//   memory with zeros (exact); rows are padded by 16 bytes (272 and 528
//   bytes) so that ldmatrix's eight rows fall on distinct banks.
// - S = Q K^T is mma.sync m16n8k16 (bf16 in, f32 sums) from ldmatrix
//   fragments of Q and of K as it lies (k-contiguous).  The row max and
//   sum are quad butterflies, so every lane holding a row has its bits.
// - P stays in registers as the A fragment of P V, with V's B fragments
//   read by ldmatrix.trans.  P rounded once to bf16 would err by 2^-9 of
//   |p| |v|, far above the f32 tolerance and the 1e-5 rms floor near zero,
//   so p is split exactly into three bf16 terms p1 + p2 + p3 (8 + 8 + 8
//   significant bits: p1 = bf16(p), p2 = bf16(p - p1), p3 = p - p1 - p2)
//   and the three products are added into one f32 sum: P V as exact as
//   f32 P, at three times the (here negligible) tensor-core work.  The
//   tensor cores truncate their f32 sums, so each tile's context is summed
//   from zero (at most 8 steps of S, 6 of P V) and added to the running one
//   with IEEE f32 operations, as the softmax's max and sums are.
// - A KV tile masked for every query of the block is not copied, and one
//   masked for every row of a warp is not computed by it (causal: past the
//   last query; window: before the first query's window; kv_len: past the
//   valid keys).  That is exact: the TPU kernel's arithmetic leaves m, l
//   and acc unchanged on such a tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int BQ = 32;              // queries per block: two groups of 16 rows
constexpr int BKV = 32;             // keys per tile
constexpr int NT_S = BKV / 8;       // n8 tiles of scores per tile
constexpr int CW = 128;             // context columns a warp owns
constexpr int NT_O = CW / 8;        // n8 tiles of a warp's context
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}
// A butterfly: every lane adds the same two operands at every stage, so
// the four lanes of a row end with the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Two f32 values as a bf16 pair, each split into three exact terms:
// a = a1 + a2 + a3; out[i] holds (a_i+1, b_i+1), a in the low half.
__device__ __forceinline__ void split3(float a, float b, unsigned (&out)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    out[i] = *reinterpret_cast<const unsigned*>(&h);
    a = __fsub_rn(a, __low2float(h));
    b = __fsub_rn(b, __high2float(h));
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows [0, nrows) of a (rows, hd) bf16 matrix into shared rows of ROW
// elements, hd padded to hd16 with zeros, rows from `valid` on zero.
template <int ROW, int THREADS>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          const __nv_bfloat16* base, int valid, int nrows,
                                          int hd, int hd16, int tid) {
  const int ch = hd16 / 8, chv = hd / 8;
  for (int i = tid; i < nrows * ch; i += THREADS) {
    const int r = i / ch, c = i % ch;
    const bool ok = r < valid && c < chv;
    cp_async16(dst + r * ROW + 8 * c, ok ? src + (size_t)r * hd + 8 * c : base, ok);
  }
}

// The shape of one instance: HD the largest head size, SPLIT warps a
// 16-row group (each owning CW context columns), ROW the shared row.
template <int HD>
struct Shape {
  static constexpr int SPLIT = HD / CW;
  static constexpr int WARPS = 2 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROW = HD + 8;
  static constexpr int SMEM = (BQ + 4 * BKV) * ROW * 2;  // Q, 2 x K, 2 x V (bytes)
};

template <int HD, typename OT>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, OT* __restrict__ out, int Sq,
                       int Skv, int hd, int kv_len, int causal, int window, float sm_scale) {
  using SH = Shape<HD>;
  constexpr int ROW = SH::ROW, THREADS = SH::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const sK[2] = {sQ + BQ * ROW, sQ + (BQ + BKV) * ROW};
  __nv_bfloat16* const sV[2] = {sQ + (BQ + 2 * BKV) * ROW, sQ + (BQ + 3 * BKV) * ROW};

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // a fragment's row group and column pair
  // this warp's 16-row group and its context columns [c0, c0 + CW)
  const int group = warp / SH::SPLIT, c0 = CW * (warp % SH::SPLIT);
  const int hd16 = (hd + 15) & ~15;
  const int ksteps = hd16 / 16, nt_o = max(0, min(CW, hd - c0)) / 8;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * hd;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * hd;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * hd;

  // the KV tiles that hold a key some query of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BKV;
  const int t_end = (kv_end + BKV - 1) / BKV;
  // the keys the rows of this warp may see
  const int r0 = 16 * group, w_first = q0 + r0;
  const int w_last = min(w_first + 15, Sq - 1);
  const int w_end = causal ? min(kv_len, w_last + 1) : kv_len;
  const int w_begin = window > 0 ? w_first - window + 1 : 0;

  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * BKV, nk = min(BKV, Skv - k0);
    copy_rows<ROW, THREADS>(sK[buf], kb + (size_t)k0 * hd, k, nk, BKV, hd, hd16, tid);
    copy_rows<ROW, THREADS>(sV[buf], vb + (size_t)k0 * hd, v, nk, BKV, hd, hd16, tid);
  };
  copy_rows<ROW, THREADS>(sQ, qb + (size_t)q0 * hd, q, Sq - q0, BQ, hd, hd16, tid);
  if (t_begin < t_end) load_tile(t_begin, 0);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = tile * BKV, nk = min(BKV, Skv - k0);
    const int nt_s = (nk + 7) / 8, kst = (nk + 15) / 16;
    const bool seen = w_first < Sq && k0 < w_end && k0 + nk - 1 >= w_begin;
    if (seen) {
      // S = Q K^T for this warp's 16 rows and the tile's keys
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        if (kk >= ksteps) break;
        unsigned a[4];
        ldmatrix_x4(a, sQ + (r0 + (lane & 15)) * ROW + 16 * kk + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < NT_S / 2; ++np) {
          if (2 * np >= nt_s) break;
          unsigned b[4];
          ldmatrix_x4(b, sK[buf] + (16 * np + 8 * (lane >> 4) + (lane & 7)) * ROW + 16 * kk +
                             8 * ((lane >> 3) & 1));
          mma_bf16(s[2 * np], a, b[0], b[1]);
          if (2 * np + 1 < nt_s) mma_bf16(s[2 * np + 1], a, b[2], b[3]);
        }
      }

      // online softmax: mask, the tile's max, rescale, probabilities
      float tmax[2] = {NEG_INF, NEG_INF};
      unsigned valid = 0;  // bit 4 j + e: element e of score tile j is seen
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qpos = w_first + g + 8 * (e >> 1);
          const bool ok = j < nt_s && kpos < kv_len && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          valid |= unsigned(ok) << (4 * j + e);
          s[j][e] = ok ? s[j][e] * sm_scale : NEG_INF;
          tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
        }
      float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(tmax[h]));
        alpha[h] = expf(m[h] - m_new);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (valid >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
          s[j][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);

      // context: P V, P as three exact bf16 terms, summed from zero per tile
      float ctx[NT_O][4];
#pragma unroll
      for (int j = 0; j < NT_O; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) ctx[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        if (kk >= kst) break;
        unsigned pa[4][3];  // the A fragment's four registers, three terms each
        split3(s[2 * kk][0], s[2 * kk][1], pa[0]);
        split3(s[2 * kk][2], s[2 * kk][3], pa[1]);
        split3(s[2 * kk + 1][0], s[2 * kk + 1][1], pa[2]);
        split3(s[2 * kk + 1][2], s[2 * kk + 1][3], pa[3]);
#pragma unroll
        for (int np = 0; np < NT_O / 2; ++np) {
          if (2 * np >= nt_o) break;
          unsigned b[4];
          ldmatrix_x4_trans(b, sV[buf] + (16 * kk + 8 * ((lane >> 3) & 1) + (lane & 7)) * ROW +
                                   c0 + 16 * np + 8 * (lane >> 4));
#pragma unroll
          for (int term = 0; term < 3; ++term) {
            const unsigned a[4] = {pa[0][term], pa[1][term], pa[2][term], pa[3][term]};
            mma_bf16(ctx[2 * np], a, b[0], b[1]);
            if (2 * np + 1 < nt_o) mma_bf16(ctx[2 * np + 1], a, b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT_O; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha[e >> 1] + ctx[j][e];
    }
    __syncthreads();  // the buffer is consumed before the next copy into it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qpos = w_first + g + 8 * h;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    OT* o = out + ((size_t)bh * Sq + qpos) * hd + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      if (j < nt_o) store2(o + 8 * j, acc[j][2 * h] / denom, acc[j][2 * h + 1] / denom);
  }
}

template <int HD, typename OT>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Skv,
           int hd, int kv_len, int causal, int window, float sm_scale, cudaStream_t stream) {
  using SH = Shape<HD>;
  // the dynamic shared memory's ceiling, raised once per instance (not a
  // stream operation, so a graph capture records nothing of it)
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_attention_kernel<HD, OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SH::SMEM);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<HD, OT><<<grid, SH::THREADS, SH::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<OT*>(out), Sq, Skv, hd, kv_len, causal,
      window, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename OT>
int launch_hd(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Skv,
              int hd, int kv_len, int causal, int window, float sm_scale, cudaStream_t stream) {
  if (hd <= 128)
    return launch<128, OT>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window, sm_scale,
                           stream);
  return launch<256, OT>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window, sm_scale,
                         stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns the first CUDA error of
// the launch (cudaGetLastError() after it), so a refused launch is
// reported to the caller.  hd up to 128 takes the HD = 128 instance, up to
// 256 the HD = 256 one.
extern "C" int flash_attention_bhsd(const void* q, const void* k, const void* v, void* out,
                                    int out_bf16, int BH, int Sq, int Skv, int hd, int kv_len,
                                    int causal, int window, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return launch_hd<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window,
                                    sm_scale, s);
  return launch_hd<float>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window, sm_scale, s);
}
