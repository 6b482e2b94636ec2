// Fused causal / sliding-window attention for Hopper (sm_90a):
// out = softmax(mask(q k^T * sm_scale)) v, f32 inside, bf16 or f32 out.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention.py::flash_attention_bhsd (body
// _flash_kernel).  q is (BH, Sq, hd), k and v are (BH, Skv, hd), all bf16
// with the heads already expanded to H; hd is a multiple of 8 up to 128.
// A key at position kpos is seen by the query at position qpos when
// kpos < kv_len, and (causal) kpos <= qpos, and (window > 0)
// kpos > qpos - window.  Masked scores are -1e30 and their probabilities
// 0; the output is acc / max(l, 1e-30), so a row with no valid key is 0.
//
// What bounds it: the bytes are q + k + v + out, read and written once;
// the operations are 4 * hd per (query, valid key) pair.  At the service
// curve's prefill (Sq = Skv = 32, hd 128) a block does 64 operations per
// byte of K/V it stages, and the whole call is a few microseconds of
// either, so launch and latency bound it.  The design keeps what the TPU
// kernel keeps out of device memory -- the scores, the probabilities and
// the running max / sum / context -- and carries it differently:
//
// - The TPU grid walks the KV blocks in order on one core, carrying
//   acc/m/l in VMEM scratch across grid steps.  Here one block owns one
//   (bh, tile of BQ queries) and the KV sweep is a loop inside it, with
//   the running state in registers: each warp owns RPW query rows, each
//   lane one key pair of the tile for the scores and NC output columns
//   for the context.
// - K and V tiles of BK rows are staged in shared memory once per block
//   and read by every warp; K rows are padded to an odd number of words so
//   the lanes of a warp, each reading its own key's row, hit 32 banks.
// - A KV tile masked for every query of the block is skipped (causal:
//   past the block's last query; window: before its first query's window;
//   kv_len: past the valid keys).  That is exact: the TPU kernel's
//   arithmetic leaves m, l and acc unchanged on such a tile.
// - Scores and the context are f32 FMAs in a fixed order per element; the
//   tile's row max and sum are warp butterflies, so every lane holds the
//   same bits.
//
// Tensor cores (mma / wgmma) for long prefills are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int MAX_HD = 128;
constexpr int BQ = 32;              // queries per block
constexpr int BK = 64;              // keys per shared-memory tile (two per lane)
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPW = BQ / WARPS;     // query rows per warp
constexpr int KW = MAX_HD / 2 + 1;  // words per staged K row: odd, conflict-free
constexpr int NC = MAX_HD / 32;     // output columns per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
// A butterfly: every lane adds the same two operands at every stage, so
// every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <typename OT>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, OT* __restrict__ out, int Sq,
                       int Skv, int hd, int kv_len, int causal, int window, float sm_scale) {
  __shared__ uint32_t sQ[BQ][MAX_HD / 2];         // bf16 pairs
  __shared__ uint32_t sK[BK][KW];                 // bf16 pairs, padded rows
  __shared__ __align__(16) __nv_bfloat16 sV[BK][MAX_HD];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = hd / 2;  // words per row
  const int hv = hd / 8;  // 16-byte vectors per row
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * hd;
  const __nv_bfloat16* kb = k + (size_t)bh * Skv * hd;
  const __nv_bfloat16* vb = v + (size_t)bh * Skv * hd;

  for (int i = tid; i < BQ * hv; i += THREADS) {  // the query tile; rows past Sq are 0
    const int r = i / hv, c = i % hv;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < Sq) u = __ldg(reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * hd) + c);
    sQ[r][4 * c] = u.x; sQ[r][4 * c + 1] = u.y; sQ[r][4 * c + 2] = u.z; sQ[r][4 * c + 3] = u.w;
  }

  // the KV tiles that hold a key some query of this block may see
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    const int nk = min(BK, Skv - k0);  // rows of the tile that exist
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < BK * hv; i += THREADS) {
      const int r = i / hv, c = i % hv;
      uint4 ku = make_uint4(0u, 0u, 0u, 0u), vu = ku;
      if (r < nk) {
        ku = __ldg(reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * hd) + c);
        vu = __ldg(reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * hd) + c);
      }
      sK[r][4 * c] = ku.x; sK[r][4 * c + 1] = ku.y; sK[r][4 * c + 2] = ku.z; sK[r][4 * c + 3] = ku.w;
      *reinterpret_cast<uint4*>(&sV[r][8 * c]) = vu;
    }
    __syncthreads();

    // scores of the warp's rows against keys lane and lane + 32
    float s[RPW][2];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i][0] = s[i][1] = 0.f;
    for (int w = 0; w < hw; ++w) {
      const uint32_t ka = sK[lane][w], kc = sK[lane + 32][w];
      const float k0a = lo(ka), k0b = hi(ka), k1a = lo(kc), k1b = hi(kc);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const uint32_t qw = sQ[warp * RPW + i][w];
        const float qa = lo(qw), qb2 = hi(qw);
        s[i][0] = fmaf(qb2, k0b, fmaf(qa, k0a, s[i][0]));
        s[i][1] = fmaf(qb2, k1b, fmaf(qa, k1a, s[i][1]));
      }
    }

    // online softmax: mask, the tile's max, rescale, probabilities
    float p[RPW][2], alpha[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int qpos = q0 + warp * RPW + i;
      bool ok[2];
      float tmax = NEG_INF;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kpos = k0 + lane + 32 * h;
        ok[h] = kpos < kv_len && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        s[i][h] = ok[h] ? s[i][h] * sm_scale : NEG_INF;
        tmax = fmaxf(tmax, s[i][h]);
      }
      const float m_new = fmaxf(m[i], warp_max(tmax));
      alpha[i] = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[i][h] = ok[h] ? expf(s[i][h] - m_new) : 0.f;
        psum += p[i][h];
      }
      l[i] = l[i] * alpha[i] + warp_sum(psum);
      m[i] = m_new;
    }

    // context: sum over the tile's keys of p_j v_j, p_j broadcast from its lane
    float ctx[RPW][NC];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) ctx[i][c] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int jn = min(32, nk - 32 * h);
      for (int jj = 0; jj < jn; ++jj) {
        const int j = 32 * h + jj;
        float vj[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = lane + 32 * c;
          vj[c] = d < hd ? __bfloat162float(sV[j][d]) : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const float pj = __shfl_sync(FULL, p[i][h], jj);
#pragma unroll
          for (int c = 0; c < NC; ++c) ctx[i][c] = fmaf(pj, vj[c], ctx[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] * alpha[i] + ctx[i][c];
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp * RPW + i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    OT* o = out + ((size_t)bh * Sq + qpos) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) store(o + d, acc[i][c] / denom);
    }
  }
}

template <typename OT>
void launch(const void* q, const void* k, const void* v, void* out, int BH, int Sq, int Skv,
            int hd, int kv_len, int causal, int window, float sm_scale, cudaStream_t stream) {
  const dim3 grid(BH, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<OT*>(out), Sq, Skv, hd, kv_len, causal,
      window, sm_scale);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
extern "C" int flash_attention_bhsd(const void* q, const void* k, const void* v, void* out,
                                    int out_bf16, int BH, int Sq, int Skv, int hd, int kv_len,
                                    int causal, int window, float sm_scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window, sm_scale, s);
  else
    launch<float>(q, k, v, out, BH, Sq, Skv, hd, kv_len, causal, window, sm_scale, s);
  return static_cast<int>(cudaGetLastError());
}
