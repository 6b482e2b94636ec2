// One-token GQA attention over an int8 KV cache, for Hopper (sm_90a): the
// kernel body shared by the contiguous and the paged cache.
//
// Included by decode_attention_int8.cu (replaces the Pallas TPU kernel
// repro/kernels/decode_attention.py::decode_attention_int8) and
// decode_attention_int8_paged.cu (replaces ::decode_attention_int8_paged).
// The two differ only in where slot s of row b lives, which the `Slots`
// functor answers with a physical slot index p: K/V row (p, kvh) starts at
// (p * KV + kvh) * HD, its scale at p * KV + kvh.  Everything else -- the
// chunks, the tiles, the online softmax, the combine -- is this one body,
// so a row read through a block table computes exactly the bits of the
// same row read from a contiguous cache.
//
// Shapes:
//   q          (B, KV, G, hd)  bf16 or f32 -- one query token, grouped per kv head
//   k, v       (P, KV, hd)     int8 cache slots, P physical slots
//   ks, vs     (P, KV)         f32 per-(slot, head) scales
//   valid_len  (B,)            int32 -- logical slots < valid_len[b] take part
//   k_new,     (B, KV, hd)     f32, optional: the append column (the current
//   v_new                      token's k/v, folded in after the cache)
//   out        (B, KV, G, hd)  f32
//   work       B * KV * NSPLIT * roundup(G * (hd + 2), 4) f32, and counters
//              (B * KV) int32, all 0: the split's scratch, kept by the wrapper
//
// The TPU kernel swept the slot tiles as the sequential grid axis, carrying
// the online-softmax state in scratch.  Here the sweep is split three ways.
//   1. Across blocks: the grid is (KV, B, NSPLIT).  A row's valid range
//      [0, vl) is cut into chunks of roundup(ceil(vl / NSPLIT), CHUNK_ALIGN)
//      slots (chunk_len), and block z takes chunk z; blocks past the last
//      chunk return at once.  The bounds depend on vl and the two constants
//      alone -- never on B, the capacity, the block size or the grid -- so
//      a row's bits do not depend on the batch or the cache it lies in.  A
//      row of up to 64 slots (a short decode) is one chunk.
//   2. Across the block's eight warps: a chunk is cut into warp tiles of
//      WT = 16 slots, dealt to the warps in turn.  Each warp keeps its own
//      online softmax (m, l, acc in registers) with no block barrier in the
//      loop.  It copies its next tile's int8 K/V rows and scales with
//      cp.async into a ring of its own (the paged kernel maps each slot
//      through the table once per tile, in one lane); per tile
//        a. S = Q K^T on the bf16 tensor cores (mma.sync m16n8k16): the G
//           <= 16 query rows are the A operand, from a bf16 copy of q in
//           shared memory (f32 q as three exact bf16 terms); K's int8 bytes
//           convert to bf16 exactly in registers;
//        b. the tile's max and sum per query row by quad shuffles; the k
//           scale folds into the score, the v scale into p;
//        c. P V on the tensor cores: P, kept in registers as the A operand,
//           split into three exact bf16 terms (so P V keeps f32 accuracy);
//           V's bytes transposed in registers (byte permutes) into the B
//           operands.  Each product is summed from zero and added with IEEE
//           operations, since the tensor cores truncate their sums.
//      The index maps (q_col, k_off, v_off below) put every operand a lane
//      needs into whole 32-bit words of the int8 rows, at distinct banks.
//      At the end of the chunk the warps' states are combined in warp order
//      through shared memory.
//   3. Across chunks, in the same launch: with more than one chunk, each
//      block writes its (acc, m, l) to the workspace, fences, and takes a
//      ticket from its (b, kv head) counter with an integer atomicAdd; the
//      last to arrive combines the chunks in chunk order (M = max m_i; l
//      and acc each summed as exp(m_i - M) x_i), and sets the counter back
//      to 0.  No float atomics, no second launch.
// Last, the optional append column joins the softmax as one more score, and
// the output is acc / max(l, 1e-30), as the reference does: with an empty
// cache and the column the output is exactly v_new, without it zeros.
//
// What bounds it: the cache bytes it must read (int8 K and V of the valid
// slots plus their scales), a few MB at most, so latency: the launch, the
// cold reads of valid_len and of each warp's first tile, each warp's chain
// of dependent operations per tile, and the combine's round trips through
// L2.  The split puts up to B * KV * NSPLIT blocks on the card instead of
// the B * KV (16 at B = 8) of a whole-row sweep, so a 4,096-slot row no
// longer runs serially on one SM; the tensor cores take the products off
// the FMA pipes and shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int THREADS = 256;     // eight warps
constexpr int MIN_BLOCKS = 2;    // resident blocks per SM: caps the registers at 128
constexpr int WARPS = THREADS / 32;
constexpr int NSPLIT = 16;       // chunks a row is cut into, at most
constexpr int CHUNK_ALIGN = 64;  // a chunk's length is a multiple of this
constexpr int WT = 16;           // slots per warp tile: the k of P V's products
constexpr int STAGES = 2;        // a warp's ring of tiles in shared memory
constexpr int MAXG = 16;         // query rows: one m16 tile
constexpr int MAXHD = 128;
constexpr int QROW = MAXHD + 8;  // bf16 of a row of q in shared memory: 272 bytes
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RPT = MAXG * MAXHD / THREADS;  // rows of a column per thread, outside the sweep
static_assert(THREADS % MAXHD == 0 && WARPS <= NSPLIT && WT == 16 && THREADS == NSPLIT * MAXG &&
                  NSPLIT <= 32,
              "the layout below");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// q as bf16 terms whose sum is q: one for bf16 q, three for f32 (8 + 8 + 8
// significant bits, exact)
template <typename QT>
struct QTerms {
  static constexpr int N = 3;
};
template <>
struct QTerms<__nv_bfloat16> {
  static constexpr int N = 1;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}

// A butterfly: the four lanes of a row add the same operands at every
// stage, so they end with the same bits.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Bytes j and j + 1 of w (int8 values) as a bf16 pair, byte j in the low
// half (SEL = 0x4140 for j = 0, 0x4342 for j = 2); c43 holds 0x43434343.
// Exact: a byte v = l + 128 h (l its low seven bits, h its sign bit) is
// (128 + l) - (128 + 128 h), both bf16 values (0x4300 | l, 0x4300 | h << 7).
template <unsigned SEL>
__device__ __forceinline__ unsigned s8x2_to_bf16x2(unsigned w, unsigned c43) {
  const unsigned t = __byte_perm(w, c43, SEL);
  const unsigned lo = t & 0x437F437Fu;
  const unsigned hi = t & 0x43804380u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const unsigned*>(&d);
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

// An arrival at a (row, kv head) counter, by thread 0 after a barrier: a
// release of the block's partial (which the barrier orders before it) and
// an acquire of those of the blocks that arrived earlier.  Returns the
// arrivals before this one.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Slots per chunk of a row with vl valid slots, and the number of chunks
// (one, empty, when vl = 0).  kernels/decode_attention.py::
// decode_chunk_bounds is the same formula.
__device__ __forceinline__ int chunk_len(int vl) {
  const int per = (vl + NSPLIT - 1) / NSPLIT;
  return (per + CHUNK_ALIGN - 1) / CHUNK_ALIGN * CHUNK_ALIGN;
}

__device__ __forceinline__ int n_chunks(int vl) {
  return vl > 0 ? (vl + chunk_len(vl) - 1) / chunk_len(vl) : 1;
}

// f32 per chunk in the workspace: acc (G, HD), m (G), l (G), rounded up to
// whole float4s (kernels/decode_attention.py::_scratch sizes it the same)
__device__ __forceinline__ size_t partial_stride(int G, int HD) {
  return ((size_t)G * (HD + 2) + 3) / 4 * 4;
}

// Where the products' k and n indices lie.  In S = Q K^T (k = d, n = slot)
// and in P V (k = slot, n = d) each lane's operands and results are then
// whole 32-bit words of the int8 rows -- sums are the same terms in another
// fixed order:
//   - k of S within a 16-wide step: k = 2 t + e is d = 4 t + e, and
//     k = 8 + 2 t + e is d = 4 t + 2 + e (t = lane % 4, e = 0, 1): a lane's
//     four d of a step are one word of a K row;
//   - n of S: column n of score tile nt is slot 4 (n / 2) + 2 nt + n % 2,
//     so a lane's four scores of a row are slots 4 t .. 4 t + 3, and k of
//     P V is slot 4 t + e (k = 2 t + e) or 4 t + 2 + e (k = 8 + 2 t + e);
//   - n of P V: column n of context tile 4 q + j is d = 32 q + 4 n + j, so
//     lane (n = lane / 4) reads one word of each of four V rows per q and
//     a 4 x 4 byte transpose gives its four tiles' operands.
__device__ __forceinline__ int q_col(int d) {  // shared column of q's d
  const int c = d & 15, t = c >> 2, w = c & 3;
  return (d & ~15) + (w < 2 ? 2 * t + w : 8 + 2 * t + w - 2);
}
// Byte offsets in a stage's 16 x 128 int8 K and V tiles.  Both XOR-permute
// the 16-byte chunks of a row, so that each warp-wide 4-byte read falls on
// 32 distinct banks.
__device__ __forceinline__ int k_off(int r, int chunk) {
  return r * MAXHD + ((chunk ^ (((r >> 1) & 6) | (r & 1))) << 4);
}
__device__ __forceinline__ int v_off(int r, int chunk) {
  return r * MAXHD + ((chunk ^ ((r >> 1) & 6)) << 4);
}

// Contiguous cache (B, S, KV, hd): slot s of row b is physical slot b * S + s.
struct ContiguousSlots {
  int S;
  __device__ __forceinline__ long long operator()(int b, int s) const {
    return (long long)b * S + s;
  }
};

// Paged cache (NB, bs, KV, hd): slot s of row b lies in block
// tables[b, s / bs] at offset s % bs.
struct PagedSlots {
  const int* tables;  // (B, MB) int32, entries in [0, NB)
  int MB, BS;
  __device__ __forceinline__ long long operator()(int b, int s) const {
    return (long long)tables[(size_t)b * MB + s / BS] * BS + s % BS;
  }
};

// Shared memory of one block; NQ = the number of q's bf16 terms.
template <int NQ>
struct Smem {
  struct alignas(16) Stage {   // one warp tile: WT slots' K/V rows and scales
    int8_t k[WT * MAXHD];
    int8_t v[WT * MAXHD];
    float ks[WT], vs[WT];
  };
  struct alignas(16) Red {     // after the sweep: the warps' states
    float acc[WARPS][MAXG][MAXHD];
    float m[WARPS][MAXG], l[WARPS][MAXG];
    float e[NSPLIT][MAXG];     // a combine's factors exp(m_i - M)
  };
  __nv_bfloat16 q[NQ][MAXG][QROW];  // q's terms, k-permuted (q_col)
  union {
    Stage st[WARPS][STAGES];
    Red red;
  } u;
  float sn[MAXHD / 32][MAXG];  // the append column's scores, per 32 columns
  float M[MAXG], L[MAXG], a[MAXG], pn[MAXG];
  int ticket;
};

// S is the row's logical capacity (contiguous: the cache length; paged:
// MB * bs); valid_len is clamped to it.
template <typename QT, typename Slots>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
decode_attention_int8_kernel(const QT* __restrict__ q, const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v, const float* __restrict__ ks,
                             const float* __restrict__ vs, const int* __restrict__ valid_len,
                             const float* __restrict__ k_new, const float* __restrict__ v_new,
                             float* __restrict__ out, float* __restrict__ work,
                             int* __restrict__ counters, int S, int KV, int G, int HD,
                             float sm_scale, Slots slots) {
  constexpr int NQ = QTerms<QT>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<NQ>& sm = *reinterpret_cast<Smem<NQ>*>(smem_raw);

  const int kvh = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // a fragment's row group and column pair
  // outside the sweep thread tid owns column col of rows r0 .. r0 + RPT - 1
  const int col = tid % MAXHD, r0 = tid / MAXHD * RPT;
  const size_t head = (size_t)b * KV + kvh;

  // q (and the append column) are loaded first, so that they arrive while
  // the chunk's bounds and first tile wait on valid_len (and, paged, on
  // the table)
  float qv[RPT];
  const QT* qb = q + head * G * HD;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    qv[i] = r0 + i < G && col < HD ? to_f32(qb[(r0 + i) * HD + col]) : 0.f;
  float kn = 0.f, vn = 0.f;
  if (k_new != nullptr && col < HD) {
    kn = k_new[head * HD + col];
    vn = v_new[head * HD + col];
  }

  const int vl = min(max(valid_len[b], 0), S);
  const int nch = n_chunks(vl);
  if (z >= nch) return;
  const int cl = chunk_len(vl);
  const int c0 = z * cl, c1 = min(vl, c0 + cl);

  // the warp tiles of the chunk; warp w takes tiles w, w + WARPS, ...
  const int tiles = (c1 - c0 + WT - 1) / WT;
  const int mine = tiles > warp ? (tiles - warp + WARPS - 1) / WARPS : 0;

  // this warp's tile number it into its stage it % STAGES; lane j < WT
  // maps slot j through `slots` once, and the copying lanes take it by
  // shuffle
  auto load = [&](int it) {
    auto& st = sm.u.st[warp][it % STAGES];
    const int s0 = c0 + (warp + it * WARPS) * WT;
    long long pm = 0;
    if (lane < WT && s0 + lane < c1) pm = slots(b, s0 + lane);
#pragma unroll
    for (int u = 0; u < WT * MAXHD / 16 / 32; ++u) {
      const int j = (lane >> 3) + 4 * u, c = lane & 7;
      const long long p = __shfl_sync(FULL, pm, j);
      const bool ok = s0 + j < c1 && c * 16 < HD;
      const size_t off = ((size_t)p * KV + kvh) * HD + c * 16;
      cp_async16(st.k + k_off(j, c), ok ? k + off : k, ok);
      cp_async16(st.v + v_off(j, c), ok ? v + off : v, ok);
    }
    const int j = lane % WT;  // lanes below WT copy the k scales, the rest the v scales
    const long long p = __shfl_sync(FULL, pm, j);
    const bool ok = s0 + j < c1;
    const size_t off = (size_t)p * KV + kvh;
    if (lane < WT)
      cp_async4(&st.ks[j], ok ? ks + off : ks, ok);
    else
      cp_async4(&st.vs[j], ok ? vs + off : vs, ok);
  };
#pragma unroll
  for (int it = 0; it < STAGES - 1; ++it) {
    if (it < mine) load(it);
    cp_async_commit();
  }

  // q's terms into shared memory, k-permuted; rows past G and d past HD 0
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float x = qv[i];
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const __nv_bfloat16 h = __float2bfloat16_rn(x);
      sm.q[n][r0 + i][q_col(col)] = h;
      x = __fsub_rn(x, __bfloat162float(h));
    }
  }
  if (k_new != nullptr) {
    // the append column's scores, summed over the columns in a fixed
    // order: each warp's 32 by shuffles, then the 32-column blocks in order
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float d = warp_sum(__fmul_rn(qv[i], kn));
      if (lane == 0) sm.sn[col / 32][r0 + i] = d;
    }
  }
  __syncthreads();  // q (and the append column's partial scores) staged

  const unsigned c43 = 0x43434343u;
  const int ksteps = HD / 16;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g and g + 8
  float acc[MAXHD / 8][4];
#pragma unroll
  for (int j = 0; j < MAXHD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < mine; ++it) {
    if (it + STAGES - 1 < mine) load(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const auto& st = sm.u.st[warp][it % STAGES];
    const int rows = min(WT, c1 - (c0 + (warp + it * WARPS) * WT));

    // a. S = Q K^T on the tensor cores: two n8 tiles of slots, each summed
    //    from zero over the even and the odd k16 steps of hd (four
    //    independent chains of products), then the two sums added
    float s[2][2][4];  // [even / odd steps][n8 tile][fragment]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[h][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MAXHD / 16; ++kk) {
      if (kk >= ksteps) break;
      unsigned a[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
        ldmatrix_x4(a[n], &sm.q[n][lane & 15][16 * kk + 8 * (lane >> 4)]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int r = 4 * (g >> 1) + 2 * nt + (g & 1);  // the slot of column g
        const unsigned w = *reinterpret_cast<const unsigned*>(st.k + k_off(r, kk) + 4 * t);
        const unsigned b0 = s8x2_to_bf16x2<0x4140>(w, c43);
        const unsigned b1 = s8x2_to_bf16x2<0x4342>(w, c43);
#pragma unroll
        for (int n = 0; n < NQ; ++n) mma_bf16(s[kk & 1][nt], a[n], b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][nt][e] = __fadd_rn(s[0][nt][e], s[1][nt][e]);

    // b. online softmax of the tile: this lane holds rows g (e = 0, 1) and
    //    g + 8 (e = 2, 3) at slots 4 t + 2 nt + e % 2; the k scale folds
    //    into the score, the v scale into p
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * t + 2 * nt + (e & 1);
        s[0][nt][e] = j < rows ? __fmul_rn(__fmul_rn(s[0][nt][e], sm_scale), st.ks[j]) : NEG_INF;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], s[0][nt][e]);
      }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_run[h], quad_max(tmax[h]));
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * t + 2 * nt + (e & 1);
        const float p = j < rows ? expf(s[0][nt][e] - m_run[e >> 1]) : 0.f;
        psum[e >> 1] += p;
        s[0][nt][e] = __fmul_rn(p, st.vs[j]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = fmaf(l_run[h], alpha[h], quad_sum(psum[h]));

    // c. P V on the tensor cores, P (times vs) as three exact bf16 terms,
    //    summed from zero and added to acc with IEEE operations (the tensor
    //    cores truncate their sums)
    unsigned pa[4][3];
    split3(s[0][0][0], s[0][0][1], pa[0]);
    split3(s[0][0][2], s[0][0][3], pa[1]);
    split3(s[0][1][0], s[0][1][1], pa[2]);
    split3(s[0][1][2], s[0][1][3], pa[3]);
#pragma unroll
    for (int qd = 0; qd < MAXHD / 32; ++qd) {
      if (32 * qd >= HD) break;
      unsigned w[4];  // word g of V rows 4 t .. 4 t + 3 in this 32-wide block of d
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = *reinterpret_cast<const unsigned*>(st.v + v_off(4 * t + e, 2 * qd + (g >> 2)) +
                                                  4 * (g & 3));
      // transpose: col4[j] holds byte j of w[0..3], slot 4 t + e in byte e
      const unsigned x0 = __byte_perm(w[0], w[1], 0x5140), x1 = __byte_perm(w[0], w[1], 0x7362);
      const unsigned x2 = __byte_perm(w[2], w[3], 0x5140), x3 = __byte_perm(w[2], w[3], 0x7362);
      const unsigned col4[4] = {__byte_perm(x0, x2, 0x5410), __byte_perm(x0, x2, 0x7632),
                                __byte_perm(x1, x3, 0x5410), __byte_perm(x1, x3, 0x7632)};
      // the block's four n8 tiles, each summed from zero over P's three
      // terms: four independent chains of products
      unsigned b[4][2];
      float ctx[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = s8x2_to_bf16x2<0x4140>(col4[j], c43);
        b[j][1] = s8x2_to_bf16x2<0x4342>(col4[j], c43);
#pragma unroll
        for (int e = 0; e < 4; ++e) ctx[j][e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < 3; ++n) {
        const unsigned a[4] = {pa[0][n], pa[1][n], pa[2][n], pa[3][n]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(ctx[j], a, b[j][0], b[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* o = acc[4 * qd + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = fmaf(o[e], alpha[e >> 1], ctx[j][e]);
      }
    }
    __syncwarp();  // the stage is free for the next copy
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the sweep: Red may overwrite the stages

  // the warps' states, combined in warp order
  auto& R = sm.u.red;
#pragma unroll
  for (int qd = 0; qd < MAXHD / 32; ++qd)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = 32 * qd + 8 * t + j;  // columns n = 2 t and 2 t + 1 of tile 4 qd + j
      const float* o = acc[4 * qd + j];
      R.acc[warp][g][d] = o[0];
      R.acc[warp][g][d + 4] = o[1];
      R.acc[warp][g + 8][d] = o[2];
      R.acc[warp][g + 8][d + 4] = o[3];
    }
  if (t == 0) {
    R.m[warp][g] = m_run[0];
    R.l[warp][g] = l_run[0];
    R.m[warp][g + 8] = m_run[1];
    R.l[warp][g + 8] = l_run[1];
  }
  __syncthreads();
  if (tid < MAXG) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, R.m[w][tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float e = expf(R.m[w][tid] - M);
      R.e[w][tid] = e;
      l = fmaf(e, R.l[w][tid], l);
    }
    sm.M[tid] = M;
    sm.L[tid] = l;
  }
  __syncthreads();
  float cacc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) x = fmaf(R.e[w][r0 + i], R.acc[w][r0 + i][col], x);
    cacc[i] = x;
  }

  if (nch > 1) {
    // this chunk's (m, l, acc) to the workspace; the last block of the
    // (b, kv head) to arrive combines the chunks in chunk order
    const size_t pstride = partial_stride(G, HD);  // [acc (G, HD)][m (G)][l (G)]
    float* wh = work + head * NSPLIT * pstride;
    float* wp = wh + z * pstride;
    if (col < HD) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (r0 + i < G) wp[(r0 + i) * HD + col] = cacc[i];
    }
    if (tid < G) {
      wp[G * HD + tid] = sm.M[tid];
      wp[G * HD + G + tid] = sm.L[tid];
    }
    __syncthreads();  // the block's partial is written
    if (tid == 0) sm.ticket = arrive(&counters[head]);
    __syncthreads();
    if (sm.ticket != nch - 1) return;
    // the last block: every thread's first four columns of acc and, in
    // thread c + NSPLIT r, chunk c's m and l of row r are loaded at once
    const int n4 = G * HD / 4;  // outputs of four columns: o = tid, tid + THREADS, ...
    float4 x[NSPLIT];
    auto fetch = [&](int o) {
      const float* src = wh + o / (HD / 4) * HD + o % (HD / 4) * 4;
#pragma unroll
      for (int c = 0; c < NSPLIT; ++c)
        if (c < nch) x[c] = __ldcg(reinterpret_cast<const float4*>(src + c * pstride));
    };
    if (tid < n4) fetch(tid);
    {
      const int c = tid % NSPLIT, r = tid / NSPLIT;
      const bool live = c < nch && r < G;
      const float m = live ? __ldcg(wh + c * pstride + G * HD + r) : NEG_INF;
      const float l = live ? __ldcg(wh + c * pstride + G * HD + G + r) : 0.f;
      // M and l of row r over its NSPLIT lanes, by butterflies: every
      // lane ends with the same bits, in a fixed order of the chunks
      float M = m;
#pragma unroll
      for (int o = 1; o < NSPLIT; o <<= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, o));
      const float e = expf(m - M);  // 0 past the last chunk
      float L = __fmul_rn(e, l);
#pragma unroll
      for (int o = 1; o < NSPLIT; o <<= 1) L += __shfl_xor_sync(FULL, L, o);
      R.e[c][r] = e;
      if (c == 0) {
        sm.M[r] = M;
        sm.L[r] = L;
      }
    }
    __syncthreads();
    // acc, in chunk order, into shared memory (R.acc[0] is free)
    float* cs = &R.acc[0][0][0];
    for (int o = tid; o < n4; o += THREADS) {
      if (o != tid) fetch(o);
      const int r = o / (HD / 4), d = o % (HD / 4) * 4;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int c = 0; c < NSPLIT; ++c)
        if (c < nch) {
          const float e = R.e[c][r];
          y.x = fmaf(e, x[c].x, y.x);
          y.y = fmaf(e, x[c].y, y.y);
          y.z = fmaf(e, x[c].z, y.z);
          y.w = fmaf(e, x[c].w, y.w);
        }
      *reinterpret_cast<float4*>(cs + r * MAXHD + d) = y;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) cacc[i] = cs[(r0 + i) * MAXHD + col];
    if (tid == 0) counters[head] = 0;
  }

  if (k_new != nullptr) {
    // the append column joins the softmax last
    if (tid < G) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < MAXHD / 32; ++c) d += sm.sn[c][tid];
      const float s_new = __fmul_rn(d, sm_scale);
      const float m_fin = fmaxf(sm.M[tid], s_new);
      const float a = expf(sm.M[tid] - m_fin), p = expf(s_new - m_fin);
      sm.a[tid] = a;
      sm.pn[tid] = p;
      sm.L[tid] = fmaf(sm.L[tid], a, p);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      cacc[i] = fmaf(sm.pn[r0 + i], vn, __fmul_rn(cacc[i], sm.a[r0 + i]));
  }

  if (col < HD) {
    float* ob = out + head * G * HD;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (r0 + i < G) ob[(size_t)(r0 + i) * HD + col] = cacc[i] / fmaxf(sm.L[r0 + i], 1e-30f);
  }
}

template <typename QT, typename Slots>
void launch_q(const void* q, const int8_t* k, const int8_t* v, const float* ks,
              const float* vs, const int* vl, const float* kn, const float* vn, float* out,
              float* work, int* counters, int B, int S, int KV, int G, int HD, float sm_scale,
              Slots slots, cudaStream_t stream) {
  // more than the 48 KB of static shared memory: allowed once per kernel
  constexpr int bytes = sizeof(Smem<QTerms<QT>::N>);
  static const bool sized = cudaFuncSetAttribute(decode_attention_int8_kernel<QT, Slots>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 bytes) == cudaSuccess;
  if (!sized) return;  // the caller's cudaGetLastError() reports it
  const dim3 grid(KV, B, NSPLIT);
  decode_attention_int8_kernel<QT, Slots><<<grid, THREADS, bytes, stream>>>(
      static_cast<const QT*>(q), k, v, ks, vs, vl, kn, vn, out, work, counters, S, KV, G, HD,
      sm_scale, slots);
}

// Launch over (KV, B, NSPLIT) blocks on `stream`; q is bf16 when q_bf16 is
// set, else f32; G <= MAXG, HD <= MAXHD with HD % 16 == 0.  Returns
// cudaGetLastError() after the launch.
template <typename Slots>
int launch_decode_attention_int8(const void* q, int q_bf16, const void* k, const void* v,
                                 const void* ks, const void* vs, const void* valid_len,
                                 const void* k_new, const void* v_new, void* out, void* work,
                                 void* counters, int B, int S, int KV, int G, int HD,
                                 float sm_scale, Slots slots, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* k8 = static_cast<const int8_t*>(k);
  const auto* v8 = static_cast<const int8_t*>(v);
  const auto* ksf = static_cast<const float*>(ks);
  const auto* vsf = static_cast<const float*>(vs);
  const auto* vl = static_cast<const int*>(valid_len);
  const auto* kn = static_cast<const float*>(k_new);
  const auto* vn = static_cast<const float*>(v_new);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<float*>(work);
  auto* c = static_cast<int*>(counters);
  if (q_bf16)
    launch_q<__nv_bfloat16>(q, k8, v8, ksf, vsf, vl, kn, vn, o, w, c, B, S, KV, G, HD, sm_scale,
                            slots, st);
  else
    launch_q<float>(q, k8, v8, ksf, vsf, vl, kn, vn, o, w, c, B, S, KV, G, HD, sm_scale, slots,
                    st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
