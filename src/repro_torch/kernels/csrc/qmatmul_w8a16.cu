// Weight-only int8 matmul for Hopper (sm_90a): out = act(x @ (w * w_scale[col]) + bias).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul.py::qmatmul_w8a16
// (body _w8a16_kernel).  x is (M, K) bf16 or f32, w is (K, N) int8 row-major
// with one f32 scale per output column, bias is (N,) f32 or absent, out is
// (M, N) bf16 or f32.  Accumulation is f32.
//
// Two kernels, each with its own C entry point; the caller picks one (the
// wrapper in kernels/qmatmul.py, by path):
//
// 1. qmatmul_w8a16 -- the GEMV below, for a decode tick's few rows and for
//    every launch whose rows must not depend on the path.
// 2. qmatmul_w8a16_mma -- mma.sync on the bf16 tensor cores, for the
//    full-sequence forward's hundreds of rows (see its own note further
//    down).  Its sums are added in another order than the GEMV's, so a row
//    differs from the GEMV's row by f32 rounding.
//
// Path 1, the GEMV.
//
// What bounds it: at decode M is 1 to 8, so the product does about 2*M
// operations per weight byte -- far below the ~295 the card needs before
// its arithmetic, not its memory, is the limit.  The kernel is bound by
// reading w once, and its design keeps every weight byte read exactly once
// and enough of them in flight:
//
// - A block owns a strip of BN output columns.  Each thread owns CPT
//   neighbouring columns and reads them as one 4-byte word, so a warp reads
//   whole 32-byte sectors of w's rows.
// - The block's KS k-slices each own one contiguous range of w's rows and
//   walk it in groups of G rows, the next group's weights loaded while the
//   current one is multiplied, with no barrier in the loop.  x (a few KB)
//   is read through the L1 cache, 16 bytes per row and group.
// - Each weight is dequantized as float(w) * w_scale[n], as the reference
//   oracle does, and folded into f32 FMAs.  The KS partial sums of a column
//   are added in a fixed order at the end, through shared memory.
//
// Rows are independent: row m's arithmetic depends only on row m of x and
// on w, never on M or on the other rows (no split-K chosen by shape, no
// atomics).  The serving engine's bit-for-bit parity with its batch-1
// sequential reference depends on that.  M larger than MT is covered by
// gridDim.y, one MT-row slab per block row, with the same per-row math.
// K must be a multiple of G and x 16-byte aligned (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int BN = 32;             // output columns per block
constexpr int CPT = 4;             // columns per thread (one 4-byte load)
constexpr int TN = BN / CPT;       // column threads per block
constexpr int KS = 32;             // k-slices per block
constexpr int THREADS = TN * KS;   // 256
constexpr int G = 8;               // rows of w per group (one 16-byte x load)
constexpr int MT = 8;              // rows of x per block
static_assert(THREADS == MT * BN, "the drain gives one output per thread");

// Eight consecutive elements of x as f32.
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float (&out)[G]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is the bf16 bits in the high half
    out[2 * i] = __uint_as_float(words[i] << 16);
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load_x8(const float* p, float (&out)[G]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load_w(const int8_t* w, size_t row_stride, int (&out)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) out[u] = __ldg(reinterpret_cast<const int*>(w + u * row_stride));
}

template <typename XT, typename OT>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale, const float* __restrict__ bias,
                     OT* __restrict__ out, int M, int K, int N, int act) {
  __shared__ float red[KS][MT][BN];

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int ks = tid / TN;
  const int m0 = blockIdx.y * MT;
  const int n = blockIdx.x * BN + tn * CPT;

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

  if (n < N) {  // N % CPT == 0, so a column group is all in or all out
    float sc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) sc[j] = w_scale[n + j];
    // this slice's rows: [kb, kb + groups * G), G-aligned, in order
    const int per = ((K + KS - 1) / KS + G - 1) / G * G;
    const int kb = min(K, ks * per);
    const int groups = (min(K, kb + per) - kb) / G;
    const size_t row_stride = (size_t)N;
    const int8_t* wp = w + (size_t)kb * N + n;
    int wv[G];
    if (groups > 0) load_w(wp, row_stride, wv);
    for (int gi = 0; gi < groups; ++gi) {
      const int k = kb + gi * G;
      const bool more = gi + 1 < groups;
      int nv[G];
      if (more) load_w(wp + (size_t)(gi + 1) * G * N, row_stride, nv);  // prefetch
      float wf[G][CPT];
#pragma unroll
      for (int u = 0; u < G; ++u) {
#pragma unroll
        for (int j = 0; j < CPT; ++j)  // byte j of the word, sign-extended
          wf[u][j] = float((wv[u] << (24 - 8 * j)) >> 24) * sc[j];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float xv[G];
        if (m0 + m < M) {
          load_x8(x + (size_t)(m0 + m) * K + k, xv);
        } else {
#pragma unroll
          for (int u = 0; u < G; ++u) xv[u] = 0.f;
        }
#pragma unroll
        for (int u = 0; u < G; ++u)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[m][j] = fmaf(xv[u], wf[u][j], acc[m][j]);
      }
      if (more) {
#pragma unroll
        for (int u = 0; u < G; ++u) wv[u] = nv[u];
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) red[ks][m][tn * CPT + j] = acc[m][j];
  __syncthreads();

  const int m = tid / BN, c = tid % BN;
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < KS; ++q) s += red[q][m][c];
  const int row = m0 + m, col = blockIdx.x * BN + c;
  if (row < M && col < N) {
    if (bias != nullptr) s += bias[col];
    store(out + (size_t)row * N + col, activate(s, act));
  }
}

template <typename XT, typename OT>
void launch(const void* x, const void* w, const void* w_scale, const void* bias, void* out,
            int M, int K, int N, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  qmatmul_w8a16_kernel<XT, OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<OT*>(out), M, K, N, act);
}

// Path 2, mma.sync on the bf16 tensor cores, for the full-sequence forward.
//
// What bounds it: at a prefill of 16 x 32 tokens (M = 512) the product does
// 1,024 operations per weight byte, past the ~295 at which the card's bf16
// arithmetic, not its memory, is the limit.  The GEMV above re-reads w for
// every 8 rows and multiplies in scalar f32; this kernel keeps each tile of
// w in shared memory for TC_BM rows and multiplies on the tensor cores:
//
// - A block owns a TC_BM x TC_BN output tile; each of its eight warps a
//   TC_WM x TC_WN piece, as TC_MI x TC_NI m16n8k16 products (bf16 in, f32
//   sums in registers).  K is walked in TC_BK-deep stages through a ring of
//   TC_STAGES buffers of shared memory, filled by cp.async TC_STAGES - 1
//   stages ahead (one barrier per stage).
// - x's tile lies as in memory (row-major, k contiguous), the A fragment's
//   layout, so ldmatrix reads it as it lies.  w's int8 tile lies as in
//   memory too (k-major, n contiguous).  One stage ahead of the products,
//   the whole block converts it once into a bf16 tile of the same layout
//   (two buffers), from which ldmatrix.trans reads the B fragments.  The 16-byte chunks of every shared row are XOR-permuted by
//   the row, so the eight rows of each ldmatrix phase fall on distinct
//   banks.  No second copy of w is kept in device memory.
// - An int8 weight converts to bf16 exactly (8 significant bits): a byte
//   v = l + 128 h (l its low seven bits, h its sign bit) is, read as a
//   signed value, (128 + l) - (128 + 128 h), and both terms are bf16 values
//   whose bits are 0x4300 | l and 0x4300 | (h << 7): one byte permute puts
//   two weights under 0x43 high bytes, two masks make both terms, one bf16x2
//   subtract gives two weights.  w_scale[col] is applied once per column in
//   the drain: the kernel computes s * sum(x * w) where the reference
//   computes sum(x * (w * s)), equal up to f32 rounding.
// - A stage's copies, conversion and products are one branch-free stretch
//   of code (copies past K are zero-filled, the width of w's copies is a
//   template parameter), so the compiler interleaves the copies and the
//   conversion with the products.  The drain goes through shared memory:
//   each thread then finishes four neighbouring columns of a row at a time
//   in a short loop (a drain unrolled over the registers, with the
//   activations inlined, was ~15,000 instructions of code per kernel), and
//   the stores are row-contiguous.
// - The 128 x 128 x 128 tile, three stages and eight warps were picked from
//   times of several shapes on the card (PERF.md): 64-deep stages, 64-row
//   blocks and sixteen warps were slower at M = 512.  What bounds the
//   kernel then is mma.sync itself: on this card its m16n8k16 products run
//   at about half the rate of the tensor cores' wgmma peak, and the copies
//   and the conversion do not fully hide behind them.
// - The tensor cores add into their f32 accumulator without rounding to
//   nearest (they truncate), which over K / 16 steps drifts by ~1e-5 of
//   the sum's scale.  Each stage's products are therefore summed from zero
//   in the tensor cores and added to the running sum with IEEE f32 adds.
// - Ragged edges of M, N and K are zero-filled in shared memory (zeros add
//   nothing) and the stores are masked.  N % 16 == 0 copies w in 16-byte
//   pieces, other N (N % 4 == 0) in 4-byte ones.
//
// Rows are independent: the k stages, their order and every add are fixed
// by K alone (no split-K chosen by shape, no atomics), so row m's bits
// depend only on row m of x and on w, never on M or on the other rows.
// They do differ from the GEMV's bits: the engine, whose parity with its
// batch-1 reference needs one path for every M, never takes this kernel.

constexpr int TC_BM = 128;                       // output rows per block
constexpr int TC_BN = 128;                       // output columns per block
constexpr int TC_BK = 128;                       // k per stage
constexpr int TC_STAGES = 3;                     // shared-memory ring of x and int8 w
constexpr int TC_WARPS_M = 2, TC_WARPS_N = 4;    // the block's warp grid
constexpr int TC_MIN_BLOCKS = 1;                 // blocks per SM the registers allow
constexpr int TC_THREADS = 32 * TC_WARPS_M * TC_WARPS_N;
constexpr int TC_WM = TC_BM / TC_WARPS_M;        // rows per warp
constexpr int TC_WN = TC_BN / TC_WARPS_N;        // columns per warp
constexpr int TC_MI = TC_WM / 16;                // m16 tiles per warp
constexpr int TC_NI = TC_WN / 8;                 // n8 tiles per warp
constexpr int TC_X_ROW = TC_BK * 2;              // bytes of a row of x's tile
constexpr int TC_B_ROW = TC_BN * 2;              // bytes of a row of the bf16 w tile
constexpr int TC_X_BYTES = TC_BM * TC_X_ROW;     // one stage of x (bf16)
constexpr int TC_W_BYTES = TC_BK * TC_BN;        // one stage of w (int8)
constexpr int TC_B_BYTES = TC_BK * TC_B_ROW;     // one converted stage of w (bf16)
constexpr int TC_STAGE = TC_X_BYTES + TC_W_BYTES;
constexpr int TC_SMEM = TC_STAGES * TC_STAGE + 2 * TC_B_BYTES;
constexpr int TC_X_COPIES = TC_X_BYTES / 16 / TC_THREADS;  // 16-byte copies per thread
constexpr int TC_W_COPIES = TC_W_BYTES / 16 / TC_THREADS;  // ... and conversions
constexpr int TC_X_RSTEP = TC_THREADS / (TC_X_ROW / 16);   // rows between a thread's copies
constexpr int TC_W_RSTEP = TC_THREADS / (TC_BN / 16);
static_assert(TC_X_ROW % 128 == 0 && TC_BN == 128, "whole 128-byte rows; int8 w's are 128 bytes");
static_assert(TC_NI % 2 == 0, "B fragments in pairs of n8 tiles");
static_assert(TC_X_COPIES * 16 * TC_THREADS == TC_X_BYTES &&
                  TC_W_COPIES * 16 * TC_THREADS == TC_W_BYTES,
              "tiles in whole copies");
static_assert(TC_STAGES >= 3, "a stage is converted one ahead of its products");
static_assert(TC_SMEM <= 227 * 1024, "shared memory of one block");

// Byte offset of 16-byte chunk c of row r of a shared tile of ROW-byte rows.
template <int ROW>
__device__ __forceinline__ int swz(int r, int c) {
  return r * ROW + ((c ^ (r & 7)) << 4);
}

// Bytes j and j + 1 of w (int8 values) as a bf16 pair, byte j in the low
// half (sel = 0x4140 for j = 0, 0x4342 for j = 2); c43 holds 0x43434343.
// Exact.
template <unsigned SEL>
__device__ __forceinline__ unsigned s8x2_to_bf16x2(unsigned w, unsigned c43) {
  const unsigned t = __byte_perm(w, c43, SEL);  // halves 0x43 : byte
  const unsigned lo = t & 0x437F437Fu;          // 128 + l
  const unsigned hi = t & 0x43804380u;          // 128 + 128 h
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&lo),
                                   *reinterpret_cast<const __nv_bfloat162*>(&hi));
  return *reinterpret_cast<const unsigned*>(&d);
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a * b, the same product summed from zero.
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                              unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

constexpr int TC_C_ROW = TC_BN + 8;  // f32 per row of the drain's tile (padded: no bank conflicts)
static_assert(TC_BM * TC_C_ROW * 4 <= TC_SMEM, "the drain's tile fits the ring");

// COPY16: N % 16 == 0, so w is copied in 16-byte pieces (else 4-byte ones).
template <typename OT, bool COPY16>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
qmatmul_w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ w_scale, const float* __restrict__ bias,
                         OT* __restrict__ out, int M, int K, int N, int act) {
  // TC_STAGES stages of (TC_BM rows of x, TC_BK rows of int8 w), then two
  // bf16 tiles of w
  extern __shared__ __align__(128) uint8_t smem[];
  auto x_tile = [&](int s) { return smem + s * TC_STAGE; };
  auto w_tile = [&](int s) { return smem + s * TC_STAGE + TC_X_BYTES; };
  auto b_tile = [&](int s) { return smem + TC_STAGES * TC_STAGE + s * TC_B_BYTES; };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * TC_BM;  // blocks of one column strip run together,
  const int n0 = blockIdx.y * TC_BN;  // so its weights come from L2 after the first
  const int wm = warp / TC_WARPS_N, wn = warp % TC_WARPS_N;
  const int ktiles = (K + TC_BK - 1) / TC_BK;
  const unsigned c43 = 0x43434343u;

  // Copy i of this thread: x row xr + i TC_X_RSTEP, 16-byte chunk xc; w row
  // wr + i TC_W_RSTEP of the stage, 16-byte chunk wc.  The same chunks are
  // converted by this thread.
  const int xr = tid / (TC_X_ROW / 16), xc = tid % (TC_X_ROW / 16);
  const int wr = tid / (TC_BN / 16), wc = tid % (TC_BN / 16);
  const __nv_bfloat16* xp = x + (size_t)(m0 + xr) * K + 8 * xc;
  const int8_t* wp = w + (size_t)wr * N + n0 + 16 * wc;
  const bool w_col_ok = n0 + 16 * wc < N;

  // Stage kt into slot s; a stage past the last is all zero-fill.
  auto load = [&](int s, int kt) {
    const int k0 = kt * TC_BK;
    const bool kx = k0 + 8 * xc < K;  // K % 8 == 0: a copy is all in or out
#pragma unroll
    for (int i = 0; i < TC_X_COPIES; ++i) {
      const bool ok = kx && m0 + xr + i * TC_X_RSTEP < M;
      cp_async16(x_tile(s) + swz<TC_X_ROW>(xr + i * TC_X_RSTEP, xc),
                 ok ? xp + (size_t)i * TC_X_RSTEP * K + k0 : x, ok);
    }
#pragma unroll
    for (int i = 0; i < TC_W_COPIES; ++i) {
      const int k = k0 + wr + i * TC_W_RSTEP;
      const int8_t* src = wp + (size_t)(k0 + i * TC_W_RSTEP) * N;
      uint8_t* dst = w_tile(s) + swz<TC_BN>(wr + i * TC_W_RSTEP, wc);
      if (COPY16) {
        const bool ok = k < K && w_col_ok;
        cp_async16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {  // N % 4 == 0: a 4-byte piece is all in or out
          const bool ok = k < K && n0 + 16 * wc + 4 * q < N;
          cp_async4(dst + 4 * q, ok ? src + 4 * q : w, ok);
        }
      }
    }
  };

  // The int8 chunks this thread copied into stage s, as bf16 into b_tile(b):
  // 16 weights of one row, two 16-byte chunks of the bf16 row.
  auto convert = [&](int s, int b) {
#pragma unroll
    for (int i = 0; i < TC_W_COPIES; ++i) {
      const int r = wr + i * TC_W_RSTEP;
      const uint4 q = *reinterpret_cast<const uint4*>(w_tile(s) + swz<TC_BN>(r, wc));
      const unsigned in[4] = {q.x, q.y, q.z, q.w};
      unsigned o[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // bytes n, n+1 -> one pair; n+2, n+3 -> the next
        o[2 * j] = s8x2_to_bf16x2<0x4140>(in[j], c43);
        o[2 * j + 1] = s8x2_to_bf16x2<0x4342>(in[j], c43);
      }
      *reinterpret_cast<uint4*>(b_tile(b) + swz<TC_B_ROW>(r, 2 * wc)) =
          make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(b_tile(b) + swz<TC_B_ROW>(r, 2 * wc + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[TC_MI][TC_NI][4];
#pragma unroll
  for (int i = 0; i < TC_MI; ++i)
#pragma unroll
    for (int j = 0; j < TC_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    load(s, s);
    cp_async_commit();
  }
  cp_async_wait<TC_STAGES - 2>();  // stage 0 has landed (this thread's copies, which
  convert(0, 0);                   // are the ones it converts)

  for (int kt = 0; kt < ktiles; ++kt) {
    // Stage kt + 1 has landed; after the barrier every thread's copies and
    // conversions are visible, and stage kt - 1 and bf16 tile (kt + 1) % 2
    // are free.
    cp_async_wait<TC_STAGES - 3>();
    __syncthreads();
    load((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    cp_async_commit();
    convert((kt + 1) % TC_STAGES, (kt + 1) % 2);  // past the last stage: unused

    const uint8_t* xs = x_tile(kt % TC_STAGES);
    const uint8_t* bs = b_tile(kt % 2);
    float part[TC_MI][TC_NI][4];  // this stage's products, summed from zero
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      // A of m16 tile mi: rows lane % 16, k-chunk 2 ks + lane / 16.  B of
      // n8 tiles 2 p, 2 p + 1 (ldmatrix.trans): matrix q = lane / 8 holds
      // k 8 (q % 2) .. + 7 of the warp's column chunk 2 p + q / 2.
      unsigned a[TC_MI][4], b[TC_NI][2];
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
        ldmatrix_x4(a[mi],
                    xs + swz<TC_X_ROW>(wm * TC_WM + mi * 16 + lane % 16, 2 * ks + lane / 16));
#pragma unroll
      for (int p = 0; p < TC_NI / 2; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, bs + swz<TC_B_ROW>(16 * ks + 8 * ((lane / 8) % 2) + lane % 8,
                                                wn * TC_WN / 8 + 2 * p + lane / 16));
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TC_NI; ++ni) {
          if (ks == 0)
            mma_bf16_zero(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
          else
            mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < TC_MI; ++i)
#pragma unroll
      for (int j = 0; j < TC_NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the drain's tile now

  // accumulator e of tile (mi, ni): row g + 8 (e / 2), column 2 t + e % 2
  float* ct = reinterpret_cast<float*>(smem);
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * TC_WM + mi * 16 + g + 8 * half, c = wn * TC_WN + ni * 8 + 2 * t;
        *reinterpret_cast<float2*>(ct + r * TC_C_ROW + c) =
            make_float2(acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
  // this thread's four columns are the same in every row it finishes
  static_assert(TC_THREADS % (TC_BN / 4) == 0, "a thread keeps its columns");
  const int c = 4 * (tid % (TC_BN / 4)), col = n0 + c;
  const bool col_ok = col < N;  // N % 4 == 0: four columns all in or out
  float sc[4], bi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    sc[q] = col_ok ? w_scale[col + q] : 0.f;
    bi[q] = col_ok && bias != nullptr ? bias[col + q] : 0.f;
  }
  __syncthreads();
  if (!col_ok) return;
#pragma unroll 1
  for (int r = tid / (TC_BN / 4); r < TC_BM && m0 + r < M; r += TC_THREADS / (TC_BN / 4)) {
    const float4 a = *reinterpret_cast<const float4*>(ct + r * TC_C_ROW + c);
    float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] *= sc[q];
      if (bias != nullptr) v[q] += bi[q];
      v[q] = activate(v[q], act);
    }
    store4(out + (size_t)(m0 + r) * N + col, v);
  }
}

template <typename OT, bool COPY16>
cudaError_t launch_mma_kernel(const void* x, const void* w, const void* w_scale, const void* bias,
                       void* out, int M, int K, int N, int act, cudaStream_t stream) {
  const auto kernel = qmatmul_w8a16_mma_kernel<OT, COPY16>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN);
  kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), static_cast<OT*>(out),
      M, K, N, act);
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_mma(const void* x, const void* w, const void* w_scale, const void* bias,
                       void* out, int M, int K, int N, int act, cudaStream_t stream) {
  return N % 16 == 0
             ? launch_mma_kernel<OT, true>(x, w, w_scale, bias, out, M, K, N, act, stream)
             : launch_mma_kernel<OT, false>(x, w, w_scale, bias, out, M, K, N, act, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
extern "C" int qmatmul_w8a16(const void* x, int x_bf16, const void* w, const void* w_scale,
                             const void* bias, void* out, int out_bf16, int M, int K, int N,
                             int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, w_scale, bias, out, M, K, N, act, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, w_scale, bias, out, M, K, N, act, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, w, w_scale, bias, out, M, K, N, act, s);
  else
    launch<float, float>(x, w, w_scale, bias, out, M, K, N, act, s);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core kernel: x bf16 only, K % 8 == 0, N % 4 == 0, x 16-byte and
// w 4-byte aligned (the wrapper checks).  Returns the first CUDA error of
// the launch, so a refused launch is reported to the caller.
extern "C" int qmatmul_w8a16_mma(const void* x, const void* w, const void* w_scale,
                                 const void* bias, void* out, int out_bf16, int M, int K, int N,
                                 int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_mma<__nv_bfloat16>(x, w, w_scale, bias, out, M, K, N, act, s)
               : launch_mma<float>(x, w, w_scale, bias, out, M, K, N, act, s);
  return static_cast<int>(err);
}
