// int8 x int8 matmul for Hopper (sm_90a) with int32 accumulation:
// out = act(float(x @ w) * x_scale * w_scale[col] + bias).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul.py::qmatmul_w8a8
// (body _w8a8_kernel).  x is (M, K) int8 with one f32 scale for the whole
// tensor (x_scale, a device scalar), w is (K, N) int8 row-major with one
// f32 scale per output column, bias is (N,) f32 or absent, out is (M, N)
// bf16 or f32.  K must be a multiple of 16, N of 4, w 4-byte and x 16-byte
// aligned (the wrapper checks); M is any.
//
// What bounds it: the product does 2*M operations per weight byte.  At a
// decode tick (M = 8) that is far below the ~590 operations per byte at
// which the card's int8 arithmetic, not its memory, becomes the limit: the
// weight stream bounds it.  At a prefill of 16 x 32 tokens (M = 512) it is
// 1,024, past that line: the int8 operations bound it.  So there are two
// kernels, and the wrapper (kernels/qmatmul.py) picks one by M alone:
//
// 1. __dp4a, for the decode tick's few rows, built for the weight stream
//    like qmatmul_w8a16.cu.  A block owns a strip of BN output columns;
//    each thread owns CPT neighbouring columns and reads them as one 4-byte
//    word, so a warp reads whole 32-byte sectors of w's rows.  The block's
//    KS k-slices each walk one contiguous range of w's rows in groups of G,
//    the next group loaded while the current one is multiplied.  A 4x4 byte
//    transpose (__byte_perm) turns four row words into four column words,
//    each holding four consecutive k of one column, which __dp4a (four
//    int8 products and their sum, added to an int32) multiplies with four
//    bytes of a row of x.  The KS partial sums are added through shared
//    memory.  M beyond MT rows is covered by gridDim.y, each MT-row slab
//    re-reading w.
// 2. mma.sync on the int8 tensor cores, for a prefill's hundreds of rows,
//    where __dp4a's integer units reach ~1% of the tensor cores' rate.  A
//    block owns a TC_BM x TC_BN output tile; each of its eight warps owns a
//    32 x 32 piece of it as 2 x 4 m16n8k32 products with int32 accumulators
//    in registers.  K is walked in TC_BK-byte stages through two buffers of
//    shared memory: while stage k is multiplied, stage k+1 of x is copied in
//    with cp.async and stage k+1 of w is loaded into registers (full 32-byte
//    sectors: neighbouring threads read neighbouring words of a row).  x's
//    tile is row-major with k contiguous, the A fragment's layout, so
//    ldmatrix reads it as it lies.  The B fragment wants four consecutive k
//    of one column per register, and w is row-major with n contiguous, so
//    the w tile goes through the same 4x4 byte transpose on its way into
//    shared memory and lies there n-major with k contiguous; w keeps its
//    layout in device memory.  The 16-byte chunks of each shared row are
//    permuted by an XOR of the row (swz), so that ldmatrix's reads and the
//    transposed stores fall on distinct banks.  Ragged edges of M, N and K
//    are zero-filled in shared memory (zeros add nothing to an integer sum)
//    and the stores are masked.  The 64 x 128 x 128 tile was picked from
//    times of several tile shapes on the card: with two stages the kernel
//    waits on one global round trip per stage (it takes about as long at
//    M = 8 as at M = 512), so a tile small enough for two blocks per SM
//    beat the 128 x 128 one, and a deeper stage ran out of registers.
//
// Why the two paths give identical bits: every product of int8 values and
// every sum of them is exact in int32 (|sum| <= K * 127^2 < 2^31 for
// K < 133,000), so the integer sum of an output does not depend on the
// order in which either kernel adds its products, and both drain it with
// the one function drain_w8a8 (epilogue.cuh): float(acc) * x_scale, then
// * w_scale[col], then + bias, then the activation, rounded step by step
// as the reference rounds (__fmul_rn / __fadd_rn, no fused multiply-add).
// A row's bits therefore depend only on its own row of x: not on M, not on
// the other rows, not on the path the wrapper picked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

// --- path 1: __dp4a ---------------------------------------------------------

constexpr int BN = 32;             // output columns per block
constexpr int CPT = 4;             // columns per thread (one 4-byte load)
constexpr int TN = BN / CPT;       // column threads per block
constexpr int KS = 32;             // k-slices per block
constexpr int THREADS = TN * KS;   // 256
constexpr int G = 16;              // rows of w per group (one 16-byte x load)
constexpr int MT = 8;              // rows of x per block
static_assert(THREADS == MT * BN, "the drain gives one output per thread");

__device__ __forceinline__ void load_w(const int8_t* w, size_t row_stride, int (&out)[G]) {
#pragma unroll
  for (int u = 0; u < G; ++u) out[u] = __ldg(reinterpret_cast<const int*>(w + u * row_stride));
}

// a0..a3 hold rows k..k+3 of four neighbouring columns (byte j = column j);
// col[j] gets column j's rows k..k+3 (byte i = row k+i).
__device__ __forceinline__ void transpose4(unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                           int (&col)[4]) {
  const unsigned lo01 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const unsigned lo23 = __byte_perm(a2, a3, 0x5140);  // a2.0 a3.0 a2.1 a3.1
  const unsigned hi01 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const unsigned hi23 = __byte_perm(a2, a3, 0x7362);  // a2.2 a3.2 a2.3 a3.3
  col[0] = static_cast<int>(__byte_perm(lo01, lo23, 0x5410));
  col[1] = static_cast<int>(__byte_perm(lo01, lo23, 0x7632));
  col[2] = static_cast<int>(__byte_perm(hi01, hi23, 0x5410));
  col[3] = static_cast<int>(__byte_perm(hi01, hi23, 0x7632));
}

template <typename OT>
__global__ void __launch_bounds__(THREADS, 2)
qmatmul_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                    const float* __restrict__ bias, OT* __restrict__ out, int M, int K, int N,
                    int act) {
  __shared__ int red[KS][MT][BN];

  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int ks = tid / TN;
  const int m0 = blockIdx.y * MT;
  const int n = blockIdx.x * BN + tn * CPT;

  int acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0;

  if (n < N) {  // N % CPT == 0, so a column group is all in or all out
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
      int wc[CPT][G / 4];  // wc[j][q]: column n + j, rows k + 4q .. k + 4q + 3
#pragma unroll
      for (int q = 0; q < G / 4; ++q) {
        int c[4];
        transpose4(wv[4 * q], wv[4 * q + 1], wv[4 * q + 2], wv[4 * q + 3], c);
#pragma unroll
        for (int j = 0; j < CPT; ++j) wc[j][q] = c[j];
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m < M) {
          const int4 xv = __ldg(reinterpret_cast<const int4*>(x + (size_t)(m0 + m) * K + k));
          const int xw[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int q = 0; q < G / 4; ++q)
#pragma unroll
            for (int j = 0; j < CPT; ++j) acc[m][j] = __dp4a(xw[q], wc[j][q], acc[m][j]);
        }
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
  int s = 0;
#pragma unroll 8
  for (int q = 0; q < KS; ++q) s += red[q][m][c];
  const int row = m0 + m, col = blockIdx.x * BN + c;
  if (row < M && col < N)
    drain_w8a8(out + (size_t)row * N + col, s, *x_scale, w_scale[col], bias, col, act);
}

// --- path 2: mma.sync on the int8 tensor cores --------------------------------

constexpr int TC_BM = 64;                        // output rows per block
constexpr int TC_BN = 128;                       // output columns per block
constexpr int TC_BK = 128;                       // bytes of k per stage
constexpr int TC_WARPS_M = 2, TC_WARPS_N = 4;    // the block's warp grid
constexpr int TC_THREADS = 32 * TC_WARPS_M * TC_WARPS_N;
constexpr int TC_WM = TC_BM / TC_WARPS_M;        // rows per warp
constexpr int TC_WN = TC_BN / TC_WARPS_N;        // columns per warp
constexpr int TC_MI = TC_WM / 16;                // m16 tiles per warp
constexpr int TC_NI = TC_WN / 8;                 // n8 tiles per warp
constexpr int TC_CG = TC_BN / 4;                 // 4-column groups of a row of w's tile
constexpr int TC_KG = TC_THREADS / TC_CG;        // groups of w's rows
constexpr int TC_BR = TC_BK / TC_KG;             // rows of w per thread and stage
constexpr int TC_A_CHUNKS = TC_BM * TC_BK / 16 / TC_THREADS;  // 16-byte copies of x per thread
constexpr int TC_STAGE = (TC_BM + TC_BN) * TC_BK;             // bytes of one stage
constexpr int TC_SMEM = 2 * TC_STAGE;
static_assert(TC_SMEM <= 48 * 1024, "static shared memory; more needs the dynamic opt-in");
static_assert(TC_BK % 128 == 0 && TC_BR % 16 == 0, "whole 128-byte rows, 16-byte stores");
static_assert(TC_CG % 8 == 0 && TC_THREADS % TC_CG == 0, "a warp reads whole 32-byte sectors");
static_assert(TC_A_CHUNKS * 16 * TC_THREADS == TC_BM * TC_BK, "x's tile in whole copies");
static_assert(TC_MI >= 1 && TC_NI % 2 == 0, "m16 tiles, pairs of n8 tiles");

// Byte offset of 16-byte chunk c of row r of a shared tile with TC_BK-byte
// rows.  The chunk's low three bits are XORed with a function of the row, so
// that eight consecutive rows (one ldmatrix phase) and eight rows four apart
// (one phase of w's transposed stores) fall on eight different bank groups.
__device__ __forceinline__ int swz(int r, int c) {
  return r * TC_BK + ((c ^ ((r ^ (r >> 2)) & 7)) << 4);
}

// c += a (16 x 32, row-major) * b (32 x 8, column-major), int8 in, int32 sums.
// Registers only (not volatile), so the compiler may interleave it with the
// fragment loads.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename OT>
__global__ void __launch_bounds__(TC_THREADS, 2)
qmatmul_w8a8_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                        const float* __restrict__ bias, OT* __restrict__ out, int M, int K,
                        int N, int act) {
  // stage s: TC_BM rows of x, then TC_BN columns of w, each k-contiguous
  __shared__ __align__(128) int8_t smem[TC_SMEM];
  auto x_tile = [&](int stage) { return smem + stage * TC_STAGE; };
  auto w_tile = [&](int stage) { return smem + stage * TC_STAGE + TC_BM * TC_BK; };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * TC_BM;  // blocks of one column strip run together,
  const int n0 = blockIdx.y * TC_BN;  // so its weights come from L2 after the first
  const int wm = warp / TC_WARPS_N, wn = warp % TC_WARPS_N;
  // w loader: columns 4cg .. 4cg+3 (neighbouring threads on neighbouring
  // words of a row), rows kg*TC_BR .. kg*TC_BR + TC_BR - 1 of the stage
  const int cg = tid % TC_CG, kg = tid / TC_CG;
  const int wcol = n0 + 4 * cg;
  const int ktiles = (K + TC_BK - 1) / TC_BK;

  auto load_x = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < TC_A_CHUNKS; ++i) {
      const int c = tid + i * TC_THREADS;
      const int r = c / (TC_BK / 16), kc = c % (TC_BK / 16);
      const bool ok = m0 + r < M && k0 + 16 * kc < K;  // K % 16 == 0: a copy is all in or out
      cp_async16(x_tile(stage) + swz(r, kc), ok ? x + (size_t)(m0 + r) * K + k0 + 16 * kc : x,
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto load_w = [&](int k0, int (&v)[TC_BR]) {
#pragma unroll
    for (int i = 0; i < TC_BR; ++i) {
      const int k = k0 + kg * TC_BR + i;
      v[i] = (wcol < N && k < K) ? __ldg(reinterpret_cast<const int*>(w + (size_t)k * N + wcol))
                                 : 0;
    }
  };
  auto store_w = [&](int stage, const int (&v)[TC_BR]) {
    int col[4][TC_BR / 4];  // col[j][q]: column 4cg+j, this thread's rows 4q .. 4q+3
#pragma unroll
    for (int q = 0; q < TC_BR / 4; ++q) {
      int c[4];
      transpose4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3], c);
#pragma unroll
      for (int j = 0; j < 4; ++j) col[j][q] = c[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < TC_BR / 16; ++q)
        *reinterpret_cast<int4*>(w_tile(stage) + swz(4 * cg + j, kg * TC_BR / 16 + q)) =
            make_int4(col[j][4 * q], col[j][4 * q + 1], col[j][4 * q + 2], col[j][4 * q + 3]);
  };

  int acc[TC_MI][TC_NI][4];
#pragma unroll
  for (int i = 0; i < TC_MI; ++i)
#pragma unroll
    for (int j = 0; j < TC_NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  int wv[TC_BR];
  load_x(0, 0);
  load_w(0, wv);
  store_w(0, wv);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < ktiles;
    if (more) {  // the next stage's loads fly while this one is multiplied
      load_x(cur ^ 1, (kt + 1) * TC_BK);
      load_w((kt + 1) * TC_BK, wv);
    }
#pragma unroll
    for (int ks = 0; ks < TC_BK / 32; ++ks) {
      // A fragment of m16 tile mi: rows g and g+8, k 4t.. and 16+4t.. (t =
      // lane % 4, g = lane / 4); B fragment of n8 tile ni: b[ni][0] holds k
      // 4t..4t+3, b[ni][1] k 16+4t..16+4t+3 of column g, one ldmatrix.x4
      // filling two n8 tiles.  All are loaded before the products.
      unsigned a[TC_MI][4], b[TC_NI][2];
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
        ldmatrix_x4(a[mi], x_tile(cur) + swz(wm * TC_WM + mi * 16 + lane % 16, 2 * ks + lane / 16));
#pragma unroll
      for (int np = 0; np < TC_NI / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, w_tile(cur) + swz(wn * TC_WN + np * 16 + lane % 8 + (lane / 16) * 8,
                                         2 * ks + (lane / 8) % 2));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TC_NI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    if (more) {
      store_w(cur ^ 1, wv);
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // the next stage is in place; this one may be overwritten
  }

  // accumulator e of tile (mi, ni): row g + 8 * (e / 2), column 2t + e % 2
  const float xscale = *x_scale;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * TC_WM + mi * 16 + g + 8 * (e / 2);
        const int col = n0 + wn * TC_WN + ni * 8 + 2 * t + e % 2;
        if (row < M && col < N)
          drain_w8a8(out + (size_t)row * N + col, acc[mi][ni][e], xscale, w_scale[col], bias,
                     col, act);
      }
}

template <typename OT>
void launch(const void* x, const void* w, const void* x_scale, const void* w_scale,
            const void* bias, void* out, int M, int K, int N, int act, bool tensor_cores,
            cudaStream_t stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(x_scale);
  const auto* wsp = static_cast<const float*>(w_scale);
  const auto* bp = static_cast<const float*>(bias);
  auto* op = static_cast<OT*>(out);
  if (tensor_cores) {
    const dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN);
    qmatmul_w8a8_mma_kernel<OT><<<grid, TC_THREADS, 0, stream>>>(xp, wp, xsp, wsp, bp, op, M, K,
                                                                 N, act);
  } else {
    const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
    qmatmul_w8a8_kernel<OT><<<grid, THREADS, 0, stream>>>(xp, wp, xsp, wsp, bp, op, M, K, N, act);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  tensor_cores picks the kernel
// (the wrapper decides by M).  Returns cudaGetLastError() after the launch,
// so a refused launch is reported to the caller.
extern "C" int qmatmul_w8a8(const void* x, const void* w, const void* x_scale,
                            const void* w_scale, const void* bias, void* out, int out_bf16,
                            int M, int K, int N, int act, int tensor_cores, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = tensor_cores != 0;
  if (out_bf16)
    launch<__nv_bfloat16>(x, w, x_scale, w_scale, bias, out, M, K, N, act, tc, s);
  else
    launch<float>(x, w, x_scale, w_scale, bias, out, M, K, N, act, tc, s);
  return static_cast<int>(cudaGetLastError());
}
