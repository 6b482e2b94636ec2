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
// decode tick (M = 8 or 16) that is far below the ~590 operations per byte
// at which the card's int8 arithmetic, not its memory, becomes the limit:
// the weight stream bounds it.  At a prefill of 16 x 32 tokens (M = 512) it
// is 1,024, past that line: the int8 operations bound it.  So there are two
// kernels, and the wrapper (kernels/qmatmul.py) picks one by M alone:
//
// 1. The GEMV, for the decode tick's few rows, built for the weight stream
//    like qmatmul_w8a16.cu's GEMV:
//    - One pass over w for up to MR = 16 rows: a block holds 16 rows of x,
//      so at M <= 16 every weight byte is read from device memory once per
//      launch (more rows are covered by gridDim.y, each 16-row slab
//      re-reading w; the wrapper sends them to path 2).
//    - Blocks and bytes in flight.  Little's law at 3.35 TB/s and ~1 us of
//      latency asks for ~25 KB in flight per SM.  A block owns a strip of BN
//      output columns and one range of w's rows, walked in BK-row stages
//      through a ring of STAGES shared-memory buffers filled by cp.async
//      STAGES - 1 stages ahead (24 KB of w in flight per block, three
//      blocks per SM).  The split plan, computed by the wrapper from (K, N)
//      alone (kernels/qmatmul.py::w8a8_split_plan) and passed in, cuts K
//      into `splits` ranges of `split_rows` rows (a multiple of 32) so that
//      every projection, wk and wv's 4 strips too, puts at least one block
//      on each of the 132 SMs: one wave of up to three blocks per SM.
//    - The products on the int8 tensor cores, operands swapped: a 16-column
//      piece of w is the A operand of mma.sync m16n8k32 (16 x 32 k) and 8
//      rows of x the B operand (one n8 tile at M <= 8, two at M <= 16).
//      Warp (cg, kq) multiplies columns 32 cg .. 32 cg + 31 of the strip
//      with rows 32 kq .. 32 kq + 31 of each stage.  The fragments want four
//      consecutive k of one column per register, and w lies n-contiguous,
//      so each lane reads the 4 columns 4g .. 4g + 3 (g = lane / 4) of 8
//      rows as 8 words and turns them with two 4x4 byte transposes into the
//      A registers of two m16 tiles (tile j: columns 4g + 2j and 4g + 2j + 1
//      as its rows g and g + 8).  The lane's k slots 4t .. 4t + 3 and
//      16 + 4t .. 16 + 4t + 3 (t = lane % 4) stand for rows 8t .. 8t + 7 of
//      the warp's 32, in both operands, so its B registers are one 8-byte
//      read of a row of x as it lies; a sum over k does not depend on the
//      order of its terms.  No weight byte is transposed twice or stored
//      twice in shared memory, and the multiply costs a few instructions per
//      512 weight bytes: the stream sets the pace, not the arithmetic.
//    - Padding puts every warp-wide read of shared memory on 32 banks: 32
//      bytes after every 8 rows of w's stage (the lanes' four row groups),
//      32 after every row of x's.
//    - The combine, in the same launch.  The KQ k-slices of a block add
//      through shared memory.  With more than one split, every block stores
//      its int32 partial tile to a workspace (allocated by the wrapper),
//      fences and takes a ticket from its strip's arrival counter; the block
//      that arrives last adds all the partials, drains them and sets the
//      counter back to 0 for the next launch.  With one split the block
//      drains directly.
//    Ragged edges of M, N, K and of a split's range are zero-filled in
//    shared memory (zeros add nothing to an integer sum) and the stores are
//    masked; w is copied in 16-byte pieces when N % 16 == 0 and it is
//    16-byte aligned, in 4-byte pieces otherwise.
// 2. mma.sync on the int8 tensor cores, for a prefill's hundreds of rows,
//    where the GEMV would re-read w for every 16-row slab.  A block owns a
//    TC_BM x TC_BN output tile; each of its eight warps owns a 32 x 32 piece
//    of it as 2 x 4 m16n8k32 products with int32 accumulators in registers.
//    K is walked in TC_BK-byte stages through two buffers of shared memory:
//    while stage k is multiplied, stage k+1 of x is copied in
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
// order in which either kernel adds its products, nor on how the GEMV's
// k-slices and splits cut K, and both drain it with
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

// --- path 1: the GEMV ----------------------------------------------------------

constexpr int BN = 64;             // output columns per block (a strip)
constexpr int BK = 128;            // rows of w per stage
constexpr int STAGES = 4;          // the cp.async ring
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CG = BN / 32;        // column groups: 32 columns per warp
constexpr int KQ = WARPS / CG;     // k-slices: 32 rows of each stage per warp
constexpr int MR = 16;             // rows of x per block (two n8 tiles)
constexpr int W_PAD = 32;          // bytes after every 8 rows of w's stage
constexpr int W_BYTES = BK * BN + BK / 8 * W_PAD;  // one stage of w
constexpr int X_ROW = BK + 32;     // bytes of a row of x's stage (padded)
constexpr int STAGE = W_BYTES + MR * X_ROW;
constexpr int RING = STAGES * STAGE;
constexpr int RED_ROW = BN + 4;    // int32 of a row of the k-slices' partials (padded)
constexpr int QUADS = MR * BN / 4; // (row, four columns) pieces of a block's tile
static_assert(BK == 32 * KQ && CG * KQ == WARPS, "one m16n8k32 k step per warp and stage");
static_assert(QUADS == THREADS, "the combine gives one quad per thread");
static_assert(KQ * MR * RED_ROW * 4 <= RING, "the k-slices' partials fit the ring");
static_assert(RING <= 48 * 1024, "static shared memory; more needs the dynamic opt-in");
static_assert(W_BYTES % 16 == 0 && X_ROW % 16 == 0 && STAGE % 16 == 0, "16-byte copies");

// Byte offset of row r of w's stage.
__device__ __forceinline__ int w_row(int r) { return r * BN + (r >> 3) * W_PAD; }

// a0..a3 hold rows k..k+3 of four neighbouring columns (byte j = column j);
// col[j] gets column j's rows k..k+3 (byte i = row k+i).
__device__ __forceinline__ void transpose4(unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                           unsigned (&col)[4]) {
  const unsigned lo01 = __byte_perm(a0, a1, 0x5140);  // a0.0 a1.0 a0.1 a1.1
  const unsigned lo23 = __byte_perm(a2, a3, 0x5140);  // a2.0 a3.0 a2.1 a3.1
  const unsigned hi01 = __byte_perm(a0, a1, 0x7362);  // a0.2 a1.2 a0.3 a1.3
  const unsigned hi23 = __byte_perm(a2, a3, 0x7362);  // a2.2 a3.2 a2.3 a3.3
  col[0] = __byte_perm(lo01, lo23, 0x5410);
  col[1] = __byte_perm(lo01, lo23, 0x7632);
  col[2] = __byte_perm(hi01, hi23, 0x5410);
  col[3] = __byte_perm(hi01, hi23, 0x7632);
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

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// NT: n8 tiles of x's rows (1 for M <= 8, else 2).  COPY16: N % 16 == 0 and w
// 16-byte aligned, so w is copied in 16-byte pieces (else 4-byte ones).
template <typename OT, bool COPY16, int NT>
__global__ void __launch_bounds__(THREADS, 3)
qmatmul_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                    const float* __restrict__ bias, OT* __restrict__ out, int M, int K, int N,
                    int act, int splits, int split_rows, int* __restrict__ work,
                    int* __restrict__ counters) {
  __shared__ __align__(16) unsigned char smem[RING];
  __shared__ int ticket;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int strip = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = strip * BN, m0 = blockIdx.y * MR;
  const int kb = split * split_rows, ke = min(K, kb + split_rows);
  const int nst = (ke - kb + BK - 1) / BK;  // stages of this block's range

  // Copies of stage s into its ring slot: w's BK x BN tile, x's MR x BK tile.
  auto load_stage = [&](int s) {
    const int k0 = kb + s * BK;
    unsigned char* sw = smem + (s % STAGES) * STAGE;
    constexpr int PIECE = COPY16 ? 16 : 4;  // bytes per copy
#pragma unroll
    for (int i = 0; i < BK * BN / PIECE / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e / (BN / PIECE), c = (e % (BN / PIECE)) * PIECE;
      const bool ok = k0 + r < ke && n0 + c < N;  // N % 4 == 0: a piece is all in or out
      const int8_t* src = ok ? w + (size_t)(k0 + r) * N + n0 + c : w;
      if (COPY16)
        cp_async16(sw + w_row(r) + c, src, ok);
      else
        cp_async4(sw + w_row(r) + c, src, ok);
    }
    for (int e = tid; e < 8 * NT * BK / 16; e += THREADS) {
      const int m = e / (BK / 16), c = (e % (BK / 16)) * 16;
      const bool ok = m0 + m < M && k0 + c < ke;  // K % 16 == 0: a copy is all in or out
      cp_async16(sw + W_BYTES + m * X_ROW + c, ok ? x + (size_t)(m0 + m) * K + k0 + c : x, ok);
    }
  };

  // Lane (g, t) of warp (cg, kq): w's rows 32 kq + 8 t .. + 7 of a stage,
  // columns 32 cg + 4 g .. + 3 of the strip; x's rows g and 8 + g at the same
  // eight k.  acc[j][nt]: columns 4 g + 2 j (e = 0, 1) and 4 g + 2 j + 1
  // (e = 2, 3), rows 8 nt + 2 t + e % 2.
  const int cg = warp % CG, kq = warp / CG, g = lane >> 2, t = lane & 3;
  const int w_off = w_row(32 * kq + 8 * t) + 32 * cg + 4 * g;
  const int x_off = W_BYTES + g * X_ROW + 32 * kq + 8 * t;
  int acc[2][NT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s has landed; the slot refilled below is consumed
    if (s + STAGES - 1 < nst) load_stage(s + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (s % STAGES) * STAGE;
    unsigned v[8];  // rows 8 t + i of the warp's 32, four columns each
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = *reinterpret_cast<const unsigned*>(st + w_off + i * BN);
    unsigned lo[4], hi[4];  // column 4 g + j: rows 8 t .. 8 t + 3 (lo), 8 t + 4 .. (hi)
    transpose4(v[0], v[1], v[2], v[3], lo);
    transpose4(v[4], v[5], v[6], v[7], hi);
    const unsigned a[2][4] = {{lo[0], lo[1], hi[0], hi[1]}, {lo[2], lo[3], hi[2], hi[3]}};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint2 b = *reinterpret_cast<const uint2*>(st + x_off + 8 * nt * X_ROW);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_s8(acc[j][nt], a[j], b.x, b.y);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the k-slices' partials

  int* red = reinterpret_cast<int*>(smem);  // [KQ][MR][RED_ROW]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<int4*>(red + (kq * MR + 8 * nt + 2 * t + h) * RED_ROW + 32 * cg + 4 * g) =
          make_int4(acc[0][nt][h], acc[0][nt][2 + h], acc[1][nt][h], acc[1][nt][2 + h]);
  __syncthreads();
  // thread tid: row qr of the slab, columns qc .. qc + 3 of the strip
  const int qr = tid / (BN / 4), qc = 4 * (tid % (BN / 4));
  const int row = m0 + qr, col = n0 + qc;
  const bool live = qr < 8 * NT && row < M && col < N;  // N % 4 == 0: all four or none
  int4 sum = make_int4(0, 0, 0, 0);
  if (qr < 8 * NT) {
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      sum = add4(sum, *reinterpret_cast<const int4*>(red + (q * MR + qr) * RED_ROW + qc));
  }

  if (splits > 1) {  // the splits of this strip: the last block to arrive adds them
    if (live) *reinterpret_cast<int4*>(work + ((size_t)split * M + row) * N + col) = sum;
    __threadfence();
    __syncthreads();
    int* counter = counters + blockIdx.y * (gridDim.x / splits) + strip;
    if (tid == 0) ticket = atomicAdd(counter, 1);
    __syncthreads();
    if (ticket != splits - 1) return;
    __threadfence();
    if (live) {
      const int4* p = reinterpret_cast<const int4*>(work + (size_t)row * N + col);
      const size_t stride = (size_t)M * N / 4;  // one split's partials, in int4
      sum = make_int4(0, 0, 0, 0);
      int q = 0;
      for (; q + 8 <= splits; q += 8) {  // eight loads in flight
        int4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = __ldcg(p + (q + u) * stride);
#pragma unroll
        for (int u = 0; u < 8; ++u) sum = add4(sum, v[u]);
      }
      for (; q < splits; ++q) sum = add4(sum, __ldcg(p + q * stride));
    }
    if (tid == 0) *counter = 0;
  }
  if (!live) return;
  const float xs = *x_scale;
  const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    drain_w8a8(out + (size_t)row * N + col + j, s4[j], xs, w_scale[col + j], bias, col + j, act);
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
      unsigned c[4];
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

template <typename OT, bool COPY16>
void launch_gemv(const int8_t* x, const int8_t* w, const float* x_scale, const float* w_scale,
                 const float* bias, OT* out, int M, int K, int N, int act, int splits,
                 int split_rows, int* work, int* counters, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN * splits, (M + MR - 1) / MR);
  const auto kernel =
      M <= 8 ? qmatmul_w8a8_kernel<OT, COPY16, 1> : qmatmul_w8a8_kernel<OT, COPY16, 2>;
  kernel<<<grid, THREADS, 0, stream>>>(x, w, x_scale, w_scale, bias, out, M, K, N, act, splits,
                                       split_rows, work, counters);
}

template <typename OT>
void launch(const void* x, const void* w, const void* x_scale, const void* w_scale,
            const void* bias, void* out, int M, int K, int N, int act, bool tensor_cores,
            int splits, int split_rows, void* work, void* counters, cudaStream_t stream) {
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
    auto* wk = static_cast<int*>(work);
    auto* cp = static_cast<int*>(counters);
    if (N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0)
      launch_gemv<OT, true>(xp, wp, xsp, wsp, bp, op, M, K, N, act, splits, split_rows, wk, cp,
                            stream);
    else
      launch_gemv<OT, false>(xp, wp, xsp, wsp, bp, op, M, K, N, act, splits, split_rows, wk, cp,
                             stream);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  tensor_cores picks the kernel
// (the wrapper decides by M).  The GEMV (tensor_cores == 0) runs under the
// split plan: splits ranges of split_rows rows (a multiple of 32) covering
// [0, K), with a workspace of splits * M * N int32 and one int counter per
// (16-row slab, strip), all 0, when splits > 1 (the kernel leaves the
// counters 0).  Returns cudaGetLastError() after the launch, so a refused
// launch is reported to the caller.
extern "C" int qmatmul_w8a8(const void* x, const void* w, const void* x_scale,
                            const void* w_scale, const void* bias, void* out, int out_bf16,
                            int M, int K, int N, int act, int tensor_cores, int splits,
                            int split_rows, void* work, void* counters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = tensor_cores != 0;
  if (out_bf16)
    launch<__nv_bfloat16>(x, w, x_scale, w_scale, bias, out, M, K, N, act, tc, splits,
                          split_rows, work, counters, s);
  else
    launch<float>(x, w, x_scale, w_scale, bias, out, M, K, N, act, tc, splits, split_rows, work,
                  counters, s);
  return static_cast<int>(cudaGetLastError());
}
