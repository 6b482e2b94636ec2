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
//    every launch whose rows must not depend on the path; and
//    qmatmul_w8a16_experts, the same GEMV over a stack of matrices (the MoE
//    layer's routed experts at every decode step: repro/models/moe.py's
//    emm is a plain einsum outside any Pallas kernel, ported here so that
//    its rows do not depend on the batch and the experts' choice stays on
//    the card), which skips the experts no row was routed to.
// 2. qmatmul_w8a16_mma -- mma.sync on the bf16 tensor cores, for the
//    full-sequence forward's hundreds of rows (see its own note further
//    down); and qmatmul_w8a16_experts_mma, the same body over a stack of
//    experts at the forward, reading each expert once.  Its sums are added
//    in another order than the GEMV's, so a row differs from the GEMV's
//    row by f32 rounding.
//
// Path 1, the GEMV.
//
// What bounds it: at a decode tick (M = 8) the product does 16 operations
// per weight byte, far below the ~295 at which the card's tensor cores,
// not its memory, are the limit; the floor is reading w once (3.03 GB per
// tick of full-width starcoder2-3b, 0.91 ms at 3.35 TB/s).  Three things
// stand between the kernel and that floor:
//
// - Blocks and bytes in flight.  Little's law at 3.35 TB/s and ~1 us of
//   latency asks for ~3 MB in flight, ~25 KB per SM.  A block owns a strip
//   of BN output columns and one contiguous range of w's rows, walked in
//   BK-row stages through a ring of STAGES shared-memory buffers filled by
//   cp.async STAGES - 1 stages ahead (16 KB of w in flight per block, in no
//   registers).  The split plan, computed by the wrapper from (K, N) alone
//   (kernels/qmatmul.py::gemv_split_plan) and passed in, cuts K into
//   `splits` ranges of `split_rows` rows so that a projection whose strips
//   alone do not fill the card gets about three blocks on every SM (the
//   launch bounds let three stay resident): one wave, equal work per SM.
// - Instructions.  Every weight byte costs 8 FMAs (one per row of x) plus
//   its dequantization, and an SM issues 128 such operations per cycle, so
//   at M = 8 the kernel is nearly as much bound by issue as by bytes.  Each
//   weight is converted once (int8 -> f32, exact) and multiplied once by
//   its column's scale, float(w) * w_scale[n] as the reference oracle
//   dequantizes, then used by the 8 FMAs of its rows; x's tile is converted
//   to f32 once per stage by the whole block (k-major, so a thread reads
//   the 8 rows of x for one k as two 16-byte loads), not by every thread
//   that uses it.
// - The combine.  The partial sums are combined in a fixed order, all in
//   one launch and with no float atomics: the k-slices of a block through
//   shared memory in slice order (two per warp by one butterfly step); the
//   splits of a strip through a workspace (allocated by the wrapper) and a
//   per-tile arrival counter: every block stores its partial tile and takes
//   a ticket with an integer atomicAdd, and the block that arrives last
//   adds all the partials in split order, applies bias and activation,
//   stores the output and sets the counter back to 0 for the next launch.
//   With one split the block drains directly.
//
// The stage's thread layout: thread (tn, ks) owns the CPT = 4 columns
// 4 tn .. 4 tn + 3 of the strip and the rows ks, ks + KS, ... of each
// stage, reading one word of w per row; the two halves of a warp read
// neighbouring rows, on distinct banks.
//
// A stack of E matrices (the MoE layer's experts, repro/models/moe.py's
// emm): x (E, M, K), w (E, K, N), w_scale (E, N), no bias, out (E, M, N).
// qmatmul_w8a16_experts_kernel runs with gridDim.z = E: a block of expert
// e offsets every pointer (its workspace and its counters too) by e's
// matrices and runs the same body, so the whole stack is one launch.  The
// wrapper's plan for a stack (kernels/qmatmul.py::gemv_experts_plan)
// counts E x strips blocks against the wave: the 60 experts of
// qwen2-moe-a2.7b fill it with one split, so a stack of them needs no
// workspace.
//
// The stack's live mask.  At a tick the stack holds every expert's rows,
// zero where no token was routed (a tick's 8 tokens reach ~25 of 60
// experts a layer), and reading every expert's weights would cost twice
// what the routed ones need.  So the stack takes a mask live (E, M) of
// uint8 flags, one per (expert, row), built on the card by the caller
// (models/moe.py) from the routing: a block whose MT-row slab holds no
// live row stores act(+0.0) on its tile and returns before any copy of w
// (at a tick a slab is a whole expert, so an unrouted expert costs only
// its stores).  act(+0.0) is what the body computes for an all-zero row:
// its sums start at +0 and every product added is +0 or -0, so they stay
// +0.
// The decision depends on the slab's flags alone, so every split of a
// dead slab returns together, takes no ticket and leaves its counters
// at 0.  A dead row in a live slab is computed with its slab (its FMAs
// are not skipped, so a live row's instructions are as without the mask)
// and stored as act(+0.0), so a dead row's output never depends on what
// its row of x holds.  No mask (nullptr) means every row is live.
//
// Rows are independent: the plan, the stages, the slices and every add are
// fixed by (E, K, N), so row m's arithmetic depends only on row m of x and on
// w, never on M or on the other rows.  The serving engine's bit-for-bit
// parity with its batch-1 sequential reference depends on that.  M larger
// than MT is covered by gridDim.y, one MT-row slab per block row, with the
// same per-row math.  Rows past M, columns past N and rows past a split's
// range are zero-filled in shared memory and add nothing.  K must be a
// multiple of 8, x 16-byte and w 4-byte aligned (the wrapper checks); w is
// copied in 16-byte pieces when N % 16 == 0 and it is 16-byte aligned, in
// 4-byte pieces otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma.cuh"

namespace {

constexpr int BN = 64;             // output columns per block (a strip)
constexpr int CPT = 4;             // columns per thread (one word of w per row)
constexpr int TN = BN / CPT;       // column threads
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KS = THREADS / TN;   // k-slices per block
constexpr int MT = 8;              // rows of x per block
constexpr int BK = 128;            // rows of w per stage
constexpr int RPT = BK / KS;       // rows per thread per stage: ks, ks + KS, ...
constexpr int STAGES = 3;          // the cp.async ring
constexpr int W_BYTES = BK * BN;   // one stage of w
constexpr int W_COPIES = W_BYTES / 16 / THREADS;  // 16-byte copies of w per thread and stage
constexpr int XF_ROW = 12;         // floats of a row of the converted x tile
constexpr int XPT = MT * BK / THREADS;            // elements of x converted per thread
constexpr int OPT = MT * BN / THREADS;            // outputs drained per thread
static_assert(TN == 16, "a strip spans a half warp: two k-slices per warp");
static_assert(W_COPIES * 16 * THREADS == W_BYTES && XPT * THREADS == MT * BK &&
                  OPT * THREADS == MT * BN,
              "whole copies, conversions and outputs per thread");

template <typename XT>
struct Smem {
  static constexpr int X_ROW = BK * sizeof(XT) + 16;    // bytes of a row of raw x (padded)
  static constexpr int X_BYTES = MT * X_ROW;            // one stage of raw x
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int XF = BK * XF_ROW * 4;            // the stage's x, f32, k-major
  static constexpr int RED = WARPS * MT * BN * 4;       // the block's partials
  static constexpr int BYTES = (RING > RED ? RING : RED) + XF;
  static constexpr int X_COPIES = MT * BK * sizeof(XT) / 16;  // 16-byte copies of x
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// Byte J of the word u (four int8 weights) as f32, exactly.
template <int J>
__device__ __forceinline__ float s8_to_f32(unsigned u) {
  return static_cast<float>(static_cast<int8_t>(u >> (8 * J)));
}

// The GEMV's body, for the block (blockIdx.x, blockIdx.y) of one matrix;
// STACK: the matrix is expert blockIdx.z of a stack, so every pointer is
// first offset by that expert's matrices, and live (E, M) flags its rows
// (nullptr: all live; see the note on the stack's live mask above).
template <typename XT, typename OT, bool COPY16, bool STACK>
__device__ __forceinline__ void gemv(const XT* __restrict__ x, const int8_t* __restrict__ w,
                                     const float* __restrict__ w_scale,
                                     const float* __restrict__ bias, OT* __restrict__ out,
                                     int M, int K, int N, int act, int splits, int split_rows,
                                     float* __restrict__ work, int* __restrict__ counters,
                                     const uint8_t* __restrict__ live) {
  using S = Smem<XT>;
  __shared__ __align__(16) unsigned char smem[S::BYTES];
  __shared__ int ticket;

  if (STACK) {
    const size_t e = blockIdx.z;
    x += e * M * K;
    w += e * K * N;
    w_scale += e * N;
    out += e * M * N;
    if (live != nullptr) live += e * M;
    if (splits > 1) {
      work += e * splits * M * N;
      counters += e * gridDim.y * (gridDim.x / splits);
    }
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tn = tid % TN, ks = tid / TN;
  const int strip = blockIdx.x / splits, split = blockIdx.x % splits;
  const int n0 = strip * BN, m0 = blockIdx.y * MT;
  if (STACK && live != nullptr &&
      !__syncthreads_or(tid < MT && m0 + tid < M && live[m0 + tid])) {
    // a dead slab: its tile is act(+0.0), stored once (by split 0)
    if (split == 0) {
      const float v = activate(0.f, act);
#pragma unroll
      for (int h = 0; h < OPT; ++h) {
        const int o = tid + h * THREADS, m = m0 + o / BN, c = n0 + o % BN;
        if (m < M && c < N) store(out + (size_t)m * N + c, v);
      }
    }
    return;
  }
  const int kb = split * split_rows, ke = min(K, kb + split_rows);
  const int nst = (ke - kb + BK - 1) / BK;  // stages of this block's range
  float* xf = reinterpret_cast<float*>(smem + (S::RING > S::RED ? S::RING : S::RED));

  auto stage_w = [&](int slot) { return smem + slot * S::STAGE; };
  auto stage_x = [&](int slot) { return smem + slot * S::STAGE + W_BYTES; };
  // Copies of stage s into its ring slot: w's BK x BN tile, x's MT x BK tile.
  auto load_stage = [&](int s) {
    const int k0 = kb + s * BK;
    unsigned char* sw = stage_w(s % STAGES);
    constexpr int PIECE = COPY16 ? 16 : 4;  // bytes per copy
#pragma unroll
    for (int i = 0; i < W_COPIES * 16 / PIECE; ++i) {
      const int e = tid + i * THREADS, r = e / (BN / PIECE), c = (e % (BN / PIECE)) * PIECE;
      const bool ok = k0 + r < ke && n0 + c < N;
      const int8_t* src = ok ? w + (size_t)(k0 + r) * N + n0 + c : w;
      if (COPY16)
        cp_async16(sw + r * BN + c, src, ok);
      else
        cp_async4(sw + r * BN + c, src, ok);
    }
    for (int e = tid; e < S::X_COPIES; e += THREADS) {
      constexpr int E = 16 / sizeof(XT);  // elements per copy
      const int m = e / (BK / E), c = (e % (BK / E)) * E;
      const bool ok = m0 + m < M && k0 + c < ke;
      cp_async16(stage_x(s % STAGES) + m * S::X_ROW + c * sizeof(XT),
                 ok ? x + (size_t)(m0 + m) * K + k0 + c : x, ok);
    }
  };

  float sc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) sc[j] = n0 + CPT * tn + j < N ? w_scale[n0 + CPT * tn + j] : 0.f;
  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[m][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load_stage(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s has landed; the slot refilled below and xf are consumed
    if (s + STAGES - 1 < nst) load_stage(s + STAGES - 1);
    cp_async_commit();
    {  // x's tile once as f32, k-major: xf[k][m]
      const int m = tid % MT, c = XPT * (tid / MT);
      const XT* rx = reinterpret_cast<const XT*>(stage_x(s % STAGES) + m * S::X_ROW) + c;
#pragma unroll
      for (int i = 0; i < XPT; ++i) xf[(c + i) * XF_ROW + m] = to_f32(rx[i]);
    }
    __syncthreads();
    const unsigned char* sw = stage_w(s % STAGES) + ks * BN + CPT * tn;
    const float* sx = xf + ks * XF_ROW;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {  // the rows ks + KS i, in order
      const unsigned u = *reinterpret_cast<const unsigned*>(sw + i * KS * BN);
      const float4 xa = *reinterpret_cast<const float4*>(sx + i * KS * XF_ROW);
      const float4 xb = *reinterpret_cast<const float4*>(sx + i * KS * XF_ROW + 4);
      const float xv[MT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float wf[CPT] = {__fmul_rn(s8_to_f32<0>(u), sc[0]), __fmul_rn(s8_to_f32<1>(u), sc[1]),
                             __fmul_rn(s8_to_f32<2>(u), sc[2]), __fmul_rn(s8_to_f32<3>(u), sc[3])};
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[m][j] = fmaf(xv[m], wf[j], acc[m][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the partials

  // k-slices 2 warp and 2 warp + 1 by one butterfly step, then the warps in order
  float* red = reinterpret_cast<float*>(smem);  // [WARPS][MT][BN]
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float v[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      v[j] = acc[m][j] + __shfl_xor_sync(0xffffffffu, acc[m][j], 16);
    if (lane < 16)
      *reinterpret_cast<float4*>(red + (warp * MT + m) * BN + CPT * tn) =
          make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();
  float sum[OPT];
  int row[OPT], col[OPT];
  bool inside[OPT];
#pragma unroll
  for (int h = 0; h < OPT; ++h) {
    const int o = tid + h * THREADS, m = o / BN, c = o % BN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += red[(q * MT + m) * BN + c];
    sum[h] = s;
    row[h] = m0 + m;
    col[h] = n0 + c;
    inside[h] = row[h] < M && col[h] < N;
  }

  if (splits > 1) {  // the splits of this tile: the last block to arrive adds them
#pragma unroll
    for (int h = 0; h < OPT; ++h)
      if (inside[h]) work[((size_t)split * M + row[h]) * N + col[h]] = sum[h];
    __threadfence();
    __syncthreads();
    int* counter = counters + blockIdx.y * (gridDim.x / splits) + strip;
    if (tid == 0) ticket = atomicAdd(counter, 1);
    __syncthreads();
    if (ticket != splits - 1) return;
    __threadfence();
    const size_t stride = (size_t)M * N;  // one split's partials
#pragma unroll
    for (int h = 0; h < OPT; ++h) {
      if (!inside[h]) continue;
      const float* p = work + (size_t)row[h] * N + col[h];
      float s = 0.f;
      int q = 0;
      for (; q + 4 <= splits; q += 4) {  // four loads in flight, added in order
        const float a0 = __ldcg(p + q * stride), a1 = __ldcg(p + (q + 1) * stride);
        const float a2 = __ldcg(p + (q + 2) * stride), a3 = __ldcg(p + (q + 3) * stride);
        s += a0;
        s += a1;
        s += a2;
        s += a3;
      }
      for (; q < splits; ++q) s += __ldcg(p + q * stride);
      sum[h] = s;
    }
    if (tid == 0) *counter = 0;
  }
#pragma unroll
  for (int h = 0; h < OPT; ++h) {
    if (!inside[h]) continue;
    float s = sum[h];
    if (STACK && live != nullptr && !live[row[h]]) s = 0.f;  // a dead row: act(+0.0)
    if (bias != nullptr) s += bias[col[h]];
    store(out + (size_t)row[h] * N + col[h], activate(s, act));
  }
}

// One matrix, and a stack of them (one launch, gridDim.z = E, with the
// stack's live mask): the same body, two names, so that a profile tells
// the experts' launches apart.  A stack of one runs the stack's kernel
// with gridDim.z = 1, whose arithmetic is the 2-D kernel's.  The 2-D
// kernel takes live (null, unread) only so that both share one signature.
template <typename XT, typename OT, bool COPY16>
__global__ void __launch_bounds__(THREADS, 3)
qmatmul_w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale, const float* __restrict__ bias,
                     OT* __restrict__ out, int M, int K, int N, int act, int splits,
                     int split_rows, float* __restrict__ work, int* __restrict__ counters,
                     const uint8_t* __restrict__ live) {
  gemv<XT, OT, COPY16, false>(x, w, w_scale, bias, out, M, K, N, act, splits, split_rows, work,
                              counters, live);
}

template <typename XT, typename OT, bool COPY16>
__global__ void __launch_bounds__(THREADS, 3)
qmatmul_w8a16_experts_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                             const float* __restrict__ w_scale, const float* __restrict__ bias,
                             OT* __restrict__ out, int M, int K, int N, int act, int splits,
                             int split_rows, float* __restrict__ work,
                             int* __restrict__ counters, const uint8_t* __restrict__ live) {
  gemv<XT, OT, COPY16, true>(x, w, w_scale, bias, out, M, K, N, act, splits, split_rows, work,
                             counters, live);
}

// stack: the experts' kernel over gridDim.z = E (else E == 1, the 2-D one)
template <typename XT, typename OT>
void launch(const void* x, const void* w, const void* w_scale, const void* bias, void* out,
            bool stack, int E, int M, int K, int N, int act, int splits, int split_rows,
            void* work, void* counters, const void* live, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN * splits, (M + MT - 1) / MT, E);
  const bool copy16 = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto kernel = stack ? (copy16 ? qmatmul_w8a16_experts_kernel<XT, OT, true>
                                      : qmatmul_w8a16_experts_kernel<XT, OT, false>)
                            : (copy16 ? qmatmul_w8a16_kernel<XT, OT, true>
                                      : qmatmul_w8a16_kernel<XT, OT, false>);
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<OT*>(out), M, K, N, act, splits, split_rows, static_cast<float*>(work),
      static_cast<int*>(counters), static_cast<const uint8_t*>(live));
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
//   WM x TC_WN piece, as MI x TC_NI m16n8k16 products (bf16 in, f32 sums
//   in registers; WM and MI follow from the M tile, TcTile).  K is walked in TC_BK-deep stages through a ring of
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
//
// A stack of E matrices (the MoE layer's experts at the full-sequence
// forward, qmatmul_w8a16_experts_mma): the same body over gridDim.z = E,
// each block offsetting its pointers by expert blockIdx.z's matrices, with
// an M tile of TC_BM_STACK = 64 rows.  An expert holds a forward's
// capacity rows (3 a batch row of 32 tokens at qwen2-moe-a2.7b: 3, 12 and
// 48 on the serve CLI's curve), so one M tile covers each and every
// expert's weight tile is read from device memory once; the GEMV's 8-row
// slabs read it once a slab (six times at 48 rows).  The tile's height
// changes no row's arithmetic: an m16n8k16 product computes each output
// from its own row of A, the stages and their IEEE adds are K's, so a
// stack of one is bitwise the 2-D kernel on that expert.  The live mask
// is the GEMV's: an (expert, M tile) with no live row stores act(+0.0)
// and returns before any copy (an all-zero row's sums are +0 and its
// scale is >= 0), and a dead row is stored as act(+0.0).

constexpr int TC_BM = 128;                       // output rows per block (one matrix)
constexpr int TC_BM_STACK = 64;                  // ... in a stack of experts
constexpr int TC_BN = 128;                       // output columns per block
constexpr int TC_BK = 128;                       // k per stage
constexpr int TC_STAGES = 3;                     // shared-memory ring of x and int8 w
constexpr int TC_WARPS_M = 2, TC_WARPS_N = 4;    // the block's warp grid
constexpr int TC_MIN_BLOCKS = 1;                 // blocks per SM the registers allow
constexpr int TC_THREADS = 32 * TC_WARPS_M * TC_WARPS_N;
constexpr int TC_WN = TC_BN / TC_WARPS_N;        // columns per warp
constexpr int TC_NI = TC_WN / 8;                 // n8 tiles per warp
constexpr int TC_X_ROW = TC_BK * 2;              // bytes of a row of x's tile
constexpr int TC_B_ROW = TC_BN * 2;              // bytes of a row of the bf16 w tile
constexpr int TC_W_BYTES = TC_BK * TC_BN;        // one stage of w (int8)
constexpr int TC_B_BYTES = TC_BK * TC_B_ROW;     // one converted stage of w (bf16)
constexpr int TC_W_COPIES = TC_W_BYTES / 16 / TC_THREADS;  // 16-byte copies per thread
constexpr int TC_X_RSTEP = TC_THREADS / (TC_X_ROW / 16);   // rows between a thread's copies
constexpr int TC_W_RSTEP = TC_THREADS / (TC_BN / 16);
constexpr int TC_C_ROW = TC_BN + 8;  // f32 per row of the drain's tile (padded: no bank conflicts)
static_assert(TC_X_ROW % 128 == 0 && TC_BN == 128, "whole 128-byte rows; int8 w's are 128 bytes");
static_assert(TC_NI % 2 == 0, "B fragments in pairs of n8 tiles");
static_assert(TC_W_COPIES * 16 * TC_THREADS == TC_W_BYTES, "w's tile in whole copies");
static_assert(TC_STAGES >= 3, "a stage is converted one ahead of its products");

// The sizes that follow from an M tile of BM rows.
template <int BM>
struct TcTile {
  static constexpr int WM = BM / TC_WARPS_M;                // rows per warp
  static constexpr int MI = WM / 16;                        // m16 tiles per warp
  static constexpr int X_BYTES = BM * TC_X_ROW;             // one stage of x (bf16)
  static constexpr int STAGE = X_BYTES + TC_W_BYTES;
  static constexpr int SMEM = TC_STAGES * STAGE + 2 * TC_B_BYTES;
  static constexpr int X_COPIES = X_BYTES / 16 / TC_THREADS;  // 16-byte copies per thread
  static_assert(MI >= 1 && MI * 16 == WM, "whole m16 tiles per warp");
  static_assert(X_COPIES * 16 * TC_THREADS == X_BYTES, "x's tile in whole copies");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
  static_assert(BM * TC_C_ROW * 4 <= SMEM, "the drain's tile fits the ring");
};

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

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// The tensor-core body, for the block (blockIdx.x, blockIdx.y) of one
// matrix, a BM x TC_BN tile of out; STACK: the matrix is expert blockIdx.z
// of a stack, its rows flagged by live (E, M) (nullptr: all live).
// COPY16: N % 16 == 0, so w is copied in 16-byte pieces (else 4-byte ones).
template <int BM, typename OT, bool COPY16, bool STACK>
__device__ __forceinline__ void mma_body(const __nv_bfloat16* __restrict__ x,
                                         const int8_t* __restrict__ w,
                                         const float* __restrict__ w_scale,
                                         const float* __restrict__ bias, OT* __restrict__ out,
                                         int M, int K, int N, int act,
                                         const uint8_t* __restrict__ live) {
  using T = TcTile<BM>;
  constexpr int MI = T::MI;
  // TC_STAGES stages of (BM rows of x, TC_BK rows of int8 w), then two
  // bf16 tiles of w
  extern __shared__ __align__(128) uint8_t smem[];
  auto x_tile = [&](int s) { return smem + s * T::STAGE; };
  auto w_tile = [&](int s) { return smem + s * T::STAGE + T::X_BYTES; };
  auto b_tile = [&](int s) { return smem + TC_STAGES * T::STAGE + s * TC_B_BYTES; };

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m0 = blockIdx.x * BM;     // blocks of one column strip run together,
  const int n0 = blockIdx.y * TC_BN;  // so its weights come from L2 after the first
  if (STACK) {
    const size_t e = blockIdx.z;
    x += e * M * K;
    w += e * K * N;
    w_scale += e * N;
    out += e * M * N;
    if (live != nullptr) {
      live += e * M;
      if (!__syncthreads_or(tid < BM && m0 + tid < M && live[m0 + tid])) {
        // a dead tile: act(+0.0) on its rows, nothing loaded
        const float a0 = activate(0.f, act);
        const float v[4] = {a0, a0, a0, a0};
        for (int i = tid; i < BM * (TC_BN / 4); i += TC_THREADS) {
          const int r = m0 + i / (TC_BN / 4), col = n0 + 4 * (i % (TC_BN / 4));
          if (r < M && col < N) store4(out + (size_t)r * N + col, v);
        }
        return;
      }
    }
  }
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
    for (int i = 0; i < T::X_COPIES; ++i) {
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

  float acc[MI][TC_NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
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
    float part[MI][TC_NI][4];  // this stage's products, summed from zero
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      // A of m16 tile mi: rows lane % 16, k-chunk 2 ks + lane / 16.  B of
      // n8 tiles 2 p, 2 p + 1 (ldmatrix.trans): matrix q = lane / 8 holds
      // k 8 (q % 2) .. + 7 of the warp's column chunk 2 p + q / 2.
      unsigned a[MI][4], b[TC_NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
        ldmatrix_x4(a[mi],
                    xs + swz<TC_X_ROW>(wm * T::WM + mi * 16 + lane % 16, 2 * ks + lane / 16));
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
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < TC_NI; ++ni) {
          if (ks == 0)
            mma_bf16_zero(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
          else
            mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
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
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * T::WM + mi * 16 + g + 8 * half, c = wn * TC_WN + ni * 8 + 2 * t;
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
  for (int r = tid / (TC_BN / 4); r < BM && m0 + r < M; r += TC_THREADS / (TC_BN / 4)) {
    const float4 a = *reinterpret_cast<const float4*>(ct + r * TC_C_ROW + c);
    float v[4] = {a.x, a.y, a.z, a.w};
    const bool dead = STACK && live != nullptr && !live[m0 + r];  // stored as act(+0.0)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (dead) {
        v[q] = 0.f;
      } else {
        v[q] *= sc[q];
        if (bias != nullptr) v[q] += bi[q];
      }
      v[q] = activate(v[q], act);
    }
    store4(out + (size_t)(m0 + r) * N + col, v);
  }
}

// One matrix (TC_BM-row tiles), and a stack of them (TC_BM_STACK-row
// tiles, gridDim.z = E): the same body, two names.
template <typename OT, bool COPY16>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
qmatmul_w8a16_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                         const float* __restrict__ w_scale, const float* __restrict__ bias,
                         OT* __restrict__ out, int M, int K, int N, int act) {
  mma_body<TC_BM, OT, COPY16, false>(x, w, w_scale, bias, out, M, K, N, act, nullptr);
}

template <typename OT, bool COPY16>
__global__ void __launch_bounds__(TC_THREADS, TC_MIN_BLOCKS)
qmatmul_w8a16_experts_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                 const int8_t* __restrict__ w,
                                 const float* __restrict__ w_scale, OT* __restrict__ out, int M,
                                 int K, int N, int act, const uint8_t* __restrict__ live) {
  mma_body<TC_BM_STACK, OT, COPY16, true>(x, w, w_scale, nullptr, out, M, K, N, act, live);
}

// Each launcher allows its kernel's dynamic shared memory (above 48 KB)
// once per process, at the first launch: the eager call or a capture's
// warm-up, so that no capture records it.
template <typename OT, bool COPY16>
cudaError_t launch_mma_kernel(const void* x, const void* w, const void* w_scale, const void* bias,
                              void* out, int M, int K, int N, int act, cudaStream_t stream) {
  const auto kernel = qmatmul_w8a16_mma_kernel<OT, COPY16>;
  constexpr int SMEM = TcTile<TC_BM>::SMEM;
  static const cudaError_t sized =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (sized != cudaSuccess) return sized;
  const dim3 grid((M + TC_BM - 1) / TC_BM, (N + TC_BN - 1) / TC_BN);
  kernel<<<grid, TC_THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias), static_cast<OT*>(out),
      M, K, N, act);
  return cudaGetLastError();
}

template <typename OT, bool COPY16>
cudaError_t launch_experts_mma_kernel(const void* x, const void* w, const void* w_scale,
                                      const void* live, void* out, int E, int M, int K, int N,
                                      int act, cudaStream_t stream) {
  const auto kernel = qmatmul_w8a16_experts_mma_kernel<OT, COPY16>;
  constexpr int SMEM = TcTile<TC_BM_STACK>::SMEM;
  static const cudaError_t sized =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (sized != cudaSuccess) return sized;
  const dim3 grid((M + TC_BM_STACK - 1) / TC_BM_STACK, (N + TC_BN - 1) / TC_BN, E);
  kernel<<<grid, TC_THREADS, SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<OT*>(out), M, K, N, act,
      static_cast<const uint8_t*>(live));
  return cudaGetLastError();
}

template <typename OT>
cudaError_t launch_mma(const void* x, const void* w, const void* w_scale, const void* bias,
                       void* out, int M, int K, int N, int act, cudaStream_t stream) {
  return N % 16 == 0
             ? launch_mma_kernel<OT, true>(x, w, w_scale, bias, out, M, K, N, act, stream)
             : launch_mma_kernel<OT, false>(x, w, w_scale, bias, out, M, K, N, act, stream);
}

template <typename OT>
cudaError_t launch_experts_mma(const void* x, const void* w, const void* w_scale,
                               const void* live, void* out, int E, int M, int K, int N, int act,
                               cudaStream_t stream) {
  return N % 16 == 0 ? launch_experts_mma_kernel<OT, true>(x, w, w_scale, live, out, E, M, K, N,
                                                           act, stream)
                     : launch_experts_mma_kernel<OT, false>(x, w, w_scale, live, out, E, M, K,
                                                            N, act, stream);
}

}  // namespace

// Plain C entry point, bound with ctypes: the GEMV under the split plan
// (splits ranges of split_rows rows, G-aligned, covering [0, K)), with a
// workspace of splits * M * N f32 and one int counter per (slab, strip), all
// 0, when splits > 1 (the kernel leaves them 0).  Returns
// cudaGetLastError() after the launch, so a refused launch is reported to
// the caller.
static int launch_gemv(const void* x, int x_bf16, const void* w, const void* w_scale,
                       const void* bias, void* out, int out_bf16, bool stack, int E, int M,
                       int K, int N, int act, int splits, int split_rows, void* work,
                       void* counters, const void* live, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, w_scale, bias, out, stack, E, M, K, N, act,
                                         splits, split_rows, work, counters, live, s);
  else if (x_bf16)
    launch<__nv_bfloat16, float>(x, w, w_scale, bias, out, stack, E, M, K, N, act, splits,
                                 split_rows, work, counters, live, s);
  else if (out_bf16)
    launch<float, __nv_bfloat16>(x, w, w_scale, bias, out, stack, E, M, K, N, act, splits,
                                 split_rows, work, counters, live, s);
  else
    launch<float, float>(x, w, w_scale, bias, out, stack, E, M, K, N, act, splits, split_rows,
                         work, counters, live, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qmatmul_w8a16(const void* x, int x_bf16, const void* w, const void* w_scale,
                             const void* bias, void* out, int out_bf16, int M, int K, int N,
                             int act, int splits, int split_rows, void* work, void* counters,
                             void* stream) {
  return launch_gemv(x, x_bf16, w, w_scale, bias, out, out_bf16, false, 1, M, K, N, act, splits,
                     split_rows, work, counters, nullptr, stream);
}

// The GEMV over a stack of E matrices (the experts' entry): the same
// arguments, without bias, with every tensor stacked on a leading E axis
// and live (E, M) uint8 flags or null (see the notes on stacks above),
// under the stack's plan, with a workspace of splits * E * M * N f32 and
// one counter per (expert, slab, strip) when splits > 1.
extern "C" int qmatmul_w8a16_experts(const void* x, int x_bf16, const void* w,
                                     const void* w_scale, const void* live, void* out,
                                     int out_bf16, int E, int M, int K, int N, int act,
                                     int splits, int split_rows, void* work, void* counters,
                                     void* stream) {
  return launch_gemv(x, x_bf16, w, w_scale, nullptr, out, out_bf16, true, E, M, K, N, act,
                     splits, split_rows, work, counters, live, stream);
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

// The tensor-core kernel over a stack of E matrices (the experts' entry at
// the forward): x (E, M, K) bf16, w (E, K, N), w_scale (E, N), live (E, M)
// uint8 flags or null, no bias, out (E, M, N); the 2-D entry's conditions.
extern "C" int qmatmul_w8a16_experts_mma(const void* x, const void* w, const void* w_scale,
                                         const void* live, void* out, int out_bf16, int E,
                                         int M, int K, int N, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16
          ? launch_experts_mma<__nv_bfloat16>(x, w, w_scale, live, out, E, M, K, N, act, s)
          : launch_experts_mma<float>(x, w, w_scale, live, out, E, M, K, N, act, s);
  return static_cast<int>(err);
}
