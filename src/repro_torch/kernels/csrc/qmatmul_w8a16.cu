// Weight-only int8 matmul for Hopper (sm_90a): out = act(x @ (w * w_scale[col]) + bias).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul.py::qmatmul_w8a16
// (body _w8a16_kernel).  x is (M, K) bf16 or f32, w is (K, N) int8 row-major
// with one f32 scale per output column, bias is (N,) f32 or absent, out is
// (M, N) bf16 or f32.  Accumulation is f32.
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
