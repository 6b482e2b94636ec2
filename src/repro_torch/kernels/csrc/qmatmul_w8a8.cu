// int8 x int8 matmul for Hopper (sm_90a) with int32 accumulation:
// out = act(float(x @ w) * x_scale * w_scale[col] + bias).
//
// Replaces the Pallas TPU kernel repro/kernels/qmatmul.py::qmatmul_w8a8
// (body _w8a8_kernel).  x is (M, K) int8 with one f32 scale for the whole
// tensor (x_scale, a device scalar), w is (K, N) int8 row-major with one
// f32 scale per output column, bias is (N,) f32 or absent, out is (M, N)
// bf16 or f32.
//
// What bounds it: the product does 2*M operations per weight byte.  At a
// decode tick (M = 8) that is far below the ~590 operations per byte at
// which the card's int8 arithmetic, not its memory, becomes the limit; at
// a prefill of 16 x 32 tokens (M = 512) it is 1,024, past that line, so
// the int8 tensor cores would be the limit there.  This first kernel runs
// the integer products on the SM's integer units (__dp4a: four int8
// products and their sum, added to an int32, per instruction) and is
// built for the weight stream, like qmatmul_w8a16.cu:
//
// - A block owns a strip of BN output columns.  Each thread owns CPT
//   neighbouring columns and reads them as one 4-byte word, so a warp
//   reads whole 32-byte sectors of w's rows.
// - The block's KS k-slices each own one contiguous range of w's rows and
//   walk it in groups of G rows, the next group's weights loaded while the
//   current one is multiplied.  A 4x4 byte transpose (__byte_perm) turns
//   four row words into four column words, each holding four consecutive
//   k of one column, which __dp4a multiplies with four consecutive bytes
//   of a row of x (read 16 bytes at a time through the L1 cache).
// - The KS partial sums of a column are added through shared memory.
//   Integer sums are exact in any order, so a row's result depends only on
//   its own row of x, never on M or on the other rows.
// - The drain follows the reference's order, with no fused multiply-add:
//   float(acc) * x_scale, then * w_scale[col], then + bias, then the
//   activation.
//
// M larger than MT is covered by gridDim.y, one MT-row slab per block
// row, each re-reading w (from L2 when it fits).  Moving the prefill's
// large M to the int8 tensor cores (mma / wgmma) is later work.  K must be
// a multiple of G, N of CPT, and x 16-byte aligned (the wrapper checks).
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
  if (row < M && col < N) {
    // (acc * x_scale) * w_scale, then + bias: rounded step by step, as the
    // reference does (no contraction into a fused multiply-add)
    float v = __fmul_rn(__fmul_rn(static_cast<float>(s), *x_scale), w_scale[col]);
    if (bias != nullptr) v = __fadd_rn(v, bias[col]);
    store(out + (size_t)row * N + col, activate(v, act));
  }
}

template <typename OT>
void launch(const void* x, const void* w, const void* x_scale, const void* w_scale,
            const void* bias, void* out, int M, int K, int N, int act, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  qmatmul_w8a8_kernel<OT><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<const float*>(bias), static_cast<OT*>(out), M, K, N, act);
}

}  // namespace

// Plain C entry point, bound with ctypes.  Returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.
extern "C" int qmatmul_w8a8(const void* x, const void* w, const void* x_scale,
                            const void* w_scale, const void* bias, void* out, int out_bf16,
                            int M, int K, int N, int act, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(x, w, x_scale, w_scale, bias, out, M, K, N, act, s);
  else
    launch<float>(x, w, x_scale, w_scale, bias, out, M, K, N, act, s);
  return static_cast<int>(cudaGetLastError());
}
