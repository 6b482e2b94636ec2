// Shared by the kernels: a store of one f32 value as the output type, the
// quantized matmuls' activations (the reference's), and the W8A8 drain.
#pragma once
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Activation codes follow ACTIVATIONS in kernels/qmatmul.py.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 1:
      return fmaxf(v, 0.f);
    case 2: {  // tanh-approximated GELU, as jax.nn.gelu
      const float inner = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.f + tanhf(inner));
    }
    case 3:
      return v / (1.f + expf(-v));
    case 4:
      return tanhf(v);
    case 5:
      return 1.f / (1.f + expf(-v));
    default:
      return v;
  }
}

// One W8A8 output from its int32 sum: (float(acc) * x_scale) * w_scale,
// then + bias, then the activation, rounded step by step as the reference
// rounds (no contraction into a fused multiply-add).  Both W8A8 kernels
// drain through this one function, so they give an output the same bits.
template <typename OT>
__device__ __forceinline__ void drain_w8a8(OT* p, int acc, float x_scale, float w_scale,
                                           const float* bias, int col, int act) {
  float v = __fmul_rn(__fmul_rn(static_cast<float>(acc), x_scale), w_scale);
  if (bias != nullptr) v = __fadd_rn(v, bias[col]);
  store(p, activate(v, act));
}

}  // namespace
