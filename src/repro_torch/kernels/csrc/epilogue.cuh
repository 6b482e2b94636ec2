// Shared by the kernels: a store of one f32 value as the output type, and
// the quantized matmuls' activations (the reference's).
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

}  // namespace
