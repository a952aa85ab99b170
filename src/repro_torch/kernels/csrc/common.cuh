// Helpers shared by the attention kernels: element conversion and the
// strides a kernel is handed in place of a fixed layout.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The finite mask value of the reference: a row whose every slot is masked
// still has a defined softmax (the uniform one), as in the JAX package.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (batch, head, seq, head_dim) view whose last axis is
// contiguous. The model keeps (batch, seq, head, head_dim) tensors, so the
// kernels read them in place through these strides, without a transpose.
struct Strides {
  int64_t b, h, s;
};

}  // namespace repro
