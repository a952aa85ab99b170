// Split-KV (flash-decoding) pieces shared by the decode kernels, dense and
// paged (decode_kernels.cuh): the slot range of a split, the merge of a
// CTA's softmax states through shared memory into either the finished rows
// or the split's partial state, and the combine pass that merges the
// splits' partial states.
//
// Partial states live in one float32 workspace the wrapper allocates: for
// B rows, Hq q-heads and n_split splits, first (m, l) pairs at
// ml[((b * hq + h) * n_split + split) * 2], then the unnormalised
// accumulators at acc[((b * hq + h) * n_split + split) * D]. An empty
// split writes m = -inf, l = 0 and no accumulator; the combine skips it.
#pragma once

#include "common.cuh"

namespace repro {
namespace splitkv {

// Slots [begin, end) of split `split` of `split_len` slots, clipped to the
// row's n slots; empty when begin >= end.
struct Range {
  int begin, end;
};
__host__ __device__ inline Range split_range(int split, int split_len, int n) {
  const int begin = split * split_len;
  const int end = begin + split_len < n ? begin + split_len : n;
  return {begin, end};
}

__device__ __forceinline__ float* partial_ml(float* ws, int b, int h, int split, int hq,
                                             int n_split) {
  return ws + ((static_cast<int64_t>(b) * hq + h) * n_split + split) * 2;
}
__device__ __forceinline__ float* partial_acc(float* ws, int b, int h, int split, int hq,
                                              int n_split, int batch, int d) {
  const int64_t ml_size = static_cast<int64_t>(batch) * hq * n_split * 2;
  return ws + ml_size + ((static_cast<int64_t>(b) * hq + h) * n_split + split) * d;
}

// An empty split: m = -inf, l = 0 for each of its `group` q-heads.
__device__ __forceinline__ void store_empty(float* ws, int b, int h0, int group, int split,
                                            int hq, int n_split) {
  for (int g = threadIdx.x; g < group; g += blockDim.x) {
    float* ml = partial_ml(ws, b, h0 + g, split, hq, n_split);
    ml[0] = -INFINITY;
    ml[1] = 0.f;
  }
}

// Merge the CTA's kStates softmax states for its `group` q-heads
// h0 .. h0 + group - 1 and store the finished rows into o when there is one
// split (and, where lse is not null, each row's logsumexp m + log(l) at
// lse[b * hq + h]), else the split's partial state into the workspace. The states lie
// in shared memory as m_s[kStates][G], l_s[kStates][G] and
// acc_s[kStates][G][LD] (a state that saw no slot holds m = -inf; only the
// first D of a state's LD columns are stored). Every thread of the block
// takes part; the states must be visible (after a __syncthreads).
template <typename T, int G, int D, int kStates, int LD = D>
__device__ __forceinline__ void merge_and_store(const float* m_s, const float* l_s,
                                                const float* acc_s, int group, int b, int h0,
                                                int split, int n_split, int hq, int batch, T* o,
                                                int64_t os_b, int64_t os_h, float* ws,
                                                float* lse) {
  for (int i = threadIdx.x; i < group * D; i += blockDim.x) {
    const int g = i / D, c = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kStates; ++w) mx = fmaxf(mx, m_s[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kStates; ++w) {
      const float m = m_s[w * G + g];
      if (m == -INFINITY) continue;
      const float f = __expf(m - mx);
      lsum += l_s[w * G + g] * f;
      a += acc_s[(w * G + g) * LD + c] * f;
    }
    if (n_split == 1) {
      o[b * os_b + (h0 + g) * os_h + c] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
      if (lse != nullptr && c == 0) lse[static_cast<int64_t>(b) * hq + h0 + g] = mx + logf(lsum);
    } else {
      partial_acc(ws, b, h0 + g, split, hq, n_split, batch, D)[c] = a;
      if (c == 0) {
        float* ml = partial_ml(ws, b, h0 + g, split, hq, n_split);
        ml[0] = mx;
        ml[1] = lsum;
      }
    }
  }
}

// The combine pass: one CTA per (q-head, row) merges the n_split partial
// states in float32 and writes the row of o in T (and, where lse is not
// null, the row's logsumexp).
template <typename T>
__global__ void __launch_bounds__(128)
combine_kernel(float* __restrict__ ws, T* __restrict__ o, float* __restrict__ lse, int64_t os_b,
               int64_t os_h, int hq, int n_split, int batch, int d) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* ml = partial_ml(ws, b, h, 0, hq, n_split);
  const float* acc = partial_acc(ws, b, h, 0, hq, n_split, batch, d);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, ml[2 * s]);
  float lsum = 0.f;
  for (int s = 0; s < n_split; ++s)
    if (ml[2 * s] != -INFINITY) lsum += ml[2 * s + 1] * __expf(ml[2 * s] - mx);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  if (lse != nullptr && threadIdx.x == 0) lse[static_cast<int64_t>(b) * hq + h] = mx + logf(lsum);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_split; ++s)
      if (ml[2 * s] != -INFINITY) a += acc[s * d + c] * __expf(ml[2 * s] - mx);
    o[b * os_b + h * os_h + c] = from_f32<T>(a * inv);
  }
}

template <typename T>
cudaError_t launch_combine(float* ws, void* o, float* lse, int64_t os_b, int64_t os_h, int batch,
                           int hq, int n_split, int d, cudaStream_t stream) {
  combine_kernel<T><<<dim3(hq, batch), 128, 0, stream>>>(ws, static_cast<T*>(o), lse, os_b, os_h,
                                                         hq, n_split, batch, d);
  return cudaGetLastError();
}

}  // namespace splitkv
}  // namespace repro
