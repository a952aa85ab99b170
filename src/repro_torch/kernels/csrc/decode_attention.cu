// Single-token decode attention against a dense KV cache, for Hopper:
// split-KV (flash-decoding).
//
// Replaces the Pallas kernel `_decode_kernel` of
// src/repro/kernels/decode_attention.py (`decode_attention`): one query row
// per (batch, q-head) against the cache, masked by `slot < valid_len`, with
// the finite -1e30 mask (a row with valid_len 0 gets the uniform mean of its
// V rows) and a float32 softmax. Slot order does not matter, so rolling
// sliding-window caches work as they are. Unlike the Pallas kernel, which
// takes one scalar valid_len, this one takes a (B,) int32 vector, so the
// serving engine's continuous batch (one position per row) runs on it.
//
// What bounds it on an H100: the bytes of the valid cache prefix. Each slot
// costs 2*D*G multiply-adds for 4*D bytes of bf16 K and V, far below the
// card's 295 operations per byte.
//
// Design (decode_kernels.cuh, shared with the paged pool): the Pallas grid
// (b, q-head, kv-block) reads every K/V tile once per q-head. Here a CTA
// owns (split, kv-head, batch) and all G <= 16 q-heads of its kv-head (in
// float32 a group above 8 goes to two CTAs), so each K/V row is read from
// device memory once; the slots are split across CTAs
// so that a small batch (gemma-2b has one kv-head: 4 CTAs at B = 4 without
// splits) still fills the 132 SMs. The host picks the split count from S,
// B * Hkv and the SM count (kernels/ref.py split_plan: one wave of CTAs,
// splits of at least 256 slots), without reading the valid lengths, which
// would cost a device round trip a layer. bf16 runs both products on the
// tensor cores (mma.sync), float32 on the CUDA cores. This file holds the
// dense cache's row policy (slot s at kb + s * stride) and the C entry
// point.
#include "decode_kernels.cuh"

namespace repro {
namespace {

template <typename T, int D>
cudaError_t dense_dim(const void* q, const void* k, const void* v, const int* vl, void* o,
                      float* ws, float* lse, const int64_t* st, int b, int hq, int hkv, int s_len,
                      int split_len, int n_split, float scale, cudaStream_t s) {
  const DenseKV<T> kv{static_cast<const T*>(k), static_cast<const T*>(v),
                      Strides{st[2], st[3], st[4]}, Strides{st[5], st[6], st[7]}};
  return dispatch_group<T, D, D>(q, kv, vl, o, ws, lse, Strides2{st[0], st[1]},
                                 Strides2{st[8], st[9]}, b, hq, hkv, s_len, split_len, n_split,
                                 scale, s);
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v, const int* vl,
                         void* o, float* ws, float* lse, const int64_t* st, int b, int hq,
                         int hkv, int s_len, int split_len, int n_split, float scale,
                         cudaStream_t s) {
  switch (d) {
    case 64: return dense_dim<T, 64>(q, k, v, vl, o, ws, lse, st, b, hq, hkv, s_len, split_len, n_split, scale, s);
    case 128: return dense_dim<T, 128>(q, k, v, vl, o, ws, lse, st, b, hq, hkv, s_len, split_len, n_split, scale, s);
    case 256: return dense_dim<T, 256>(q, k, v, vl, o, ws, lse, st, b, hq, hkv, s_len, split_len, n_split, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 10 element strides: q (batch, head), k (batch, head, slot),
// v (batch, head, slot), o (batch, head); k and v 16-byte aligned (pointers
// and strides). valid_len: (B,) int32 on the card. n_split splits of
// split_len slots; ws: the float32 partial-state workspace of
// B * hq * n_split * (d + 2) floats, unused when n_split is 1. lse: null,
// or a (B, hq) contiguous float32 output of each row's logsumexp of the
// masked scale * q.k (the context-parallel decode combines shards by it;
// a row with valid_len 0 gets -1e30 + log(S)). dtype: 0 float32, 1
// bfloat16. Launches the split kernel and, with more than one split, the
// combine pass; returns the first failing launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* valid_len, void* o, void* ws, void* lse,
                                      const int64_t* strides, int b, int hq, int hkv,
                                      int s_len, int d, int n_split, int split_len,
                                      float scale, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s_len <= 0 || n_split <= 0 || split_len <= 0 ||
      static_cast<int64_t>(n_split) * split_len < s_len)
    return (int)cudaErrorInvalidValue;
  const int* vl = static_cast<const int*>(valid_len);
  float* w = static_cast<float*>(ws);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::dispatch_dim<float>(d, q, k, v, vl, o, w, l, strides, b, hq, hkv, s_len, split_len, n_split, scale, s);
  if (dtype == 1)
    return (int)repro::dispatch_dim<__nv_bfloat16>(d, q, k, v, vl, o, w, l, strides, b, hq, hkv, s_len, split_len, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
