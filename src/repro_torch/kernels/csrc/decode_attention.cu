// Single-token decode attention against a dense KV cache, for Hopper.
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
// Design: the Pallas grid (b, q-head, kv-block) reads every K/V tile once per
// q-head. Here one CTA owns (batch, kv-head) and holds all G q-heads of that
// kv-head in registers, so each K/V row is read from device memory once.
// Four warps split the slots; within a warp each lane owns D/32 contiguous
// columns (coalesced loads) and a warp shuffle finishes each dot product.
// Every warp keeps an online softmax per q-head; the warps' states are
// merged through shared memory at the end. Weakness: at the serving path's
// decode shape (B=4, one kv-head) that is 4 CTAs on 132 SMs; splitting the
// slots across CTAs (flash-decoding) is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 2;  // slots a warp has in flight per iteration

struct Strides2 {
  int64_t b, h;
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              T* __restrict__ o, Strides2 qs, Strides ks, Strides vs,
              Strides2 os, int group, int s_len, float scale) {
  constexpr int C = D / 32;  // columns per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;

  const int vl = valid_len[b];
  const bool all_masked = vl <= 0;  // every slot masked: uniform softmax
  const int n = all_masked ? s_len : min(vl, s_len);

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + b * qs.b + (hk * group + g) * qs.h + lane * C;
#pragma unroll
    for (int c = 0; c < C; ++c) qr[g][c] = (g < group) ? to_f32(qh[c]) : 0.f;
  }

  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
  }

  const T* kb = k + b * ks.b + hk * ks.h + lane * C;
  const T* vb = v + b * vs.b + hk * vs.h + lane * C;
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float kr[kUnroll][C], vr[kUnroll][C];
    bool present[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u;
      present[u] = slot < n;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kr[u][c] = present[u] ? to_f32(kb[slot * ks.s + c]) : 0.f;
        vr[u][c] = present[u] ? to_f32(vb[slot * vs.s + c]) : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float sc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot += qr[g][c] * kr[u][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        sc[u] = !present[u] ? -INFINITY : (all_masked ? kNegInf : dot * scale);
      }
      // slot `base` is always present, so m_new is finite
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, sc[u]);
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = expf(sc[u] - m_new);
        l[g] += p;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] += p * vr[u][c];
      }
      m[g] = m_new;
    }
  }

  // merge the warps' partial softmax states
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc_s[warp][g][lane * C + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * D; i += kWarps * 32) {
    const int g = i / D, c = i % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot holds m = -inf, l = 0, acc = 0
      const float f = (m_s[w][g] == -INFINITY) ? 0.f : expf(m_s[w][g] - mx);
      lsum += l_s[w][g] * f;
      a += acc_s[w][g][c] * f;
    }
    o[b * os.b + (hk * group + g) * os.h + c] = from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* valid_len, void* o, const int64_t* st,
                          int b, int hkv, int group, int s_len, float scale,
                          cudaStream_t stream) {
  const Strides2 qs{st[0], st[1]};
  const Strides ks{st[2], st[3], st[4]};
  const Strides vs{st[5], st[6], st[7]};
  const Strides2 os{st[8], st[9]};
  const dim3 grid(hkv, b);
  decode_kernel<T, D, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid_len, static_cast<T*>(o), qs, ks, vs, os, group, s_len, scale);
  return cudaGetLastError();
}

// G is the group size rounded up to a power of two: the q-heads past the
// real group are zeros that are never stored.
template <typename T, int D>
cudaError_t dispatch_group(int group, const void* q, const void* k, const void* v,
                           const int* vl, void* o, const int64_t* st, int b,
                           int hkv, int s_len, float scale, cudaStream_t s) {
  if (group == 1) return launch_decode<T, D, 1>(q, k, v, vl, o, st, b, hkv, group, s_len, scale, s);
  if (group == 2) return launch_decode<T, D, 2>(q, k, v, vl, o, st, b, hkv, group, s_len, scale, s);
  if (group <= 4) return launch_decode<T, D, 4>(q, k, v, vl, o, st, b, hkv, group, s_len, scale, s);
  if (group <= 8) return launch_decode<T, D, 8>(q, k, v, vl, o, st, b, hkv, group, s_len, scale, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int d, int group, const void* q, const void* k,
                         const void* v, const int* vl, void* o,
                         const int64_t* st, int b, int hkv, int s_len,
                         float scale, cudaStream_t s) {
  switch (d) {
    case 64: return dispatch_group<T, 64>(group, q, k, v, vl, o, st, b, hkv, s_len, scale, s);
    case 128: return dispatch_group<T, 128>(group, q, k, v, vl, o, st, b, hkv, s_len, scale, s);
    case 256: return dispatch_group<T, 256>(group, q, k, v, vl, o, st, b, hkv, s_len, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 10 element strides: q (batch, head), k (batch, head, slot),
// v (batch, head, slot), o (batch, head). valid_len: (B,) int32 on the card.
// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* valid_len, void* o,
                                      const int64_t* strides, int b, int hq,
                                      int hkv, int s_len, int d, float scale,
                                      int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || s_len <= 0) return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::dispatch_dim<float>(d, group, q, k, v, vl, o, strides, b, hkv, s_len, scale, s);
  if (dtype == 1)
    return (int)repro::dispatch_dim<__nv_bfloat16>(d, group, q, k, v, vl, o, strides, b, hkv, s_len, scale, s);
  return (int)cudaErrorInvalidValue;
}
