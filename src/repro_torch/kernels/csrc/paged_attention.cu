// Single-token decode attention through a page table, for Hopper.
//
// Replaces the Pallas kernel `_paged_kernel` of
// src/repro/kernels/paged_attention.py (`paged_attention`): the KV cache
// lives in a shared pool of fixed-size pages, (n_pool, Hkv, page, D), and
// row b's logical slot s lives in physical page block_tables[b, s / page] at
// offset s % page. Pad entries of a table point at page 0 and may alias live
// pages; `slot < valid_len` masks them with the finite -1e30 of the
// reference, so a row with valid_len 0 gets the uniform mean of V over every
// slot of its table, pad pages included. valid_len is (B,) int32.
//
// What bounds it on an H100: the bytes of the valid pages. Each slot costs
// 2*D*G multiply-adds for 4*D bytes of bf16 K and V, far below the card's
// 295 operations per byte.
//
// Design: the decode kernel's (decode_attention.cu) with one indirection.
// The Pallas grid (b, q-head, page) reads every page once per q-head; here
// one CTA owns (batch row, kv-head) and holds all G q-heads of that kv-head
// in registers, so each page is read once. Four warps take slots in turn,
// two at a time, so one pass of the CTA gathers 8 slots and the warps walk
// several 16-token pages together; a warp reads the slot's page id from the
// table (one broadcast load, cached) and then the K and V rows. Lane l owns
// columns l, l+32, ..., so a row's loads are coalesced and any head_dim up
// to 32*C works (48 and 80 included). Each warp keeps an online softmax per
// q-head; the warps' states merge through shared memory at the end. The
// pools are taken through strides, so the model layout's (n_pool, page, Hkv,
// D) pool is read as a (n_pool, Hkv, page, D) view without a copy.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kUnroll = 2;  // slots a warp has in flight per iteration

// element strides of a (n_pool, Hkv, page, D) pool view
struct PoolStrides {
  int64_t page, h, t;
};

template <typename T, int C, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ tables,
             const int* __restrict__ valid_len, T* __restrict__ o,
             int64_t qs_b, int64_t qs_h, PoolStrides ks, PoolStrides vs,
             int64_t os_b, int64_t os_h, int group, int d, int page,
             int n_pages, float scale) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int* table = tables + (int64_t)b * n_pages;

  const int span = n_pages * page;
  const int vl = valid_len[b];
  const bool all_masked = vl <= 0;  // every slot masked: uniform softmax
  const int n = all_masked ? span : min(vl, span);

  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + b * qs_b + (int64_t)(hk * group + g) * qs_h;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int col = c * 32 + lane;
      qr[g][c] = (g < group && col < d) ? to_f32(qh[col]) : 0.f;
    }
  }

  float m[G], l[G], acc[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[g][c] = 0.f;
  }

  const T* kh = k + hk * ks.h;
  const T* vh = v + hk * vs.h;
  for (int base = warp * kUnroll; base < n; base += kWarps * kUnroll) {
    float kr[kUnroll][C], vr[kUnroll][C];
    bool present[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int slot = base + u;
      present[u] = slot < n;
      const T* krow = kh;
      const T* vrow = vh;
      if (present[u]) {
        const int lp = slot / page;
        const int64_t pg = table[lp];
        const int t = slot - lp * page;
        krow = kh + pg * ks.page + t * ks.t;
        vrow = vh + pg * vs.page + t * vs.t;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = c * 32 + lane;
        const bool in = present[u] && col < d;
        kr[u][c] = in ? to_f32(krow[col]) : 0.f;
        vr[u][c] = in ? to_f32(vrow[col]) : 0.f;
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
  __shared__ float acc_s[kWarps][G][C * 32];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) acc_s[warp][g][c * 32 + lane] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * d; i += kWarps * 32) {
    const int g = i / d, col = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      // a warp that saw no slot holds m = -inf, l = 0, acc = 0
      const float f = (m_s[w][g] == -INFINITY) ? 0.f : expf(m_s[w][g] - mx);
      lsum += l_s[w][g] * f;
      a += acc_s[w][g][col] * f;
    }
    o[b * os_b + (int64_t)(hk * group + g) * os_h + col] =
        from_f32<T>(a / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int C, int G>
cudaError_t launch_paged(const void* q, const void* k, const void* v,
                         const int* tables, const int* valid_len, void* o,
                         const int64_t* st, int b, int hkv, int group, int d,
                         int page, int n_pages, float scale,
                         cudaStream_t stream) {
  const PoolStrides ks{st[2], st[3], st[4]};
  const PoolStrides vs{st[5], st[6], st[7]};
  const dim3 grid(hkv, b);
  paged_kernel<T, C, G><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), tables, valid_len, static_cast<T*>(o),
      st[0], st[1], ks, vs, st[8], st[9], group, d, page, n_pages, scale);
  return cudaGetLastError();
}

// G is the group size rounded up to a power of two: the q-heads past the
// real group are zeros that are never stored.
template <typename T, int C>
cudaError_t dispatch_group(int group, const void* q, const void* k,
                           const void* v, const int* tbl, const int* vl,
                           void* o, const int64_t* st, int b, int hkv, int d,
                           int page, int n_pages, float scale, cudaStream_t s) {
  if (group == 1) return launch_paged<T, C, 1>(q, k, v, tbl, vl, o, st, b, hkv, group, d, page, n_pages, scale, s);
  if (group == 2) return launch_paged<T, C, 2>(q, k, v, tbl, vl, o, st, b, hkv, group, d, page, n_pages, scale, s);
  if (group <= 4) return launch_paged<T, C, 4>(q, k, v, tbl, vl, o, st, b, hkv, group, d, page, n_pages, scale, s);
  if (group <= 8) return launch_paged<T, C, 8>(q, k, v, tbl, vl, o, st, b, hkv, group, d, page, n_pages, scale, s);
  return cudaErrorInvalidValue;
}

// C = ceil(d / 32) columns per lane: 2 for d 33..64, 3 for 65..96, 4 for
// 97..128, 8 for 225..256.
template <typename T>
cudaError_t dispatch_dim(int d, int group, const void* q, const void* k,
                         const void* v, const int* tbl, const int* vl, void* o,
                         const int64_t* st, int b, int hkv, int page,
                         int n_pages, float scale, cudaStream_t s) {
  switch ((d + 31) / 32) {
    case 2: return dispatch_group<T, 2>(group, q, k, v, tbl, vl, o, st, b, hkv, d, page, n_pages, scale, s);
    case 3: return dispatch_group<T, 3>(group, q, k, v, tbl, vl, o, st, b, hkv, d, page, n_pages, scale, s);
    case 4: return dispatch_group<T, 4>(group, q, k, v, tbl, vl, o, st, b, hkv, d, page, n_pages, scale, s);
    case 8: return dispatch_group<T, 8>(group, q, k, v, tbl, vl, o, st, b, hkv, d, page, n_pages, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 10 element strides: q (batch, head), k pool (page, head, slot),
// v pool (page, head, slot), o (batch, head). tables: (B, n_pages) int32,
// contiguous; valid_len: (B,) int32; both on the card. dtype: 0 float32,
// 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* k,
                                     const void* v, const void* tables,
                                     const void* valid_len, void* o,
                                     const int64_t* strides, int b, int hq,
                                     int hkv, int page, int n_pages, int d,
                                     float scale, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page <= 0 || n_pages <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  const int group = hq / hkv;
  const int* tbl = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(valid_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::dispatch_dim<float>(d, group, q, k, v, tbl, vl, o, strides, b, hkv, page, n_pages, scale, s);
  if (dtype == 1)
    return (int)repro::dispatch_dim<__nv_bfloat16>(d, group, q, k, v, tbl, vl, o, strides, b, hkv, page, n_pages, scale, s);
  return (int)cudaErrorInvalidValue;
}
