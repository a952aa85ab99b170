// Single-token decode attention through a page table, for Hopper: the
// split-KV decode kernels of decode_kernels.cuh on a paged pool.
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
// Design: the dense decode's, with one indirection. The Pallas grid (b,
// q-head, page) reads every page once per q-head; here the decode kernels
// run on the row's n_pages * page logical slots, split across CTAs by the
// same rule (kernels/ref.py split_plan) and merged by the same combine
// pass, and they differ from the dense cache only in where a slot's row
// lies: `PagedRows` reads the slot's page id from the table once per row of
// a tile (a multiply-high division by the page size) and adds the slot's
// place in the page, and the tile's rows then come through the same 16-byte
// cp.async ring, from wherever their pages lie. bf16 takes the tensor-core
// kernel at every head_dim (48, 80 and 96 are multiples of 16); float32 the
// CUDA-core kernel, at 48, 80 and 96 on rows padded with zero columns to 64,
// 128 and 128. The pools are taken through strides, so the model layout's
// (n_pool, page, Hkv, D) pool is read as a (n_pool, Hkv, page, D) view
// without a copy.
#include "decode_kernels.cuh"

namespace repro {
namespace {

template <typename T, int D, int DP>
cudaError_t paged_dim(const void* q, const void* k, const void* v, const int* tables,
                      const int* vl, void* o, float* ws, const int64_t* st, int b, int hq,
                      int hkv, int page, int n_pages, int split_len, int n_split, float scale,
                      cudaStream_t s) {
  const PagedKV<T> kv{static_cast<const T*>(k),
                      static_cast<const T*>(v),
                      PoolStrides{st[2], st[3], st[4]},
                      PoolStrides{st[5], st[6], st[7]},
                      tables,
                      n_pages,
                      tiles::FastDiv(page)};
  return dispatch_group<T, D, DP>(q, kv, vl, o, ws, nullptr, Strides2{st[0], st[1]},
                                  Strides2{st[8], st[9]}, b, hq, hkv, n_pages * page, split_len,
                                  n_split, scale, s);
}

template <typename T>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v, const int* tbl,
                         const int* vl, void* o, float* ws, const int64_t* st, int b, int hq,
                         int hkv, int page, int n_pages, int split_len, int n_split,
                         float scale, cudaStream_t s) {
  // float32 rows of 48, 80 and 96 columns run padded to a power of two
  constexpr bool f32 = std::is_same<T, float>::value;
  switch (d) {
    case 48: return paged_dim<T, 48, f32 ? 64 : 48>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    case 64: return paged_dim<T, 64, 64>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    case 80: return paged_dim<T, 80, f32 ? 128 : 80>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    case 96: return paged_dim<T, 96, f32 ? 128 : 96>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    case 128: return paged_dim<T, 128, 128>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    case 256: return paged_dim<T, 256, 256>(q, k, v, tbl, vl, o, ws, st, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 10 element strides: q (batch, head), k pool (page, head, slot),
// v pool (page, head, slot), o (batch, head); the pools 16-byte aligned
// (pointers and strides). tables: (B, n_pages) int32, contiguous, every id
// in the pool; valid_len: (B,) int32; both on the card. n_split splits of
// split_len of the n_pages * page logical slots; ws: the float32
// partial-state workspace of B * hq * n_split * (d + 2) floats, unused when
// n_split is 1. dtype: 0 float32, 1 bfloat16. Launches the split kernel
// and, with more than one split, the combine pass; returns the first
// failing launch's cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* k, const void* v,
                                     const void* tables, const void* valid_len, void* o,
                                     void* ws, const int64_t* strides, int b, int hq, int hkv,
                                     int page, int n_pages, int d, int n_split, int split_len,
                                     float scale, int dtype, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || page <= 0 || n_pages <= 0 || d <= 0 || n_split <= 0 ||
      split_len <= 0 || static_cast<int64_t>(n_pages) * page > 0x7fffffff ||
      static_cast<int64_t>(n_split) * split_len < static_cast<int64_t>(n_pages) * page)
    return (int)cudaErrorInvalidValue;
  const int* tbl = static_cast<const int*>(tables);
  const int* vl = static_cast<const int*>(valid_len);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)repro::dispatch_dim<float>(d, q, k, v, tbl, vl, o, w, strides, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
  if (dtype == 1)
    return (int)repro::dispatch_dim<__nv_bfloat16>(d, q, k, v, tbl, vl, o, w, strides, b, hq, hkv, page, n_pages, split_len, n_split, scale, s);
  return (int)cudaErrorInvalidValue;
}
