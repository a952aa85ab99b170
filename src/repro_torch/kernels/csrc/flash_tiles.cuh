// Index math of the tensor-core flash kernel: GQA packing, the keys a tile
// of rows may see, and which KV tiles need the element mask. Plain
// functions of integers, so a host build can run the tile loop without
// the card.
#pragma once

#include <stdint.h>

namespace repro {
namespace tiles {

// n / d for 0 <= n < 2^31 as a multiply-high and a shift: the magic number
// is found once, on the host (Granlund and Montgomery). The kernel divides
// packed row indices by Sq with it, where an integer division would cost
// some twenty dependent instructions a row.
struct FastDiv {
  int d;
  uint32_t mul, shift;
  __host__ __device__ explicit FastDiv(int d_ = 1) : d(d_), mul(0), shift(0) {
    if (d > 1) {
      int l = 0;
      while ((1u << l) < static_cast<uint32_t>(d)) ++l;  // ceil(log2 d)
      mul = static_cast<uint32_t>(((uint64_t(1) << (31 + l)) + d - 1) / d);
      shift = static_cast<uint32_t>(l - 1);
    }
  }
  __host__ __device__ int operator()(int n) const {
    if (d == 1) return n;
#ifdef __CUDA_ARCH__
    return static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shift);
#else
    return static_cast<int>(((uint64_t(static_cast<uint32_t>(n)) * mul) >> 32) >> shift);
#endif
  }
};

// Packed rows: the g q-heads of one kv-head are stacked, so packed row r is
// q-head r / sq (within the group) and query r % sq. A tile of rows then
// reads each K/V tile once for the whole group, however small sq is.
struct RowSpan {
  int q_lo, q_hi;  // the least and greatest query index among the rows
};

// Rows [r_begin, r_end) of the packed rows, `sq` dividing by Sq. A span
// that crosses into the next head covers its query 0 and its head's last
// query, so it is widened to every query; an empty span has q_hi < q_lo.
__host__ __device__ inline RowSpan packed_query_span(int r_begin, int r_end, const FastDiv& sq) {
  if (r_end <= r_begin) return {0, -1};
  const int h0 = sq(r_begin), h1 = sq(r_end - 1);
  if (h0 == h1) return {r_begin - h0 * sq.d, r_end - 1 - h1 * sq.d};
  return {0, sq.d - 1};
}

// Keys [begin, end) that some row of the span may see, `begin` rounded down
// to a KV tile of `bk`: the causal edge of the last query and the window
// of the first. Tiles outside are skipped; each row keeps its own keys.
struct KeySpan {
  int begin, end;
};
__host__ __device__ inline KeySpan key_span(RowSpan r, int sk, int causal, int window,
                                            int q_offset, int bk) {
  if (r.q_hi < r.q_lo) return {0, 0};
  int end = causal ? (r.q_hi + q_offset + 1 < sk ? r.q_hi + q_offset + 1 : sk) : sk;
  int begin = window > 0 ? r.q_lo + q_offset - window + 1 : 0;
  begin = begin > 0 ? (begin / bk) * bk : 0;
  if (end < begin) end = begin;
  return {begin, end};
}

// Whether the KV tile [k0, k0 + bk) needs the element mask for the span:
// it runs past sk, or some key lies beyond a row's causal edge, or before
// a row's window. A tile wholly inside every row's keys takes no mask.
__host__ __device__ inline bool tile_needs_mask(int k0, int bk, RowSpan r, int sk, int causal,
                                                int window, int q_offset) {
  if (k0 + bk > sk) return true;
  if (causal && k0 + bk - 1 > r.q_lo + q_offset) return true;
  if (window > 0 && k0 <= r.q_hi + q_offset - window) return true;
  return false;
}

// Whether query position qpos sees key kpos (the reference's mask; keys
// past sk are handled apart, they get no weight at all).
__host__ __device__ inline bool visible(int kpos, int qpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

}  // namespace tiles
}  // namespace repro
