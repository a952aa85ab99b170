// The split-KV decode kernels, shared by the dense cache
// (decode_attention.cu) and the paged pool (paged_attention.cu).
//
// Both kernels are templates over a "slot -> row address" policy: `KV::row(b,
// hk)` gives the K/V rows of one (batch row, kv-head), whose `offsets(s,
// lookup(s))` are the element offsets of slot s. A dense cache is one
// strided run of slots (`kb + s * k_stride`; `lookup` is nothing); a paged
// pool's `lookup` reads the slot's page id from the row's table once per row
// of a tile, and `offsets` adds the slot's place in the page. A tile's
// loader makes the lookup of its next row before it issues the copies of
// this one, so that the table load is in flight meanwhile (each copy's asm
// clobbers memory, so a lookup after one would wait for it). All the rest,
// the split rule, the shared-memory ring, the products, the softmax, the
// merge and the combine pass, is the same code for both.
//
// A CTA owns (split, kv-head, batch) and all G q-heads of its kv-head (a
// float32 group above 8: one of two sub-groups, see below), so each K/V row
// is read from device memory once; the slots are split across
// CTAs so that a small batch still fills the 132 SMs (kernels/ref.py
// split_plan). A CTA whose slots lie past its row's valid length stores an
// empty state and exits. A CTA streams its slots through a two-stage ring of
// K/V tiles in shared memory, filled by 16-byte cp.async copies while the
// warps work on the other stage. Each CTA's (m, l, acc) states are merged
// through shared memory (split_kv.cuh) into the finished rows when there is
// one split, else into its partial state, which the combine pass merges.
// Two kernels, chosen by dtype:
//
// bf16: `tc::decode_tc_kernel`, both products on the tensor cores with
// mma.sync (see its note below): on the CUDA cores the 2*D*G multiply-adds
// of a slot, not its bytes, would bound it. Any D that is a multiple of 16
// (48, 80 and 96 included), and groups of up to 16 q-heads, the M rows of
// one mma tile: K/V are read once per kv-head whatever the group.
//
// float32: `decode_split_kernel`, on the CUDA cores (f32 keeps 2e-5). The
// four warps split the slots; each slot's row is read from shared memory
// as 16-byte vectors by a group of DP * sizeof(T) / 16 lanes (at most 32),
// each lane holding its columns of q and of the output for every q-head.
// A CTA holds at most 8 q-heads (kMaxF32Heads): at 16 the registers of q,
// the output and the dot products would spill, and the merge states of D =
// 256 would not fit the ring. A larger group (9 to 16) is split into equal
// sub-groups on the grid's y axis, so K/V are read once per sub-group (twice
// per kv-head): float32 is the parity path, not the served one.
// DP is D rounded up to a power of two, so the lane groups divide a warp:
// at D = 48, 80 and 96 the ring's columns past D are zeros and so are q's,
// and they are never stored. The G * 4 partial dot products of four steps
// are summed across the group by one reduce-scatter (about G * 4 shuffles,
// not G * 4 * log2 lanes) and shared through shared memory; each lane group
// keeps an online softmax per q-head.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "split_kv.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kTileBytes = 16384;  // K or V of one tile
constexpr int kMaxGroup = 16;      // q-heads per kv-head the kernels take
constexpr int kMaxF32Heads = 8;    // q-heads a float32 CTA holds

struct Strides2 {
  int64_t b, h;
};

// ---------------------------------------------------------------------------
// slot -> row address policies
// ---------------------------------------------------------------------------

// K/V rows of one (batch row, kv-head) of a dense cache: slot s at
// kb + s * k_stride.
template <typename T>
struct DenseRows {
  const T* kb;
  const T* vb;
  int64_t k_stride, v_stride;
  __device__ __forceinline__ int lookup(int) const { return 0; }
  __device__ __forceinline__ void offsets(int s, int, int64_t& ko, int64_t& vo) const {
    ko = s * k_stride;
    vo = s * v_stride;
  }
};
template <typename T>
struct DenseKV {
  const T* k;
  const T* v;
  Strides ks, vs;
  __device__ __forceinline__ DenseRows<T> row(int b, int hk) const {
    return {k + b * ks.b + hk * ks.h, v + b * vs.b + hk * vs.h, ks.s, vs.s};
  }
};

// element strides of a (n_pool, Hkv, page, D) pool view
struct PoolStrides {
  int64_t page, h, t;
};
// K/V rows of one (batch row, kv-head) of a paged pool: slot s lies in pool
// page table[s / page] at offset s % page.
template <typename T>
struct PagedRows {
  const T* kb;
  const T* vb;
  const int* table;
  tiles::FastDiv page;
  int64_t k_page, k_t, v_page, v_t;
  // the pool page of slot s
  __device__ __forceinline__ int lookup(int s) const { return __ldg(table + page(s)); }
  __device__ __forceinline__ void offsets(int s, int pg, int64_t& ko, int64_t& vo) const {
    const int t = s - page(s) * page.d;
    ko = pg * k_page + t * k_t;
    vo = pg * v_page + t * v_t;
  }
};
template <typename T>
struct PagedKV {
  const T* k;
  const T* v;
  PoolStrides ks, vs;
  const int* tables;  // (B, n_pages)
  int n_pages;
  tiles::FastDiv page;
  __device__ __forceinline__ PagedRows<T> row(int b, int hk) const {
    return {k + hk * ks.h, v + hk * vs.h, tables + static_cast<int64_t>(b) * n_pages, page,
            ks.page, ks.t, vs.page, vs.t};
  }
};

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// The kernel's geometry for DP columns of T and G (a power of two) q-heads.
template <typename T, int DP, int G>
struct Cfg {
  static constexpr int kElems = 16 / sizeof(T);             // elements a vector
  static constexpr int kTile = kTileBytes / (DP * (int)sizeof(T));  // slots a tile
  static constexpr int kRowVecs = DP / kElems;              // vectors a row
  static constexpr int kLanes = kRowVecs < 32 ? kRowVecs : 32;  // lanes a slot
  static constexpr int kVecs = kRowVecs / kLanes;           // vectors a lane a row
  static constexpr int kSlots = 32 / kLanes;                // slots a warp step
  static constexpr int kCols = kVecs * kElems;              // columns a lane
  static constexpr int kUnroll = 4;                         // warp steps a softmax update
  static constexpr int kItems = G * kUnroll;                // dot products a step
  static constexpr int kStates = kWarps * kSlots;           // softmax states a head
  static constexpr int kSmem = kStages * 2 * kTileBytes;
  static_assert(kSlots * kLanes == 32, "lane groups must divide a warp");
  static_assert(kStates * G * (DP + 2) * 4 <= kSmem, "merge states exceed the ring");
};

// Reduce-scatter of N partial sums over the O * 2 lanes of a group: each
// level swaps half the sums with the partner lane and adds, so after
// log2(min(N, 2 * O)) levels lane j holds whole sums, at a cost of about N
// shuffles where reducing each sum alone would take N * log2(2 * O). Once
// one sum is left the remaining levels reduce it as a plain butterfly.
template <int N, int O>
struct Scatter {
  static __device__ __forceinline__ void run(float* v, int j) {
    if constexpr (O > 0) {
      if constexpr (N > 1) {
        const bool up = j & O;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float send = up ? v[i] : v[i + N / 2];
          const float keep = up ? v[i + N / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
        }
        Scatter<N / 2, O / 2>::run(v, j);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
        Scatter<1, O / 2>::run(v, j);
      }
    }
  }
};

// The first of the sums that lane j holds after Scatter<N, lanes / 2>, and
// how many it holds.
template <int N, int LANES>
struct Scattered {
  static constexpr int kHeld = N > LANES ? N / LANES : 1;
  static __device__ __forceinline__ int first(int j) {
    int first = 0, n = N;
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) {
      if (n > 1) {
        if (j & o) first += n / 2;
        n /= 2;
      }
    }
    return first;
  }
};

__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float* f = reinterpret_cast<const float*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}
__device__ __forceinline__ void unpack(const uint4& u, float* out, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Slots [s0, s0 + n) of K and V into one stage of the ring (rows of DP
// elements, of which the first D are copied).
template <typename T, int D, int DP, typename Rows>
__device__ __forceinline__ void load_tile(T* k_dst, T* v_dst, const Rows& rows, int s0, int n) {
  constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  constexpr int kElems = 16 / sizeof(T);
  int hint = threadIdx.x < n * kChunks ? rows.lookup(s0 + threadIdx.x / kChunks) : 0;
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int next = i + kThreads < n * kChunks ? rows.lookup(s0 + (i + kThreads) / kChunks) : 0;
    int64_t ko, vo;
    rows.offsets(s0 + r, hint, ko, vo);
    cp_async16(k_dst + r * DP + c * kElems, rows.kb + ko + c * kElems);
    cp_async16(v_dst + r * DP + c * kElems, rows.vb + vo + c * kElems);
    hint = next;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, int D, int DP, int G, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, KV kv, const int* __restrict__ valid_len,
                    T* __restrict__ o, float* __restrict__ ws, float* __restrict__ lse,
                    Strides2 qs, Strides2 os,
                    int group, int sub_len, int hq, int batch, int s_len, int split_len,
                    int n_split, float scale) {
  using R = Cfg<T, DP, G>;
  constexpr int C = R::kCols;
  constexpr int U = R::kUnroll;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  T* ring = reinterpret_cast<T*>(decode_smem);  // stage s: K at 2s tiles, V at 2s + 1

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / R::kLanes;  // the slot of this lane's group in a step
  const int j = lane % R::kLanes;    // the lane within its group
  const int split = blockIdx.x;
  // blockIdx.y: kv-head hk's sub-group `sg` of sub_len q-heads (one
  // sub-group, the whole group, unless the group exceeds kMaxF32Heads)
  const int n_sub = (group + sub_len - 1) / sub_len;
  const int hk = blockIdx.y / n_sub;
  const int sg = blockIdx.y - hk * n_sub;
  const int b = blockIdx.z;
  const int h0 = hk * group + sg * sub_len;
  const int heads = min(sub_len, group - sg * sub_len);  // this CTA's q-heads

  const int vl = valid_len[b];
  const bool all_masked = vl <= 0;  // every slot masked: uniform softmax
  const int n = all_masked ? s_len : min(vl, s_len);
  const splitkv::Range range = splitkv::split_range(split, split_len, n);
  if (range.begin >= range.end) {  // only a split past the first can be empty
    splitkv::store_empty(ws, b, h0, heads, split, hq, n_split);
    return;
  }

  if constexpr (D != DP) {  // the ring's columns past D stay zero
    for (int i = threadIdx.x; i < kStages * 2 * R::kTile * (DP - D); i += kThreads) {
      const int r = i / (DP - D);
      ring[r * DP + D + (i - r * (DP - D))] = from_f32<T>(0.f);
    }
  }
  const auto rows = kv.row(b, hk);
  const int n_tiles = (range.end - range.begin + R::kTile - 1) / R::kTile;
  load_tile<T, D, DP>(ring, ring + R::kTile * DP, rows, range.begin,
                      min(R::kTile, range.end - range.begin));

  // lane j of a group holds columns (vv * kLanes + j) * kElems + e of every
  // q-head
  float qr[G][C];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const T* qh = q + b * qs.b + (h0 + (g < heads ? g : 0)) * qs.h;
#pragma unroll
    for (int vv = 0; vv < R::kVecs; ++vv)
#pragma unroll
      for (int e = 0; e < R::kElems; ++e) {
        const int col = (vv * R::kLanes + j) * R::kElems + e;
        qr[g][vv * R::kElems + e] = g < heads && col < D ? to_f32(qh[col]) : 0.f;
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
  // a lane group's whole dot products of a step, shared within the warp
  __shared__ float dots[kWarps][R::kSlots][R::kItems];
  const int first = Scattered<R::kItems, R::kLanes>::first(j);

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = range.begin + t * R::kTile;
    if (t + 1 < n_tiles) {
      T* nxt = ring + ((t + 1) % kStages) * 2 * R::kTile * DP;
      const int s1 = s0 + R::kTile;
      load_tile<T, D, DP>(nxt, nxt + R::kTile * DP, rows, s1, min(R::kTile, range.end - s1));
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const T* kt = ring + (t % kStages) * 2 * R::kTile * DP + j * R::kElems;
    const T* vt = kt + R::kTile * DP;
    const int n_t = min(R::kTile, range.end - s0);

    constexpr int kStep = kWarps * R::kSlots;  // slots the CTA covers a step
    // the bound is warp-uniform: every lane reaches the shuffles
    for (int base = warp * R::kSlots; base < n_t; base += U * kStep) {
      float part[R::kItems];  // item g * U + u: q-head g against slot u
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = base + u * kStep + sub;
        float kf[C];
#pragma unroll
        for (int vv = 0; vv < R::kVecs; ++vv) {
          const uint4 kv4 = slot < n_t ? *reinterpret_cast<const uint4*>(
                                             kt + slot * DP + vv * R::kLanes * R::kElems)
                                       : make_uint4(0, 0, 0, 0);
          unpack(kv4, &kf[vv * R::kElems], T());
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) dot += qr[g][c] * kf[c];
          part[g * U + u] = dot;
        }
      }
      Scatter<R::kItems, R::kLanes / 2>::run(part, j);
#pragma unroll
      for (int i = 0; i < Scattered<R::kItems, R::kLanes>::kHeld; ++i)
        dots[warp][sub][first + i] = part[i];
      __syncwarp();
      float sc[G][U];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int u = 0; u < U; ++u)
          sc[g][u] = base + u * kStep + sub >= n_t
                         ? -INFINITY
                         : (all_masked ? kNegInf : dots[warp][sub][g * U + u] * scale);
      __syncwarp();  // read before the next step writes
      // online softmax per q-head over this step's slots; sc becomes p
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, sc[g][u]);
        if (m_new == -INFINITY) {  // this lane group saw no slot yet
#pragma unroll
          for (int u = 0; u < U; ++u) sc[g][u] = 0.f;
          continue;
        }
        const float alpha = __expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[g][u] = __expf(sc[g][u] - m_new);
          l[g] += sc[g][u];
        }
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int slot = base + u * kStep + sub;
        if (slot >= n_t) continue;
        float vf[C];
#pragma unroll
        for (int vv = 0; vv < R::kVecs; ++vv)
          unpack(*reinterpret_cast<const uint4*>(vt + slot * DP + vv * R::kLanes * R::kElems),
                 &vf[vv * R::kElems], T());
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int c = 0; c < C; ++c) acc[g][c] += sc[g][u] * vf[c];
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // merge the lane groups' softmax states (in the ring, no longer read),
  // then store rows or the partial
  float* m_s = reinterpret_cast<float*>(decode_smem);   // [kStates][G]
  float* l_s = m_s + R::kStates * G;                    // [kStates][G]
  float* acc_s = l_s + R::kStates * G;                  // [kStates][G][DP]
  const int state = warp * R::kSlots + sub;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (j == 0) {
      m_s[state * G + g] = m[g];
      l_s[state * G + g] = l[g];
    }
#pragma unroll
    for (int vv = 0; vv < R::kVecs; ++vv)
#pragma unroll
      for (int e = 0; e < R::kElems; ++e)
        acc_s[(state * G + g) * DP + (vv * R::kLanes + j) * R::kElems + e] =
            acc[g][vv * R::kElems + e];
  }
  __syncthreads();
  splitkv::merge_and_store<T, G, D, R::kStates, DP>(m_s, l_s, acc_s, heads, b, h0, split,
                                                    n_split, hq, batch, o, os.b, os.h, ws, lse);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync.m16n8k16, f32 accumulate). The q-heads are
// the M rows of one tile: G <= 8 fill its first 8 rows (rows 8..15 are
// zeros and never stored), G = 16 (groups 9..16) both halves, each lane
// then holding two rows (`row` and `row + 8`) of S, of the softmax state
// and of O. A warp owns 16 slots of each 64-slot tile: S = Q.K^T as two
// n-tiles of 8 slots over D / 16 k-steps (K fragments by ldmatrix from the
// ring), an online softmax over its slots, and O += P.V with P from the S
// registers (the accumulator layout of two n-tiles is the A layout of one
// k-step) and V fragments by ldmatrix.trans, so V needs no transpose. The
// K/V bytes do not grow with G: the 16-row tile costs the 8-row one's
// loads and mma count. For a row with at most kExactPKeys valid slots P
// goes in as three bf16 terms (hi + mid + lo): there the outputs are large
// and one bf16 P would move them by an output ulp. Ring rows are padded by
// 16 bytes so that ldmatrix reads are free of bank conflicts; rows past the
// split are zero-filled.
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;         // slots a tile: 16 a warp
constexpr int kExactPKeys = 512;  // rows with at most this many keys take P in three terms

template <int D>
struct TcCfg {
  static constexpr int kRow = D + 8;                        // padded row, elements
  static constexpr int kTileElems = kTile * kRow;           // one K or V tile
  static constexpr int kSmem = kStages * 2 * kTileElems * 2;
  static_assert(D % 16 == 0, "the mma k-steps take 16 columns");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, k-major)
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// p rounded to a bf16 pair; p keeps what the rounding left
__device__ __forceinline__ uint32_t split_pair(float& x, float& y) {
  const uint32_t r = pack(x, y);
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  x -= f.x;
  y -= f.y;
  return r;
}

// Slots [s0, s0 + kTile) of K and V into one stage; slots at or past `n`
// are zero-filled.
template <int D, typename Rows>
__device__ __forceinline__ void load_tile(bf16* k_dst, bf16* v_dst, const Rows& rows, int s0,
                                          int n) {
  constexpr int kChunks = D / 8;
  constexpr int kRow = TcCfg<D>::kRow;
  int hint = s0 + static_cast<int>(threadIdx.x) / kChunks < n
                 ? rows.lookup(s0 + threadIdx.x / kChunks) : 0;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int rn = (i + kThreads) / kChunks;
    const int next = rn < kTile && s0 + rn < n ? rows.lookup(s0 + rn) : 0;
    const bool in = s0 + r < n;
    const int bytes = in ? 16 : 0;
    int64_t ko = 0, vo = 0;
    if (in) rows.offsets(s0 + r, hint, ko, vo);
    const bf16* ks = in ? rows.kb + ko + c * 8 : rows.kb;
    const bf16* vs = in ? rows.vb + vo + c * 8 : rows.vb;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(k_dst + r * kRow + c * 8)),
                 "l"(ks), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(v_dst + r * kRow + c * 8)),
                 "l"(vs), "r"(bytes)
                 : "memory");
    hint = next;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int D, int G, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_tc_kernel(const bf16* __restrict__ q, KV kv, const int* __restrict__ valid_len,
                 bf16* __restrict__ o, float* __restrict__ ws, float* __restrict__ lse,
                 Strides2 qs, Strides2 os,
                 int group, int hq, int batch, int s_len, int split_len, int n_split,
                 float scale) {
  using L = TcCfg<D>;
  constexpr int kRow = L::kRow;
  constexpr int KS = D / 16;           // k-steps of Q.K^T
  constexpr int NT = D / 8;            // n-tiles of O
  constexpr int MH = G > 8 ? 2 : 1;    // 8-row halves of the M tile that hold q-heads
  static_assert(G <= 16, "one m16 tile holds at most 16 q-heads");
  static_assert(kWarps * G * (D + 2) * 4 <= L::kSmem, "merge states exceed the ring");
  extern __shared__ __align__(16) unsigned char decode_smem[];
  bf16* ring = reinterpret_cast<bf16*>(decode_smem);  // stage s: K at 2s tiles, V at 2s + 1

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = lane / 4;        // this lane's q-head (its M row), and row + 8 where MH = 2
  const int quad = lane % 4;
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int h0 = hk * group;

  const int vl = valid_len[b];
  const bool all_masked = vl <= 0;  // every slot masked: uniform softmax
  const int n = all_masked ? s_len : min(vl, s_len);
  const splitkv::Range range = splitkv::split_range(split, split_len, n);
  if (range.begin >= range.end) {  // only a split past the first can be empty
    splitkv::store_empty(ws, b, h0, group, split, hq, n_split);
    return;
  }
  const bool exact = n <= kExactPKeys;

  const auto rows = kv.row(b, hk);
  const int n_tiles = (range.end - range.begin + kTile - 1) / kTile;
  load_tile<D>(ring, ring + L::kTileElems, rows, range.begin, range.end);

  // Q as A fragments: qa[kk][half][hh] holds row `row + 8 hh`, columns
  // 16kk + 8 half + 2 * quad (+1): a0 = [0][0], a1 = [0][1], a2 = [1][0],
  // a3 = [1][1]; with MH = 1 a1 and a3 (rows 8..15) are zero
  uint32_t qa[KS][2][MH];
#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    const int r = row + 8 * hh;
    const bool live = r < group && r < G;
    const bf16* qh = q + b * qs.b + (h0 + (live ? r : 0)) * qs.h;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = 16 * kk + 8 * half + 2 * quad;
        qa[kk][half][hh] =
            live ? pack(__bfloat162float(qh[c]), __bfloat162float(qh[c + 1])) : 0u;
      }
  }

  // O rows `row + 8 hh`: columns 8 nt + 2 * quad (+1) in acc[nt][2 hh (+1)]
  float acc[NT][2 * MH];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2 * MH; ++e) acc[nt][e] = 0.f;
  float m_run[MH], l_run[MH];
#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    m_run[hh] = -INFINITY;
    l_run[hh] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s0 = range.begin + t * kTile;
    if (t + 1 < n_tiles) {
      bf16* nxt = ring + ((t + 1) % kStages) * 2 * L::kTileElems;
      load_tile<D>(nxt, nxt + L::kTileElems, rows, s0 + kTile, range.end);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const bf16* kt = ring + (t % kStages) * 2 * L::kTileElems + warp * 16 * kRow;
    const bf16* vt = kt + L::kTileElems;
    const int w0 = s0 + warp * 16;  // this warp's first slot

    if (w0 < range.end) {  // warp-uniform
      // S = Q.K^T over this warp's 16 slots: two n-tiles of 8; sc[j][e]
      // holds row `row + 8 (e / 2)`, slot w0 + 8j + 2 quad + e % 2
      float sc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int kk = 0; kk < KS; kk += 2) {
          // matrices: slots 8j.. of columns 16kk, 16kk + 8, 16kk + 16, 16kk + 24
          uint32_t bk[4];
          ldsm_x4(smem_u32(kt + (8 * j + lane % 8) * kRow + 16 * kk + 8 * (lane / 8)), bk);
          mma(sc[j], qa[kk][0][0], MH > 1 ? qa[kk][0][MH - 1] : 0u, qa[kk][1][0],
              MH > 1 ? qa[kk][1][MH - 1] : 0u, bk[0], bk[1]);
          if (kk + 1 < KS)
            mma(sc[j], qa[kk + 1][0][0], MH > 1 ? qa[kk + 1][0][MH - 1] : 0u, qa[kk + 1][1][0],
                MH > 1 ? qa[kk + 1][1][MH - 1] : 0u, bk[2], bk[3]);
        }
      float mt[MH];
#pragma unroll
      for (int hh = 0; hh < MH; ++hh) mt[hh] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2 * MH; ++e) {
          const int slot = w0 + 8 * j + 2 * quad + (e & 1);
          float x = slot >= range.end ? -INFINITY : (all_masked ? kNegInf : sc[j][e] * scale);
          sc[j][e] = x;
          mt[e / 2] = fmaxf(mt[e / 2], x);
        }
      float m_new[MH];
#pragma unroll
      for (int hh = 0; hh < MH; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        m_new[hh] = fmaxf(m_run[hh], mt[hh]);  // finite: w0 < range.end
        const float alpha = __expf(m_run[hh] - m_new[hh]);
        m_run[hh] = m_new[hh];
        l_run[hh] *= alpha;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][2 * hh] *= alpha;
          acc[nt][2 * hh + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2 * MH; ++e) {
          sc[j][e] = __expf(sc[j][e] - m_new[e / 2]);
          l_run[e / 2] += sc[j][e];
        }
      // O += P.V, P as one bf16 term or three
      const int terms = exact ? 3 : 1;
      for (int term = 0; term < terms; ++term) {
        const uint32_t pa0 = split_pair(sc[0][0], sc[0][1]);
        const uint32_t pa2 = split_pair(sc[1][0], sc[1][1]);
        uint32_t pa1 = 0u, pa3 = 0u;  // rows 8..15
        if constexpr (MH > 1) {
          pa1 = split_pair(sc[0][2], sc[0][3]);
          pa3 = split_pair(sc[1][2], sc[1][3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          // matrices: slots 0-7 and 8-15 of columns 8nt.., then of 8nt + 8..
          uint32_t bv[4];
          ldsm_x4_t(smem_u32(vt + (lane % 8 + 8 * ((lane / 8) % 2)) * kRow + 8 * nt +
                             8 * (lane / 16)),
                    bv);
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            // with MH = 1 the M rows past 8 (c[2], c[3]) take zeros and give zeros
            float c[4] = {acc[nt + x][0], acc[nt + x][1], 0.f, 0.f};
            if constexpr (MH > 1) {
              c[2] = acc[nt + x][2];
              c[3] = acc[nt + x][3];
            }
            mma(c, pa0, pa1, pa2, pa3, bv[2 * x], bv[2 * x + 1]);
            acc[nt + x][0] = c[0];
            acc[nt + x][1] = c[1];
            if constexpr (MH > 1) {
              acc[nt + x][2] = c[2];
              acc[nt + x][3] = c[3];
            }
          }
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  // the quad's partial row sums, then merge the four warps' states (in the
  // ring, no longer read) and store rows or the partial
  float* m_s = reinterpret_cast<float*>(decode_smem);   // [kWarps][G]
  float* l_s = m_s + kWarps * G;                        // [kWarps][G]
  float* acc_s = l_s + kWarps * G;                      // [kWarps][G][D]
#pragma unroll
  for (int hh = 0; hh < MH; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    const int r = row + 8 * hh;
    if (r < G) {
      if (quad == 0) {
        m_s[warp * G + r] = m_run[hh];
        l_s[warp * G + r] = l_run[hh];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        acc_s[(warp * G + r) * D + 8 * nt + 2 * quad] = acc[nt][2 * hh];
        acc_s[(warp * G + r) * D + 8 * nt + 2 * quad + 1] = acc[nt][2 * hh + 1];
      }
    }
  }
  __syncthreads();
  splitkv::merge_and_store<bf16, G, D, kWarps>(m_s, l_s, acc_s, group, b, h0, split, n_split,
                                               hq, batch, o, os.b, os.h, ws, lse);
}

}  // namespace tc

// The split kernel for T and D on the cache `kv`, and with more than one
// split the combine pass. DP: the float32 kernel's padded width (D rounded
// up to a power of two); sub_len: the q-heads of a float32 CTA.
template <typename T, int D, int DP, int G, typename KV>
cudaError_t launch_decode(const void* q, const KV& kv, const int* valid_len, void* o, float* ws,
                          float* lse, Strides2 qs, Strides2 os, int b, int hq, int hkv, int s_len,
                          int split_len, int n_split, int sub_len, float scale,
                          cudaStream_t stream) {
  const int group = hq / hkv;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int smem = tc::TcCfg<D>::kSmem;
    static const cudaError_t attr = cudaFuncSetAttribute(
        tc::decode_tc_kernel<D, G, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    tc::decode_tc_kernel<D, G, KV><<<dim3(n_split, hkv, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), kv, valid_len, static_cast<T*>(o), ws, lse, qs, os, group, hq, b,
        s_len, split_len, n_split, scale);
  } else {
    using R = Cfg<T, DP, G>;
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_split_kernel<T, D, DP, G, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        R::kSmem);
    if (attr != cudaSuccess) return attr;
    const int n_sub = (group + sub_len - 1) / sub_len;
    decode_split_kernel<T, D, DP, G, KV><<<dim3(n_split, hkv * n_sub, b), kThreads, R::kSmem,
                                           stream>>>(
        static_cast<const T*>(q), kv, valid_len, static_cast<T*>(o), ws, lse, qs, os, group, sub_len,
        hq, b, s_len, split_len, n_split, scale);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return splitkv::launch_combine<T>(ws, o, lse, os.b, os.h, b, hq, n_split, D, stream);
}

// G is the q-heads a CTA holds rounded up to a power of two: the q-heads past
// them are zeros that are never stored. bf16 holds the whole group (up to
// 16); float32 at most kMaxF32Heads, a larger group going out in equal
// sub-groups (10 as 5 + 5, 16 as 8 + 8).
template <typename T, int D, int DP, typename KV>
cudaError_t dispatch_group(const void* q, const KV& kv, const int* vl, void* o, float* ws,
                           float* lse, Strides2 qs, Strides2 os, int b, int hq, int hkv, int s_len,
                           int split_len, int n_split, float scale, cudaStream_t s) {
  const int group = hq / hkv;
  if (group > kMaxGroup) return cudaErrorInvalidValue;
  constexpr bool f32 = std::is_same<T, float>::value;
  const int n_sub = f32 ? (group + kMaxF32Heads - 1) / kMaxF32Heads : 1;
  const int heads = (group + n_sub - 1) / n_sub;
  if (heads == 1) return launch_decode<T, D, DP, 1>(q, kv, vl, o, ws, lse, qs, os, b, hq, hkv, s_len, split_len, n_split, heads, scale, s);
  if (heads == 2) return launch_decode<T, D, DP, 2>(q, kv, vl, o, ws, lse, qs, os, b, hq, hkv, s_len, split_len, n_split, heads, scale, s);
  if (heads <= 4) return launch_decode<T, D, DP, 4>(q, kv, vl, o, ws, lse, qs, os, b, hq, hkv, s_len, split_len, n_split, heads, scale, s);
  if (heads <= 8) return launch_decode<T, D, DP, 8>(q, kv, vl, o, ws, lse, qs, os, b, hq, hkv, s_len, split_len, n_split, heads, scale, s);
  if constexpr (!f32)
    return launch_decode<T, D, DP, 16>(q, kv, vl, o, ws, lse, qs, os, b, hq, hkv, s_len, split_len, n_split, heads, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
