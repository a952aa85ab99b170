// Causal / sliding-window flash attention (prefill) for Hopper.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`): the same online
// softmax with a float32 (m, l, acc) state, GQA by q-head h -> kv-head
// h / group, query positions shifted by q_offset, and the mask
// `k <= q` (causal) and `k > q - window` filled with -1e30; keys past Sk
// get no weight at all.
//
// What bounds it on an H100: at a long prompt the work is 4*Sq*Sk*D/2
// multiply-adds per head, far above the card's 295 operations per byte, so
// the bound is the tensor cores' rate. At the serving path's prompts
// (Sq <= 32) there is almost no work and the launch itself dominates.
//
// Two kernels, chosen by dtype (not a fallback: each input type has one):
//
// bf16: the tensor-core kernel `flash_tc_kernel`. Both products run as
// wgmma.mma_async (m64nNk16, f32 accumulate): S = Q.K^T with Q and K from
// shared memory (K-major), and O += P.V with P rounded to bf16 in registers
// as the A operand (as FA3 does) and V read MN-major through the
// descriptor's transpose bit, so V needs no transpose. A CTA holds one or
// two consumer warpgroups of 64 query rows (two where the grid fills the
// card, one for the serving path's short prompts, for twice the CTAs); they
// share a two-stage ring of K/V tiles of 64 keys, which cp.async fills
// (16-byte copies written straight into the 128-byte swizzle of the
// descriptors, Q with K ahead of V) while the warpgroups multiply the
// other stage. cp.async rather than TMA: the operands are strided views of
// (B, S, H, D) model tensors, which cp.async takes as they are, where TMA
// would need a tensor map encoded on the host for every call (the driver
// API, and host time on a host-bound path). The g q-heads of a kv-head are
// packed into the rows (row r is q-head r / Sq, query r % Sq, divided by a
// multiply-high), so at the serving path's small prompts one tile holds the
// whole group and each K/V tile is read once for it. KV tiles outside a
// warpgroup's causal or window horizon are skipped, the element mask runs
// only on tiles that cross a boundary, and the CTAs are launched longest
// first. Rows past the end load zeros and are not stored; the output goes
// out through shared memory as 16-byte stores, through its own strides.
// Head dims 48 and 96 (MLA's qk_nope + qk_rope, reduced and at full width)
// are 96 and 192 bytes a row, no whole number of 128-byte swizzle atoms:
// the tiles are padded to the next multiple of 64 columns inside shared
// memory (DP = 64 and 128), the missing columns filled with zeros by
// cp.async with a zero source size, so nothing is padded in device memory.
// S = Q.K^T runs only the k-steps of the D real columns; O += P.V runs at
// N = DP, whose padded columns are products with the zero V columns, and
// they are never stored. The padding costs (DP - D) / D more P.V work and
// shared memory, a third at D = 48 and 96.
// Accuracy: for a warpgroup whose rows see at most kExactPKeys keys (where
// the outputs are largest), P goes in as three bf16 terms hi + mid + lo and
// S is summed a 64-column block at a time in f32, which keeps the output
// within the float32 plain version's own rounding; one bf16 P would move
// such rows by an output ulp of their largest values. At D = 256 the O
// accumulator is 128 registers a thread; ptxas prints the count.
//
// Both kernels can also write each row's logsumexp of scale * q.k, float32
// (B, Hq, Sq), when handed a buffer for it: the saved statistic of the
// FlashAttention-2 backward (`_flash_fwd_impl`'s `lse` in
// src/repro/models/layers.py). It costs one store a row in the epilogue;
// serving passes null and its launches do the same work as without it.
//
// float32: `flash_f32_kernel`, both products on the tensor cores in
// float32 accuracy (3xTF32, `tf32.cuh`): each operand is split into TF32
// hi and lo parts in registers as its fragment is loaded, and the
// accumulator takes lo.hi + hi.lo + hi.hi, small terms first, which keeps
// the f32 contract of 2e-5 (one TF32 product would not). The products are
// mma.sync m16n8k8 TF32 with f32 accumulation, not wgmma: tf32 wgmma takes
// K-major B operands only, so V would have to be transposed (and split)
// into shared memory a tile at a time, where mma.sync reads each B
// fragment as scalars a lane and needs no transpose; and the split runs in
// registers either way. A CTA is four warps of 16 packed rows (64 rows:
// the g q-heads of a kv-head packed as in the bf16 kernel, so each K/V
// tile is read once for the group); a lane reads its Q and K fragments as
// 16-byte vectors (two k-steps of 8 from 16 columns: the reduction's order
// is permuted alike in both operands) and its V fragment as scalars, from
// rows padded against bank conflicts. P goes from the S accumulator into
// the A fragment of O += P.V where it lies (keys 2t and 2t + 1 serve as
// the k-step's t and t + 4, and V's rows are read in that order). Q stays
// in shared memory and is split again each tile (16 rows against the 2 x
// 32 or 64 key rows of K and V). S is summed a 16-column block at a time
// and the blocks added in f32: the tensor core rounds its sums toward
// zero, and one accumulator over all of D 256 moved the logsumexp by
// 5e-6, which the FA2 backward turned into a 3.6e-5 gradient error (on an
// NVIDIA H100 80GB HBM3 at 700 W). K/V tiles of 64 keys (32 at D >= 96, so
// that two CTAs fit an SM at D 96 and 128, one at D 256: 206 KB) go
// through a two-stage cp.async ring, K apart from V, with the bf16
// kernel's tile skipping, element masks only on boundary tiles, and
// longest CTAs first. At D = 256 the O accumulator is 128 registers a
// thread; ptxas prints the count. Operands whose pointers or strides are
// not 16-byte aligned are copied 4 bytes at a time. On an NVIDIA H100 80GB
// HBM3 at 700 W this took the long float32 rows from the CUDA-core
// design's 3334 / 2175 / 1619 µs to 845 / 503 / 427 µs (minicpm3-4b 2048²
// D 96, gemma3-12b local 1024² D 256, whisper-base's encoder): under SDPA
// and the plain version, at 3.5-8.8% of the TF32 bound.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace repro {
namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBM = 64;     // query rows a consumer warpgroup
constexpr int kBK = 64;     // keys a KV tile
constexpr int kStages = 2;  // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// A warpgroup whose rows see at most this many keys takes P in three bf16
// terms and sums S in f32 a 64-column block at a time. There the largest
// outputs lie (a row over n keys has |o| of about sqrt(e / n)), and one
// bf16 P, or the wgmma accumulator's rounding over a whole row of D, moves
// them by an output ulp, beyond the float32 reference's own rounding; over
// more keys the outputs are small and so are their ulps.
constexpr int kExactPKeys = 512;

// The tiles' width in shared memory: D padded to whole 64-column (128-byte)
// swizzle atoms.
template <int D>
__host__ __device__ constexpr int padded_dim() {
  return (D + 63) / 64 * 64;
}

// WG consumer warpgroups share each K/V tile: two where the grid fills the
// card anyway (half the K/V traffic per row), one where it would not.
template <int D, int WG>
struct Cfg {
  static constexpr int kDP = padded_dim<D>();
  static constexpr int kRows = kBM * WG;               // packed rows a CTA
  static constexpr int kThreads = 128 * WG;
  static constexpr int kQ = kRows * kDP * 2;            // the CTA's Q rows
  static constexpr int kTile = kBK * kDP * 2;           // one K or V tile
  static constexpr int kBytes = kQ + kStages * 2 * kTile + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + kBK) of a (seq, D) operand into a swizzled tile of
// padded_dim<D>() columns; rows at or past `n`, and the padding columns, are
// zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_kv_tile(uint32_t dst, const bf16* src, int64_t stride,
                                             int row0, int n, int tid) {
  constexpr int kChunks = padded_dim<D>() / 8;
#pragma unroll
  for (int k = 0; k < kBK * kChunks / NT; ++k) {
    const int i = tid + k * NT;
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < n && c < D / 8;
    const bf16* p = in ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(dst + sw128_offset(r, c, kBK), p, in);
  }
}

// The CTA's packed Q rows [r0, r0 + ROWS) into a swizzled tile of
// padded_dim<D>() columns; rows at or past `rows_total`, and the padding
// columns, are zero-filled. Row r is q-head r / Sq, query r % Sq.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_q_tile(uint32_t dst, const bf16* qb, Strides qs,
                                            const tiles::FastDiv& sq, int r0, int rows_total,
                                            int tid) {
  constexpr int kChunks = padded_dim<D>() / 8;
  constexpr int kStep = NT / kChunks;  // rows a pass
  const int c = tid % kChunks;
#pragma unroll
  for (int k = 0; k < ROWS / kStep; ++k) {
    const int r = tid / kChunks + k * kStep;
    const int pr = r0 + r;
    const int head = sq(pr);
    const bool in = pr < rows_total && c < D / 8;
    const bf16* p = in ? qb + head * qs.h + (pr - head * sq.d) * qs.s + c * 8 : qb;
    cp_async16(dst + sw128_offset(r, c, ROWS), p, in);
  }
}

// Descriptors of k-step kk (16 elements of the reduction axis).
template <int ROWS>
__device__ __forceinline__ uint64_t q_desc(uint32_t q_s, int wg, int kk) {
  return sw128_desc(q_s + (kk >> 2) * ROWS * 128 + wg * kBM * 128 + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t k_desc(uint32_t k_s, int kk) {
  return sw128_desc(k_s + (kk >> 2) * kBK * 128 + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t v_desc(uint32_t v_s, int kk) {
  return sw128_desc(v_s + kk * 16 * 128, kBK * 128, 1024);
}

// N = DP, the padded width.
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n64(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n128(o, a, b);
}
template <>
__device__ __forceinline__ void wgmma_pv<256>(float (&o)[128], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_n256(o, a, b);
}

// S (+)= Q.K^T over k-steps [k_lo, k_hi) for the warpgroup's 64 rows against
// one K tile (64 keys).
template <int ROWS>
__device__ __forceinline__ void qk_steps(float (&s)[32], uint32_t q_s, uint32_t k_s, int wg,
                                         int k_lo, int k_hi, bool accumulate) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = k_lo; kk < k_hi; ++kk)
    wgmma_ss_n64(s, q_desc<ROWS>(q_s, wg, kk), k_desc(k_s, kk), accumulate || kk > k_lo);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// S = Q.K^T over the D / 16 k-steps of the real columns (the padding
// columns are never read): in one accumulator, or (`blocks`) a 64-column
// block of D at a time, the blocks summed in f32 with round-to-nearest.
template <int D, int ROWS>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t q_s, uint32_t k_s, int wg,
                                   bool blocks) {
  constexpr int kSteps = D / 16;
  if (!blocks || kSteps <= 4) {
    qk_steps<ROWS>(s, q_s, k_s, wg, 0, kSteps, false);
    return;
  }
  qk_steps<ROWS>(s, q_s, k_s, wg, 0, 4, false);
#pragma unroll
  for (int c = 1; c < (kSteps + 3) / 4; ++c) {
    float t[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) t[i] = 0.f;
    qk_steps<ROWS>(t, q_s, k_s, wg, 4 * c, min(4 * c + 4, kSteps), false);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] += t[i];
  }
}

// P as the A operand of the four k-steps of P.V, rounded to bf16; p keeps
// what the rounding left, so a second and third call give the next terms
// of P = hi + mid + lo.
__device__ __forceinline__ void p_split(float (&p)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float& x = p[8 * kk + 2 * i];
      float& y = p[8 * kk + 2 * i + 1];
      a[kk][i] = pack_bf16(x, y);
      const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a[kk][i]));
      x -= r.x;
      y -= r.y;
    }
}

// O += P.V for one V tile, at the padded width DP.
template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2], const uint32_t (&a)[4][4], uint32_t v_s) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<DP>(o, a[kk], v_desc(v_s, kk));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

__device__ __forceinline__ void bar_sync_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int D, int WG>
__global__ void __launch_bounds__(Cfg<D, WG>::kThreads, 1)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                Strides qs, Strides ks, Strides vs, Strides os, int group, tiles::FastDiv sq,
                int sk, int causal,
                int window, int q_offset, float scale_log2, int n_tiles) {
  using L = Cfg<D, WG>;
  constexpr int kDP = L::kDP;
  constexpr int kRows = L::kRows;
  constexpr int kThreads = L::kThreads;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t kv_s = base + L::kQ;  // stage s: K at + 2s tiles, V at + 2s + 1

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int warp = t / 32;
  const int lane = t % 32;
  const int tile = n_tiles - 1 - blockIdx.x;  // the longest causal tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_total = group * sq.d;
  const int r0 = tile * kRows;

  const bf16* qb = q + b * qs.b + hk * group * qs.h;
  const bf16* kb = k + b * ks.b + hk * ks.h;
  const bf16* vb = v + b * vs.b + hk * vs.h;

  // the keys the CTA loads, and the keys this warpgroup's rows may see
  const tiles::RowSpan cta_rows =
      tiles::packed_query_span(r0, min(r0 + kRows, rows_total), sq);
  const tiles::KeySpan cta_keys = tiles::key_span(cta_rows, sk, causal, window, q_offset, kBK);
  const int w0 = r0 + wg * kBM;
  const tiles::RowSpan wg_rows = tiles::packed_query_span(w0, min(w0 + kBM, rows_total), sq);
  const tiles::KeySpan wg_keys = tiles::key_span(wg_rows, sk, causal, window, q_offset, kBK);
  int min_keys = causal ? min(wg_rows.q_lo + q_offset + 1, sk) : sk;
  if (window > 0) min_keys = min(min_keys, window);
  const bool exact = min_keys <= kExactPKeys;

  // this thread's two rows: 16 * warp + lane / 4 and 8 below it
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = w0 + warp * 16 + lane / 4 + 8 * i;
    qpos[i] = (pr < rows_total ? pr - sq(pr) * sq.d : 0) + q_offset;
  }

  float acc[kDP / 2];
#pragma unroll
  for (int i = 0; i < kDP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_run[2] = {0.f, 0.f};
  bool first = true;  // no tile processed yet (warpgroup-uniform)

  // cp.async groups: Q with K of tile 0, then V of tile 0, then K and V of
  // each next tile apart, so S = Q.K^T starts before V has arrived
  const int n_kv = (cta_keys.end - cta_keys.begin + kBK - 1) / kBK;
  load_q_tile<D, kRows, kThreads>(q_s, qb, qs, sq, r0, rows_total, tid);
  if (n_kv > 0) load_kv_tile<D, kThreads>(kv_s, kb, ks.s, cta_keys.begin, sk, tid);
  cp_async_commit();
  if (n_kv > 0) load_kv_tile<D, kThreads>(kv_s + L::kTile, vb, vs.s, cta_keys.begin, sk, tid);
  cp_async_commit();

  for (int it = 0; it < n_kv; ++it) {
    const int k0 = cta_keys.begin + it * kBK;
    const uint32_t k_s = kv_s + (it % kStages) * 2 * L::kTile;
    const bool more = it + 1 < n_kv;
    if (more) {
      const uint32_t nxt = kv_s + ((it + 1) % kStages) * 2 * L::kTile;
      load_kv_tile<D, kThreads>(nxt, kb, ks.s, k0 + kBK, sk, tid);
      cp_async_commit();
      load_kv_tile<D, kThreads>(nxt + L::kTile, vb, vs.s, k0 + kBK, sk, tid);
      cp_async_commit();
    }
    // K of this tile (V of this tile and the next tile may fly)
    if (more) cp_async_wait<3>(); else cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const bool mine = k0 < wg_keys.end && k0 + kBK > wg_keys.begin;  // warpgroup-uniform
    float s[32];
    if (mine) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      qk<D, kRows>(s, q_s, k_s, wg, exact);

      // s stays raw (Q.K^T); a key a row may not see holds the finite mask
      // kNegInf (its weight is exp(kNegInf - m), the reference's), a key past
      // sk holds -inf (no weight at all)
      const bool masked =
          tiles::tile_needs_mask(k0, kBK, wg_rows, sk, causal, window, q_offset);
      float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e];
          float xm = x * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            if (kpos >= sk) {
              x = xm = -INFINITY;
            } else if (!tiles::visible(kpos, qpos[e >> 1], causal, window)) {
              x = xm = kNegInf;
            }
          }
          s[4 * j + e] = x;
          m_tile[e >> 1] = fmaxf(m_tile[e >> 1], xm);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 1));
        m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 2));
        // a processed tile holds a key below sk, so m_new is finite
        const float m_new = fmaxf(m_run[i], m_tile[i]);
        alpha[i] = ex2(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
      // p = 2^(s * scale_log2 - m) with one rounding (a fused multiply-add)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          const float m = m_run[e >> 1];
          const float p = (masked && x == kNegInf) ? ex2(kNegInf - m)
                                                   : ex2(fmaf(x, scale_log2, -m));
          s[4 * j + e] = p;
          l_run[e >> 1] += p;
        }
      if (!first) {  // before the first tile acc is zero
#pragma unroll
        for (int j = 0; j < kDP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
      }
      first = false;
    }

    if (more) cp_async_wait<2>(); else cp_async_wait<0>();  // V of this tile
    fence_proxy_async();
    __syncthreads();

    if (mine) {
      // P.V with P in bf16, or as three bf16 terms hi + mid + lo (P to
      // about 2^-24) for the rows with few keys (see kExactPKeys)
      uint32_t a[4][4];
      const int terms = exact ? 3 : 1;
      for (int term = 0; term < terms; ++term) {
        p_split(s, a);
        pv<kDP>(acc, a, k_s + L::kTile);
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }

  if (n_kv == 0) {  // no tile ran: the Q copies may still be landing
    cp_async_wait<0>();
    __syncthreads();
  }
  // the quad's partial row sums; the rows go through shared memory (this
  // warpgroup's Q rows, no longer read) and out as 16-byte stores, the
  // padding columns left behind
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // the rows' logsumexp for the backward, (B, Hq, Sq) float32, in natural
  // units: m_run is in log2 units (the scores were scaled by scale * log2 e),
  // except the finite mask kNegInf of a row that sees no key, kept as the
  // reference keeps it. A kv-head's packed rows are its q-heads' rows in
  // order, so row pr lies at (b * Hq + hk * group) * Sq + pr.
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = w0 + warp * 16 + lane / 4 + 8 * i;
      if (pr < rows_total) {
        const float m = m_run[i] == kNegInf ? kNegInf : m_run[i] * kLn2;
        lse[(static_cast<int64_t>(b) * gridDim.y + hk) * rows_total + pr] =
            m + logf(fmaxf(l_run[i], 1e-30f));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wg * kBM + warp * 16 + lane / 4 + 8 * i;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {  // the real columns' 8-column groups
      const uint32_t val = pack_bf16(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      const uint32_t dst = q_s + sw128_offset(row, j, kRows) + 4 * (lane % 4);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(val) : "memory");
    }
  }
  bar_sync_wg(wg);
  constexpr int kChunks = kDP / 8;
  constexpr int kStep = 128 / kChunks;  // rows a pass
  const int c = t % kChunks;
  bf16* ob = o + b * os.b + hk * group * os.h + c * 8;
#pragma unroll
  for (int k = 0; k < kBM / kStep; ++k) {
    const int r = t / kChunks + k * kStep;
    const int pr = w0 + r;
    if (pr >= rows_total || c >= D / 8) break;
    const int head = sq(pr);
    uint4 val;
    asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                 : "r"(q_s + sw128_offset(wg * kBM + r, c, kRows)));
    *reinterpret_cast<uint4*>(ob + head * os.h + (pr - head * sq.d) * os.s) = val;
  }
}

// One warpgroup, one tile, through the kernel's own loaders, descriptors
// and wgmma calls: S = Q.K^T (64 x 64) and O = bf16(S).V (64 x D), with
// q, k, v contiguous (64, D) bf16 and s, o float32. It pins the swizzle, the
// descriptors and the column padding of D = 48 and 96 against a plain
// matrix product on the card.
template <int D>
__global__ void __launch_bounds__(128)
flash_tc_selftest_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, float* __restrict__ s_out,
                         float* __restrict__ o_out) {
  using L = Cfg<D, 1>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const uint32_t base = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + L::kQ, v_s = k_s + L::kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Strides qs{0, 0, D};
  load_q_tile<D, kBM, 128>(q_s, q, qs, tiles::FastDiv(kBM), 0, kBM, tid);
  load_kv_tile<D, 128>(k_s, k, D, 0, kBK, tid);
  load_kv_tile<D, 128>(v_s, v, D, 0, kBK, tid);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  qk<D, kBM>(s, q_s, k_s, 0, false);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s_out[(warp * 16 + lane / 4 + 8 * (e >> 1)) * kBK + 8 * j + 2 * (lane % 4) + (e & 1)] =
          s[4 * j + e];
  float acc[L::kDP / 2];
#pragma unroll
  for (int i = 0; i < L::kDP / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
  p_split(s, a);
  pv<L::kDP>(acc, a, v_s);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o_out[(warp * 16 + lane / 4 + 8 * (e >> 1)) * D + 8 * j + 2 * (lane % 4) + (e & 1)] =
          acc[4 * j + e];
}

// The dynamic shared-memory limit, set once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

template <int D, int WG>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, float* lse,
                      const Strides* st,
                      int b, int hkv, int group, int sq, int sk, int causal, int window,
                      int q_offset, float scale, cudaStream_t stream) {
  using L = Cfg<D, WG>;
  static const cudaError_t attr = allow_smem(flash_tc_kernel<D, WG>, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int n_tiles = (group * sq + L::kRows - 1) / L::kRows;
  const dim3 grid(n_tiles, hkv, b);
  flash_tc_kernel<D, WG><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, st[0], st[1], st[2], st[3], group, tiles::FastDiv(sq), sk, causal,
      window, q_offset, scale * kLog2e, n_tiles);
  return cudaGetLastError();
}

// Two warpgroups a CTA unless that grid would leave more than half the SMs
// idle (the serving path's prompts): then one, for twice the CTAs.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st,
                   int b, int hq, int hkv, int sq, int sk, int causal, int window, int q_offset,
                   float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const long long ctas2 =
      static_cast<long long>((group * sq + 2 * kBM - 1) / (2 * kBM)) * hkv * b;
  if (2 * ctas2 < sm_count())
    return launch_wg<D, 1>(q, k, v, o, lse, st, b, hkv, group, sq, sk, causal, window, q_offset,
                           scale, stream);
  return launch_wg<D, 2>(q, k, v, o, lse, st, b, hkv, group, sq, sk, causal, window, q_offset,
                         scale, stream);
}

template <int D>
cudaError_t selftest(const void* q, const void* k, const void* v, float* s, float* o,
                     cudaStream_t stream) {
  using L = Cfg<D, 1>;
  static const cudaError_t attr = allow_smem(flash_tc_selftest_kernel<D>, L::kBytes);
  if (attr != cudaSuccess) return attr;
  flash_tc_selftest_kernel<D><<<1, 128, L::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), s,
      o);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

namespace f32tc {

using namespace hopper;

constexpr int kRows = 64;  // packed query rows a CTA: four warps of 16
constexpr int kThreads = 128;

// Keys a K/V tile: 64, or 32 at D >= 96, where two 64-key stages would
// leave room for one CTA an SM (D 96 and 128 take two at 32 keys; at D 256
// one CTA takes 206 KB).
template <int D>
__host__ __device__ constexpr int key_tile() {
  return D >= 96 ? 32 : 64;
}

// Shared memory, in floats: Q (64 rows), then two stages of K and V.
// Row strides: a warp reads Q and K rows as 16-byte vectors, rows g and
// g + 1 in each quarter-warp, so their stride is 16 words mod 32 (D 48's
// already is); it reads V as scalars, key 2t at column g in lane (g, t),
// so its stride is 4 words mod 16 (two V rows are 8 words mod 32 apart):
// no bank is read twice in either.
template <int D>
struct Smem {
  static constexpr int kBK = key_tile<D>();
  static constexpr int kLdQK = D % 32 == 0 ? D + 16 : D;
  static constexpr int kLdV = D + 4;
  static_assert(kLdQK % 32 == 16 && kLdV % 16 == 4, "bank-conflict-free strides");
  static constexpr int kQ = kRows * kLdQK;
  static constexpr int kK = kBK * kLdQK;
  static constexpr int kStage = kK + kBK * kLdV;
  static constexpr size_t kBytes = sizeof(float) * (kQ + 2 * kStage);
};

// x as TF32 hi and lo: hi = tf32(x), lo = x - hi with its low 13 bits
// left as they are: the tensor core reads a TF32 operand's sign, exponent
// and 10 high mantissa bits and drops the rest, so lo needs no rounding of
// its own (it is truncated there where `split` rounds it, a difference of
// at most 2^-22 of x)
__device__ __forceinline__ uint2 split_op(float x) {
  const uint32_t hi = tf32(x);
  return make_uint2(hi, __float_as_uint(x - __uint_as_float(hi)));
}
__device__ __forceinline__ void split_a(float a0, float a1, float a2, float a3, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint2 r = split_op(a[e]);
    hi[e] = r.x;
    lo[e] = r.y;
  }
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// ROWS rows of a (seq, D) operand from row `row0`, row r at src + r *
// stride, into shared rows of LD floats; rows at or past `n` are
// zero-filled. 16-byte copies when `vec` (pointers and strides 16-byte
// aligned), else 4-byte ones.
template <int D, int LD, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t stride, int row0,
                                          int n, bool vec, int tid) {
  const uint32_t base = smem_addr(dst);
  if (vec) {
    constexpr int kChunks = D / 4;
    static_assert(ROWS * kChunks % kThreads == 0, "whole passes");
#pragma unroll 4
    for (int k = 0; k < ROWS * kChunks / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const bool in = row0 + r < n;
      cp_async16(base + 4 * (r * LD + 4 * c), in ? src + (row0 + r) * stride + 4 * c : src, in);
    }
  } else {
    for (int i = tid; i < ROWS * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = row0 + r < n;
      cp_async4(base + 4 * (r * LD + c), in ? src + (row0 + r) * stride + c : src, in);
    }
  }
}

// The CTA's packed Q rows [r0, r0 + kRows) into shared rows of LD floats;
// rows at or past `rows_total` are zero-filled. Row r is q-head r / Sq,
// query r % Sq.
template <int D, int LD>
__device__ __forceinline__ void load_q(float* dst, const float* qb, Strides qs,
                                       const tiles::FastDiv& sq, int r0, int rows_total, bool vec,
                                       int tid) {
  const uint32_t base = smem_addr(dst);
  auto row = [&](int r) {  // packed row r0 + r, or null past the last
    const int pr = r0 + r;
    const int head = sq(pr);
    return pr < rows_total ? qb + head * qs.h + (pr - head * sq.d) * qs.s : nullptr;
  };
  if (vec) {
    constexpr int kChunks = D / 4;
#pragma unroll 2
    for (int k = 0; k < kRows * kChunks / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / kChunks, c = 4 * (i % kChunks);
      const float* p = row(r);
      cp_async16(base + 4 * (r * LD + c), p ? p + c : qb, p != nullptr);
    }
  } else {
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* p = row(r);
      cp_async4(base + 4 * (r * LD + c), p ? p + c : qb, p != nullptr);
    }
  }
}

// Warp w owns the CTA's packed rows 16w .. 16w + 15; lane (g, t) = (lane /
// 4, lane % 4) holds rows g and g + 8 of them, as the m16n8k8 fragments do.
template <int D>
__global__ void __launch_bounds__(kThreads, D >= 256 ? 1 : 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                 Strides qs, Strides ks, Strides vs, Strides os, int group, tiles::FastDiv sq,
                 int sk, int causal, int window, int q_offset, float scale_log2, int n_tiles,
                 int vec) {
  using L = Smem<D>;
  constexpr int kBK = L::kBK;
  constexpr int kNT = kBK / 8;              // n-tiles of S: 8 keys each
  constexpr int kDT = D / 8;                // n-tiles of O: 8 columns each
  constexpr int kSC = D >= 256 ? 2 : 4;     // S n-tiles a pass of Q.K^T
  constexpr int kC = kDT % 4 == 0 ? 4 : 2;  // O n-tiles a pass of P.V
  extern __shared__ __align__(16) float f32_smem[];
  float* const q_s = f32_smem;
  float* const kv_s = f32_smem + L::kQ;  // stage s: K at s * kStage, V at + kK

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tile = n_tiles - 1 - blockIdx.x;  // the longest causal tiles first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int rows_total = group * sq.d;
  const int r0 = tile * kRows;

  const float* qb = q + b * qs.b + hk * group * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  // the keys the CTA loads, and the keys this warp's rows may see
  const tiles::RowSpan cta_rows =
      tiles::packed_query_span(r0, min(r0 + kRows, rows_total), sq);
  const tiles::KeySpan cta_keys = tiles::key_span(cta_rows, sk, causal, window, q_offset, kBK);
  const int w0 = r0 + 16 * warp;
  const tiles::RowSpan w_rows = tiles::packed_query_span(w0, min(w0 + 16, rows_total), sq);
  const tiles::KeySpan w_keys = tiles::key_span(w_rows, sk, causal, window, q_offset, kBK);

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = w0 + g + 8 * i;
    qpos[i] = (pr < rows_total ? pr - sq(pr) * sq.d : 0) + q_offset;
  }

  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // log2 units
  float l_run[2] = {0.f, 0.f};
  bool first = true;  // no tile processed yet (warp-uniform)

  // cp.async groups: Q with K of tile 0, then V of tile 0, then K and V of
  // each next tile apart, so S = Q.K^T starts before V has arrived
  const int n_kv = (cta_keys.end - cta_keys.begin + kBK - 1) / kBK;
  load_q<D, L::kLdQK>(q_s, qb, qs, sq, r0, rows_total, vec, tid);
  if (n_kv > 0) load_rows<D, L::kLdQK, kBK>(kv_s, kb, ks.s, cta_keys.begin, sk, vec, tid);
  cp_async_commit();
  if (n_kv > 0) load_rows<D, L::kLdV, kBK>(kv_s + L::kK, vb, vs.s, cta_keys.begin, sk, vec, tid);
  cp_async_commit();

  const float* q_row = q_s + (16 * warp + g) * L::kLdQK + 4 * t;
  for (int it = 0; it < n_kv; ++it) {
    const int k0 = cta_keys.begin + it * kBK;
    const float* k_s = kv_s + (it & 1) * L::kStage;
    const float* v_s = k_s + L::kK;
    const bool more = it + 1 < n_kv;
    if (more) {
      float* nxt = kv_s + ((it + 1) & 1) * L::kStage;
      load_rows<D, L::kLdQK, kBK>(nxt, kb, ks.s, k0 + kBK, sk, vec, tid);
      cp_async_commit();
      load_rows<D, L::kLdV, kBK>(nxt + L::kK, vb, vs.s, k0 + kBK, sk, vec, tid);
      cp_async_commit();
    }
    // K of this tile (V of this tile and the next tile may fly)
    if (more) cp_async_wait<3>(); else cp_async_wait<1>();
    __syncthreads();

    const bool mine = k0 < w_keys.end && k0 + kBK > w_keys.begin;  // warp-uniform
    float s[kNT][4];
    if (mine) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      // S = Q.K^T, 16 columns of D a pass as two k-steps of 8. Within a
      // pass lane t reads columns 4t .. 4t + 3 of its rows as one vector:
      // k-step 0 takes columns 4t and 4t + 1 as its k = t and t + 4, k-step
      // 1 columns 4t + 2 and 4t + 3 (the order of the reduction is free, as
      // long as both operands keep the same one). Each pass sums into a
      // zeroed block, the four small products first and the two large ones
      // last, and the block is added to S in f32: the tensor core rounds
      // its sums toward zero, and a block's sum is a quarter of a row's
      // (sqrt of 16 columns of D 256), so S keeps the float32 accuracy that
      // the logsumexp (and the backward through it) needs
#pragma unroll
      for (int dg = 0; dg < D / 16; ++dg) {
        const float4 qa = *reinterpret_cast<const float4*>(q_row + 16 * dg);
        const float4 qc = *reinterpret_cast<const float4*>(q_row + 8 * L::kLdQK + 16 * dg);
        uint32_t ah[2][4], al[2][4];
        split_a(qa.x, qc.x, qa.y, qc.y, ah[0], al[0]);
        split_a(qa.z, qc.z, qa.w, qc.w, ah[1], al[1]);
#pragma unroll
        for (int n0 = 0; n0 < kNT; n0 += kSC) {
          uint2 b0[2][kSC], b1[2][kSC];
#pragma unroll
          for (int c = 0; c < kSC; ++c) {
            const float4 kv = *reinterpret_cast<const float4*>(
                k_s + (8 * (n0 + c) + g) * L::kLdQK + 16 * dg + 4 * t);
            b0[0][c] = split_op(kv.x);
            b1[0][c] = split_op(kv.y);
            b0[1][c] = split_op(kv.z);
            b1[1][c] = split_op(kv.w);
          }
          float blk[kSC][4];
#pragma unroll
          for (int c = 0; c < kSC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) blk[c][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
            for (int c = 0; c < kSC; ++c) mma_tf32(blk[c], al[ks], b0[ks][c].x, b1[ks][c].x);
#pragma unroll
            for (int c = 0; c < kSC; ++c) mma_tf32(blk[c], ah[ks], b0[ks][c].y, b1[ks][c].y);
          }
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int c = 0; c < kSC; ++c) mma_tf32(blk[c], ah[ks], b0[ks][c].x, b1[ks][c].x);
#pragma unroll
          for (int c = 0; c < kSC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n0 + c][e] += blk[c][e];
        }
      }

      // s stays raw (Q.K^T); a key a row may not see holds the finite mask
      // kNegInf (its weight is exp(kNegInf - m), the reference's), a key past
      // sk holds -inf (no weight at all)
      const bool masked = tiles::tile_needs_mask(k0, kBK, w_rows, sk, causal, window, q_offset);
      float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e];
          float xm = x * scale_log2;
          if (masked) {
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            if (kpos >= sk) {
              x = xm = -INFINITY;
            } else if (!tiles::visible(kpos, qpos[e >> 1], causal, window)) {
              x = xm = kNegInf;
            }
          }
          s[j][e] = x;
          m_tile[e >> 1] = fmaxf(m_tile[e >> 1], xm);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 1));
        m_tile[i] = fmaxf(m_tile[i], __shfl_xor_sync(0xffffffffu, m_tile[i], 2));
        // a processed tile holds a key below sk, so m_new is finite
        const float m_new = fmaxf(m_run[i], m_tile[i]);
        alpha[i] = tc::ex2(m_run[i] - m_new);
        m_run[i] = m_new;
        l_run[i] *= alpha[i];
      }
      // p = 2^(s * scale_log2 - m) with one rounding (a fused multiply-add)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float m = m_run[e >> 1];
          const float p = (masked && x == kNegInf) ? tc::ex2(kNegInf - m)
                                                   : tc::ex2(fmaf(x, scale_log2, -m));
          s[j][e] = p;
          l_run[e >> 1] += p;
        }
      if (!first) {  // before the first tile acc is zero
#pragma unroll
        for (int n = 0; n < kDT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      }
      first = false;
    }

    if (more) cp_async_wait<2>(); else cp_async_wait<0>();  // V of this tile
    __syncthreads();

    if (mine) {
      // O += P.V, a k-step of 8 keys at a time. The accumulator of S holds
      // keys 2t and 2t + 1 of each 8 in lane t, which serve as the A
      // fragment's k = t and t + 4 where they lie; V's rows follow: b0 is
      // key 2t, b1 key 2t + 1, at column g of each n-tile
#pragma unroll
      for (int kk = 0; kk < kNT; ++kk) {
        uint32_t ah[4], al[4];
        split_a(s[kk][0], s[kk][2], s[kk][1], s[kk][3], ah, al);
        const float* v_row = v_s + (8 * kk + 2 * t) * L::kLdV + g;
#pragma unroll
        for (int n0 = 0; n0 < kDT; n0 += kC) {
          uint2 b0[kC], b1[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            b0[c] = split_op(v_row[8 * (n0 + c)]);
            b1[c] = split_op(v_row[L::kLdV + 8 * (n0 + c)]);
          }
          mma3<kC>(acc, ah, al, b0, b1, n0);
        }
      }
    }
    __syncthreads();  // the stage is consumed before it is refilled
  }
  if (n_kv == 0) cp_async_wait<0>();  // no tile ran: the Q copies may still be landing

  // the quad's partial row sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  // the rows' logsumexp for the backward, as the bf16 kernel writes it
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pr = w0 + g + 8 * i;
      if (pr < rows_total) {
        const float m = m_run[i] == kNegInf ? kNegInf : m_run[i] * tc::kLn2;
        lse[(static_cast<int64_t>(b) * gridDim.y + hk) * rows_total + pr] =
            m + logf(fmaxf(l_run[i], 1e-30f));
      }
    }
  }
  // lane t writes columns 2t and 2t + 1 of each n-tile of its two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int pr = w0 + g + 8 * i;
    if (pr >= rows_total) continue;
    const int head = sq(pr);
    float* orow = o + b * os.b + (hk * group + head) * os.h + (pr - head * sq.d) * os.s + 2 * t;
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const float x = acc[n][2 * i] / denom, y = acc[n][2 * i + 1] / denom;
      if (vec) {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x, y);
      } else {
        orow[8 * n] = x;
        orow[8 * n + 1] = y;
      }
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Strides* st, int b, int hq, int hkv, int sq, int sk, int causal,
                   int window, int q_offset, float scale, bool vec, cudaStream_t stream) {
  using L = Smem<D>;
  static const cudaError_t attr = tc::allow_smem(flash_f32_kernel<D>, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int group = hq / hkv;
  const int n_tiles = (group * sq + kRows - 1) / kRows;
  const dim3 grid(n_tiles, hkv, b);
  flash_f32_kernel<D><<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, st[0], st[1], st[2], st[3], group, tiles::FastDiv(sq), sk,
      causal, window, q_offset, scale * tc::kLog2e, n_tiles, vec ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace f32tc

cudaError_t dispatch_f32(int d, const void* q, const void* k, const void* v, void* o,
                         float* lse, const Strides* st, int b, int hq, int hkv, int sq, int sk, int causal,
                         int window, int q_offset, float scale, bool vec, cudaStream_t stream) {
  switch (d) {
    case 48:
      return f32tc::launch<48>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, stream);
    case 64:
      return f32tc::launch<64>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, stream);
    case 96:
      return f32tc::launch<96>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, stream);
    case 128:
      return f32tc::launch<128>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, stream);
    case 256:
      return f32tc::launch<256>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v, void* o,
                          float* lse, const Strides* st, int b, int hq, int hkv, int sq, int sk, int causal,
                          int window, int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 48:
      return tc::launch<48>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 64:
      return tc::launch<64>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 96:
      return tc::launch<96>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 128:
      return tc::launch<128>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 256:
      return tc::launch<256>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn.
// dtype: 0 float32 (3xTF32 mma.sync kernel; 16-byte copies where the
// pointers and strides allow, else 4-byte ones), 1 bfloat16 (wgmma kernel;
// the pointers and the strides must be 16-byte aligned). lse: null, or a
// contiguous (b, hq, sq) float32 buffer that takes each row's logsumexp of
// scale * q.k (natural log), which the backward reads. Returns the launch's
// cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, void* lse, const int64_t* strides, int b,
                                     int hq, int hkv, int sq, int sk, int d,
                                     int causal, int window, int q_offset,
                                     float scale, int dtype, void* stream) {
  using repro::Strides;
  if (hkv <= 0 || hq % hkv != 0 || sq <= 0 || sk <= 0) return (int)cudaErrorInvalidValue;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0) {
    // 16-byte copies where every pointer and every stride of an axis
    // longer than one allow them, else 4-byte ones
    const int64_t sizes[12] = {b, hq, sq, b, hkv, sk, b, hkv, sk, b, hq, sq};
    auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    bool vec = aligned(q) && aligned(k) && aligned(v) && aligned(o);
    for (int i = 0; i < 12; ++i) vec = vec && (sizes[i] <= 1 || strides[i] % 4 == 0);
    return (int)repro::dispatch_f32(d, q, k, v, o, lse_f, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, vec, s);
  }
  if (dtype == 1)
    return (int)repro::dispatch_bf16(d, q, k, v, o, lse_f, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core path's one-tile self-test: q, k, v (64, d) contiguous
// bf16; s (64, 64) and o (64, d) float32. Returns the launch's cudaError_t.
extern "C" int repro_flash_selftest(const void* q, const void* k, const void* v, void* s,
                                    void* o, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sf = static_cast<float*>(s);
  float* of = static_cast<float*>(o);
  switch (d) {
    case 48: return (int)repro::tc::selftest<48>(q, k, v, sf, of, st);
    case 64: return (int)repro::tc::selftest<64>(q, k, v, sf, of, st);
    case 96: return (int)repro::tc::selftest<96>(q, k, v, sf, of, st);
    case 128: return (int)repro::tc::selftest<128>(q, k, v, sf, of, st);
    case 256: return (int)repro::tc::selftest<256>(q, k, v, sf, of, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
