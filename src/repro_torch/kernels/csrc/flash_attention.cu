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
// float32: `flash_fwd_kernel`, products on the CUDA cores in f32, which
// keeps the f32 contract of 2e-5 (TF32 tensor cores would not). One CTA
// owns (batch, q-head, 16-row query tile) and walks the KV tiles in a loop,
// with the same tile skipping and ragged-edge masks; Q in f32 and K/V in
// dynamic shared memory, rows padded one 32-bit word against bank
// conflicts.
#include "common.cuh"
#include "flash_tiles.cuh"
#include "wgmma.cuh"

namespace repro {
namespace {

constexpr int kBQ = 16;                      // query rows per CTA
constexpr int kBK = 64;                      // keys per KV tile
constexpr int kThreads = 128;
constexpr int kRowThreads = kThreads / kBQ;  // 8 consecutive lanes share a row

template <typename T, int D>
struct FlashSmem {
  static constexpr int kPad = 4 / sizeof(T);  // one 32-bit word per row
  static constexpr int kQStride = D + 1;
  static constexpr int kKVStride = D + kPad;
  static constexpr int kPStride = kBK + 1;
  static constexpr size_t kBytes = sizeof(float) * kBQ * kQStride
                                   + 2 * sizeof(T) * kBK * kKVStride
                                   + sizeof(float) * kBQ * kPStride;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, Strides qs,
                 Strides ks, Strides vs, Strides os, int group, int sq, int sk,
                 int causal, int window, int q_offset, float scale) {
  using L = FlashSmem<T, D>;
  constexpr int kCols = D / kRowThreads;    // output columns per thread
  constexpr int kKeys = kBK / kRowThreads;  // scores per thread per tile

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  T* k_s = reinterpret_cast<T*>(q_s + kBQ * L::kQStride);
  T* v_s = k_s + kBK * L::kKVStride;
  float* p_s = reinterpret_cast<float*>(v_s + kBK * L::kKVStride);

  const int tid = threadIdx.x;
  const int row = tid / kRowThreads;
  const int sub = tid % kRowThreads;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r * L::kQStride + c] =
        (q0 + r < sq) ? to_f32(qb[(q0 + r) * qs.s + c]) : 0.f;
  }

  // the keys that some row of this tile may see; whole tiles outside are
  // skipped, which changes nothing because each causal row keeps its own key
  const int q_last = min(q0 + kBQ, sq) - 1;
  int k_begin = 0;
  int k_end = sk;
  if (causal) k_end = min(sk, q_last + q_offset + 1);
  if (window > 0) k_begin = max(0, q0 + q_offset - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  const int qpos = q0 + row + q_offset;
  float m_run = kNegInf;
  float l_run = 0.f;
  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed; q_s is visible
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < sk;
      k_s[r * L::kKVStride + c] = in ? kb[(k0 + r) * ks.s + c] : from_f32<T>(0.f);
      v_s[r * L::kKVStride + c] = in ? vb[(k0 + r) * vs.s + c] : from_f32<T>(0.f);
    }
    __syncthreads();

    // scores of this thread's keys sub, sub+8, ... against its query row
    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) s[j] = 0.f;
    const float* qrow = q_s + row * L::kQStride;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        s[j] += qd * to_f32(k_s[(sub + j * kRowThreads) * L::kKVStride + d]);
    }

    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const int kpos = k0 + sub + j * kRowThreads;
      const bool seen = (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
      // keys past the end do not exist: they get no weight at all
      s[j] = (kpos >= sk) ? -INFINITY : (seen ? s[j] * scale : kNegInf);
      m_tile = fmaxf(m_tile, s[j]);
    }
#pragma unroll
    for (int off = kRowThreads / 2; off > 0; off >>= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, off));
    const float m_new = fmaxf(m_run, m_tile);
    const float alpha = expf(m_run - m_new);

    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      const float p = expf(s[j] - m_new);
      l_tile += p;
      p_s[row * L::kPStride + sub + j * kRowThreads] = p;
    }
#pragma unroll
    for (int off = kRowThreads / 2; off > 0; off >>= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, off);
    l_run = l_run * alpha + l_tile;
    m_run = m_new;
    __syncwarp();  // a row's probabilities are written and read by one warp

#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] *= alpha;
    const float* prow = p_s + row * L::kPStride;
    for (int c = 0; c < kBK; ++c) {
      const float p = prow[c];
      const T* vrow = v_s + c * L::kKVStride + sub;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[j] += p * to_f32(vrow[j * kRowThreads]);
    }
  }

  if (q0 + row < sq) {
    const float denom = fmaxf(l_run, 1e-30f);
    T* orow = ob + (q0 + row) * os.s + sub;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[j * kRowThreads] = from_f32<T>(acc[j] / denom);
    // the row's logsumexp, for the backward: (B, Hq, Sq) float32
    if (lse != nullptr && sub == 0)
      lse[(static_cast<int64_t>(b) * gridDim.y + h) * sq + q0 + row] = m_run + logf(denom);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         float* lse, const Strides* st, int b, int hq, int hkv, int sq,
                         int sk, int causal, int window, int q_offset,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<T, D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, st[0], st[1], st[2], st[3], hq / hkv, sq, sk, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

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

cudaError_t dispatch_f32(int d, const void* q, const void* k, const void* v, void* o,
                         float* lse, const Strides* st, int b, int hq, int hkv, int sq, int sk, int causal,
                         int window, int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 48:
      return launch_flash<float, 48>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 64:
      return launch_flash<float, 64>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 96:
      return launch_flash<float, 96>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 128:
      return launch_flash<float, 128>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 256:
      return launch_flash<float, 256>(q, k, v, o, lse, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
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
// dtype: 0 float32 (CUDA-core kernel), 1 bfloat16 (tensor-core kernel; the
// pointers and the strides must be 16-byte aligned). lse: null, or a
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
  if (dtype == 0)
    return (int)repro::dispatch_f32(d, q, k, v, o, lse_f, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, s);
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
