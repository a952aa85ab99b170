// Mamba-2 SSD diagonal block, for Hopper: both products on the tensor
// cores in float32 accuracy (3xTF32), C.B^T once a chunk.
//
// Replaces the Pallas kernel `_ssd_diag_kernel` of
// src/repro/kernels/ssd_diag.py (`ssd_diag`): for every chunk of Q rows of
// the sequence and every head h,
//   Y[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j,
//   cum  = cumsum over the chunk of dt * A[h],
// in float32 (x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N), Y (B,S,H,P)).
//
// What bounds it on an H100: the bytes of x and y. The function's
// operations are Q(Q+1)/2 * 2(N + H P) a chunk (C.B^T has no head index:
// one group), about 65 per byte of x and y at Q = 256, N = 128, P = 64,
// H = 80: under the 148 TF32 tensor-core operations a byte, far above the
// 20 float32 ones a byte outside the tensor cores.
//
// Design, two launches on the stream:
// 1. `ssd_scores_kernel`: one CTA per 64 x 16 block of a causal 64 x 64
//    tile pair (q-tile, k-tile <= q-tile) of a chunk computes that block of
//    C.B^T into a float32 workspace (160 KB a chunk at Q = 256, kept in the
//    50 MB L2), so the scores are computed once a chunk, not once a head as
//    in the Pallas kernel; it stores them in the order of the apply
//    kernel's A fragments, so that a warp reads its fragment as one 16-byte
//    load a lane. Further CTAs of the same launch each take 32 heads of a
//    chunk and form cum: the chunk's dt column block comes into shared
//    memory in one round of copies, one thread per head sums its column
//    sequentially in place, round(dt * A) added in the reference's order,
//    and the block goes to the workspace by coalesced stores.
// 2. `ssd_apply_kernel`: one CTA, one warpgroup, per (q-tile, head, chunk,
//    batch), the longest q-tiles (those that visit the most k-tiles)
//    launched first. It streams the 64 x P tiles of x through a two-stage
//    ring of 16-byte cp.async copies; each tile is turned once, by the whole
//    CTA, into dt x split into hi and lo parts laid out as wgmma's K-major B
//    operand (the 128-byte swizzle). Each thread forms its own elements of
//    W = S * exp(cum_i - cum_j) (j <= i) in registers from the score
//    fragments it reads from L2 (the register layout of wgmma's A operand),
//    and the warpgroup accumulates W . (dt x) with wgmma.mma_async
//    m64nNk8, A from registers, while it forms the next key step's W. Key
//    steps past the rows of a short chunk are skipped.
// C.B^T runs as mma.sync m16n8k8 TF32, W . (dt x) as wgmma TF32, both with
// float32 accumulation. A single TF32 product keeps ~11 bits; each float32
// operand is split into hi = tf32(a) and lo = tf32(a - hi) and the
// accumulator takes lo.hi + hi.lo + hi.hi (`tf32.cuh`), which keeps about
// 21 bits a product, as float32 does to within the checks' 2e-5. In the
// scores the three terms are issued term by term across the n-tiles, so
// that no product waits on the one before it. Shared-memory rows are padded or
// swizzled so that a warp's reads and writes fall in distinct banks.
#include "common.cuh"
#include "tf32.cuh"
#include "wgmma.cuh"

namespace repro {
namespace {

constexpr int kT = 64;          // rows of a q-tile and of a k-tile
constexpr int kKeys = 16;       // keys of a scores CTA's block
constexpr int kBlocks = kT / kKeys;  // scores CTAs a tile pair
constexpr int kThreads = 128;   // four warps: warp w owns tile rows 16w..16w+15
constexpr int kCumHeads = 32;   // heads a cum CTA sums, one thread each
constexpr int kSmemMax = 232448;

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }
// padded rows: C/B tiles (N + 4 with N a multiple of 8: rows 4 words apart
// mod 32, an odd number of 4-word groups) and the raw x tiles (16-byte rows)
__host__ __device__ constexpr int ld_state(int n) { return round_up(n, 8) + 4; }
__host__ __device__ constexpr int ld_x(int p) { return round_up(p, 4); }

__host__ __device__ inline int n_qtiles(int chunk) { return (chunk + kT - 1) / kT; }
__host__ __device__ inline int n_pairs(int chunk) {
  const int q = n_qtiles(chunk);
  return q * (q + 1) / 2;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of `cols` floats, row r at src + r * stride, into dst rows of
// `ld` floats; rows at or past `valid` are zero-filled, and so are columns
// [cols, pad) by plain stores. 16-byte copies when `vec` (cols a multiple
// of 4, src and stride 16-byte aligned), else 4-byte ones.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, int64_t stride,
                                          int rows, int valid, int cols, int pad, bool vec) {
  // (row, copy) of this thread's first copy, stepped by kThreads copies
  // without a division a copy
  const int per_row = vec ? cols / 4 : cols, width = vec ? 4 : 1;
  const int dr = kThreads / per_row, dc = kThreads % per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x % per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      ++r;
      if (r >= rows) break;
    }
    const bool in = r < valid;
    float* d = dst + r * ld + c * width;
    const float* from = in ? src + r * stride + c * width : src;
    if (vec)
      cp_async16(d, from, in);
    else
      cp_async4(d, from, in);
  }
  const int extra = pad - cols;
  for (int e = threadIdx.x; e < rows * extra; e += kThreads) {
    const int r = e / extra;
    dst[r * ld + cols + (e - r * extra)] = 0.f;
  }
}

// Where element (r, c) of a 64 x 64 score tile lies in the workspace: in
// the apply kernel's A fragments, so that the lane (g, t) = (r % 8, c % 4)
// of warp r / 16 finds its four values of key step c / 8 in one float4:
// rows r and r + 8 of columns c and c + 4.
__device__ __forceinline__ int frag_index(int r, int c) {
  const int w = r >> 4, g = r & 7, rh = (r >> 3) & 1;
  const int ks = c >> 3, t = c & 3, ch = (c >> 2) & 1;
  return (((w * 8 + ks) * 32 + g * 4 + t) << 2) + rh + 2 * ch;
}

// Workspace layout (floats): the score tiles, scores[b][chunk][pair][64 * 64]
// with pair = qt (qt + 1) / 2 + kt for kt <= qt, each in `frag_index` order,
// then cum[b][s][h].
__host__ __device__ inline int64_t score_floats(int b, int s, int chunk) {
  return static_cast<int64_t>(b) * (s / chunk) * n_pairs(chunk) * kT * kT;
}

__host__ inline size_t scores_smem(int n, int chunk) {
  const size_t tiles = static_cast<size_t>(kT + kKeys) * ld_state(n);
  const size_t cum = static_cast<size_t>(chunk) * kCumHeads;
  return (tiles > cum ? tiles : cum) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                  const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ scores, float* __restrict__ cum, int s_len, int h, int n,
                  int chunk, int vec, int vec_dt) {
  extern __shared__ __align__(16) float smem[];
  const int pairs = n_pairs(chunk);
  const int ck = blockIdx.y, bb = blockIdx.z;
  const int64_t row0 = static_cast<int64_t>(bb) * s_len + static_cast<int64_t>(ck) * chunk;

  if (static_cast<int>(blockIdx.x) >= pairs * kBlocks) {
    // cum of heads h0 .. h0 + 31: the chunk's dt block comes in by one round
    // of copies (16-byte ones when `vec_dt`), one thread a head sums its
    // column in place in the reference's order, and the block goes out by
    // coalesced stores
    const int h0 = (blockIdx.x - pairs * kBlocks) * kCumHeads;
    const int nh = min(kCumHeads, h - h0);
    const float* dt0 = dt + row0 * h + h0;
    load_rows(smem, kCumHeads, dt0, h, chunk, chunk, nh, nh, vec_dt);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (threadIdx.x < nh) {
      const int c = threadIdx.x;
      const float a = A[h0 + c];
      float run = 0.f;
      // whole batches of 16 rows without a guard a row (their loads in
      // flight together), then the rows past the last whole batch; the sum
      // itself stays sequential
      constexpr int kBatch = 16;
      const int whole = chunk / kBatch * kBatch;
      float* col = smem + c;
      for (int j0 = 0; j0 < whole; j0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) v[u] = __fmul_rn(col[(j0 + u) * kCumHeads], a);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          run = __fadd_rn(run, v[u]);
          col[(j0 + u) * kCumHeads] = run;
        }
      }
      for (int j = whole; j < chunk; ++j) {
        run = __fadd_rn(run, __fmul_rn(col[j * kCumHeads], a));
        col[j * kCumHeads] = run;
      }
    }
    __syncthreads();
    // row j of the block to cum[row0 + j][h0 ..]: warp w takes rows w, w + 4, ...
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float* out = cum + row0 * h + h0 + lane;
    if (lane < nh) {
#pragma unroll 8
      for (int j = warp; j < chunk; j += kThreads / 32)
        out[static_cast<int64_t>(j) * h] = smem[j * kCumHeads + lane];
    }
    return;
  }

  // block kq (keys 16 kq .. 16 kq + 15) of the tile pair (qt, kt):
  // S[i][j] = C[i0 + i] . B[j0 + j]
  const int pair = blockIdx.x / kBlocks, kq = blockIdx.x % kBlocks;
  int qt = 0;
  while ((qt + 1) * (qt + 2) / 2 <= pair) ++qt;
  const int kt = pair - qt * (qt + 1) / 2;
  const int i0 = qt * kT, j0 = kt * kT + kq * kKeys;
  const int ld = ld_state(n), n8 = round_up(n, 8);
  float* c_s = smem;
  float* b_s = smem + kT * ld;
  load_rows(c_s, ld, Cm + (row0 + i0) * n, n, kT, chunk - i0, n, n8, vec);
  // a block past a short chunk reads nothing: its rows are zero-filled
  load_rows(b_s, ld, Bm + (row0 + min(j0, chunk - 1)) * n, n, kKeys, chunk - j0, n, n8, vec);
  cp_commit();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  float acc[2][4] = {};
  // rows past the chunk, and on the diagonal tile rows before the block's
  // keys, see none of them: those stay zero
  const bool live = i0 + 16 * warp < chunk && j0 < chunk && (kt < qt || kq <= warp);
  cp_wait<0>();
  __syncthreads();
  if (live) {
#pragma unroll 4
    for (int ks = 0; ks < n8 / 8; ++ks) {
      const int c0 = 8 * ks + t;
      const float a[4] = {c_s[r0 * ld + c0], c_s[(r0 + 8) * ld + c0], c_s[r0 * ld + c0 + 4],
                          c_s[(r0 + 8) * ld + c0 + 4]};
      uint32_t ah[4], al[4];
      split4(a, ah, al);
      uint2 b0[2], b1[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* brow = b_s + (8 * nt + g) * ld + c0;
        b0[nt] = split2(brow[0]);
        b1[nt] = split2(brow[4]);
      }
      mma3<2>(acc, ah, al, b0, b1);
    }
  }
  float* out = scores + ((static_cast<int64_t>(bb) * (s_len / chunk) + ck) * pairs + pair) * kT * kT;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const int col = kq * kKeys + 8 * nt + 2 * t;
    out[frag_index(r0, col)] = acc[nt][0];
    out[frag_index(r0, col + 1)] = acc[nt][1];
    out[frag_index(r0 + 8, col)] = acc[nt][2];
    out[frag_index(r0 + 8, col + 1)] = acc[nt][3];
  }
}

// d (64 x 64) += a (64 x 8, registers) . b (8 x 64, shared, K-major), TF32 in,
// f32 out
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31} "
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// d (64 x 128) += a (64 x 8, registers) . b (8 x 128, shared, K-major), TF32 in,
// f32 out
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63} "
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The apply kernel's shared memory, in bytes from a 1024-byte aligned base:
// the hi and lo parts of dt x in the 128-byte swizzle, K-major (row n of N
// columns holds its 64 keys, 32 to a 128-byte block), which is how wgmma
// takes a tf32 B operand; then the two raw x stages and cum and dt.
struct ApplySmem {
  int ldx;
  uint32_t hi, lo, x, cum, dt, total;
  __host__ __device__ ApplySmem(int n_cols, int p, int chunk) {
    ldx = ld_x(p);
    hi = 0;
    lo = hi + n_cols * kT * 4;
    x = lo + n_cols * kT * 4;
    cum = x + 2 * kT * ldx * 4;
    dt = cum + chunk * 4;
    total = dt + chunk * 4 + 1024;  // + the base's alignment
  }
};

// NT: n-tiles of 8 output columns, P <= 8 NT; a CTA is one warpgroup, and
// its accumulators are the wgmma's 64 x 8 NT tile
template <int NT>
__global__ void __launch_bounds__(kThreads)
ssd_apply_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ scores, const float* __restrict__ cum,
                 float* __restrict__ y, int batch, int s_len, int h, int p, int chunk, int vec) {
  constexpr int N = 8 * NT;
  extern __shared__ __align__(16) unsigned char apply_smem[];
  const ApplySmem lay(N, p, chunk);
  const uint32_t base = (hopper::smem_addr(apply_smem) + 1023u) & ~1023u;
  unsigned char* const sm = apply_smem + (base - hopper::smem_addr(apply_smem));
  float* cum_s = reinterpret_cast<float*>(sm + lay.cum);
  float* dt_s = reinterpret_cast<float*>(sm + lay.dt);

  const int n_chunks = s_len / chunk;
  const int nq = n_qtiles(chunk);
  const int per = h * n_chunks * batch;
  const int qt = nq - 1 - static_cast<int>(blockIdx.x) / per;  // longest first
  const int rest = blockIdx.x % per;
  const int hh = rest % h;
  const int ck = (rest / h) % n_chunks;
  const int bb = rest / h / n_chunks;
  const int64_t row0 = static_cast<int64_t>(bb) * s_len + static_cast<int64_t>(ck) * chunk;
  const int i0 = qt * kT;
  const int i_end = min(chunk, i0 + kT);
  const float* s_base =
      scores + ((static_cast<int64_t>(bb) * n_chunks + ck) * n_pairs(chunk) + qt * (qt + 1) / 2) *
                   kT * kT;
  const float* x_base = x + (row0 * h + hh) * p;
  const int64_t x_stride = static_cast<int64_t>(h) * p;

  // stage kt & 1: x rows kt * 64 .. kt * 64 + 63
  auto x_stage = [&](int kt) { return reinterpret_cast<float*>(sm + lay.x) + (kt & 1) * kT * lay.ldx; };
  auto load_x = [&](int kt) {
    load_rows(x_stage(kt), lay.ldx, x_base + kt * kT * x_stride, x_stride, kT,
              min(kT, chunk - kt * kT), p, p, vec);
    cp_commit();
  };
  // this head's cum and dt down the chunk's rows: copies in the first group
  for (int j = threadIdx.x; j < i_end; j += kThreads) {
    cp_async4(cum_s + j, cum + (row0 + j) * h + hh, true);
    cp_async4(dt_s + j, dt + (row0 + j) * h + hh, true);
  }
  load_x(0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;  // tile rows r0 and r0 + 8
  const int i_a = i0 + r0, i_b = i_a + 8;
  const bool ok_a = i_a < i_end, ok_b = i_b < i_end;
  float acc[4 * NT];
#pragma unroll
  for (int e = 0; e < 4 * NT; ++e) acc[e] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int j0 = kt * kT;
    // key steps that some row sees: none past the rows of a short chunk
    const int ks_end = min(8, (i_end - j0 + 7) / 8);
    // this thread's score fragments, in flight while the x tile is split
    const float4* s_frag =
        reinterpret_cast<const float4*>(s_base + static_cast<int64_t>(kt) * kT * kT) +
        warp * 8 * 32 + lane;
    float4 sv[8];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks)
      if (ks < ks_end) sv[ks] = __ldg(s_frag + ks * 32);
    if (kt < qt) {
      load_x(kt + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // x stage kt (and at kt 0 cum and dt) are in; the last wgmma is done
    {
      // dt x of keys 4 kq .. 4 kq + 3 and column n, split, as one 16-byte
      // piece of row n in each of hi and lo; consecutive lanes take
      // consecutive columns, so the reads and the swizzled writes are free
      // of bank conflicts. Columns past P are zeros.
      const float* x_s = x_stage(kt);
#pragma unroll
      for (int m = 0; m < N * (kT / 4) / kThreads; ++m) {
        const int item = threadIdx.x + m * kThreads;
        const int n = item % N, kq = item / N;
        uint4 hi4 = make_uint4(0, 0, 0, 0), lo4 = make_uint4(0, 0, 0, 0);
        if (n < p) {
          uint32_t hv[4], lv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // keys past the rows: their W is 0; dt is clamped to a loaded one
            const int r = 4 * kq + e;
            split(__fmul_rn(dt_s[min(j0 + r, i_end - 1)], x_s[r * lay.ldx + n]), hv[e], lv[e]);
          }
          hi4 = make_uint4(hv[0], hv[1], hv[2], hv[3]);
          lo4 = make_uint4(lv[0], lv[1], lv[2], lv[3]);
        }
        const uint32_t off = hopper::sw128_offset(n, kq, N);
        *reinterpret_cast<uint4*>(sm + lay.hi + off) = hi4;
        *reinterpret_cast<uint4*>(sm + lay.lo + off) = lo4;
      }
    }
    hopper::fence_proxy_async();  // the stores above, to wgmma's reads
    __syncthreads();  // the hi and lo parts are in

    const float cum_a = ok_a ? cum_s[i_a] : 0.f;
    const float cum_b = ok_b ? cum_s[i_b] : 0.f;
    // W at rows (r0, r0 + 8) x keys (c0, c0 + 4) of key step ks: the A
    // fragment, split into hi and lo
    auto make_w = [&](int ks, uint32_t (&wh)[4], uint32_t (&wl)[4]) {
      const int ja = j0 + 8 * ks + t, jb = ja + 4;
      const float cja = cum_s[min(ja, i_end - 1)], cjb = cum_s[min(jb, i_end - 1)];
      const float w[4] = {
          ok_a && ja <= i_a ? sv[ks].x * expf(cum_a - cja) : 0.f,
          ok_b && ja <= i_b ? sv[ks].y * expf(cum_b - cja) : 0.f,
          ok_a && jb <= i_a ? sv[ks].z * expf(cum_a - cjb) : 0.f,
          ok_b && jb <= i_b ? sv[ks].w * expf(cum_b - cjb) : 0.f};
      split4(w, wh, wl);
    };
    // B of key step ks: keys 8 ks .. 8 ks + 7 are 32 bytes of every row
    auto desc = [&](uint32_t part, int ks) {
      return hopper::sw128_desc(base + part + (ks >> 2) * N * 128 + (ks & 3) * 32, 16, 1024);
    };
    uint32_t wh[2][4], wl[2][4];
    if (ks_end > 0) make_w(0, wh[0], wl[0]);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if (ks >= ks_end) break;
      const int cur = ks & 1;
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
      wgmma_tf32(acc, wl[cur], desc(lay.hi, ks));
      wgmma_tf32(acc, wh[cur], desc(lay.lo, ks));
      wgmma_tf32(acc, wh[cur], desc(lay.hi, ks));
      hopper::wgmma_commit();
      // the next step's W while the tensor cores work on this one
      if (ks + 1 < ks_end) make_w(ks + 1, wh[cur ^ 1], wl[cur ^ 1]);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      // this step's W registers stay unchanged until its wgmma is done
      asm volatile("" ::"r"(wh[cur][0]), "r"(wh[cur][1]), "r"(wh[cur][2]), "r"(wh[cur][3]),
                   "r"(wl[cur][0]), "r"(wl[cur][1]), "r"(wl[cur][2]), "r"(wl[cur][3]));
    }
  }

  float* y_base = y + (row0 * h + hh) * p;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = half ? i_b : i_a;
      if (i >= i_end) continue;
      float* dst = y_base + static_cast<int64_t>(i) * x_stride + col;
      if (col < p) dst[0] = acc[4 * nt + 2 * half];
      if (col + 1 < p) dst[1] = acc[4 * nt + 2 * half + 1];
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
}

template <int NT>
cudaError_t launch_ssd(const float* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, float* y, float* ws, int b, int s, int h, int p, int n,
                       int chunk, bool vec_bc, bool vec_x, bool vec_dt, cudaStream_t stream) {
  const size_t smem1 = scores_smem(n, chunk);
  const size_t smem2 = ApplySmem(8 * NT, p, chunk).total;
  if (smem1 > kSmemMax || smem2 > kSmemMax) return cudaErrorInvalidValue;
  static const cudaError_t attr1 = allow_smem(ssd_scores_kernel);
  static const cudaError_t attr2 = allow_smem(ssd_apply_kernel<NT>);
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  float* scores = ws;
  float* cum = ws + score_floats(b, s, chunk);
  const int n_chunks = s / chunk;
  const dim3 grid1(n_pairs(chunk) * kBlocks + (h + kCumHeads - 1) / kCumHeads, n_chunks, b);
  ssd_scores_kernel<<<grid1, kThreads, smem1, stream>>>(dt, A, Bm, Cm, scores, cum, s, h, n,
                                                         chunk, vec_bc, vec_dt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t grid2 = static_cast<int64_t>(n_qtiles(chunk)) * h * n_chunks * b;
  if (grid2 > 0x7fffffff) return cudaErrorInvalidValue;
  ssd_apply_kernel<NT><<<static_cast<unsigned>(grid2), kThreads, smem2, stream>>>(
      x, dt, scores, cum, y, b, s, h, p, chunk, vec_x);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// Floats of the workspace `repro_ssd_diag` takes for these shapes.
extern "C" int64_t repro_ssd_workspace(int b, int s, int h, int chunk) {
  if (b <= 0 || s <= 0 || h <= 0 || chunk <= 0 || s % chunk != 0) return -1;
  return repro::score_floats(b, s, chunk) + static_cast<int64_t>(b) * s * h;
}

// All operands float32 and contiguous on the card: x (B,S,H,P), dt (B,S,H),
// A (H,), Bm/Cm (B,S,N), y (B,S,H,P); ws: repro_ssd_workspace(b, s, h,
// chunk) floats. chunk divides S. Launches the scores phase and the apply
// phase; returns the first failing launch's cudaError_t.
extern "C" int repro_ssd_diag(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* Cm, void* y, void* ws, int b, int s, int h, int p,
                              int n, int chunk, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 || s % chunk != 0 ||
      b > 65535 || s / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* w = static_cast<float*>(ws);
  auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  const bool vec_bc = n % 4 == 0 && aligned(Bm) && aligned(Cm);
  const bool vec_x = p % 4 == 0 && aligned(x) && (static_cast<int64_t>(h) * p) % 4 == 0;
  // a cum CTA's 32 heads of dt: whole 16-byte pieces when h is a multiple of 4
  const bool vec_dt = h % 4 == 0 && aligned(dt);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 64) return (int)repro::launch_ssd<8>(xf, dtf, af, bf, cf, yf, w, b, s, h, p, n, chunk, vec_bc, vec_x, vec_dt, st);
  if (p <= 128) return (int)repro::launch_ssd<16>(xf, dtf, af, bf, cf, yf, w, b, s, h, p, n, chunk, vec_bc, vec_x, vec_dt, st);
  return (int)cudaErrorInvalidValue;
}
