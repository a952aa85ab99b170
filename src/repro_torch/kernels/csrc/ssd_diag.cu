// Mamba-2 SSD diagonal block, for Hopper.
//
// Replaces the Pallas kernel `_ssd_diag_kernel` of
// src/repro/kernels/ssd_diag.py (`ssd_diag`): for every chunk of Q rows of
// the sequence and every head h,
//   Y[i] = sum_{j <= i} (C_i . B_j) * exp(cum_i - cum_j) * dt_j * x_j,
//   cum  = cumsum over the chunk of dt * A[h],
// in float32 (x (B,S,H,P), dt (B,S,H), A (H,), B/C (B,S,N), Y (B,S,H,P)).
//
// What bounds it on an H100: operations. The causal half of two products,
// C.B^T (N multiply-adds a pair) and W.(dt x) (P a pair), is
// Q(Q+1)/2 * 2(N+P) operations per (chunk, head), against about 8PQ bytes
// of x and y per (chunk, head) (B and C are shared by the heads): at
// Q = 256, N = 128, P = 64 some 95 operations per byte, above the card's 20
// float32 operations per byte outside the tensor cores.
//
// Design: the Pallas kernel holds the whole (Q, Q) score tile of a chunk;
// at Q = 256 that is 256 KB of float32, more than a block's 227 KB of
// shared memory. Here one CTA owns (batch, chunk, head, 64-row q-tile) and
// loops over 64-row k-tiles up to the diagonal only, so the masked upper
// half is never computed. The chunk's prefix sum is formed in shared memory
// (every thread runs the same sequential sum, in the reference's order, and
// keeps the entries it owns). The C tile stays in shared memory for the
// whole loop; each k-tile brings in B and dt*x; a 16 x 16 thread grid
// computes the 64 x 64 scores (4 x 4 each, rows and columns strided by 16),
// weights them by the decay, stores W in shared memory, and accumulates
// W.(dt x) into a (64, P) output held in registers. Rows of the B and C
// tiles are padded to an odd number of words so the 16 rows a half-warp
// reads fall in distinct banks. C.B^T does not depend on the head (one
// group), yet it is recomputed for every head, as the Pallas kernel does:
// sharing it across heads is later work (ROADMAP).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;      // q rows per CTA and k rows per tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kSub = kRows / 16;

struct SsdSmem {
  int ld_n, ld_w;
  size_t inc, cum, c, b, dtx, w, total;  // float offsets and total floats
  __host__ __device__ SsdSmem(int chunk, int n, int p) {
    ld_n = n | 1;
    ld_w = kRows + 1;
    inc = 0;
    cum = inc + chunk;
    c = cum + chunk;
    b = c + (size_t)kRows * ld_n;
    dtx = b + (size_t)kRows * ld_n;
    w = dtx + (size_t)kRows * p;
    total = w + (size_t)kRows * ld_w;
  }
};

// M: output columns a thread owns (columns tx, tx+16, ...), P <= 16*M
template <int M>
__global__ void __launch_bounds__(kThreads)
ssd_diag_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, float* __restrict__ y,
                int s_len, int h, int p, int n, int chunk, int n_qtiles) {
  extern __shared__ float smem[];
  const SsdSmem lay(chunk, n, p);
  float* inc_s = smem + lay.inc;
  float* cum_s = smem + lay.cum;
  float* c_s = smem + lay.c;
  float* b_s = smem + lay.b;
  float* dtx_s = smem + lay.dtx;
  float* w_s = smem + lay.w;

  const int qt = blockIdx.x % n_qtiles;
  const int ck = blockIdx.x / n_qtiles;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int64_t row0 = (int64_t)bb * s_len + (int64_t)ck * chunk;
  const int i0 = qt * kRows;
  const int i_end = min(chunk, i0 + kRows);

  // cum[0, i_end): the sequential sum of dt * A[h], as the reference's
  // cumsum takes it; thread t keeps the entries t, t + 256, ...
  const float a_h = A[hh];
  for (int j = tid; j < i_end; j += kThreads)
    inc_s[j] = dt[(row0 + j) * h + hh] * a_h;
  __syncthreads();
  {
    float run = 0.f;
    for (int j = 0; j < i_end; ++j) {
      run += inc_s[j];
      if ((j & (kThreads - 1)) == tid) cum_s[j] = run;
    }
  }

  // this tile's C rows, zero past the chunk
  for (int e = tid; e < kRows * n; e += kThreads) {
    const int r = e / n, col = e - r * n;
    const int i = i0 + r;
    c_s[r * lay.ld_n + col] = i < i_end ? Cm[(row0 + i) * n + col] : 0.f;
  }

  float acc[kSub][M];
#pragma unroll
  for (int a = 0; a < kSub; ++a)
#pragma unroll
    for (int mm = 0; mm < M; ++mm) acc[a][mm] = 0.f;

  for (int j0 = 0; j0 < i_end; j0 += kRows) {
    const int j_end = min(chunk, j0 + kRows);
    __syncthreads();  // cum and C are in; the last tile's B, dt*x, W are read
    for (int e = tid; e < kRows * n; e += kThreads) {
      const int r = e / n, col = e - r * n;
      const int j = j0 + r;
      b_s[r * lay.ld_n + col] = j < j_end ? Bm[(row0 + j) * n + col] : 0.f;
    }
    for (int e = tid; e < kRows * p; e += kThreads) {
      const int r = e / p, col = e - r * p;
      const int j = j0 + r;
      float val = 0.f;
      if (j < j_end) {
        const int64_t hr = (row0 + j) * h + hh;
        val = dt[hr] * x[hr * p + col];
      }
      dtx_s[r * p + col] = val;
    }
    __syncthreads();

    // scores of rows ty + 16a against columns tx + 16c
    float sc[kSub][kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a)
#pragma unroll
      for (int c = 0; c < kSub; ++c) sc[a][c] = 0.f;
    for (int kk = 0; kk < n; ++kk) {
      float cv[kSub], bv[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) cv[a] = c_s[(ty + 16 * a) * lay.ld_n + kk];
#pragma unroll
      for (int c = 0; c < kSub; ++c) bv[c] = b_s[(tx + 16 * c) * lay.ld_n + kk];
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int c = 0; c < kSub; ++c) sc[a][c] += cv[a] * bv[c];
    }
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
      const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
      for (int c = 0; c < kSub; ++c) {
        const int cc = tx + 16 * c, j = j0 + cc;
        const bool live = i < i_end && j < j_end && j <= i;
        w_s[r * lay.ld_w + cc] = live ? sc[a][c] * expf(cum_s[i] - cum_s[j]) : 0.f;
      }
    }
    __syncthreads();

    // acc += W (64 x 64) . dt*x (64 x P)
    for (int jj = 0; jj < kRows; ++jj) {
      float wv[kSub], dv[M];
#pragma unroll
      for (int a = 0; a < kSub; ++a) wv[a] = w_s[(ty + 16 * a) * lay.ld_w + jj];
#pragma unroll
      for (int mm = 0; mm < M; ++mm) {
        const int col = tx + 16 * mm;
        dv[mm] = col < p ? dtx_s[jj * p + col] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a)
#pragma unroll
        for (int mm = 0; mm < M; ++mm) acc[a][mm] += wv[a] * dv[mm];
    }
  }

#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= i_end) continue;
#pragma unroll
    for (int mm = 0; mm < M; ++mm) {
      const int col = tx + 16 * mm;
      if (col < p) y[((row0 + i) * h + hh) * p + col] = acc[a][mm];
    }
  }
}

template <int M>
cudaError_t launch_ssd(const float* x, const float* dt, const float* A,
                       const float* Bm, const float* Cm, float* y, int b,
                       int s, int h, int p, int n, int chunk,
                       cudaStream_t stream) {
  const size_t smem = SsdSmem(chunk, n, p).total * sizeof(float);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_diag_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (chunk + kRows - 1) / kRows;
  const dim3 grid((s / chunk) * n_qtiles, h, b);
  ssd_diag_kernel<M><<<grid, kThreads, smem, stream>>>(
      x, dt, A, Bm, Cm, y, s, h, p, n, chunk, n_qtiles);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// All operands float32 and contiguous on the card: x (B,S,H,P), dt (B,S,H),
// A (H,), Bm/Cm (B,S,N), y (B,S,H,P). chunk divides S. Returns the launch's
// cudaError_t.
extern "C" int repro_ssd_diag(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y, int b,
                              int s, int h, int p, int n, int chunk,
                              void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || p <= 0 || n <= 0 || chunk <= 0 ||
      s % chunk != 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p <= 16) return (int)repro::launch_ssd<1>(xf, dtf, af, bf, cf, yf, b, s, h, p, n, chunk, st);
  if (p <= 32) return (int)repro::launch_ssd<2>(xf, dtf, af, bf, cf, yf, b, s, h, p, n, chunk, st);
  if (p <= 64) return (int)repro::launch_ssd<4>(xf, dtf, af, bf, cf, yf, b, s, h, p, n, chunk, st);
  if (p <= 128) return (int)repro::launch_ssd<8>(xf, dtf, af, bf, cf, yf, b, s, h, p, n, chunk, st);
  return (int)cudaErrorInvalidValue;
}
