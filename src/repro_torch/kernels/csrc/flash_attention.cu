// Causal / sliding-window flash attention (prefill) for Hopper.
//
// Replaces the Pallas kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`): the same online
// softmax with a float32 (m, l, acc) state, GQA by q-head h -> kv-head
// h / group, query positions shifted by q_offset, and the mask
// `k <= q` (causal) and `k > q - window` filled with -1e30.
//
// What bounds it on an H100: at a long prompt the work is 4*Sq*Sk*D/2
// multiply-adds per head, far above the card's 295 operations per byte, so
// the bound is the tensor cores' rate. At the serving path's prompts
// (Sq <= 32) there is almost no work and the launch itself dominates.
//
// Design: the TPU walks KV blocks as a sequential grid axis and carries the
// softmax state in VMEM scratch. Here one CTA owns (batch, q-head, 16-row
// query tile) and walks the KV tiles in a loop, so the state stays in
// registers and nothing crosses CTAs. Tiles wholly outside the causal or
// window horizon are skipped (the Pallas kernel runs them masked). A ragged
// last query tile (bucketed prompts of 8 tokens) and a ragged last KV tile
// are masked, never asserted on. Q is kept in float32 and K/V tiles in the
// input type in dynamic shared memory (152 KB at D=256 in float32, above the
// 48 KB static limit); rows are padded by one 32-bit word so the threads of
// a warp read distinct banks. Products run on the CUDA cores in float32:
// this first version is right and simple; mma/wgmma tiles are later work.
#include "common.cuh"

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
                 const T* __restrict__ v, T* __restrict__ o, Strides qs,
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
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         const Strides* st, int b, int hq, int hkv, int sq,
                         int sk, int causal, int window, int q_offset,
                         float scale, cudaStream_t stream) {
  constexpr size_t smem = FlashSmem<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), st[0], st[1], st[2], st[3], hq / hkv, sq, sk, causal,
      window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int d, const void* q, const void* k, const void* v,
                           void* o, const Strides* st, int b, int hq, int hkv,
                           int sq, int sk, int causal, int window, int q_offset,
                           float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_flash<T, 64>(q, k, v, o, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 128:
      return launch_flash<T, 128>(q, k, v, o, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    case 256:
      return launch_flash<T, 256>(q, k, v, o, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// strides: 12 element strides, (batch, head, seq) for q, k, v and o in turn.
// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, const int64_t* strides, int b,
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
  if (dtype == 0)
    return (int)repro::dispatch_flash<float>(d, q, k, v, o, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, s);
  if (dtype == 1)
    return (int)repro::dispatch_flash<__nv_bfloat16>(d, q, k, v, o, st, b, hq, hkv, sq, sk, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
