// One-token decode attention for Hopper (sm_90a), CUDA C++.
//
// Has no TPU counterpart: the reference's decode attention
// (repro/models/layers.py::attention_decode) is plain JAX, and under pjit a
// device computes only its own rows and heads. The port's plain version
// (kernels/decode_attention.py::decode_attention_plain) sums in the library's
// order, which depends on the batch and head counts, so on a mesh a rank had
// to make one device's call over zeros of the global cache to keep one
// device's bits. This kernel's result for a (row, head) does not depend on
// the batch, the head count or the grid, so a rank runs its own rows and
// heads and still gets one device's bits.
//
// For q (B, Hq, D), caches (B, Smax, Hkv, D) read in place in their own
// dtype (float32 or bfloat16), a per-row limit lim[b] (the last position the
// mask keeps: pos for "full" and "ring", pos % Smax for "chunk_ring") and
// rep = Hq / Hkv, Q head h reads KV head h / rep:
//
//   s_c = (sum_d q_d k_cd) * scale          for c <= lim, else -inf
//   out = sum_c softmax(s)_c v_c            (float32, cast to q's dtype)
//
// as a flash-decoding split whose reduction order is fixed by Smax and D
// alone. Pass 1: one block per (row, head, chunk of CHUNK keys) computes the
// chunk's scores (each key's dot over ascending d), its max m, p_c = exp(s_c
// - m) (NaN -> 0), l = sum_c p_c (a fixed shuffle tree) and acc_d = sum_c p_c
// v_cd (ascending c), and writes (m, l, acc) to a float32 workspace. A chunk
// wholly past lim writes (-inf, 0, 0) without reading the cache. Pass 2: one
// block per (row, head) takes M = max_j m_j, w_j = exp(m_j - M), L = sum_j
// w_j l_j and A_d = sum_j w_j acc_jd in ascending chunk order, and writes A_d
// / L. A skipped chunk adds exact zeros. Every add and multiply is __fadd_rn
// / __fmul_rn (the file is built with --fmad=false).
//
// What bounds it on an H100: bytes. Each (row, KV head) must read its lim + 1
// cache rows of K and V once; the scores and p.V are 4 D operations a row.
// At a rank's 8 rows and 1 head of a 32 k context (decode_32k on 16 x 16) the
// chunks give 512 blocks where the rows and heads alone give 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHUNK = 64;                // keys a pass-1 block takes
constexpr int MAX_D = 256;
constexpr long long SMEM_LIMIT = 232448;  // 227 KB: the most a block may use on sm_90

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Dynamic shared memory of a pass-1 block: q (D), the K chunk (CHUNK rows of
// stride D + 1, so the 64 threads reading key rows at one d hit distinct
// banks) and p (CHUNK), in floats.
__host__ __device__ inline long long partial_smem_bytes(int D) {
  return 4LL * (D + CHUNK * (D + 1) + CHUNK);
}

__host__ __device__ inline int n_chunks(int smax) { return (smax + CHUNK - 1) / CHUNK; }

__device__ __forceinline__ int row_limit(long long pos, int smax, int mode) {
  // mode 0 full / 1 ring: kpos <= pos (a filled ring keeps every slot);
  // mode 2 chunk_ring: kpos <= pos mod Smax.
  const long long lim = mode == 2 ? pos % smax : pos;
  return lim >= smax ? smax - 1 : static_cast<int>(lim);
}

// Pass 1. grid: B * Hq * nchunks blocks, chunk fastest.
template <typename QT, typename KT>
__global__ void __launch_bounds__(THREADS) decode_partial_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
    const int* __restrict__ pos, float* __restrict__ ws, int Smax, int Hq, int Hkv, int D,
    int mode, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;                       // (D)
  float* s_k = s_q + D;                    // (CHUNK, D + 1)
  float* s_p = s_k + CHUNK * (D + 1);      // (CHUNK)
  const int tid = threadIdx.x;
  const int nch = n_chunks(Smax);
  const long long blk = blockIdx.x;
  const int chunk = static_cast<int>(blk % nch);
  const long long bh = blk / nch;
  const int b = static_cast<int>(bh / Hq), h = static_cast<int>(bh % Hq);
  const int hk = h / (Hq / Hkv);
  float* w = ws + blk * (D + 2);           // (m, l, acc[D])
  const int lim = row_limit(pos[b], Smax, mode);
  const int c0 = chunk * CHUNK;
  if (c0 > lim) {                          // every key of the chunk is masked
    for (int d = tid; d < D + 2; d += THREADS) w[d] = d == 0 ? -INFINITY : 0.f;
    return;
  }
  const int rows = min(CHUNK, Smax - c0);
  const long long kv_row = static_cast<long long>(Hkv) * D;   // stride of the sequence axis
  const long long base = (static_cast<long long>(b) * Smax + c0) * kv_row +
                         static_cast<long long>(hk) * D;
  for (int d = tid; d < D; d += THREADS) s_q[d] = to_f32(q[bh * D + d]);
  for (int e = tid; e < rows * D; e += THREADS) {
    const int r = e / D, d = e % D;
    s_k[r * (D + 1) + d] = to_f32(k[base + r * kv_row + d]);
  }
  __syncthreads();
  if (tid < CHUNK) {
    float s = -INFINITY;
    if (tid < rows && c0 + tid <= lim) {
      const float* kr = s_k + tid * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = __fadd_rn(dot, __fmul_rn(s_q[d], kr[d]));
      s = __fmul_rn(dot, scale);
    }
    s_p[tid] = s;
  }
  __syncthreads();
  if (tid < 32) {                          // the chunk's max and sum, warp 0
    float mx = fmaxf(s_p[tid], s_p[tid + 32]);
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float p0 = expf(__fsub_rn(s_p[tid], mx)), p1 = expf(__fsub_rn(s_p[tid + 32], mx));
    if (isnan(p0)) p0 = 0.f;
    if (isnan(p1)) p1 = 0.f;
    s_p[tid] = p0;
    s_p[tid + 32] = p1;
    float l = __fadd_rn(p0, p1);
    for (int o = 16; o > 0; o >>= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));
    if (tid == 0) {
      w[0] = mx;
      w[1] = l;
    }
  }
  __syncthreads();
  const int used = min(rows, lim - c0 + 1);  // keys past lim have p = 0
  for (int d = tid; d < D; d += THREADS) {
    float acc = 0.f;
    for (int c = 0; c < used; ++c)
      acc = __fadd_rn(acc, __fmul_rn(s_p[c], to_f32(v[base + c * kv_row + d])));
    w[2 + d] = acc;
  }
}

// Pass 2. grid: B * Hq blocks.
template <typename QT>
__global__ void __launch_bounds__(THREADS) decode_combine_kernel(
    const float* __restrict__ ws, QT* __restrict__ out, int Smax, int D) {
  const int nch = n_chunks(Smax);
  const long long bh = blockIdx.x;
  const float* w = ws + bh * nch * (D + 2);
  float M = -INFINITY;
  for (int j = 0; j < nch; ++j) M = fmaxf(M, w[j * (D + 2)]);
  for (int d = threadIdx.x; d < D; d += THREADS) {
    float L = 0.f, A = 0.f;
    for (int j = 0; j < nch; ++j) {
      const float* wj = w + j * (D + 2);
      const float f = expf(__fsub_rn(wj[0], M));
      L = __fadd_rn(L, __fmul_rn(f, wj[1]));
      A = __fadd_rn(A, __fmul_rn(f, wj[2 + d]));
    }
    from_f32(out + bh * D + d, __fdiv_rn(A, L));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos, void* out,
                   float* ws, int B, int Smax, int Hq, int Hkv, int D, int mode, float scale,
                   cudaStream_t stream) {
  const long long smem = partial_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<QT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long bhs = static_cast<long long>(B) * Hq;
  decode_partial_kernel<QT, KT><<<static_cast<unsigned>(bhs * n_chunks(Smax)), THREADS, smem,
                                  stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v), pos, ws,
      Smax, Hq, Hkv, D, mode, scale);
  decode_combine_kernel<QT><<<static_cast<unsigned>(bhs), THREADS, 0, stream>>>(
      ws, static_cast<QT*>(out), Smax, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan: plan[0] keys a pass-1 block takes, plan[1] threads a
// block, plan[2] pass-1 blocks for one (row, head) at Smax, plan[3] the
// pass-1 block's dynamic shared memory in bytes, plan[4] workspace floats a
// (row, head). Returns 0, or cudaErrorInvalidValue for a shape it refuses.
int decode_attention_plan(int smax, int D, long long* plan) {
  if (smax < 1 || D < 1 || D > MAX_D) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = CHUNK;
  plan[1] = THREADS;
  plan[2] = n_chunks(smax);
  plan[3] = partial_smem_bytes(D);
  plan[4] = static_cast<long long>(n_chunks(smax)) * (D + 2);
  return plan[3] > SMEM_LIMIT ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

// q, out (B, Hq, D) contiguous in q_dtype; k, v (B, Smax, Hkv, D) contiguous
// in kv_dtype (0 float32, 1 bfloat16); pos (B,) int32; ws B * Hq *
// plan[4] floats. mode 0 full, 1 ring, 2 chunk_ring. Returns
// cudaGetLastError() after the two launches (0 on success).
int decode_attention_launch(const void* q, const void* k, const void* v, const int* pos,
                            void* out, float* ws, int B, int Smax, int Hq, int Hkv, int D,
                            int mode, int q_dtype, int kv_dtype, float scale, void* stream) {
  if (B < 1 || Smax < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || D < 1 || D > MAX_D ||
      mode < 0 || mode > 2 || q_dtype < 0 || q_dtype > 1 || kv_dtype < 0 || kv_dtype > 1 ||
      static_cast<long long>(B) * Hq * n_chunks(Smax) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch<float, float>(q, k, v, pos, out, ws, B, Smax, Hq, Hkv, D, mode, scale, s);
  else if (q_dtype == 0)
    err = launch<float, __nv_bfloat16>(q, k, v, pos, out, ws, B, Smax, Hq, Hkv, D, mode,
                                       scale, s);
  else if (kv_dtype == 0)
    err = launch<__nv_bfloat16, float>(q, k, v, pos, out, ws, B, Smax, Hq, Hkv, D, mode,
                                       scale, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(q, k, v, pos, out, ws, B, Smax, Hq, Hkv, D,
                                               mode, scale, s);
  return static_cast<int>(err);
}

}  // extern "C"
