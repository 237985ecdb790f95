// Fused single-pass Phi matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/phi_fused.py::phi_fused_pallas (body _fused_kernel
// over _partition_body). For binary activations a (M, K), per-partition
// patterns (T, q, k) with K = T*k, given bit-packed as one word per pattern
// (T, q) (bit j = pattern element j; the bank is constant after calibration,
// so the caller packs it once), pattern-weight products pwp (T, q+1, N) in
// f32 / bf16 / int8 with per-row scales (T, q+1), and weights w (K, N) f32:
//
//   per row m and K-partition t:
//     bits   = the k activation bits of a[m, t*k : (t+1)*k], packed in a word
//     H_i    = popc(bits ^ p_i)        (= |a|+|p|-2a.p exactly for binary a)
//     best   = first argmin_i H_i;  idx = (H_best < popc(bits)) ? best : q
//     acc1  += pwp[t, idx, :] * scale[t, idx]              (L1)
//     acc2  += sum_j residual_j * w[t*k + j, :]            (L2, residual in {-1,0,+1})
//   out[m] = acc1 + acc2;  l2_nnz[m / bm] += number of residual entries
//
// The two accumulators stay separate and are added once at the end, as the
// reference does: every partial product is exact (a selected PWP row; a +-1
// residual entry), so on weights of a dyadic grid the result is bitwise equal
// to the unfused lowerings whatever the summation order. Every float add and
// multiply is written with __fadd_rn / __fmul_rn (and the file is built with
// --fmad=false) so that nvcc cannot contract acc1 + v*scale into an FMA that
// would round differently from the reference.
//
// What bounds it on an H100: the integer match, not bytes. Each output element
// costs T gathered PWP values and a handful of CUDA-core adds (no tensor-core
// work), and the bytes it must move (activations, PWP rows, residual weight
// rows, output) take far less time at the card's memory rate than the kernel
// does. The match, q popcounts per (row, partition), is redone by every one of
// the ceil(N / BN) column tiles of a row block, so its cost scales with N / BN
// and not with the bytes; PERF.md (Where the time goes, Open questions) has the
// measurement and the next steps: match once per row block and share the
// index across column tiles, or do the match on the int8 tensor cores.
// The design as it stands:
//   * One block per (BM x BN) output tile. A loop over groups of TG
//     K-partitions inside the block replaces the TPU's all-resident (bm, K)
//     activation block, which does not fit shared memory at K = 4608.
//   * Per group, the group's packed patterns (TG x q words) are copied to
//     shared memory; each thread matches one (row, partition) pair and
//     leaves idx, scale and the residual's +/- bit masks in shared memory. Neither the (M, T) index nor
//     the (M, K) residual ever reaches device memory.
//   * In the accumulate phase a warp owns 32 consecutive output columns of one
//     row, so each selected PWP row and each residual weight row is read as
//     one coalesced segment, and the residual loop walks only the set bits.
//   * Ragged M and N edges are masked in the kernel; nothing is padded.
// Limits (the wrapper refuses the rest): k <= 64 (one 64-bit word per row
// partition), q <= MAX_Q (the pattern group must fit 48 KB of static-limit
// shared memory), f32 activations and weights.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;                              // rows per output tile
constexpr int BN = 64;                              // columns per output tile
constexpr int TG = 8;                               // K-partitions per stage
constexpr int THREADS = BM * TG;                    // one (row, partition) pair each
constexpr int ROW_GROUPS = THREADS / BN;            // 4
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;    // 8
constexpr int MAX_Q = 512;

static_assert(THREADS == 256, "tile shape");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename P>
__global__ void __launch_bounds__(THREADS) phi_fused_kernel(
    const float* __restrict__ a,                      // (M, K)
    const unsigned long long* __restrict__ pat,       // (T, q) packed patterns
    const P* __restrict__ pwp,                        // (T, q+1, N)
    const float* __restrict__ scale,                  // (T, q+1)
    const float* __restrict__ w,                      // (K, N)
    float* __restrict__ out,                          // (M, N)
    int* __restrict__ nnz,                            // (ceil(M / bm),), zeroed
    long long M, int K, int N, int T, int q, int k, int bm) {
  extern __shared__ unsigned long long s_pat[];       // TG rows of stride q+1
  __shared__ int s_idx[BM][TG];
  __shared__ float s_scale[BM][TG];
  __shared__ unsigned long long s_pos[BM][TG];
  __shared__ unsigned long long s_neg[BM][TG];

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int qs = q + 1;  // padded stride: the TG pattern rows fall in different banks

  // Match-phase role: one (row, partition-in-group) pair.
  const int mr = tid / TG, mt = tid % TG;
  const long long mrow = m0 + mr;
  const bool mrow_ok = mrow < M;
  // Accumulate-phase role: one column, ROWS_PER_THREAD rows.
  const int col = tid % BN, rg = tid / BN;
  const int n = blockIdx.y * BN + col;
  const bool n_ok = n < N;

  float acc1[ROWS_PER_THREAD], acc2[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) { acc1[i] = 0.f; acc2[i] = 0.f; }
  int my_nnz = 0;

  for (int g = 0; g < T; g += TG) {
    const int tg = min(TG, T - g);
    __syncthreads();  // the previous stage is done with the shared state
    for (int i = tid; i < tg * q; i += THREADS)
      s_pat[(i / q) * qs + (i % q)] = pat[static_cast<size_t>(g) * q + i];
    __syncthreads();

    if (mt < tg) {
      const int t = g + mt;
      unsigned long long bits = 0ull;
      if (mrow_ok) {
        const float* src = a + mrow * K + static_cast<long long>(t) * k;
        if ((k & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
          for (int j = 0; j < k; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(src + j);
            bits |= (v.x != 0.f ? 1ull : 0ull) << j;
            bits |= (v.y != 0.f ? 1ull : 0ull) << (j + 1);
            bits |= (v.z != 0.f ? 1ull : 0ull) << (j + 2);
            bits |= (v.w != 0.f ? 1ull : 0ull) << (j + 3);
          }
        } else {
          for (int j = 0; j < k; ++j)
            if (src[j] != 0.f) bits |= 1ull << j;
        }
      }
      const int pop_a = __popcll(bits);
      const unsigned long long* pt = s_pat + mt * qs;
      int best = 0, best_h = 0x7fffffff;
      for (int i = 0; i < q; ++i) {
        const int h = __popcll(bits ^ pt[i]);
        if (h < best_h) { best_h = h; best = i; }  // strict: first index on ties
      }
      const bool use = best_h < pop_a;              // strictly better than raw bits
      const int idx = use ? best : q;
      const unsigned long long chosen = use ? pt[best] : 0ull;
      const unsigned long long pos = bits & ~chosen, neg = chosen & ~bits;
      s_idx[mr][mt] = idx;
      s_scale[mr][mt] = scale[static_cast<size_t>(t) * qs + idx];
      s_pos[mr][mt] = pos;
      s_neg[mr][mt] = neg;
      my_nnz += __popcll(pos) + __popcll(neg);
    }
    __syncthreads();

    if (n_ok) {
      for (int tt = 0; tt < tg; ++tt) {
        const int t = g + tt;
        const P* pwp_t = pwp + static_cast<size_t>(t) * qs * N + n;
        const float* w_t = w + static_cast<size_t>(t) * k * N + n;
#pragma unroll
        for (int i = 0; i < ROWS_PER_THREAD; ++i) {
          const int r = rg + i * ROW_GROUPS;
          const float v = to_f32(pwp_t[static_cast<size_t>(s_idx[r][tt]) * N]);
          acc1[i] = __fadd_rn(acc1[i], __fmul_rn(v, s_scale[r][tt]));
          const unsigned long long pos = s_pos[r][tt];
          unsigned long long rest = pos | s_neg[r][tt];
          if (rest) {
            float part = 0.f;
            while (rest) {                           // set bits in ascending j
              const int j = __ffsll(static_cast<long long>(rest)) - 1;
              rest &= rest - 1;
              const float wv = w_t[static_cast<size_t>(j) * N];
              part = ((pos >> j) & 1ull) ? __fadd_rn(part, wv) : __fsub_rn(part, wv);
            }
            acc2[i] = __fadd_rn(acc2[i], part);
          }
        }
      }
    }
  }

  if (n_ok) {
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const long long row = m0 + rg + i * ROW_GROUPS;
      if (row < M) out[row * N + n] = __fadd_rn(acc1[i], acc2[i]);
    }
  }
  // The residual count is the same in every column tile; one tile writes it.
  if (blockIdx.y == 0 && mrow_ok && my_nnz) atomicAdd(&nnz[mrow / bm], my_nnz);
}

template <typename P>
cudaError_t launch(const float* a, const unsigned long long* packed, const void* pwp,
                   const float* scale, const float* w, float* out, int* nnz,
                   long long M, int K, int N, int T, int q, int k, int bm,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  const size_t smem = static_cast<size_t>(TG) * (q + 1) * sizeof(unsigned long long);
  phi_fused_kernel<P><<<grid, THREADS, smem, stream>>>(
      a, packed, static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// pwp_dtype: 0 = float32, 1 = bfloat16, 2 = int8. Returns cudaGetLastError()
// after the launch (0 on success); the caller synchronises as it needs.
int phi_fused_launch(const float* a, const unsigned long long* packed, const void* pwp,
                     int pwp_dtype, const float* scale, const float* w, float* out,
                     int* nnz, long long M, int K, int N, int T, int q, int k, int bm,
                     void* stream) {
  if (k < 1 || k > 64 || q < 1 || q > MAX_Q || K != T * k || bm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pwp_dtype) {
    case 0: return launch<float>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, s);
    case 1: return launch<__nv_bfloat16>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, s);
    case 2: return launch<int8_t>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
