// Fused single-pass Phi matmul for Hopper (sm_90a), CUDA C++: three kernels.
//
// phi_fused_kernel<P, false> replaces repro/kernels/phi_fused.py::
// phi_fused_pallas (body _fused_kernel over _partition_body);
// phi_fused_kernel<P, true> replaces phi_fused_prefetch_pallas and
// phi_fused_stream_kernel replaces phi_fused_stream_pallas, both described at
// the end of this note. For binary activations a (M, K), per-partition
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
// What bounds it on an H100: not bytes. Each output element costs T gathered
// PWP values, the residual's weight rows and a handful of CUDA-core adds (no
// tensor-core work), and the bytes it must move (activations, PWP rows,
// residual weight rows, output) take far less time at the card's memory rate
// than the kernel does. Its time goes to the match, q popcounts per (row,
// partition), redone by every one of the ceil(N / BN) column tiles of a row
// block, and to the per-element gathers of PWP and weight rows through L2;
// restricting the match to a few patterns (the prefetching variant below)
// saves only 13-20%, so the gathers are most of it. PERF.md (Where the time
// goes, Open questions) has the measurements and the next steps.
// The design as it stands:
//   * One block per (BM x BN) output tile. A loop over groups of TG
//     K-partitions inside the block replaces the TPU's all-resident (bm, K)
//     activation block, which does not fit shared memory at K = 4608.
//   * Per group, the group's packed patterns (TG x q words) are copied to
//     shared memory; each thread matches one (row, partition) pair and
//     leaves idx, scale and the residual's +/- bit masks in shared memory.
//     Neither the (M, T) index nor the (M, K) residual reaches device memory.
//   * In the accumulate phase a warp owns 32 consecutive output columns of one
//     row, so each selected PWP row and each residual weight row is read as
//     one coalesced segment, and the residual loop walks only the set bits.
//   * Ragged M and N edges are masked in the kernel; nothing is padded.
// Limits (the wrapper refuses the rest): k <= 64 (one 64-bit word per row
// partition), q <= MAX_Q (the pattern group must fit 48 KB of static-limit
// shared memory), f32 activations and weights.
//
// phi_fused_stream_kernel: the K-streaming variant. The TPU kernel keeps only
// group_t K-partitions resident and copies group g+1's operands HBM->VMEM
// with double-buffered DMAs while group g is matched and contracted. Here the
// same tiles and per-partition math as above, but each group's packed
// patterns and its (BM x group_t*k) activation tile are copied into one of two
// shared-memory stages with cp.async, one group ahead, so the match reads
// shared memory and the next group's loads overlap this group's work. The
// PWP and residual weight rows are gathers by the matched index and stay
// global reads, as in the kernel above. Each output still sums its partitions
// in ascending t, L1 and L2 apart, so the two kernels are bitwise equal.
// The two stages take 48 KB of dynamic shared memory at q = 128, k = 16,
// group_t = 8, which with the 6 KB match tile still lets four blocks share an
// SM, as the first kernel's registers (60 a thread) allow it; the
// activation tile is not padded, since padding it cost a block per SM and
// the bank conflicts it removed are a few reads per (row, partition) against
// q popcounts. It takes any q whose two stages fit the 227 KB a block may
// use. It is bound as the first kernel is, and measures 1-6% slower than it
// at every GEMM of the VGG and Spikformer-4-384 slices: the loads it hides
// were already hidden by the other blocks on the SM.
//
// phi_fused_kernel<P, true>: the PWP-prefetching variant. The TPU kernel
// copies into VMEM only the pattern and PWP rows of a per-M-stripe active
// set (the P patterns the stripe's rows reference most, P sized from the
// calibration usage) and matches against those alone; a row whose best
// pattern lies outside the set matches none, and its bits go to the exact
// L2 residual. Here the first kernel's tiles, with the stage's pattern rows
// gathered through the stripe's active set (active[stripe][t][0..P), in that
// order, so ties go to the earlier set member as in the reference) and the
// matched compact index mapped back to the bank's row for the PWP and scale
// gathers. The PWP rows were gathers by index already, so what the Hopper
// gains is the match: P patterns a partition instead of q. The output is
// exact as before; l2_nnz counts the larger residual of the restricted
// match. A BM-row tile must lie in one stripe (the wrapper checks).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;                              // rows per output tile
constexpr int BN = 64;                              // columns per output tile
constexpr int TG = 8;                               // K-partitions per stage
constexpr int THREADS = BM * TG;                    // one (row, partition) pair each
constexpr int ROW_GROUPS = THREADS / BN;            // 4
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;    // 8
constexpr int MAX_Q = 512;
constexpr int SMEM_OPTIN = 232448;                  // 227 KB: a block's shared-memory limit

static_assert(THREADS == 256, "tile shape");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

// The k activation bits of one row partition, bit j = element j non-zero.
__device__ __forceinline__ unsigned long long row_bits(const float* src, int k) {
  unsigned long long bits = 0ull;
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
  return bits;
}

// The match state of one output tile's BM rows in one stage of partitions.
struct MatchTile {
  int idx[BM][TG];
  float scale[BM][TG];
  unsigned long long pos[BM][TG];
  unsigned long long neg[BM][TG];
};

// Match one (row, partition) against n_pat packed patterns: first argmin of
// the Hamming distance, kept only when strictly below the row's own popcount.
// ``map`` (null: identity) takes the matched position to the bank row; no
// match is row q. Leaves idx, scale and the residual's +/- masks in the
// tile; returns the residual entries.
__device__ __forceinline__ int match_one(unsigned long long bits, const unsigned long long* pt,
                                         int n_pat, const int* map, int q,
                                         const float* scale_t, MatchTile& m, int mr, int mt) {
  const int pop_a = __popcll(bits);
  int best = 0, best_h = 0x7fffffff;
  for (int i = 0; i < n_pat; ++i) {
    const int h = __popcll(bits ^ pt[i]);
    if (h < best_h) { best_h = h; best = i; }  // strict: first index on ties
  }
  const bool use = best_h < pop_a;              // strictly better than raw bits
  const int idx = use ? (map ? map[best] : best) : q;
  const unsigned long long chosen = use ? pt[best] : 0ull;
  const unsigned long long pos = bits & ~chosen, neg = chosen & ~bits;
  m.idx[mr][mt] = idx;
  m.scale[mr][mt] = scale_t[idx];
  m.pos[mr][mt] = pos;
  m.neg[mr][mt] = neg;
  return __popcll(pos) + __popcll(neg);
}

// Accumulate one stage of tg partitions (from partition g) into this
// thread's ROWS_PER_THREAD rows of column n: L1 and L2 apart, ascending t.
template <typename P>
__device__ __forceinline__ void accumulate(float (&acc1)[ROWS_PER_THREAD],
                                           float (&acc2)[ROWS_PER_THREAD],
                                           const P* __restrict__ pwp,
                                           const float* __restrict__ w, const MatchTile& m,
                                           int g, int tg, int q, int k, int N, int n, int rg) {
  const int qs = q + 1;
  for (int tt = 0; tt < tg; ++tt) {
    const int t = g + tt;
    const P* pwp_t = pwp + static_cast<size_t>(t) * qs * N + n;
    const float* w_t = w + static_cast<size_t>(t) * k * N + n;
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int r = rg + i * ROW_GROUPS;
      const float v = to_f32(pwp_t[static_cast<size_t>(m.idx[r][tt]) * N]);
      acc1[i] = __fadd_rn(acc1[i], __fmul_rn(v, m.scale[r][tt]));
      const unsigned long long pos = m.pos[r][tt];
      unsigned long long rest = pos | m.neg[r][tt];
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

__device__ __forceinline__ void store_tile(const float (&acc1)[ROWS_PER_THREAD],
                                           const float (&acc2)[ROWS_PER_THREAD],
                                           float* __restrict__ out, long long m0, long long M,
                                           int N, int n, int rg) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const long long row = m0 + rg + i * ROW_GROUPS;
    if (row < M) out[row * N + n] = __fadd_rn(acc1[i], acc2[i]);
  }
}

template <typename P, bool PREFETCH>
__global__ void __launch_bounds__(THREADS) phi_fused_kernel(
    const float* __restrict__ a,                      // (M, K)
    const unsigned long long* __restrict__ pat,       // (T, q) packed patterns
    const P* __restrict__ pwp,                        // (T, q+1, N)
    const float* __restrict__ scale,                  // (T, q+1)
    const float* __restrict__ w,                      // (K, N)
    float* __restrict__ out,                          // (M, N)
    int* __restrict__ nnz,                            // (ceil(M / bm),), zeroed
    long long M, int K, int N, int T, int q, int k, int bm,
    const int* __restrict__ active,                   // PREFETCH: (ceil(M / bm), T, n_pat)
    int n_pat) {                                      // patterns matched: q, or P
  extern __shared__ unsigned long long s_pat[];       // TG rows of stride n_pat+1
  __shared__ MatchTile s_m;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int qs = q + 1;
  const int ps = n_pat + 1;  // padded stride: the TG pattern rows fall in different banks
  // PREFETCH: the tile's stripe's active sets, (T, n_pat)
  const int* act = PREFETCH ? active + (m0 / bm) * T * n_pat : nullptr;

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
    for (int i = tid; i < tg * n_pat; i += THREADS) {
      const int tt = i / n_pat, p = i % n_pat;
      const int row = PREFETCH ? act[(g + tt) * n_pat + p] : p;
      s_pat[tt * ps + p] = pat[static_cast<size_t>(g + tt) * q + row];
    }
    __syncthreads();

    if (mt < tg) {
      const int t = g + mt;
      const unsigned long long bits =
          mrow_ok ? row_bits(a + mrow * K + static_cast<long long>(t) * k, k) : 0ull;
      my_nnz += match_one(bits, s_pat + mt * ps, n_pat, PREFETCH ? act + t * n_pat : nullptr,
                          q, scale + static_cast<size_t>(t) * qs, s_m, mr, mt);
    }
    __syncthreads();

    if (n_ok) accumulate<P>(acc1, acc2, pwp, w, s_m, g, tg, q, k, N, n, rg);
  }

  if (n_ok) store_tile(acc1, acc2, out, m0, M, N, n, rg);
  // The residual count is the same in every column tile; one tile writes it.
  if (blockIdx.y == 0 && mrow_ok && my_nnz) atomicAdd(&nnz[mrow / bm], my_nnz);
}

// ------------------------------------------------------- K-streaming kernel ---
// Shared memory of one stage: group_t packed pattern rows of stride q+1
// (rounded up to 16 bytes), then the activation tile, BM rows of group_t
// partitions of k floats, as they lie in a row of the activations.
__host__ __device__ __forceinline__ size_t stream_pat_bytes(int q, int group_t) {
  return (static_cast<size_t>(group_t) * (q + 1) * 8 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ size_t stream_stage_bytes(int q, int k, int group_t) {
  return stream_pat_bytes(q, group_t) + static_cast<size_t>(BM) * group_t * k * sizeof(float);
}

template <typename P>
__global__ void __launch_bounds__(THREADS) phi_fused_stream_kernel(
    const float* __restrict__ a, const unsigned long long* __restrict__ pat,
    const P* __restrict__ pwp, const float* __restrict__ scale,
    const float* __restrict__ w, float* __restrict__ out, int* __restrict__ nnz,
    long long M, int K, int N, int T, int q, int k, int bm, int group_t) {
  extern __shared__ __align__(16) unsigned char s_stage[];   // two stages
  __shared__ MatchTile s_m;

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int qs = q + 1;
  const int gk = group_t * k;                         // floats of one tile row
  const size_t pat_bytes = stream_pat_bytes(q, group_t);
  const size_t stage_bytes = stream_stage_bytes(q, k, group_t);
  const bool vec = (k & 3) == 0 && (K & 3) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const int n_groups = (T + group_t - 1) / group_t;

  const int mr = tid / TG, mt = tid % TG;
  const long long mrow = m0 + mr;
  const bool mrow_ok = mrow < M;
  const int col = tid % BN, rg = tid / BN;
  const int n = blockIdx.y * BN + col;
  const bool n_ok = n < N;

  // Start the copies of group gi into stage st: the group's packed patterns,
  // and its activation tile (rows past M are not copied; nothing reads them).
  auto issue = [&](int gi, int st) {
    unsigned long long* sp = reinterpret_cast<unsigned long long*>(s_stage + st * stage_bytes);
    float* sa = reinterpret_cast<float*>(s_stage + st * stage_bytes + pat_bytes);
    const int g = gi * group_t, tg = min(group_t, T - g);
    for (int i = tid; i < tg * q; i += THREADS)
      __pipeline_memcpy_async(sp + (i / q) * qs + (i % q), pat + static_cast<size_t>(g) * q + i,
                              8);
    const int rows = static_cast<int>(min(static_cast<long long>(BM), M - m0));
    const float* src = a + m0 * K + static_cast<long long>(g) * k;
    if (vec) {
      const int per_row = tg * k / 4;
      for (int i = tid; i < rows * per_row; i += THREADS) {
        const int r = i / per_row, c = (i % per_row) * 4;
        __pipeline_memcpy_async(sa + r * gk + c, src + r * K + c, 16);
      }
    } else {
      const int per_row = tg * k;
      for (int i = tid; i < rows * per_row; i += THREADS) {
        const int r = i / per_row, c = i % per_row;
        __pipeline_memcpy_async(sa + r * gk + c, src + r * K + c, 4);
      }
    }
    __pipeline_commit();
  };

  float acc1[ROWS_PER_THREAD], acc2[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) { acc1[i] = 0.f; acc2[i] = 0.f; }
  int my_nnz = 0;

  issue(0, 0);
  for (int gi = 0; gi < n_groups; ++gi) {
    const int st = gi & 1;
    const int g = gi * group_t, tg = min(group_t, T - g);
    // The other stage was last read by group gi-1's match, which every
    // thread finished before the barrier that preceded its accumulate.
    if (gi + 1 < n_groups) {
      issue(gi + 1, st ^ 1);
      __pipeline_wait_prior(1);                 // this thread's copies of group gi landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // everyone's copies landed; the previous accumulate is done with s_m

    if (mt < tg) {
      const unsigned long long* sp =
          reinterpret_cast<const unsigned long long*>(s_stage + st * stage_bytes);
      const float* sa = reinterpret_cast<const float*>(s_stage + st * stage_bytes + pat_bytes);
      const int t = g + mt;
      const unsigned long long bits = mrow_ok ? row_bits(sa + mr * gk + mt * k, k) : 0ull;
      my_nnz += match_one(bits, sp + mt * qs, q, nullptr, q, scale + static_cast<size_t>(t) * qs,
                          s_m, mr, mt);
    }
    __syncthreads();

    if (n_ok) accumulate<P>(acc1, acc2, pwp, w, s_m, g, tg, q, k, N, n, rg);
  }

  if (n_ok) store_tile(acc1, acc2, out, m0, M, N, n, rg);
  if (blockIdx.y == 0 && mrow_ok && my_nnz) atomicAdd(&nnz[mrow / bm], my_nnz);
}

// group_t 0: the first kernel, or with ``active`` its prefetching variant
// over n_pat patterns; group_t > 0: the streaming kernel.
template <typename P>
cudaError_t launch(const float* a, const unsigned long long* packed, const void* pwp,
                   const float* scale, const float* w, float* out, int* nnz,
                   long long M, int K, int N, int T, int q, int k, int bm, int group_t,
                   const int* active, int n_pat, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN));
  if (group_t == 0) {
    const size_t smem = static_cast<size_t>(TG) * (n_pat + 1) * sizeof(unsigned long long);
    if (active)
      phi_fused_kernel<P, true><<<grid, THREADS, smem, stream>>>(
          a, packed, static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm,
          active, n_pat);
    else
      phi_fused_kernel<P, false><<<grid, THREADS, smem, stream>>>(
          a, packed, static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm,
          nullptr, q);
    return cudaGetLastError();
  }
  const size_t smem = 2 * stream_stage_bytes(q, k, group_t);
  if (smem + sizeof(MatchTile) > SMEM_OPTIN) return cudaErrorInvalidValue;
  if (smem + sizeof(MatchTile) > 48 * 1024) {   // static + dynamic past the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        phi_fused_stream_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  phi_fused_stream_kernel<P><<<grid, THREADS, smem, stream>>>(
      a, packed, static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm, group_t);
  return cudaGetLastError();
}

cudaError_t dispatch_dtype(const float* a, const unsigned long long* packed, const void* pwp,
                           int pwp_dtype, const float* scale, const float* w, float* out,
                           int* nnz, long long M, int K, int N, int T, int q, int k, int bm,
                           int group_t, const int* active, int n_pat, cudaStream_t s) {
  switch (pwp_dtype) {
    case 0: return launch<float>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm,
                                 group_t, active, n_pat, s);
    case 1: return launch<__nv_bfloat16>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k,
                                         bm, group_t, active, n_pat, s);
    case 2: return launch<int8_t>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm,
                                  group_t, active, n_pat, s);
    default: return cudaErrorInvalidValue;
  }
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
  return static_cast<int>(dispatch_dtype(a, packed, pwp, pwp_dtype, scale, w, out, nnz, M, K,
                                         N, T, q, k, bm, 0, nullptr, q,
                                         static_cast<cudaStream_t>(stream)));
}

// The PWP-prefetching variant: the same contract plus ``active``
// (ceil(M / bm), T, p_active) int32 bank rows per stripe of bm rows, bm a
// multiple of 32 or M <= bm; p_active <= MAX_Q.
int phi_fused_prefetch_launch(const float* a, const unsigned long long* packed,
                              const void* pwp, int pwp_dtype, const float* scale,
                              const float* w, float* out, int* nnz, long long M, int K,
                              int N, int T, int q, int k, int bm, const int* active,
                              int p_active, void* stream) {
  if (k < 1 || k > 64 || q < 1 || K != T * k || bm < 1 || active == nullptr ||
      p_active < 1 || p_active > q || p_active > MAX_Q || (bm % BM != 0 && M > bm))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_dtype(a, packed, pwp, pwp_dtype, scale, w, out, nnz, M, K,
                                         N, T, q, k, bm, 0, active, p_active,
                                         static_cast<cudaStream_t>(stream)));
}

// The K-streaming kernel: the same contract, group_t (1..8) partitions per
// stage, any q whose two stages fit a block's shared memory.
int phi_fused_stream_launch(const float* a, const unsigned long long* packed, const void* pwp,
                            int pwp_dtype, const float* scale, const float* w, float* out,
                            int* nnz, long long M, int K, int N, int T, int q, int k, int bm,
                            int group_t, void* stream) {
  if (k < 1 || k > 64 || q < 1 || K != T * k || bm < 1 || group_t < 1 || group_t > TG)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_dtype(a, packed, pwp, pwp_dtype, scale, w, out, nnz, M, K,
                                         N, T, q, k, bm, group_t, nullptr, q,
                                         static_cast<cudaStream_t>(stream)));
}

// Shared memory of one block of the K-streaming kernel, in bytes: its two
// stages (dynamic) and the match tile (static).
long long phi_fused_stream_smem_bytes(int q, int k, int group_t) {
  return static_cast<long long>(2 * stream_stage_bytes(q, k, group_t) + sizeof(MatchTile));
}

}  // extern "C"
