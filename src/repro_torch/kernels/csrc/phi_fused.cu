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
// with double-buffered DMAs while group g is matched and contracted. Here
// each group's packed patterns and activation rows are copied into one of
// two shared-memory stages with cp.async, one group ahead. Each output still
// sums its partitions in ascending t, L1 and L2 apart, so it is bitwise equal
// to the first kernel. Taken apart on the card (PERF.md), the first
// version of this kernel, which had the first kernel's tiles, spent its time
// on loads issued one at a time (per row, the PWP load and then each residual
// bit's weight row, each waited for before the next), on the match, redone by
// every 64-column tile of a row tile, and on copying the row tile's
// activations once per column tile. This design:
//   * A cluster of up to 8 column tiles (distributed shared memory) shares a
//     row tile's match: each block matches a 1/cluster share of the rows,
//     each (row, partition)'s q patterns split over up to 32 lanes (a packed
//     (distance, index) minimum keeps the first index on ties), writes the
//     result into every block's match tile and copies only its share of the
//     activations. The match runs one group ahead of the sums, while the
//     group's first PWP loads are in flight; one cluster barrier a group.
//   * 128-column tiles, a warp per row group and four columns a thread: one
//     decode of a residual mask serves four columns, and PWP and weight rows
//     are read as 16-byte vectors (8 bytes for bf16, 4 for int8); the next
//     partition's PWP values and scales are loaded before this partition's
//     ordered sums.
//   * The residual's weight rows are read from w (L2-resident here), not
//     staged: staging each group's K-slab of w in shared memory measured
//     slower at every GEMM of the main paths (the copies cost L2 bandwidth
//     and the slab's shared memory forced shallower groups, so more cluster
//     barriers).
// What bounds it on an H100 is latency: the stages are chains of L2 loads,
// shared-memory loads and barriers (PERF.md has the cycle counts).
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
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
// Its own tile: BM rows x SBN columns, a warp per row group (SROWS rows, the
// warp's lanes on SCOLS consecutive columns each), so that a warp decodes
// each residual mask once for 128 columns.
constexpr int SBN = 128;                            // columns per output tile
constexpr int SCOLS = 4;                            // columns per thread
constexpr int SROW_GROUPS = THREADS / 32;           // 8: one warp each
constexpr int SROWS = BM / SROW_GROUPS;             // 4 rows per thread
static_assert(32 * SCOLS == SBN, "stream tile shape");

// Shared memory of one stage: group_t packed pattern rows of stride q+1 and
// the activation rows this block matches (rows ceil(BM / cluster) of
// group_t*k floats), each rounded up to 16 bytes. After the two stages, two
// match tiles (one per group parity) of BM x group_t pairs (the residual's
// +/- masks, the matched index) and BM row counters.
__host__ __device__ __forceinline__ size_t round16(size_t b) { return (b + 15) / 16 * 16; }
__host__ __device__ __forceinline__ size_t stream_stage_bytes(int q, int k, int group_t, int rows) {
  return round16(static_cast<size_t>(group_t) * (q + 1) * 8) +
         round16(static_cast<size_t>(rows) * group_t * k * sizeof(float));
}
__host__ __device__ __forceinline__ size_t stream_smem(int q, int k, int group_t, int cluster) {
  return 2 * stream_stage_bytes(q, k, group_t, (BM + cluster - 1) / cluster) +
         static_cast<size_t>(2) * BM * group_t * (8 + 8 + 4) + BM * sizeof(int);
}
// Column tiles of a row tile that share its match: the largest divisor of
// the column-tile count up to 8, the portable cluster size.
__host__ __device__ __forceinline__ int stream_cluster(int N) {
  const int ny = (N + SBN - 1) / SBN;
  for (int c = 8; c > 1; --c)
    if (ny % c == 0) return c;
  return 1;
}

// SCOLS consecutive values from p as floats: one vector load where `vec`
// (N a multiple of 4 and the base aligned), else the first `valid` ones.
__device__ __forceinline__ float4 load4(const float* p, bool vec, int valid) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) r.x = p[0];
  if (valid > 1) r.y = p[1];
  if (valid > 2) r.z = p[2];
  if (valid > 3) r.w = p[3];
  return r;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, bool vec, int valid) {
  if (vec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) r.x = __bfloat162float(p[0]);
  if (valid > 1) r.y = __bfloat162float(p[1]);
  if (valid > 2) r.z = __bfloat162float(p[2]);
  if (valid > 3) r.w = __bfloat162float(p[3]);
  return r;
}
__device__ __forceinline__ float4 load4(const int8_t* p, bool vec, int valid) {
  if (vec) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                       static_cast<float>(c.z), static_cast<float>(c.w));
  }
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid > 0) r.x = static_cast<float>(p[0]);
  if (valid > 1) r.y = static_cast<float>(p[1]);
  if (valid > 2) r.z = static_cast<float>(p[2]);
  if (valid > 3) r.w = static_cast<float>(p[3]);
  return r;
}

__device__ __forceinline__ void add_scaled(float4& acc, float4 v, float s) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, s));
  acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, s));
  acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, s));
  acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, s));
}

// This thread's SROWS rows' PWP values (SCOLS columns) and scales of
// partition t, whose matched indices are column tt of the match tile.
template <typename P>
__device__ __forceinline__ void load_partition(float4 (&v)[SROWS], float (&s)[SROWS],
                                               const P* __restrict__ pwp,
                                               const float* __restrict__ scale,
                                               const int* __restrict__ tidx, int t, int tt,
                                               int group_t, int q, int N, int n, int rg, bool vec,
                                               int valid) {
  const size_t qs = static_cast<size_t>(q) + 1;
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const size_t row = t * qs + tidx[(rg + i * SROW_GROUPS) * group_t + tt];
    v[i] = load4(pwp + row * N + n, vec, valid);
    s[i] = scale[row];
  }
}

// One stage of tg partitions (from g) into this thread's SROWS rows of its
// SCOLS columns, L1 and L2 apart, ascending t, each column's sums those of
// accumulate(). vn, sn hold partition g's PWP values and scales (loaded by
// the caller ahead); the next partition's are loaded before this
// partition's sums. The residual's weight rows are read from w (L2-resident
// at the main paths' shapes) as SCOLS-wide vectors.
template <typename P>
__device__ __forceinline__ void accumulate_stream(
    float4 (&acc1)[SROWS], float4 (&acc2)[SROWS], float4 (&vn)[SROWS], float (&sn)[SROWS],
    const P* __restrict__ pwp, const float* __restrict__ scale, const float* __restrict__ w,
    const unsigned long long* __restrict__ tpos, const unsigned long long* __restrict__ tneg,
    const int* __restrict__ tidx, int g, int tg, int group_t, int q, int k, int N, int n,
    int rg, bool vec, int valid) {
  for (int tt = 0; tt < tg; ++tt) {
    float4 v[SROWS];
    float s[SROWS];
#pragma unroll
    for (int i = 0; i < SROWS; ++i) { v[i] = vn[i]; s[i] = sn[i]; }
    if (tt + 1 < tg)
      load_partition<P>(vn, sn, pwp, scale, tidx, g + tt + 1, tt + 1, group_t, q, N, n, rg, vec,
                        valid);
#pragma unroll
    for (int i = 0; i < SROWS; ++i) {
      const int e = (rg + i * SROW_GROUPS) * group_t + tt;
      add_scaled(acc1[i], v[i], s[i]);
      const unsigned long long pos = tpos[e];
      unsigned long long rest = pos | tneg[e];
      if (rest) {
        float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
        while (rest) {                           // set bits in ascending j
          const int j = __ffsll(static_cast<long long>(rest)) - 1;
          rest &= rest - 1;
          const float4 wv = load4(w + static_cast<size_t>((g + tt) * k + j) * N + n, vec, valid);
          if ((pos >> j) & 1ull) {
            part.x = __fadd_rn(part.x, wv.x); part.y = __fadd_rn(part.y, wv.y);
            part.z = __fadd_rn(part.z, wv.z); part.w = __fadd_rn(part.w, wv.w);
          } else {
            part.x = __fsub_rn(part.x, wv.x); part.y = __fsub_rn(part.y, wv.y);
            part.z = __fsub_rn(part.z, wv.z); part.w = __fsub_rn(part.w, wv.w);
          }
        }
        acc2[i].x = __fadd_rn(acc2[i].x, part.x); acc2[i].y = __fadd_rn(acc2[i].y, part.y);
        acc2[i].z = __fadd_rn(acc2[i].z, part.z); acc2[i].w = __fadd_rn(acc2[i].w, part.w);
      }
    }
  }
}

// Launched in clusters of stream_cluster(N) blocks along the column tiles of
// one row tile. Block `rank` matches the rows r = rank (mod cluster) of each
// stage, each (row, partition) pair's q patterns split over up to 32 lanes,
// and writes the result into every block's match tile (distributed shared
// memory); one cluster barrier a stage publishes it.
template <typename P>
__global__ void __launch_bounds__(THREADS, 3) phi_fused_stream_kernel(
    const float* __restrict__ a, const unsigned long long* __restrict__ pat,
    const P* __restrict__ pwp, const float* __restrict__ scale,
    const float* __restrict__ w, float* __restrict__ out, int* __restrict__ nnz,
    long long M, int K, int N, int T, int q, int k, int bm, int group_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int qs = q + 1;
  const int gk = group_t * k;                         // floats of one activation row
  const int rows_r = (BM - rank + C - 1) / C;         // rows r = rank (mod C) of the tile
  const size_t pat_bytes = round16(static_cast<size_t>(group_t) * qs * 8);
  const size_t act_bytes = round16(static_cast<size_t>((BM + C - 1) / C) * gk * sizeof(float));
  const size_t pa_bytes = pat_bytes + act_bytes;         // one stage
  const int pairs_max = BM * group_t;
  unsigned char* tiles = smem + 2 * pa_bytes;               // match tiles, by group parity
  const size_t tile_bytes = static_cast<size_t>(pairs_max) * 20;
  int* s_rownnz = reinterpret_cast<int*>(tiles + 2 * tile_bytes);
  const int n0 = blockIdx.y * SBN;
  const bool vec_a = (k & 3) == 0 && (K & 3) == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  // Vector loads of pwp and w rows: N a multiple of 4 and the bases aligned.
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pwp) & (4 * sizeof(P) - 1)) == 0;
  const int n_groups = (T + group_t - 1) / group_t;

  const int lane = tid % 32, rg = tid / 32;
  const int n = n0 + lane * SCOLS;
  const int valid = min(SCOLS, N - n);                // columns of this thread inside N
  if (tid < BM) s_rownnz[tid] = 0;

  // Start the copies of group gp's packed patterns and this block's
  // activation rows (rows past M are not copied; nothing reads them).
  auto issue = [&](int gp) {
    if (gp < n_groups) {
      unsigned char* base = smem + (gp & 1) * pa_bytes;
      unsigned long long* sp = reinterpret_cast<unsigned long long*>(base);
      float* sa = reinterpret_cast<float*>(base + pat_bytes);
      const int g = gp * group_t, tg = min(group_t, T - g);
      for (int i = tid; i < tg * q; i += THREADS)
        __pipeline_memcpy_async(sp + (i / q) * qs + (i % q),
                                pat + static_cast<size_t>(g) * q + i, 8);
      const float* src = a + m0 * K + static_cast<long long>(g) * k;
      const int per_row = vec_a ? tg * k / 4 : tg * k, width = vec_a ? 4 : 1;
      for (int i = tid; i < rows_r * per_row; i += THREADS) {
        const int j = i / per_row, c = (i % per_row) * width, r = rank + j * C;
        if (m0 + r >= M) continue;
        if (vec_a)
          __pipeline_memcpy_async(sa + j * gk + c, src + r * K + c, 16);
        else
          __pipeline_memcpy_async(sa + j * gk + c, src + r * K + c, 4);
      }
    }
    __pipeline_commit();
  };

  // Match group gm's pairs of this block's rows from its pattern/activation
  // buffer into every block's match tile gm & 1 (pos, neg: 8 bytes; idx: 4;
  // pair e = r*group_t + tt).
  auto match = [&](int gm) {
    const unsigned char* base = smem + (gm & 1) * pa_bytes;
    unsigned char* tile = tiles + (gm & 1) * tile_bytes;
    const int tg = min(group_t, T - gm * group_t);
    const int pairs = rows_r * tg;
    int tpp = 1;
    while (tpp < 32 && pairs * tpp * 2 <= THREADS) tpp *= 2;
    const bool on = tid < pairs * tpp;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    if (!on) return;
    const unsigned long long* sp = reinterpret_cast<const unsigned long long*>(base);
    const float* sa = reinterpret_cast<const float*>(base + pat_bytes);
    const int pair = tid / tpp, sub = tid % tpp, j = pair / tg, tt = pair % tg;
    const int r = rank + j * C;
    const unsigned long long bits = m0 + r < M ? row_bits(sa + j * gk + tt * k, k) : 0ull;
    const unsigned long long* pt = sp + tt * qs;
    unsigned best = 0xffffffffu;                      // (distance << 16) | index
    for (int i = sub; i < q; i += tpp)
      best = min(best, (static_cast<unsigned>(__popcll(bits ^ pt[i])) << 16) | i);
    for (int o = tpp / 2; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(mask, best, o));
    if (sub == 0) {
      const bool use = static_cast<int>(best >> 16) < __popcll(bits);  // strictly better
      const int idx = use ? static_cast<int>(best & 0xffffu) : q;
      const unsigned long long chosen = use ? pt[idx] : 0ull;
      const unsigned long long pos = bits & ~chosen, neg = chosen & ~bits;
      const int e = r * group_t + tt;
      for (int dst = 0; dst < C; ++dst) {
        unsigned char* rt = cluster.map_shared_rank(tile, dst);
        reinterpret_cast<unsigned long long*>(rt)[e] = pos;
        reinterpret_cast<unsigned long long*>(rt)[pairs_max + e] = neg;
        reinterpret_cast<int*>(rt + 16 * pairs_max)[e] = idx;
      }
      const int cnt = __popcll(pos) + __popcll(neg);
      if (cnt) atomicAdd(&s_rownnz[r], cnt);
    }
  };

  float4 acc1[SROWS], acc2[SROWS];
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    acc1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // The match runs one group ahead of the sums: iteration gi matches group
  // gi+1 while group gi's PWP loads are in flight, then sums group gi; one
  // cluster barrier publishes the match. Copies run one iteration ahead.
  issue(0);
  issue(1);
  __pipeline_wait_prior(1);
  __syncthreads();
  match(0);
  cluster.sync();
  for (int gi = 0; gi < n_groups; ++gi) {
    const int g = gi * group_t, tg = min(group_t, T - g);
    __syncthreads();  // iteration gi-1 is done with the buffers the next copies fill
    if (gi + 1 < n_groups) {
      issue(gi + 2);
      __pipeline_wait_prior(1);                 // this thread's copies for iteration gi landed
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();  // everyone's copies landed
    const unsigned char* tile = tiles + (gi & 1) * tile_bytes;
    const int* tidx = reinterpret_cast<const int*>(tile + 16 * pairs_max);
    float4 vn[SROWS];
    float sn[SROWS];
    if (valid > 0)                              // in flight while group gi+1 is matched
      load_partition<P>(vn, sn, pwp, scale, tidx, g, 0, group_t, q, N, n, rg, vec, valid);
    if (gi + 1 < n_groups) match(gi + 1);
    if (valid > 0)
      accumulate_stream<P>(
          acc1, acc2, vn, sn, pwp, scale, w, reinterpret_cast<const unsigned long long*>(tile),
          reinterpret_cast<const unsigned long long*>(tile) + pairs_max, tidx, g, tg, group_t, q,
          k, N, n, rg, vec, valid);
    cluster.sync();  // group gi+1's match tiles are complete; gi's are no longer read
  }

  if (valid > 0) {
#pragma unroll
    for (int i = 0; i < SROWS; ++i) {
      const long long row = m0 + rg + i * SROW_GROUPS;
      if (row >= M) continue;
      const float4 o =
          make_float4(__fadd_rn(acc1[i].x, acc2[i].x), __fadd_rn(acc1[i].y, acc2[i].y),
                      __fadd_rn(acc1[i].z, acc2[i].z), __fadd_rn(acc1[i].w, acc2[i].w));
      float* dst = out + row * N + n;
      if (vec && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        dst[0] = o.x;
        if (valid > 1) dst[1] = o.y;
        if (valid > 2) dst[2] = o.z;
        if (valid > 3) dst[3] = o.w;
      }
    }
  }
  // Each row's residual is counted by the block that matched it, in the
  // first cluster of the row tile only.
  __syncthreads();
  if (blockIdx.y < C && tid < BM && s_rownnz[tid]) atomicAdd(&nnz[(m0 + tid) / bm], s_rownnz[tid]);
}

template <typename P>
cudaError_t launch_stream(const float* a, const unsigned long long* packed, const void* pwp,
                          const float* scale, const float* w, float* out, int* nnz, long long M,
                          int K, int N, int T, int q, int k, int bm, int group_t,
                          cudaStream_t stream) {
  const int C = stream_cluster(N);
  const size_t smem = stream_smem(q, k, group_t, C);
  if (smem > static_cast<size_t>(SMEM_OPTIN)) return cudaErrorInvalidValue;
  // A cluster launch is refused unless the kernel's dynamic shared-memory
  // limit is set, whatever the size.
  const cudaError_t err = cudaFuncSetAttribute(
      phi_fused_stream_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((M + BM - 1) / BM),
                     static_cast<unsigned>((N + SBN - 1) / SBN));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, phi_fused_stream_kernel<P>, a, packed,
                            static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm,
                            group_t);
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
  const cudaError_t err =
      launch_stream<P>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, group_t, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
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
// stage, any q < 65536 whose two stages fit a block's shared memory.
int phi_fused_stream_launch(const float* a, const unsigned long long* packed, const void* pwp,
                            int pwp_dtype, const float* scale, const float* w, float* out,
                            int* nnz, long long M, int K, int N, int T, int q, int k, int bm,
                            int group_t, void* stream) {
  if (k < 1 || k > 64 || q < 1 || q > 0xffff || K != T * k || bm < 1 || group_t < 1 ||
      group_t > TG || N > 65535 * SBN)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch_dtype(a, packed, pwp, pwp_dtype, scale, w, out, nnz, M, K,
                                         N, T, q, k, bm, group_t, nullptr, q,
                                         static_cast<cudaStream_t>(stream)));
}

// Shared memory of one block of the K-streaming kernel, in bytes, at a
// cluster of one block (the most any N gives): its two stages, the two match
// tiles and the row counters; all dynamic.
long long phi_fused_stream_smem_bytes(int q, int k, int group_t) {
  return static_cast<long long>(stream_smem(q, k, group_t, 1));
}

// Blocks of a fused kernel one SM holds (cudaOccupancy...), float32 bank:
// kernel 0 the first one, 1 the prefetching one (n_pat = q), 2 the streaming
// one at (q, k, group_t) and N's cluster; a negative CUDA error code on failure.
int phi_fused_occupancy(int kernel, int q, int k, int group_t, int N) {
  int n = 0;
  cudaError_t err;
  if (kernel == 0 || kernel == 1) {
    const size_t smem = static_cast<size_t>(TG) * (q + 1) * sizeof(unsigned long long);
    err = kernel == 0
        ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, phi_fused_kernel<float, false>,
                                                        THREADS, smem)
        : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, phi_fused_kernel<float, true>,
                                                        THREADS, smem);
  } else {
    const size_t smem = stream_smem(q, k, group_t, stream_cluster(N));
    err = cudaFuncSetAttribute(phi_fused_stream_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, phi_fused_stream_kernel<float>,
                                                          THREADS, smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
