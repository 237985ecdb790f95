// Fused single-pass Phi matmul for Hopper (sm_90a), CUDA C++: three kernels
// from two templates.
//
// phi_fused_kernel<P, false> replaces repro/kernels/phi_fused.py::
// phi_fused_pallas (body _fused_kernel over _partition_body) and
// phi_fused_kernel<P, true> replaces phi_fused_prefetch_pallas;
// phi_fused_stream_kernel replaces phi_fused_stream_pallas. For binary
// activations a (M, K), per-partition patterns (T, q, k) with K = T*k, given
// bit-packed as one word per pattern (T, q) (bit j = pattern element j; the
// bank is constant after calibration, so the caller packs it once),
// pattern-weight products pwp (T, q+1, N) in f32 / bf16 / int8 with per-row
// scales (T, q+1), and weights w (K, N) f32:
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
// would round differently from the reference. Both kernels take each output's
// partitions in ascending t and, within a partition, the residual's bits in
// ascending j into a partial sum that is then added to acc2, so they are
// bitwise equal to each other on any weights.
//
// What bounds them on an H100: not HBM bytes and not arithmetic. Each output
// element costs T gathered PWP values and the residual's weight rows, read
// through L2 (the bank and w stay L2-resident at the main paths' shapes), and
// a handful of CUDA-core adds. The time goes to those gathers and to the
// match, q popcounts per (row, partition).
//
// phi_fused_kernel<P, PREFETCH>, the first kernel, for T < 96 partitions on
// the main paths (any T on a direct call). Taken apart on the card (PERF.md),
// its first design (32x64 tiles, a stage of 8 partitions matched and summed
// in lockstep) spent a third of each stage on the match, redone by every
// 64-column tile of a row tile, one thread per (row, partition) pair looping
// over the q patterns, and the rest on sums whose loads were issued one at a
// time. This design:
//   * 128-column tiles, a warp per row group and four columns a thread (the
//     streaming kernel's tile): PWP and weight rows are read as 16-byte
//     vectors (8 bytes for bf16, 4 for int8), scalar where N is not a
//     multiple of 4 or a base is unaligned; ragged M and N edges are masked.
//   * Match once, then sum. A cluster of up to 8 column tiles (distributed
//     shared memory) shares a row tile's match. Each block packs the bits of
//     a 1/cluster share of the rows and matches them against the bank, read
//     from device memory (L1- and L2-resident; no staging, so no barrier per
//     stage): a unit of (partition, up to MR rows) takes TPP lanes, each
//     lane a slice of the patterns against all MR rows, and a transposing
//     min-reduction leaves lane j with row j's packed (distance, index)
//     minimum (first index on ties); the words are 32 bits wide where
//     k <= 32 (measured faster than 64). Each result goes into every block's
//     match tile; the matched rows' scales follow in one batch of loads.
//     The tile holds all T partitions of the row tile (32 x T pairs, 24
//     bytes each; T is taken in chunks of at most MAX_TC), so one cluster
//     barrier publishes the whole match and the sums run with no barrier.
//   * L1 and L2 in two loops (their accumulators are apart, so each keeps its
//     own ascending order), each accumulator parked in shared memory while
//     the other phases run, so that neither loop spills: the L1 loop keeps
//     L1_DEPTH partitions' PWP rows in flight; for L2 a warp lists each row's
//     residual entries in order (a prefix sum over its lanes, one partition
//     a lane) and walks the list, L2_BATCH weight rows loaded before their
//     ordered adds.
// PREFETCH: the TPU kernel copies into VMEM only the pattern and PWP rows of
// a per-M-stripe active set (the P patterns the stripe's rows reference most,
// P sized from the calibration usage) and matches against those alone; a row
// whose best pattern lies outside the set matches none, and its bits go to
// the exact L2 residual. Here the match reads the stripe's active patterns
// through its set (active[stripe][t][0..P), in that order, so ties go to the
// earlier set member as in the reference) and maps the matched position back
// to the bank's row for the PWP and scale gathers. The output is exact as before;
// l2_nnz counts the larger residual of the restricted match. A 32-row tile
// must lie in one stripe (the wrapper checks).
// Limits (the wrapper refuses the rest): k <= 64 (one 64-bit word per row
// partition), q and P <= MAX_Q, f32 activations and weights.
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32;                              // rows per output tile
constexpr int TG = 8;                               // K-partitions per stage
constexpr int THREADS = 256;
constexpr int MAX_Q = 512;
constexpr int SMEM_OPTIN = 232448;                  // 227 KB: a block's shared-memory limit

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

// The fused kernels' grid: BM-row by SBN-column output tiles.
inline dim3 fused_grid(long long M, int N) {
  return dim3(static_cast<unsigned>((M + BM - 1) / BM), static_cast<unsigned>((N + SBN - 1) / SBN));
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
  cfg.gridDim = fused_grid(M, N);
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

// ------------------------------------------------------------ first kernel ---
// The streaming kernel's tile (BM x SBN, a warp per row group of SROWS rows,
// SCOLS columns a thread) over a match tile of every partition of a chunk.
constexpr int MAX_TC = 95;    // partitions a match tile holds: every T the policy sends here
constexpr int MR = 8;         // rows a warp matches against each pattern it loads
constexpr int TPP = 8;        // lanes that share a unit's patterns (four units a warp)
constexpr int PB = 8;         // patterns a lane loads at a time (a block of TPP * PB)
constexpr int L1_DEPTH = 2;   // partitions of PWP rows in flight ahead of the L1 adds
constexpr int L2_BATCH = 8;   // residual weight rows loaded before their ordered adds
constexpr int LIST_CAP = 256; // residual entries of one row a warp lists at a time
constexpr int STASH = 2 * SROWS * SCOLS;  // accumulator floats a thread parks between phases
static_assert(TPP == MR, "a unit's lanes end with one row each");

// Partitions per chunk: T in the fewest chunks of at most MAX_TC, as even as
// they go.
__host__ __device__ __forceinline__ int first_tc(int T) {
  if (T <= MAX_TC) return T > 0 ? T : 1;
  const int chunks = (T + MAX_TC - 1) / MAX_TC;
  return (T + chunks - 1) / chunks;
}
// Shared memory of one block: the match tile of BM x first_tc(T) pairs (the
// residual's +/- masks, 8 bytes each, the matched bank row and its scale, 4
// each), BM row counters, each warp's list of residual entries and the parked
// accumulators.
__host__ __device__ __forceinline__ size_t first_smem(int T) {
  return static_cast<size_t>(BM) * first_tc(T) * 24 + BM * sizeof(int) +
         static_cast<size_t>(SROW_GROUPS) * LIST_CAP * sizeof(unsigned) +
         static_cast<size_t>(STASH) * THREADS * sizeof(float);
}

// Park (or fetch) this thread's SROWS accumulators in slots [s0, s0 + 16) of
// the block's stash (slot-major, so a warp's lanes hit consecutive words):
// they are not held in registers through the phases that do not add to them.
__device__ __forceinline__ void park(float* stash, int s0, int tid, const float4 (&acc)[SROWS]) {
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    stash[(s0 + 4 * i) * THREADS + tid] = acc[i].x;
    stash[(s0 + 4 * i + 1) * THREADS + tid] = acc[i].y;
    stash[(s0 + 4 * i + 2) * THREADS + tid] = acc[i].z;
    stash[(s0 + 4 * i + 3) * THREADS + tid] = acc[i].w;
  }
}
__device__ __forceinline__ void fetch(float4 (&acc)[SROWS], const float* stash, int s0, int tid) {
#pragma unroll
  for (int i = 0; i < SROWS; ++i)
    acc[i] = make_float4(
        stash[(s0 + 4 * i) * THREADS + tid], stash[(s0 + 4 * i + 1) * THREADS + tid],
        stash[(s0 + 4 * i + 2) * THREADS + tid], stash[(s0 + 4 * i + 3) * THREADS + tid]);
}

// acc2 of one row over the chunk's partitions from c0, by a whole warp (its
// lanes on their columns; a lane with none loads nothing). Lane l takes
// partition w0 + l of a window of 32 and lists its residual entries (weight
// row << 2 | last of its partition << 1 | sign) at its place in the row's
// order (a prefix sum over the lanes; a window ends before the first
// partition that would overflow the list). The warp then walks the list in
// order, L2_BATCH weight rows loaded before their ordered adds into `part`; a
// partition's `part` goes into acc2 after its last entry, as
// accumulate_stream adds it. Each entry is added as +w or as -w
// (x - w == x + (-w) exactly).
__device__ __forceinline__ void l2_row(float4& acc2, const float* __restrict__ w,
                                       const unsigned long long* __restrict__ rpos,
                                       const unsigned long long* __restrict__ rneg,
                                       unsigned* __restrict__ list, int c0, int tcn, int k,
                                       int N, int n, bool vec, int valid, int lane) {
  float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w0 = 0; w0 < tcn;) {                       // warp-uniform
    const int tt = w0 + lane;
    const bool in = tt < tcn;
    const unsigned long long lp = in ? rpos[tt] : 0ull, rest0 = in ? lp | rneg[tt] : 0ull;
    const int cnt = __popcll(rest0);
    int incl = cnt;                                   // entries up to this lane's partition
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned over = __ballot_sync(0xffffffffu, incl > LIST_CAP);
    const int take = over ? __ffs(over) - 1 : 32;     // partitions listed now (k <= LIST_CAP)
    const int total = __shfl_sync(0xffffffffu, incl, take - 1);
    if (lane < take) {
      unsigned long long rest = rest0;
      for (int e = incl - cnt; rest; ++e) {           // ascending bit
        const int j = __ffsll(static_cast<long long>(rest)) - 1;
        rest &= rest - 1;
        list[e] = (static_cast<unsigned>((c0 + tt) * k + j) << 2) | (rest ? 0u : 2u) |
                  static_cast<unsigned>((lp >> j) & 1ull);
      }
    }
    __syncwarp();
    for (int e0 = 0; e0 < total; e0 += L2_BATCH) {
      float4 wv[L2_BATCH];
      unsigned last = 0u;
#pragma unroll
      for (int s = 0; s < L2_BATCH; ++s) {
        const bool hv = e0 + s < total;
        const unsigned code = hv ? list[e0 + s] : 0u;
        const float4 v = load4(w + static_cast<size_t>(code >> 2) * N + n, vec && hv,
                               hv ? valid : 0);
        wv[s] = (code & 1u) ? v : make_float4(-v.x, -v.y, -v.z, -v.w);
        last |= ((code >> 1) & 1u) << s;
      }
#pragma unroll
      for (int s = 0; s < L2_BATCH; ++s) {
        if (e0 + s >= total) break;
        part.x = __fadd_rn(part.x, wv[s].x); part.y = __fadd_rn(part.y, wv[s].y);
        part.z = __fadd_rn(part.z, wv[s].z); part.w = __fadd_rn(part.w, wv[s].w);
        if ((last >> s) & 1u) {
          acc2.x = __fadd_rn(acc2.x, part.x); acc2.y = __fadd_rn(acc2.y, part.y);
          acc2.z = __fadd_rn(acc2.z, part.z); acc2.w = __fadd_rn(acc2.w, part.w);
          part = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    __syncwarp();                                     // the list is read before it is refilled
    w0 += take;
  }
}

// This thread's SROWS rows' PWP values (SCOLS columns) at partition c0 + tt,
// the bank rows the match tile names; VEC: 16/8/4-byte vector loads.
template <typename P, bool VEC>
__device__ __forceinline__ void load_rows(float4 (&v)[SROWS], const P* __restrict__ pwp,
                                          const int* __restrict__ tidx, int c0, int tt, int tcs,
                                          int q, int N, int n, int rg, int valid) {
  const size_t qs = static_cast<size_t>(q) + 1;
#pragma unroll
  for (int i = 0; i < SROWS; ++i) {
    const size_t row = (c0 + tt) * qs + tidx[(rg + i * SROW_GROUPS) * tcs + tt];
    v[i] = load4(pwp + row * N + n, VEC, valid);
  }
}

// acc1 over the chunk's partitions in ascending t, L1_DEPTH partitions' PWP
// values in flight ahead of the adds; the scales are read from the match tile
// as they are used.
template <typename P, bool VEC>
__device__ __forceinline__ void l1_sums(float4 (&acc1)[SROWS], const P* __restrict__ pwp,
                                        const int* __restrict__ tidx,
                                        const float* __restrict__ tscale, int c0, int tcn,
                                        int tcs, int q, int N, int n, int rg, int valid) {
  float4 v[L1_DEPTH][SROWS];
#pragma unroll
  for (int d = 0; d < L1_DEPTH; ++d)
    if (d < tcn) load_rows<P, VEC>(v[d], pwp, tidx, c0, d, tcs, q, N, n, rg, valid);
  for (int t0 = 0; t0 < tcn; t0 += L1_DEPTH) {
#pragma unroll
    for (int d = 0; d < L1_DEPTH; ++d) {
      const int tt = t0 + d;
      if (tt < tcn) {
#pragma unroll
        for (int i = 0; i < SROWS; ++i)
          add_scaled(acc1[i], v[d][i], tscale[(rg + i * SROW_GROUPS) * tcs + tt]);
        if (tt + L1_DEPTH < tcn)
          load_rows<P, VEC>(v[d], pwp, tidx, c0, tt + L1_DEPTH, tcs, q, N, n, rg, valid);
      }
    }
  }
}

__device__ __forceinline__ int popc(unsigned x) { return __popc(x); }
__device__ __forceinline__ int popc(unsigned long long x) { return __popcll(x); }

// Halve a lane's values with its partner lane ^ o: it keeps the half named
// by its bit o (the low half where clear), the minimum of both lanes' copies.
template <int H>
__device__ __forceinline__ void halve(unsigned (&dst)[H], const unsigned (&src)[2 * H], int lane,
                                      int o) {
  const bool hi = lane & o;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const unsigned mine = hi ? src[H + m] : src[m], other = hi ? src[m] : src[H + m];
    dst[m] = min(mine, __shfl_xor_sync(0xffffffffu, other, o));
  }
}

// Patterns i0 + sub, i0 + sub + TPP, ... (PB of them, zero past n_pat) of
// one partition's packed row pt in device memory (coalesced; PREFETCH:
// through `map`, the stripe's active set), as Words: 32 bits where k <= 32
// (the patterns' high words are zero), else 64.
template <typename Word, bool PREFETCH>
__device__ __forceinline__ void load_patterns(Word (&p)[PB],
                                              const unsigned long long* __restrict__ pt,
                                              const int* __restrict__ map, int n_pat, int i0,
                                              int sub) {
#pragma unroll
  for (int m = 0; m < PB; ++m) {
    const int i = i0 + TPP * m + sub;
    p[m] = i < n_pat ? static_cast<Word>(__ldg(pt + (PREFETCH ? __ldg(map + i) : i))) : Word(0);
  }
}

// Each of MR rows' packed (distance << 16 | index) minimum, folded over one
// block of a lane's patterns.
template <typename Word>
__device__ __forceinline__ void match_block(unsigned (&best)[MR], const Word (&bits)[MR],
                                            const Word (&p)[PB], int n_pat, int i0, int sub) {
#pragma unroll
  for (int m = 0; m < PB; ++m) {
    const int i = i0 + TPP * m + sub;
    if (i >= n_pat) break;
#pragma unroll
    for (int j = 0; j < MR; ++j)
      best[j] = min(best[j], (static_cast<unsigned>(popc(static_cast<Word>(bits[j] ^ p[m])))
                              << 16) | static_cast<unsigned>(i));
  }
}

// A unit's TPP lanes' minima reduced in 7 shuffles: lane sub of the unit
// ends with row sub's minimum over all the unit's patterns (first index on
// ties).
__device__ __forceinline__ unsigned reduce_rows(const unsigned (&best)[MR], int lane) {
  unsigned h4[4], h2[2], h1[1];
  halve<4>(h4, best, lane, 4);
  halve<2>(h2, h4, lane, 2);
  halve<1>(h1, h2, lane, 1);
  return h1[0];
}

// The match of a chunk: units of (partition, block of up to MR of this
// block's rows), four a warp, TPP lanes each over the patterns; lane sub of
// a unit writes row sub's result (residual masks, matched bank row) into
// every block's tile and counts its residual entries.
template <typename Word, bool PREFETCH>
__device__ __forceinline__ void match_units(cg::cluster_group cluster,
                                            unsigned long long* tpos, int* s_rownnz,
                                            const unsigned long long* __restrict__ pat,
                                            const int* __restrict__ act, int rank, int C,
                                            int rows_r, int rsize, int rblocks, int c0, int tcn,
                                            int tcs, int q, int n_pat, int lane, int rg) {
  const int units = tcn * rblocks, sub = lane % TPP;
  for (int u0 = 0; u0 < units; u0 += SROW_GROUPS * (32 / TPP)) {   // warp-uniform
    const int unit = u0 + rg * (32 / TPP) + lane / TPP;
    const bool on = unit < units;
    const int tt = on ? unit % tcn : 0, j0 = on ? (unit / tcn) * rsize : 0;
    const int nr = on ? min(rsize, rows_r - j0) : 0;
    const unsigned long long* pt = pat + static_cast<size_t>(c0 + tt) * q;
    const int* map = PREFETCH ? act + (c0 + tt) * n_pat : nullptr;
    Word bits[MR];
    unsigned best8[MR];
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      bits[j] = j < nr ? static_cast<Word>(tpos[(rank + (j0 + j) * C) * tcs + tt]) : Word(0);
      best8[j] = 0xffffffffu;
    }
    for (int i0 = 0; i0 < n_pat; i0 += TPP * PB) {
      Word p[PB];
      load_patterns<Word, PREFETCH>(p, pt, map, on ? n_pat : 0, i0, sub);
      match_block<Word>(best8, bits, p, on ? n_pat : 0, i0, sub);
    }
    const unsigned best = reduce_rows(best8, lane);
    if (sub < nr) {                                   // row sub's result
      const int r = rank + (j0 + sub) * C, e = r * tcs + tt;
      const unsigned long long bj = tpos[e];
      const bool use = static_cast<int>(best >> 16) < __popcll(bj);  // strictly better
      const int b = static_cast<int>(best & 0xffffu);
      const int row = PREFETCH ? map[b] : b;
      const int idx = use ? row : q;
      const unsigned long long chosen = use ? pt[row] : 0ull;
      const unsigned long long pos = bj & ~chosen, neg = chosen & ~bj;
      for (int dst = 0; dst < C; ++dst) {
        unsigned long long* rp = cluster.map_shared_rank(tpos, dst);
        rp[e] = pos;
        rp[BM * tcs + e] = neg;
        reinterpret_cast<int*>(rp + 2 * BM * tcs)[e] = idx;
      }
      const int cnt = __popcll(pos) + __popcll(neg);
      if (cnt) atomicAdd(&s_rownnz[r], cnt);
    }
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Launched in clusters of stream_cluster(N) blocks along the column tiles of
// one row tile. Per chunk of partitions: block `rank` packs the bits of the
// rows r = rank (mod cluster) into its own tile, matches them and writes each
// result into every block's tile (distributed shared memory); one cluster
// barrier publishes the chunk's match, then every block sums it.
template <typename P, bool PREFETCH>
__global__ void __launch_bounds__(THREADS, 2) phi_fused_kernel(
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
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();                           // waited for before the first remote write

  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int tcs = first_tc(T);                        // the tile's partitions (its stride)
  const int pairs_max = BM * tcs;
  float* stash = reinterpret_cast<float*>(smem);
  unsigned* lists = reinterpret_cast<unsigned*>(stash + STASH * THREADS);
  unsigned long long* tpos =
      reinterpret_cast<unsigned long long*>(lists + SROW_GROUPS * LIST_CAP);
  unsigned long long* tneg = tpos + pairs_max;
  int* tidx = reinterpret_cast<int*>(tneg + pairs_max);
  float* tscale = reinterpret_cast<float*>(tidx + pairs_max);
  int* s_rownnz = reinterpret_cast<int*>(tscale + pairs_max);
  // PREFETCH: the tile's stripe's active sets, (T, n_pat)
  const int* act = PREFETCH ? active + (m0 / bm) * T * n_pat : nullptr;
  const int rows_r = (BM - rank + C - 1) / C;         // rows r = rank (mod C) of the tile
  // Vector loads of pwp and w rows: N a multiple of 4 and the bases aligned.
  const bool vec = (N & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(pwp) & (4 * sizeof(P) - 1)) == 0;
  const int lane = tid % 32, rg = tid / 32;
  const int n = blockIdx.y * SBN + lane * SCOLS;
  const int valid = min(SCOLS, N - n);                // columns of this thread inside N
  const bool vl = vec && valid > 0;                   // a lane past N loads nothing
  if (tid < BM) s_rownnz[tid] = 0;

  float4 acc1[SROWS], acc2[SROWS];
  for (int c0 = 0; c0 < T; c0 += tcs) {
    const int tcn = min(tcs, T - c0);
    if (c0 > 0) cluster.sync();                       // every block is done with the last chunk
    // The bits of this block's rows (zero past M) into their pos slots, a
    // (row, partition) word a thread.
    for (int e = tid; e < rows_r * tcn; e += THREADS) {
      const int r = rank + (e / tcn) * C, tt = e % tcn;
      tpos[r * tcs + tt] =
          m0 + r < M ? row_bits(a + (m0 + r) * K + static_cast<long long>(c0 + tt) * k, k) : 0ull;
    }
    __syncthreads();
    if (c0 == 0) cluster_wait();                      // every block of the cluster has started

    // The match: units of (partition, block of up to MR of this block's
    // rows), TPP lanes each over the patterns.
    const int rblocks = (rows_r + MR - 1) / MR, rsize = (rows_r + rblocks - 1) / rblocks;
    if (k <= 32)
      match_units<unsigned, PREFETCH>(cluster, tpos, s_rownnz, pat, act, rank, C, rows_r, rsize,
                                      rblocks, c0, tcn, tcs, q, n_pat, lane, rg);
    else
      match_units<unsigned long long, PREFETCH>(cluster, tpos, s_rownnz, pat, act, rank, C,
                                                rows_r, rsize, rblocks, c0, tcn, tcs, q, n_pat,
                                                lane, rg);
    __syncthreads();
    // The matched rows' scales, one load each (all in flight), into every
    // block's tile.
    for (int e = tid; e < rows_r * tcn; e += THREADS) {
      const int tt = e % tcn, p = (rank + (e / tcn) * C) * tcs + tt;
      const float sv = scale[(c0 + tt) * (static_cast<size_t>(q) + 1) + tidx[p]];
      for (int dst = 0; dst < C; ++dst) cluster.map_shared_rank(tscale, dst)[p] = sv;
    }
    cluster.sync();                                   // the chunk's match tile is complete

    // L1: partitions in ascending t, L1_DEPTH partitions' loads in flight.
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < SROWS; ++i) acc1[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      fetch(acc1, stash, 0, tid);
    }
    if (vl)
      l1_sums<P, true>(acc1, pwp, tidx, tscale, c0, tcn, tcs, q, N, n, rg, valid);
    else
      l1_sums<P, false>(acc1, pwp, tidx, tscale, c0, tcn, tcs, q, N, n, rg, valid);
    park(stash, 0, tid, acc1);
    // L2: each row's residual entries in order, through the warp's list.
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < SROWS; ++i) acc2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      fetch(acc2, stash, 16, tid);
    }
#pragma unroll
    for (int i = 0; i < SROWS; ++i) {
      const int r = rg + i * SROW_GROUPS;
      l2_row(acc2[i], w, tpos + r * tcs, tneg + r * tcs, lists + rg * LIST_CAP, c0, tcn, k, N, n,
             vl, valid, lane);
    }
    if (c0 + tcs < T) park(stash, 16, tid, acc2);
  }
  if (T <= 0) {                                       // no chunk: zero sums, and the arrive's wait
#pragma unroll
    for (int i = 0; i < SROWS; ++i) acc2[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    park(stash, 0, tid, acc2);
    cluster_wait();
  }
  fetch(acc1, stash, 0, tid);

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

template <typename P, bool PREFETCH>
cudaError_t launch_first(const float* a, const unsigned long long* packed, const void* pwp,
                         const float* scale, const float* w, float* out, int* nnz, long long M,
                         int K, int N, int T, int q, int k, int bm, const int* active, int n_pat,
                         cudaStream_t stream) {
  const int C = stream_cluster(N);
  const size_t smem = first_smem(T);
  if (smem > static_cast<size_t>(SMEM_OPTIN)) return cudaErrorInvalidValue;
  // A cluster launch is refused unless the kernel's dynamic shared-memory
  // limit is set, whatever the size.
  const cudaError_t err = cudaFuncSetAttribute(
      phi_fused_kernel<P, PREFETCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = fused_grid(M, N);
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
  return cudaLaunchKernelEx(&cfg, phi_fused_kernel<P, PREFETCH>, a, packed,
                            static_cast<const P*>(pwp), scale, w, out, nnz, M, K, N, T, q, k, bm,
                            active, n_pat);
}

// group_t 0: the first kernel, or with ``active`` its prefetching variant
// over n_pat patterns; group_t > 0: the streaming kernel.
template <typename P>
cudaError_t launch(const float* a, const unsigned long long* packed, const void* pwp,
                   const float* scale, const float* w, float* out, int* nnz,
                   long long M, int K, int N, int T, int q, int k, int bm, int group_t,
                   const int* active, int n_pat, cudaStream_t stream) {
  cudaError_t err;
  if (group_t == 0 && active)
    err = launch_first<P, true>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, active,
                                n_pat, stream);
  else if (group_t == 0)
    err = launch_first<P, false>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm,
                                 nullptr, q, stream);
  else
    err = launch_stream<P>(a, packed, pwp, scale, w, out, nnz, M, K, N, T, q, k, bm, group_t,
                           stream);
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

// The grid of the three fused kernels at (M, N): out = {blocks along M,
// blocks along N, rows a tile, columns a tile}. Returns 0.
int phi_fused_grid(long long M, long long N, long long* out) {
  const dim3 g = fused_grid(M, static_cast<int>(N));
  out[0] = g.x;
  out[1] = g.y;
  out[2] = BM;
  out[3] = SBN;
  return 0;
}

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

// Shared memory of one block of the first kernel (and of its prefetching
// variant), in bytes, at T partitions: the match tile, the row counters and
// the warps' residual lists; all dynamic.
long long phi_fused_smem_bytes(int T) {
  return static_cast<long long>(first_smem(T));
}

// Blocks of a fused kernel one SM holds (cudaOccupancy...), float32 bank:
// kernel 0 the first one and 1 the prefetching one, both at T partitions; 2
// the streaming one at (q, k, group_t) and N's cluster; a negative CUDA error
// code on failure.
int phi_fused_occupancy(int kernel, int q, int k, int group_t, int N, int T) {
  int n = 0;
  cudaError_t err;
  if (kernel == 0 || kernel == 1) {
    const size_t smem = first_smem(T);
    const void* fn = kernel == 0 ? reinterpret_cast<const void*>(phi_fused_kernel<float, false>)
                                 : reinterpret_cast<const void*>(phi_fused_kernel<float, true>);
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, smem);
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
