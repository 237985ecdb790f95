// Level-2 bucketed COO +-1 spmm for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/phi_spmm.py::l2_spmm_pallas (body _spmm_kernel), the
// third stage of the per-unit ("pallas") lowering. Its input is the L2
// residual as COO bucketed per M-block by ops.bucket_coo: for each of G
// blocks of bm rows, C entries (local row, column, sign), the block's real
// entries first in ascending (row, column) order, then sentinels (local row
// bm, sign 0) up to the per-block capacity C. With w (K, N) f32:
//
//   out[g*bm + r, n] = sum over the block's entries e with row r, in order,
//                      of w[col_e, n] * sign_e
//
// and rows with no entry are written as zeros, as the TPU kernel's one-hot
// contraction writes them; sentinel entries vanish.
//
// No floating-point atomics: the output is the same bits run to run. Each
// output is written once, its sum starting from 0 in entry order (__fadd_rn,
// --fmad=false), which is what the plain version's index_add_ does; so kernel
// and plain version agree bitwise on any weights, and on weights of a dyadic
// grid (every sum exact) the reference agrees too.
//
// What bounds it on an H100: the latency of the gathers, not their bytes. The
// VGG slice's weight-row segments total ~0.67 GB a batch, all served by the
// 50 MB L2 cache (every w fits), and each entry's segment depends on the
// entry's column, so a thread that walks entries one load at a time waits
// one L2 round trip per entry. The design attacks that from three sides:
//   * parallelism from rows, not M-blocks: a warp owns `rpw` consecutive rows
//     (1 to 16, chosen by the wrapper so that the grid holds thousands of
//     warps even at conv4's 512 rows) and a 128-column slice of the output;
//   * each lane owns 4 columns and loads them as one 16-byte float4 where
//     N % 4 == 0 (a warp reads a 512-byte weight-row segment per entry);
//     otherwise 4 strided scalars (the head has N = 10);
//   * the warp loads 32 entries' (row, column, sign) with one coalesced read,
//     broadcasts them by shuffles, and keeps AHEAD = 4 entries' weight loads
//     in flight ahead of their ordered adds. 58 registers leave 4 blocks (32
//     warps) an SM; 8 in flight took 78 registers, 3 blocks an SM, and
//     measured slower at every VGG GEMM, so the SM's warps, not one lane's
//     queue, hide the L2 latency.
// The warp finds its rows' entry range with a warp-cooperative search over
// the block's sorted local rows: 32 probes a round (a ballot counts the
// probes below the row), so ~4 rounds instead of ~16 dependent probes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;     // warps per block
constexpr int SLICE = 128;   // columns per warp: 4 per lane
constexpr int AHEAD = 4;     // entries whose weight loads are in flight

// First position in rows[0, n) whose value is >= v (rows ascend), found by the
// whole warp: each round probes 32 evenly spaced positions of the open range,
// and the ballot of "probe < v" (a prefix of lanes, since rows ascend) leaves
// a range 32x shorter. Returns the same value on every lane.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ rows, int n, int v,
                                                int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const bool below = p < hi && __ldg(rows + p) < v;
    const int cnt = __popc(__ballot_sync(0xffffffffu, below));
    const int next_lo = cnt ? lo + (cnt - 1) * step + 1 : lo;
    hi = min(hi, lo + cnt * step);
    lo = next_lo;
  }
  const int p = lo + lane;
  const bool below = p < hi && __ldg(rows + p) < v;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

// A lane's 4 columns of one weight row: col0 + 4*lane.. (VEC) or
// col0 + lane + 32*j (scalar); columns at or past N read as 0.
template <bool VEC>
__device__ __forceinline__ float4 load_cols(const float* __restrict__ wrow, int col0, int lane,
                                            int N) {
  if (VEC) {
    const int c = col0 + 4 * lane;
    return c < N ? __ldg(reinterpret_cast<const float4*>(wrow + c)) : make_float4(0, 0, 0, 0);
  }
  const int c = col0 + lane;
  return make_float4(c < N ? __ldg(wrow + c) : 0.f, c + 32 < N ? __ldg(wrow + c + 32) : 0.f,
                     c + 64 < N ? __ldg(wrow + c + 64) : 0.f,
                     c + 96 < N ? __ldg(wrow + c + 96) : 0.f);
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* __restrict__ orow, int col0, int lane, int N,
                                           float4 v) {
  if (VEC) {
    const int c = col0 + 4 * lane;
    if (c < N) *reinterpret_cast<float4*>(orow + c) = v;
    return;
  }
  const int c = col0 + lane;
  if (c < N) orow[c] = v.x;
  if (c + 32 < N) orow[c + 32] = v.y;
  if (c + 64 < N) orow[c + 64] = v.z;
  if (c + 96 < N) orow[c + 96] = v.w;
}

template <bool VEC>
__global__ void __launch_bounds__(32 * WARPS)
l2_spmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
               const int8_t* __restrict__ signs, const float* __restrict__ w,
               float* __restrict__ out, int G, int C, int bm, int N, int rpw) {
  const int lane = threadIdx.x & 31;
  const int groups = (bm + rpw - 1) / rpw;                   // row groups per M-block
  const long long wid = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (wid >= static_cast<long long>(G) * groups) return;    // the whole warp leaves
  const int g = static_cast<int>(wid / groups);
  const int r0 = static_cast<int>(wid % groups) * rpw;
  const int r1 = min(bm, r0 + rpw);
  const int col0 = blockIdx.y * SLICE;
  const long long base = static_cast<long long>(g) * C;
  const int* brows = rows + base;
  const int* bcols = cols + base;
  const int8_t* bsigns = signs + base;
  float* dst = out + static_cast<long long>(g) * bm * N;

  const int e0 = warp_lower_bound(brows, C, r0, lane);
  const int e1 = warp_lower_bound(brows, C, r1, lane);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int row = r0;
  for (int e = e0; e < e1; e += 32) {
    const int n_here = min(32, e1 - e);
    int my_r = r1, my_c = 0, my_s = 0;
    if (lane < n_here) {
      my_r = __ldg(brows + e + lane);
      my_c = __ldg(bcols + e + lane);
      my_s = __ldg(bsigns + e + lane);
    }
    for (int k = 0; k < n_here; k += AHEAD) {
      int r[AHEAD];
      float4 v[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {                     // loads first: AHEAD in flight
        r[u] = __shfl_sync(0xffffffffu, my_r, (k + u) & 31);
        const int c = __shfl_sync(0xffffffffu, my_c, (k + u) & 31);
        const float s = static_cast<float>(__shfl_sync(0xffffffffu, my_s, (k + u) & 31));
        if (k + u < n_here) {
          const float4 x = load_cols<VEC>(w + static_cast<long long>(c) * N, col0, lane, N);
          v[u] = make_float4(__fmul_rn(x.x, s), __fmul_rn(x.y, s), __fmul_rn(x.z, s),
                             __fmul_rn(x.w, s));
        } else {
          r[u] = r1;
          v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {                     // then the adds, in entry order
        if (r[u] >= r1) break;                              // warp-uniform
        if (r[u] != row) {                                  // leave the row: write it
          store_cols<VEC>(dst + static_cast<long long>(row) * N, col0, lane, N, acc);
          for (++row; row < r[u]; ++row)                    // rows without entries
            store_cols<VEC>(dst + static_cast<long long>(row) * N, col0, lane, N,
                            make_float4(0.f, 0.f, 0.f, 0.f));
          acc = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        acc.x = __fadd_rn(acc.x, v[u].x);
        acc.y = __fadd_rn(acc.y, v[u].y);
        acc.z = __fadd_rn(acc.z, v[u].z);
        acc.w = __fadd_rn(acc.w, v[u].w);
      }
    }
  }
  store_cols<VEC>(dst + static_cast<long long>(row) * N, col0, lane, N, acc);
  for (++row; row < r1; ++row)
    store_cols<VEC>(dst + static_cast<long long>(row) * N, col0, lane, N,
                    make_float4(0.f, 0.f, 0.f, 0.f));
}

}  // namespace

// Blocks of the grid: WARPS warps a block, one a group of rpw rows of an
// M-block.
inline long long spmm_blocks(long long G, long long bm, long long rpw) {
  const long long warps = G * ((bm + rpw - 1) / rpw);
  return (warps + WARPS - 1) / WARPS;
}

extern "C" {

// The launch grid: out = {blocks, column slices, warps a block, columns a
// slice}. Returns 0.
int l2_spmm_grid(long long G, long long bm, long long N, long long rpw, long long* out) {
  out[0] = spmm_blocks(G, bm, rpw);
  out[1] = (N + SLICE - 1) / SLICE;
  out[2] = WARPS;
  out[3] = SLICE;
  return 0;
}

// rows/cols (G, C) int32, signs (G, C) int8, w (K, N) f32 -> out (G*bm, N) f32;
// rpw rows per warp; vec: 1 for float4 columns (N % 4 == 0, w and out 16-byte
// aligned), 0 for scalar ones. Returns cudaGetLastError() after the launch
// (0 on success).
int l2_spmm_launch(const int* rows, const int* cols, const int8_t* signs, const float* w,
                   float* out, int G, int C, int bm, int N, int rpw, int vec, void* stream) {
  if (G < 1 || C < 1 || bm < 1 || N < 1 || rpw < 1 || (N + SLICE - 1) / SLICE > 65535 ||
      (vec && N % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = spmm_blocks(G, bm, rpw);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), (N + SLICE - 1) / SLICE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    l2_spmm_kernel<true><<<grid, 32 * WARPS, 0, s>>>(rows, cols, signs, w, out, G, C, bm, N, rpw);
  else
    l2_spmm_kernel<false><<<grid, 32 * WARPS, 0, s>>>(rows, cols, signs, w, out, G, C, bm, N,
                                                      rpw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
