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
// No floating-point atomics: the output is the same bits run to run. The TPU
// kernel scatters with a one-hot matmul over the whole block; here each warp
// owns a contiguous range of the block's rows, finds its entries by binary
// search over the block's sorted local rows (the sentinels, = bm, sort last),
// and each lane owns one output column: it walks the warp's entries in order
// with its sum in a register, writes a row when the walk leaves it and zeros
// for rows it skips. Each output is written once, its sum starting from 0 in
// entry order (__fadd_rn, --fmad=false), which is what the plain version's
// index_add_ does on the CPU; on weights of a dyadic grid every sum is exact,
// so kernel, plain version and reference agree bitwise whatever their order.
//
// What bounds it on an H100: the gathers. Each entry reads one weight row
// segment per 32 columns (a coalesced 128-byte read, shared by the lanes)
// plus its index triple (one address for the whole warp). The walk is a chain
// of dependent adds, so entries are loaded four at a time ahead of the adds.
// Blocks: one per (M-block, 32 columns), 8 warps each.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;   // columns per block: one per lane
constexpr int WARPS = 8;   // warps per block, each over a contiguous row range
constexpr int AHEAD = 4;   // entries loaded ahead of their adds

// First position in rows[0, n) whose value is >= value (rows ascend).
__device__ __forceinline__ int lower_bound(const int* rows, int n, int value) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(rows + mid) < value) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(COLS * WARPS)
l2_spmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
               const int8_t* __restrict__ signs, const float* __restrict__ w,
               float* __restrict__ out, int C, int bm, int N) {
  const int n = blockIdx.y * COLS + threadIdx.x;
  if (n >= N) return;
  const long long base = static_cast<long long>(blockIdx.x) * C;
  const int* brows = rows + base;
  const int* bcols = cols + base;
  const int8_t* bsigns = signs + base;
  const int per_warp = (bm + WARPS - 1) / WARPS;
  const int r0 = min(bm, static_cast<int>(threadIdx.y) * per_warp);
  const int r1 = min(bm, r0 + per_warp);
  int e = lower_bound(brows, C, r0);
  const int e_end = lower_bound(brows, C, r1);
  float* dst = out + static_cast<long long>(blockIdx.x) * bm * N + n;
  float acc = 0.f;
  int row = r0;
  for (; e < e_end; e += AHEAD) {
    int r[AHEAD];
    float v[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      r[u] = e + u < e_end ? __ldg(brows + e + u) : r1;
      v[u] = e + u < e_end
                 ? __fmul_rn(__ldg(w + static_cast<long long>(__ldg(bcols + e + u)) * N + n),
                             static_cast<float>(__ldg(bsigns + e + u)))
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      if (r[u] >= r1) break;
      for (; row < r[u]; ++row) {                     // leave the row: write it
        dst[static_cast<long long>(row) * N] = acc;
        acc = 0.f;
      }
      acc = __fadd_rn(acc, v[u]);
    }
  }
  for (; row < r1; ++row) {
    dst[static_cast<long long>(row) * N] = acc;
    acc = 0.f;
  }
}

}  // namespace

extern "C" {

// rows/cols (G, C) int32, signs (G, C) int8, w (K, N) f32 -> out (G*bm, N) f32.
// Returns cudaGetLastError() after the launch (0 on success).
int l2_spmm_launch(const int* rows, const int* cols, const int8_t* signs, const float* w,
                   float* out, int G, int C, int bm, int N, void* stream) {
  if (G < 1 || C < 1 || bm < 1 || N < 1 || (N + COLS - 1) / COLS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, (N + COLS - 1) / COLS);
  l2_spmm_kernel<<<grid, dim3(COLS, WARPS), 0, static_cast<cudaStream_t>(stream)>>>(
      rows, cols, signs, w, out, C, bm, N);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
