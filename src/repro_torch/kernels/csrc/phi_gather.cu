// Level-1 PWP gather and K-tile reduction for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/phi_gather.py::l1_gather_pallas (body
// _gather_kernel), the second stage of the per-unit ("pallas") lowering:
//
//   out[m, n] = sum over t = 0..T-1, in that order, of pwp[t, idx[m, t], n]
//
// with idx (M, T) int32 in [0, q] (q = the all-zero "no pattern" slot; the
// wrapper refuses any other index, so the kernel reads no bank row out of
// range) and
// pwp (T, q+1, N) in f32 or bf16 (widened exactly to f32). The TPU kernel keeps
// the output tile in VMEM across a T-innermost grid, zeroes it at t = 0 and
// adds each partition's rows; here each thread keeps one output element in a
// register, starts from 0 and adds the T gathered values in ascending t with
// __fadd_rn (the file is built with --fmad=false), then writes it once. That
// is the reference's order of sums, so kernel, plain version and reference
// agree bitwise for any f32 or bf16 bank, not only on dyadic data. The TPU's
// two retrieval modes (a one-hot matmul, "mxu", and a vector gather, "take")
// select the same values; on the card both are this row gather.
//
// What bounds it on an H100: bytes. Each output element needs T gathered
// bank values and T indices; what must move is idx once, the bank rows the
// indices name and the output once. Design: a block of 8 rows x 32 columns,
// a warp per row, so each index load is one address for the whole warp
// (a broadcast) and each gathered PWP row segment is one coalesced 128-byte
// read. The banks of the VGG slice's first three GEMMs fit the 50 MB L2
// cache, so repeated rows are served from there. Ragged M and N are masked.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;  // columns per block: one per lane
constexpr int ROWS = 8;   // rows per block: one per warp

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename P>
__global__ void __launch_bounds__(COLS * ROWS)
l1_gather_kernel(const int* __restrict__ idx, const P* __restrict__ pwp,
                 float* __restrict__ out, long long M, int N, int T, int q1) {
  const long long m = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.y;
  const int n = blockIdx.y * COLS + threadIdx.x;
  if (m >= M || n >= N) return;
  const int* row = idx + m * T;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    const int i = __ldg(row + t);
    acc = __fadd_rn(acc, to_f32(pwp[(static_cast<long long>(t) * q1 + i) * N + n]));
  }
  out[m * N + n] = acc;
}

}  // namespace

extern "C" {

// pwp_dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success).
int l1_gather_launch(const int* idx, const void* pwp, int pwp_dtype, float* out, long long M,
                     int N, int T, int q1, void* stream) {
  if (M < 1 || N < 1 || T < 1 || q1 < 1 || (N + COLS - 1) / COLS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + ROWS - 1) / ROWS), (N + COLS - 1) / COLS);
  const dim3 block(COLS, ROWS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pwp_dtype) {
    case 0:
      l1_gather_kernel<float><<<grid, block, 0, s>>>(idx, static_cast<const float*>(pwp), out,
                                                     M, N, T, q1);
      break;
    case 1:
      l1_gather_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          idx, static_cast<const __nv_bfloat16*>(pwp), out, M, N, T, q1);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
