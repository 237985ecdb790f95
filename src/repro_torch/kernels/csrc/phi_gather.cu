// Level-1 PWP gather and K-tile reduction for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/phi_gather.py::l1_gather_pallas (body
// _gather_kernel), the second stage of the per-unit ("pallas") lowering:
//
//   out[m, n] = sum over t = 0..T-1, in that order, of pwp[t, idx[m, t], n]
//
// with idx (M, T) int32 in [0, q] (q = the all-zero "no pattern" slot) and pwp
// (T, q+1, N) in f32 or bf16 (widened exactly to f32). Each output starts
// from 0 and adds its T gathered values in ascending t with __fadd_rn (the
// file is built with --fmad=false), as the TPU kernel's VMEM output tile
// accumulates; so kernel, plain version and reference agree bitwise for any
// f32 or bf16 bank, not only on dyadic data. The TPU's two retrieval modes (a
// one-hot matmul, "mxu", and a vector gather, "take") select the same values;
// on the card both are this gather. An index outside [0, q] reads no bank
// row: it sets *flag (when the caller passed one) and adds nothing; the
// wrapper then refuses the call.
//
// What bounds it on an H100: the gathered bytes, M*T*N*elem (~2.1 GB a VGG
// batch at f32), against the few (t, index) rows a batch names. The TPU kernel
// staged a (q+1, block_n) slab of pwp[t] in VMEM and served a block of rows
// from it. Here the L1 cache does that on demand: spike patterns are skewed,
// so a few rows of each partition take most matches, and the rows a block's
// warps name stay in the SM's L1 (up to 256 KB) while the rest come from the
// L2 cache. Staging the whole slab in shared memory with a cp.async ring (128
// to 512 rows a block) was built and measured slower at every VGG GEMM: it
// copies every row of the slab and waits at a barrier a partition. So the
// design keeps loads wide and many in flight:
//   * a warp owns one row and 128 columns, 4 a lane, loaded as one 16-byte
//     (f32) or 8-byte (bf16) vector where N % 4 == 0 and the bank is aligned,
//     one column a lane otherwise; a block holds 8 rows;
//   * each lane loads AHEAD = 8 partitions' indices (a broadcast within the
//     warp) and then their bank segments before it adds them in order, so 8
//     gathers are in flight per lane and 40 registers leave 6 blocks an SM.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;    // rows per block, one a warp
constexpr int AHEAD = 8;   // partitions whose loads are in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive bank values (16 bytes at f32, 8 at bf16), widened to f32.
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Block: ROWS rows (a warp each) x 32*VEC columns. VEC = 4 needs N % 4 == 0
// and an aligned bank; VEC = 1 takes any N.
template <typename P, int VEC>
__global__ void __launch_bounds__(32 * ROWS)
l1_gather_kernel(const int* __restrict__ idx, const P* __restrict__ pwp,
                 float* __restrict__ out, int* __restrict__ flag, long long M, int N, int T,
                 int q1) {
  const long long m = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.y;
  const int c = (blockIdx.y * 32 + threadIdx.x) * VEC;
  if (m >= M || c >= N) return;
  const int* row = idx + m * T;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  bool bad = false;
  for (int t0 = 0; t0 < T; t0 += AHEAD) {
    float4 v[AHEAD];
    bool use[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {                 // loads first: AHEAD in flight
      const int t = t0 + u;
      const int i = t < T ? __ldg(row + t) : 0;
      use[u] = t < T && static_cast<unsigned>(i) < static_cast<unsigned>(q1);
      bad |= t < T && !use[u];
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (use[u]) {
        const P* src = pwp + (static_cast<long long>(t) * q1 + i) * N + c;
        if (VEC == 4) v[u] = ldg4(src);
        else v[u].x = to_f32(*src);
      }
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {                 // then the adds, in ascending t
      if (!use[u]) continue;
      acc.x = __fadd_rn(acc.x, v[u].x);
      if (VEC == 4) {
        acc.y = __fadd_rn(acc.y, v[u].y);
        acc.z = __fadd_rn(acc.z, v[u].z);
        acc.w = __fadd_rn(acc.w, v[u].w);
      }
    }
  }
  if (bad && flag) *flag = 1;
  float* dst = out + m * N + c;
  if (VEC == 4) *reinterpret_cast<float4*>(dst) = acc;
  else *dst = acc.x;
}

template <typename P>
int launch(const int* idx, const P* pwp, float* out, int* flag, long long M, int N, int T,
           int q1, int vec, cudaStream_t s) {
  const dim3 block(32, ROWS);
  const unsigned gx = static_cast<unsigned>((M + ROWS - 1) / ROWS);
  if (vec)
    l1_gather_kernel<P, 4><<<dim3(gx, (N + 127) / 128), block, 0, s>>>(idx, pwp, out, flag, M,
                                                                       N, T, q1);
  else
    l1_gather_kernel<P, 1><<<dim3(gx, (N + 31) / 32), block, 0, s>>>(idx, pwp, out, flag, M,
                                                                     N, T, q1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// pwp_dtype: 0 = float32, 1 = bfloat16. vec: 1 for 4 columns a lane (N % 4 ==
// 0, bank 16-byte aligned). flag: an int32 on the device set to 1 where an
// index lies outside [0, q1), or null. Returns cudaGetLastError() after the
// launch (0 on success).
int l1_gather_launch(const int* idx, const void* pwp, int pwp_dtype, float* out, int* flag,
                     long long M, int N, int T, int q1, int vec, void* stream) {
  if (M < 1 || N < 1 || T < 1 || q1 < 1 || (N + 31) / 32 > 65535 || (vec && N % 4) ||
      (M + ROWS - 1) / ROWS > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pwp_dtype) {
    case 0:
      return launch(idx, static_cast<const float*>(pwp), out, flag, M, N, T, q1, vec, s);
    case 1:
      return launch(idx, static_cast<const __nv_bfloat16*>(pwp), out, flag, M, N, T, q1, vec,
                    s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
