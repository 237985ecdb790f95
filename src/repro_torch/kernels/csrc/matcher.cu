// Standalone Phi pattern matcher for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/matcher.py::matcher_pallas (body _matcher_kernel),
// the first stage of the per-unit ("pallas") lowering. For binary
// activations a (M, K) f32 and per-partition patterns given bit-packed as one
// word per pattern (T, q) (bit j = pattern element j; phi_fused.cu's
// convention, so PhiState.packed serves both), K = T*k:
//
//   per row m and K-partition t:
//     bits  = the k activation bits of a[m, t*k : (t+1)*k], packed in a word
//     H_i   = popc(bits ^ p_i)          (= |a|+|p|-2a.p exactly for binary a)
//     best  = first argmin_i H_i;  use = H_best < popc(bits)   (strict rule)
//     idx[m, t]              = use ? best : q                  (int32)
//     residual[m, t*k + j]   = bit_j(a) - (use ? bit_j(p_best) : 0)   (int8)
//
// Everything is an integer, so the kernel is bitwise equal to its plain
// version (assign_patterns) and to the reference on any binary input.
//
// What bounds it on an H100: the bytes are a (4 per element read), the
// residual (1 per element written) and idx (4 per row partition), about 99 MB
// at the VGG slice's conv1 (0.03 ms at 3.35 TB/s); the work is q 64-bit
// popcounts and compares per (row, partition), 151 M at conv1, on the CUDA
// cores' integer pipes. Design: one thread per (row, partition), a block of
// 32 rows x 8 partitions, so a warp holds 32 rows of one partition and every
// pattern word it loads is the same address for all 32 lanes (one broadcast
// load, cached in L1). Each thread reads its k activations as float4s and
// writes its k residual bytes as 32-bit words where alignment allows.
// Nothing is staged in shared memory, so any q runs. Ragged M and T edges are
// masked; nothing is padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;   // rows per block: one per lane
constexpr int PARTS = 8;   // K-partitions per block: one per warp

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

// One residual byte: +1 where the row has a bit the pattern lacks, -1 where
// the pattern has a bit the row lacks, else 0.
__device__ __forceinline__ uint32_t residual_byte(unsigned long long plus,
                                                  unsigned long long minus, int j) {
  if ((plus >> j) & 1ull) return 0x01u;
  if ((minus >> j) & 1ull) return 0xFFu;
  return 0u;
}

__global__ void __launch_bounds__(ROWS * PARTS)
matcher_kernel(const float* __restrict__ a, const unsigned long long* __restrict__ packed,
               int* __restrict__ idx, int8_t* __restrict__ residual, long long M, int K,
               int T, int q, int k) {
  const long long m = static_cast<long long>(blockIdx.x) * ROWS + threadIdx.x;
  const int t = blockIdx.y * PARTS + threadIdx.y;
  if (m >= M || t >= T) return;
  const unsigned long long bits = row_bits(a + m * K + static_cast<long long>(t) * k, k);
  const unsigned long long* bank = packed + static_cast<long long>(t) * q;
  int best = 0;
  int best_h = __popcll(bits ^ __ldg(bank));
  for (int i = 1; i < q; ++i) {
    const int h = __popcll(bits ^ __ldg(bank + i));
    if (h < best_h) {                                 // first index wins ties
      best_h = h;
      best = i;
    }
  }
  const bool use = best_h < __popcll(bits);
  idx[m * T + t] = use ? best : q;
  const unsigned long long chosen = use ? __ldg(bank + best) : 0ull;
  const unsigned long long plus = bits & ~chosen, minus = chosen & ~bits;
  int8_t* dst = residual + m * K + static_cast<long long>(t) * k;
  if ((k & 3) == 0 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
    for (int j = 0; j < k; j += 4) {
      uint32_t word = 0u;
      for (int b = 0; b < 4; ++b) word |= residual_byte(plus, minus, j + b) << (8 * b);
      *reinterpret_cast<uint32_t*>(dst + j) = word;
    }
  } else {
    for (int j = 0; j < k; ++j)
      dst[j] = static_cast<int8_t>(static_cast<uint8_t>(residual_byte(plus, minus, j)));
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 on success).
int matcher_launch(const float* a, const unsigned long long* packed, int* idx,
                   int8_t* residual, long long M, int K, int T, int q, int k, void* stream) {
  if (M < 1 || k < 1 || k > 64 || q < 1 || T < 1 || K != T * k ||
      (T + PARTS - 1) / PARTS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((M + ROWS - 1) / ROWS), (T + PARTS - 1) / PARTS);
  matcher_kernel<<<grid, dim3(ROWS, PARTS), 0, static_cast<cudaStream_t>(stream)>>>(
      a, packed, idx, residual, M, K, T, q, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
