// LIF neuron update for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/lif.py::lif_pallas (body _lif_kernel):
//   v_int = v*decay + x;  s = v_int >= threshold;
//   v'    = hard: v_int*(1-s)   soft: v_int - threshold*s
// and adds the time loop that repro/snn/lif.py::lif_sequence runs around it:
// one thread per neuron keeps v in a register across the T steps and writes
// only the (T, n) spikes, so the membrane state never reaches device memory.
//
// What bounds it on an H100: bytes (8 bytes moved per neuron-step against 3
// floating-point operations). Design: grid-stride loops with neighbouring
// threads on neighbouring neurons, so each time step's row is read and
// written in coalesced segments. Every add and multiply is __fadd_rn /
// __fmul_rn (and the file is built with --fmad=false) so the result matches
// the plain version's separately rounded v*decay + x bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

__device__ __forceinline__ float reset_v(float v_int, float s, float threshold, int soft) {
  return soft ? __fsub_rn(v_int, __fmul_rn(threshold, s)) : __fmul_rn(v_int, 1.f - s);
}

__global__ void lif_step_kernel(const float* __restrict__ v, const float* __restrict__ x,
                                float* __restrict__ spike, float* __restrict__ v_out,
                                long long n, float decay, float threshold, int soft) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float v_int = __fadd_rn(__fmul_rn(v[i], decay), x[i]);
    const float s = v_int >= threshold ? 1.f : 0.f;
    spike[i] = s;
    v_out[i] = reset_v(v_int, s, threshold, soft);
  }
}

__global__ void lif_sequence_kernel(const float* __restrict__ x, float* __restrict__ spikes,
                                    int T, long long n, float decay, float threshold,
                                    int soft) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float v = 0.f;
    for (int t = 0; t < T; ++t) {
      const long long at = static_cast<long long>(t) * n + i;
      const float v_int = __fadd_rn(__fmul_rn(v, decay), x[at]);
      const float s = v_int >= threshold ? 1.f : 0.f;
      spikes[at] = s;
      v = reset_v(v_int, s, threshold, soft);
    }
  }
}

unsigned grid_for(long long n) {
  const long long blocks = (n + THREADS - 1) / THREADS;
  return static_cast<unsigned>(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// The launch grid for n neurons: out = {blocks, threads a block}; a block
// walks the neurons with a grid-stride loop. Returns 0.
int lif_grid(long long n, long long* out) {
  out[0] = grid_for(n);
  out[1] = THREADS;
  return 0;
}

// Both return cudaGetLastError() after the launch (0 on success).
int lif_step_launch(const float* v, const float* x, float* spike, float* v_out, long long n,
                    float decay, float threshold, int soft, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lif_step_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v, x, spike, v_out, n, decay, threshold, soft);
  return static_cast<int>(cudaGetLastError());
}

int lif_sequence_launch(const float* x, float* spikes, int T, long long n, float decay,
                        float threshold, int soft, void* stream) {
  if (n <= 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  lif_sequence_kernel<<<grid_for(n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, spikes, T, n, decay, threshold, soft);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
