// Standalone Phi pattern matcher for Hopper (sm_90a), CUDA C++.
//
// Replaces repro/kernels/matcher.py::matcher_pallas (body _matcher_kernel),
// the first stage of the per-unit ("pallas") lowering. For binary
// activations a (M, K) f32 and per-partition patterns given bit-packed as one
// word per pattern (T, q) (bit j = pattern element j; phi_fused.cu's
// convention, so PhiState.packed serves both), K = T*k:
//
//   per row m and K-partition t, with x the k bits of a[m, t*k : (t+1)*k]:
//     H_i  = |x| + |p_i| - 2 x.p_i          (the Hamming distance)
//     best = first argmin_i H_i;  use = H_best < |x|       (strict rule)
//     idx[m, t]            = use ? best : q                  (int32)
//     residual[m, t*k + j] = x_j - (use ? p_best,j : 0)      (int8)
//
// Everything is an integer, so the kernel is bitwise equal to its plain
// version (assign_patterns) and to the reference on any binary input.
//
// What bounds it on an H100: the bytes are a (4 per element read), the
// residual (1 per element written), idx and the bank: 187 MB a VGG batch,
// 0.056 ms at 3.35 TB/s. The work is M*T*q candidates, 283 M a batch. Scored
// with popcounts (the design this file replaced: a thread per row and
// partition, popc(x ^ p_i) per candidate, the bank read through L1) that
// work alone needs 0.076 ms at the SMs' 16 popcounts a clock. So the score is
// taken on the int8 tensor cores, as the TPU kernel takes it on its MXU:
// x.p_i for 16 rows by 8 patterns is one mma.sync.m16n8k16 (k <= 16;
// m16n8k32 for k <= 32, two for k <= 64) over 0/1 bytes, exact in int32.
// What is left per candidate is one integer multiply-add and one min on a
// packed key
//   key = ((|p_i| - 2 x.p_i + 64) << 16) | i,
// whose least value is the first argmin (|x| is the same for every
// candidate of a row; use <=> |p| - 2 x.p < 0). Taken apart on the card
// (kernels/phases.py), the same layout scored by popcounts instead is
// 0.03-0.09 ms a batch slower, and the replaced kernel spent 2-4x its share
// of the bound in each of its three phases (strided reads, the popcount
// loop, byte-wise residual writes).
//
// Design: a block of 256 threads owns 64 rows and the `tp` partitions of one
// partition block (matcher_plan: as many as 32 KB of shared memory holds,
// evened out over T), and makes one round trip to device memory:
//  1. Row bits. Each thread issues its float4 loads of the block's row
//     segments, LOADS at a time (32 floats and a __ballot_sync a word where
//     the segment is not 16-byte aligned); while the first are in flight the
//     block stages the bank. 8 lanes then turn 32 columns into one 32-bit word (a
//     shuffle tree), kept in shared memory; a partition's k bits are a
//     funnel shift across at most three words, so any k <= 64 and any
//     K = T*k work (k = 5 straddles words).
//  2. The bank, a chunk at a time (`chunk` patterns, multiples of 8; one
//     chunk where the bank fits, so any q >= 1 runs): 0/1 bytes in the
//     fragment order of the mma's B operand, beside each pattern's
//     (|p| + 64) << 16 | i.
//  3. Match: a warp task is 16 rows of one partition against every
//     8-pattern tile of the chunk, the min taken over the accumulator
//     fragments, then across the 4 lanes that share a row. Chunks fold into
//     a 64-bit (value, index) key a row and partition, so ties still go to
//     the lowest index across chunks.
//  4. Write, from the same lanes: idx, and the residual as 4-byte words, each
//     lane's four columns from its A fragment (the row's bytes) and the
//     chosen pattern's staged B-fragment bytes (+1 where only the row has
//     the bit, -1 where only the pattern has it).
// Ragged M and the last partition block are masked; nothing is padded in
// device memory. Kept against variants measured slower on the card: blocks
// that walk many row tiles (the bank staged once; the next tile's loads in
// flight, by cp.async into shared memory or in registers), the bank copied
// by cp.async and expanded after a barrier, the key taken from the mma's
// accumulator input (64 patterns at a time).
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 64;             // rows a block: four 16-row mma tiles
constexpr int SMEM_BUDGET = 32768;   // shared memory a block
// Row loads in flight a thread (float4) or a warp (float) a round: 5 keep
// the kernel at 48 registers and 5 blocks an SM (conv1's rows then take two
// rounds), which measured faster than one round of 10 at 64 registers and
// 4 blocks.
constexpr int LOADS = 5;
// Folded key of a row and partition no pattern beats: value 0 (H = |x|)
// minus one, so only |p| - 2 x.p < 0 wins.
constexpr unsigned long long NO_MATCH = (64ull << 32) - 1ull;

__host__ __device__ constexpr int cdiv(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}

// Bytes of a pattern's fragment row: k padded to the mma's depth.
__host__ __device__ constexpr int padded_k(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : 64; }

// Words of a row's bitstring in shared memory: a partition's funnel shift
// reads two words past its first.
__host__ __device__ constexpr int row_words(int tp, int k) {
  return cdiv(static_cast<long long>(tp) * k, 32) + 2;
}

__host__ __device__ constexpr int smem_bytes(int tp, int chunk, int k) {
  return ROWS * tp * 8 + tp * chunk * (padded_k(k) + 4) + ROWS * row_words(tp, k) * 4;
}

// The launch plan: the bank chunk (all of q where it fits, in multiples of
// 8 patterns), then the most partitions a block that stay in SMEM_BUDGET,
// evened out over the partition blocks T needs.
void plan(int T, int q, int k, int* tp_out, int* chunk_out, int* smem_out) {
  const int fit = (SMEM_BUDGET - smem_bytes(1, 0, k)) / (padded_k(k) + 4) / 8 * 8;
  const int chunk = fit < 8 * cdiv(q, 8) ? fit : 8 * cdiv(q, 8);
  int tp = 1;
  while (tp < T && smem_bytes(tp + 1, chunk, k) <= SMEM_BUDGET) ++tp;
  tp = cdiv(T, cdiv(T, tp));
  *tp_out = tp;
  *chunk_out = chunk;
  *smem_out = smem_bytes(tp, chunk, k);
}

// n / d for the block's few runtime divisors, as a multiply: exact while
// n * d < 2^32, which the plan's shared-memory budget keeps (n < 2^16).
struct Div {
  unsigned long long m;
  __device__ explicit Div(int d) : m((0x100000000ull + d - 1) / d) {}
  __device__ int operator()(int n) const {
    return static_cast<int>((static_cast<unsigned long long>(n) * m) >> 32);
  }
};

// 4 bits -> 4 bytes of 0/1 (the shifted copies of x do not overlap).
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  return (x * 0x00204081u) & 0x01010101u;
}

// 64 bits of a bitstring from bit o on.
__device__ __forceinline__ unsigned long long bits_at(const uint32_t* s, int o) {
  const int w = o >> 5, sh = o & 31;
  const uint32_t lo = __funnelshift_r(s[w], s[w + 1], sh);
  const uint32_t hi = __funnelshift_r(s[w + 1], s[w + 2], sh);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Four residual bytes from four 0/1 bytes of the row (x) and of the pattern
// (p): 0x01 where only x is set, 0xFF where only p is, else 0.
__device__ __forceinline__ uint32_t residual_bytes(uint32_t x, uint32_t p) {
  return (x & ~p) | (p & ~x) * 0xFFu;
}

// d = A (16 rows x KP, 0/1 bytes) . B (KP x 8 patterns): the A fragment is
// KP/8 registers, the B fragment KP/16 (PTX ISA, mma.m16n8k16/k32 .s8).
template <int KP>
__device__ __forceinline__ void dot_tile(int (&d)[4], const uint32_t (&a)[KP / 8],
                                         const uint32_t (&b)[KP / 16]) {
  d[0] = d[1] = d[2] = d[3] = 0;
  if constexpr (KP == 16) {
    asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
        "{%0,%1,%2,%3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(b[0]));
  } else {
#pragma unroll
    for (int h = 0; h < KP / 32; ++h)
      asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
          "{%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
          : "r"(a[4 * h]), "r"(a[4 * h + 1]), "r"(a[4 * h + 2]), "r"(a[4 * h + 3]),
            "r"(b[2 * h]), "r"(b[2 * h + 1]));
  }
}

template <int KP>
__global__ void __launch_bounds__(THREADS, 5)
matcher_kernel(const float* __restrict__ a, const unsigned long long* __restrict__ packed,
               int* __restrict__ idx, int8_t* __restrict__ residual, long long M, int K,
               int T, int q, int k, int tp, int chunk, int n_pb, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bs = row_words(tp, k);
  unsigned long long* best = reinterpret_cast<unsigned long long*>(smem);   // [ROWS][tp]
  uint32_t* bank = reinterpret_cast<uint32_t*>(best + ROWS * tp);   // [tp][chunk][4][KP/16]
  int* pkey = reinterpret_cast<int*>(bank + tp * chunk * (KP / 4));  // [tp][chunk]
  uint32_t* xbits = reinterpret_cast<uint32_t*>(pkey + tp * chunk);  // [ROWS][bs]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x / n_pb) * ROWS;
  const int t0 = (blockIdx.x % n_pb) * tp;
  const int tn = min(tp, T - t0);   // this block's partitions
  const int len = tn * k;           // columns of its row segment
  const int nw = cdiv(len, 32);     // words of a row's bits
  const unsigned long long kmask = k == 64 ? ~0ull : (1ull << k) - 1ull;
  const float* seg = a + static_cast<long long>(t0) * k;

  // Stage the chunk of the bank from pattern `base` on: 0/1 bytes in the
  // mma's B-fragment order, and each pattern's key (|p| + 64) << 16 | j.
  auto stage = [&](int base) {
    const int nq8 = 8 * cdiv(min(chunk, q - base), 8);
    const Div by_nq8(nq8);
    for (int i = tid; i < tn * nq8; i += THREADS) {
      const int t = by_nq8(i), j = i - t * nq8;
      unsigned long long p = 0ull;
      int key = INT_MAX;   // padding past q: never the least
      if (base + j < q) {
        const long long gi = static_cast<long long>(t0 + t) * q + base + j;
        p = (KP <= 32 ? reinterpret_cast<const uint32_t*>(packed)[2 * gi] : packed[gi]) & kmask;
        key = ((__popcll(p) + 64) << 16) | j;
      }
      // word f*(KP/16) + jj holds bits 4f + 16jj .. +3 as bytes: lane tig = f's
      // B fragment is its KP/16 words
      uint4* dst = reinterpret_cast<uint4*>(bank + (t * chunk + j) * (KP / 4));
#pragma unroll
      for (int v = 0; v < KP / 16; ++v) {
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = (4 * v + e) / (KP / 16), jj = (4 * v + e) % (KP / 16);
          w[e] = spread4(static_cast<uint32_t>(p >> (4 * f + 16 * jj)) & 0xFu);
        }
        dst[v] = make_uint4(w[0], w[1], w[2], w[3]);
      }
      pkey[t * chunk + j] = key;
    }
  };

  for (int i = tid; i < ROWS * tp; i += THREADS) best[i] = NO_MATCH;

  // ---- 1-2. row bits: coalesced loads, one 32-bit word a 32 columns; the
  // bank's first chunk is staged while the first round of loads is in flight
  if (vec) {
    // float4 slots a row, padded to whole words: lanes 8w..8w+7 of a warp
    // hold the 32 columns of one word, 4 bits each
    const int per_row = 8 * nw, items = ROWS * per_row;
    const Div by_row(per_row);
    for (int f0 = 0; f0 < items; f0 += THREADS * LOADS) {
      float4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int f = f0 + u * THREADS + tid, r = by_row(f), c = (f - r * per_row) * 4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f < items && m0 + r < M && c < len)
          v[u] = __ldcs(reinterpret_cast<const float4*>(seg + (m0 + r) * K + c));
      }
      if (f0 == 0) stage(0);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        uint32_t x = ((v[u].x != 0.f ? 1u : 0u) | (v[u].y != 0.f ? 2u : 0u) |
                      (v[u].z != 0.f ? 4u : 0u) | (v[u].w != 0.f ? 8u : 0u)) << (4 * (lane & 7));
        x |= __shfl_xor_sync(0xffffffffu, x, 1);
        x |= __shfl_xor_sync(0xffffffffu, x, 2);
        x |= __shfl_xor_sync(0xffffffffu, x, 4);
        const int f = f0 + u * THREADS + tid, r = by_row(f);
        if ((lane & 7) == 0 && f < items) xbits[r * bs + (f - r * per_row) / 8] = x;
      }
    }
  } else {
    // a warp a word: 32 floats and a ballot
    const int items = ROWS * nw;
    const Div by_nw(nw);
    for (int i0 = warp * LOADS; i0 < items; i0 += WARPS * LOADS) {
      float v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u, r = by_nw(i), c = (i - r * nw) * 32 + lane;
        v[u] = i < items && m0 + r < M && c < len ? __ldcs(seg + (m0 + r) * K + c) : 0.f;
      }
      if (i0 == warp * LOADS) stage(0);
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const uint32_t x = __ballot_sync(0xffffffffu, v[u] != 0.f);
        const int i = i0 + u, r = by_nw(i);
        if (lane == u && i < items) xbits[r * bs + i - r * nw] = x;
      }
    }
    if (warp * LOADS >= items) stage(0);   // a warp with no row words still stages its share
  }

  // ---- 3-4. match a chunk of the bank at a time, then write ---------------
  for (int base = 0;;) {
    __syncthreads();   // the row bits and the chunk are in
    const int nq8 = 8 * cdiv(min(chunk, q - base), 8);
    const bool last = q - base <= chunk;
    // a warp task: 16 rows (one mma tile) of one partition, all the chunk
    for (int task = warp; task < (ROWS / 16) * tn; task += WARPS) {
      const int t = task / (ROWS / 16), r = (task % (ROWS / 16)) * 16 + g;
      const unsigned long long x0 = bits_at(xbits + r * bs, t * k) & kmask;
      const unsigned long long x8 = bits_at(xbits + (r + 8) * bs, t * k) & kmask;
      uint32_t af[KP / 8];
#pragma unroll
      for (int jj = 0; jj < KP / 16; ++jj) {
        af[2 * jj] = spread4(static_cast<uint32_t>(x0 >> (4 * tig + 16 * jj)) & 0xFu);
        af[2 * jj + 1] = spread4(static_cast<uint32_t>(x8 >> (4 * tig + 16 * jj)) & 0xFu);
      }
      const uint32_t* bp = bank + (t * chunk + g) * (KP / 4) + tig * (KP / 16);
      const int* kp = pkey + t * chunk + 2 * tig;
      int k0 = INT_MAX, k8 = INT_MAX;
#pragma unroll 2
      for (int n8 = 0; n8 < nq8; n8 += 8) {
        uint32_t bf[KP / 16];
        if constexpr (KP == 16) {
          bf[0] = bp[n8 * (KP / 4)];
        } else if constexpr (KP == 32) {
          const uint2 b2 = *reinterpret_cast<const uint2*>(bp + n8 * (KP / 4));
          bf[0] = b2.x;
          bf[1] = b2.y;
        } else {
          const uint4 b4 = *reinterpret_cast<const uint4*>(bp + n8 * (KP / 4));
          bf[0] = b4.x;
          bf[1] = b4.y;
          bf[2] = b4.z;
          bf[3] = b4.w;
        }
        const int2 pk = *reinterpret_cast<const int2*>(kp + n8);
        int d[4];
        dot_tile<KP>(d, af, bf);
        k0 = min(k0, min(pk.x - (d[0] << 17), pk.y - (d[1] << 17)));
        k8 = min(k8, min(pk.x - (d[2] << 17), pk.y - (d[3] << 17)));
      }
      // every lane of the 4 that share a row gets the row's least key
      k0 = min(k0, __shfl_xor_sync(0xffffffffu, k0, 1));
      k0 = min(k0, __shfl_xor_sync(0xffffffffu, k0, 2));
      k8 = min(k8, __shfl_xor_sync(0xffffffffu, k8, 1));
      k8 = min(k8, __shfl_xor_sync(0xffffffffu, k8, 2));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = h ? k8 : k0, rr = r + 8 * h;
        // the chunk's (value, index) as one 64-bit key, folded into the
        // earlier chunks' (ties to the lowest index across chunks)
        unsigned long long folded = (static_cast<unsigned long long>(key >> 16) << 32) |
                                    static_cast<unsigned long long>(base + (key & 0xFFFF));
        const unsigned long long prev = best[rr * tp + t];
        if (prev < folded) folded = prev;
        if (!last) {
          if (tig == 0) best[rr * tp + t] = folded;
          continue;
        }
        const long long m = m0 + rr;
        if (m >= M) continue;
        const int chosen = folded == NO_MATCH ? q : static_cast<int>(folded & 0xFFFFFFFFull);
        if (tig == 0) idx[m * T + t0 + t] = chosen;
        // the chosen pattern's bytes at this lane's columns 4*tig + 16*jj ..
        // +3: its B-fragment words in the staged chunk, or (a winner from an
        // earlier chunk) its packed word
        const bool staged = chosen >= base && chosen < q;
        const unsigned long long p = chosen < q && !staged
            ? __ldg(packed + static_cast<long long>(t0 + t) * q + chosen) & kmask : 0ull;
        const uint32_t* pb = bank + (t * chunk + (staged ? chosen - base : 0)) * (KP / 4)
                             + tig * (KP / 16);
        int8_t* dst = residual + m * K + static_cast<long long>(t0 + t) * k;
#pragma unroll
        for (int jj = 0; jj < KP / 16; ++jj) {
          const int c = 4 * tig + 16 * jj;
          if (c >= k) break;
          const uint32_t word = residual_bytes(
              af[2 * jj + h], staged ? pb[jj] : spread4(static_cast<uint32_t>(p >> c) & 0xFu));
          if (c + 4 <= k && (reinterpret_cast<uintptr_t>(dst + c) & 3) == 0) {
            *reinterpret_cast<uint32_t*>(dst + c) = word;
          } else {
            for (int e = 0; e < 4 && c + e < k; ++e)
              dst[c + e] = static_cast<int8_t>((word >> (8 * e)) & 0xFFu);
          }
        }
      }
    }
    base += chunk;
    if (base >= q) break;
    __syncthreads();   // the chunk is no longer read
    stage(base);
  }
}

}  // namespace

extern "C" {

// The launch plan for a (T, q, k) bank: out = {partitions a block, bank
// chunk, dynamic shared-memory bytes}. Returns cudaErrorInvalidValue for a
// shape the kernel does not take, else 0.
int matcher_plan(int T, int q, int k, int* out) {
  if (k < 1 || k > 64 || q < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  plan(T, q, k, out, out + 1, out + 2);
  return 0;
}

// The launch grid for M rows: out = {blocks, rows a block, partitions a
// block, bank chunk, dynamic shared-memory bytes}. Returns
// cudaErrorInvalidValue for a shape the kernel does not take, else 0.
int matcher_grid(long long M, long long T, long long q, long long k, long long* out) {
  if (k < 1 || k > 64 || q < 1 || T < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  int tp, chunk, smem;
  plan(static_cast<int>(T), static_cast<int>(q), static_cast<int>(k), &tp, &chunk, &smem);
  out[0] = static_cast<long long>(cdiv(M, ROWS)) * cdiv(T, tp);
  out[1] = ROWS;
  out[2] = tp;
  out[3] = chunk;
  out[4] = smem;
  return 0;
}

// Returns cudaGetLastError() after the launch (0 on success). `residual` is
// 4-byte aligned (the wrapper allocates it).
int matcher_launch(const float* a, const unsigned long long* packed, int* idx,
                   int8_t* residual, long long M, int K, int T, int q, int k, void* stream) {
  if (M < 1 || k < 1 || k > 64 || q < 1 || T < 1 || static_cast<long long>(T) * k != K)
    return static_cast<int>(cudaErrorInvalidValue);
  int tp, chunk, smem;
  plan(T, q, k, &tp, &chunk, &smem);
  const int n_pb = cdiv(T, tp);
  const long long blocks = static_cast<long long>(cdiv(M, ROWS)) * n_pb;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = K % 4 == 0 && (tp * k) % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(a) & 15) == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (k <= 16)
    matcher_kernel<16><<<grid, THREADS, smem, s>>>(a, packed, idx, residual, M, K, T, q, k, tp,
                                                   chunk, n_pb, vec);
  else if (k <= 32)
    matcher_kernel<32><<<grid, THREADS, smem, s>>>(a, packed, idx, residual, M, K, T, q, k, tp,
                                                   chunk, n_pb, vec);
  else
    matcher_kernel<64><<<grid, THREADS, smem, s>>>(a, packed, idx, residual, M, K, T, q, k, tp,
                                                   chunk, n_pb, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
