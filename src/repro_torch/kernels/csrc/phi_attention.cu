// Phi flash attention for Hopper (sm_90a), CUDA C++, with a dense instantiation.
//
// Replaces repro/kernels/phi_attention.py::phi_flash_attention_pallas (body
// _attn_kernel over attn_score_block). For q, k, v (B, S, H, D) f32 with
// binary spike Q and K, and a pattern bank (T, qp, kp) calibrated on the K
// rows, given bit-packed as one word per pattern (T, qp) (kp <= 64,
// T*kp <= D), one block per (batch*head, q-block) computes
//
//   per q-block, once:   PQ[t][i][r] = sum_{j in pattern (t, i)} Q[r][t*kp + j]
//                        (the pattern x Q^T products; row qp is zero)
//   per kv-block, per K row c and partition t:
//     bits = K[c][t*kp : (t+1)*kp];  H_i = popc(bits ^ p_ti)
//     best = first argmin_i H_i;  idx = (H_best < popc(bits)) ? best : qp
//     residual = bits - p_t,idx  (as +/- bit masks; counted into l2_nnz)
//   per score (r, c):    L1 = sum_t PQ[t][idx_ct][r]
//                        L2 = sum_t sum_{j in residual_ct} +-Q[r][t*kp + j]
//                        s  = (L1 + L2 + sum_{d >= T*kp} K[c][d] Q[r][d]) * scale
//   masks (padded keys, causal, window, chunk), then the online softmax:
//     m' = max(m, max_c s);  p = exp(s - m') (NaN -> 0);  corr = exp(m - m') (NaN -> 0)
//     den = den*corr + sum_c p;  acc = acc*corr + p @ V;  out = acc / max(den, 1e-30)
//
// The template flag PHI picks the score source: the decomposition above, or
// the dense q.k^T. Both feed one online-softmax body, so for binary Q and K
// (every score an exact integer either way) the two instantiations give
// bitwise-equal outputs: the port's dense flash_attention launches the dense
// one, which makes Phi inference and dense inference comparable bit for bit on
// the card. L1 and L2 accumulate apart and are added once, scale is applied
// after the contraction, every add and multiply is __fadd_rn / __fmul_rn (the
// file is built with --fmad=false) and exp is the accurate expf. The plain
// PyTorch version sums p and p @ V in another order, so the outputs agree to a
// stated tolerance; the scores and l2_nnz are exact.
//
// l2_nnz (B*H, nq) int32: as in the reference, every q-block matches *all* K
// rows again, so l2_nnz[bh, iq] is the residual count of the whole K panel
// and has the same value in every q-block column.
//
// What bounds it on an H100: at the spikformer's S = 64 the work per (batch,
// head) is small (a 64 x 64 score block), so the least time is set by bytes
// (read q, k, v once, write out once). The kernel is far from it: each of its
// phases is a chain of shared-memory loads, and at blocks (64, 64) the Phi
// block needs 121 KB (66 KB of it the pattern x Q table), so an SM holds one
// block of 8 warps, too few to hide that latency; the dense instantiation
// (50 KB, four blocks per SM) is 4x faster, and block_q = 32 (71 KB) halves
// the Phi time. PERF.md has the measurements and the next steps (blocks
// chosen by occupancy; the L1 score as a popcount of pattern and Q bits,
// which binary Q makes exact and which removes the table). The design:
//   * One block of 256 threads per (batch*head, q-block). Blocks run in any
//     order and share nothing; the (m, den, acc) state of the online softmax
//     lives in shared memory inside the block's loop over kv-blocks.
//   * kv-blocks are streamed through shared memory one at a time (the TPU
//     kernel keeps the whole K/V panel resident), so the footprint does not
//     grow with S. The footprint is phi_attention_smem_bytes(), mirrored by
//     kernels/phi_attention.py::smem_bytes; above 48 KB the launch raises the
//     block's dynamic shared-memory limit (at most 227 KB).
//   * The pattern x Q^T products are built once per q-block from the packed
//     bank (T*(qp+1)*bq floats); a K row's L1 score is then one gather per
//     partition, and only the residual's set bits cost adds.
//   * One warp per query row in the softmax phase: coalesced reads of the
//     score row and of V's columns, warp-shuffle max and sum.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long SMEM_LIMIT = 232448;  // 227 KB: the most a block may use on sm_90

struct Layout {
  size_t pat, pos, neg, pq, idx, q, k, v, s, acc, m, den, nnz, total;
};

// Byte offsets of the block's shared-memory arrays. The 8-byte arrays come
// first so they stay aligned; every size is a multiple of 4.
__host__ __device__ inline Layout make_layout(int bq, int bkv, int D, int T, int qp, bool phi) {
  Layout L;
  size_t off = 0;
  const size_t t = phi ? static_cast<size_t>(T) : 0;
  L.pat = off; off += 8 * t * qp;                      // packed bank (T, qp)
  L.pos = off; off += 8 * t * bkv;                     // residual +1 masks (bkv, T)
  L.neg = off; off += 8 * t * bkv;                     // residual -1 masks (bkv, T)
  L.pq = off;  off += 4 * t * (qp + 1) * bq;           // pattern x Q^T (T, qp+1, bq)
  L.idx = off; off += 4 * t * bkv;                     // matched pattern (bkv, T)
  L.q = off;   off += 4 * static_cast<size_t>(bq) * (D + 1);    // Q block, padded rows
  L.k = off;   off += 4 * static_cast<size_t>(bkv) * (D + 1);   // K block, padded rows
  L.v = off;   off += 4 * static_cast<size_t>(bkv) * D;         // V block
  L.s = off;   off += 4 * static_cast<size_t>(bq) * (bkv + 1);  // scores, then p
  L.acc = off; off += 4 * static_cast<size_t>(bq) * D;          // output accumulator
  L.m = off;   off += 4 * static_cast<size_t>(bq);              // running max
  L.den = off; off += 4 * static_cast<size_t>(bq);              // running denominator
  L.nnz = off; off += 4;                                        // block's residual count
  L.total = off;
  return L;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <bool PHI>
__global__ void __launch_bounds__(THREADS) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned long long* __restrict__ packed,    // (T, qp), PHI only
    float* __restrict__ out,                          // (B, S, H, D)
    int* __restrict__ l2_nnz,                         // (B*H, nq), PHI only
    int S, int H, int D, int T, int qp, int kp, int bq, int bkv, int nq, int nkv,
    int causal, int has_window, int window, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(bq, bkv, D, T, qp, PHI);
  unsigned long long* s_pat = reinterpret_cast<unsigned long long*>(smem + L.pat);
  unsigned long long* s_pos = reinterpret_cast<unsigned long long*>(smem + L.pos);
  unsigned long long* s_neg = reinterpret_cast<unsigned long long*>(smem + L.neg);
  float* s_pq = reinterpret_cast<float*>(smem + L.pq);
  int* s_idx = reinterpret_cast<int*>(smem + L.idx);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_k = reinterpret_cast<float*>(smem + L.k);
  float* s_v = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* s_acc = reinterpret_cast<float*>(smem + L.acc);
  float* s_m = reinterpret_cast<float*>(smem + L.m);
  float* s_den = reinterpret_cast<float*>(smem + L.den);
  int* s_nnz = reinterpret_cast<int*>(smem + L.nnz);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / nq, iq = blockIdx.x % nq;
  const int b = bh / H, h = bh % H;
  const int ld = D + 1, lds = bkv + 1;
  const long long row = static_cast<long long>(H) * D;  // stride of the sequence axis
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int e = tid; e < bq * D; e += THREADS) {
    const int r = e / D, d = e % D, sr = iq * bq + r;
    s_q[r * ld + d] = sr < S ? qb[sr * row + d] : 0.f;   // padded query rows are zero
    s_acc[e] = 0.f;
  }
  for (int r = tid; r < bq; r += THREADS) {
    s_m[r] = -INFINITY;
    s_den[r] = 0.f;
  }
  if (tid == 0) *s_nnz = 0;
  if constexpr (PHI) {
    for (int i = tid; i < T * qp; i += THREADS) s_pat[i] = packed[i];
  }
  __syncthreads();

  if constexpr (PHI) {
    const int per_t = (qp + 1) * bq;
    for (int e = tid; e < T * per_t; e += THREADS) {
      const int r = e % bq, i = (e / bq) % (qp + 1), t = e / per_t;
      float acc = 0.f;
      if (i < qp) {
        unsigned long long bits = s_pat[t * qp + i];
        const float* qr = s_q + r * ld + t * kp;
        while (bits) {                                  // set bits in ascending j
          const int j = __ffsll(static_cast<long long>(bits)) - 1;
          bits &= bits - 1;
          acc = __fadd_rn(acc, qr[j]);
        }
      }
      s_pq[e] = acc;
    }
  }

  int my_nnz = 0;
  const int used = T * kp;
  for (int jk = 0; jk < nkv; ++jk) {
    __syncthreads();  // the previous kv-block's K, V and scores are no longer read
    for (int e = tid; e < bkv * D; e += THREADS) {
      const int c = e / D, d = e % D, sr = jk * bkv + c;
      const bool ok = sr < S;                           // padded keys are zero
      s_k[c * ld + d] = ok ? kb[sr * row + d] : 0.f;
      s_v[c * D + d] = ok ? vb[sr * row + d] : 0.f;
    }
    __syncthreads();

    if constexpr (PHI) {
      for (int e = tid; e < bkv * T; e += THREADS) {
        const int c = e / T, t = e % T;
        const float* kr = s_k + c * ld + t * kp;
        unsigned long long bits = 0ull;
        for (int j = 0; j < kp; ++j)
          if (kr[j] != 0.f) bits |= 1ull << j;
        const int pop = __popcll(bits);
        const unsigned long long* pt = s_pat + t * qp;
        int best = 0, best_h = 0x7fffffff;
        for (int i = 0; i < qp; ++i) {
          const int hd = __popcll(bits ^ pt[i]);
          if (hd < best_h) { best_h = hd; best = i; }   // strict: first index on ties
        }
        const bool use = best_h < pop;                  // strictly better than raw bits
        const unsigned long long chosen = use ? pt[best] : 0ull;
        const unsigned long long pos = bits & ~chosen, neg = chosen & ~bits;
        s_idx[e] = use ? best : qp;
        s_pos[e] = pos;
        s_neg[e] = neg;
        my_nnz += __popcll(pos) + __popcll(neg);
      }
      __syncthreads();
    }

    for (int e = tid; e < bq * bkv; e += THREADS) {
      const int r = e % bq, c = e / bq;
      const float* qr = s_q + r * ld;
      const float* kr = s_k + c * ld;
      float sc = 0.f;
      if constexpr (PHI) {
        float a1 = 0.f, a2 = 0.f;
        for (int t = 0; t < T; ++t) {
          const int ct = c * T + t;
          a1 = __fadd_rn(a1, s_pq[(t * (qp + 1) + s_idx[ct]) * bq + r]);
          const unsigned long long pos = s_pos[ct];
          unsigned long long rest = pos | s_neg[ct];
          if (rest) {
            const float* qt = qr + t * kp;
            float part = 0.f;
            while (rest) {
              const int j = __ffsll(static_cast<long long>(rest)) - 1;
              rest &= rest - 1;
              part = ((pos >> j) & 1ull) ? __fadd_rn(part, qt[j]) : __fsub_rn(part, qt[j]);
            }
            a2 = __fadd_rn(a2, part);
          }
        }
        sc = __fadd_rn(a1, a2);
        if (used < D) {                                 // dense ragged tail
          float tail = 0.f;
          for (int d = used; d < D; ++d) tail = __fadd_rn(tail, __fmul_rn(kr[d], qr[d]));
          sc = __fadd_rn(sc, tail);
        }
      } else {
        for (int d = 0; d < D; ++d) sc = __fadd_rn(sc, __fmul_rn(qr[d], kr[d]));
      }
      sc = __fmul_rn(sc, scale);
      const int qpos = iq * bq + r, kpos = jk * bkv + c;
      bool valid = kpos < S;
      if (causal) valid = valid && kpos <= qpos;
      if (has_window) valid = valid && kpos > qpos - window;
      if (chunk > 0) valid = valid && (kpos / chunk) == (qpos / chunk);
      s_s[r * lds + c] = valid ? sc : -INFINITY;
    }
    __syncthreads();

    for (int r = warp; r < bq; r += WARPS) {
      float* sr = s_s + r * lds;
      float mx = -INFINITY;
      for (int c = lane; c < bkv; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, mx);
      float psum = 0.f;
      for (int c = lane; c < bkv; c += 32) {
        float p = expf(__fsub_rn(sr[c], m_new));
        if (isnan(p)) p = 0.f;                          // fully-masked rows
        sr[c] = p;
        psum = __fadd_rn(psum, p);
      }
      psum = warp_sum(psum);
      float corr = expf(__fsub_rn(m_old, m_new));
      if (isnan(corr)) corr = 0.f;
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float pv = 0.f;
        for (int c = 0; c < bkv; ++c) pv = __fadd_rn(pv, __fmul_rn(sr[c], s_v[c * D + d]));
        float* a = s_acc + r * D + d;
        *a = __fadd_rn(__fmul_rn(*a, corr), pv);
      }
      __syncwarp();
      if (lane == 0) {
        s_den[r] = __fadd_rn(__fmul_rn(s_den[r], corr), psum);
        s_m[r] = m_new;
      }
    }
  }

  if constexpr (PHI) atomicAdd(s_nnz, my_nnz);
  __syncthreads();
  for (int e = tid; e < bq * D; e += THREADS) {
    const int r = e / D, d = e % D, sr = iq * bq + r;
    if (sr < S) out[base + sr * row + d] = __fdiv_rn(s_acc[e], fmaxf(s_den[r], 1e-30f));
  }
  if constexpr (PHI) {
    if (tid == 0) l2_nnz[static_cast<long long>(bh) * nq + iq] = *s_nnz;
  }
}

template <bool PHI>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const unsigned long long* packed, float* out, int* l2_nnz, int B, int S,
                   int H, int D, int T, int qp, int kp, int bq, int bkv, int causal,
                   int has_window, int window, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = make_layout(bq, bkv, D, T, qp, PHI).total;
  if (smem > 48 * 1024) {  // above the default limit the block must ask for more
    const cudaError_t err = cudaFuncSetAttribute(
        attn_kernel<PHI>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nq = (S + bq - 1) / bq, nkv = (S + bkv - 1) / bkv;
  const long long blocks = static_cast<long long>(B) * H * nq;
  attn_kernel<PHI><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      q, k, v, packed, out, l2_nnz, S, H, D, T, qp, kp, bq, bkv, nq, nkv, causal, has_window,
      window, chunk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the kernel uses, in bytes (phi = 0: the
// dense instantiation, which ignores T and qp).
long long phi_attention_smem_bytes(int bq, int bkv, int D, int T, int qp, int phi) {
  return static_cast<long long>(make_layout(bq, bkv, D, T, qp, phi != 0).total);
}

// q, k, v, out (B, S, H, D) f32 contiguous; packed (T, qp) and l2_nnz
// (B*H, ceil(S/bq)) for phi = 1, ignored for phi = 0. bq and bkv are the
// clamped blocks (<= S). Returns cudaGetLastError() after the launch (0 on
// success); the caller synchronises as it needs.
int phi_attention_launch(const float* q, const float* k, const float* v,
                         const unsigned long long* packed, float* out, int* l2_nnz, int B,
                         int S, int H, int D, int T, int qp, int kp, int bq, int bkv,
                         int causal, int has_window, int window, int chunk, float scale,
                         int phi, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || bq < 1 || bkv < 1 || bq > S || bkv > S ||
      chunk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (phi && (kp < 1 || kp > 64 || qp < 1 || T < 1 || T * kp > D))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H * ((S + bq - 1) / bq) > 0x7fffffffLL ||
      phi_attention_smem_bytes(bq, bkv, D, T, qp, phi) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phi)
    return static_cast<int>(launch<true>(q, k, v, packed, out, l2_nnz, B, S, H, D, T, qp, kp,
                                         bq, bkv, causal, has_window, window, chunk, scale, s));
  return static_cast<int>(launch<false>(q, k, v, nullptr, out, nullptr, B, S, H, D, 0, 0, 0,
                                        bq, bkv, causal, has_window, window, chunk, scale, s));
}

}  // extern "C"
