// Phi flash attention for Hopper (sm_90a), CUDA C++, with a dense instantiation.
//
// Replaces repro/kernels/phi_attention.py::phi_flash_attention_pallas (body
// _attn_kernel over attn_score_block). For q, k, v (B, S, H, D) f32 with
// binary spike Q and K, and a pattern bank (T, qp, kp) calibrated on the K
// rows, given bit-packed as one word per pattern (T, qp) (kp <= 64,
// T*kp <= D), one block per (batch*head, q-block) computes
//
//   per kv-block, per K row c and partition t:
//     bits = K[c][t*kp : (t+1)*kp];  H_i = popc(bits ^ p_ti)
//     best = first argmin_i H_i;  idx = (H_best < popc(bits)) ? best : qp
//     chosen = p_t,idx (0 for idx = qp);  residual = bits - chosen
//       (as +/- bit masks; counted into l2_nnz)
//   per score (r, c):    L1 = sum_t sum_{j in chosen_ct} Q[r][t*kp + j]
//                        L2 = sum_t sum_{j in residual_ct} +-Q[r][t*kp + j]
//                        s  = (L1 + L2 + sum_{d >= T*kp} K[c][d] Q[r][d]) * scale
//   masks (padded keys, causal, window, chunk), then the online softmax:
//     m' = max(m, max_c s);  p = exp(s - m') (NaN -> 0);  corr = exp(m - m') (NaN -> 0)
//     den = den*corr + sum_c p;  acc = acc*corr + p @ V;  out = acc / max(den, 1e-30)
//   and, where the caller passes a buffer (dense only), lse = m + log(max(den, 1e-30))
//   per query row: the forward of models/flash.py's autograd Function, whose
//   backward recomputes p from it.
//
// The template flag PHI picks the score source: the decomposition above, or
// the dense q.k^T. Both feed one online-softmax body, whose arithmetic for a
// query row does not depend on the block's shape (block_q, the thread
// mapping), only on block_kv: so for binary Q and K (every score an exact
// integer either way) the two instantiations give bitwise-equal outputs at
// equal block_kv, whatever each one's block_q. The port's dense
// flash_attention launches the dense one, which makes Phi inference and dense
// inference comparable bit for bit on the card. Scale is applied after the
// contraction, every float add and multiply is __fadd_rn / __fmul_rn (the file
// is built with --fmad=false) and exp is the accurate expf. The plain PyTorch
// version sums p and p @ V in another order, so the outputs agree to a stated
// tolerance; the scores and l2_nnz are exact.
//
// l2_nnz (B*H, nq) int32: as in the reference, every q-block matches *all* K
// rows again, so l2_nnz[bh, iq] is the residual count of the whole K panel
// and has the same value in every q-block column.
//
// What bounds it on an H100: at the spikformer's S = 64 the work of a (batch,
// head) is one 64 x 64 score block, so the least time is set by bytes (read q,
// k, v once, write out once); a kernel reaches it only with enough blocks
// resident to hide the loads and the shared-memory latency of each phase. The
// first version of this kernel built a pattern x Q^T table per q-block
// (T*(qp+1)*bq floats, 66 KB at blocks (64, 64)), which left one block of 8
// warps per SM, and ran the softmax and p.V one warp per row, eight rows in
// a row, with the accumulator in shared memory. This design:
//   * No table. Where a block's Q rows are binary (checked as they load,
//     __syncthreads_or) a score is integer work: L1 = sum_t popc(chosen &
//     qbits_rt), L2 = sum_t popc(pos & qbits_rt) - popc(neg & qbits_rt); the
//     same exact integers the float sums give. A block whose Q is not binary
//     adds Q's elements over each mask's set bits in ascending j, the order in
//     which the table's entries were built, so its scores are bitwise those of
//     the table. The Phi block's shared memory is then about the dense one's
//     (49.7 KB against 43.5 KB at (64, 64), D = 32). The launch bound asks
//     for three blocks an SM (80 registers a thread, a few bytes spilled),
//     two where p.V takes several passes (kernels/phi_attention.py::
//     launch_bound_blocks mirrors it): asking for four left 64 registers and
//     more spills, and measured slower.
//   * The match splits each (K row, partition) pair's qp patterns over up to
//     32 lanes, combined as a packed (distance, index) minimum: the first
//     index on ties, as the serial scan. Past 256 pairs (bkv * T) a lane
//     matches one pair a pass, in as many passes as it takes.
//   * Scores in 4 x 4 register tiles per thread (16-byte shared loads; the
//     dense sum still runs over d in ascending order).
//   * Softmax statistics: four threads a row, running max and denominator in
//     registers. p.V: each thread owns 8 consecutive output columns of up to
//     RPT rows, the accumulator in registers, V read as 16-byte broadcasts.
//   * Q, K and V blocks come in with cp.async; kv-blocks are streamed through
//     shared memory one at a time, so the footprint does not grow with S. The
//     footprint is phi_attention_smem_bytes(), mirrored by
//     kernels/phi_attention.py::smem_bytes; above 48 KB the launch raises the
//     block's dynamic shared-memory limit (at most 227 KB).
//   * The dense instantiation walks only the kv-blocks its q block's masks
//     leave open (band()): a causal prefill half of them, a sliding window
//     of W keys about W / bkv + 1. Skipping a block whose scores are all
//     masked changes no bit of the result. The Phi instantiation walks every
//     block: its l2_nnz counts the residual of every K row.
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DC = 8;          // p.V: output columns per thread
constexpr int SG = 4;          // softmax statistics: threads per row
constexpr int MAX_BQ = 2 * THREADS / SG;  // 128: two statistics rows per thread
constexpr long long SMEM_LIMIT = 232448;  // 227 KB: the most a block may use on sm_90

// Row stride of the Q and K blocks: D rounded up to 16-byte words, an odd
// number of them, so that the 4 x 4 score tiles' 16-byte loads of eight
// consecutive rows fall in distinct banks.
__host__ __device__ inline int ld_qk(int D) { return 4 * (((D + 3) / 4) | 1); }
__host__ __device__ inline int ld_v(int D) { return (D + DC - 1) / DC * DC; }

struct Layout {
  size_t pat, chosen, pos, neg, qbits, q, k, v, s, corr, nnz, total;
};

// Byte offsets of the block's shared-memory arrays: the 8-byte arrays first,
// then the 16-byte aligned float blocks.
__host__ __device__ inline Layout make_layout(int bq, int bkv, int D, int T, int qp, bool phi) {
  Layout L;
  size_t off = 0;
  const size_t t = phi ? static_cast<size_t>(T) : 0;
  L.pat = off;    off += 8 * t * qp;                   // packed bank (T, qp)
  L.chosen = off; off += 8 * t * bkv;                  // matched pattern word (bkv, T)
  L.pos = off;    off += 8 * t * bkv;                  // residual +1 masks (bkv, T)
  L.neg = off;    off += 8 * t * bkv;                  // residual -1 masks (bkv, T)
  L.qbits = off;  off += 8 * t * bq;                   // Q rows as bits (bq, T)
  off = (off + 15) / 16 * 16;
  L.q = off; off += 4 * static_cast<size_t>(bq) * ld_qk(D);     // Q block
  L.k = off; off += 4 * static_cast<size_t>(bkv) * ld_qk(D);    // K block
  L.v = off; off += 4 * static_cast<size_t>(bkv) * ld_v(D);     // V block
  L.s = off; off += 4 * static_cast<size_t>(bq) * (bkv + 1);    // scores, then p
  L.corr = off; off += 4 * static_cast<size_t>(bq);             // per-row rescale, then den
  L.nnz = off;  off += 4;                                       // block's residual count
  L.total = off;
  return L;
}

// Rows of the p.V phase one pass of the block covers, and the passes (RPT) a
// block of bq rows needs: 1, 2 or 4; 0 if none of those covers it.
__host__ __device__ inline int pv_rows(int D) { return THREADS / ((D + DC - 1) / DC); }
__host__ __device__ inline int pv_passes(int bq, int D) {
  const int rpp = pv_rows(D);
  if (rpp < 1 || bq > MAX_BQ) return 0;
  for (int p = 1; p <= 4; p *= 2)
    if (bq <= p * rpp) return p;
  return 0;
}

// Copy `rows` sequence rows from s0 on (stride `row` floats) into a block of
// stride ldt with cp.async; rows past S and columns [D, zero_to) are zero.
__device__ __forceinline__ void load_rows(float* dst, int ldt, const float* src, long long row,
                                          int s0, int rows, int S, int D, int zero_to,
                                          bool vec) {
  if (vec) {
    const int per = D / 4;
    for (int e = threadIdx.x; e < rows * per; e += THREADS) {
      const int r = e / per, c = (e % per) * 4, sr = s0 + r;
      float* d = dst + r * ldt + c;
      if (sr < S)
        __pipeline_memcpy_async(d, src + sr * row + c, 16);
      else
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int e = threadIdx.x; e < rows * D; e += THREADS) {
      const int r = e / D, c = e % D, sr = s0 + r;
      float* d = dst + r * ldt + c;
      if (sr < S)
        __pipeline_memcpy_async(d, src + sr * row + c, 4);
      else
        *d = 0.f;
    }
  }
  const int pad = zero_to - D;
  for (int e = threadIdx.x; e < rows * pad; e += THREADS)
    dst[(e / pad) * ldt + D + e % pad] = 0.f;
}

// Sum of q over the set bits of `bits` in ascending j: a table entry of the
// first version of this kernel, or one partition's residual (pos added, the
// rest subtracted).
__device__ __forceinline__ float bit_sum(unsigned long long bits, unsigned long long pos,
                                         const float* q) {
  float part = 0.f;
  while (bits) {
    const int j = __ffsll(static_cast<long long>(bits)) - 1;
    bits &= bits - 1;
    part = ((pos >> j) & 1ull) ? __fadd_rn(part, q[j]) : __fsub_rn(part, q[j]);
  }
  return part;
}

// The kv-blocks [*lo, *hi] that the causal, window and chunk masks leave open
// to some query row of the block at q0 (dense only: the Phi instantiation
// matches every K row for l2_nnz). A block outside holds only masked scores
// for every row, and adds nothing: p = 0, and the running max, denominator
// and accumulator keep their bits (corr = 1, or 0 on all of them while a
// row's max is still -inf). So the work is O(S * W) under a window.
__device__ __forceinline__ void band(int q0, int bq, int S, int bkv, int causal,
                                     int has_window, int window, int chunk, int* lo,
                                     int* hi) {
  const int qlast = min(q0 + bq, S) - 1;
  if (causal) *hi = min(*hi, qlast / bkv);
  if (has_window) *lo = max(*lo, (q0 - window + 1) / bkv);
  if (chunk > 0) {
    *lo = max(*lo, q0 / chunk * chunk / bkv);
    const long long end = (static_cast<long long>(qlast) / chunk + 1) * chunk - 1;
    if (end < S) *hi = min(*hi, static_cast<int>(end / bkv));
  }
}

template <bool PHI, int RPT>
__global__ void __launch_bounds__(THREADS, RPT == 1 ? 3 : 2) attn_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const unsigned long long* __restrict__ packed,    // (T, qp), PHI only
    float* __restrict__ out,                          // (B, S, H, D)
    int* __restrict__ l2_nnz,                         // (B*H, nq), PHI only
    float* __restrict__ lse,                          // (B*H, S) or null, dense only
    int S, int H, int D, int T, int qp, int kp, int bq, int bkv, int nq, int nkv,
    int causal, int has_window, int window, int chunk, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(bq, bkv, D, T, qp, PHI);
  unsigned long long* s_pat = reinterpret_cast<unsigned long long*>(smem + L.pat);
  unsigned long long* s_ch = reinterpret_cast<unsigned long long*>(smem + L.chosen);
  unsigned long long* s_pos = reinterpret_cast<unsigned long long*>(smem + L.pos);
  unsigned long long* s_neg = reinterpret_cast<unsigned long long*>(smem + L.neg);
  unsigned long long* s_qb = reinterpret_cast<unsigned long long*>(smem + L.qbits);
  float* s_q = reinterpret_cast<float*>(smem + L.q);
  float* s_k = reinterpret_cast<float*>(smem + L.k);
  float* s_v = reinterpret_cast<float*>(smem + L.v);
  float* s_s = reinterpret_cast<float*>(smem + L.s);
  float* s_corr = reinterpret_cast<float*>(smem + L.corr);
  int* s_nnz = reinterpret_cast<int*>(smem + L.nnz);

  const int tid = threadIdx.x;
  const int bh = blockIdx.x / nq, iq = blockIdx.x % nq;
  const int b = bh / H, h = bh % H;
  const int ld = ld_qk(D), ldv = ld_v(D), lds = bkv + 1, D4 = (D + 3) / 4 * 4;
  const long long row = static_cast<long long>(H) * D;  // stride of the sequence axis
  const long long base = (static_cast<long long>(b) * S * H + h) * D;
  const int q0 = iq * bq;

  load_rows(s_q, ld, q + base, row, q0, bq, S, D, D4, vec);
  if (tid == 0) *s_nnz = 0;
  if constexpr (PHI) {
    for (int i = tid; i < T * qp; i += THREADS) s_pat[i] = packed[i];
  }

  // Softmax statistics role: rows sr0 + 64 i of four threads each.
  const int sr0 = tid / SG, ssub = tid % SG;
  float m_run[2] = {-INFINITY, -INFINITY}, den[2] = {0.f, 0.f};
  // p.V role: DC columns from d0 of rows pr0 + rpp i.
  const int tpr = (D + DC - 1) / DC, rpp = THREADS / tpr;
  const int pr0 = tid / tpr, d0 = (tid % tpr) * DC;
  const bool pv_on = tid < rpp * tpr;
  float acc[RPT][DC];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  bool binary = true;
  int my_nnz = 0;
  const int used = T * kp;
  int jk_lo = 0, jk_hi = nkv - 1;
  if constexpr (!PHI) band(q0, bq, S, bkv, causal, has_window, window, chunk, &jk_lo, &jk_hi);
  for (int jk = jk_lo; jk <= jk_hi; ++jk) {
    if (jk > jk_lo) __syncthreads();  // the previous kv-block's K, V and p are no longer read
    load_rows(s_k, ld, k + base, row, jk * bkv, bkv, S, D, D4, vec);
    load_rows(s_v, ldv, v + base, row, jk * bkv, bkv, S, D, D, vec);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    if constexpr (PHI) {
      if (jk == 0) {
        int odd = 0;
        for (int e = tid; e < bq * D; e += THREADS) {
          const float x = s_q[(e / D) * ld + e % D];
          odd |= !(x == 0.f || x == 1.f);
        }
        binary = !__syncthreads_or(odd);
        if (binary) {
          for (int e = tid; e < bq * T; e += THREADS) {
            const float* qr = s_q + (e / T) * ld + (e % T) * kp;
            unsigned long long bits = 0ull;
            for (int j = 0; j < kp; ++j)
              if (qr[j] != 0.f) bits |= 1ull << j;
            s_qb[e] = bits;
          }
        }
      }
      // Match: each (K row, partition) pair's patterns split over tpp lanes;
      // past THREADS pairs (tpp = 1) the block takes them in several passes.
      const int pairs = bkv * T;
      int tpp = 1;
      while (tpp < 32 && pairs * tpp * 2 <= THREADS) tpp *= 2;
      for (int p0 = 0; p0 < pairs; p0 += THREADS / tpp) {
        const int pair = p0 + tid / tpp, sub = tid % tpp;
        const bool on = pair < pairs;
        const unsigned mask = __ballot_sync(0xffffffffu, on);
        if (!on) continue;
        const int c = pair / T, t = pair % T;
        const float* kr = s_k + c * ld + t * kp;
        unsigned long long bits = 0ull;
        for (int j = 0; j < kp; ++j)
          if (kr[j] != 0.f) bits |= 1ull << j;
        const unsigned long long* pt = s_pat + t * qp;
        unsigned best = 0xffffffffu;                    // (distance << 16) | index
        for (int i = sub; i < qp; i += tpp)
          best = min(best, (static_cast<unsigned>(__popcll(bits ^ pt[i])) << 16) | i);
        for (int o = tpp / 2; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(mask, best, o));
        if (sub == 0) {
          const bool use = static_cast<int>(best >> 16) < __popcll(bits);  // strictly better
          const unsigned long long chosen = use ? pt[best & 0xffffu] : 0ull;
          const unsigned long long pos = bits & ~chosen, neg = chosen & ~bits;
          s_ch[pair] = chosen;
          s_pos[pair] = pos;
          s_neg[pair] = neg;
          my_nnz += __popcll(pos) + __popcll(neg);
        }
      }
      __syncthreads();
    }

    // Scores: 4 x 4 tiles, rows ty + 16 i and columns tx + 16 j of each 64 x 64.
    const int ty = tid / 16, tx = tid % 16;
    for (int r0 = 0; r0 < bq; r0 += 64) {
      for (int c0 = 0; c0 < bkv; c0 += 64) {
        int rr[4], cc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rr[i] = min(r0 + ty + 16 * i, bq - 1);
          cc[i] = min(c0 + tx + 16 * i, bkv - 1);
        }
        float sc[4][4];
        if (!PHI || binary) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        }
        if constexpr (PHI) {
          if (binary) {
            // L1 + L2 of each score as one exact integer: float(L1) + float(L2)
            // rounds to the same value, both being integers below 2^24.
            int tot[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) tot[i][j] = 0;
            for (int t = 0; t < T; ++t) {
              unsigned long long qw[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) qw[i] = s_qb[rr[i] * T + t];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int ct = cc[j] * T + t;
                const unsigned long long ch = s_ch[ct], ps = s_pos[ct], ng = s_neg[ct];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                  tot[i][j] += __popcll(ch & qw[i]) + __popcll(ps & qw[i]) - __popcll(ng & qw[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sc[i][j] = static_cast<float>(tot[i][j]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float* qr = s_q + rr[i] * ld;
                float a1 = 0.f, a2 = 0.f;
                for (int t = 0; t < T; ++t) {
                  const int ct = cc[j] * T + t;
                  a1 = __fadd_rn(a1, bit_sum(s_ch[ct], ~0ull, qr + t * kp));
                  const unsigned long long rest = s_pos[ct] | s_neg[ct];
                  if (rest) a2 = __fadd_rn(a2, bit_sum(rest, s_pos[ct], qr + t * kp));
                }
                sc[i][j] = __fadd_rn(a1, a2);
              }
          }
          if (used < D) {                               // dense ragged tail
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float* qr = s_q + rr[i] * ld;
                const float* kr = s_k + cc[j] * ld;
                float tail = 0.f;
                for (int d = used; d < D; ++d) tail = __fadd_rn(tail, __fmul_rn(kr[d], qr[d]));
                sc[i][j] = __fadd_rn(sc[i][j], tail);
              }
          }
        } else {
          for (int d = 0; d < D4; d += 4) {             // ascending d; the pad adds +0
            float4 a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              a[i] = *reinterpret_cast<const float4*>(s_q + rr[i] * ld + d);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 kk = *reinterpret_cast<const float4*>(s_k + cc[j] * ld + d);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float x = sc[i][j];
                x = __fadd_rn(x, __fmul_rn(a[i].x, kk.x));
                x = __fadd_rn(x, __fmul_rn(a[i].y, kk.y));
                x = __fadd_rn(x, __fmul_rn(a[i].z, kk.z));
                sc[i][j] = __fadd_rn(x, __fmul_rn(a[i].w, kk.w));
              }
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = r0 + ty + 16 * i, c = c0 + tx + 16 * j;
            if (r >= bq || c >= bkv) continue;
            const int qpos = q0 + r, kpos = jk * bkv + c;
            bool valid = kpos < S;
            if (causal) valid = valid && kpos <= qpos;
            if (has_window) valid = valid && kpos > qpos - window;
            if (chunk > 0) valid = valid && (kpos / chunk) == (qpos / chunk);
            s_s[r * lds + c] = valid ? __fmul_rn(sc[i][j], scale) : -INFINITY;
          }
      }
    }
    __syncthreads();

    // Softmax statistics: the row's max, p in place of the scores, the
    // row sum (each of the four threads over c = sub mod 4, then combined).
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = sr0 + 64 * i;
      const unsigned mask = __ballot_sync(0xffffffffu, r < bq);
      if (r < bq) {
        float* sr = s_s + r * lds;
        float mx = -INFINITY;
        for (int c = ssub; c < bkv; c += SG) mx = fmaxf(mx, sr[c]);
        mx = fmaxf(mx, __shfl_xor_sync(mask, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(mask, mx, 2));
        const float m_new = fmaxf(m_run[i], mx);
        float psum = 0.f;
        for (int c = ssub; c < bkv; c += SG) {
          float p = expf(__fsub_rn(sr[c], m_new));
          if (isnan(p)) p = 0.f;                        // fully-masked rows
          sr[c] = p;
          psum = __fadd_rn(psum, p);
        }
        psum = __fadd_rn(psum, __shfl_xor_sync(mask, psum, 1));
        psum = __fadd_rn(psum, __shfl_xor_sync(mask, psum, 2));
        float corr = expf(__fsub_rn(m_run[i], m_new));
        if (isnan(corr)) corr = 0.f;
        den[i] = __fadd_rn(__fmul_rn(den[i], corr), psum);
        m_run[i] = m_new;
        if (ssub == 0) s_corr[r] = corr;
      }
    }
    __syncthreads();

    // p.V into the registers' accumulator, ascending c.
    if (pv_on) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = pr0 + rpp * i;
        if (r < bq) {
          const float* pr = s_s + r * lds;
          float pv[DC];
#pragma unroll
          for (int j = 0; j < DC; ++j) pv[j] = 0.f;
          for (int c = 0; c < bkv; ++c) {
            const float p = pr[c];
            const float4 v0 = *reinterpret_cast<const float4*>(s_v + c * ldv + d0);
            const float4 v1 = *reinterpret_cast<const float4*>(s_v + c * ldv + d0 + 4);
            pv[0] = __fadd_rn(pv[0], __fmul_rn(p, v0.x));
            pv[1] = __fadd_rn(pv[1], __fmul_rn(p, v0.y));
            pv[2] = __fadd_rn(pv[2], __fmul_rn(p, v0.z));
            pv[3] = __fadd_rn(pv[3], __fmul_rn(p, v0.w));
            pv[4] = __fadd_rn(pv[4], __fmul_rn(p, v1.x));
            pv[5] = __fadd_rn(pv[5], __fmul_rn(p, v1.y));
            pv[6] = __fadd_rn(pv[6], __fmul_rn(p, v1.z));
            pv[7] = __fadd_rn(pv[7], __fmul_rn(p, v1.w));
          }
          const float corr = s_corr[r];
#pragma unroll
          for (int j = 0; j < DC; ++j) acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr), pv[j]);
        }
      }
    }
  }

  if constexpr (PHI) {
    if (my_nnz) atomicAdd(s_nnz, my_nnz);
  }
  __syncthreads();  // the last p.V read s_corr
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = sr0 + 64 * i;
    if (r < bq && ssub == 0) s_corr[r] = den[i];
  }
  if (lse != nullptr) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = sr0 + 64 * i, sr = q0 + r;
      if (r < bq && sr < S && ssub == 0)
        lse[static_cast<long long>(bh) * S + sr] =
            __fadd_rn(m_run[i], logf(fmaxf(den[i], 1e-30f)));
    }
  }
  __syncthreads();
  if (pv_on) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = pr0 + rpp * i, sr = q0 + r;
      if (r < bq && sr < S) {
        const float dn = fmaxf(s_corr[r], 1e-30f);
        float* o = out + base + sr * row + d0;
        float res[DC];
#pragma unroll
        for (int j = 0; j < DC; ++j) res[j] = __fdiv_rn(acc[i][j], dn);
        if (vec && d0 + DC <= D) {
          *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
          *reinterpret_cast<float4*>(o + 4) = make_float4(res[4], res[5], res[6], res[7]);
        } else {
#pragma unroll
          for (int j = 0; j < DC; ++j)
            if (d0 + j < D) o[j] = res[j];
        }
      }
    }
  }
  if constexpr (PHI) {
    if (tid == 0) l2_nnz[static_cast<long long>(bh) * nq + iq] = *s_nnz;
  }
}

// The instantiation a shape runs, and the dynamic shared memory it needs.
template <bool PHI>
const void* kernel_for(int passes) {
  switch (passes) {
    case 1: return reinterpret_cast<const void*>(attn_kernel<PHI, 1>);
    case 2: return reinterpret_cast<const void*>(attn_kernel<PHI, 2>);
    case 4: return reinterpret_cast<const void*>(attn_kernel<PHI, 4>);
    default: return nullptr;
  }
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;  // above the default limit the block must ask
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool PHI>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const unsigned long long* packed, float* out, int* l2_nnz, float* lse, int B,
                   int S, int H, int D, int T, int qp, int kp, int bq, int bkv, int causal,
                   int has_window, int window, int chunk, float scale, cudaStream_t stream) {
  const size_t smem = make_layout(bq, bkv, D, T, qp, PHI).total;
  const int passes = pv_passes(bq, D);
  const void* fn = kernel_for<PHI>(passes);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  const int vec = (D % 4 == 0) && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(v) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int nq = (S + bq - 1) / bq, nkv = (S + bkv - 1) / bkv;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * H * nq);
  switch (passes) {
    case 1:
      attn_kernel<PHI, 1><<<blocks, THREADS, smem, stream>>>(
          q, k, v, packed, out, l2_nnz, lse, S, H, D, T, qp, kp, bq, bkv, nq, nkv, causal,
          has_window, window, chunk, scale, vec);
      break;
    case 2:
      attn_kernel<PHI, 2><<<blocks, THREADS, smem, stream>>>(
          q, k, v, packed, out, l2_nnz, lse, S, H, D, T, qp, kp, bq, bkv, nq, nkv, causal,
          has_window, window, chunk, scale, vec);
      break;
    default:
      attn_kernel<PHI, 4><<<blocks, THREADS, smem, stream>>>(
          q, k, v, packed, out, l2_nnz, lse, S, H, D, T, qp, kp, bq, bkv, nq, nkv, causal,
          has_window, window, chunk, scale, vec);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch grid: out = {blocks, q-blocks of a (batch, head)}: one block
// per (batch * head, q-block of bq rows). Returns 0.
int phi_attention_grid(long long B, long long S, long long H, long long bq, long long* out) {
  const long long nq = (S + bq - 1) / bq;
  out[0] = B * H * nq;
  out[1] = nq;
  return 0;
}

// Dynamic shared memory one block of the kernel uses, in bytes (phi = 0: the
// dense instantiation, which ignores T and qp).
long long phi_attention_smem_bytes(int bq, int bkv, int D, int T, int qp, int phi) {
  return static_cast<long long>(make_layout(bq, bkv, D, T, qp, phi != 0).total);
}

// Blocks of the kernel one SM holds at this shape (cudaOccupancy...), or a
// negative CUDA error code; 0 where the kernel refuses the shape.
int phi_attention_occupancy(int bq, int bkv, int D, int T, int qp, int phi) {
  const size_t smem = make_layout(bq, bkv, D, T, qp, phi != 0).total;
  const void* fn = phi ? kernel_for<true>(pv_passes(bq, D)) : kernel_for<false>(pv_passes(bq, D));
  if (fn == nullptr || static_cast<long long>(smem) > SMEM_LIMIT) return 0;
  cudaError_t err = prepare(fn, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, THREADS, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// q, k, v, out (B, S, H, D) f32 contiguous; packed (T, qp) and l2_nnz
// (B*H, ceil(S/bq)) for phi = 1, ignored for phi = 0; lse (B*H, S) f32 for
// phi = 0, or null to skip it (phi = 1 takes none). bq and bkv are the
// clamped blocks (<= S); bq <= 128 and covered by at most four p.V passes
// (bq <= 4 * 256 / ceil(D / 8)). Returns cudaGetLastError() after the launch
// (0 on success); the caller synchronises as it needs.
int phi_attention_launch(const float* q, const float* k, const float* v,
                         const unsigned long long* packed, float* out, int* l2_nnz, float* lse,
                         int B, int S, int H, int D, int T, int qp, int kp, int bq, int bkv,
                         int causal, int has_window, int window, int chunk, float scale,
                         int phi, void* stream) {
  if (B < 1 || S < 1 || H < 1 || D < 1 || bq < 1 || bkv < 1 || bq > S || bkv > S ||
      chunk < 0 || pv_passes(bq, D) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (phi && (kp < 1 || kp > 64 || qp < 1 || qp > 0xffff || T < 1 || T * kp > D ||
              lse != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * H * ((S + bq - 1) / bq) > 0x7fffffffLL ||
      phi_attention_smem_bytes(bq, bkv, D, T, qp, phi) > SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (phi)
    return static_cast<int>(launch<true>(q, k, v, packed, out, l2_nnz, nullptr, B, S, H, D, T,
                                         qp, kp, bq, bkv, causal, has_window, window, chunk,
                                         scale, s));
  return static_cast<int>(launch<false>(q, k, v, nullptr, out, nullptr, lse, B, S, H, D, 0, 0,
                                        0, bq, bkv, causal, has_window, window, chunk, scale,
                                        s));
}

}  // extern "C"
