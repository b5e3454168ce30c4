// Consensus column vote for Hopper (sm_90a): the fused segmented vote and
// the standalone finalize.
//
// Replaces the two Pallas kernels of the JAX package, both in
// bsseqconsensusreads_tpu/ops/pallas_vote.py:
//   * bsseq_seg_vote      <- _vote_kernel (column_vote_groups, pallas_call at
//                            :277) and _finalize_kernel (vote_finalize_groups,
//                            pallas_call at :217) together with the segment
//                            sum in front of it (models/molecular.py
//                            vote_partials_segments).
//   * bsseq_vote_finalize <- _finalize_kernel alone, over summed
//                            log-likelihoods.
//
// Bound: device memory. Per output column the vote reads each of its rows'
// base (1 B) and qual (2 B) once and writes base, qual, depth and errors
// (6 B); the arithmetic is at most 4 float adds per observation plus three
// exp and one log per output column, far below the card's float32 rate.
//
// Design (bsseq_seg_vote):
//   * one thread per (segment, plane, column); neighbouring threads take
//     neighbouring columns, so every row's base/qual loads coalesce;
//   * the 512 x 2 log-likelihood table (log_ok, log_err per integer qual)
//     sits in shared memory (4 KB): no transcendental runs per observation,
//     and the values are the pinned bits of the JAX package's table;
//   * the thread adds its segment's rows IN ROW ORDER into 4 float and 4
//     int registers — the unfactored per-observation term (hit ? log_ok :
//     log_err), so the float sums are bit-identical to the plain version's
//     in-order segment sum by construction (no reordering, no atomics, no
//     multiply to contract);
//   * the finalize (tie-band argmax, 5-comparator ascending posterior, two
//     trials with the pre-UMI rate, Phred round) runs in registers and each
//     output is written once. errors = depth - cnt[consensus].
// One launch covers every layout: molecular packed (ragged row offsets,
// 2 planes = R1/R2), duplex packed (2-row segments, 1 plane) and padded
// (offsets k*T). Build with -fmad=false: the two-trials arithmetic must not
// contract into FMAs the CPU never makes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNBase = 4;          // alphabet.NBASE: no observation
constexpr int kTableQuals = 512;   // ops/phred.py TABLE_QUALS
constexpr float kTieTol = 2.5e-6f; // models/molecular.py ARGMAX_TIE_TOL
constexpr int kThreads = 128;

// The finalize of models/molecular.py vote_finalize, op for op: the
// tie-canonical argmax (lowest base within kTieTol of the max), the
// 5-comparator sorting network on ll - max BEFORE the exp (largest term
// exactly 1.0), two trials with the pre-UMI rate, Phred clip and
// round-half-even. log10 is log(p) * float32(1 / log(10)), as jnp.log10
// lowers it.
__device__ __forceinline__ int finalize(const float ll[4], int depth,
                                        float min_cons, float p2,
                                        float* qual_out) {
  float m = fmaxf(fmaxf(ll[0], ll[1]), fmaxf(ll[2], ll[3]));
  float thr = m - kTieTol;
  int cons = ll[0] >= thr ? 0 : ll[1] >= thr ? 1 : ll[2] >= thr ? 2 : 3;
  float d0 = ll[0] - m, d1 = ll[1] - m, d2 = ll[2] - m, d3 = ll[3] - m;
  float a = fminf(d0, d1), b = fmaxf(d0, d1);
  float c = fminf(d2, d3), e = fmaxf(d2, d3);
  float a2 = fminf(a, c), c2 = fmaxf(a, c);
  float b2 = fminf(b, e);
  float b3 = fminf(b2, c2), c3 = fmaxf(b2, c2);
  float denom = ((expf(a2) + expf(b3)) + expf(c3)) + 1.0f;
  float p1 = 1.0f - 1.0f / denom;
  float pf = p1 * (1.0f - p2) + (1.0f - p1) * p2 + (2.0f / 3.0f) * p1 * p2;
  pf = fminf(fmaxf(pf, 1e-12f), 1.0f);
  const float inv_ln10 = __int_as_float(0x3EDE5BD9);  // float32(1 / log(10))
  float q = -10.0f * (logf(pf) * inv_ln10);
  q = fminf(fmaxf(q, 2.0f), 93.0f);
  bool keep = depth > 0 && !(q < min_cons);
  *qual_out = keep ? rintf(q) : 2.0f;
  return keep ? cons : kNBase;
}

__global__ void __launch_bounds__(kThreads)
seg_vote_kernel(const int8_t* __restrict__ bases,
                const int16_t* __restrict__ quals,
                const int32_t* __restrict__ offsets,
                const float* __restrict__ table, int S, int P, int W,
                int min_in, float min_cons, float p2,
                int8_t* __restrict__ base_out, uint8_t* __restrict__ qual_out,
                int16_t* __restrict__ depth_out, int16_t* __restrict__ err_out,
                float* __restrict__ ll_out) {
  __shared__ float tab[kTableQuals * 2];
  for (int i = threadIdx.x; i < kTableQuals * 2; i += blockDim.x) {
    tab[i] = table[i];
  }
  __syncthreads();
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)S * P * W;
  if (idx >= total) return;
  const int w = (int)(idx % W);
  const long long sp = idx / W;
  const int p = (int)(sp % P);
  const int s = (int)(sp / P);
  const int r0 = offsets[s], r1 = offsets[s + 1];
  float ll[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int cnt[4] = {0, 0, 0, 0};
  for (int r = r0; r < r1; ++r) {
    const long long cell = ((long long)r * P + p) * W + w;
    const int b = bases[cell];
    const int q = quals[cell];
    if (b == kNBase || q < min_in) continue;  // contributes exact zeros
    const int qi = min(max(q, 0), kTableQuals - 1);
    const float lo = tab[2 * qi], le = tab[2 * qi + 1];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ll[k] += (b == k) ? lo : le;
      cnt[k] += (b == k) ? 1 : 0;
    }
  }
  const int depth = cnt[0] + cnt[1] + cnt[2] + cnt[3];
  float qual;
  const int cons = finalize(ll, depth, min_cons, p2, &qual);
  base_out[idx] = (int8_t)cons;
  qual_out[idx] = (uint8_t)qual;
  depth_out[idx] = (int16_t)depth;
  err_out[idx] = (int16_t)(cons != kNBase ? depth - cnt[cons] : 0);
  if (ll_out != nullptr) {
    float4 v = make_float4(ll[0], ll[1], ll[2], ll[3]);
    reinterpret_cast<float4*>(ll_out)[idx] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
vote_finalize_kernel(const float* __restrict__ ll,
                     const int32_t* __restrict__ depth, long long n,
                     float min_cons, float p2, int8_t* __restrict__ base_out,
                     uint8_t* __restrict__ qual_out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float4 v = reinterpret_cast<const float4*>(ll)[idx];
  const float l[4] = {v.x, v.y, v.z, v.w};
  float qual;
  const int cons = finalize(l, depth[idx], min_cons, p2, &qual);
  base_out[idx] = (int8_t)cons;
  qual_out[idx] = (uint8_t)qual;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points (bound with ctypes), called with at least one
// output column. Each launches on `stream` and returns cudaGetLastError():
// 0 when the launch was accepted.
extern "C" int bsseq_seg_vote(const int8_t* bases, const int16_t* quals,
                              const int32_t* offsets, const float* table,
                              int S, int P, int W, int min_in, float min_cons,
                              float p2, int8_t* base_out, uint8_t* qual_out,
                              int16_t* depth_out, int16_t* err_out,
                              float* ll_out, void* stream) {
  const long long total = (long long)S * P * W;
  seg_vote_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      bases, quals, offsets, table, S, P, W, min_in, min_cons, p2, base_out,
      qual_out, depth_out, err_out, ll_out);
  return (int)cudaGetLastError();
}

extern "C" int bsseq_vote_finalize(const float* ll, const int32_t* depth,
                                   long long n, float min_cons, float p2,
                                   int8_t* base_out, uint8_t* qual_out,
                                   void* stream) {
  vote_finalize_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      ll, depth, n, min_cons, p2, base_out, qual_out);
  return (int)cudaGetLastError();
}
