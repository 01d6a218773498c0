// cagra_beam_step — one CAGRA beam-search iteration on Hopper.
//
// Replaces raft_tpu/ops/beam_step.py:_beam_step_kernel (pallas_call at
// :443, entry beam_merge_step :319). One block per query, as in the
// reference's single-CTA search (search_single_cta_kernel-inl.cuh:585):
//
//   1. candidates: either pre-scored (the seeding arm) or decoded from the
//      packed rows of the query's `width` parents, read from `nbr_pack` by
//      parent id inside the kernel (the TPU caller gathers them first, a
//      205 MB copy per iteration at m = 10k, W = 1280). Each packed row is
//      [deg * d/4 code words | deg norm bitcasts (L2) | deg ids]; code word
//      e * d/4 + t holds int8 dims 4t..4t+3 of neighbour e. A byte's
//      product is bf16(int8 * bf16 q) and the four bytes of a word are
//      added in f32 in order j = 0..3 from 0, as on the TPU. The words of
//      a neighbour (padded with zeros to P = next_pow2(d/4)) are summed by
//      a fixed tree — adjacent pairs, level by level — inside a thread and
//      then across its segment by xor shuffles of 1, 2, 4, ...; the plain
//      version sums in the same tree, so the two agree bit for bit. L2
//      scores are norm - dots (||q||^2 is added back by the caller), inner
//      product -dots; an id < 0 or a parent < 0 scores +inf.
//   2. merge: the itopk buffer and the candidates, padded with (+inf, -1)
//      to LL = next_pow2(L + C), go through the bitonic network of
//      matrix/bitonic.py in shared memory, ids riding as
//      (id << 1) | explored.
//   3. windowed dedup: a copy within `window` slots of an earlier copy of
//      its id is blanked to (+inf, -1) and hands its explored flag to the
//      earlier one (one window step after the other, as on the TPU).
//   4. the first `width` unexplored live entries of the first L become the
//      next parents and are marked explored (a warp ballot ranks them).
//
// Bound on the H100: bytes — per query the buffer in and out, the query,
// and the parents' packed rows; at the main path's shapes (m = 10,000,
// width = 4, W = 1280) the rows are ~0.2 GB per step against a few
// hundred MFLOP. The kernel reads each parent's row once per query that
// picked it; PERF.md holds its time against the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rtt_error.cuh"

namespace {

constexpr int NT = 256;
constexpr int LL_MAX = 2048;
constexpr int PER_T = LL_MAX / NT;
constexpr int WIDTH_MAX = 64;
constexpr int D_MAX = 2048;

struct Args {
  const float* buf_d;
  const int* buf_i;
  const int* buf_e;
  const float* cand_d;          // scored arm [m, C]
  const int* cand_i;
  const __nv_bfloat16* qs;      // packed arm [m, d], scaled
  const int* pack;              // [n, W]
  const int* parents;           // [m, width]
  int L, C, deg, d, W, o_norm, o_id, width, window, ip, LL;
  float* out_bd;
  int* out_bi;
  int* out_be;
  int* out_par;
  float* out_cd;                // emit_cands (packed arm), or null
  int* out_ci;
};

__device__ __forceinline__ float word_dot(int w, const float* q4) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int b = (int)((unsigned)w << (24 - 8 * j)) >> 24;  // byte j, signed
    acc = __fadd_rn(acc, __bfloat162float(__float2bfloat16_rn(
                             __fmul_rn((float)b, q4[j]))));
  }
  return acc;
}

// Scores the C = width * deg candidates of one query into kd/kie[L, L+C).
// WPT words per thread, SEG = P / WPT threads per neighbour.
template <int WPT>
__device__ void score_packed(const Args& a, size_t qi, const float* qf,
                             const int* par_in, float* kd, int* kie) {
  const int dq = a.d >> 2;
  int P = 1;
  while (P < dq) P <<= 1;
  const int seg = P / WPT;                       // power of two, <= 32
  const int per_round = NT / seg;
  const int s_lane = threadIdx.x % seg;
  const bool vec = WPT % 4 == 0 && dq % 4 == 0;   // 16-byte word loads
  for (int base = 0; base < a.C; base += per_round) {
    const int c = base + threadIdx.x / seg;
    const bool active = c < a.C;
    const int w = active ? c / a.deg : 0;
    const int e = active ? c % a.deg : 0;
    const int p = active ? par_in[w] : -1;
    float v[WPT];
#pragma unroll
    for (int i = 0; i < WPT; ++i) v[i] = 0.0f;
    if (p >= 0) {
      const int* row = a.pack + (size_t)p * a.W + (size_t)e * dq;
      const int t0 = s_lane * WPT;
      if constexpr (WPT % 4 == 0) {
        if (vec) {
#pragma unroll
          for (int i = 0; i < WPT; i += 4) {
            if (t0 + i >= dq) break;
            const int4 x = __ldg(reinterpret_cast<const int4*>(row + t0 + i));
            v[i] = word_dot(x.x, qf + 4 * (t0 + i));
            v[i + 1] = word_dot(x.y, qf + 4 * (t0 + i + 1));
            v[i + 2] = word_dot(x.z, qf + 4 * (t0 + i + 2));
            v[i + 3] = word_dot(x.w, qf + 4 * (t0 + i + 3));
          }
        }
      }
      if (!vec) {
#pragma unroll
        for (int i = 0; i < WPT; ++i)
          if (t0 + i < dq)
            v[i] = word_dot(__ldg(row + t0 + i), qf + 4 * (t0 + i));
      }
    }
    // adjacent-pairs tree: inside the thread, then across the segment
#pragma unroll
    for (int h = 1; h < WPT; h <<= 1)
#pragma unroll
      for (int i = 0; i < WPT; i += 2 * h) v[i] = __fadd_rn(v[i], v[i + h]);
    float dot = v[0];
    for (int o = 1; o < seg; o <<= 1)
      dot = __fadd_rn(dot, __shfl_xor_sync(0xffffffffu, dot, o));
    if (active && s_lane == 0) {
      float cd = INFINITY;
      int id = -1;
      if (p >= 0) {
        const int* prow = a.pack + (size_t)p * a.W;
        id = __ldg(prow + a.o_id + e);
        if (id >= 0)
          cd = a.ip ? -dot
                    : __fsub_rn(__int_as_float(__ldg(prow + a.o_norm + e)), dot);
      }
      kd[a.L + c] = cd;
      kie[a.L + c] = id * 2;           // -1 encodes as -2: (id -1, unexplored)
      if (a.out_cd != nullptr) {
        a.out_cd[qi * a.C + c] = cd;
        a.out_ci[qi * a.C + c] = id;
      }
    }
  }
}

__device__ void bitonic_sort(float* kd, int* kie, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += NT) {
        const int i = 2 * j * (t / j) + (t % j);
        const int l = i + j;
        const float a = kd[i], b = kd[l];
        if (((i & k) == 0) ? a > b : a < b) {
          kd[i] = b;
          kd[l] = a;
          const int x = kie[i];
          kie[i] = kie[l];
          kie[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

template <int WPT>   // 0 = the pre-scored arm
__global__ void __launch_bounds__(NT) beam_step_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);                 // d
  float* kd = qf + (WPT ? a.d : 0);                           // LL
  int* kie = reinterpret_cast<int*>(kd + a.LL);               // LL
  int* par_in = kie + a.LL;                                   // width
  int* par_out = par_in + a.width;                            // width

  const size_t qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int L = a.L, LL = a.LL;

  for (int t = tid; t < L; t += NT) {
    kd[t] = a.buf_d[qi * L + t];
    kie[t] = (a.buf_i[qi * L + t] * 2) | (a.buf_e[qi * L + t] & 1);
  }
  for (int t = L + a.C + tid; t < LL; t += NT) {
    kd[t] = INFINITY;
    kie[t] = -1;
  }
  for (int t = tid; t < a.width; t += NT) {
    par_out[t] = -1;
    if (WPT) par_in[t] = a.parents[qi * a.width + t];
  }
  if (WPT) {
    for (int t = tid; t < a.d; t += NT)
      qf[t] = __bfloat162float(a.qs[qi * a.d + t]);
  } else {
    for (int t = tid; t < a.C; t += NT) {
      const int id = a.cand_i[qi * a.C + t];
      kd[L + t] = id < 0 ? INFINITY : a.cand_d[qi * a.C + t];
      kie[L + t] = id * 2;
    }
  }
  __syncthreads();
  if (WPT) {
    score_packed<WPT ? WPT : 1>(a, qi, qf, par_in, kd, kie);
    __syncthreads();
  }

  bitonic_sort(kd, kie, LL);

  // windowed dedup, one window step after the other
  unsigned dup = 0;                     // bit s: slot tid + s * NT
  for (int w = 1; w <= a.window; ++w) {
    int nk[PER_T];
#pragma unroll
    for (int s = 0; s < PER_T; ++s) {
      const int p = tid + s * NT;
      nk[s] = 0;
      if (p >= LL) continue;
      const int here = kie[p];
      const int id = here >> 1;
      if (p >= w && id >= 0 && (kie[p - w] >> 1) == id) dup |= 1u << s;
      nk[s] = here;
      if (p + w < LL && id >= 0 && (kie[p + w] >> 1) == id)
        nk[s] |= kie[p + w] & 1;        // the earlier copy inherits
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < PER_T; ++s) {
      const int p = tid + s * NT;
      if (p < LL) kie[p] = nk[s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < PER_T; ++s) {
    const int p = tid + s * NT;
    if (p < LL && (dup >> s & 1u)) {
      kd[p] = INFINITY;
      kie[p] = -1;
    }
  }
  __syncthreads();

  // parents: the first `width` unexplored live slots of the first L
  if (tid < 32) {
    int base = 0;
    for (int c0 = 0; c0 < L && base < a.width; c0 += 32) {
      const int p = c0 + tid;
      bool une = false;
      if (p < L) {
        const int x = kie[p];
        une = (x & 1) == 0 && (x >> 1) >= 0 && kd[p] < INFINITY;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, une);
      const int rank = base + __popc(bal & ((1u << tid) - 1u));
      if (une && rank < a.width) {
        par_out[rank] = kie[p] >> 1;
        kie[p] |= 1;
      }
      base += __popc(bal);
    }
  }
  __syncthreads();

  for (int t = tid; t < L; t += NT) {
    a.out_bd[qi * L + t] = kd[t];
    a.out_bi[qi * L + t] = kie[t] >> 1;
    a.out_be[qi * L + t] = kie[t] & 1;
  }
  for (int t = tid; t < a.width; t += NT)
    a.out_par[qi * a.width + t] = par_out[t];
}

template <int WPT>
int launch(const Args& a, int m, cudaStream_t stream) {
  const size_t smem = (size_t)(WPT ? a.d : 0) * sizeof(float) +
                      (size_t)a.LL * (sizeof(float) + sizeof(int)) +
                      (size_t)2 * a.width * sizeof(int);
  beam_step_kernel<WPT><<<m, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// buf_d / buf_i / buf_e [m, L] (sorted buffer, explored flags 0/1).
// Pre-scored arm: cand_d / cand_i [m, C], qs = pack = parents = null.
// Packed arm: cand_d = cand_i = null; qs [m, d] bf16 (q * (2 or 1) *
// code_scale); nbr_pack [n, W] int32 with regions at 0, o_norm, o_id;
// parents [m, width] (< 0 masks the block); C = width * deg. Outputs:
// out_bd / out_bi / out_be [m, L], out_par [m, width], and for the packed
// arm optionally out_cd / out_ci [m, C]. Returns a cudaError_t code.
extern "C" int cagra_beam_step(const void* buf_d, const void* buf_i,
                               const void* buf_e, const void* cand_d,
                               const void* cand_i, const void* qs,
                               const void* nbr_pack, const void* parents,
                               int m, int L, int C, int deg, int d, int W,
                               int o_norm, int o_id, int width, int window,
                               int ip, void* out_bd, void* out_bi,
                               void* out_be, void* out_par, void* out_cd,
                               void* out_ci, void* stream) {
  const bool scored = cand_d != nullptr;
  int LL = 1;
  while (LL < L + C) LL <<= 1;
  if (m < 1 || L < 1 || C < 0 || width < 1 || width > WIDTH_MAX ||
      window < 0 || LL > LL_MAX || (scored && cand_i == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(buf_d), static_cast<const int*>(buf_i),
         static_cast<const int*>(buf_e), static_cast<const float*>(cand_d),
         static_cast<const int*>(cand_i),
         static_cast<const __nv_bfloat16*>(qs),
         static_cast<const int*>(nbr_pack), static_cast<const int*>(parents),
         L, C, deg, d, W, o_norm, o_id, width, window, ip, LL,
         static_cast<float*>(out_bd), static_cast<int*>(out_bi),
         static_cast<int*>(out_be), static_cast<int*>(out_par),
         static_cast<float*>(out_cd), static_cast<int*>(out_ci)};
  auto s = static_cast<cudaStream_t>(stream);
  if (scored) return launch<0>(a, m, s);
  if (qs == nullptr || nbr_pack == nullptr || parents == nullptr ||
      deg < 1 || d < 4 || d % 4 || d > D_MAX || C != width * deg ||
      W % 4 || o_id + deg > W || (!ip && o_norm + deg > W))
    return (int)cudaErrorInvalidValue;
  int P = 1;
  while (P < d / 4) P <<= 1;
  // words per thread: 4 where a neighbour has 4..128, more beyond
  const int wpt = P < 4 ? P : (P <= 128 ? 4 : P / 32);
  switch (wpt) {
    case 1: return launch<1>(a, m, s);
    case 2: return launch<2>(a, m, s);
    case 4: return launch<4>(a, m, s);
    case 8: return launch<8>(a, m, s);
    case 16: return launch<16>(a, m, s);
  }
  return (int)cudaErrorInvalidValue;
}
