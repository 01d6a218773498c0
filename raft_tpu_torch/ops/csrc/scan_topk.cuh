// Shared core of the two hand-written kernels of raft_tpu_torch.ops:
// a block stages a tile of its queries and a tile of candidate rows in
// shared memory, computes their f32 dot products on the CUDA cores, applies
// the L2 / inner-product / cosine epilogue in min-space, and folds the tile
// into each query's running top-k of (distance, position) — ties go to the
// lower position, as in the TPU kernels' k-pass extraction.
//
// Operands: rows are f32, bf16 or int8 and are widened to f32 exactly as
// they are staged; with `round_ops` f32 rows are then rounded to bf16 (the
// reference's bf16 compute; bf16 and int8 rows are bf16 values already),
// without it f32 queries meet the widened rows unrounded (f32 x bf16 rows
// stays exact). Queries come in two modes, fixed at compile time: as the
// caller gives them (already rounded to bf16 with `round_ops`), a plain
// load; or, with STAGE_Q (the IVF-PQ residual queries), each component is
// staged as ((q - center) * scale) and then rounded.
//
// Layout: 256 threads as 16 x 16, each owning a 4 x 4 micro tile of the
// 64 x 64 (queries x rows) distance tile; the depth runs in slices of 32.
// After each tile, warp w keeps the top-k of queries w, w+8, ...: lanes
// hold one candidate each, a ballot picks the ones under the current k-th
// distance, and each is inserted in position order by one warp-wide shift
// of the sorted list (kept in dynamic shared memory, k <= 256).
//
// RTT_STAGES (a build flag, ops/_build.py) compiles in only the first
// stages, to split the kernel's time: 0 = the staging loads and the
// epilogue, 1 = plus the dots, 2 = plus the top-k selection (the whole
// kernel, the default). With fewer than 2 the outputs are not results.
#pragma once

#ifndef RTT_STAGES
#define RTT_STAGES 2
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rtt {

constexpr int QT = 64;          // queries per block
constexpr int RT = 64;          // candidate rows per tile
constexpr int DK = 32;          // depth of one staged slice
constexpr int PAD = 4;          // keeps float4 rows aligned, spreads banks
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int KMAX = 256;       // largest k a block keeps
constexpr int KPL = KMAX / 32;  // list slots per lane during an insertion

enum Metric { kL2 = 0, kIP = 1, kCosine = 2 };

struct __align__(16) Tiles {
  float qs[DK][QT + PAD];       // query slice, transposed
  float xs[DK][RT + PAD];       // row slice, transposed
  float dist[QT][RT + PAD];     // the tile's distances
  int qidx[QT];                 // global query index per slot, -1 = empty
  float qa[QT];                 // per-slot qaux (||q||^2 L2, ||q|| cosine)
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

// One staged query component: (q - center) * scale, then the operand
// rounding. Each step rounds once (no contraction), so a plain version
// that subtracts, multiplies and rounds in the same order gets the same
// bits.
__device__ __forceinline__ float stage_query(float q, const float* center,
                                             int c, float scale,
                                             bool round_ops) {
  float v = center ? __fsub_rn(q, center[c]) : q;
  v = __fmul_rn(v, scale);
  return round_ops ? round_bf16(v) : v;
}

// Inserts (vd, vp) into the sorted list td/tp of length k. vp is larger
// than every position in the list, so it goes after entries of equal
// distance. Called by all 32 lanes with the same (vd, vp).
__device__ __forceinline__ void warp_insert(float* td, int* tp, int k,
                                            float vd, int vp, int lane) {
  float nd[KPL];
  int np[KPL];
#pragma unroll
  for (int s = 0; s < KPL; ++s) {
    const int j = lane + 32 * s;
    nd[s] = 0.f;
    np[s] = 0;
    if (j < k) {
      const float od = td[j];
      if (od <= vd) {
        nd[s] = od;
        np[s] = tp[j];
      } else if (j == 0 || td[j - 1] <= vd) {
        nd[s] = vd;
        np[s] = vp;
      } else {
        nd[s] = td[j - 1];
        np[s] = tp[j - 1];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < KPL; ++s) {
    const int j = lane + 32 * s;
    if (j < k) {
      td[j] = nd[s];
      tp[j] = np[s];
    }
  }
  __syncwarp();
}

// Scans positions [p_begin, p_end) of `rows` (row p at rows + p * d)
// against the block's queries (t.qidx, with their qaux in t.qa, both set
// by the caller) and leaves each query's top-k in topd / topp [QT * k],
// sorted by (distance, position); unfilled slots hold (+inf, -1). `norms`
// and `keep` are indexed by position and may be null (no norms for inner
// product; no filter). With STAGE_Q queries are staged through
// stage_query with `qcenter` (may be null), `qscale` and `round_ops`;
// without it they are loaded as given. f32 rows are rounded to bf16 with
// `round_ops`.
template <typename T, bool STAGE_Q>
__device__ void scan_topk(Tiles& t, float* topd, int* topp,
                          const float* __restrict__ queries,
                          const float* __restrict__ qcenter, float qscale,
                          const T* __restrict__ rows,
                          const float* __restrict__ norms,
                          const int* __restrict__ keep, int p_begin,
                          int p_end, int d, int k, int metric,
                          bool round_ops) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  for (int i = tid; i < QT * k; i += NTHREADS) {
    topd[i] = INFINITY;
    topp[i] = -1;
  }
  __syncthreads();
  float qa[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qa[i] = t.qa[ty * 4 + i];

  for (int r0 = p_begin; r0 < p_end; r0 += RT) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      for (int e = tid; e < QT * DK; e += NTHREADS) {
        const int r = e / DK, c = e % DK;
        const int q = t.qidx[r];
        float v = 0.f;
        if (q >= 0 && d0 + c < d) {
          v = queries[(size_t)q * d + d0 + c];
          if (STAGE_Q) v = stage_query(v, qcenter, d0 + c, qscale, round_ops);
        }
        t.qs[c][r] = v;
      }
      for (int e = tid; e < RT * DK; e += NTHREADS) {
        const int r = e / DK, c = e % DK;
        const int p = r0 + r;
        float v = 0.f;
        if (p < p_end && d0 + c < d) {
          v = to_f32(rows[(size_t)p * d + d0 + c]);
          if (std::is_same<T, float>::value && round_ops) v = round_bf16(v);
        }
        t.xs[c][r] = v;
      }
      __syncthreads();
#if RTT_STAGES >= 1
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&t.qs[c][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&t.xs[c][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#else
      // keep the staged slices live without the dots
      acc[0][0] += t.qs[tx][ty * 4] + t.xs[ty][tx * 4];
#endif
      __syncthreads();
    }

    // epilogue: min-space distance, +inf where the row is past the end or
    // filtered out
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = r0 + tx * 4 + j;
      const bool ok = p < p_end && (keep == nullptr || keep[p] > 0);
      const float xn = (ok && metric != kIP) ? norms[p] : 0.f;
      const float plen = sqrtf(fmaxf(xn, 1e-30f));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dot = acc[i][j];
        float dv;
        if (!ok) {
          dv = INFINITY;
        } else if (metric == kL2) {
          dv = fmaxf(__fsub_rn(__fadd_rn(qa[i], xn), __fmul_rn(2.f, dot)),
                     0.f);
        } else if (metric == kIP) {
          dv = -dot;
        } else {
          dv = __fsub_rn(1.f,
                         __fdiv_rn(dot, fmaxf(__fmul_rn(qa[i], plen), 1e-30f)));
        }
        t.dist[ty * 4 + i][tx * 4 + j] = dv;
      }
    }
    __syncthreads();

    for (int qq = warp; qq < QT; qq += NWARPS) {
      if (t.qidx[qq] < 0) continue;
      float* td = topd + qq * k;
      int* tp = topp + qq * k;
#if RTT_STAGES < 2
      // keep the distances live without the selection (and every stored
      // position valid, since the caller reads ids through them)
      if (lane == 0) {
        td[0] = fminf(td[0], t.dist[qq][r0 & 31]);
        tp[0] = r0;
      }
#else
      for (int half = 0; half < RT; half += 32) {
        const float cd = t.dist[qq][half + lane];
        const int cp = r0 + half + lane;
        float thr = td[k - 1];
        unsigned mask = __ballot_sync(0xffffffffu, cd < thr);
        while (mask) {
          const int src = __ffs(mask) - 1;
          const float vd = __shfl_sync(0xffffffffu, cd, src);
          const int vp = __shfl_sync(0xffffffffu, cp, src);
          warp_insert(td, tp, k, vd, vp, lane);
          thr = td[k - 1];
          mask &= ~(1u << src);
          mask &= __ballot_sync(0xffffffffu, cd < thr);
        }
      }
#endif
    }
    __syncthreads();
  }
}

// Dynamic shared memory a block needs for its top-k lists.
inline size_t topk_smem_bytes(int k) {
  return (size_t)QT * k * (sizeof(float) + sizeof(int));
}

}  // namespace rtt

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
