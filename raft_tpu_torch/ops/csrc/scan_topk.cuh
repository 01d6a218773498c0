// Shared core of the two hand-written kernels of raft_tpu_torch.ops:
// a block stages a tile of its queries and a tile of candidate rows in
// shared memory, computes their f32 dot products on the CUDA cores, applies
// the L2 / inner-product / cosine epilogue in min-space, and folds the tile
// into each query's running top-k of (distance, position) — ties go to the
// lower position, as in the TPU kernels' k-pass extraction.
//
// Operands: rows are f32, bf16, f16, int8 or uint8 and are widened to f32
// exactly as they are staged; with `round_ops` f32 and f16 rows are then
// rounded to bf16 (the reference's bf16 compute casts its rows to bf16;
// bf16, int8 and uint8 rows are bf16 values already),
// without it f32 queries meet the widened rows unrounded (f32 x bf16 rows
// stays exact). Queries come in two modes, fixed at compile time: as the
// caller gives them (already rounded to bf16 with `round_ops`), a plain
// load; or, with STAGE_Q (the IVF-PQ residual queries), each component is
// staged as ((q - center) * scale) and then rounded.
//
// Rows come in three layouts, fixed at compile time (ROWS): dense
// [rows, d] of type T; packed signed int4, 8 components a 32-bit word; or
// packed sign bits, 32 a word (IVF-PQ's i4 and RaBitQ caches). Packed
// rows are stored transposed, word w of row p at rows[w * row_stride + p],
// so neighbouring threads read neighbouring rows of one word-row; each
// thread loads one word of the slice and writes its decoded components
// (exact in bf16: [-8, 7] or +-1). In the RaBitQ layout `row_scale` (when
// given) multiplies each row's dot before the epilogue. With STAGE_Q and
// SCALE_VEC the staged query's scale is a per-component vector (the i4
// and raw caches' per-list scales) instead of one float.
//
// Layout: 256 threads as 16 x 16, each owning a 4 x 4 micro tile of the
// 64 x 64 (queries x rows) distance tile; the depth runs in slices of 32.
// After each tile, warp w keeps the top-k of queries w, w+8, ...: lanes
// hold one candidate each, a ballot picks the ones under the current k-th
// distance, and each is inserted in position order by one warp-wide shift
// of the sorted list (kept in dynamic shared memory, k <= 256).
//
// Extraction (EXTRACT, a compile-time switch; exact by default). The
// binned arms of the TPU kernel (raft_tpu/ops/ivf_scan.py:89 binned, :123
// binned_deep) and the fold arms of both TPU kernels (fused_topk.py:102,
// ivf_scan.py:169) keep, instead of the top-k lists, R slots per bin of
// 128 (R = 1 binned, 4 binned_deep, 2-4 fold), a position's bin being its
// offset from
// the scan's first position mod 128: level r of bin b of query q at
// [q][r][b], the distance as a float and the position as its 128-chunk in
// 16 bits (6 bytes a slot, so binned_deep's 64 queries x 512 slots fit
// beside the tiles in one block's 227 KB). A newcomer enters by the
// reference's compare-swap cascade with a strict `<` (bin_candidates):
// it takes the first level whose slot it beats and the displaced slot
// goes on down. A 64-row tile that starts at a multiple of 64 covers 64
// distinct bins, so the lane that owns a (query, position) owns its bin
// for that tile, and tiles taken in position order give the reference's
// order with no atomics. After the scan a warp extracts each of its
// queries' k entries (extract_bins), ordered as the reference's arms
// order them; the fold arms write every slot out unextracted instead
// (the caller's write-out).
//
// RTT_STAGES (a build flag, ops/_build.py) compiles in only the first
// stages, to split the kernel's time: 0 = the staging loads and the
// epilogue, 1 = plus the dots, 2 = plus the top-k selection (the whole
// kernel, the default; for the binned arms the bin updates and the
// extraction). With fewer than 2 the outputs are not results.
#pragma once

#ifndef RTT_STAGES
#define RTT_STAGES 2
#endif

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
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
enum Rows { kRowsDense = 0, kRowsI4 = 1, kRowsBits = 2 };
// the fold arms at depth R = 2, 3, 4 are kFold2 + R - 2
enum Extract {
  kExact = 0, kBinned = 1, kBinnedDeep = 2, kFold2 = 3, kFold3 = 4,
  kFold4 = 5
};

constexpr int NBINS = 128;      // bins of the binned and fold arms
__host__ __device__ constexpr bool is_fold(int extract) {
  return extract >= kFold2;
}
// slots a bin keeps: one for binned, R = 4 for binned_deep, R for fold
__host__ __device__ constexpr int bin_depth(int extract) {
  return extract == kBinnedDeep ? 4 : is_fold(extract) ? extract - kFold2 + 2
                                                       : 1;
}

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
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
}
// rows whose values are not all bf16 values, rounded under `round_ops`
template <typename T>
constexpr bool kRoundsToBf16 =
    std::is_same<T, float>::value || std::is_same<T, __half>::value;

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

// Folds one query's row of RT tile distances `drow` (positions r0,
// r0 + 1, ...) into its sorted list td/tp of length k, 32 candidates at a
// time, one a lane: a ballot picks the lanes under the current k-th
// distance and each is inserted in lane order.
__device__ __forceinline__ void fold_candidates(float* td, int* tp, int k,
                                                const float* drow, int r0,
                                                int lane) {
  for (int half = 0; half < RT; half += 32) {
    const float cd = drow[half + lane];
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
}

// Folds one query's row of RT tile distances `drow` (positions rel, rel +
// 1, ..., rel a multiple of RT from the scan's first) into its bins of
// depth R: level r of bin b at sd / sc[r * NBINS + b], sc holding the
// position's 128-chunk. Lane l owns positions rel + l and rel + 32 + l.
// A distance that does not beat the bin's last level changes nothing (the
// levels are sorted), so most candidates stop at one read; +inf and NaN
// never enter.
template <int R>
__device__ __forceinline__ void bin_candidates(float* sd, uint16_t* sc,
                                               const float* drow, int rel,
                                               int lane) {
  const uint16_t chunk = static_cast<uint16_t>(rel >> 7);
#pragma unroll
  for (int half = 0; half < RT; half += 32) {
    float nd = drow[half + lane];
    const int b = (rel + half + lane) & (NBINS - 1);
    if (!(nd < sd[(R - 1) * NBINS + b])) continue;
    uint16_t nc = chunk;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float od = sd[r * NBINS + b];
      if (nd < od) {
        const uint16_t oc = sc[r * NBINS + b];
        sd[r * NBINS + b] = nd;
        sc[r * NBINS + b] = nc;
        nd = od;
        nc = oc;
      }
    }
  }
}

// One warp takes k entries from one query's bins of depth R (sd / sc of
// that query, [R][NBINS]) in the reference's order — binned (R = 1) by
// distance, then position; binned_deep by distance, then bin, then level
// — and writes each entry's distance and id (ids[position]) to od / oi;
// once the least left is +inf the rest are (+inf, -1). Lane l holds bins
// l, l + 32, l + 64, l + 96 in registers; each pass is a lane-local
// minimum and a 5-step butterfly over (distance, key), after which the
// lane holding the winner drops it. All 32 lanes call it.
template <int R>
__device__ void extract_bins(const float* sd, const uint16_t* sc, int k,
                             const int* __restrict__ ids, float* od,
                             int* oi, int lane) {
  constexpr int S = 4 * R;
  float v[S];
  int key[S];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = lane + 32 * i;
      v[i * R + r] = sd[r * NBINS + b];
      key[i * R + r] = R == 1 ? b + NBINS * sc[b] : b * R + r;
    }
  for (int j = 0; j < k; ++j) {
    float bd = INFINITY;
    int bk = INT_MAX;
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (v[s] < bd || (v[s] == bd && key[s] < bk)) {
        bd = v[s];
        bk = key[s];
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float d2 = __shfl_xor_sync(0xffffffffu, bd, off);
      const int k2 = __shfl_xor_sync(0xffffffffu, bk, off);
      if (d2 < bd || (d2 == bd && k2 < bk)) {
        bd = d2;
        bk = k2;
      }
    }
    if (bd == INFINITY) {
      for (int jj = j + lane; jj < k; jj += 32) {
        od[jj] = INFINITY;
        oi[jj] = -1;
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (key[s] == bk) v[s] = INFINITY;
    if (lane == 0) {
      const int pos =
          R == 1 ? bk
                 : bk / R + NBINS * sc[(bk % R) * NBINS + bk / R];
      od[j] = bd;
      oi[j] = ids[pos];
    }
  }
}

// The min-space distance of one (query, row) pair from its dot, the
// query's qaux and the row's norm xn (unread for inner product) and
// plen = sqrt(max(xn, 1e-30)) (read for cosine only).
__device__ __forceinline__ float epilogue_dist(float dot, float qa, float xn,
                                               float plen, int metric) {
  if (metric == kL2)
    return fmaxf(__fsub_rn(__fadd_rn(qa, xn), __fmul_rn(2.f, dot)), 0.f);
  if (metric == kIP) return -dot;
  return __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(qa, plen), 1e-30f)));
}

// Scans positions [p_begin, p_end) of `rows` (row p at rows + p * d)
// against the block's queries (t.qidx, with their qaux in t.qa, both set
// by the caller) and leaves each query's top-k in topd / topp [QT * k],
// sorted by (distance, position); unfilled slots hold (+inf, -1). `norms`
// and `keep` are indexed by position and may be null (no norms for inner
// product; no filter). With STAGE_Q queries are staged through
// stage_query with `qcenter` (may be null), `qscale` (with SCALE_VEC the
// vector `qscale_vec` [d]) and `round_ops`; without it they are loaded as
// given. f32 rows are rounded to bf16 with `round_ops`. Packed rows
// (ROWS) are words of type T = uint32_t, `row_stride` words apart per
// word-row, and `row_scale` (RaBitQ, may be null) is indexed by position.
// With a binned EXTRACT the block keeps bins instead (header): topd holds
// the distances [QT][R][NBINS] and topp, read as uint16_t, the chunks;
// unfilled slots hold +inf, and the caller extracts (extract_bins).
template <typename T, bool STAGE_Q, int ROWS = kRowsDense,
          bool SCALE_VEC = false, int EXTRACT = kExact>
__device__ void scan_topk(Tiles& t, float* topd, int* topp,
                          const float* __restrict__ queries,
                          const float* __restrict__ qcenter, float qscale,
                          const T* __restrict__ rows,
                          const float* __restrict__ norms,
                          const int* __restrict__ keep, int p_begin,
                          int p_end, int d, int k, int metric,
                          bool round_ops,
                          const float* __restrict__ qscale_vec = nullptr,
                          const float* __restrict__ row_scale = nullptr,
                          int row_stride = 0) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  constexpr int R = bin_depth(EXTRACT);
  uint16_t* sc = reinterpret_cast<uint16_t*>(topp);
  if constexpr (EXTRACT == kExact) {
    for (int i = tid; i < QT * k; i += NTHREADS) {
      topd[i] = INFINITY;
      topp[i] = -1;
    }
  } else {
    for (int i = tid; i < QT * R * NBINS; i += NTHREADS) {
      topd[i] = INFINITY;
      sc[i] = 0;
    }
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
          if constexpr (STAGE_Q)
            v = stage_query(v, qcenter, d0 + c,
                            SCALE_VEC ? qscale_vec[d0 + c] : qscale,
                            round_ops);
        }
        t.qs[c][r] = v;
      }
      if constexpr (ROWS == kRowsDense) {
        for (int e = tid; e < RT * DK; e += NTHREADS) {
          const int r = e / DK, c = e % DK;
          const int p = r0 + r;
          float v = 0.f;
          if (p < p_end && d0 + c < d) {
            v = to_f32(rows[(size_t)p * d + d0 + c]);
            if (kRoundsToBf16<T> && round_ops) v = round_bf16(v);
          }
          t.xs[c][r] = v;
        }
      } else {
        // one word a thread: (row r, quarter h of the 32-component slice)
        static_assert(RT * 4 == NTHREADS, "one packed word per thread");
        const int r = tid % RT, h = tid / RT;
        const int p = r0 + r;
        if constexpr (ROWS == kRowsI4) {
          // 4 words of 8 signed nibbles; d = 8 nw, so words past it are 0
          const int w = d0 / 8 + h;
          const bool ok = p < p_end && w * 8 < d;
          const uint32_t word =
              ok ? static_cast<uint32_t>(rows[(size_t)w * row_stride + p])
                 : 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            t.xs[h * 8 + j][r] =
                ok ? static_cast<float>(static_cast<int>(word << (28 - 4 * j))
                                        >> 28)
                   : 0.f;
        } else {
          // one word of 32 sign bits (d = 32 nw); this thread decodes 8
          const bool ok = p < p_end;
          const uint32_t word =
              ok ? static_cast<uint32_t>(rows[(size_t)(d0 / 32) * row_stride +
                                              p])
                 : 0u;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = h * 8 + j;
            t.xs[c][r] = ok ? ((word >> c) & 1u ? 1.f : -1.f) : 0.f;
          }
        }
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
      float rs = 1.f;
      if constexpr (ROWS == kRowsBits)
        if (ok && row_scale != nullptr) rs = row_scale[p];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float dot = acc[i][j];
        if constexpr (ROWS == kRowsBits) dot = __fmul_rn(dot, rs);
        float dv;
        if (!ok) {
          dv = INFINITY;
        } else {
          dv = epilogue_dist(dot, qa[i], xn, plen, metric);
        }
        t.dist[ty * 4 + i][tx * 4 + j] = dv;
      }
    }
    __syncthreads();

    for (int qq = warp; qq < QT; qq += NWARPS) {
      if (t.qidx[qq] < 0) continue;
      if constexpr (EXTRACT == kExact) {
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
        fold_candidates(td, tp, k, t.dist[qq], r0, lane);
#endif
      } else {
        float* qd = topd + qq * R * NBINS;
#if RTT_STAGES < 2
        // keep the distances live without the bins (chunk 0 of bin 0 is
        // a valid position)
        if (lane == 0) qd[0] = fminf(qd[0], t.dist[qq][r0 & 31]);
#else
        bin_candidates<R>(qd, sc + qq * R * NBINS, t.dist[qq],
                          r0 - p_begin, lane);
#endif
      }
    }
    __syncthreads();
  }
}

// Dynamic shared memory a block of `nq` queries needs for its top-k lists
// (exact) or its bins (the binned and fold arms: 6 B a slot, 96 KB at
// 64 queries for fold at R = 2, 192 KB at R = 4).
inline size_t topk_smem_bytes(int k, int extract = kExact, int nq = QT) {
  if (extract == kExact)
    return (size_t)nq * k * (sizeof(float) + sizeof(int));
  return (size_t)nq * bin_depth(extract) * NBINS *
         (sizeof(float) + sizeof(uint16_t));
}

}  // namespace rtt

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
