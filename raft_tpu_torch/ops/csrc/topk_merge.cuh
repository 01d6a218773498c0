// The exact arms' selection, shared by kernel 2's Hopper arms' body
// (ivf_scan_arms.cuh) and kernel 1's exact Hopper body
// (fused_exact_hopper.cuh): a query's candidates, buffered in shared memory
// (distance, row of the tile), merged by one warp into the query's top-k
// list by (distance, position), the list taken into the warp's registers
// while it merges (entry j in lane j % 32, register j / 32). The merges
// are chains of dependent shuffles (PERF.md): one candidate at a time into
// a list of k <= 32 (merge_list), or the list and many candidates sorted
// together (warp_sort).
#pragma once

#include "scan_topk.cuh"

namespace rtt {
namespace arms {

constexpr int AT = NBINS;           // rows a tile of kernel 2's arms (128)
constexpr int SORT_MIN = 16;        // candidates from which a merge of
                                    // k > 32 sorts (exact)

// (a, pa) comes before (b, pb): by distance, then position
__device__ __forceinline__ bool before(float a, int pa, float b, int pb) {
  return a < b || (a == b && pa < pb);
}

// entry j of a warp's list of LP entries a lane (entry j in register j /
// 32 of lane j % 32), as every lane sees it
template <int LP>
__device__ __forceinline__ void list_at(const float* ld, const int* lp,
                                        int j, float& d, int& p) {
  float v = ld[0];
  int q = lp[0];
#pragma unroll
  for (int s = 1; s < LP; ++s)
    if ((j >> 5) == s) {
      v = ld[s];
      q = lp[s];
    }
  d = __shfl_sync(0xffffffffu, v, j & 31);
  p = __shfl_sync(0xffffffffu, q, j & 31);
}

// Merges 32 candidates (cd, cp), one a lane (+inf where none), into a
// query's sorted top-k (k <= 32 LP) held by one warp (list_at's layout),
// in any order: by (distance, position). Each one that comes before the
// k-th entry is inserted at its rank, the entries after it moving up one.
template <int LP>
__device__ __forceinline__ void merge_list(float* ld, int* lp, int k,
                                           float cd, int cp, int lane) {
  float kd;
  int kp;
  list_at<LP>(ld, lp, k - 1, kd, kp);
  unsigned mask = __ballot_sync(0xffffffffu, before(cd, cp, kd, kp));
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float vd = __shfl_sync(0xffffffffu, cd, src);
    const int vp = __shfl_sync(0xffffffffu, cp, src);
    int at = 0;
    float ud[LP], td[LP];
    int up[LP], tp[LP];
#pragma unroll
    for (int s = 0; s < LP; ++s) {
      at += __popc(__ballot_sync(0xffffffffu, before(ld[s], lp[s], vd, vp)));
      ud[s] = __shfl_up_sync(0xffffffffu, ld[s], 1);
      up[s] = __shfl_up_sync(0xffffffffu, lp[s], 1);
      td[s] = __shfl_sync(0xffffffffu, ld[s], 31);
      tp[s] = __shfl_sync(0xffffffffu, lp[s], 31);
    }
#pragma unroll
    for (int s = 0; s < LP; ++s) {
      const int j = 32 * s + lane;
      // the entry before j: lane - 1 of register s, or lane 31 of s - 1
      const int ps = s > 0 ? s - 1 : 0;
      const float pd = lane > 0 ? ud[s] : td[ps];
      const int pp = lane > 0 ? up[s] : tp[ps];
      if (j == at) {
        ld[s] = vd;
        lp[s] = vp;
      } else if (j > at) {
        ld[s] = pd;
        lp[s] = pp;
      }
    }
    list_at<LP>(ld, lp, k - 1, kd, kp);
    mask &= ~(1u << src);
    mask &= __ballot_sync(0xffffffffu, before(cd, cp, kd, kp));
  }
}

// Sorts a warp's 32 S elements (element i = S lane + j in register j) by
// (distance, position): a bitonic network whose strides under S compare
// two registers of a lane and wider ones two lanes by shuffles.
template <int S>
__device__ __forceinline__ void warp_sort(float* v, int* p, int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * S; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= S) {
        const int ls = stride / S;            // the partner lane's offset
        const bool lower = (lane & ls) == 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const bool up = ((S * lane + j) & size) == 0;
          const float pv = __shfl_xor_sync(0xffffffffu, v[j], ls);
          const int pp = __shfl_xor_sync(0xffffffffu, p[j], ls);
          // the lower element of an ascending pair keeps the smaller
          if (before(pv, pp, v[j], p[j]) == (lower == up)) {
            v[j] = pv;
            p[j] = pp;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int j2 = j ^ stride;
          if (j2 > j) {
            const bool up = ((S * lane + j) & size) == 0;
            if (before(v[j2], p[j2], v[j], p[j]) == up) {
              const float tv = v[j];
              const int tp = p[j];
              v[j] = v[j2];
              p[j] = p[j2];
              v[j2] = tv;
              p[j2] = tp;
            }
          }
        }
      }
    }
  }
}

// One warp merges block query qq's n buffered candidates (k + n <= 32 S)
// into its top-k list by sorting both together (warp_sort; padding (+inf,
// -1)), and returns the list's k-th distance; arguments as merge_query's.
// Without LIST the list is empty (+inf, -1), as before a query's first
// tile, and the candidates alone are sorted (n <= 32 S). A query's
// buffered candidates start at qq BS (kernel 1's exact body buffers 64
// rows a query).
template <int S, bool LIST = true, int BS = AT>
__device__ __forceinline__ float sort_query(float* sld, int* slp,
                                            const float* cbd,
                                            const unsigned char* cbr,
                                            int qq, int n, int r0, int k,
                                            int lane) {
  const int kl = LIST ? k : 0;   // list entries sorted in
  float v[S];
  int p[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = S * lane + j;
    v[j] = INFINITY;
    p[j] = -1;
    if (i < kl) {
      v[j] = sld[qq * k + i];
      p[j] = slp[qq * k + i];
    } else if (i - kl < n) {
      v[j] = cbd[qq * BS + i - kl];
      p[j] = r0 + cbr[qq * BS + i - kl];
    }
  }
  warp_sort<S>(v, p, lane);
  float kv = v[0];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int i = S * lane + j;
    if (i < k) {
      sld[qq * k + i] = v[j];
      slp[qq * k + i] = p[j];
    }
    if (j == (k - 1) % S) kv = v[j];
  }
  return __shfl_sync(0xffffffffu, kv, (k - 1) / S);
}

// One warp merges block query qq's n buffered candidates (distances cbd,
// rows cbr of the tile at r0, from qq BS) into its top-k list (sld / slp, k
// entries from qq k), and returns the list's k-th distance.
template <int LP, int BS = AT>
__device__ __forceinline__ float merge_query(float* sld, int* slp,
                                             const float* cbd,
                                             const unsigned char* cbr,
                                             int qq, int n, int r0, int k,
                                             int lane) {
  float ld[LP];
  int lp[LP];
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int j = 32 * s + lane;
    ld[s] = j < k ? sld[qq * k + j] : INFINITY;
    lp[s] = j < k ? slp[qq * k + j] : -1;
  }
  for (int c0 = 0; c0 < n; c0 += 32) {
    const bool has = c0 + lane < n;
    merge_list<LP>(ld, lp, k, has ? cbd[qq * BS + c0 + lane] : INFINITY,
                   has ? r0 + cbr[qq * BS + c0 + lane] : 0, lane);
  }
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int j = 32 * s + lane;
    if (j < k) {
      sld[qq * k + j] = ld[s];
      slp[qq * k + j] = lp[s];
    }
  }
  float kd;
  int kp;
  list_at<LP>(ld, lp, k - 1, kd, kp);
  return kd;
}

}  // namespace arms
}  // namespace rtt
