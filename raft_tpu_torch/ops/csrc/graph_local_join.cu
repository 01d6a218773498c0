// graph_local_join — the nn-descent local join on Hopper.
//
// Replaces raft_tpu/ops/graph_join.py:_join_kernel (pallas_call at :257).
// Per node row b: score its C candidates against its own vector (L2
// max(||q||^2 + ||c||^2 - 2 q.c, 0), or inner product -q.c; id < 0 is
// +inf), pool them with the row's current list of K, and write the pool's
// unique-by-id top-K: a duplicate id keeps its smallest distance, ties go
// to the smallest id, and unfilled slots are (+inf, -1).
//
// One warp per node row, four rows a block, six blocks an SM, and no block
// barrier: a row's gathers, its merge and its write-out are the warp's
// alone, so rows that merge sit beside rows that gather. The
// TPU kernel takes the candidate vectors pre-gathered into a [B, C, d]
// slab (the gather stays in XLA there); here the warp reads its
// candidates' rows from `data` by id, 16 bytes a lane, eight candidates in
// flight, so the 7.5 GB slab of a 65,536-row block at C = 224, d = 128
// never exists. The eight partial dots are reduced across the warp by a
// transposing butterfly (9 shuffles for 8 candidates, each sum taken in
// one fixed order whatever the candidate's slot).
//
// The merge keeps the pool (K + C <= 2048 entries, padded to P =
// next_pow2) in registers, P / 32 64-bit (distance, id) keys a lane:
// - dedup: each valid entry's id goes into a per-warp hash table in shared
//   memory (2P slots, linear probing), whose slot keeps the id's smallest
//   ordered distance by atomicMin (a minimum does not depend on the order
//   of the inserts); then one entry at that distance claims the slot, the
//   list's before the candidates, and every other copy drops out;
// - selection: bitonic sorts in registers, shuffles across lanes, no
//   shared memory. The list is the last join's output, so it is as a rule
//   already in order; then only the candidates are sorted and one merge
//   step takes the smallest half (half the full sort's work at the
//   main path's P = 512). Otherwise, or where K or C is over P / 2, all P
//   keys are sorted. The first K keys are the answer.
// The TPU kernel reaches the same list by K passes of min-extraction that
// mask by id.
//
// Bound on the H100: bytes. Per launch it must read the block's rows, ids
// and lists and each referenced data row once; at the main path's shapes
// the dots are 3.8 GFLOP (f32), well under the bytes. The kernel reads a
// candidate row once per reference (C per node, ~115 GB per nn-descent
// iteration at 1M rows), relying on L2 for reuse; PERF.md holds the time
// against both counts.
//
// RTT_STAGES (a build flag, ops/_build.py) compiles in only the first
// stages, to split the kernel's time: 0 = the candidate rows gathered and
// summed without the query (and the pool written), 1 = plus the scores
// (dots, warp reduction, distances), 2 = plus the merge (the whole
// kernel). The partial builds write a digest of the pool, not a result.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rtt_error.cuh"

#ifndef RTT_STAGES
#define RTT_STAGES 2
#endif

namespace {

constexpr int WPB = 4;                  // warps (node rows) per block
constexpr int NT = WPB * 32;
constexpr int U = 8;                    // candidates per gather round
constexpr int POOL_MAX = 2048;          // largest next_pow2(K + C)
constexpr unsigned long long EMPTY = ~0ull;
constexpr uint32_t TAKEN = ~0u;         // a hash slot whose id is claimed
constexpr unsigned FULL = 0xffffffffu;

// Order-preserving map of a float to uint32 (-0.0 taken as +0.0, so the
// two compare equal as they do in float).
__device__ __forceinline__ uint32_t ord_of(float d) {
  const uint32_t u = d == 0.0f ? 0u : __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float val_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (distance, id) key of a pool entry; EMPTY for an invalid id or a
// distance that is not below +inf.
__device__ __forceinline__ unsigned long long key_of(int id, float d) {
  const uint32_t od = ord_of(d);
  return id < 0 || od >= 0xff800000u
             ? EMPTY
             : ((unsigned long long)od << 32) | (uint32_t)id;
}

__device__ __forceinline__ uint32_t hash_of(int id, int T) {
  return ((uint32_t)id * 0x9e3779b1u) & (uint32_t)(T - 1);
}

// Where pool entry p (the list's entries p < K, then candidate p - K)
// waits in shared memory: at slot r * 32 + l for the lane l and register r
// that take it, so the 32 lanes read one register's slots free of bank
// conflicts. Split layout (K and C each at most P / 2, H = KPL / 2):
// registers [0, H) of lane l hold candidates l H + r, registers [H, KPL)
// the list's entries l H + r - H. Otherwise lane l holds entries
// l KPL + r in pool order.
template <int KPL>
__device__ __forceinline__ int slot_of(int p, int K, bool split) {
  constexpr int H = KPL > 1 ? KPL / 2 : 1;
  if (!split) return (p % KPL) * 32 + p / KPL;
  if (p < K) return (H + p % H) * 32 + p / H;
  return ((p - K) % H) * 32 + (p - K) / H;
}

// Ascending bitonic sort of the 32 * NR keys in registers [0, NR) of the
// warp, lane l holding keys [l * NR, (l + 1) * NR): strides below NR within
// a lane, the rest by shuffles with lane l ^ (j / NR). MERGE_ONLY runs the
// last round alone, which sorts a bitonic sequence.
template <int NR, int KPL, bool MERGE_ONLY = false>
__device__ __forceinline__ void warp_sort(unsigned long long (&key)[KPL],
                                          int lane) {
  constexpr int N = 32 * NR;
#pragma unroll
  for (int k = MERGE_ONLY ? N : 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < NR) {
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int l = i ^ j;
          if (l > i) {
            const bool up = ((lane * NR + i) & k) == 0;
            const unsigned long long a = key[i], b = key[l];
            if ((a > b) == up) {
              key[i] = b;
              key[l] = a;
            }
          }
        }
      } else {
        const int lm = j / NR;
        const bool lower = (lane & lm) == 0;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const unsigned long long other = __shfl_xor_sync(FULL, key[i], lm);
          const bool up = ((lane * NR + i) & k) == 0;
          const bool keep_min = lower == up;
          key[i] = keep_min ? (other < key[i] ? other : key[i])
                            : (other > key[i] ? other : key[i]);
        }
      }
    }
  }
}

// Writes the first K keys of the sorted registers [0, NR) as row b's list,
// and (+inf, -1) after them.
template <int NR, int KPL>
__device__ __forceinline__ void emit(const unsigned long long (&key)[KPL],
                                     int lane, long long b, int K,
                                     float* __restrict__ out_d,
                                     int* __restrict__ out_i) {
  int n_mine = 0;
#pragma unroll
  for (int i = 0; i < NR; ++i) n_mine += key[i] != EMPTY;
  int incl = n_mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  int pos = incl - n_mine;
#pragma unroll
  for (int i = 0; i < NR; ++i) {       // a lane's live keys come first
    if (i < n_mine && pos + i < K) {
      out_d[b * K + pos + i] = val_of((uint32_t)(key[i] >> 32));
      out_i[b * K + pos + i] = (int)(uint32_t)key[i];
    }
  }
  for (int j = total + lane; j < K; j += 32) {
    out_d[b * K + j] = INFINITY;
    out_i[b * K + j] = -1;
  }
}

// One node row b, by one warp. `pool` is the warp's 16 P bytes of shared
// memory: the pool (P keys) and the candidate ids while scoring, then the
// hash table (T ids, T ordered distances).
template <int KPL>
__device__ __forceinline__ void join_row(
    long long b, int lane, unsigned long long* pool,
    const float* __restrict__ q, const float* __restrict__ qn,
    const int* __restrict__ cand_ids, const float* __restrict__ data,
    const float* __restrict__ norms, const float* __restrict__ cur_d,
    const int* __restrict__ cur_i, int C, int K, int d, int ip, int vec4,
    float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int P = 32 * KPL;
  constexpr int T = 2 * P;              // hash slots
  constexpr int H = KPL > 1 ? KPL / 2 : 1;
  int* cid = reinterpret_cast<int*>(pool + P);
  int* hid = reinterpret_cast<int*>(pool);
  uint32_t* hord = reinterpret_cast<uint32_t*>(hid + T);
  const float* qrow = q + b * d;
  bool split = KPL > 1 && 2 * K <= P && 2 * C <= P;

  for (int c = lane; c < C; c += 32) cid[c] = cand_ids[b * C + c];
  for (int p = lane; p < K; p += 32) {
    const int id = cur_i[b * K + p];
    pool[slot_of<KPL>(p, K, split)] = key_of(id, cur_d[b * K + p]);
  }
  __syncwarp();

  // ---- gather and score, U candidates a round ----
  const float qnb = ip ? 0.0f : qn[b];
  for (int c0 = 0; c0 < C; c0 += U) {
    int ids[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ids[u] = c0 + u < C ? cid[c0 + u] : -1;
      acc[u] = 0.0f;
    }
    if (vec4) {
      for (int t = lane * 4; t < d; t += 128) {
        const float4 qv = make_float4(__ldg(qrow + t), __ldg(qrow + t + 1),
                                      __ldg(qrow + t + 2),
                                      __ldg(qrow + t + 3));
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ids[u] < 0) continue;
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              data + (size_t)ids[u] * d + t));
#if RTT_STAGES >= 1
          acc[u] += qv.x * x.x + qv.y * x.y + qv.z * x.z + qv.w * x.w;
#else
          acc[u] += (x.x + x.y) + (x.z + x.w) + 0.0f * qv.x;
#endif
        }
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float qv = __ldg(qrow + t);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ids[u] < 0) continue;
#if RTT_STAGES >= 1
          acc[u] += qv * __ldg(data + (size_t)ids[u] * d + t);
#else
          acc[u] += __ldg(data + (size_t)ids[u] * d + t) + 0.0f * qv;
#endif
        }
      }
    }
#if RTT_STAGES >= 1
    // transposing butterfly: after the lane-bit-4, -3 and -2 exchanges
    // lane l holds candidate (l >> 2) & 7 summed over its group of four
    // lanes, then bits 1 and 0 finish the sum (every add pairs the same
    // two operands on both lanes, so all four agree bit for bit)
#pragma unroll
    for (int h = U / 2, o = 16; h >= 1; h >>= 1, o >>= 1) {
      const bool hi = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = hi ? acc[i] : acc[i + h];
        const float keep = hi ? acc[i + h] : acc[i];
        acc[i] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
    acc[0] += __shfl_xor_sync(FULL, acc[0], 2);
    acc[0] += __shfl_xor_sync(FULL, acc[0], 1);
#else
#pragma unroll
    for (int u = 1; u < U; ++u) acc[0] += acc[u];
#endif
    const int c = c0 + ((lane >> 2) & 7);
    if ((lane & 3) == 0 && c < C) {
      const int id = cid[c];
      const float dot = acc[0];
      float dist = INFINITY;
      if (id >= 0)
        dist = ip ? -dot : fmaxf(qnb + __ldg(norms + id) - 2.0f * dot, 0.0f);
      pool[slot_of<KPL>(K + c, K, split)] = key_of(id, dist);
    }
  }
  __syncwarp();

  unsigned long long key[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const bool valid = !split                ? lane * KPL + r < K + C
                       : r < H               ? lane * H + r < C
                                             : lane * H + r - H < K;
    key[r] = valid ? pool[r * 32 + lane] : EMPTY;
  }
  __syncwarp();

#if RTT_STAGES >= 2
  // ---- dedup: each id's smallest ordered distance, by hash ----
  for (int s = lane; s < P; s += 32)      // T ids and T distances: all ones
    reinterpret_cast<uint4*>(pool)[s] = make_uint4(~0u, ~0u, ~0u, ~0u);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    if (key[i] == EMPTY) continue;
    const int id = (int)(uint32_t)key[i];
    uint32_t h = hash_of(id, T);
    for (;;) {
      const int prev = atomicCAS(hid + h, -1, id);
      if (prev == -1 || prev == id) {
        atomicMin(hord + h, (uint32_t)(key[i] >> 32));
        break;
      }
      h = (h + 1) & (T - 1);
    }
  }
  // one copy of each id stays: the first to claim its slot at the id's
  // smallest distance (copies at that distance are the same key, so which
  // one does not matter), the list's entries before the candidates
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const bool listed = split ? i >= H : lane * KPL + i < K;
      if (key[i] == EMPTY || listed != (pass == 0)) continue;
      const int id = (int)(uint32_t)key[i];
      const uint32_t od = (uint32_t)(key[i] >> 32);
      uint32_t h = hash_of(id, T);
      while (hid[h] != id) h = (h + 1) & (T - 1);
      if (atomicCAS(hord + h, od, TAKEN) != od) key[i] = EMPTY;
    }
  }

  // ---- selection ----
  // The list is the last join's output, so as a rule already in (distance,
  // id) order: then only the candidates are sorted, and one merge step
  // takes the P / 2 smallest of both halves. Otherwise all P are sorted.
  if (split) {
    bool asc = true;
#pragma unroll
    for (int r = H; r + 1 < KPL; ++r) asc &= key[r] <= key[r + 1];
    const unsigned long long next = __shfl_down_sync(FULL, key[H], 1);
    if (lane < 31) asc &= key[KPL - 1] <= next;
    split = __all_sync(FULL, asc);
  }
  if (split) {
    warp_sort<H, KPL>(key, lane);
    // candidate j against the list's entry P / 2 - 1 - j, on lane l ^ 31:
    // the smaller of each pair form a bitonic sequence of the P / 2
    // smallest keys, which the last round of a sort orders
#pragma unroll
    for (int r = 0; r < H; ++r) {
      const unsigned long long other =
          __shfl_xor_sync(FULL, key[KPL - 1 - r], 31);
      key[r] = other < key[r] ? other : key[r];
    }
    warp_sort<H, KPL, true>(key, lane);
    emit<H, KPL>(key, lane, b, K, out_d, out_i);
  } else {
    warp_sort<KPL, KPL>(key, lane);
    emit<KPL, KPL>(key, lane, b, K, out_d, out_i);
  }
#else
  // partial builds: a digest of the pool, so no stage is optimised away
  unsigned long long x = 0;
#pragma unroll
  for (int i = 0; i < KPL; ++i) x ^= key[i];
  for (int j = lane; j < K; j += 32) {
    out_d[b * K + j] = __uint_as_float((uint32_t)(x >> 32));
    out_i[b * K + j] = (int)(uint32_t)x ^ j;
  }
#endif
}

template <int KPL>
__global__ void __launch_bounds__(NT, KPL <= 16 ? 6 : 1)
graph_local_join_kernel(const float* __restrict__ q,
                        const float* __restrict__ qn,
                        const int* __restrict__ cand_ids,
                        const float* __restrict__ data,
                        const float* __restrict__ norms,
                        const float* __restrict__ cur_d,
                        const int* __restrict__ cur_i, int B, int C, int K,
                        int d, int ip, int vec4, float* __restrict__ out_d,
                        int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * WPB + warp;
  if (b < B)
    join_row<KPL>(b, lane,
                  reinterpret_cast<unsigned long long*>(
                      smem + (size_t)warp * 16 * 32 * KPL),
                  q, qn, cand_ids, data, norms, cur_d, cur_i, C, K, d, ip,
                  vec4, out_d, out_i);
}

template <int KPL>
int launch(const float* q, const float* qn, const int* cand_ids,
           const float* data, const float* norms, const float* cur_d,
           const int* cur_i, int B, int C, int K, int d, int ip, int vec4,
           float* out_d, int* out_i, cudaStream_t stream) {
  const size_t smem = (size_t)WPB * 16 * 32 * KPL;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_local_join_kernel<KPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((B + WPB - 1) / WPB);
  graph_local_join_kernel<KPL><<<grid, NT, smem, stream>>>(
      q, qn, cand_ids, data, norms, cur_d, cur_i, B, C, K, d, ip, vec4,
      out_d, out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, d] f32; qn [B] f32 (null for IP); cand_ids [B, C] int32 (-1 =
// empty); data [n, d] f32; norms [n] f32 (null for IP); cur_d / cur_i
// [B, K]; out_d / out_i [B, K]. vec4: d % 4 == 0 and data 16-byte
// aligned. Returns a cudaError_t code.
extern "C" int graph_local_join(const void* q, const void* qn,
                                const void* cand_ids, const void* data,
                                const void* norms, const void* cur_d,
                                const void* cur_i, int B, int C, int K, int d,
                                int ip, int vec4, void* out_d, void* out_i,
                                void* stream) {
  if (B < 1 || C < 0 || K < 1 || d < 1 || K + C > POOL_MAX ||
      (!ip && (qn == nullptr || norms == nullptr)))
    return (int)cudaErrorInvalidValue;
  int pool = 32;
  while (pool < K + C) pool <<= 1;
  const auto* qf = static_cast<const float*>(q);
  const auto* qnf = static_cast<const float*>(qn);
  const auto* cid = static_cast<const int*>(cand_ids);
  const auto* x = static_cast<const float*>(data);
  const auto* xn = static_cast<const float*>(norms);
  const auto* cd = static_cast<const float*>(cur_d);
  const auto* ci = static_cast<const int*>(cur_i);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  switch (pool) {
    case 32:
      return launch<1>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4, od,
                       oi, s);
    case 64:
      return launch<2>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4, od,
                       oi, s);
    case 128:
      return launch<4>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4, od,
                       oi, s);
    case 256:
      return launch<8>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4, od,
                       oi, s);
    case 512:
      return launch<16>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4,
                        od, oi, s);
    case 1024:
      return launch<32>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4,
                        od, oi, s);
    default:
      return launch<64>(qf, qnf, cid, x, xn, cd, ci, B, C, K, d, ip, vec4,
                        od, oi, s);
  }
}
