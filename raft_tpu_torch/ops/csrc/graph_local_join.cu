// graph_local_join — the nn-descent local join on Hopper.
//
// Replaces raft_tpu/ops/graph_join.py:_join_kernel (pallas_call at :257).
// Per node row b: score its C candidates against its own vector (L2
// max(||q||^2 + ||c||^2 - 2 q.c, 0), or inner product -q.c; id < 0 is
// +inf), pool them with the row's current list of K, and write the pool's
// unique-by-id top-K: a duplicate id keeps its smallest distance, ties go
// to the smallest id, and unfilled slots are (+inf, -1).
//
// One block of 256 threads per node row. The TPU kernel takes the
// candidate vectors pre-gathered into a [B, C, d] slab (the gather stays
// in XLA there); here each warp reads its candidates' rows from `data` by
// id, 16 bytes a lane, four candidates in flight, so the 7.5 GB slab of a
// 65,536-row block at C = 224, d = 128 never exists. The pool (K + C <=
// 2048 entries) lives in shared memory as 64-bit keys and is ordered by
// two bitonic sorts: by (id, distance), which puts each id's smallest copy
// first so the later copies can be blanked, then by (distance, id), whose
// first K entries are the answer. The TPU kernel reaches the same list by
// K passes of min-extraction that mask by id.
//
// Bound on the H100: bytes. Per launch it must read the block's rows, ids
// and lists and each referenced data row once; at the main path's shapes
// the dots are 3.8 GFLOP (f32), well under the bytes. The kernel reads a
// candidate row once per reference (C per node, ~115 GB per nn-descent
// iteration at 1M rows), relying on L2 for reuse; PERF.md holds the time
// against both counts.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rtt_error.cuh"

namespace {

constexpr int NT = 256;                 // threads per block (one node row)
constexpr int NW = NT / 32;
constexpr int U = 4;                    // candidates in flight per warp
constexpr int POOL_MAX = 2048;          // largest next_pow2(K + C)
constexpr int PER_T = POOL_MAX / NT;    // pool slots per thread
constexpr unsigned long long EMPTY = ~0ull;

// Order-preserving map of a float to uint32 (-0.0 taken as +0.0, so the
// two compare equal as they do in float).
__device__ __forceinline__ uint32_t ord_of(float d) {
  const uint32_t u = d == 0.0f ? 0u : __float_as_uint(d);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float val_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (id, distance) key: ids ascending (-1 last, as 0xffffffff), then
// distances ascending.
__device__ __forceinline__ unsigned long long id_key(int id, float d) {
  return ((unsigned long long)(uint32_t)id << 32) | ord_of(d);
}

__device__ void bitonic_sort(unsigned long long* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += NT) {
        const int i = 2 * j * (t / j) + (t % j);
        const int l = i + j;
        const unsigned long long a = key[i], b = key[l];
        if (((i & k) == 0) ? a > b : a < b) {
          key[i] = b;
          key[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(NT)
graph_local_join_kernel(const float* __restrict__ q,
                        const float* __restrict__ qn,
                        const int* __restrict__ cand_ids,
                        const float* __restrict__ data,
                        const float* __restrict__ norms,
                        const float* __restrict__ cur_d,
                        const int* __restrict__ cur_i, int C, int K, int d,
                        int pool, int ip, int vec4,
                        float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                  // d, 16B-padded
  unsigned long long* key =
      reinterpret_cast<unsigned long long*>(qs + ((d + 3) & ~3));  // pool

  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int t = tid; t < d; t += NT) qs[t] = q[b * d + t];
  for (int t = tid; t < K; t += NT) {
    const int id = cur_i[b * K + t];
    key[t] = id_key(id, id < 0 ? INFINITY : cur_d[b * K + t]);
  }
  for (int t = K + C + tid; t < pool; t += NT) key[t] = EMPTY;
  __syncthreads();

  const float qnb = ip ? 0.0f : qn[b];
  const int* crow = cand_ids + b * C;
  for (int c0 = warp * U; c0 < C; c0 += NW * U) {
    int ids[U];
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ids[u] = c0 + u < C ? crow[c0 + u] : -1;
      acc[u] = 0.0f;
    }
    if (vec4) {
      for (int t = lane * 4; t < d; t += 128) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + t);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (ids[u] < 0) continue;
          const float4 x = __ldg(reinterpret_cast<const float4*>(
              data + (size_t)ids[u] * d + t));
          acc[u] += qv.x * x.x + qv.y * x.y + qv.z * x.z + qv.w * x.w;
        }
      }
    } else {
      for (int t = lane; t < d; t += 32) {
        const float qv = qs[t];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ids[u] >= 0) acc[u] += qv * __ldg(data + (size_t)ids[u] * d + t);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
    if (lane < U && c0 + lane < C) {
      // lane u writes candidate c0 + u (register arrays need static
      // indices, hence the unrolled select)
      int id = -1;
      float dot = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u == lane) {
          id = ids[u];
          dot = acc[u];
        }
      float dist = INFINITY;
      if (id >= 0)
        dist = ip ? -dot : fmaxf(qnb + norms[id] - 2.0f * dot, 0.0f);
      key[K + c0 + lane] = id_key(id, dist);
    }
  }
  __syncthreads();

  // pass 1: by (id, distance); blank every copy after an id's first, and
  // invalid or +inf entries; re-key the rest by (distance, id)
  bitonic_sort(key, pool);
  unsigned long long next[PER_T];
#pragma unroll
  for (int s = 0; s < PER_T; ++s) {
    const int p = tid + s * NT;
    next[s] = EMPTY;
    if (p < pool) {
      const unsigned long long kk = key[p];
      const int id = (int)(kk >> 32);
      const uint32_t od = (uint32_t)kk;
      const bool first = p == 0 || (int)(key[p - 1] >> 32) != id;
      if (id >= 0 && od < 0xff800000u && first)       // finite, not +inf
        next[s] = ((unsigned long long)od << 32) | (uint32_t)id;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < PER_T; ++s) {
    const int p = tid + s * NT;
    if (p < pool) key[p] = next[s];
  }
  __syncthreads();

  // pass 2: by (distance, id); the first K are the merged list
  bitonic_sort(key, pool);
  for (int j = tid; j < K; j += NT) {
    const unsigned long long kk = key[j];
    const bool live = kk != EMPTY;
    out_d[b * K + j] = live ? val_of((uint32_t)(kk >> 32)) : INFINITY;
    out_i[b * K + j] = live ? (int)(uint32_t)kk : -1;
  }
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
  int pool = 1;
  while (pool < K + C) pool <<= 1;
  const size_t smem = (size_t)((d + 3) & ~3) * sizeof(float) +
                      (size_t)pool * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        graph_local_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  graph_local_join_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(qn),
      static_cast<const int*>(cand_ids), static_cast<const float*>(data),
      static_cast<const float*>(norms), static_cast<const float*>(cur_d),
      static_cast<const int*>(cur_i), C, K, d, pool, ip, vec4,
      static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}
