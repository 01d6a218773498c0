// ivf_list_scan_topk — the IVF list scan + per-list top-k on Hopper.
//
// Replaces raft_tpu/ops/ivf_scan.py:_scan_kernel (float-storage arm, exact
// extraction). One block per (bucket, 64-query sub-tile), sub-tiles
// fastest so the blocks of one bucket read its list together through L2.
// The block reads its own list id (bucket_list[b]) and size, gathers its
// queries by bucket_q instead of a pre-gathered [nb, G, d] copy, streams
// the list's first `size` rows through shared memory (scan_topk.cuh) with
// the `keep` filter applied, and writes each query's exact top-k with the
// stored global ids read from the list's id row; empty query slots and
// list tails come back as (+inf, -1).
//
// Bound on the H100: bytes, counted as chip_smoke.py counts them. At the
// SIFT-1M main path (10k queries x 64 probes, 1024 lists of ~1k rows,
// d = 128, f32 storage, bf16-rounded operands) the least traffic is each
// probed list read once (rows, ids, norms) plus queries and outputs,
// ~0.60 GB = 0.18 ms at 3.35 TB/s; the dots are ~161 GFLOP, 0.16 ms at the
// bf16 tensor cores' 989 TFLOP/s. This first version is far from either:
// it streams a list once per 64-query block (~14 times: ~3.5 buckets per
// list, 4 blocks per bucket, mostly from L2), gathers the block's queries
// again for every 64-row tile, and runs the dots on the f32 CUDA cores
// (bf16 operands widened exactly), whose 67 TFLOP/s put its own floor at
// ~2.4 ms. PERF.md splits its time
// by stage (staging, dots, top-k selection); moving the dots to the tensor
// cores and cutting the selection's cost are the next steps.
#include "scan_topk.cuh"

using namespace rtt;

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
ivf_list_scan_topk_kernel(const T* __restrict__ storage,
                          const int* __restrict__ indices,
                          const int* __restrict__ list_sizes,
                          const int* __restrict__ bucket_list,
                          const int* __restrict__ bucket_q,
                          const float* __restrict__ queries,
                          const float* __restrict__ qaux,
                          const float* __restrict__ norms,
                          const int* __restrict__ keep, int cap, int d, int G,
                          int k, int n_sub, int metric, int round_rows,
                          float* __restrict__ out_d,
                          int* __restrict__ out_i) {
  __shared__ Tiles t;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* topd = reinterpret_cast<float*>(dyn);
  int* topp = reinterpret_cast<int*>(topd + QT * k);

  const int b = blockIdx.x / n_sub;
  const int g0 = (blockIdx.x % n_sub) * QT;
  const int l = bucket_list[b];
  int any = 0;
  if (threadIdx.x < QT) {
    const int g = g0 + threadIdx.x;
    const int q = g < G ? bucket_q[(size_t)b * G + g] : -1;
    t.qidx[threadIdx.x] = q;
    any = q >= 0;
  }
  // a block whose slots are all empty (padding buckets) scans nothing
  const int size = __syncthreads_or(any) ? list_sizes[l] : 0;
  const size_t base = (size_t)l * cap;
  scan_topk<T>(t, topd, topp, queries, qaux, storage + base * d,
               norms ? norms + base : nullptr, keep ? keep + base : nullptr,
               0, size, d, k, metric, round_rows != 0);
  __syncthreads();

  for (int e = threadIdx.x; e < QT * k; e += NTHREADS) {
    const int g = g0 + e / k;
    if (g >= G) continue;
    const size_t o = ((size_t)b * G + g) * k + e % k;
    const float dv = topd[e];
    out_d[o] = dv;
    out_i[o] = isinf(dv) ? -1 : indices[base + topp[e]];
  }
}

template <typename T>
static int launch(const T* storage, const int* indices,
                  const int* list_sizes, const int* bucket_list,
                  const int* bucket_q, const float* queries,
                  const float* qaux, const float* norms, const int* keep,
                  int cap, int d, int nb, int G, int k, int metric,
                  int round_rows, float* out_d, int* out_i,
                  cudaStream_t stream) {
  const int n_sub = (G + QT - 1) / QT;
  const size_t smem = topk_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_list_scan_topk_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ivf_list_scan_topk_kernel<T><<<nb * n_sub, NTHREADS, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
      norms, keep, cap, d, G, k, n_sub, metric, round_rows, out_d, out_i);
  return (int)cudaGetLastError();
}

// storage [C, cap, d] f32 or bf16 (storage_bf16); indices [C, cap] int32;
// list_sizes [C]; bucket_list [nb]; bucket_q [nb, G] (-1 = empty slot);
// queries [m, d] f32; qaux [m] f32 (null for IP); norms [C, cap] f32 (null
// for IP); keep [C, cap] int32 or null; out_d / out_i [nb, G, k].
// Returns a cudaError_t code.
extern "C" int ivf_list_scan_topk(
    const void* storage, int storage_bf16, const void* indices,
    const void* list_sizes, const void* bucket_list, const void* bucket_q,
    const void* queries, const void* qaux, const void* norms,
    const void* keep, int cap, int d, int nb, int G, int k, int metric,
    int round_rows, void* out_d, void* out_i, void* stream) {
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || nb < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int*>(indices);
  const auto* ls = static_cast<const int*>(list_sizes);
  const auto* bl = static_cast<const int*>(bucket_list);
  const auto* bq = static_cast<const int*>(bucket_q);
  const auto* q = static_cast<const float*>(queries);
  const auto* qa = static_cast<const float*>(qaux);
  const auto* xn = static_cast<const float*>(norms);
  const auto* kp = static_cast<const int*>(keep);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (storage_bf16)
    return launch(static_cast<const __nv_bfloat16*>(storage), ix, ls, bl, bq,
                  q, qa, xn, kp, cap, d, nb, G, k, metric, 0, od, oi, s);
  return launch(static_cast<const float*>(storage), ix, ls, bl, bq, q, qa,
                xn, kp, cap, d, nb, G, k, metric, round_rows, od, oi, s);
}
