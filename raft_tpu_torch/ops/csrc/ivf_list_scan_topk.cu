// ivf_list_scan_topk — the IVF list scan + per-list top-k on Hopper.
//
// Replaces raft_tpu/ops/ivf_scan.py:_scan_kernel: the float-storage arm
// (f32 / bf16 rows) and the int8 rows that the float branch widens
// (:302-308, IVF-PQ's decoded-residual cache), with exact extraction. One
// block per (bucket, 64-query sub-tile), sub-tiles fastest so the blocks
// of one bucket read its list together through L2. The block reads its
// own list id (bucket_list[b]) and size, gathers its queries by bucket_q
// instead of a pre-gathered [nb, G, d] copy, streams the list's first
// `size` rows through shared memory (scan_topk.cuh) with the `keep` filter
// applied, and writes each query's exact top-k with the stored global ids
// read from the list's id row; empty query slots and list tails come back
// as (+inf, -1).
//
// Residual-query mode (IVF-PQ): the reference pre-gathers per-bucket
// queries qv = (q_rot - centers_rot[l]) * scale (ivf_pq.py:2043-2054),
// ~0.3 GB per batch at DEEP-10M. Here the block subtracts its list's
// center row (L2; inner product takes q_rot * scale) and scales while it
// stages the query slices, and computes qaux = ||q_rot - c_l||^2 of the
// unscaled f32 residual itself, one sequential sum per slot (component 0
// first, each product and sum rounded once) that the plain version
// repeats.
//
// Bound on the H100: at the SIFT-1M IVF-Flat path bytes (each probed list
// read once, ~0.60 GB = 0.18 ms at 3.35 TB/s); at the DEEP-10M IVF-PQ path
// operations (10k queries x 128 probes x ~10k rows x 96 dims, ~2.4 TFLOP,
// ~2.4 ms at the bf16 tensor cores' 989 TFLOP/s; chip_smoke.py counts both
// from the run's data). This first version is far from either: it streams
// a list once per 64-query block, stages the block's queries again for
// every 64-row tile, and runs the dots on the f32 CUDA cores (operands
// widened exactly), whose 67 TFLOP/s put its own floor ~15x above the
// tensor cores'. PERF.md splits its time by stage (staging, dots, top-k
// selection); staging each list once per bucket, moving the dots to the
// tensor cores (wgmma) and cutting the selection's cost are the next steps.
#include "scan_topk.cuh"

using namespace rtt;

template <typename T, bool STAGE_Q>
__global__ void __launch_bounds__(NTHREADS)
ivf_list_scan_topk_kernel(const T* __restrict__ storage,
                          const int* __restrict__ indices,
                          const int* __restrict__ list_sizes,
                          const int* __restrict__ bucket_list,
                          const int* __restrict__ bucket_q,
                          const float* __restrict__ queries,
                          const float* __restrict__ qaux,
                          const float* __restrict__ norms,
                          const int* __restrict__ keep,
                          const float* __restrict__ centers, float scale,
                          int cap, int d, int G, int k, int n_sub,
                          int metric, int round_ops,
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
  // residual queries (L2) subtract the list's center row
  const float* center = centers ? centers + (size_t)l * d : nullptr;
  if (threadIdx.x < QT) {
    const int q = t.qidx[threadIdx.x];
    float qa = 0.f;
    if (q >= 0 && metric != kIP) {
      if (center) {
        // ||q - c||^2 of the unscaled f32 residual, in component order
        const float* qr = queries + (size_t)q * d;
        for (int c = 0; c < d; ++c) {
          const float r = __fsub_rn(qr[c], center[c]);
          qa = __fadd_rn(qa, __fmul_rn(r, r));
        }
      } else {
        qa = qaux[q];
      }
    }
    t.qa[threadIdx.x] = qa;
  }
  scan_topk<T, STAGE_Q>(t, topd, topp, queries, center, scale,
                        storage + base * d, norms ? norms + base : nullptr,
                        keep ? keep + base : nullptr, 0, size, d, k, metric,
                        round_ops != 0);
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

template <typename T, bool STAGE_Q>
static int launch_as(const T* storage, const int* indices,
                     const int* list_sizes, const int* bucket_list,
                     const int* bucket_q, const float* queries,
                     const float* qaux, const float* norms, const int* keep,
                     const float* centers, float scale, int cap, int d,
                     int nb, int G, int k, int metric, int round_ops,
                     float* out_d, int* out_i, cudaStream_t stream) {
  const int n_sub = (G + QT - 1) / QT;
  const size_t smem = topk_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      ivf_list_scan_topk_kernel<T, STAGE_Q>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ivf_list_scan_topk_kernel<T, STAGE_Q>
      <<<nb * n_sub, NTHREADS, smem, stream>>>(
          storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
          norms, keep, centers, scale, cap, d, G, k, n_sub, metric,
          round_ops, out_d, out_i);
  return (int)cudaGetLastError();
}

// Residual or scaled queries are staged component by component; plain
// queries (already rounded by the caller with round_ops) are loaded as
// they are.
template <typename T>
static int launch(const T* storage, const int* indices,
                  const int* list_sizes, const int* bucket_list,
                  const int* bucket_q, const float* queries,
                  const float* qaux, const float* norms, const int* keep,
                  const float* centers, float scale, int cap, int d, int nb,
                  int G, int k, int metric, int round_ops, float* out_d,
                  int* out_i, cudaStream_t stream) {
  if (centers != nullptr || scale != 1.f)
    return launch_as<T, true>(storage, indices, list_sizes, bucket_list,
                              bucket_q, queries, qaux, norms, keep, centers,
                              scale, cap, d, nb, G, k, metric, round_ops,
                              out_d, out_i, stream);
  return launch_as<T, false>(storage, indices, list_sizes, bucket_list,
                             bucket_q, queries, qaux, norms, keep, centers,
                             scale, cap, d, nb, G, k, metric, round_ops,
                             out_d, out_i, stream);
}

// storage [C, cap, d] of kind storage_kind (0 f32, 1 bf16, 2 int8);
// indices [C, cap] int32; list_sizes [C]; bucket_list [nb]; bucket_q
// [nb, G] (-1 = empty slot); queries [m, d] f32; qaux [m] f32 (null for IP,
// and unread in residual L2 mode); norms [C, cap] f32 (null for IP); keep
// [C, cap] int32 or null; centers [C, d] f32 (residual L2 mode) or null;
// scale multiplies every staged query component; round_ops computes in
// bf16: f32 rows and staged residual queries are rounded to bf16, plain
// queries (no centers, scale 1) must come rounded already; out_d / out_i
// [nb, G, k]. Returns a cudaError_t code.
extern "C" int ivf_list_scan_topk(
    const void* storage, int storage_kind, const void* indices,
    const void* list_sizes, const void* bucket_list, const void* bucket_q,
    const void* queries, const void* qaux, const void* norms,
    const void* keep, const void* centers, float scale, int cap, int d,
    int nb, int G, int k, int metric, int round_ops, void* out_d,
    void* out_i, void* stream) {
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || nb < 1 || G < 1 ||
      storage_kind < 0 || storage_kind > 2)
    return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int*>(indices);
  const auto* ls = static_cast<const int*>(list_sizes);
  const auto* bl = static_cast<const int*>(bucket_list);
  const auto* bq = static_cast<const int*>(bucket_q);
  const auto* q = static_cast<const float*>(queries);
  const auto* qa = static_cast<const float*>(qaux);
  const auto* xn = static_cast<const float*>(norms);
  const auto* kp = static_cast<const int*>(keep);
  const auto* ct = static_cast<const float*>(centers);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (storage_kind == 1)
    return launch(static_cast<const __nv_bfloat16*>(storage), ix, ls, bl, bq,
                  q, qa, xn, kp, ct, scale, cap, d, nb, G, k, metric,
                  round_ops, od, oi, s);
  if (storage_kind == 2)
    return launch(static_cast<const int8_t*>(storage), ix, ls, bl, bq, q, qa,
                  xn, kp, ct, scale, cap, d, nb, G, k, metric, round_ops, od,
                  oi, s);
  return launch(static_cast<const float*>(storage), ix, ls, bl, bq, q, qa,
                xn, kp, ct, scale, cap, d, nb, G, k, metric, round_ops, od,
                oi, s);
}
