// ivf_list_scan_topk — the IVF list scan + per-list top-k on Hopper.
//
// Replaces raft_tpu/ops/ivf_scan.py:_scan_kernel: the float-storage arm
// (f32 / bf16 rows), the int8 rows that the float branch widens
// (:302-308, IVF-PQ's int8 caches) and the three packed storage arms
// (packed_i4 :281, packed_bits + row_scale :256/:310, packed_pq4 :221;
// IVF-PQ's compressed caches, below), with exact extraction. One
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
//
// Packed arms. The i4 and sign-bit caches are [C, nw, cap] words with rows
// on the fast axis; the shared core (scan_topk.cuh, ROWS) decodes one
// word a thread while it stages, so no wider copy of a cache exists, and
// the per-list i4 / raw-cache scales ride in the staged residual query
// (SCALE_VEC). Their bound is the int8 arm's: operations, 2 * rot per
// scored row on the bf16 tensor cores, the cache bytes (rot / 2 and
// rot / 8 per row) far below it. The pq4 arm scores 4-bit PQ codes
// against a table per (query, subspace) in shared memory, as the
// reference RAFT's ivf_pq_compute_similarity does (the TPU kernel's
// 16-pass one-hot contraction is not carried over): a block of PQ_QT = 16
// queries builds its tables once (16 x p x 16 f32, 96 KB at p = 96; 64
// queries would overflow the 227 KB a block may use) and then streams its
// list, one row a thread, summing p table entries per (query, row). Its
// bound is operations: p adds per scored (query, row) on the f32 CUDA
// cores, plus 2 * pq_len per table entry; chip_smoke.py counts both.
//
// Extraction arms (EXTRACT, extract at the C entry): exact, or the TPU
// kernel's binned (raft_tpu/ops/ivf_scan.py:89), binned_deep (:123) and
// fold (:169, at depth R = fold_depth(k), 2-4), for every storage mode
// and the pq4 kernel alike. The binned and fold arms keep
// per-(query, bin) slots in the dynamic shared memory where the exact arm
// keeps its top-k lists (scan_topk.cuh), and after the scan each warp
// extracts its queries' k entries and writes them with their ids, read
// through the list's id row as the exact write-out reads them. They need
// a cap that is a multiple of 128 over 128 (as the reference's), k <= 64
// (binned) or 256, and cap / 128 <= 65,536 (a chunk in 16 bits). A
// launch whose slots do not fit a block's shared memory returns its CUDA
// error (binned_deep: 196,608 B at 64 queries beside the 35,328 B of
// tiles, inside the 232,448 B a block may use). The fold keeps
// binned_deep's bins at depth R (96 KB at R = 2) and writes all 128 R
// slots of each query unextracted (write_bins): a [nb, G, 128 R] buffer
// that the caller's exact merge reduces; its write (nb G 128 R 8 B) adds
// to the arm's bytes.
//
// The binned_deep arm has a second body, designed for Hopper
// (ivf_scan_deep.cuh, extract code 6): int8, i4 and sign-bit rows with
// bf16 operands and d <= 128 take it where the caller routes them
// (ops/ivf_scan.py:binned_deep_body); the other modes keep this file's.
//
// The pq4 arm has a second body too, designed for Hopper
// (ivf_scan_pq4.cuh, extract codes 7-9: exact, binned, binned_deep): the
// TPU kernel's one-hot contraction on the tensor cores, 32 queries a
// block, bf16 tables staged once. bf16 operands take it where its block
// fits (ops/ivf_scan.py:pq4_body); f32 operands, the fold arms and wider
// tables keep ivf_pq4_scan_topk_kernel below.
//
// The exact and binned arms over int8, i4 and sign-bit rows, and over f32
// and bf16 rows with plain queries, have a second body too, on the
// binned_deep Hopper body (ivf_scan_arms.cuh, extract codes 10 and 11):
// bf16 operands, d <= 128 (the int8, f32 and bf16 kinds' a multiple of
// 16), k <= 64 and a cap that is a multiple of 128 take it where the
// caller routes them (ops/ivf_scan.py:scan_body); the other modes keep
// this file's.
#include "scan_topk.cuh"
#include "ivf_scan_deep.cuh"
#include "ivf_scan_pq4.cuh"
#include "ivf_scan_arms.cuh"

using namespace rtt;

// The binned arms' write-out: warp w extracts queries w, w + 8, ... of the
// block's `nq` (bins of query qq at sd / sc + qq * R * NBINS) into their
// output rows; slots past G are not written. The fold arms write every
// slot instead, unextracted: level r of bin b at column r * 128 + b of the
// query's 128 R-wide row, its id through the list's id row (-1 where
// +inf).
template <int EXTRACT>
__device__ __forceinline__ void write_bins(const float* sd,
                                           const uint16_t* sc, int nq,
                                           const int* ids, int b, int g0,
                                           int G, int k, float* out_d,
                                           int* out_i) {
  constexpr int R = bin_depth(EXTRACT);
  if constexpr (is_fold(EXTRACT)) {
    constexpr int W = R * NBINS;
    for (int e = threadIdx.x; e < nq * W; e += NTHREADS) {
      const int g = g0 + e / W;
      if (g >= G) continue;
      const int s = e % W;
      const size_t o = ((size_t)b * G + g) * W + s;
      const float dv = sd[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1 : ids[NBINS * sc[e] + (s & (NBINS - 1))];
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int qq = threadIdx.x >> 5; qq < nq; qq += NWARPS) {
      const int g = g0 + qq;
      if (g >= G) continue;
      const size_t o = ((size_t)b * G + g) * k;
#if RTT_STAGES < 2
      // the stage builds leave the extraction out (the outputs are not
      // results), keeping the bins live
      if (lane == 0) out_d[o] = sd[qq * R * NBINS];
#else
      extract_bins<R>(sd + qq * R * NBINS, sc + qq * R * NBINS, k, ids,
                      out_d + o, out_i + o, lane);
#endif
    }
  }
}

template <typename T, bool STAGE_Q, int ROWS, bool SCALE_VEC, int EXTRACT>
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
                          const float* __restrict__ scale_vec,
                          const float* __restrict__ row_scale, int cap,
                          int d, int nw, int G, int k, int n_sub,
                          int metric, int round_ops,
                          float* __restrict__ out_d,
                          int* __restrict__ out_i) {
  __shared__ Tiles t;
  extern __shared__ __align__(16) unsigned char dyn[];
  // the top-k lists (exact) or the bins' distances, then positions or
  // chunks
  float* topd = reinterpret_cast<float*>(dyn);
  int* topp = reinterpret_cast<int*>(
      topd + QT * (EXTRACT == kExact ? k : bin_depth(EXTRACT) * NBINS));

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
  // a list's rows: dense [cap, d], or packed [nw, cap] words
  const size_t list_elems = ROWS == kRowsDense ? (size_t)cap * d
                                               : (size_t)cap * nw;
  scan_topk<T, STAGE_Q, ROWS, SCALE_VEC, EXTRACT>(
      t, topd, topp, queries, center, scale, storage + (size_t)l * list_elems,
      norms ? norms + base : nullptr, keep ? keep + base : nullptr, 0, size,
      d, k, metric, round_ops != 0,
      SCALE_VEC ? scale_vec + (size_t)l * d : nullptr,
      row_scale ? row_scale + base : nullptr, cap);
  __syncthreads();

  if constexpr (EXTRACT == kExact) {
    for (int e = threadIdx.x; e < QT * k; e += NTHREADS) {
      const int g = g0 + e / k;
      if (g >= G) continue;
      const size_t o = ((size_t)b * G + g) * k + e % k;
      const float dv = topd[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1 : indices[base + topp[e]];
    }
  } else {
    write_bins<EXTRACT>(topd, reinterpret_cast<const uint16_t*>(topp),
                        QT, indices + base, b, g0, G, k, out_d, out_i);
  }
}

// The pq4 arm: one block per (bucket, PQ_QT-query sub-tile). The block
// builds its queries' tables in shared memory, lut[slot][s][v] = sum over
// l < pq_len (in order) of the staged query component s * pq_len + l
// times pq_centers[s][v][l], each product and sum rounded once and, under
// round_ops, the query component, the codebook entry and the finished
// entry rounded to bf16 (where the reference casts qv, its codebook
// weights and lut_v). Thread (row r, query group g) then walks its row's
// code words and sums, for each of its 4 queries, the table entries of
// the row's codes in subspace order; neighbouring threads read
// neighbouring rows of one word-row. The epilogue and the top-k are the
// shared core's.
constexpr int PQ_QT = 16;
constexpr int PQ_QPT = PQ_QT / (NTHREADS / RT);   // queries per thread

template <int EXTRACT>
__global__ void __launch_bounds__(NTHREADS)
ivf_pq4_scan_topk_kernel(const uint32_t* __restrict__ storage,
                         const int* __restrict__ indices,
                         const int* __restrict__ list_sizes,
                         const int* __restrict__ bucket_list,
                         const int* __restrict__ bucket_q,
                         const float* __restrict__ queries,
                         const float* __restrict__ norms,
                         const int* __restrict__ keep,
                         const float* __restrict__ centers,
                         const float* __restrict__ pq_centers, int cap,
                         int nw, int p, int pl, int G, int k, int n_sub,
                         int metric, int round_ops,
                         float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float dist[PQ_QT][RT + PAD];
  __shared__ int qidx[PQ_QT];
  __shared__ float qas[PQ_QT];
  extern __shared__ __align__(16) unsigned char dyn[];
  float* lut = reinterpret_cast<float*>(dyn);          // [PQ_QT][p][16]
  // the top-k lists (exact) or the bins (scan_topk.cuh)
  constexpr int R = bin_depth(EXTRACT);
  float* topd = lut + (size_t)PQ_QT * p * 16;
  int* topp = reinterpret_cast<int*>(
      topd + PQ_QT * (EXTRACT == kExact ? k : R * NBINS));
  uint16_t* sc = reinterpret_cast<uint16_t*>(topp);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int d = p * pl;
  const bool rops = round_ops != 0;
  const int b = blockIdx.x / n_sub;
  const int g0 = (blockIdx.x % n_sub) * PQ_QT;
  const int l = bucket_list[b];
  int any = 0;
  if (tid < PQ_QT) {
    const int g = g0 + tid;
    const int q = g < G ? bucket_q[(size_t)b * G + g] : -1;
    qidx[tid] = q;
    any = q >= 0;
  }
  const int size = __syncthreads_or(any) ? list_sizes[l] : 0;
  const size_t base = (size_t)l * cap;
  const float* center = centers ? centers + (size_t)l * d : nullptr;
  if (tid < PQ_QT) {
    const int q = qidx[tid];
    float qa = 0.f;
    if (q >= 0 && metric != kIP) {
      // ||q - c||^2 of the f32 residual, in component order
      const float* qr = queries + (size_t)q * d;
      for (int c = 0; c < d; ++c) {
        const float r = __fsub_rn(qr[c], center[c]);
        qa = __fadd_rn(qa, __fmul_rn(r, r));
      }
    }
    qas[tid] = qa;
  }
  for (int e = tid; e < PQ_QT * p * 16; e += NTHREADS) {
    const int slot = e / (p * 16);
    const int s = (e / 16) % p;
    const int v = e % 16;
    const int q = qidx[slot];
    float acc = 0.f;
    if (q >= 0) {
      for (int j = 0; j < pl; ++j) {
        const int c = s * pl + j;
        const float qv = stage_query(queries[(size_t)q * d + c], center, c,
                                     1.f, rops);
        float w = pq_centers[((size_t)s * 16 + v) * pl + j];
        if (rops) w = round_bf16(w);
        acc = __fadd_rn(acc, __fmul_rn(qv, w));
      }
      if (rops) acc = round_bf16(acc);
    }
    lut[e] = acc;
  }
  if constexpr (EXTRACT == kExact) {
    for (int i = tid; i < PQ_QT * k; i += NTHREADS) {
      topd[i] = INFINITY;
      topp[i] = -1;
    }
  } else {
    for (int i = tid; i < PQ_QT * R * NBINS; i += NTHREADS) {
      topd[i] = INFINITY;
      sc[i] = 0;
    }
  }
  __syncthreads();

  const int r = tid % RT;
  const int g = tid / RT;
  const uint32_t* words = storage + (size_t)l * nw * cap;
  for (int r0 = 0; r0 < size; r0 += RT) {
    const int pos = r0 + r;
    const bool in = pos < size;
    float acc[PQ_QPT];
#pragma unroll
    for (int i = 0; i < PQ_QPT; ++i) acc[i] = 0.f;
    if (in) {
      for (int w = 0; w < nw; ++w) {
        const uint32_t word = words[(size_t)w * cap + pos];
        const int s_end = min(8, p - w * 8);
        for (int j = 0; j < s_end; ++j) {
          const int code = (word >> (4 * j)) & 15u;
          const float* row = lut + (size_t)(w * 8 + j) * 16 + code;
#pragma unroll
          for (int i = 0; i < PQ_QPT; ++i)
            acc[i] = __fadd_rn(acc[i],
                               row[(size_t)(g * PQ_QPT + i) * p * 16]);
        }
      }
    }
    const bool ok = in && (keep == nullptr || keep[base + pos] > 0);
    const float xn = (ok && metric != kIP) ? norms[base + pos] : 0.f;
    const float plen = sqrtf(fmaxf(xn, 1e-30f));
#pragma unroll
    for (int i = 0; i < PQ_QPT; ++i) {
      const int slot = g * PQ_QPT + i;
      dist[slot][r] =
          ok ? epilogue_dist(acc[i], qas[slot], xn, plen, metric) : INFINITY;
    }
    __syncthreads();
    for (int qq = warp; qq < PQ_QT; qq += NWARPS) {
      if (qidx[qq] < 0) continue;
      if constexpr (EXTRACT == kExact)
        fold_candidates(topd + qq * k, topp + qq * k, k, dist[qq], r0, lane);
      else
        bin_candidates<R>(topd + qq * R * NBINS, sc + qq * R * NBINS,
                          dist[qq], r0, lane);
    }
    __syncthreads();
  }

  if constexpr (EXTRACT == kExact) {
    for (int e = tid; e < PQ_QT * k; e += NTHREADS) {
      const int gq = g0 + e / k;
      if (gq >= G) continue;
      const size_t o = ((size_t)b * G + gq) * k + e % k;
      const float dv = topd[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1 : indices[base + topp[e]];
    }
  } else {
    write_bins<EXTRACT>(topd, sc, PQ_QT, indices + base, b, g0, G, k, out_d,
                        out_i);
  }
}

template <typename T, bool STAGE_Q, int ROWS, bool SCALE_VEC, int EXTRACT>
static int launch_as(const T* storage, const int* indices,
                     const int* list_sizes, const int* bucket_list,
                     const int* bucket_q, const float* queries,
                     const float* qaux, const float* norms, const int* keep,
                     const float* centers, float scale,
                     const float* scale_vec, const float* row_scale, int cap,
                     int d, int nw, int nb, int G, int k, int metric,
                     int round_ops, float* out_d, int* out_i,
                     cudaStream_t stream) {
  const int n_sub = (G + QT - 1) / QT;
  const size_t smem = topk_smem_bytes(k, EXTRACT);
  auto kernel =
      ivf_list_scan_topk_kernel<T, STAGE_Q, ROWS, SCALE_VEC, EXTRACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<nb * n_sub, NTHREADS, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
      norms, keep, centers, scale, scale_vec, row_scale, cap, d, nw, G, k,
      n_sub, metric, round_ops, out_d, out_i);
  return (int)cudaGetLastError();
}

// Residual, scaled or per-list-scaled queries are staged component by
// component; plain queries (already rounded by the caller with round_ops)
// are loaded as they are. Each mode and extraction arm is its own
// instantiation, so the float arm's exact extraction compiles as it did
// before the packed and binned arms.
template <typename T, int ROWS, int EXTRACT>
static int launch_arm(const T* storage, const int* indices,
                      const int* list_sizes, const int* bucket_list,
                      const int* bucket_q, const float* queries,
                      const float* qaux, const float* norms, const int* keep,
                      const float* centers, float scale,
                      const float* scale_vec, const float* row_scale,
                      int cap, int d, int nw, int nb, int G, int k,
                      int metric, int round_ops, float* out_d, int* out_i,
                      cudaStream_t stream) {
#define RTT_LAUNCH(STAGE, VEC)                                                \
  launch_as<T, STAGE, ROWS, VEC, EXTRACT>(                                    \
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,     \
      norms, keep, centers, scale, scale_vec, row_scale, cap, d, nw, nb, G,   \
      k, metric, round_ops, out_d, out_i, stream)
  if (scale_vec != nullptr) return RTT_LAUNCH(true, true);
  if (centers != nullptr || scale != 1.f) return RTT_LAUNCH(true, false);
  return RTT_LAUNCH(false, false);
#undef RTT_LAUNCH
}

template <typename T, int ROWS>
static int launch(const T* storage, const int* indices,
                  const int* list_sizes, const int* bucket_list,
                  const int* bucket_q, const float* queries,
                  const float* qaux, const float* norms, const int* keep,
                  const float* centers, float scale, const float* scale_vec,
                  const float* row_scale, int cap, int d, int nw, int nb,
                  int G, int k, int metric, int round_ops, int extract,
                  float* out_d, int* out_i, cudaStream_t stream) {
#define RTT_ARM(EXTRACT)                                                      \
  launch_arm<T, ROWS, EXTRACT>(storage, indices, list_sizes, bucket_list,     \
                               bucket_q, queries, qaux, norms, keep, centers, \
                               scale, scale_vec, row_scale, cap, d, nw, nb,   \
                               G, k, metric, round_ops, out_d, out_i, stream)
  if (extract == kBinned) return RTT_ARM(kBinned);
  if (extract == kBinnedDeep) return RTT_ARM(kBinnedDeep);
  if (extract == kFold2) return RTT_ARM(kFold2);
  if (extract == kFold3) return RTT_ARM(kFold3);
  if (extract == kFold4) return RTT_ARM(kFold4);
  return RTT_ARM(kExact);
#undef RTT_ARM
}

// f16 and uint8 rows (IVF-Flat over float16 and uint8 datasets, stored as
// the dataset's type): plain queries only, the one mode IVF-Flat scans
// them in, at every extraction arm; the rows widen exactly as they are
// staged (f16 then rounded to bf16 with round_ops).
template <typename T>
static int launch_plain_rows(const T* storage, const int* indices,
                             const int* list_sizes, const int* bucket_list,
                             const int* bucket_q, const float* queries,
                             const float* qaux, const float* norms,
                             const int* keep, const float* centers,
                             float scale, const float* scale_vec, int cap,
                             int d, int nb, int G, int k, int metric,
                             int round_ops, int extract, float* out_d,
                             int* out_i, cudaStream_t stream) {
  if (centers != nullptr || scale_vec != nullptr || scale != 1.f)
    return (int)cudaErrorInvalidValue;
#define RTT_ARM(EXTRACT)                                                      \
  launch_as<T, false, kRowsDense, false, EXTRACT>(                            \
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,     \
      norms, keep, nullptr, 1.f, nullptr, nullptr, cap, d, 0, nb, G, k,       \
      metric, round_ops, out_d, out_i, stream)
  if (extract == kBinned) return RTT_ARM(kBinned);
  if (extract == kBinnedDeep) return RTT_ARM(kBinnedDeep);
  if (extract == kFold2) return RTT_ARM(kFold2);
  if (extract == kFold3) return RTT_ARM(kFold3);
  if (extract == kFold4) return RTT_ARM(kFold4);
  return RTT_ARM(kExact);
#undef RTT_ARM
}

template <int EXTRACT>
static int launch_pq4_arm(const uint32_t* storage, const int* indices,
                          const int* list_sizes, const int* bucket_list,
                          const int* bucket_q, const float* queries,
                          const float* norms, const int* keep,
                          const float* centers, const float* pq_centers,
                          int cap, int nw, int p, int pl, int nb, int G,
                          int k, int metric, int round_ops, float* out_d,
                          int* out_i, cudaStream_t stream) {
  const int n_sub = (G + PQ_QT - 1) / PQ_QT;
  const size_t smem = (size_t)PQ_QT * p * 16 * sizeof(float) +
                      topk_smem_bytes(k, EXTRACT, PQ_QT);
  auto kernel = ivf_pq4_scan_topk_kernel<EXTRACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // tables past a block's shared memory: report the error, and clear it so
  // that the next launch's cudaGetLastError does not return it again
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<nb * n_sub, NTHREADS, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, norms,
      keep, centers, pq_centers, cap, nw, p, pl, G, k, n_sub, metric,
      round_ops, out_d, out_i);
  return (int)cudaGetLastError();
}

static int launch_pq4(const uint32_t* storage, const int* indices,
                      const int* list_sizes, const int* bucket_list,
                      const int* bucket_q, const float* queries,
                      const float* norms, const int* keep,
                      const float* centers, const float* pq_centers,
                      int cap, int nw, int p, int pl, int nb, int G, int k,
                      int metric, int round_ops, int extract, float* out_d,
                      int* out_i, cudaStream_t stream) {
#define RTT_ARM(EXTRACT)                                                      \
  launch_pq4_arm<EXTRACT>(storage, indices, list_sizes, bucket_list,          \
                          bucket_q, queries, norms, keep, centers,            \
                          pq_centers, cap, nw, p, pl, nb, G, k, metric,       \
                          round_ops, out_d, out_i, stream)
  if (extract == kBinned) return RTT_ARM(kBinned);
  if (extract == kBinnedDeep) return RTT_ARM(kBinnedDeep);
  if (extract == kFold2) return RTT_ARM(kFold2);
  if (extract == kFold3) return RTT_ARM(kFold3);
  if (extract == kFold4) return RTT_ARM(kFold4);
  return RTT_ARM(kExact);
#undef RTT_ARM
}

// storage of kind storage_kind: 0 f32, 1 bf16, 2 int8, 6 f16, 7 uint8 rows
// [C, cap, d] (6 and 7 with plain queries only); 3 packed int4 (d = 8 nw), 4 packed sign bits (d = 32 nw), 5 packed
// 4-bit PQ codes (d = p * pl), each [C, nw, cap] uint32 words. indices
// [C, cap] int32; list_sizes [C]; bucket_list [nb]; bucket_q [nb, G] (-1 =
// empty slot); queries [m, d] f32; qaux [m] f32 (null for IP, and unread
// in residual L2 mode and by kind 5); norms [C, cap] f32 (null for IP);
// keep [C, cap] int32 or null; centers [C, d] f32 (residual L2 mode) or
// null; scale multiplies every staged query component, or scale_vec [C, d]
// (non-null) per list and component (kinds 0-4); row_scale [C, cap]
// multiplies each row's dot (kind 4, may be null); pq_centers [p, 16, pl]
// (kind 5); round_ops computes in bf16: f32 rows and staged queries are
// rounded to bf16, plain queries (no centers, scale 1) must come rounded
// already; extract 0 exact, 1 binned, 2 binned_deep, 3-5 fold at depth
// R = 2-4 (R >= ceil(k / 64)), 6 binned_deep through the Hopper body
// (kinds 2-4, round_ops, d <= 128; the int8 kind's d a multiple of 16;
// storage, norms, keep and row_scale 16-byte aligned), 7-9 exact, binned
// and binned_deep through the pq4 Hopper body (kind 5, round_ops, L2 or
// inner product, its block within a block's shared memory; storage, norms
// and keep 16-byte aligned); 10 and 11 exact and binned through the
// Hopper arms' body (kinds 2-4 as code 6, and kinds 0 and 1 with plain
// queries and d a multiple of 16 <= 128; k <= 64, cap a multiple of 128);
// out_d / out_i [nb, G, k], or [nb, G, 128 R] for fold. Returns a
// cudaError_t code.
extern "C" int ivf_list_scan_topk(
    const void* storage, int storage_kind, const void* indices,
    const void* list_sizes, const void* bucket_list, const void* bucket_q,
    const void* queries, const void* qaux, const void* norms,
    const void* keep, const void* centers, float scale,
    const void* scale_vec, const void* row_scale, const void* pq_centers,
    int cap, int d, int nw, int p, int pl, int nb, int G, int k, int metric,
    int round_ops, int extract, void* out_d, void* out_i, void* stream) {
  if (k < 1 || k > KMAX || cap < 1 || d < 1 || nb < 1 || G < 1 ||
      storage_kind < 0 || storage_kind > 7 || extract < kExact ||
      (extract > kFold4 && extract != deep::kBinnedDeepHopper &&
       !pq4h::is_code(extract) && !arms::is_code(extract)))
    return (int)cudaErrorInvalidValue;
  if (arms::is_code(extract)) {
    if (cap % NBINS != 0 || cap / NBINS > 65536 ||
        (extract == arms::kBinnedHopper && cap <= NBINS) ||
        (storage_kind >= 3 && (nw < 1 || (storage_kind == 3 && d != 8 * nw) ||
                               (storage_kind == 4 && d != 32 * nw))))
      return (int)cudaErrorInvalidValue;
    return arms::launch(
        extract, storage_kind, storage, static_cast<const int*>(indices),
        static_cast<const int*>(list_sizes),
        static_cast<const int*>(bucket_list),
        static_cast<const int*>(bucket_q), static_cast<const float*>(queries),
        static_cast<const float*>(qaux), static_cast<const float*>(norms),
        static_cast<const int*>(keep), static_cast<const float*>(centers),
        scale, static_cast<const float*>(scale_vec),
        static_cast<const float*>(row_scale), cap, d, nw, nb, G, k, metric,
        round_ops, static_cast<float*>(out_d), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream));
  }
  if (pq4h::is_code(extract)) {
    if (storage_kind != 5 || scale_vec != nullptr || d != p * pl)
      return (int)cudaErrorInvalidValue;
    return pq4h::launch(
        extract, static_cast<const uint32_t*>(storage),
        static_cast<const int*>(indices), static_cast<const int*>(list_sizes),
        static_cast<const int*>(bucket_list),
        static_cast<const int*>(bucket_q), static_cast<const float*>(queries),
        static_cast<const float*>(norms), static_cast<const int*>(keep),
        static_cast<const float*>(centers),
        static_cast<const float*>(pq_centers), cap, nw, p, pl, nb, G, k,
        metric, round_ops, static_cast<float*>(out_d),
        static_cast<int*>(out_i), static_cast<cudaStream_t>(stream));
  }
  if (extract == deep::kBinnedDeepHopper) {
    if (cap % NBINS != 0 || cap <= NBINS || cap / NBINS > 65536 ||
        (storage_kind >= 3 && (nw < 1 || (storage_kind == 3 && d != 8 * nw) ||
                               (storage_kind == 4 && d != 32 * nw))))
      return (int)cudaErrorInvalidValue;
    return deep::launch(
        storage_kind, storage, static_cast<const int*>(indices),
        static_cast<const int*>(list_sizes),
        static_cast<const int*>(bucket_list),
        static_cast<const int*>(bucket_q), static_cast<const float*>(queries),
        static_cast<const float*>(qaux), static_cast<const float*>(norms),
        static_cast<const int*>(keep), static_cast<const float*>(centers),
        scale, static_cast<const float*>(scale_vec),
        static_cast<const float*>(row_scale), cap, d, nw, nb, G, k, metric,
        round_ops, static_cast<float*>(out_d), static_cast<int*>(out_i),
        static_cast<cudaStream_t>(stream));
  }
  if (extract != kExact &&
      (cap % NBINS != 0 || cap <= NBINS || cap / NBINS > 65536 ||
       k > (extract == kBinned ? 64 : KMAX) ||
       (is_fold(extract) && k > 64 * bin_depth(extract))))
    return (int)cudaErrorInvalidValue;
  if (storage_kind >= 3 && storage_kind <= 5 &&
      (nw < 1 || (storage_kind == 3 && d != 8 * nw) ||
       (storage_kind == 4 && d != 32 * nw)))
    return (int)cudaErrorInvalidValue;
  if (storage_kind == 5 &&
      (pq_centers == nullptr || p < 1 || pl < 1 || p > 8 * nw ||
       d != p * pl || scale_vec != nullptr || metric == kCosine))
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
  const auto* sv = static_cast<const float*>(scale_vec);
  const auto* rs = static_cast<const float*>(row_scale);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* words = static_cast<const uint32_t*>(storage);
  switch (storage_kind) {
    case 1:
      return launch<__nv_bfloat16, kRowsDense>(
          static_cast<const __nv_bfloat16*>(storage), ix, ls, bl, bq, q, qa,
          xn, kp, ct, scale, sv, nullptr, cap, d, 0, nb, G, k, metric,
          round_ops, extract, od, oi, s);
    case 2:
      return launch<int8_t, kRowsDense>(
          static_cast<const int8_t*>(storage), ix, ls, bl, bq, q, qa, xn, kp,
          ct, scale, sv, nullptr, cap, d, 0, nb, G, k, metric, round_ops,
          extract, od, oi, s);
    case 3:
      return launch<uint32_t, kRowsI4>(words, ix, ls, bl, bq, q, qa, xn, kp,
                                       ct, scale, sv, nullptr, cap, d, nw,
                                       nb, G, k, metric, round_ops, extract,
                                       od, oi, s);
    case 4:
      return launch<uint32_t, kRowsBits>(words, ix, ls, bl, bq, q, qa, xn,
                                         kp, ct, scale, sv, rs, cap, d, nw,
                                         nb, G, k, metric, round_ops,
                                         extract, od, oi, s);
    case 6:
      return launch_plain_rows<__half>(
          static_cast<const __half*>(storage), ix, ls, bl, bq, q, qa, xn, kp,
          ct, scale, sv, cap, d, nb, G, k, metric, round_ops, extract, od,
          oi, s);
    case 7:
      return launch_plain_rows<uint8_t>(
          static_cast<const uint8_t*>(storage), ix, ls, bl, bq, q, qa, xn, kp,
          ct, scale, sv, cap, d, nb, G, k, metric, round_ops, extract, od,
          oi, s);
    case 5:
      return launch_pq4(words, ix, ls, bl, bq, q, xn, kp, ct,
                        static_cast<const float*>(pq_centers), cap, nw, p, pl,
                        nb, G, k, metric, round_ops, extract, od, oi, s);
    default:
      return launch<float, kRowsDense>(
          static_cast<const float*>(storage), ix, ls, bl, bq, q, qa, xn, kp,
          ct, scale, sv, nullptr, cap, d, 0, nb, G, k, metric, round_ops,
          extract, od, oi, s);
  }
}
