// fused_knn_topk — brute-force distance + per-chunk top-k on Hopper.
//
// Replaces raft_tpu/ops/fused_topk.py:_fused_kernel (exact arm). Grid: one
// block per (64-query tile, row chunk), query tiles fastest so the blocks
// reading one chunk of rows run together and share it through L2. Each
// block streams its chunk through shared memory (scan_topk.cuh) and writes
// its queries' exact top-k to columns [chunk * k, chunk * k + k) of the
// [m, n_chunks * k] candidate buffer, which the caller merges.
//
// Bound on the H100: operations, counted as chip_smoke.py counts them. At
// 1,000 queries x 1M rows x 128 dims in f32 the dots are 256 GFLOP, 3.82 ms
// at the f32 CUDA cores' 67 TFLOP/s, against ~0.52 GB of inputs and
// outputs (0.15 ms at 3.35 TB/s). This first version runs the dots on those
// cores with a 4 x 4 register micro tile fed by 16-byte shared-memory
// loads; bf16 operands are widened to f32 (exact products), so for them
// the tensor cores (wgmma) are the next step. PERF.md splits its time by
// stage (staging, dots, top-k selection). Operands: f32 or bf16 rows,
// widened exactly; round_ops (bf16 queries, which arrive as exact bf16
// values in f32) rounds f32 rows to bf16, without it f32 queries meet the
// rows unrounded (f32 x bf16).
//
// The fold arm (EXTRACT = kFold2..kFold4; raft_tpu/ops/fused_topk.py:102,
// _extract_fold over fold_lane_stacks :76): a block's row chunk is one
// row tile of the reference (tile_n rows, a multiple of 128), and instead
// of top-k lists each query keeps the shared core's R-deep bins, a
// column's bin being its offset from the tile's start mod 128 (the
// reference's lane) and its chunk that offset / 128 (so the chunk stays
// under 16 even at tile_n = 2048, far inside its 16 bits). After the scan
// every slot is written out unextracted: slot (r, lane) of tile ch at
// column ch * 128 R + r * 128 + lane of the [m, n_chunks * 128 R] buffer,
// id -1 where +inf, which the caller merges exactly. Bound: the exact
// arm's operations, plus the candidate write (m * n_chunks * 128 R * 8 B).
// Its bins take 96 KB (R = 2) to 192 KB (R = 4) of shared memory beside
// the 35.3 KB of tiles, so one block runs on an SM; the exact arm's
// instantiations compile as they did before the fold.
//
// The fold arm has a second body, designed for Hopper
// (fused_fold_hopper.cuh, entry fused_knn_fold_hopper below): wgmma
// distance tiles of 128 queries (64 at R = 3, 4) x 128 rows from shared
// memory, the lane stacks in registers. bf16 queries with d a multiple
// of 16 and tiles of at most 2048 rows take it where the caller routes
// them (ops/fused_topk.py:fold_body); the rest keep this file's
// kFold2..4.
//
// The exact arm has a second body too (fused_exact_hopper.cuh, entry
// fused_knn_exact_hopper below): 128 queries a block, a cp.async ring of
// 64-row tiles under mbarriers, bf16 operands on wgmma tiles and f32
// operands as 3xTF32 on mma.sync, the candidates under each query's k-th
// distance merged by the warp that owns the query. f32 or bf16 queries
// over f32 or bf16 rows with d a multiple of 16 up to 128 and k <= 64
// take it where the caller routes them (ops/fused_topk.py:exact_body);
// the rest keep this file's kExact.
#include "scan_topk.cuh"
#include "fused_fold_hopper.cuh"
#include "fused_exact_hopper.cuh"

using namespace rtt;

template <typename T, int EXTRACT = kExact>
__global__ void __launch_bounds__(NTHREADS)
fused_knn_topk_kernel(const float* __restrict__ queries,
                      const float* __restrict__ qaux,
                      const T* __restrict__ x,
                      const float* __restrict__ norms,
                      const int* __restrict__ keep, int m, int n, int d,
                      int k, int chunk_rows, int n_chunks, int n_qtiles,
                      int metric, int round_ops, float* __restrict__ out_d,
                      int* __restrict__ out_i) {
  __shared__ Tiles t;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* topd = reinterpret_cast<float*>(dyn);
  // the top-k lists (exact) or the bins' distances, then positions or
  // chunks
  int* topp = reinterpret_cast<int*>(
      topd + QT * (EXTRACT == kExact ? k : bin_depth(EXTRACT) * NBINS));

  const int qt = blockIdx.x % n_qtiles;
  const int ch = blockIdx.x / n_qtiles;
  const int q0 = qt * QT;
  if (threadIdx.x < QT) {
    const int q = q0 + threadIdx.x;
    t.qidx[threadIdx.x] = q < m ? q : -1;
    t.qa[threadIdx.x] = (q < m && metric != kIP) ? qaux[q] : 0.f;
  }
  const int p_begin = ch * chunk_rows;
  const int p_end = min(n, p_begin + chunk_rows);
  __syncthreads();
  scan_topk<T, false, kRowsDense, false, EXTRACT>(
      t, topd, topp, queries, nullptr, 1.f, x, norms, keep, p_begin, p_end,
      d, k, metric, round_ops != 0);
  __syncthreads();

  if constexpr (EXTRACT == kExact) {
    const size_t width = (size_t)n_chunks * k;
    for (int e = threadIdx.x; e < QT * k; e += NTHREADS) {
      const int q = q0 + e / k;
      if (q >= m) continue;
      const size_t o = (size_t)q * width + (size_t)ch * k + e % k;
      const float dv = topd[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1 : topp[e];
    }
  } else {
    // every slot of the block's queries: bin b's level r of query qq is
    // topd[qq * W + r * NBINS + b], its column p_begin + 128 chunk + b
    constexpr int W = bin_depth(EXTRACT) * NBINS;
    const uint16_t* sc = reinterpret_cast<const uint16_t*>(topp);
    const size_t width = (size_t)n_chunks * W;
    for (int e = threadIdx.x; e < QT * W; e += NTHREADS) {
      const int q = q0 + e / W;
      if (q >= m) continue;
      const int s = e % W;
      const size_t o = (size_t)q * width + (size_t)ch * W + s;
      const float dv = topd[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1
                           : p_begin + NBINS * sc[e] + (s & (NBINS - 1));
    }
  }
}

template <typename T, int EXTRACT>
static int launch_as(const float* queries, const float* qaux, const T* x,
                     const float* norms, const int* keep, int m, int n,
                     int d, int k, int chunk_rows, int n_chunks, int metric,
                     int round_ops, float* out_d, int* out_i,
                     cudaStream_t stream) {
  const int n_qtiles = (m + QT - 1) / QT;
  const size_t smem = topk_smem_bytes(k, EXTRACT);
  auto kernel = fused_knn_topk_kernel<T, EXTRACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<n_qtiles * n_chunks, NTHREADS, smem, stream>>>(
      queries, qaux, x, norms, keep, m, n, d, k, chunk_rows, n_chunks,
      n_qtiles, metric, round_ops, out_d, out_i);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const float* queries, const float* qaux, const T* x,
                  const float* norms, const int* keep, int m, int n, int d,
                  int k, int chunk_rows, int n_chunks, int metric,
                  int round_ops, int fold_r, float* out_d, int* out_i,
                  cudaStream_t stream) {
#define RTT_ARM(EXTRACT)                                                      \
  launch_as<T, EXTRACT>(queries, qaux, x, norms, keep, m, n, d, k,            \
                        chunk_rows, n_chunks, metric, round_ops, out_d,       \
                        out_i, stream)
  if (fold_r == 2) return RTT_ARM(kFold2);
  if (fold_r == 3) return RTT_ARM(kFold3);
  if (fold_r == 4) return RTT_ARM(kFold4);
  return RTT_ARM(kExact);
#undef RTT_ARM
}

// queries [m, d] f32; qaux [m] f32 (null for IP); x [n, d] f32 or bf16
// (x_bf16); norms [n] f32 (null for IP); keep [n] int32 or null;
// round_ops: the queries hold bf16 values and f32 rows are rounded to
// bf16; fold_r 0 for the exact arm, else the fold's depth R (2-4), with
// chunk_rows the row tile (a multiple of 128); out_d / out_i
// [m, n_chunks * k] (exact) or [m, n_chunks * 128 R] (fold). Returns a
// cudaError_t code.
extern "C" int fused_knn_topk(const void* queries, const void* qaux,
                              const void* x, int x_bf16, const void* norms,
                              const void* keep, int m, int n, int d, int k,
                              int chunk_rows, int n_chunks, int metric,
                              int round_ops, int fold_r, void* out_d,
                              void* out_i, void* stream) {
  if (k < 1 || k > KMAX || m < 1 || n < 1 || d < 1 || chunk_rows < 1 ||
      n_chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (fold_r != 0 &&
      (fold_r < 2 || fold_r > 4 || chunk_rows % NBINS != 0 ||
       chunk_rows / NBINS > 65536))
    return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(queries);
  const auto* qa = static_cast<const float*>(qaux);
  const auto* xn = static_cast<const float*>(norms);
  const auto* kp = static_cast<const int*>(keep);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch(q, qa, static_cast<const __nv_bfloat16*>(x), xn, kp, m, n,
                  d, k, chunk_rows, n_chunks, metric, round_ops, fold_r, od,
                  oi, s);
  return launch(q, qa, static_cast<const float*>(x), xn, kp, m, n, d, k,
                chunk_rows, n_chunks, metric, round_ops, fold_r, od, oi, s);
}

// The fold through the Hopper body (fused_fold_hopper.cuh): queries [m, d]
// bf16 (16-byte aligned); qaux [m] f32 (null for IP); x [n, d] bf16
// (x_bf16, 16-byte aligned) or f32 (rounded to bf16); norms [n] f32 (null
// for IP); keep [n] int32 or null; d a multiple of 16 within a block's
// shared memory; tile_n a multiple of 128 up to 2048; fold_r 2-4; out_d /
// out_i [m, n_tiles * 128 R]. Returns a cudaError_t code.
extern "C" int fused_knn_fold_hopper(const void* queries, const void* qaux,
                                     const void* x, int x_bf16,
                                     const void* norms, const void* keep,
                                     int m, int n, int d, int tile_n,
                                     int n_tiles, int metric, int fold_r,
                                     void* out_d, void* out_i,
                                     void* stream) {
  if (m < 1 || n < 1 || d < 16 || d % 16 != 0 || tile_n < NBINS ||
      tile_n % NBINS != 0 || tile_n / NBINS > foldh::MAX_CHUNKS ||
      n_tiles != (n + tile_n - 1) / tile_n || fold_r < 2 || fold_r > 4 ||
      foldh::smem_bytes(fold_r, d) > 232448)
    return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const __nv_bfloat16*>(queries);
  const auto* qa = static_cast<const float*>(qaux);
  const auto* xn = static_cast<const float*>(norms);
  const auto* kp = static_cast<const int*>(keep);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return foldh::launch_r(fold_r, q, qa,
                           static_cast<const __nv_bfloat16*>(x), xn, kp, m,
                           n, d, tile_n, n_tiles, metric, od, oi, s);
  return foldh::launch_r(fold_r, q, qa, static_cast<const float*>(x), xn,
                         kp, m, n, d, tile_n, n_tiles, metric, od, oi, s);
}

// The exact arm through the Hopper body (fused_exact_hopper.cuh): queries
// [m, d] bf16 (bf16_ops) or f32, 16-byte aligned; qaux [m] f32 (null for
// IP); x [n, d] bf16 (x_bf16) or f32, 16-byte aligned; norms [n] f32 (null
// for IP) and keep [n] int32 or null, 16-byte aligned; d a multiple of 16
// up to 128; k <= 64; chunk_rows a multiple of 64 with n_chunks =
// ceil(n / chunk_rows); block_q and stages the body's queries a block and
// ring stages (exacth::block_queries, ring_stages); out_d / out_i [m,
// n_chunks * k]. Returns a cudaError_t code.
extern "C" int fused_knn_exact_hopper(const void* queries, const void* qaux,
                                      const void* x, int x_bf16,
                                      const void* norms, const void* keep,
                                      int m, int n, int d, int k,
                                      int chunk_rows, int n_chunks,
                                      int metric, int bf16_ops, int block_q,
                                      int stages, void* out_d, void* out_i,
                                      void* stream) {
  using namespace exacth;
  const bool bo = bf16_ops != 0, xb16 = x_bf16 != 0;
  if (m < 1 || n < 1 || d < 16 || d % 16 != 0 || d > EDMAX || k < 1 ||
      k > EKA || chunk_rows < ET || chunk_rows % ET != 0 ||
      n_chunks != (n + chunk_rows - 1) / chunk_rows ||
      block_q != block_queries(bo, xb16, d, k) ||
      stages != ring_stages(bo, xb16, d, k, block_q) ||
      smem_bytes(bo, xb16, d, k, block_q, stages) + STATIC_BYTES >
          (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto aligned16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  if (!aligned16(queries) || !aligned16(x) || !aligned16(norms) ||
      !aligned16(keep))
    return (int)cudaErrorMisalignedAddress;
  const auto* qa = static_cast<const float*>(qaux);
  const auto* xn = static_cast<const float*>(norms);
  const auto* kp = static_cast<const int*>(keep);
  auto* od = static_cast<float*>(out_d);
  auto* oi = static_cast<int*>(out_i);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* xh = static_cast<const __nv_bfloat16*>(x);
  const auto* xf = static_cast<const float*>(x);
  if (bo)
    return xb16 ? launch_q<true>(block_q, queries, qa, xh, xn, kp, m, n, d,
                                 k, chunk_rows, n_chunks, metric, stages,
                                 od, oi, s)
                : launch_q<true>(block_q, queries, qa, xf, xn, kp, m, n, d,
                                 k, chunk_rows, n_chunks, metric, stages,
                                 od, oi, s);
  return xb16 ? launch_q<false>(block_q, queries, qa, xh, xn, kp, m, n, d, k,
                                chunk_rows, n_chunks, metric, stages, od,
                                oi, s)
              : launch_q<false>(block_q, queries, qa, xf, xn, kp, m, n, d, k,
                                chunk_rows, n_chunks, metric, stages, od,
                                oi, s);
}
