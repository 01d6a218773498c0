// Kernel 2's exact and binned arms over int8, i4, sign-bit, f32 and bf16
// rows, redesigned for Hopper on the binned_deep Hopper body
// (ivf_scan_deep.cuh; extract codes kExactHopper and kBinnedHopper, below;
// ops/ivf_scan.py:scan_body routes to them).
//
// Replaces, for the launches it covers, the shared core's exact and binned
// instantiations of ivf_list_scan_topk_kernel (scan_topk.cuh), which stay
// as they are for every other mode. It computes what the TPU kernel
// computes: raft_tpu/ops/ivf_scan.py:_scan_kernel (:198) over f32 or bf16
// rows and the int8 rows its float branch widens (:302-308), packed_i4
// (:281) or packed_bits with the row scale (:256, :310), then
// * the exact arm, _extract_topk (:70): each query's k smallest
//   distances, ties to the lowest position;
// * the binned arm, _extract_topk_binned (:89): one slot a bin of 128 (a
//   position's bin is its list offset mod 128), the bin's smallest
//   distance, the lowest position among equals; then the k smallest
//   slots, ties to the lowest position;
// with the stored ids, the keep filter, and (+inf, -1) for empty query
// slots, list tails and padding buckets.
//
// Covers what the binned_deep body covers (int8 rows with d a multiple of
// 16, i4 and sign words, d <= 128; residual, scaled, per-list-scaled or
// plain queries; L2, inner product, cosine; bf16 operands only), and f32
// and bf16 rows with d a multiple of 16 <= 128 and plain queries (the
// IVF-Flat scan), at k <= 64 and caps that are a multiple of 128 (128-row
// tiles read whole). Under bf16 operands every product of a bf16 query
// and a bf16 row value (an f32 row rounded to nearest even as its B
// fragment is built, as round_bf16 rounds it) is exact in f32, so, as for
// the integer rows, only the order of the f32 sums differs from the plain
// version.
//
// What held the shared core's arms back (PERF.md): it staged every query
// again for each 64-row tile, summed the dots on the CUDA cores, and
// selected through a shared distance tile behind block barriers; its
// binned arm (64 queries x 128 slots of 6 B) ran two blocks an SM, its
// exact arm four. The arms keep the binned_deep body's ring, B-fragment
// widening, mma.sync dots and epilogue (ivf_scan_deep.cuh), and stage the
// queries with its operations; they differ in where the A fragments live
// and in the selection:
// * The queries are prepared once a block in the A fragments' order, a
//   warp's 32 lanes' 16 B side by side (prep_bytes), and read from there
//   for each tile's dots, conflict-free. Held in registers for the whole
//   scan, as the binned_deep body holds them, they took 64 registers a
//   thread: the exact arm ran at 255 registers with its lists in local
//   memory, and neither arm could share an SM (PERF.md). Read
//   each tile, they leave at most 128 registers a thread, so two blocks
//   share an SM wherever twice their shared memory fits its 228 KB: the
//   binned arm always, the exact arm over int8 rows with norms and keep
//   at rot 96 for every k and at rot 128 to k 44.
// * binned: the lane that owns (query, bin) across the 128-row tiles
//   keeps the bin's best distance and its chunk in registers (16-bit
//   chunks two to a register), replaced by a strict `<` tile after tile:
//   position order, so the lowest position wins among equals, with no
//   slots in shared memory. After the scan the slots go to shared memory
//   once (where the ring was) and each warp takes its queries' k by
//   (distance, position) with the shared core's extract_bins<1>.
// * exact: each (query, row) distance strictly under the query's k-th
//   distance as of the tile before is buffered (at most one a row, so at
//   most 128 a tile: +inf and NaN never pass the strict test), then after
//   a block barrier warp w merges the buffered candidates of queries w, w
//   + 8, ... into their top-k lists (kept in shared memory, taken into the
//   warp's registers while it merges: entry j in lane j % 32, register j /
//   32), by (distance, position) whatever the buffer's order; the new
//   k-th distance is the next tile's threshold. An equal distance from a
//   later tile never enters: its position is higher. The merges are
//   chains of dependent shuffles, so they bound the arm: a list of k <=
//   32 (a register a lane) takes its candidates one at a time
//   (merge_list), a list of k > 32 (two, which double each insertion's
//   shuffles) sorts 16 or more in with it (warp_sort), as the first tiles
//   bring (PERF.md). Over f32 and bf16 rows a query's first tile, whose
//   valid rows are all candidates, is sorted alone (sort_query without
//   the list) instead.
// * Float rows are laid out in a ring stage for the B fragments' loads
//   (b_frag: a warp reads 8 rows' 16 dims side by side). A 128-row f32
//   tile is 64 KB at d 128, so a block of 64 queries holds an SM alone
//   and its 8 warps wait on the loads; a block of 128 queries (Q, 16
//   warps) hides them and halves the L2 traffic (PERF.md). The binned
//   arm takes the f32 rows as stored through the cp.async ring at Q 128;
//   the exact arm's buffer does not fit beside two f32 stages there, so
//   its threads load each f32 tile into registers while the warps work on
//   the tile before and store it rounded to bf16 (STAGED), where bf16
//   rows land as stored. arm_queries picks Q 128 for f32 rows and for the
//   bf16 rows' exact arm where the block fits (the exact arm to k 47),
//   else 64.
//
// Shared memory (smem_bytes) at Q queries: the prepared queries (Q / 16
// m-tiles x 16 B x 32 lanes a k-step: 16 KB at d 128 and Q 64), two ring
// stages (ivf_scan_deep.cuh), then the exact arm's buffer (Q queries x
// 128 rows of an f32 distance and a row byte, Q counts and thresholds:
// 41,472 B at Q 64) and lists (Q queries x k (f32, int32)); the binned
// arm's Q x 128 slots of 6 B reuse the front after the scan. At d 128
// with norms and keep, the 8 Q B of query ids and qaux included: int8
// rows (Q 64) 98,304 B (exact, k 10), 125,952 B (exact, k 64) and 51,712
// B (binned); f32 rows 194,560 B (exact, k 10, Q 128 staged), 224,256 B
// (exact, k 64, Q 64) and 166,912 B (binned, Q 128); bf16 rows 194,560
// B (exact, k 10, Q 128), 158,720 B (exact, k 64, Q 64) and 84,480 B
// (binned, Q 64).
//
// Bound (PERF.md): operations, 2 d per valid (query, row) pair on the bf16
// tensor cores; the list bytes are far below it.
//
// RTT_STAGES: 0 = the ring loads, the query preparation and the epilogue;
// 1 = plus the B fragments and the dots; 2 = plus the selection and the
// extraction (the whole kernel). With fewer than 2 the outputs are not
// results.
#pragma once

#include "ivf_scan_deep.cuh"
#include "scan_topk.cuh"
#include "topk_merge.cuh"

namespace rtt {
namespace arms {

constexpr int kExactHopper = 10;    // the C entry's extract codes
constexpr int kBinnedHopper = 11;
constexpr int AQ = deep::DQ;        // queries a block (64; 128 for float
                                    // rows where that fits, arm_queries)
constexpr int NQG = AQ / 32;        // query groups of 32 (a warp's 2 m-tiles)
constexpr int NCG = 4;              // column groups of 32 rows
constexpr int AW = NQG * NCG;       // warps a block
constexpr int ATH = 32 * AW;        // threads a block
constexpr int KA = 64;              // the largest k
constexpr int STATIC_BYTES = AQ * 8;   // qidx, qa

__host__ __device__ inline bool is_code(int extract) {
  return extract == kExactHopper || extract == kBinnedHopper;
}

// bytes of the prepared queries of q queries: q / 16 m-tiles x ks
// k-steps x 32 lanes x 16 B
__host__ __device__ inline int prep_bytes(int ks, int q) {
  return q / 16 * ks * 32 * 16;
}

// the row kind a ring stage holds: f32 rows of the exact arm at 128
// queries are converted to bf16 by the threads that load them (two f32
// stages would not fit beside that block's buffer)
__host__ __device__ constexpr int stage_rows(int rows, bool exact, int q) {
  return rows == deep::kRowsF32 && exact && q > AQ ? deep::kRowsBf16 : rows;
}

// dynamic shared memory of a launch of q queries a block: the prepared
// queries, the ring, then the exact arm's buffer and lists of k, or room
// for the binned arm's slots at the front
inline size_t smem_bytes(int rows, int d, int nw, int n_sides, int k,
                         bool exact, int q) {
  const size_t scan =
      (size_t)prep_bytes(deep::ksteps(rows, d, nw), q) +
      (size_t)deep::DNS *
          deep::stage_bytes(stage_rows(rows, exact, q), d, nw, n_sides);
  if (exact)
    return scan + (size_t)q * AT * 5 + (size_t)q * 8 + (size_t)q * k * 8;
  const size_t slots = (size_t)q * AT * 6;
  return scan > slots ? scan : slots;
}

// queries a block of a launch: 128 for f32 rows (two blocks of 64 could
// not share an SM) and for the bf16 rows' exact arm, where that block
// fits a block's shared memory (k <= 47 at the exact arm), else 64
inline int arm_queries(int rows, int d, int nw, int n_sides, int k,
                       bool exact) {
  if (!deep::is_float_rows(rows) || (rows == deep::kRowsBf16 && !exact))
    return AQ;
  return smem_bytes(rows, d, nw, n_sides, k, exact, 2 * AQ) +
                     2 * STATIC_BYTES <=
                 (size_t)deep::SMEM_LIMIT
             ? 2 * AQ
             : AQ;
}

// One block per (bucket, Q-query sub-tile), as the shared core's kernel;
// arguments as ivf_deep_scan_kernel's (rows of kind ROWS; d <= 128; L2
// when metric is L2); EXTRACT kExact or kBinned. Q = 64 (two blocks an
// SM where their shared memory fits) or 128 (float rows, one block).
template <int ROWS, bool L2, int EXTRACT, int Q>
__global__ void __launch_bounds__(4 * Q, Q == AQ ? 2 : 1)
ivf_arm_scan_kernel(const void* __restrict__ storage,
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
                    const float* __restrict__ row_scale, int cap, int d,
                    int nw, int G, int k, int n_sub, int metric,
                    float* __restrict__ out_d, int* __restrict__ out_i) {
  // the block's shape at Q queries (the namespace's at 64)
  constexpr int AQ = Q, NQG = Q / 32, AW = NQG * NCG, ATH = 32 * AW;
  constexpr bool EXACT = EXTRACT == kExact;
  // exact over float rows: a query's first tile sorted, not inserted
  constexpr bool FIRST_SORT = deep::is_float_rows(ROWS);
  // the ring's row kind: f32 rows converted to bf16 as they are stored
  constexpr bool STAGED = stage_rows(ROWS, EXACT, Q) != ROWS;
  constexpr int SROWS = stage_rows(ROWS, EXACT, Q);
  constexpr int MT = 2;                // m-tiles of 16 queries a warp
  constexpr int CW = AT / NCG;         // rows a column group
  constexpr int NT = CW / 8;           // n-tiles a warp
  constexpr int NP = MT * 2 * NT * 2;  // (query, row) pairs a lane a tile
  static_assert(NP == 32, "a lane owns 32 (query, bin) pairs");
  __shared__ int qidx[AQ];
  __shared__ float qas[AQ];
  extern __shared__ __align__(16) unsigned char dyn[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int qbase = (warp % NQG) * 16 * MT;
  const int cbase = (warp / NQG) * CW;

  const int b = blockIdx.x / n_sub;
  const int g0 = (blockIdx.x % n_sub) * AQ;
  const int l = bucket_list[b];
  int any = 0;
  if (tid < AQ) {
    const int g = g0 + tid;
    const int q = g < G ? bucket_q[(size_t)b * G + g] : -1;
    qidx[tid] = q;
    any = q >= 0;
  }
  const int size = __syncthreads_or(any) ? list_sizes[l] : 0;
  const size_t base = (size_t)l * cap;
  const float* center = centers ? centers + (size_t)l * d : nullptr;
  const float* sv = scale_vec ? scale_vec + (size_t)l * d : nullptr;
  if (tid < AQ) {
    const int q = qidx[tid];
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
    qas[tid] = qa;
  }

  // the block's queries prepared once, bf16, in the A fragments' order:
  // word r of lane (gid, t) of m-tile m at k-step s is at ((m KS + s) 32 +
  // lane) 4 + r, the pair of dims deep_dim(s, t, 2 (r / 2) + {0, 1}) of
  // query 16 m + gid + 8 (r % 2)
  const int KS = deep::ksteps(ROWS, d, nw);
  uint32_t* prep = reinterpret_cast<uint32_t*>(dyn);
  for (int i = tid; i < AQ / 16 * KS * 128; i += ATH) {
    const int r = i & 3, ln = (i >> 2) & 31, s = (i >> 7) % KS;
    const int q = qidx[16 * ((i >> 7) / KS) + (ln >> 2) + 8 * (r & 1)];
    uint32_t w = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = deep::deep_dim<ROWS>(s, ln & 3, 2 * (r >> 1) + h);
      float v = 0.f;
      if (q >= 0 && c < d)
        v = stage_query(queries[(size_t)q * d + c], center, c,
                        sv ? sv[c] : scale, true);
      w |= deep::bf16_bits(v) << (16 * h);
    }
    prep[i] = w;
  }
  __syncthreads();
  float qa_r[MT][2], qa_l2[MT][2];
  bool qv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = qbase + 16 * mt + gid + 8 * h;
      qv[mt][h] = qidx[slot] >= 0;
      qa_r[mt][h] = qas[slot];
      qa_l2[mt][h] = qv[mt][h] ? qa_r[mt][h] : INFINITY;
    }
  }

  // the ring behind the prepared queries; a stage holds the tile's rows,
  // then its side arrays
  const int nch = d / 16;
  const int n_sides = (norms != nullptr) + (keep != nullptr) +
                      (row_scale != nullptr);
  const int sbytes = deep::stage_bytes(SROWS, d, nw, n_sides);
  const int row_bytes = sbytes - n_sides * AT * 4;
  const int off_norms = row_bytes;
  const int off_keep = off_norms + (norms != nullptr) * AT * 4;
  const int off_rs = off_keep + (keep != nullptr) * AT * 4;
  unsigned char* ring = dyn + prep_bytes(KS, AQ);
  const unsigned char* list_rows =
      static_cast<const unsigned char*>(storage) +
      (ROWS == kRowsDense        ? (size_t)l * cap * d
       : ROWS == deep::kRowsF32  ? (size_t)l * cap * d * 4
       : ROWS == deep::kRowsBf16 ? (size_t)l * cap * d * 2
                                 : (size_t)l * nw * cap * 4);

  auto load_tile = [&](int t, unsigned char* st) {
    const int r0 = t * AT;
    if constexpr (ROWS == kRowsDense) {
      for (int c = tid; c < AT * nch; c += ATH) {
        const int r = c / nch, cc = c - r * nch;
        deep::cp_async16(st + (((r >> 3) * 8 * nch + 8 * cc + (r & 7)) << 4),
                         list_rows + (size_t)(r0 + r) * d + 16 * cc);
      }
    } else if constexpr (STAGED) {
      // the rows come through registers (fetch_rows, store_rows)
    } else if constexpr (deep::is_float_rows(ROWS)) {
      // 16-byte chunk c of the stage, in b_frag's order: (8-row group,
      // k-step, row, unit); a warp copies 8 rows' 16 dims (f32: 64 B a
      // row; bf16: 32) into 512 B side by side. F32 chunks are a lane's
      // unit (t = c % 4), bf16 chunks two (t = 2 (c % 2), + 1)
      constexpr int U = ROWS == deep::kRowsF32 ? 4 : 2;   // units a group
      constexpr int EB = ROWS == deep::kRowsF32 ? 4 : 2;  // element bytes
      for (int c = tid; c < AT * d * EB / 16; c += ATH) {
        const int grp = c / (8 * U), s = grp % nch;
        const int r = (grp / nch) * 8 + (c / U) % 8;
        deep::cp_async16(st + 16 * c,
                         list_rows + ((size_t)(r0 + r) * d + 16 * s +
                                      (c % U) * (16 / EB)) * EB);
      }
    } else {
      for (int c = tid; c < nw * (AT / 4); c += ATH) {
        const int w = c >> 5, r4 = (c & 31) * 4;
        deep::cp_async16(st + ((w * AT + ((r4 + 8 * w) & (AT - 1))) << 2),
                         list_rows + ((size_t)w * cap + r0 + r4) * 4);
      }
    }
    if (tid < AT / 4) {
      const size_t o = base + r0 + 4 * tid;
      if (norms) deep::cp_async16(st + off_norms + 16 * tid, norms + o);
      if (keep) deep::cp_async16(st + off_keep + 16 * tid, keep + o);
      if (row_scale) deep::cp_async16(st + off_rs + 16 * tid, row_scale + o);
    }
  };

  // STAGED: the tile's f32 rows in b_frag's bf16 units (4 dims, 8 B of
  // the stage, 16 B of f32), unit u = tid + j ATH in register j of the
  // thread (KS units a thread: 32 d units over 4 Q = 512 threads): a
  // warp reads 8 rows' 64 B and writes 256 B side by side
  auto fetch_rows = [&](int t, float4* v) {
    const float* src =
        reinterpret_cast<const float*>(list_rows) + (size_t)t * AT * d;
#pragma unroll
    for (int j = 0; j < deep::DKS; ++j)
      if (j < KS) {
        const int u = tid + j * ATH, grp = u >> 5;
        const int r = (grp / nch) * 8 + ((u >> 2) & 7);
        v[j] = __ldg(reinterpret_cast<const float4*>(
            src + (size_t)r * d + 16 * (grp % nch) + 4 * (u & 3)));
      }
  };
  auto store_rows = [&](const float4* v, unsigned char* st) {
#pragma unroll
    for (int j = 0; j < deep::DKS; ++j)
      if (j < KS)
        reinterpret_cast<uint2*>(st)[tid + j * ATH] =
            make_uint2(deep::f32x2_to_bf16(v[j].x, v[j].y),
                       deep::f32x2_to_bf16(v[j].z, v[j].w));
  };

  // exact: the buffer of candidates (distance, row in the tile) a query,
  // their counts, the thresholds (the k-th distance as of the tile
  // before), and the queries' top-k lists (entry j of query q at q KA +
  // j), each taken into one warp's registers while it merges
  unsigned char* arm = ring + deep::DNS * sbytes;
  float* cbd = reinterpret_cast<float*>(arm);
  unsigned char* cbr = arm + AQ * AT * 4;
  int* ccnt = reinterpret_cast<int*>(arm + AQ * AT * 5);
  float* cthr = reinterpret_cast<float*>(ccnt + AQ);
  float* sld = cthr + AQ;
  int* slp = reinterpret_cast<int*>(sld + AQ * k);
  // binned: the best distance of each of the lane's 32 (query, bin) pairs
  // (pair i = ((mt 2 + h) NT + j) 2 + e: query qbase + 16 mt + gid + 8 h,
  // bin cbase + 8 j + 2 t4 + e) and its chunk, two to a register
  float thr[NP];
  uint32_t bch[NP / 2];
  if constexpr (EXACT) {
    for (int i = tid; i < AQ * k; i += ATH) {
      sld[i] = INFINITY;
      slp[i] = -1;
    }
    if (tid < AQ) {
      ccnt[tid] = 0;
      cthr[tid] = INFINITY;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) thr[i] = INFINITY;
#pragma unroll
    for (int i = 0; i < NP / 2; ++i) bch[i] = 0u;
  }

  const int ntiles = (size + AT - 1) / AT;
  if (ntiles > 0) load_tile(0, ring);
  if constexpr (STAGED) {
    if (ntiles > 0) {
      float4 v[deep::DKS];
      fetch_rows(0, v);
      store_rows(v, ring);
    }
  }
  deep::cp_async_commit();
#if RTT_STAGES < 2
  float keep_live = INFINITY;
#endif
  for (int t = 0; t < ntiles; ++t) {
    deep::cp_async_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    // STAGED: the next tile's rows in flight to registers over the dots
    float4 nxt[STAGED ? deep::DKS : 1];
    if (t + 1 < ntiles) {
      load_tile(t + 1, ring + ((t + 1) & 1) * sbytes);
      if constexpr (STAGED) fetch_rows(t + 1, nxt);
    }
    deep::cp_async_commit();
    const unsigned char* st = ring + (t & 1) * sbytes;
    const int r0 = t * AT;

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
#if RTT_STAGES >= 1
#pragma unroll
    for (int s = 0; s < deep::DKS; ++s) {
      if (s < KS) {
        // the A fragments of the warp's two m-tiles, from the prepared
        // queries (16 B a lane, a warp's 512 B side by side)
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 v = reinterpret_cast<const uint4*>(
              prep)[((qbase / 16 + mt) * KS + s) * 32 + lane];
          a[mt][0] = v.x;
          a[mt][1] = v.y;
          a[mt][2] = v.z;
          a[mt][3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          deep::b_frag<SROWS>(st, cbase + 8 * j + gid, s, t4, nch, nw, b0,
                              b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            deep::mma_bf16(acc[mt][j], a[mt], b0, b1);
        }
      }
    }
#else
    // keep the query fragments live without the dots
    acc[0][0][0] = __uint_as_float(prep[lane] & 0x7FFF7FFFu);
#endif

    if constexpr (STAGED)
      if (t + 1 < ntiles) store_rows(nxt, ring + ((t + 1) & 1) * sbytes);

    // the thresholds of the lane's four queries (exact)
    float tq[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tq[mt][h] = EXACT ? cthr[qbase + 16 * mt + gid + 8 * h] : INFINITY;

    // the epilogue (as ivf_deep_scan_kernel's), then the selection
    const float* snorm = reinterpret_cast<const float*>(st + off_norms);
    const int* skeep = reinterpret_cast<const int*>(st + off_keep);
    const float* srs = reinterpret_cast<const float*>(st + off_rs);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      bool ok[2];
      float xn[2], plen[2], rs[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = cbase + 8 * j + 2 * t4 + e;
        ok[e] = r0 + row < size && (keep == nullptr || skeep[row] > 0);
        if constexpr (L2) {
          xn[e] = ok[e] ? snorm[row] : INFINITY;
        } else {
          xn[e] = (ok[e] && metric != kIP) ? snorm[row] : 0.f;
          plen[e] = metric == kCosine ? sqrtf(fmaxf(xn[e], 1e-30f)) : 0.f;
        }
        rs[e] = 1.f;
        if constexpr (ROWS == kRowsBits)
          if (ok[e] && row_scale != nullptr) rs[e] = srs[row];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // c = 2 h + e, as the accumulator
          const int h = c >> 1, e = c & 1;
          float dot = acc[mt][j][c];
          if constexpr (ROWS == kRowsBits) dot = __fmul_rn(dot, rs[e]);
          float dv;
          if constexpr (L2) {
            dv = fmaxf(__fmaf_rn(-2.f, dot, __fadd_rn(qa_l2[mt][h], xn[e])),
                       0.f);
            // float rows may hold inf or NaN, whose dot would turn the
            // +inf of a masked row or empty slot into 0 by fmaxf
            if constexpr (deep::is_float_rows(ROWS))
              dv = (ok[e] && qv[mt][h]) ? dv : INFINITY;
          } else
            dv = (ok[e] && qv[mt][h])
                     ? epilogue_dist(dot, qa_r[mt][h], xn[e], plen[e], metric)
                     : INFINITY;
#if RTT_STAGES >= 2
          const int row = cbase + 8 * j + 2 * t4 + e;
          if constexpr (EXACT) {
            // strict: +inf (an empty slot, a masked row) never enters, so
            // a query buffers at most the tile's AT rows
            if (dv < tq[mt][h]) {
              const int q = qbase + 16 * mt + gid + 8 * h;
              const int at = atomicAdd(&ccnt[q], 1);
              cbd[q * AT + at] = dv;
              cbr[q * AT + at] = static_cast<unsigned char>(row);
            }
          } else {
            const int i = ((mt * 2 + h) * NT + j) * 2 + e;
            if (dv < thr[i]) {
              const int sh = 16 * (i & 1);
              thr[i] = dv;
              bch[i >> 1] = (bch[i >> 1] & ~(0xFFFFu << sh)) |
                            (static_cast<uint32_t>(t) << sh);
            }
          }
#else
          keep_live = fminf(keep_live, dv);
#endif
        }
      }
    }
#if RTT_STAGES >= 2
    if constexpr (EXACT) {
      __syncthreads();   // the tile's candidates are buffered
      for (int qq = warp; qq < AQ; qq += AW) {
        const int n = ccnt[qq];
        if (n == 0) continue;
        // candidates are inserted one at a time into a list of k <= 32
        // (a register a lane); a list of k > 32 (two) sorts many of them
        // (the first tiles) in with it. Over float rows the first tile's
        // candidates (every valid row, the list empty) are sorted alone
        const float kd =
            FIRST_SORT && t == 0
                ? sort_query<4, false>(sld, slp, cbd, cbr, qq, n, r0, k, lane)
            : k <= 32 ? merge_query<1>(sld, slp, cbd, cbr, qq, n, r0, k, lane)
            : n < SORT_MIN
                ? merge_query<KA / 32>(sld, slp, cbd, cbr, qq, n, r0, k, lane)
            : k + n <= 128
                ? sort_query<4>(sld, slp, cbd, cbr, qq, n, r0, k, lane)
                : sort_query<8>(sld, slp, cbd, cbr, qq, n, r0, k, lane);
        __syncwarp();
        if (lane == 0) {
          ccnt[qq] = 0;
          cthr[qq] = kd;
        }
      }
    }
#endif
  }

#if RTT_STAGES < 2
  if (lane == 0) out_d[((size_t)b * G + g0) * k] = keep_live;
#else
  const int* ids = indices + base;
  if constexpr (EXACT) {
    __syncthreads();   // the last tile's merges are done
    for (int e = tid; e < AQ * k; e += ATH) {
      const int g = g0 + e / k;
      if (g >= G) continue;
      const size_t o = ((size_t)b * G + g) * k + e % k;
      const float dv = sld[e];
      out_d[o] = dv;
      out_i[o] = isinf(dv) ? -1 : ids[slp[e]];
    }
  } else {
    // the ring and the prepared queries are done with: the slots go to
    // shared memory, [query][bin], then each warp extracts its queries
    deep::cp_async_wait_all();
    __syncthreads();
    float* bsd = reinterpret_cast<float*>(dyn);
    uint16_t* bsc = reinterpret_cast<uint16_t*>(dyn + AQ * AT * 4);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int mt = i / (4 * NT), h = (i / (2 * NT)) & 1, j = (i >> 1) % NT,
                e = i & 1;
      const int s = (qbase + 16 * mt + gid + 8 * h) * AT + cbase + 8 * j +
                    2 * t4 + e;
      bsd[s] = thr[i];
      bsc[s] = static_cast<uint16_t>(bch[i >> 1] >> (16 * (i & 1)));
    }
    __syncthreads();
    for (int qq = warp; qq < AQ; qq += AW) {
      const int g = g0 + qq;
      if (g >= G) continue;
      const size_t o = ((size_t)b * G + g) * k;
      extract_bins<1>(bsd + qq * AT, bsc + qq * AT, k, ids, out_d + o,
                      out_i + o, lane);
    }
  }
#endif
}

template <int ROWS, bool L2, int EXTRACT, int Q>
static int launch_as(const void* storage, const int* indices,
                     const int* list_sizes, const int* bucket_list,
                     const int* bucket_q, const float* queries,
                     const float* qaux, const float* norms, const int* keep,
                     const float* centers, float scale,
                     const float* scale_vec, const float* row_scale, int cap,
                     int d, int nw, int nb, int G, int k, int metric,
                     float* out_d, int* out_i, cudaStream_t stream) {
  const int n_sub = (G + Q - 1) / Q;
  const int n_sides = (norms != nullptr) + (keep != nullptr) +
                      (row_scale != nullptr);
  const size_t smem =
      smem_bytes(ROWS, d, nw, n_sides, k, EXTRACT == kExact, Q);
  if (smem + (size_t)Q * 8 > (size_t)deep::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = ivf_arm_scan_kernel<ROWS, L2, EXTRACT, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<nb * n_sub, 4 * Q, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
      norms, keep, centers, scale, scale_vec, row_scale, cap, d, nw, G, k,
      n_sub, metric, out_d, out_i);
  return (int)cudaGetLastError();
}

// storage kind 0 (f32) or 1 (bf16) [C, cap, d] with plain queries (no
// centers or per-list scales, scale 1), 2 (int8 [C, cap, d]), 3 (i4) or 4
// (sign bits) [C, nw, cap], extract code `code` (kExactHopper or
// kBinnedHopper); the rest as the C entry's (round_ops required; k <= KA).
// Returns a cudaError_t code.
static int launch(int code, int storage_kind, const void* storage,
                  const int* indices, const int* list_sizes,
                  const int* bucket_list, const int* bucket_q,
                  const float* queries, const float* qaux, const float* norms,
                  const int* keep, const float* centers, float scale,
                  const float* scale_vec, const float* row_scale, int cap,
                  int d, int nw, int nb, int G, int k, int metric,
                  int round_ops, float* out_d, int* out_i,
                  cudaStream_t stream) {
  const int rows = storage_kind == 0   ? deep::kRowsF32
                   : storage_kind == 1 ? deep::kRowsBf16
                   : storage_kind == 2 ? kRowsDense
                   : storage_kind == 3 ? kRowsI4
                                       : kRowsBits;
  const bool dense = rows == kRowsDense || deep::is_float_rows(rows);
  if (storage_kind < 0 || storage_kind > 4 || !round_ops || d > 128 ||
      k > KA || (dense && d % 16 != 0) ||
      (rows != kRowsBits && row_scale != nullptr) ||
      (deep::is_float_rows(rows) &&
       (centers != nullptr || scale_vec != nullptr || scale != 1.f)) ||
      deep::ksteps(rows, d, nw) > deep::DKS)
    return (int)cudaErrorInvalidValue;
  if (!deep::aligned16(storage) || !deep::aligned16(norms) ||
      !deep::aligned16(keep) || !deep::aligned16(row_scale))
    return (int)cudaErrorMisalignedAddress;
  const bool exact = code != kBinnedHopper;
  const int q = arm_queries(rows, d, nw,
                            (norms != nullptr) + (keep != nullptr) +
                                (row_scale != nullptr),
                            k, exact);
#define RTT_ARM_Q(R, E, Q)                                                    \
  (metric == kL2                                                              \
       ? launch_as<R, true, E, Q>(storage, indices, list_sizes, bucket_list,  \
                                  bucket_q, queries, qaux, norms, keep,       \
                                  centers, scale, scale_vec, row_scale, cap,  \
                                  d, nw, nb, G, k, metric, out_d, out_i,      \
                                  stream)                                     \
       : launch_as<R, false, E, Q>(storage, indices, list_sizes, bucket_list, \
                                   bucket_q, queries, qaux, norms, keep,      \
                                   centers, scale, scale_vec, row_scale, cap, \
                                   d, nw, nb, G, k, metric, out_d, out_i,     \
                                   stream))
#define RTT_ARM(R, E) RTT_ARM_Q(R, E, AQ)
#define RTT_ARMS(E)                                                           \
  (rows == kRowsDense ? RTT_ARM(kRowsDense, E)                                \
                      : rows == kRowsI4 ? RTT_ARM(kRowsI4, E)                 \
                                        : RTT_ARM(kRowsBits, E))
  if (rows == deep::kRowsF32) {
    if (!exact) return RTT_ARM_Q(deep::kRowsF32, kBinned, 2 * AQ);
    return q > AQ ? RTT_ARM_Q(deep::kRowsF32, kExact, 2 * AQ)
                  : RTT_ARM_Q(deep::kRowsF32, kExact, AQ);
  }
  if (rows == deep::kRowsBf16) {
    if (!exact) return RTT_ARM_Q(deep::kRowsBf16, kBinned, AQ);
    return q > AQ ? RTT_ARM_Q(deep::kRowsBf16, kExact, 2 * AQ)
                  : RTT_ARM_Q(deep::kRowsBf16, kExact, AQ);
  }
  if (!exact) return RTT_ARMS(kBinned);
  return RTT_ARMS(kExact);
#undef RTT_ARMS
#undef RTT_ARM
#undef RTT_ARM_Q
}

}  // namespace arms
}  // namespace rtt
