// Kernel 2's binned_deep arm redesigned for Hopper (extract code
// kBinnedDeepHopper, below; ops/ivf_scan.py:binned_deep_body routes to it).
//
// Replaces, for the modes it covers, the shared core's binned_deep
// instantiations of ivf_list_scan_topk_kernel (scan_topk.cuh, EXTRACT =
// kBinnedDeep). It computes what the TPU arm computes:
// raft_tpu/ops/ivf_scan.py:_extract_topk_binned_deep (:123) inside
// _scan_kernel (:198): R = 4 slots a bin of 128 (a position's bin is its
// list offset mod 128), filled in position order by the compare-swap
// cascade with a strict `<`, then each query's k smallest slots by
// (distance, bin, level).
//
// Covers: int8 rows (d a multiple of 16), packed signed i4 and packed sign
// bits with the row scale, d <= 128; residual (centers), scaled,
// per-list-scaled or plain queries; L2, inner product, cosine; the keep
// filter; bf16 operands only (round_ops), since the dots run on the bf16
// tensor cores, where every product of a bf16 query and a row value in
// [-128, 127] is exact and only the order of the f32 sums differs from
// the plain version.
//
// What held the shared core's arm back (PERF.md): 64 queries x 512 slots
// of 6 B in shared memory beside its 35 KB of tiles left one block an
// SM, and its tile loop staged all queries again for every 64 rows,
// loaded the rows, waited at a barrier, summed 32 f32 products a slice on
// the CUDA cores and binned through a shared distance tile, each step in
// turn. Here:
//
// * One thread owns each (query, bin) for the whole scan. Tiles are 128
//   rows, one chunk, so a tile meets each bin once a query. The 8 warps
//   split a 64-query x 128-row tile into 2 query groups of 32 x 4 column
//   groups of 32 rows, MT = 2 m-tiles of 16 queries a warp, so each B
//   fragment feeds two mma (4 x 2 warps of 16 x 64 widened each B
//   fragment for one mma and measured 12-17% slower, PERF.md), and
//   accumulator element (query, column) of a warp's mma.sync.m16n8k16
//   tiles is the same (query, bin) on every tile. Its lane runs the
//   epilogue (under L2 one fma, a build of its own) and the cascade from
//   its registers into its own slots, tile after tile in chunk order: the
//   reference's order, with no
//   shared distance tile, no barrier and no atomics. Each lane keeps its
//   32 pairs' last level in registers, so a distance that cannot enter
//   costs one compare; the slots (level r of bin b: a float4 of the four
//   distances and a uint2 of their 16-bit chunks, 24 B a bin) stay in
//   shared memory, bin b of query q at b ^ swizzle(q) so that a warp's
//   float4 and uint2 accesses spread over the banks. The cascade takes
//   four pairs at a time (one column pair of two query rows): their slots
//   are read together where any of the four enters, so the reads'
//   latencies overlap.
// * Queries are prepared once a block: (q - c) * s rounded to bf16 with
//   stage_query's operations by the whole block, in fragment order, where
//   the slots will be, then held for the whole scan as each warp's mma A
//   fragments (32 rows x d, 8 registers a lane per 16 dims); qaux as
//   the shared core's kernel computes it.
// * Rows come through a 2-stage cp.async ring as stored (int8 bytes, i4
//   or sign words), with each tile's norms, keep and row scales; a tile
//   is loaded while the warps work on the one before. The B fragments are
//   widened to bf16 as they are built (int8 through the f32 magic-number
//   conversion, i4 and sign bits by bit operations), exact for
//   [-128, 127], [-8, 7] and +-1. A fragment's 16 dims are not the
//   dims' natural order: each storage kind takes the order in which a
//   lane reads its bytes or words in one load, and the A fragments follow
//   the same order (deep_dim).
// * After the scan and one barrier, warp w extracts queries w, w + 8, ...
//   by one bitonic sort of the query's 512 slots in registers
//   (extract_deep), whose cost does not depend on k; it beat
//   extract_bins' k passes at k = 30, 40 and 64 (PERF.md).
//
// Shared memory at 64 queries: 196,608 B of slots + 2 x (128 d B of int8
// rows, 64 d of i4 or 16 d of sign words, + 512 B for each side array)
// + 512 B of query ids and qaux: 231,936 B at int8, d = 128 with norms
// and keep, within the 232,448 B a block may use (deep_smem_bytes), so one
// block an SM, 8 warps, and up to 255 registers a thread.
//
// Bound (PERF.md): operations, 2 d per valid (query, row) pair on the bf16
// tensor cores; the list bytes are far below it.
//
// RTT_STAGES: 0 = the ring loads, the query preparation and the epilogue;
// 1 = plus the B fragments and the dots; 2 = plus the cascade and the
// extraction (the whole kernel). With fewer than 2 the outputs are not
// results.
#pragma once

#include "scan_topk.cuh"

namespace rtt {
namespace deep {

constexpr int kBinnedDeepHopper = 6;   // the C entry's extract code
constexpr int DQ = QT;                 // queries a block (64)
constexpr int DT = NBINS;              // rows a tile: one chunk (128)
constexpr int DR = 4;                  // levels a bin
constexpr int DNS = 2;                 // ring stages
constexpr int DKS = 8;                 // k-steps of 16 dims at most (d 128)
constexpr int SMEM_LIMIT = 232448;     // a block's shared memory (H100)
constexpr int SLOT_BYTES = DQ * DT * (16 + 8);
constexpr int STATIC_BYTES = DQ * 8;   // qidx, qa
// dense f32 and bf16 rows, which only the arms' body takes
// (ivf_scan_arms.cuh): their tiles are laid out for b_frag's loads
constexpr int kRowsF32 = 3;
constexpr int kRowsBf16 = 4;

__host__ __device__ constexpr bool is_float_rows(int rows) {
  return rows == kRowsF32 || rows == kRowsBf16;
}

// bytes of one ring stage: the tile's rows, then 128 floats or ints for
// each side array present (norms, keep, row scales)
__host__ __device__ inline int stage_bytes(int rows, int d, int nw,
                                           int n_sides) {
  return (rows == kRowsDense  ? DT * d
          : rows == kRowsF32  ? DT * d * 4
          : rows == kRowsBf16 ? DT * d * 2
                              : DT * nw * 4) +
         n_sides * DT * 4;
}

// dynamic shared memory of a launch (slots + ring)
inline size_t deep_smem_bytes(int rows, int d, int nw, int n_sides) {
  return (size_t)SLOT_BYTES + (size_t)DNS * stage_bytes(rows, d, nw, n_sides);
}

// k-steps of 16 dims a row kind needs for width d (nw words)
__host__ __device__ inline int ksteps(int rows, int d, int nw) {
  return rows == kRowsDense || is_float_rows(rows)
             ? d / 16
             : rows == kRowsI4 ? 2 * ((nw + 3) / 4) : 2 * nw;
}

// The dim that element e (0..3: k slots 2t, 2t + 1, 2t + 8, 2t + 9 of the
// mma) of k-step s holds for the lane with t = threadID_in_group: int8
// rows read 4 bytes at 16 s + 4 t (f32 and bf16 rows the 4 elements
// there); i4 rows word 4 (s / 2) + t, whose nibbles n and n + 4 make one
// bf16 pair; sign words word s / 2, whose bits i and i + 16 make one pair.
template <int ROWS>
__device__ __forceinline__ int deep_dim(int s, int t, int e) {
  if constexpr (ROWS == kRowsDense || is_float_rows(ROWS))
    return 16 * s + 4 * t + e;
  if constexpr (ROWS == kRowsI4)
    return 8 * (4 * (s >> 1) + t) + 2 * (s & 1) + (e >> 1) + 4 * (e & 1);
  return 32 * (s >> 1) + 16 * (e & 1) + 8 * (s & 1) + 2 * t + (e >> 1);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(
      __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

__device__ __forceinline__ int swz(int q) { return (q & 1) | ((q & 2) << 2); }

// slot index of bin b of block query q
__device__ __forceinline__ int slot_of(int q, int b) {
  return q * DT + (b ^ swz(q));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4 int8 bytes -> two bf16 pairs (bytes 0, 1 and 2, 3), exact: each byte,
// offset to u = b + 128, becomes the f32 2^23 + u by a byte permute,
// 2^23 + 128 is subtracted, and the exact small integer's upper 16 bits
// are its bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t x = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) -
                   8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// nibbles n and n + 4 of an i4 word (signed, [-8, 7]) as one bf16 pair:
// u = nibble + 8 under the bf16 128.0 makes 128 + u, less 136
__device__ __forceinline__ uint32_t i4_pair(uint32_t x88, int n) {
  const uint32_t v = ((x88 >> (4 * n)) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(
      *reinterpret_cast<const __nv_bfloat162*>(&v),
      __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// two f32 values rounded to nearest even as one bf16 pair (lo in the low
// half), as round_bf16 rounds each
__device__ __forceinline__ uint32_t f32x2_to_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// bits i and i + 16 of a sign word as one bf16 pair (+1 set, -1 clear);
// `inv` is the word inverted, so a clear bit sets the bf16 sign
__device__ __forceinline__ uint32_t bits_pair(uint32_t inv, int i) {
  return ((inv << (15 - i)) & 0x80008000u) | 0x3F803F80u;
}

// The B fragment (b0, b1) of k-step s for the lane's column row `row` of
// the tile in ring stage `rows_s`. int8 rows: 16-byte chunk c of row r at
// chunk (r / 8) 8 nch + 8 c + r % 8, so the 8 rows one load reads sit in
// 8 consecutive chunks; words: word w of row r at w 128 + (r + 8 w) % 128;
// f32 (bf16) rows: the 4 elements 16 s + 4 t.. of row r, 16 (8) B, at
// unit ((r / 8) nch + s) 32 + 4 (r % 8) + t, so a warp's load of 8 rows
// reads 512 (256) B side by side, rounded to bf16 as it is read (f32).
template <int ROWS>
__device__ __forceinline__ void b_frag(const unsigned char* rows_s, int row,
                                       int s, int t, int nch, int nw,
                                       uint32_t& b0, uint32_t& b1) {
  if constexpr (ROWS == kRowsDense) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        rows_s + (((row >> 3) * 8 * nch + 8 * s + (row & 7)) << 4) + 4 * t);
    i8x4_to_bf16(w, b0, b1);
  } else if constexpr (ROWS == kRowsF32) {
    const float4 v = reinterpret_cast<const float4*>(
        rows_s)[((row >> 3) * nch + s) * 32 + 4 * (row & 7) + t];
    b0 = f32x2_to_bf16(v.x, v.y);
    b1 = f32x2_to_bf16(v.z, v.w);
  } else if constexpr (ROWS == kRowsBf16) {
    const uint2 v = reinterpret_cast<const uint2*>(
        rows_s)[((row >> 3) * nch + s) * 32 + 4 * (row & 7) + t];
    b0 = v.x;
    b1 = v.y;
  } else if constexpr (ROWS == kRowsI4) {
    const int w = 4 * (s >> 1) + t;
    // words past the row's nw meet query dims past d, which are 0
    const uint32_t word =
        w < nw ? reinterpret_cast<const uint32_t*>(
                     rows_s)[w * DT + ((row + 8 * w) & (DT - 1))]
               : 0u;
    const uint32_t x = word ^ 0x88888888u;
    b0 = i4_pair(x, 2 * (s & 1));
    b1 = i4_pair(x, 2 * (s & 1) + 1);
  } else {
    const int w = s >> 1;
    const uint32_t inv = ~reinterpret_cast<const uint32_t*>(
        rows_s)[w * DT + ((row + 8 * w) & (DT - 1))];
    const int i = 8 * (s & 1) + 2 * t;
    b0 = bits_pair(inv, i);
    b1 = bits_pair(inv, i + 1);
  }
}

// The cascade of one newcomer (nd, chunk nc) into the four sorted levels
// of one bin, (L, C): as the reference's compare-swap with a strict `<`,
// the newcomer takes the first level it beats and the displaced slot goes
// on down (an equal slot stops it). A newcomer of +inf changes nothing.
__device__ __forceinline__ void deep_cascade(float4& L, uint2& C, float nd,
                                             uint32_t nc) {
  uint32_t c0 = C.x & 0xFFFFu, c1 = C.x >> 16, c2 = C.y & 0xFFFFu,
           c3 = C.y >> 16;
#define RTT_LEVEL(LV, CV)                  \
  {                                        \
    const bool sw = nd < LV;               \
    const float od = LV;                   \
    const uint32_t oc = CV;                \
    LV = sw ? nd : LV;                     \
    CV = sw ? nc : CV;                     \
    nd = sw ? od : nd;                     \
    nc = sw ? oc : nc;                     \
  }
  RTT_LEVEL(L.x, c0)
  RTT_LEVEL(L.y, c1)
  RTT_LEVEL(L.z, c2)
  RTT_LEVEL(L.w, c3)
#undef RTT_LEVEL
  C = make_uint2(c0 | (c1 << 16), c2 | (c3 << 16));
}

// One warp takes k entries from block query q's slots in the reference's
// order (distance, then bin, then level) by sorting all 512 at once on
// (distance, key = 4 bin + level): a bitonic network over element
// i = 16 lane + j (register j of the lane), where strides under 16
// compare two registers of a lane and wider ones two lanes by shuffles;
// element i is then the i-th entry, (+inf, -1) once the slots run out.
// The chunk rides in the key's low 16 bits, below the (bin, level) that
// orders it.
__device__ __forceinline__ bool deep_less(float a, uint32_t ka, float b,
                                          uint32_t kb) {
  return a < b || (a == b && ka < kb);
}

__device__ void extract_deep(const float4* sd, const uint2* sc, int q, int k,
                             const int* __restrict__ ids, float* od, int* oi,
                             int lane) {
  constexpr int S = 4 * DR;
  float v[S];
  uint32_t key[S];
  // lane l takes bins l + 32 i (4 bins of 4 levels each, 16 slots)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = lane + 32 * i;
    const float4 L = sd[slot_of(q, b)];
    const uint2 C = sc[slot_of(q, b)];
    const float lv[4] = {L.x, L.y, L.z, L.w};
    const uint32_t ch[4] = {C.x & 0xFFFFu, C.x >> 16, C.y & 0xFFFFu,
                            C.y >> 16};
#pragma unroll
    for (int r = 0; r < DR; ++r) {
      v[4 * i + r] = lv[r];
      key[4 * i + r] = (static_cast<uint32_t>(b * DR + r) << 16) | ch[r];
    }
  }
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
          const uint32_t pk = __shfl_xor_sync(0xffffffffu, key[j], ls);
          // the lower element of an ascending pair keeps the smaller
          if (deep_less(pv, pk, v[j], key[j]) == (lower == up)) {
            v[j] = pv;
            key[j] = pk;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const int j2 = j ^ stride;
          if (j2 > j) {
            const bool up = ((S * lane + j) & size) == 0;
            if (deep_less(v[j2], key[j2], v[j], key[j]) == up) {
              const float tv = v[j];
              const uint32_t tk = key[j];
              v[j] = v[j2];
              key[j] = key[j2];
              v[j2] = tv;
              key[j2] = tk;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const int e = S * lane + j;
    if (e < k) {
      const bool inf = v[j] == INFINITY;
      od[e] = v[j];
      oi[e] = inf ? -1
                  : ids[static_cast<int>(key[j] & 0xFFFFu) * DT +
                        static_cast<int>(key[j] >> 18)];
    }
  }
}

// One block per (bucket, 64-query sub-tile), as the shared core's kernel;
// arguments as ivf_list_scan_topk_kernel's (rows of kind ROWS; d <= 128;
// L2 when metric is L2, a separate build so that neither carries the
// other's epilogue).
template <int ROWS, bool L2>
__global__ void __launch_bounds__(NTHREADS, 1)
ivf_deep_scan_kernel(const void* __restrict__ storage,
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
  constexpr int MT = 2;                // m-tiles of 16 queries a warp
  constexpr int NQG = 4 / MT;          // query groups
  constexpr int NCG = NWARPS / NQG;    // column groups
  constexpr int CW = DT / NCG;         // rows a column group
  constexpr int NT = CW / 8;           // n-tiles a warp
  constexpr int NP = MT * 2 * NT * 2;  // (query, bin) pairs a lane
  static_assert(NP == 32, "a lane owns 32 (query, bin) pairs");
  __shared__ int qidx[DQ];
  __shared__ float qas[DQ];
  extern __shared__ __align__(16) unsigned char dyn[];
  float4* sd = reinterpret_cast<float4*>(dyn);
  uint2* sc = reinterpret_cast<uint2*>(dyn + DQ * DT * 16);
  unsigned char* ring = dyn + SLOT_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int qbase = (warp % NQG) * 16 * MT;
  const int cbase = (warp / NQG) * CW;

  const int b = blockIdx.x / n_sub;
  const int g0 = (blockIdx.x % n_sub) * DQ;
  const int l = bucket_list[b];
  int any = 0;
  if (tid < DQ) {
    const int g = g0 + tid;
    const int q = g < G ? bucket_q[(size_t)b * G + g] : -1;
    qidx[tid] = q;
    any = q >= 0;
  }
  const int size = __syncthreads_or(any) ? list_sizes[l] : 0;
  const size_t base = (size_t)l * cap;
  const float* center = centers ? centers + (size_t)l * d : nullptr;
  const float* sv = scale_vec ? scale_vec + (size_t)l * d : nullptr;
  if (tid < DQ) {
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

  __syncthreads();

  // the block's queries prepared once, bf16 in fragment order (query q,
  // k-step s, lane group t, element e at ((q KS + s) 4 + t) 4 + e), staged
  // where the slots will be; then each warp takes its A fragments
  const int KS = ksteps(ROWS, d, nw);
  uint16_t* prep = reinterpret_cast<uint16_t*>(dyn);
  for (int i = tid; i < DQ * KS * 16; i += NTHREADS) {
    const int q = qidx[i / (KS * 16)];
    const int r = i % (KS * 16);
    const int c = deep_dim<ROWS>(r >> 4, (r >> 2) & 3, r & 3);
    float v = 0.f;
    if (q >= 0 && c < d)
      v = stage_query(queries[(size_t)q * d + c], center, c,
                      sv ? sv[c] : scale, true);
    prep[i] = static_cast<uint16_t>(bf16_bits(v));
  }
  __syncthreads();
  uint32_t afr[MT][DKS][4];
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
#pragma unroll
    for (int s = 0; s < DKS; ++s) {
      uint2 lo = make_uint2(0u, 0u), hi = make_uint2(0u, 0u);
      if (s < KS) {
        const int row = qbase + 16 * mt + gid;
        lo = *reinterpret_cast<const uint2*>(prep +
                                             ((row * KS + s) * 4 + t4) * 4);
        hi = *reinterpret_cast<const uint2*>(
            prep + (((row + 8) * KS + s) * 4 + t4) * 4);
      }
      afr[mt][s][0] = lo.x;
      afr[mt][s][1] = hi.x;
      afr[mt][s][2] = lo.y;
      afr[mt][s][3] = hi.y;
    }
  }
  __syncthreads();

  // the lane's slots start empty: +inf, chunk 0
  float thr[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int mt = i / (4 * NT), h = (i / (2 * NT)) & 1, j = (i >> 1) % NT,
              e = i & 1;
    const int s = slot_of(qbase + 16 * mt + gid + 8 * h,
                          cbase + 8 * j + 2 * t4 + e);
    sd[s] = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    sc[s] = make_uint2(0u, 0u);
    thr[i] = INFINITY;
  }

  // the ring: a stage holds the tile's rows, then its side arrays
  const int nch = d / 16;
  const int n_sides = (norms != nullptr) + (keep != nullptr) +
                      (row_scale != nullptr);
  const int sbytes = stage_bytes(ROWS, d, nw, n_sides);
  const int row_bytes = sbytes - n_sides * DT * 4;
  const int off_norms = row_bytes;
  const int off_keep = off_norms + (norms != nullptr) * DT * 4;
  const int off_rs = off_keep + (keep != nullptr) * DT * 4;
  const unsigned char* list_rows =
      static_cast<const unsigned char*>(storage) +
      (ROWS == kRowsDense ? (size_t)l * cap * d : (size_t)l * nw * cap * 4);

  auto load_tile = [&](int t, unsigned char* st) {
    const int r0 = t * DT;
    if constexpr (ROWS == kRowsDense) {
      for (int c = tid; c < DT * nch; c += NTHREADS) {
        const int r = c / nch, cc = c - r * nch;
        cp_async16(st + (((r >> 3) * 8 * nch + 8 * cc + (r & 7)) << 4),
                   list_rows + (size_t)(r0 + r) * d + 16 * cc);
      }
    } else {
      for (int c = tid; c < nw * (DT / 4); c += NTHREADS) {
        const int w = c >> 5, r4 = (c & 31) * 4;
        cp_async16(st + ((w * DT + ((r4 + 8 * w) & (DT - 1))) << 2),
                   list_rows + ((size_t)w * cap + r0 + r4) * 4);
      }
    }
    if (tid < DT / 4) {
      const size_t o = base + r0 + 4 * tid;
      if (norms) cp_async16(st + off_norms + 16 * tid, norms + o);
      if (keep) cp_async16(st + off_keep + 16 * tid, keep + o);
      if (row_scale) cp_async16(st + off_rs + 16 * tid, row_scale + o);
    }
  };

  const int ntiles = (size + DT - 1) / DT;
  if (ntiles > 0) load_tile(0, ring);
  cp_async_commit();
#if RTT_STAGES < 2
  float keep_live = INFINITY;
#endif
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + 1 < ntiles) load_tile(t + 1, ring + ((t + 1) & 1) * sbytes);
    cp_async_commit();
    const unsigned char* st = ring + (t & 1) * sbytes;
    const int r0 = t * DT;

    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;
#if RTT_STAGES >= 1
#pragma unroll
    for (int s = 0; s < DKS; ++s) {
      if (s < KS) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t b0, b1;
          b_frag<ROWS>(st, cbase + 8 * j + gid, s, t4, nch, nw, b0, b1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][j], afr[mt][s], b0,
                                                   b1);
        }
      }
    }
#else
    // keep the query fragments live without the dots
    acc[0][0][0] = __uint_as_float(afr[0][0][0] & 0x7FFF7FFFu);
#endif

    // the epilogue, then the cascade four pairs at a time: a (column j,
    // m-tile) group's slots are read, cascaded and written together where
    // any of its newcomers beats its bin's last level. Under L2 the
    // epilogue is qa + xn - 2 dot as one fma (2 dot is exact, so it rounds
    // as epilogue_dist's subtraction does), a masked row or empty query
    // slot carrying +inf in xn or qa; the other metrics take epilogue_dist
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
        float dv[4];
        bool in[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // c = 2 h + e, as the accumulator
          const int h = c >> 1, e = c & 1;
          float dot = acc[mt][j][c];
          if constexpr (ROWS == kRowsBits) dot = __fmul_rn(dot, rs[e]);
          if constexpr (L2)
            dv[c] = fmaxf(__fmaf_rn(-2.f, dot,
                                    __fadd_rn(qa_l2[mt][h], xn[e])), 0.f);
          else
            dv[c] = (ok[e] && qv[mt][h])
                        ? epilogue_dist(dot, qa_r[mt][h], xn[e], plen[e],
                                        metric)
                        : INFINITY;
          in[c] = dv[c] < thr[((mt * 2 + h) * NT + j) * 2 + e];
        }
#if RTT_STAGES >= 2
        if (in[0] || in[1] || in[2] || in[3]) {
          float4 L[4];
          uint2 C[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (in[c]) {
              const int sl = slot_of(qbase + 16 * mt + gid + 8 * (c >> 1),
                                     cbase + 8 * j + 2 * t4 + (c & 1));
              L[c] = sd[sl];
              C[c] = sc[sl];
            }
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (in[c]) {
              const int h = c >> 1, e = c & 1;
              const int sl = slot_of(qbase + 16 * mt + gid + 8 * h,
                                     cbase + 8 * j + 2 * t4 + e);
              deep_cascade(L[c], C[c], dv[c], static_cast<uint32_t>(t));
              sd[sl] = L[c];
              sc[sl] = C[c];
              thr[((mt * 2 + h) * NT + j) * 2 + e] = L[c].w;
            }
        }
#else
#pragma unroll
        for (int c = 0; c < 4; ++c) keep_live = fminf(keep_live, dv[c]);
#endif
      }
    }
  }
#if RTT_STAGES < 2
  // the stage builds leave the bins out (the outputs are not results),
  // keeping the distances live
  sd[slot_of(qbase + gid, cbase + 2 * t4)].x = keep_live;
#endif
  __syncthreads();

  const int* ids = indices + base;
  for (int qq = warp; qq < DQ; qq += NWARPS) {
    const int g = g0 + qq;
    if (g >= G) continue;
    const size_t o = ((size_t)b * G + g) * k;
#if RTT_STAGES < 2
    if (lane == 0) out_d[o] = sd[slot_of(qq, 0)].x;
#else
    if (qidx[qq] < 0) {
      for (int jj = lane; jj < k; jj += 32) {
        out_d[o + jj] = INFINITY;
        out_i[o + jj] = -1;
      }
      continue;
    }
    extract_deep(sd, sc, qq, k, ids, out_d + o, out_i + o, lane);
#endif
  }
}

template <int ROWS, bool L2>
static int launch_as(const void* storage, const int* indices,
                     const int* list_sizes, const int* bucket_list,
                     const int* bucket_q, const float* queries,
                     const float* qaux, const float* norms, const int* keep,
                     const float* centers, float scale,
                     const float* scale_vec, const float* row_scale, int cap,
                     int d, int nw, int nb, int G, int k, int metric,
                     float* out_d, int* out_i, cudaStream_t stream) {
  const int n_sub = (G + DQ - 1) / DQ;
  const int n_sides = (norms != nullptr) + (keep != nullptr) +
                      (row_scale != nullptr);
  const size_t smem = deep_smem_bytes(ROWS, d, nw, n_sides);
  if (smem + STATIC_BYTES > (size_t)SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = ivf_deep_scan_kernel<ROWS, L2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<nb * n_sub, NTHREADS, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
      norms, keep, centers, scale, scale_vec, row_scale, cap, d, nw, G, k,
      n_sub, metric, out_d, out_i);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// storage kind 2 (int8 [C, cap, d]), 3 (i4) or 4 (sign bits) [C, nw,
// cap]; the rest as the C entry's. Returns a cudaError_t code.
static int launch(int storage_kind, const void* storage, const int* indices,
                  const int* list_sizes, const int* bucket_list,
                  const int* bucket_q, const float* queries,
                  const float* qaux, const float* norms, const int* keep,
                  const float* centers, float scale, const float* scale_vec,
                  const float* row_scale, int cap, int d, int nw, int nb,
                  int G, int k, int metric, int round_ops, float* out_d,
                  int* out_i, cudaStream_t stream) {
  const int rows = storage_kind == 2 ? kRowsDense
                                     : storage_kind == 3 ? kRowsI4 : kRowsBits;
  if (storage_kind < 2 || storage_kind > 4 || !round_ops || d > 128 ||
      (rows == kRowsDense && d % 16 != 0) ||
      (rows != kRowsBits && row_scale != nullptr) ||
      ksteps(rows, d, nw) > DKS)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(storage) || !aligned16(norms) || !aligned16(keep) ||
      !aligned16(row_scale))
    return (int)cudaErrorMisalignedAddress;
#define RTT_DEEP(R)                                                           \
  (metric == kL2                                                              \
       ? launch_as<R, true>(storage, indices, list_sizes, bucket_list,        \
                            bucket_q, queries, qaux, norms, keep, centers,    \
                            scale, scale_vec, row_scale, cap, d, nw, nb, G,   \
                            k, metric, out_d, out_i, stream)                  \
       : launch_as<R, false>(storage, indices, list_sizes, bucket_list,       \
                             bucket_q, queries, qaux, norms, keep, centers,   \
                             scale, scale_vec, row_scale, cap, d, nw, nb, G,  \
                             k, metric, out_d, out_i, stream))
  if (rows == kRowsDense) return RTT_DEEP(kRowsDense);
  if (rows == kRowsI4) return RTT_DEEP(kRowsI4);
  return RTT_DEEP(kRowsBits);
#undef RTT_DEEP
}

}  // namespace deep
}  // namespace rtt
