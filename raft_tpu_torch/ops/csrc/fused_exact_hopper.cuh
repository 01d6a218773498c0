// Kernel 1's exact arm redesigned for Hopper (ops/fused_topk.py:exact_body
// routes to it; entry fused_knn_exact_hopper in fused_knn_topk.cu).
//
// Replaces, for the launches it covers, fused_knn_topk_kernel<T, kExact>
// (the shared core's exact arm, scan_topk.cuh), which stays as it is for
// other widths, k over 64 and other operand types. It computes what the TPU
// kernel computes: raft_tpu/ops/fused_topk.py:_fused_kernel (:113) with
// _extract_exact (:61): for each query, the k smallest min-space distances
// over the rows (L2 max(||q||^2 + ||x||^2 - 2 q.x, 0), inner product -q.x,
// cosine 1 - q.x / max(||q|| ||x||, 1e-30), as the core's epilogue_dist),
// ties to the lower row, filtered-out rows and rows past the end skipped,
// (+inf, -1) where a chunk has fewer than k. A block keeps its queries' top
// k over one chunk of rows and writes them to columns [chunk k, chunk k +
// k) of the [m, n_chunks k] candidate buffer, which the caller merges.
//
// What held the core's exact arm back (PERF.md §6): 64 queries a block
// staged 64-row tiles by the threads behind block barriers (no copy
// overlapped the dots, and each row was read from L2 by every query tile),
// and the dots ran on the f32 CUDA cores with a 4 x 4 register micro tile,
// bf16 operands widened to f32. Here a block holds Q = 128 queries (64 for
// f32 rows where 128 do not fit, block_queries), staged once, and Q / 16
// warps, each owning 16 queries. 64-row tiles with their norms and keep
// flags come through a cp.async ring of as many stages as fit
// (ring_stages, 2 to 6), each stage guarded by a full and an empty
// mbarrier: every warp copies its share of the tile L (1 or 2) ahead and
// arrives on the full barrier when its copies land, waits only for its
// tile to land, and gives the stage back once it has read it. No block
// barrier stands between tiles, so warps drift apart by up to ns - L - 1
// tiles and one warp's burst of merges overlaps the others' dots (a
// single producer warp issuing every copy was slower: PERF.md). Two
// operand routes share the body:
//
// * bf16 operands (bf16 queries; bf16 rows as stored, f32 rows rounded to
//   bf16 as they are staged, as round_bf16 rounds them): the fold
//   body's layout and products (fused_fold_hopper.cuh): queries and rows
//   in wgmma's K-major core matrices, warpgroup g multiplies queries 64 g
//   .. 64 g + 63 by the tile's 64 rows, wgmma.m64n64k16 bf16 with f32
//   sums, d / 16 k-steps; a warp's quarter of the tile is its 16 queries.
//   Every product of two bf16 values is exact in f32, so only the order of
//   the sums differs from the plain version (and the tensor cores may
//   truncate a sum where it rounds).
// * f32 operands (f32 queries against f32 rows, or bf16 rows widened,
//   which are exact in TF32): 3xTF32 on the tensor cores. Each operand is
//   split as its fragment is built, hi = tf32(v) and lo = tf32(v - hi)
//   (cvt.rna), and a dot is lo.hi + hi.lo + hi.hi (lo.hi and hi.hi for
//   bf16 rows, whose lo is 0), mma.sync.m16n8k8 tf32 with f32 sums: ~22
//   bits of each product and no bf16 rounding anywhere. The tensor cores
//   truncate their f32 sums, which with non-negative rows (SIFT's) would
//   bias every dot low, so each 16-dim group's products go to fresh
//   accumulators that an f32 add (round to nearest) folds into the dot. A
//   warp covers its 16 queries x the tile's 64 rows (one m-tile x eight
//   n-tiles, eight independent accumulators a product step); lane t of a
//   fragment takes the group's dims 4 t .. 4 t + 3 (one float4), the
//   mma's k slots t and t + 4 of its two k-steps (any order of the dims is
//   one dot, A and B alike). Queries and rows stay f32 in shared memory,
//   row-major, a row's 16-byte chunk c at c ^ swizzle(row) (d a multiple
//   of 32; bf16 rows padded to a stride of 8 words mod 32), so that the
//   fragment loads meet no bank conflict. It was measured against
//   (PERF.md): design (b), the same tiles summed on the CUDA cores in dim
//   order from 4 x 8 register tiles; 32-row tiles with the
//   queries split once (hi in shared memory, lo in registers) and the rows
//   split once into hi and lo tiles through registers, or as fragments are
//   built; and 3xTF32 on wgmma m64n32k8. All were slower; the dots run at
//   ~410 m16n8k8 products a microsecond an SM, which bounds this route.
//
// Selection is the exact arm of the Hopper arms' body (ivf_scan_arms.cuh;
// its merges in topk_merge.cuh): each (query, row) distance strictly under
// the query's k-th distance as of the tile before is buffered (at most one
// a row: +inf and NaN never pass), then the owning warp merges its queries'
// candidates into their top-k lists in shared memory by (distance, row),
// taken into the warp's registers: a chunk's first tile sorted alone, a
// lone candidate inserted at its rank (insert_one), several one at a time
// into a list of k <= 32 (merge_list) and, for k > 32, a sort of list and
// candidates together where 16 or more come (warp_sort).
// The thresholds stay in the lanes' registers. Each (query, chunk) sees
// tens of thousands of rows, so after the first tiles few pass.
//
// Shared memory (smem_bytes): the queries (Q d 2 or 4 B), the stages of 64
// rows and their norms and keep flags, the buffer (Q x 64 of an f32
// distance and a row byte, Q counts) and the lists (Q k (f32, int32)): at
// d 128 and k 10, 185,856 B (bf16, 6 stages) and 217,088 B (f32, 3), one
// block an SM.
//
// Bound (PERF.md): operations, 2 d a (query, row) pair: f32 operands 3
// TF32 products at 495 TFLOP/s (3.82 ms at 67 TFLOP/s on the CUDA cores),
// bf16 ones at 989 TFLOP/s.
//
// RTT_STAGES: 0 = the ring loads and the epilogue; 1 = plus the dots; 2 =
// plus the selection (the whole kernel). With fewer than 2 the outputs are
// not results.
#pragma once

#include "fused_fold_hopper.cuh"
#include "topk_merge.cuh"

namespace rtt {
namespace exacth {

constexpr int ET = 64;              // rows a tile
constexpr int ENS = 6;              // ring stages at most (2 at least)
constexpr int EKA = 64;             // the largest k
constexpr int EDMAX = 128;          // the widest row
constexpr int SIDE = 2 * ET * 4;    // a stage's norms and keep (bytes)
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory (H100)
constexpr int WQ = 16;              // queries a warp owns
constexpr int STATIC_BYTES = 2 * ENS * 8;   // the ring's mbarriers

// bytes of one row in a ring stage: bf16 operands in core matrices; f32
// operands' f32 rows swizzled, bf16 rows padded to 8 words mod 32
__host__ __device__ inline int row_bytes(bool bf16_ops, bool x_bf16, int d) {
  if (bf16_ops) return 2 * d;
  if (x_bf16) return 2 * d + (d % 32 == 0 ? 32 : 0);
  return 4 * d;
}

// dynamic shared memory of a launch of q queries a block and ns stages
inline size_t smem_bytes(bool bf16_ops, bool x_bf16, int d, int k, int q,
                         int ns) {
  return (size_t)q * d * (bf16_ops ? 2 : 4) +
         (size_t)ns * (ET * row_bytes(bf16_ops, x_bf16, d) + SIDE) +
         (size_t)q * ET * 5 + (size_t)q * 4 + (size_t)q * k * 8;
}

// queries a block: 128 where that block fits with two stages, else 64
// (f32 rows under f32 operands at k > 57 and d 128)
inline int block_queries(bool bf16_ops, bool x_bf16, int d, int k) {
  return smem_bytes(bf16_ops, x_bf16, d, k, 128, 2) + STATIC_BYTES <=
                 (size_t)SMEM_LIMIT
             ? 128
             : 64;
}

// ring stages: as many as fit, up to ENS
inline int ring_stages(bool bf16_ops, bool x_bf16, int d, int k, int q) {
  int ns = ENS;
  while (ns > 2 && smem_bytes(bf16_ops, x_bf16, d, k, q, ns) +
                           STATIC_BYTES >
                       (size_t)SMEM_LIMIT)
    --ns;
  return ns;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}
// arrives on `bar` once the thread's cp.async so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 16-byte chunk of row r that chunk c of an f32 row lands in (d a
// multiple of 32): rows 2 i and 2 i + 1, which a fragment load's phase of
// 8 lanes reads, in opposite halves of the banks
__device__ __forceinline__ int swz(int r, int c, bool on) {
  return on ? c ^ ((r & 1) << 2) : c;
}

__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// c (+)= a (16 x 8 tf32, row) b (8 x 8 tf32, col), f32 sums; with ZERO,
// c = a b
template <bool ZERO = false>
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (ZERO)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.f));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [r0, r0 + rows) of an f32 [*, d] matrix into `dst` (shared address)
// for the f32 operands: row-major, chunk c of row r at swz(r, c); rows at
// or past `end` as zeros.
template <int NT>
__device__ __forceinline__ void load_f32(unsigned dst, const float* src,
                                         int r0, int rows, int end, int d,
                                         int tid) {
  const int nc = d >> 2;
  const bool sw = (d & 31) == 0;
  for (int e = tid; e < rows * nc; e += NT) {
    const int r = e / nc, c = e - r * nc;
    const bool ok = r0 + r < end;
    foldh::cp_async16(dst + (unsigned)(r * d * 4 + (swz(r, c, sw) << 4)),
                      src + (size_t)(ok ? r0 + r : r0) * d + 4 * c, ok);
  }
}

// Rows [r0, r0 + rows) of a bf16 [*, d] matrix into `dst` for the f32
// operands: row-major at a stride of row_bytes(false, true, d); rows at or
// past `end` as zeros.
template <int NT>
__device__ __forceinline__ void load_bf16(unsigned dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int end, int d, int tid) {
  const int nc = d >> 3, stride = row_bytes(false, true, d);
  for (int e = tid; e < rows * nc; e += NT) {
    const int r = e / nc, c = e - r * nc;
    const bool ok = r0 + r < end;
    foldh::cp_async16(dst + (unsigned)(r * stride + (c << 4)),
                      src + (size_t)(ok ? r0 + r : r0) * d + 8 * c, ok);
  }
}

// A tile's norms and keep flags (ET each from row r0, zeros past `end`)
// into `dst`: lanes 0-15 the norms, 16-31 the flags, 16 bytes each.
__device__ __forceinline__ void load_side(unsigned dst,
                                          const float* __restrict__ norms,
                                          const int* __restrict__ keep,
                                          int r0, int end, int lane) {
  const int half = lane >> 4;
  const void* src = half == 0 ? static_cast<const void*>(norms)
                              : static_cast<const void*>(keep);
  if (src == nullptr) return;
  const int r = r0 + 4 * (lane & 15);
  const int bytes = max(0, min(16, 4 * (end - r)));
  const char* from = static_cast<const char*>(src) +
                     (size_t)(bytes > 0 ? r : r0) * 4;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   dst + (unsigned)(half * ET * 4 + 16 * (lane & 15))),
               "l"(from), "r"(bytes));
}

// four dims of row r (f32 rows: chunk c of the swizzled layout; bf16 rows:
// dims 4 c .. 4 c + 3 of the padded layout, widened exactly)
template <typename T>
__device__ __forceinline__ float4 row4(const unsigned char* base, int r,
                                       int c, int d) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(
        base + r * d * 4 + (swz(r, c, (d & 31) == 0) << 4));
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(
        base + r * row_bytes(false, true, d) + 8 * c);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xFFFF0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xFFFF0000u));
  }
}

// A warp's 16 queries x the tile's 64 rows, 32 accumulators a lane:
// element 4 j + 2 h + e is query qb + gid + 8 h, row 8 j + 2 t4 + e, the
// layout of the mma tiles and of wgmma m64n64's warp quarter alike.
__host__ __device__ constexpr int acc_at(int h, int ri) {
  return 4 * (ri >> 1) + 2 * h + (ri & 1);
}

// The f32 operands' dots of one tile into acc.
template <typename T>
__device__ __forceinline__ void dots_f32(float (&acc)[32],
                                         const unsigned char* qs,
                                         const unsigned char* st, int d,
                                         int qb, int gid, int t4) {
  constexpr bool XBF = std::is_same<T, __nv_bfloat16>::value;
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int g = 0; g < d / 16; ++g) {
    const int c = 4 * g + t4;
    // A: rows gid and gid + 8, split; element e of a float4 is k-step e /
    // 2's slot t4 (e even) or t4 + 4 (e odd): a0 (gid, t4), a1 (gid + 8,
    // t4), a2 (gid, t4 + 4), a3 (gid + 8, t4 + 4)
    const float4 v0 = row4<float>(qs, qb + gid, c, d);
    const float4 v1 = row4<float>(qs, qb + gid + 8, c, d);
    const float fa[2][4] = {{v0.x, v1.x, v0.y, v1.y},
                            {v0.z, v1.z, v0.w, v1.w}};
    uint32_t ah[2][4], al[2][4];   // [k-step][fragment register]
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ah[s][r] = tf32(fa[s][r]);
        al[s][r] = tf32(__fsub_rn(fa[s][r], __uint_as_float(ah[s][r])));
      }
    // B: n-tile j's row 8 j + gid, split (b0, b1 of k-step s at 2 s, 2 s +
    // 1)
    uint32_t bh[8][4], bl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = row4<T>(st, 8 * j + gid, c, d);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        bh[j][r] = XBF ? __float_as_uint(e[r]) : tf32(e[r]);
        bl[j][r] = XBF ? 0u : tf32(__fsub_rn(e[r], __uint_as_float(bh[j][r])));
      }
    }
    // the group's products into fresh accumulators, eight independent
    // n-tiles a step, the small products first, then added to the dot at
    // round to nearest
    float tmp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_tf32<true>(tmp[j], al[0], bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mma_tf32(tmp[j], al[1], bh[j][2], bh[j][3]);
    if constexpr (!XBF) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_tf32(tmp[j], ah[s], bl[j][2 * s], bl[j][2 * s + 1]);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma_tf32(tmp[j], ah[s], bh[j][2 * s], bh[j][2 * s + 1]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[4 * j + r] = __fadd_rn(acc[4 * j + r], tmp[j][r]);
  }
}

// One candidate (cd, cp) into query qq's list of k (<= 32 LP; entry j at
// qq k + j in sld / slp, sorted by (distance, position)), which it enters
// (it is under the list's k-th): the entries from its rank on move up one,
// and only they are written. Returns the list's new k-th distance. The
// merges' common case past a chunk's first tiles, in one ballot and one
// shuffle step where merge_list takes a chain of them.
template <int LP>
__device__ __forceinline__ float insert_one(float* sld, int* slp, int qq,
                                            int k, float cd, int cp,
                                            int lane) {
  float ld[LP], ud[LP], td[LP];
  int lp[LP], up[LP], tp[LP];
  int at = 0;
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int j = 32 * s + lane;
    ld[s] = j < k ? sld[qq * k + j] : INFINITY;
    lp[s] = j < k ? slp[qq * k + j] : INT_MAX;
    at += __popc(__ballot_sync(0xffffffffu, arms::before(ld[s], lp[s], cd,
                                                         cp)));
    ud[s] = __shfl_up_sync(0xffffffffu, ld[s], 1);
    up[s] = __shfl_up_sync(0xffffffffu, lp[s], 1);
    td[s] = __shfl_sync(0xffffffffu, ld[s], 31);
    tp[s] = __shfl_sync(0xffffffffu, lp[s], 31);
  }
  float kth = 0.f;
#pragma unroll
  for (int s = 0; s < LP; ++s) {
    const int j = 32 * s + lane;
    if (j < k && j >= at) {
      // the entry before j: lane - 1 of register s, or lane 31 of s - 1
      const int ps = s > 0 ? s - 1 : 0;
      const float nd = j == at ? cd : lane > 0 ? ud[s] : td[ps];
      const int np = j == at ? cp : lane > 0 ? up[s] : tp[ps];
      sld[qq * k + j] = nd;
      slp[qq * k + j] = np;
      if (j == k - 1) kth = nd;
    }
  }
  return __shfl_sync(0xffffffffu, kth, (k - 1) & 31);
}

// queries [m, d] (bf16 under bf16 operands, else f32); qaux [m] (null for
// IP); x [n, d] T; norms [n] (null for IP); keep [n] or null. Block (query
// tile qt, chunk ch): blockIdx.x = ch n_qtiles + qt; ns ring stages. Each
// of the Q / 16 warps owns 16 queries.
template <bool BF, typename T, bool L2, int Q>
__global__ void __launch_bounds__(2 * Q, 1)
fused_exact_hopper_kernel(const void* __restrict__ queries,
                          const float* __restrict__ qaux,
                          const T* __restrict__ x,
                          const float* __restrict__ norms,
                          const int* __restrict__ keep, int m, int n, int d,
                          int k, int chunk_rows, int n_chunks, int n_qtiles,
                          int metric, int ns, float* __restrict__ out_d,
                          int* __restrict__ out_i) {
  constexpr int NT = 2 * Q, NW = NT / 32;
  constexpr bool XBF = std::is_same<T, __nv_bfloat16>::value;
  __shared__ uint64_t full[ENS], empty[ENS];
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, t4 = lane & 3;
  const int qt = blockIdx.x % n_qtiles;
  const int ch = blockIdx.x / n_qtiles;
  const int q0 = qt * Q;
  const int p_begin = ch * chunk_rows;
  const int p_end = min(n, p_begin + chunk_rows);
  const int ntiles = (p_end - p_begin + ET - 1) / ET;

  const int rbytes = row_bytes(BF, XBF, d);
  const int sbytes = ET * rbytes + SIDE;
  unsigned char* ring = smem + (size_t)Q * d * (BF ? 2 : 4);
  unsigned char* arm = ring + ns * sbytes;
  float* cbd = reinterpret_cast<float*>(arm);
  unsigned char* cbr = arm + Q * ET * 4;
  int* ccnt = reinterpret_cast<int*>(arm + Q * ET * 5);
  float* sld = reinterpret_cast<float*>(ccnt + Q);
  int* slp = reinterpret_cast<int*>(sld + Q * k);
  const unsigned qs_a = smem_addr(smem);
  const unsigned ring_a = smem_addr(ring);

  // the queries, by every thread; the lists, counts and ring barriers
  if constexpr (BF)
    foldh::load_rows<__nv_bfloat16, NT>(
        qs_a, static_cast<const __nv_bfloat16*>(queries), q0, Q, m, d, tid);
  else
    load_f32<NT>(qs_a, static_cast<const float*>(queries), q0, Q, m, d, tid);
  foldh::cp_async_commit();
  for (int i = tid; i < Q * k; i += NT) {
    sld[i] = INFINITY;
    slp[i] = -1;
  }
  if (tid < Q) ccnt[tid] = 0;
  if (tid == 0)
    for (int s = 0; s < ns; ++s) {
      mbar_init(&full[s], NT);
      mbar_init(&empty[s], NW);
    }
  foldh::cp_async_wait<0>();
  fence_async();
  __syncthreads();

  // Tile tt goes into stage tt % ns, a share of it by each thread, which
  // then arrives on the stage's full barrier once its copies have landed;
  // a warp issues its share of tile t + L while it works on tile t, once
  // every warp has let go of tile t + L - ns there. So a warp may run up
  // to ns - L - 1 tiles ahead of the slowest.
  const int L = ns >= 5 ? 2 : 1;
  auto issue = [&](int tt) {
    const int s = tt % ns;
    if (tt >= ns) mbar_wait(&empty[s], ((tt / ns) - 1) & 1);
    const unsigned st = ring_a + (unsigned)(s * sbytes);
    const int r0 = p_begin + tt * ET;
    if constexpr (BF)
      foldh::load_rows<T, NT>(st, x, r0, ET, p_end, d, tid);
    else if constexpr (XBF)
      load_bf16<NT>(st, x, r0, ET, p_end, d, tid);
    else
      load_f32<NT>(st, x, r0, ET, p_end, d, tid);
    if (warp == 0)
      load_side(st + (unsigned)(ET * rbytes), norms, keep, r0, p_end, lane);
    fence_async();   // the f32 rows rounded and stored by the thread
    cp_async_arrive(&full[s]);
  };
  for (int tt = 0; tt < L && tt < ntiles; ++tt) issue(tt);

  {
    // the warp's queries qb .. qb + 15, the lane's qb + gid and + 8
    const int qb = WQ * warp;
    float qa[2], qa_l2[2], thr[2] = {INFINITY, INFINITY};
    bool qv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + qb + gid + 8 * h;
      qv[h] = q < m;
      qa[h] = (qv[h] && metric != kIP) ? qaux[q] : 0.f;
      qa_l2[h] = qv[h] ? qa[h] : INFINITY;
    }
#if RTT_STAGES < 2
    float keep_live = INFINITY;
#endif
    for (int t = 0; t < ntiles; ++t) {
      if (t + L < ntiles) issue(t + L);
      const int s = t % ns;
      mbar_wait(&full[s], (t / ns) & 1);
      fence_async();   // cp.async and thread stores reach wgmma
      const unsigned char* st = ring + s * sbytes;
      const int r0 = p_begin + t * ET;

      float acc[32];
#if RTT_STAGES >= 1
      if constexpr (BF) {
        const unsigned sbo = (unsigned)(d * 16);   // 8 rows of d bf16
        const unsigned a0 = qs_a + (unsigned)(8 * (warp >> 2)) * sbo;
        const unsigned b0 = ring_a + (unsigned)(s * sbytes);
        foldh::wg_fence();
        for (int ks = 0; ks < d / 16; ++ks)
          foldh::wgmma_m64n64k16(
              acc, foldh::kmajor_desc(a0 + (unsigned)(ks * 256), sbo),
              foldh::kmajor_desc(b0 + (unsigned)(ks * 256), sbo), ks > 0);
        foldh::wg_commit();
        foldh::wg_wait0();
      } else {
        dots_f32<T>(acc, smem, st, d, qb, gid, t4);
      }
#else
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      // keep the tile's loads live without the dots
      acc[0] = __uint_as_float(
          *reinterpret_cast<const uint32_t*>(st + lane * 4) & 0x7FFF7FFFu);
#endif

      const float* snorm = reinterpret_cast<const float*>(st + ET * rbytes);
      const int* skeep =
          reinterpret_cast<const int*>(st + ET * rbytes + ET * 4);
#pragma unroll
      for (int ri = 0; ri < 16; ++ri) {
        const int row = 8 * (ri >> 1) + 2 * t4 + (ri & 1);
        const bool ok =
            r0 + row < p_end && (keep == nullptr || skeep[row] > 0);
        float xn, plen = 0.f;
        if constexpr (L2) {
          xn = ok ? snorm[row] : INFINITY;
        } else {
          xn = (ok && metric != kIP) ? snorm[row] : 0.f;
          if (metric == kCosine) plen = sqrtf(fmaxf(xn, 1e-30f));
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dot = acc[acc_at(h, ri)];
          float dv;
          if constexpr (L2) {
            // +inf where the row or the query is out (a NaN or inf row's
            // dot cannot pass the strict test below either)
            dv = fmaxf(__fmaf_rn(-2.f, dot, __fadd_rn(qa_l2[h], xn)), 0.f);
          } else {
            dv = (ok && qv[h]) ? epilogue_dist(dot, qa[h], xn, plen, metric)
                               : INFINITY;
          }
#if RTT_STAGES >= 2
          // strict: +inf (a masked row, a query past m) never enters, so a
          // query buffers at most the tile's ET rows
          if (dv < thr[h] && (!L2 || (ok && qv[h]))) {
            const int q = qb + gid + 8 * h;
            const int at = atomicAdd(&ccnt[q], 1);
            cbd[q * ET + at] = dv;
            cbr[q * ET + at] = static_cast<unsigned char>(row);
          }
#else
          keep_live = fminf(keep_live, fminf(dv, thr[h]));
#endif
        }
      }
      // the stage is free once every lane has read it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#if RTT_STAGES >= 2
      // the warp's queries with candidates, one at a time: a chunk's first
      // tile sorted alone (the list is empty); then a lone candidate
      // inserted at its rank (insert_one); several one at a time into a
      // list of k <= 32 (a register a lane), and into one of k > 32 (two)
      // a few at a time or else sorted in with it
      const int cnt = lane < WQ ? ccnt[qb + lane] : 0;
      unsigned todo = __ballot_sync(0xffffffffu, cnt > 0);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1;
        const int qq = qb + i;
        const int nc = __shfl_sync(0xffffffffu, cnt, i);
        const float cd = cbd[qq * ET];
        const int cp = r0 + cbr[qq * ET];
        const float kd =
            t == 0 ? arms::sort_query<2, false, ET>(sld, slp, cbd, cbr, qq,
                                                    nc, r0, k, lane)
            : nc == 1 ? (k <= 32 ? insert_one<1>(sld, slp, qq, k, cd, cp, lane)
                                 : insert_one<2>(sld, slp, qq, k, cd, cp,
                                                 lane))
            : k <= 32
                ? arms::merge_query<1, ET>(sld, slp, cbd, cbr, qq, nc, r0, k,
                                           lane)
            : nc < arms::SORT_MIN
                ? arms::merge_query<2, ET>(sld, slp, cbd, cbr, qq, nc, r0, k,
                                           lane)
                : arms::sort_query<4, true, ET>(sld, slp, cbd, cbr, qq, nc,
                                                r0, k, lane);
        if (i == gid) thr[0] = kd;
        if (i == gid + 8) thr[1] = kd;
      }
      __syncwarp();
      if (lane < WQ) ccnt[qb + lane] = 0;
      __syncwarp();
#endif
    }
#if RTT_STAGES < 2
    if (keep_live == -1.f) sld[0] = keep_live;
#endif
  }

  __syncthreads();   // every warp's last merges are done
  const size_t width = (size_t)n_chunks * k;
  for (int e = tid; e < Q * k; e += NT) {
    const int q = q0 + e / k;
    if (q >= m) continue;
    const size_t o = (size_t)q * width + (size_t)ch * k + e % k;
    const float dv = sld[e];
    out_d[o] = dv;
    out_i[o] = isinf(dv) ? -1 : slp[e];
  }
}

template <bool BF, typename T, bool L2, int Q>
static int launch_as(const void* queries, const float* qaux, const T* x,
                     const float* norms, const int* keep, int m, int n, int d,
                     int k, int chunk_rows, int n_chunks, int metric, int ns,
                     float* out_d, int* out_i, cudaStream_t stream) {
  const int n_qtiles = (m + Q - 1) / Q;
  const size_t smem =
      smem_bytes(BF, std::is_same<T, __nv_bfloat16>::value, d, k, Q, ns);
  auto kernel = fused_exact_hopper_kernel<BF, T, L2, Q>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<n_qtiles * n_chunks, 2 * Q, smem, stream>>>(
      queries, qaux, x, norms, keep, m, n, d, k, chunk_rows, n_chunks,
      n_qtiles, metric, ns, out_d, out_i);
  return (int)cudaGetLastError();
}

// The instantiations: bf16 operands at 128 queries over f32 or bf16 rows;
// f32 operands over bf16 rows at 128 and over f32 rows at 128 or 64
// (block_queries); L2 or not.
template <bool BF, typename T>
static int launch_q(int q, const void* queries, const float* qaux,
                    const T* x, const float* norms, const int* keep, int m,
                    int n, int d, int k, int chunk_rows, int n_chunks,
                    int metric, int ns, float* out_d, int* out_i,
                    cudaStream_t stream) {
#define RTT_EXACT_Q(Q)                                                        \
  (metric == kL2                                                              \
       ? launch_as<BF, T, true, Q>(queries, qaux, x, norms, keep, m, n, d, k, \
                                   chunk_rows, n_chunks, metric, ns, out_d,   \
                                   out_i, stream)                             \
       : launch_as<BF, T, false, Q>(queries, qaux, x, norms, keep, m, n, d,   \
                                    k, chunk_rows, n_chunks, metric, ns,      \
                                    out_d, out_i, stream))
  if constexpr (!BF && std::is_same<T, float>::value)
    if (q == 64) return RTT_EXACT_Q(64);
  return RTT_EXACT_Q(128);
#undef RTT_EXACT_Q
}

}  // namespace exacth
}  // namespace rtt
