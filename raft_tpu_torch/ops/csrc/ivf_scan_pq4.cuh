// Kernel 2's pq4 arm redesigned for Hopper (extract codes kPq4Hopper + 0,
// 1, 2: the exact, binned and binned_deep arms; ops/ivf_scan.py:pq4_body
// routes to it).
//
// Replaces, for the launches it covers, ivf_pq4_scan_topk_kernel
// (ivf_list_scan_topk.cu), which stays as it is for f32 operands, the
// fold arms and tables past this body's shared memory. It computes what
// the TPU kernel computes: raft_tpu/ops/ivf_scan.py:_scan_kernel's
// packed_pq4 branch (:221-255), 4-bit PQ codes scored against a table per
// (query, subspace), dots[q, x] = sum over s of lut[q, s, code(x, s)],
// as a 16-pass one-hot contraction on the tensor cores, then the L2 or
// inner-product epilogue and the exact (top-k, ties to the lower
// position), binned (:89) or binned_deep (:123) extraction with the
// stored ids, the keep filter, and (+inf, -1) for empty query slots, list
// tails and padding buckets.
//
// Covers bf16 operands (round_ops), L2 and inner product, residual
// (centers) or plain queries, any p and pq_len whose block fits
// (smem_bytes). The table entries are built as the core's pq4 kernel
// builds them: lut[q][s][v] = sum over l < pq_len (in order) of the staged
// bf16 query component s pq_len + l times the bf16 codebook entry
// pq_centers[s][v][l], each product and sum rounded once, the entry
// rounded to bf16 (where the reference casts qv, its codebook weights and
// lut_v).
//
// What held the core's pq4 kernel back (PERF.md): one 4-byte shared load
// and one f32 add per (query, row, subspace), 16 queries a block (its f32
// tables take 96 KB at p = 96), so each bucket streamed its list 16
// times, and two block barriers per 64-row tile. Here:
//
// * The dots are warpgroup products, wgmma.m64n32k16 bf16 with f32
//   accumulation, one k-step a subspace, its K = 16 the code values: A
//   is the one-hot codes of 64 rows (A[x][v] = code(x, s) == v), built in
//   registers: each lane's code as the bf16 128 + code in both halves of
//   a word (one byte permute), compared with the lane's two value pairs
//   by set.eq.bf16x2 (1.0 where equal, else 0.0); B is the table of the
//   block's 32 queries for subspace s, read from shared memory by its
//   descriptor. Each step adds exactly one table entry to each (row,
//   query), in subspace order, as the plain version does; only the
//   tensor cores' f32 accumulation (truncating where the plain version
//   rounds to nearest) differs, so the result is bit for bit the plain
//   version's where every partial sum is exact in f32 (small-integer
//   tables) and within p steps of 2 ulps of the table's running sum
//   elsewhere (chip_smoke.py:pq4_atol). The products of GSUB subspaces go
//   out as one group while the next group's fragments are built in a
//   second register buffer. mma.sync.m16n8k16 with the tables as
//   ldmatrix A fragments and the same one-hot B took 8-19% longer a scan
//   (PERF.md).
// * A block holds 32 queries: the bf16 tables take 32 p 32 B (98,304 B at
//   p = 96), built once a block, and each bucket reads its list at most 8
//   times (256-query buckets). Tiles are 256 rows (two 128-row chunks);
//   warpgroup g takes the rows of bins 64 g .. 64 g + 63 of both chunks
//   (one 64-row product each), its warp w rows 16 w .. 16 w + 15 of
//   those: a lane owns 2 bins x 8 queries (columns 2 t, 2 t + 1 of the
//   accumulator's four 8-query tiles), the same 16 (query, bin) pairs on
//   every tile.
// * Table entries of subspace s sit in wgmma's K-major core matrices
//   without swizzle: (query q, value v) at s 1024 + (v / 8) 512 + (q / 8)
//   128 + (q % 8) 16 + (v % 8) 2.
// * Codes come through a 2-stage cp.async ring as stored (word w of 256
//   rows, 16 bytes a copy where cap is a multiple of 4, else 4), with each
//   tile's norms and keep; a tile is loaded while the warps work on the
//   one before, behind one block barrier a tile.
// * Selection, by arm: binned_deep as ivf_scan_deep.cuh (each (query,
//   bin) owned by one lane across the tiles, the strict-`<` cascade from
//   registers into its slots, four pairs at a time, the last levels in
//   registers, then one bitonic sort of each query's 512 slots), its
//   slots swizzled for this body's lanes (wslot); binned keeps its one
//   slot a (query, bin) in the owner's registers and writes them out
//   once for extract_bins; exact at k <= 32 buffers each query's
//   candidates under its k-th distance of the tile before, and after a
//   second barrier warp w merges queries w, w + 8, ... into top-k lists
//   held in its registers (merge_reg); exact at k > 32 writes the tile's
//   distances to shared memory and folds them with the shared core's
//   fold_candidates.
//
// Shared memory (dynamic, smem_bytes): the tables, HNS ring stages of
// (ceil(p / 8) code words + one word for each side array) x 256 rows,
// then the arm's region: exact at k <= 32 32 x 256 (f32, int) candidates
// + 32 counts and thresholds; at k > 32 32 x 260 f32 of distances + 32 k
// (f32, int) lists; binned 32 x 128 slots of 6 B; binned_deep 32 x 128 x
// 24 B. At p = 96 with norms and keep: 98,304 + 28,672 + 98,304
// (binned_deep) = 225,280 B, beside 256 B of query ids and qaux, within
// the 232,448 B a block may use; so one block an SM, 8 warps.
//
// Bound (PERF.md): operations, p table entries added per valid (query,
// row) pair: as f32 adds on the CUDA cores, one a lane a clock (half the
// 67 TFLOP/s counted for an FMA); the one-hot contraction on the tensor
// cores does 2 x 16 p operations a pair at 989 TFLOP/s, about as long.
// The list bytes are far below either.
//
// RTT_STAGES: 0 = the tables, the ring loads and the epilogue; 1 = plus
// the one-hot fragments and the dots; 2 = plus the selection and the
// extraction (the whole kernel). With fewer than 2 the outputs are not
// results.
#pragma once

#include "ivf_scan_deep.cuh"
#include "scan_topk.cuh"

namespace rtt {
namespace pq4h {

constexpr int kPq4Hopper = 7;   // the C entry's extract code of the exact
                                // arm; binned 8, binned_deep 9
constexpr int HQ = 32;          // queries a block
constexpr int HT = 2 * NBINS;   // rows a tile: two chunks (256)
constexpr int HNS = 2;          // ring stages
constexpr int DIST_LD = HT + 4; // floats a query's row of the exact arm's
                                // distance tile (a warp's stores of 8
                                // rows x 4 queries over all banks)
constexpr int GSUB = 4;         // subspaces a group of warpgroup products
constexpr int STATIC_BYTES = HQ * 8;   // qidx, qa

__host__ __device__ inline bool is_code(int extract) {
  return extract >= kPq4Hopper && extract <= kPq4Hopper + kBinnedDeep;
}

// code words a row: the words that hold the p codes
__host__ __device__ inline int words_of(int p) { return (p + 7) / 8; }

// bytes of one ring stage: the tile's code words, then 256 floats or ints
// for each side array present (norms, keep)
__host__ __device__ inline int stage_bytes(int p, int n_sides) {
  return (words_of(p) + n_sides) * HT * 4;
}

// dynamic shared memory of a launch (tables + ring + the arm's region)
inline size_t smem_bytes(int p, int k, int extract, int n_sides) {
  const size_t arm =
      extract == kExact
          ? (k <= 32 ? (size_t)HQ * HT * 8 + HQ * 8
                     : (size_t)HQ * DIST_LD * 4 + (size_t)HQ * k * 8)
      : extract == kBinned ? (size_t)HQ * NBINS * 6
                           : (size_t)HQ * NBINS * 24;
  return (size_t)HQ * p * 32 + (size_t)HNS * stage_bytes(p, n_sides) + arm;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// 1.0 in each bf16 half of a where it equals b's half, else 0.0
// (set.eq.bf16x2 on sm_90)
__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __heq2(*reinterpret_cast<const __nv_bfloat162*>(&a),
             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// wgmma helpers: fences and groups of the asynchronous warpgroup products
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The shared-memory descriptor of one subspace's table as wgmma's B
// operand (16 values x 32 queries, K-major, no swizzle): core matrices of
// 8 queries x 8 values (16-byte rows), the two value halves 512 B apart
// (leading byte offset), the four query octets 128 B apart (stride byte
// offset); fields in units of 16 B.
__device__ __forceinline__ uint64_t table_desc(unsigned addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(512 >> 4) << 16) |
         (static_cast<uint64_t>(128 >> 4) << 32);
}

// D[64 rows x 32 queries] (f32, registers) += A[64 x 16] (the warpgroup's
// one-hot codes, bf16 registers) x B[16 x 32] (the table, shared)
__device__ __forceinline__ void wgmma_m64n32k16(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, "
      "{%16,%17,%18,%19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// slot of (block query q, bin b) in the binned_deep slots: the bin
// XOR-swizzled by bits 1-2 of the query, so that a quarter warp's float4
// accesses (2 rows x 4 query pairs) spread over the banks
__device__ __forceinline__ int wslot(int q, int b) {
  return q * NBINS + (b ^ (q & 6));
}

// deep::extract_deep over wslot's layout (ivf_scan_deep.cuh's slots stay
// as they are, so the Hopper binned_deep body keeps its code)
__device__ void extract_wdeep(const float4* sd, const uint2* sc, int q, int k,
                              const int* __restrict__ ids, float* od,
                              int* oi, int lane) {
  constexpr int S = 16;
  float v[S];
  uint32_t key[S];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = lane + 32 * i;
    const float4 L = sd[wslot(q, b)];
    const uint2 C = sc[wslot(q, b)];
    const float lv[4] = {L.x, L.y, L.z, L.w};
    const uint32_t ch[4] = {C.x & 0xFFFFu, C.x >> 16, C.y & 0xFFFFu,
                            C.y >> 16};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[4 * i + r] = lv[r];
      key[4 * i + r] = (static_cast<uint32_t>(b * 4 + r) << 16) | ch[r];
    }
  }
#pragma unroll
  for (int size = 2; size <= 32 * S; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= S) {
        const int ls = stride / S;
        const bool lower = (lane & ls) == 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const bool up = ((S * lane + j) & size) == 0;
          const float pv = __shfl_xor_sync(0xffffffffu, v[j], ls);
          const uint32_t pk = __shfl_xor_sync(0xffffffffu, key[j], ls);
          if (deep::deep_less(pv, pk, v[j], key[j]) == (lower == up)) {
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
            if (deep::deep_less(v[j2], key[j2], v[j], key[j]) == up) {
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
                  : ids[static_cast<int>(key[j] & 0xFFFFu) * NBINS +
                        static_cast<int>(key[j] >> 18)];
    }
  }
}

// Merges 32 buffered candidates (cd, cp), one a lane (+inf where none),
// into a query's sorted top-k (k <= 32) held by one warp in registers,
// entry j in lane j, in any order: by (distance, position), so equal
// distances keep the lower position whatever the arrival order.
__device__ __forceinline__ void merge_reg(float& ld, int& lp, int k, float cd,
                                          int cp, int lane) {
  float kd = __shfl_sync(0xffffffffu, ld, k - 1);
  int kp = __shfl_sync(0xffffffffu, lp, k - 1);
  unsigned mask =
      __ballot_sync(0xffffffffu, cd < kd || (cd == kd && cp < kp));
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float vd = __shfl_sync(0xffffffffu, cd, src);
    const int vp = __shfl_sync(0xffffffffu, cp, src);
    const int at = __popc(
        __ballot_sync(0xffffffffu, ld < vd || (ld == vd && lp < vp)));
    const float ud = __shfl_up_sync(0xffffffffu, ld, 1);
    const int up = __shfl_up_sync(0xffffffffu, lp, 1);
    if (lane == at) {
      ld = vd;
      lp = vp;
    } else if (lane > at) {
      ld = ud;
      lp = up;
    }
    kd = __shfl_sync(0xffffffffu, ld, k - 1);
    kp = __shfl_sync(0xffffffffu, lp, k - 1);
    mask &= ~(1u << src);
    mask &= __ballot_sync(0xffffffffu, cd < kd || (cd == kd && cp < kp));
  }
}

// One block per (bucket, 32-query sub-tile), sub-tiles fastest;
// arguments as ivf_pq4_scan_topk_kernel's.
template <int EXTRACT>
__global__ void __launch_bounds__(NTHREADS, 1)
ivf_pq4_hopper_kernel(const uint32_t* __restrict__ storage,
                      const int* __restrict__ indices,
                      const int* __restrict__ list_sizes,
                      const int* __restrict__ bucket_list,
                      const int* __restrict__ bucket_q,
                      const float* __restrict__ queries,
                      const float* __restrict__ norms,
                      const int* __restrict__ keep,
                      const float* __restrict__ centers,
                      const float* __restrict__ pq_centers, int cap, int nw,
                      int p, int pl, int G, int k, int n_sub, int metric,
                      float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int NP = 16;           // (query, bin) pairs a lane
  __shared__ int qidx[HQ];
  __shared__ float qas[HQ];
  extern __shared__ __align__(128) unsigned char dyn[];
  const int nwp = words_of(p);
  const int n_sides = (norms != nullptr) + (keep != nullptr);
  const int sbytes = stage_bytes(p, n_sides);
  unsigned char* table = dyn;
  unsigned char* ring = dyn + (size_t)HQ * p * 32;
  unsigned char* arm = ring + HNS * sbytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int t4 = lane & 3;
  const int wg = warp >> 2;        // warpgroup: bins 64 wg .. 64 wg + 63
  const int wq = warp & 3;         // its warp: rows 16 wq .. + 15 of those
  const int d = p * pl;

  const int b = blockIdx.x / n_sub;
  const int g0 = (blockIdx.x % n_sub) * HQ;
  const int l = bucket_list[b];
  int any = 0;
  if (tid < HQ) {
    const int g = g0 + tid;
    const int q = g < G ? bucket_q[(size_t)b * G + g] : -1;
    qidx[tid] = q;
    any = q >= 0;
  }
  const int size = __syncthreads_or(any) ? list_sizes[l] : 0;
  const size_t base = (size_t)l * cap;
  const float* center = centers ? centers + (size_t)l * d : nullptr;
  if (tid < HQ) {
    const int q = qidx[tid];
    float qa = 0.f;
    if (q >= 0 && metric != kIP) {
      const float* qr = queries + (size_t)q * d;
      for (int c = 0; c < d; ++c) {
        const float r = __fsub_rn(qr[c], center[c]);
        qa = __fadd_rn(qa, __fmul_rn(r, r));
      }
    }
    qas[tid] = qa;
  }

  // the tables: (query q, value v) of subspace s at s 1024 + (v / 8) 512
  // + (q / 8) 128 + (q % 8) 16 + (v % 8) 2 (wgmma's K-major core
  // matrices)
  if (size > 0) {
    for (int e = tid; e < HQ * p; e += NTHREADS) {
      const int q = e % HQ, s = e / HQ;
      const int gq = qidx[q];
      float acc[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) acc[v] = 0.f;
      if (gq >= 0) {
        for (int j = 0; j < pl; ++j) {
          const int c = s * pl + j;
          const float qv =
              stage_query(queries[(size_t)gq * d + c], center, c, 1.f, true);
          const float* wv = pq_centers + (size_t)s * 16 * pl + j;
#pragma unroll
          for (int v = 0; v < 16; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(qv, round_bf16(wv[v * pl])));
        }
      }
      uint32_t pk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pk[i] = deep::bf16_bits(acc[2 * i]) |
                (deep::bf16_bits(acc[2 * i + 1]) << 16);
      unsigned char* cm = table + (size_t)s * 1024 + (q >> 3) * 128 +
                          (q & 7) * 16;
      *reinterpret_cast<uint4*>(cm) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      *reinterpret_cast<uint4*>(cm + 512) =
          make_uint4(pk[4], pk[5], pk[6], pk[7]);
    }
  }
  // the tables are read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  float* dtile = reinterpret_cast<float*>(arm);            // exact
  float* topd = dtile + HQ * DIST_LD;
  int* topp = reinterpret_cast<int*>(topd + HQ * k);
  float4* sd = reinterpret_cast<float4*>(arm);             // binned_deep
  uint2* sc = reinterpret_cast<uint2*>(arm + HQ * NBINS * 16);
  float* bsd = reinterpret_cast<float*>(arm);              // binned
  uint16_t* bsc = reinterpret_cast<uint16_t*>(arm + HQ * NBINS * 4);
  // pair i = (h 4 + j) 2 + e: query 8 j + 2 t + e, bin 64 wg + 16 wq +
  // gid + 8 h
  float thr[NP];
  uint32_t bch[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    thr[i] = INFINITY;
    bch[i] = 0u;
  }
  const bool reg = k <= 32;
  float rld[HQ / NWARPS];
  int rlp[HQ / NWARPS];
#pragma unroll
  for (int i = 0; i < HQ / NWARPS; ++i) {
    rld[i] = INFINITY;
    rlp[i] = -1;
  }
  const int bin0 = 64 * wg + 16 * wq + gid;
  // exact, k <= 32: each query's candidates under its k-th distance of
  // the tile before, buffered (at most one a row), with their count and
  // that threshold
  float* cbd = reinterpret_cast<float*>(arm);
  int* cbp = reinterpret_cast<int*>(arm + HQ * HT * 4);
  int* ccnt = reinterpret_cast<int*>(arm + HQ * HT * 8);
  float* cthr = reinterpret_cast<float*>(ccnt + HQ);
  if constexpr (EXTRACT == kExact) {
    for (int i = tid; i < HQ * k && !reg; i += NTHREADS) {
      topd[i] = INFINITY;
      topp[i] = -1;
    }
    if (reg && tid < HQ) {
      ccnt[tid] = 0;
      cthr[tid] = INFINITY;
    }
  } else if constexpr (EXTRACT == kBinnedDeep) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int s = wslot(8 * ((i >> 1) & 3) + 2 * t4 + (i & 1),
                          bin0 + 8 * (i >> 3));
      sd[s] = make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
      sc[s] = make_uint2(0u, 0u);
    }
  }
  __syncthreads();   // the tables, qidx, qa and the lists are ready

  bool qv[4][2];
  float qa_r[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int slot = 8 * j + 2 * t4 + e;
      qv[j][e] = qidx[slot] >= 0;
      qa_r[j][e] = qas[slot];
    }
  const unsigned tbase =
      static_cast<unsigned>(__cvta_generic_to_shared(table));
  const uint32_t V0 = (0x4300u + 2 * t4) | ((0x4301u + 2 * t4) << 16);
  const uint32_t V1 = V0 + 0x00080008u;

  const int off_norms = nwp * HT * 4;
  const int off_keep = off_norms + (norms != nullptr) * HT * 4;
  const uint32_t* words = storage + (size_t)l * nw * cap;
  const bool vec = (cap & 3) == 0;
  auto load_tile = [&](int tt, unsigned char* st) {
    const int r0 = tt * HT;
    const int lim = size - r0;
    if (vec) {
      for (int c = tid; c < nwp * (HT / 4); c += NTHREADS) {
        const int w = c / (HT / 4), r4 = (c % (HT / 4)) * 4;
        if (r4 < lim)
          deep::cp_async16(st + (w * HT + r4) * 4,
                           words + (size_t)w * cap + r0 + r4);
      }
      if (tid < HT / 4 && 4 * tid < lim) {
        const size_t o = base + r0 + 4 * tid;
        if (norms) deep::cp_async16(st + off_norms + 16 * tid, norms + o);
        if (keep) deep::cp_async16(st + off_keep + 16 * tid, keep + o);
      }
    } else {
      for (int c = tid; c < nwp * HT; c += NTHREADS) {
        const int w = c / HT, r = c % HT;
        if (r < lim)
          cp_async4(st + (w * HT + r) * 4, words + (size_t)w * cap + r0 + r);
      }
      for (int r = tid; r < HT && r < lim; r += NTHREADS) {
        const size_t o = base + r0 + r;
        if (norms) cp_async4(st + off_norms + 4 * r, norms + o);
        if (keep) cp_async4(st + off_keep + 4 * r, keep + o);
      }
    }
  };

  const int ntiles = (size + HT - 1) / HT;
  if (ntiles > 0) load_tile(0, ring);
  deep::cp_async_commit();
#if RTT_STAGES < 2
  float keep_live = INFINITY;
#endif
  for (int tt = 0; tt < ntiles; ++tt) {
    deep::cp_async_wait_all();
    __syncthreads();
    if (tt + 1 < ntiles) load_tile(tt + 1, ring + ((tt + 1) & 1) * sbytes);
    deep::cp_async_commit();
    const unsigned char* st = ring + (tt & 1) * sbytes;
    const int r0 = tt * HT;

    float acc[2][16];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
#if RTT_STAGES >= 1
    const uint32_t* codes = reinterpret_cast<const uint32_t*>(st);
    // words in pairs; their 16 subspaces in groups of GSUB, each group's
    // one-hot fragments in one of two register buffers: a group's products
    // run while the next group's fragments are built
    for (int w0 = 0; w0 < nwp; w0 += 2) {
      uint32_t lo[2][2][2], hi[2][2][2];   // [word][chunk][row half]
#pragma unroll
      for (int ww = 0; ww < 2; ++ww)
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t word =
                w0 + ww < nwp
                    ? codes[(w0 + ww) * HT + 128 * c + bin0 + 8 * h]
                    : 0u;
            lo[ww][c][h] = word & 0x0F0F0F0Fu;
            hi[ww][c][h] = (word >> 4) & 0x0F0F0F0Fu;
          }
      uint32_t a[2][GSUB][2][4];          // [buffer][subspace][chunk][frag]
#pragma unroll
      for (int g = 0; g < 16 / GSUB; ++g) {
        const int buf = g & 1;
#pragma unroll
        for (int u = 0; u < GSUB; ++u) {
          const int ww = (g * GSUB + u) >> 3, jj = (g * GSUB + u) & 7;
          if (8 * (w0 + ww) + jj < p) {
            const uint32_t sel = 0x4040u | ((jj >> 1) << 8) | (jj >> 1);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const uint32_t c0 = __byte_perm(
                  (jj & 1) ? hi[ww][c][0] : lo[ww][c][0], 0x43u, sel);
              const uint32_t c8 = __byte_perm(
                  (jj & 1) ? hi[ww][c][1] : lo[ww][c][1], 0x43u, sel);
              a[buf][u][c][0] = eq_bf16x2(c0, V0);
              a[buf][u][c][1] = eq_bf16x2(c8, V0);
              a[buf][u][c][2] = eq_bf16x2(c0, V1);
              a[buf][u][c][3] = eq_bf16x2(c8, V1);
            }
          }
        }
        wg_fence();
#pragma unroll
        for (int u = 0; u < GSUB; ++u) {
          const int ww = (g * GSUB + u) >> 3, jj = (g * GSUB + u) & 7;
          const int s = 8 * (w0 + ww) + jj;
          if (s < p) {
            const uint64_t desc = table_desc(tbase + (unsigned)(s * 1024));
            wgmma_m64n32k16(acc[0], a[buf][u][0], desc);
            wgmma_m64n32k16(acc[1], a[buf][u][1], desc);
          }
        }
        wg_commit();
        wg_wait<1>();
      }
    }
    wg_wait<0>();
#else
    acc[0][0] = __uint_as_float(
        (reinterpret_cast<const uint32_t*>(table)[lane] ^
         reinterpret_cast<const uint32_t*>(st)[lane]) & 0x3F7F7F7Fu);
#endif

    const float* snorm = reinterpret_cast<const float*>(st + off_norms);
    const int* skeep = reinterpret_cast<const int*>(st + off_keep);
    float tq[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        tq[j][e] = (EXTRACT == kExact && reg) ? cthr[8 * j + 2 * t4 + e]
                                              : INFINITY;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      bool ok[2];
      float xn[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 128 * c + bin0 + 8 * h;
        ok[h] = r0 + row < size && (keep == nullptr || skeep[row] > 0);
        xn[h] = (ok[h] && metric != kIP) ? snorm[row] : 0.f;
      }
      const uint32_t chunk = static_cast<uint32_t>((r0 >> 7) + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dv[4];                   // (h, e) = (c2 >> 1, c2 & 1)
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) {
          const int h = c2 >> 1, e = c2 & 1;
          dv[c2] = (ok[h] && qv[j][e])
                       ? epilogue_dist(acc[c][4 * j + c2], qa_r[j][e], xn[h],
                                       0.f, metric)
                       : INFINITY;
        }
#if RTT_STAGES >= 2
        if constexpr (EXTRACT == kExact) {
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            const int q = 8 * j + 2 * t4 + (c2 & 1);
            const int row = 128 * c + bin0 + 8 * (c2 >> 1);
            if (!reg) {
              dtile[q * DIST_LD + row] = dv[c2];
            } else if (dv[c2] < tq[j][c2 & 1]) {
              // strict: an empty slot's or row's +inf never enters, so a
              // padding slot, which the merge below skips without
              // resetting its count, buffers nothing, and a query buffers
              // at most the tile's HT rows
              const int at = atomicAdd(&ccnt[q], 1);
              cbd[q * HT + at] = dv[c2];
              cbp[q * HT + at] = r0 + row;
            }
          }
        } else {
          bool in[4];
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2)
            in[c2] = dv[c2] < thr[((c2 >> 1) * 4 + j) * 2 + (c2 & 1)];
          if constexpr (EXTRACT == kBinned) {
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2)
              if (in[c2]) {
                const int i = ((c2 >> 1) * 4 + j) * 2 + (c2 & 1);
                thr[i] = dv[c2];
                bch[i] = chunk;
              }
          } else if (in[0] || in[1] || in[2] || in[3]) {
            float4 L[4];
            uint2 C[4];
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2)
              if (in[c2]) {
                const int sl = wslot(8 * j + 2 * t4 + (c2 & 1),
                                     bin0 + 8 * (c2 >> 1));
                L[c2] = sd[sl];
                C[c2] = sc[sl];
              }
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2)
              if (in[c2]) {
                const int sl = wslot(8 * j + 2 * t4 + (c2 & 1),
                                     bin0 + 8 * (c2 >> 1));
                deep::deep_cascade(L[c2], C[c2], dv[c2], chunk);
                sd[sl] = L[c2];
                sc[sl] = C[c2];
                thr[((c2 >> 1) * 4 + j) * 2 + (c2 & 1)] = L[c2].w;
              }
          }
        }
#else
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) keep_live = fminf(keep_live, dv[c2]);
#endif
      }
    }
#if RTT_STAGES >= 2
    if constexpr (EXTRACT == kExact) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < HQ / NWARPS; ++i) {
        const int qq = warp + NWARPS * i;
        if (qidx[qq] < 0) continue;
        if (reg) {
          const int n = ccnt[qq];
          for (int c0 = 0; c0 < n; c0 += 32) {
            const bool has = c0 + lane < n;
            merge_reg(rld[i], rlp[i], k,
                      has ? cbd[qq * HT + c0 + lane] : INFINITY,
                      has ? cbp[qq * HT + c0 + lane] : 0, lane);
          }
          const float kth = __shfl_sync(0xffffffffu, rld[i], k - 1);
          if (lane == 0) {
            ccnt[qq] = 0;
            cthr[qq] = kth;
          }
          continue;
        }
        for (int seg = 0; seg < HT / RT && r0 + seg * RT < size; ++seg)
          fold_candidates(topd + qq * k, topp + qq * k, k,
                          dtile + qq * DIST_LD + seg * RT, r0 + seg * RT,
                          lane);
      }
    }
#endif
  }

#if RTT_STAGES < 2
  if (lane == 0) out_d[((size_t)b * G + g0) * k] = keep_live;
#else
  const int* ids = indices + base;
  if constexpr (EXTRACT == kBinned) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int q = 8 * ((i >> 1) & 3) + 2 * t4 + (i & 1);
      const int bin = bin0 + 8 * (i >> 3);
      bsd[q * NBINS + bin] = thr[i];
      bsc[q * NBINS + bin] = static_cast<uint16_t>(bch[i]);
    }
  }
  __syncthreads();
  if constexpr (EXTRACT == kExact) {
    if (reg) {
#pragma unroll
      for (int i = 0; i < HQ / NWARPS; ++i) {
        const int g = g0 + warp + NWARPS * i;
        if (g < G && lane < k) {
          const size_t o = ((size_t)b * G + g) * k + lane;
          out_d[o] = rld[i];
          out_i[o] = isinf(rld[i]) ? -1 : ids[rlp[i]];
        }
      }
    } else {
      for (int e = tid; e < HQ * k; e += NTHREADS) {
        const int g = g0 + e / k;
        if (g >= G) continue;
        const size_t o = ((size_t)b * G + g) * k + e % k;
        const float dv = topd[e];
        out_d[o] = dv;
        out_i[o] = isinf(dv) ? -1 : ids[topp[e]];
      }
    }
  } else {
    for (int qq = warp; qq < HQ; qq += NWARPS) {
      const int g = g0 + qq;
      if (g >= G) continue;
      const size_t o = ((size_t)b * G + g) * k;
      if constexpr (EXTRACT == kBinned) {
        extract_bins<1>(bsd + qq * NBINS, bsc + qq * NBINS, k, ids,
                        out_d + o, out_i + o, lane);
      } else {
        if (qidx[qq] < 0) {
          for (int jj = lane; jj < k; jj += 32) {
            out_d[o + jj] = INFINITY;
            out_i[o + jj] = -1;
          }
          continue;
        }
        extract_wdeep(sd, sc, qq, k, ids, out_d + o, out_i + o, lane);
      }
    }
  }
#endif
}

template <int EXTRACT>
static int launch_as(const uint32_t* storage, const int* indices,
                     const int* list_sizes, const int* bucket_list,
                     const int* bucket_q, const float* queries,
                     const float* norms, const int* keep,
                     const float* centers, const float* pq_centers, int cap,
                     int nw, int p, int pl, int nb, int G, int k, int metric,
                     float* out_d, int* out_i, cudaStream_t stream) {
  const int n_sub = (G + HQ - 1) / HQ;
  const int n_sides = (norms != nullptr) + (keep != nullptr);
  const size_t smem = smem_bytes(p, k, EXTRACT, n_sides);
  if (smem + STATIC_BYTES > (size_t)deep::SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  auto kernel = ivf_pq4_hopper_kernel<EXTRACT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<nb * n_sub, NTHREADS, smem, stream>>>(
      storage, indices, list_sizes, bucket_list, bucket_q, queries, norms,
      keep, centers, pq_centers, cap, nw, p, pl, G, k, n_sub, metric, out_d,
      out_i);
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// storage kind 5 ([C, nw, cap] words of 8 codes), extract code `code`
// (kPq4Hopper + 0 exact, 1 binned, 2 binned_deep); the rest as the C
// entry's (round_ops required; L2 or inner product). Returns a
// cudaError_t code.
static int launch(int code, const uint32_t* storage, const int* indices,
                  const int* list_sizes, const int* bucket_list,
                  const int* bucket_q, const float* queries,
                  const float* norms, const int* keep, const float* centers,
                  const float* pq_centers, int cap, int nw, int p, int pl,
                  int nb, int G, int k, int metric, int round_ops,
                  float* out_d, int* out_i, cudaStream_t stream) {
  const int extract = code - kPq4Hopper;
  if (!round_ops || metric == kCosine || pq_centers == nullptr || p < 1 ||
      pl < 1 || p > 8 * nw ||
      (extract != kExact &&
       (cap % NBINS != 0 || cap <= NBINS || cap / NBINS > 65536 ||
        (extract == kBinned && k > 64))))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(storage) || !aligned16(norms) || !aligned16(keep))
    return (int)cudaErrorMisalignedAddress;
#define RTT_PQ4(E)                                                            \
  launch_as<E>(storage, indices, list_sizes, bucket_list, bucket_q, queries,  \
               norms, keep, centers, pq_centers, cap, nw, p, pl, nb, G, k,    \
               metric, out_d, out_i, stream)
  if (extract == kBinned) return RTT_PQ4(kBinned);
  if (extract == kBinnedDeep) return RTT_PQ4(kBinnedDeep);
  return RTT_PQ4(kExact);
#undef RTT_PQ4
}

}  // namespace pq4h
}  // namespace rtt
