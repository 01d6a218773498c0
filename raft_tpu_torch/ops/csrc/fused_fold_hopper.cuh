// Kernel 1's fold arm redesigned for Hopper (ops/fused_topk.py:fold_body
// routes to it; entry fused_knn_fold_hopper in fused_knn_topk.cu).
//
// Replaces, for the launches it covers, fused_knn_topk_kernel<T, kFold2..4>
// (the shared core's fold, scan_topk.cuh), which stays as it is for f32
// operands, d off a multiple of 16 and tiles over 2048 rows. It computes
// what the TPU kernel computes: raft_tpu/ops/fused_topk.py:_fused_kernel
// with _extract_fold (:102) over fold_lane_stacks (:76). For each query
// and each row tile of tile_n rows, lane b (column offset mod 128) keeps
// its R smallest (distance, column) pairs over the tile's columns at
// offset = b (mod 128), filled chunk by chunk (128 columns a chunk) in
// column order by the reference's strict-`<` compare-swap cascade, so
// the earlier chunk wins a tie. The stacks go out unextracted: slot
// (r, lane) of tile t at column t 128 R + r 128 + lane of the
// [m, n_tiles 128 R] buffer, id -1 where +inf; padded and filtered-out
// columns are +inf.
//
// What held the core's fold back (PERF.md): f32 dots on the CUDA cores
// with bf16 widened, 64 x 64-row tiles staged by the threads behind two
// block barriers a tile, and the bins in shared memory (96 KB at R = 2),
// so one block ran on an SM and nothing hid the staging. Here:
//
// * A block holds one row tile and 128 queries at R = 2 (four
//   warpgroups, 512 threads held to 128 registers), 64 at R = 3 and 4
//   (two warpgroups, whose deeper stacks need more registers). The
//   queries are staged once, as bf16, in wgmma's K-major core matrices
//   without swizzle: (query q, component c) at ((q / 8) KO + c / 8) 128 +
//   (q % 8) 16 + (c % 8) 2, KO = d / 8. Row chunks of 128 x d bf16 come
//   through a 2-stage cp.async ring in the same layout (bf16 rows as
//   stored; f32 rows are loaded, rounded to bf16 and stored by the
//   threads), each with its 128 norms and keep flags.
// * The dots are warpgroup products, wgmma.m64n64k16 bf16 with f32
//   accumulation, both operands read from shared memory by descriptor:
//   warpgroup (gq, g) multiplies queries 64 gq .. 64 gq + 63 by rows
//   64 g .. 64 g + 63 of the chunk, d / 16 k-steps, into 32 f32
//   registers a thread. Every row chunk staged serves all the block's
//   queries: 128 of them halve the rows' traffic from L2 against 64.
// * The accumulator's layout gives each thread the same 32 (query, lane)
//   pairs in every chunk: queries 16 w + t / 4 and + 8 of its warp w,
//   lanes 64 g + 8 j + 2 (t % 4) + {0, 1}, j < 8. So the epilogue
//   (max(qa + xn - 2 dot, 0) for L2, -dot for inner product, cosine as
//   the core's epilogue_dist) and the cascade run in registers: a pair's R
//   distances in registers, its R chunk ids as 4-bit fields (tile_n <=
//   2048 gives at most 16 chunks), eight pairs a register a level. No
//   shared memory holds a stack and no barrier guards one.
// * The write-out is the block's queries' 128 R slots each, a float2 and
//   an int2 a thread per (query, two lanes, level): whole 32-byte sectors.
//
// Shared memory (dynamic): (queries + 2 x 128) d 2 B + 2 KB of norms and
// flags: 98 KB at d = 128 and R = 2, one block an SM (the registers).
// PERF.md §6 has the designs tried (64 queries at one or two blocks an
// SM, 3- and 4-stage rings, streaming stores) and their times.
//
// Bound (PERF.md): at the fast brute force's shapes the bytes, the
// candidate write (m n_tiles 128 R 8 B: 10.0 GB at 10,000 queries x 1M
// rows, R = 2, tile 2048); its dots are 2 m n d bf16 operations at the
// tensor cores' 989 TFLOP/s, about as long. The dots are exact products
// of bf16 values summed in f32 in another order than the plain
// version's, so the buffer equals the plain version's bit for bit where
// every partial sum is exact (small integers), and elsewhere differs by
// a few ulps of the dot's terms a k-step (chip_smoke.py:fold_atol).
//
// RTT_STAGES: 0 = the ring loads, the epilogue and the write-out; 1 =
// plus the dots; 2 = plus the cascade (the whole kernel). With fewer
// than 2 the outputs are not results.
#pragma once

#include "scan_topk.cuh"

namespace rtt {
namespace foldh {

constexpr int FC = 128;       // rows a chunk (the reference's lanes)
constexpr int FS = 2;         // ring stages
constexpr int NP = 32;        // (query, lane) pairs a thread
constexpr int MAX_CHUNKS = 16;  // chunk ids in 4 bits
constexpr int SIDE = 2 * FC * 4;  // a stage's norms and keep (bytes)

// warpgroups along the queries at depth R: two (128 queries, 512
// threads, 128 registers a thread) at R = 2; one (64 queries) at R = 3
// and 4, whose stacks take more registers
__host__ __device__ constexpr int qwg(int R) { return R == 2 ? 2 : 1; }
__host__ __device__ constexpr int block_queries(int R) { return 64 * qwg(R); }
__host__ __device__ constexpr int block_threads(int R) {
  return 256 * qwg(R);
}

// dynamic shared memory of a launch at depth R and width d
inline size_t smem_bytes(int R, int d) {
  return (size_t)(block_queries(R) + FS * FC) * d * 2 + (size_t)FS * SIDE;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The descriptor of a K-major operand without swizzle at shared address
// `addr`: core matrices of 8 rows x 16 bytes, the next one along K 128 B
// on (leading byte offset), the next 8 rows `sbo` bytes on (stride byte
// offset); fields in units of 16 B.
__device__ __forceinline__ uint64_t kmajor_desc(unsigned addr,
                                                unsigned sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32);
}

// D[64 queries x 64 rows] (f32, registers) (+)= A[64 x 16] (queries,
// shared) x B[16 x 64] (rows, shared); scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n64k16(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Rows [r0, r0 + rows) of a [*, d] matrix into `dst` (shared address) in
// the core-matrix layout, rows at or past `end` as zeros. A quarter warp
// takes 8 rows of one 8-component column (one 128-byte core matrix), so
// the stores meet no bank conflict and each row is read in 64-byte runs.
// bf16 sources go by cp.async; f32 ones (the rows, rounded to bf16 as the
// plain version rounds them) are loaded and stored by the thread.
template <typename T, int NT>
__device__ __forceinline__ void load_rows(unsigned dst, const T* src,
                                          int r0, int rows, int end, int d,
                                          int tid) {
  const int ko_n = d >> 3;
  for (int e = tid; e < rows * ko_n; e += NT) {
    const int rl = e & 7, rest = e >> 3;
    const int ko = rest % ko_n, ro = rest / ko_n;
    const int r = r0 + ro * 8 + rl;
    const bool ok = r < end;
    const unsigned at =
        dst + (unsigned)(((ro * ko_n + ko) << 7) + (rl << 4));
    const T* from = src + (size_t)(ok ? r : r0) * d + ko * 8;
    if constexpr (std::is_same<T, float>::value) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (ok) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(from));
        const float4 b = __ldg(reinterpret_cast<const float4*>(from + 4));
        const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 h =
              __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
          w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    } else {
      cp_async16(at, from, ok);
    }
  }
}

// One newcomer (nd, chunk nc) into pair I's R-deep stack by the
// reference's cascade: it takes the first level whose distance it beats
// strictly, and the displaced slot goes on down; the last level's is
// dropped. Level r's chunk id of pair I is the 4-bit field at 4 (I % 8)
// of sc[r][I / 8]. +inf and NaN never enter.
template <int R, int I>
__device__ __forceinline__ void push(float (&sd)[R][NP],
                                     uint32_t (&sc)[R][NP / 8], float nd,
                                     uint32_t nc) {
  constexpr int W = I >> 3, SH = 4 * (I & 7);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool sw = nd < sd[r][I];
    const float od = sd[r][I];
    const uint32_t word = sc[r][W];
    sd[r][I] = sw ? nd : od;
    sc[r][W] = sw ? ((word & ~(15u << SH)) | (nc << SH)) : word;
    if (r + 1 < R) {
      nd = sw ? od : nd;
      nc = sw ? (word >> SH) & 15u : nc;
    }
  }
}

// One pair's distance from its dot (+inf where the column is past the
// tile or filtered out), then its cascade.
template <int R, int METRIC, int I>
__device__ __forceinline__ void fold_one(float (&sd)[R][NP],
                                         uint32_t (&sc)[R][NP / 8],
                                         float dot, bool ok, float qa,
                                         float xn, uint32_t chunk) {
  float dv = INFINITY;
  if (ok) {
    const float plen = METRIC == kCosine ? sqrtf(fmaxf(xn, 1e-30f)) : 0.f;
    dv = epilogue_dist(dot, qa, xn, plen, METRIC);
  }
#if RTT_STAGES >= 2
  push<R, I>(sd, sc, dv, chunk);
#else
  // keep the distances live without the cascade
  sd[0][I] = fminf(sd[0][I], dv);
#endif
}

// The epilogue and the cascade of the accumulator's n8 block J of one
// chunk: pair 4 J + 2 h + c is query row h's (qa[h]) column p + c.
template <int R, int METRIC, int J>
__device__ __forceinline__ void fold_pairs(float (&sd)[R][NP],
                                           uint32_t (&sc)[R][NP / 8],
                                           const float* acc,
                                           const float (&qa)[2], int p,
                                           int p_end, const float* sxn,
                                           const int* skeep,
                                           uint32_t chunk) {
  // this pair of columns' norms and keep flags, staged with the chunk
  const float2 xv = METRIC != kIP ? *reinterpret_cast<const float2*>(sxn)
                                  : make_float2(0.f, 0.f);
  const int2 kv = skeep != nullptr ? *reinterpret_cast<const int2*>(skeep)
                                   : make_int2(1, 1);
  const bool ok[2] = {p < p_end && kv.x > 0, p + 1 < p_end && kv.y > 0};
  const float xn[2] = {xv.x, xv.y};
  fold_one<R, METRIC, 4 * J>(sd, sc, acc[4 * J], ok[0], qa[0], xn[0], chunk);
  fold_one<R, METRIC, 4 * J + 1>(sd, sc, acc[4 * J + 1], ok[1], qa[0], xn[1],
                                 chunk);
  fold_one<R, METRIC, 4 * J + 2>(sd, sc, acc[4 * J + 2], ok[0], qa[1], xn[0],
                                 chunk);
  fold_one<R, METRIC, 4 * J + 3>(sd, sc, acc[4 * J + 3], ok[1], qa[1], xn[1],
                                 chunk);
}

// The chunk's 8 n8 blocks: pair columns p0 + 8 J (global) and the side
// arrays' entries at sxn / skeep + 8 J.
template <int R, int METRIC, int J = 0>
__device__ __forceinline__ void fold_chunk(float (&sd)[R][NP],
                                           uint32_t (&sc)[R][NP / 8],
                                           const float* acc,
                                           const float (&qa)[2], int p0,
                                           int p_end, const float* sxn,
                                           const int* skeep,
                                           uint32_t chunk) {
  fold_pairs<R, METRIC, J>(sd, sc, acc, qa, p0 + 8 * J, p_end,
                           sxn + 8 * J,
                           skeep == nullptr ? nullptr : skeep + 8 * J,
                           chunk);
  if constexpr (J + 1 < 8)
    fold_chunk<R, METRIC, J + 1>(sd, sc, acc, qa, p0, p_end, sxn, skeep,
                                 chunk);
}

// A chunk's norms and keep flags (128 each from row r0, zeros past `end`)
// into `dst` (shared address): threads 0-31 the norms, 32-63 the flags,
// 16 bytes each.
__device__ __forceinline__ void load_side(unsigned dst,
                                          const float* __restrict__ norms,
                                          const int* __restrict__ keep,
                                          int r0, int end, int tid) {
  const int half = tid >> 5;
  if (half > 1) return;
  const void* src = half == 0 ? static_cast<const void*>(norms)
                              : static_cast<const void*>(keep);
  if (src == nullptr) return;
  const int r = r0 + 4 * (tid & 31);
  const int bytes = max(0, min(16, 4 * (end - r)));
  const char* from = static_cast<const char*>(src) +
                     (size_t)(bytes > 0 ? r : r0) * 4;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   dst + (unsigned)(half * FC * 4 + 16 * (tid & 31))),
               "l"(from), "r"(bytes));
}

// queries [m, d] bf16; qaux [m] (null for IP); x [n, d] bf16 or f32
// (rounded to bf16); norms [n] (null for IP); keep [n] or null. Block
// (query tile qt, row tile t): blockIdx.x = t n_qtiles + qt.
template <int R, typename T>
__global__ void __launch_bounds__(block_threads(R), 1)
fused_fold_hopper_kernel(const __nv_bfloat16* __restrict__ queries,
                         const float* __restrict__ qaux,
                         const T* __restrict__ x,
                         const float* __restrict__ norms,
                         const int* __restrict__ keep, int m, int n, int d,
                         int tile_n, int n_tiles, int n_qtiles, int metric,
                         float* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int FQ = block_queries(R), FNT = block_threads(R);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wq = (tid >> 5) & 3;   // warp in its warpgroup: 16 queries
  const int g = (tid >> 7) & 1;    // warpgroup's 64 lanes of the chunk
  const int gq = tid >> 8;         // warpgroup's 64 queries of the block
  const int qt = blockIdx.x % n_qtiles;
  const int tile = blockIdx.x / n_qtiles;
  const int q0 = qt * FQ + 64 * gq;   // this warpgroup's first query
  const int p_begin = tile * tile_n;
  const int p_end = min(n, p_begin + tile_n);
  const int n_ch = (p_end - p_begin + FC - 1) / FC;

  const unsigned qs = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned ring = qs + (unsigned)(FQ * d * 2);
  const unsigned stage_bytes = (unsigned)(FC * d * 2);
  const unsigned side = ring + (unsigned)FS * stage_bytes;
  const unsigned sbo = (unsigned)(d * 16);   // 8 rows of d bf16
  const unsigned char* side_ptr =
      smem + (size_t)(FQ + FS * FC) * d * 2;

  // the queries and the first FS - 1 chunks, a group each (the queries in
  // the first)
  load_rows<__nv_bfloat16, FNT>(qs, queries, qt * FQ, FQ, m, d, tid);
#pragma unroll
  for (int c = 0; c + 1 < FS; ++c) {
    if (c < n_ch) {
      load_rows<T, FNT>(ring + (unsigned)c * stage_bytes, x,
                        p_begin + c * FC, FC, p_end, d, tid);
      load_side(side + (unsigned)(c * SIDE), norms, keep, p_begin + c * FC,
                p_end, tid);
    }
    cp_async_commit();
  }

  float qa[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + 16 * wq + (lane >> 2) + 8 * h;
    qa[h] = (q < m && metric != kIP) ? qaux[q] : 0.f;
  }
  float sd[R][NP];
  uint32_t sc[R][NP / 8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < NP; ++i) sd[r][i] = INFINITY;
#pragma unroll
    for (int i = 0; i < NP / 8; ++i) sc[r][i] = 0u;
  }
  // this thread's first lane in a chunk
  const int lane0 = 64 * g + 2 * (lane & 3);

  for (int c = 0; c < n_ch; ++c) {
    cp_async_wait<FS - 2>();
    // cp.async and thread stores reach wgmma through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    {
      const int cn = c + FS - 1;   // into the stage chunk c - 1 left
      if (cn < n_ch) {
        load_rows<T, FNT>(ring + (unsigned)(cn % FS) * stage_bytes, x,
                          p_begin + cn * FC, FC, p_end, d, tid);
        load_side(side + (unsigned)((cn % FS) * SIDE), norms, keep,
                  p_begin + cn * FC, p_end, tid);
      }
      cp_async_commit();
    }

    float acc[NP];
#if RTT_STAGES >= 1
    {
      const unsigned a0 = qs + (unsigned)(8 * gq) * sbo;
      const unsigned b0 = ring + (unsigned)(c % FS) * stage_bytes +
                          (unsigned)(8 * g) * sbo;
      wg_fence();
      for (int s = 0; s < d / 16; ++s)
        wgmma_m64n64k16(acc, kmajor_desc(a0 + (unsigned)(s * 256), sbo),
                        kmajor_desc(b0 + (unsigned)(s * 256), sbo), s > 0);
      wg_commit();
      wg_wait0();
    }
#else
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[i] = 0.f;
#endif
    const int p0 = p_begin + c * FC + lane0;
    const uint32_t chunk = static_cast<uint32_t>(c);
    const float* sxn = reinterpret_cast<const float*>(
                           side_ptr + (size_t)(c % FS) * SIDE) + lane0;
    const int* skeep =
        keep == nullptr ? nullptr
                        : reinterpret_cast<const int*>(
                              side_ptr + (size_t)(c % FS) * SIDE + FC * 4) +
                              lane0;
    if (metric == kL2)
      fold_chunk<R, kL2>(sd, sc, acc, qa, p0, p_end, sxn, skeep, chunk);
    else if (metric == kIP)
      fold_chunk<R, kIP>(sd, sc, acc, qa, p0, p_end, sxn, skeep, chunk);
    else
      fold_chunk<R, kCosine>(sd, sc, acc, qa, p0, p_end, sxn, skeep, chunk);
  }

  // every slot out: level r of lane l of query q at column
  // tile 128 R + r 128 + l, id -1 where +inf
  const size_t width = (size_t)n_tiles * FC * R;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 16 * wq + (lane >> 2) + 8 * h;
      if (q >= m) continue;
      const int l = lane0 + 8 * j;
      const int i = 4 * j + 2 * h;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t o = (size_t)q * width + (size_t)tile * FC * R +
                         (size_t)r * FC + l;
        const float d0 = sd[r][i], d1 = sd[r][i + 1];
        const uint32_t c0 = (sc[r][i >> 3] >> (4 * (i & 7))) & 15u;
        const uint32_t c1 = (sc[r][(i + 1) >> 3] >> (4 * ((i + 1) & 7))) &
                            15u;
        const float2 dv = make_float2(d0, d1);
        const int2 iv = make_int2(
            isinf(d0) ? -1 : p_begin + FC * (int)c0 + l,
            isinf(d1) ? -1 : p_begin + FC * (int)c1 + l + 1);
        *reinterpret_cast<float2*>(out_d + o) = dv;
        *reinterpret_cast<int2*>(out_i + o) = iv;
      }
    }
}

template <int R, typename T>
static int launch_as(const __nv_bfloat16* queries, const float* qaux,
                     const T* x, const float* norms, const int* keep, int m,
                     int n, int d, int tile_n, int n_tiles, int metric,
                     float* out_d, int* out_i, cudaStream_t stream) {
  constexpr int FQ = block_queries(R), FNT = block_threads(R);
  const int n_qtiles = (m + FQ - 1) / FQ;
  const size_t smem = smem_bytes(R, d);
  auto kernel = fused_fold_hopper_kernel<R, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  kernel<<<n_qtiles * n_tiles, FNT, smem, stream>>>(
      queries, qaux, x, norms, keep, m, n, d, tile_n, n_tiles, n_qtiles,
      metric, out_d, out_i);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_r(int fold_r, const __nv_bfloat16* queries,
                    const float* qaux, const T* x, const float* norms,
                    const int* keep, int m, int n, int d, int tile_n,
                    int n_tiles, int metric, float* out_d, int* out_i,
                    cudaStream_t stream) {
#define RTT_R(R)                                                              \
  launch_as<R, T>(queries, qaux, x, norms, keep, m, n, d, tile_n, n_tiles,    \
                  metric, out_d, out_i, stream)
  if (fold_r == 2) return RTT_R(2);
  if (fold_r == 3) return RTT_R(3);
  return RTT_R(4);
#undef RTT_R
}

}  // namespace foldh
}  // namespace rtt
