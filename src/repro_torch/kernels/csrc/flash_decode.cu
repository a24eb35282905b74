// Flash-decode for Hopper (sm_90a): grouped-query single-token attention
// of q (B, 1, Hq, dh) against a per-slot KV cache masked by per-slot
// lengths and, optionally, a sliding-window ring. The cache is either
//   * dense: (B, S_max, Hk, dh), or
//   * paged: a physical block pool (N_blocks, blk, Hk, dh) read through a
//     (B, nb) block table; virtual cell c of slot b lives in pool block
//     max(table[b, c / blk], 0) at row c % blk (a -1 entry, or one past
//     the pool, reads trash block 0), and S_max = nb * blk.
//
// Replaces the Pallas TPU kernels repro/kernels/flash_decode.py::
// flash_decode (body `_body`, call `_flash_decode_call`) and
// flash_decode_paged (body `_paged_body`, call `_flash_decode_paged_call`).
//
// What bounds it: the K and V bytes of the live cells, each read once.
// At B=4, Hk=8, dh=128 in bf16 and lengths [0, 1, 300, 512] that is
// 3.33 MB, about 1.0 us at the H100's 3.35 TB/s; q and the output are a
// few KB. There is about one FMA per K or V element read (2 FLOP a byte
// at G = 4), far below the 295 at which bf16 stops being memory-bound, so
// the math stays in fp32 on the CUDA cores.
//
// What the first design lost. It ran one block per (32-cell split, kv
// head, slot), 512 blocks at the serving shape whatever the lengths (216
// of them live), each writing a full fp32 partial, empty ones included
// (1,064,960 bytes a call against 3.33 MB of live rows), and a second
// kernel read all partials back. Inside a block, loads waited on the
// length, a liveness test and a block vote, q came after K/V, and P.V ran
// a per-head loop of two barriers. A call took 13.8 us at cache length
// 64 and 17.2 us at 448: 7x the bytes for 3.4 us more, so a fixed chain
// of latencies, not the bytes, set its time (21x its bound).
//
// This design: one launch, no global scratch.
//   * Clusters. A cluster of FD_CLUSTER blocks (along x) per (kv head,
//     slot, head group) takes the slot's live prefix [0, hi), hi =
//     min(length, S_max) (an SWA ring that wrapped is live up to S_max),
//     and splits its FD_TILE-cell tiles into FD_CLUSTER contiguous
//     ranges; cells past hi are never read and a block with an empty
//     range writes empty partials (m = -1e30, l = 0, acc = 0). Dead
//     cells (the SWA ring's gap, the end of the prefix) are masked from
//     the virtual cell index with live(): a tile with no live cell is
//     skipped, and in the others a dead cell's rows are zero-filled in
//     shared memory without a read, so p = 0 adds exactly nothing.
//     Cluster size 16 was measured too: the long cache ran faster, the
//     serving shape slower, so the portable 8 stays.
//   * Entry. Every thread issues its loads of the length and of q
//     (16-byte loads, held in fp32 in shared memory) before anything
//     waits. A paged block's producer then loads the table entries of
//     its range, once, before its first copy.
//   * Streaming. One producer warp fills a ring of 2 to FD_STAGES
//     shared-memory stages of FD_TILE cells (as many as a block's range
//     can have tiles: 2, within 48 KB, at the serving shape) with 16-byte
//     cp.async copies of each live cell's K and V rows; each lane's
//     cp.async.mbarrier.arrive completes the stage's `full` mbarrier, and
//     the consumers release it through its `empty` mbarrier. One
//     cp.async.bulk copy a row (dh * elt bytes, completing on the same
//     mbarrier) was built first and measured slower on the H100: a tile
//     is 64 such copies, and their per-copy cost set the pace. Rows sit
//     16 bytes apart beyond their length, so lanes reading eight
//     different rows hit different banks. Dense and paged rows differ
//     only in the source address (cell_row<kPaged>), the only difference
//     between the two kernels.
//   * Math. FD_WARPS consumer warps; warp w owns query heads w,
//     w + FD_WARPS, ... of the cluster's head group. For a tile, lane c
//     takes cell c's score for a head (the dot over dh against q in
//     shared memory, eight independent partial sums), the warp takes the
//     tile's max with one shuffle tree and each lane keeps its own share
//     of the running sum l (summed once, at the end), and lanes split
//     (cells x 8-channel chunks) for acc += p.V, the tile's p fetched by
//     shuffles before any V load, acc held in registers across tiles. No
//     block barrier per head: a tile costs one mbarrier wait per warp and
//     one arrive, whatever G. Two groups of consumer warps taking the
//     tiles in turn were measured too, and were slower at the serving
//     shape.
//   * Combine. Each block leaves its (m, l, acc) in its shared memory;
//     after a cluster barrier block rank r reads channels [r dpr,
//     (r+1) dpr), dpr = ceil(dh / C), of every head of all C partials
//     through distributed shared memory in rank order, rescales to the
//     global max, divides by max(l, 1e-30) (an empty slot gives exactly
//     0) and writes q's dtype; a second cluster barrier keeps every
//     block's shared memory alive until it has been read.
//   * Block variant (flash_decode_partial_launch). A cache split by
//     sequence over ranks is attended block by block: each rank calls the
//     kernel on its cells with its block's live count as the length and
//     no window, and the lse pointer set. The combine already holds each
//     head's global (m, l); the thread that writes channel 0 of a head
//     also stores lse = m + log(l), or -inf for a block with no live
//     cell (whose out is 0). A null lse is the plain kernel: one branch
//     a head in the combine, no other change.
// Every sum runs in a fixed order, so two calls are bitwise equal and the
// paged kernel is bitwise equal to the dense kernel on the gathered view
// for any block size. The scale dh^-0.5 is applied to the fp32 score after
// the dot, and query head h reads kv head h / G, as on the TPU.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FD_TILE 32            // cache cells per stage (one per lane)
#define FD_CLUSTER 8          // blocks per cluster (the portable size)
#define FD_STAGES 3           // most shared-memory stages of the K/V ring
#define FD_WARPS 4            // consumer warps
#define FD_PRODUCERS 2        // producer warps, issuing a tile's copies
#define FD_MAX_SMEM 232448    // dynamic shared memory a block may use
// -DFD_TRACE=1 builds a copy that stamps each block's phases with the
// global nanosecond timer (kernels/flash_decode.py: trace_phases)
#ifndef FD_TRACE
#define FD_TRACE 0
#endif
#define FD_TRACE_BLOCKS 4096
#define FD_PHASES 8

#if FD_TRACE
__device__ unsigned long long fd_trace[FD_TRACE_BLOCKS][FD_PHASES];
#define FD_STAMP(phase, when)                                               \
  do {                                                                      \
    const unsigned bid_ =                                                   \
        (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;     \
    if ((when) && bid_ < FD_TRACE_BLOCKS) {                                 \
      unsigned long long t_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \
      fd_trace[bid_][phase] = t_;                                           \
    }                                                                       \
  } while (0)
#else
#define FD_STAMP(phase, when) do {} while (0)
#endif

namespace {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = (FD_WARPS + FD_PRODUCERS) * 32;

__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}

// 8 consecutive elements -> fp32 registers (16-byte aligned loads)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 16 bytes of q -> fp32 in shared memory
__device__ __forceinline__ void q16_to_f(const uint4 raw, const float*,
                                         float* out) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = f[i];
}
__device__ __forceinline__ void q16_to_f(const uint4 raw,
                                         const __nv_bfloat16*, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// 16 bytes global -> shared, of which the first `src_bytes` (16 or 0)
// are read and the rest zero-filled
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival is counted in the barrier's initial count)
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The two halves of a cluster barrier (cluster.sync() is both at once).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Is cache cell `cell` of a slot with `length` written tokens live?
// window < 0: full causal. Otherwise the cache is a ring of s_max cells and
// each cell's absolute position is recovered from the write cursor (the
// arithmetic of attention.decode_valid_mask).
__device__ __forceinline__ bool live(int cell, int length, int s_max,
                                     int window) {
  if (cell >= s_max) return false;
  if (window < 0) return cell < length;
  const int rem = length % s_max;
  const int abs_pos = length > s_max
      ? (cell < rem ? length - rem + cell : length - rem - s_max + cell)
      : cell;
  return abs_pos < length && abs_pos >= length - window;
}

// Where a cell's K/V row starts, in rows of Hk * dh elements from the
// cache's (pool's) base. Dense: slot b's cell. Paged: the cell's pool
// block, from the block's table entries in shared memory (first = the
// range's first virtual block).
template <bool kPaged>
__device__ __forceinline__ size_t cell_row(int b, int cell, int s_max,
                                           int blk, int first,
                                           const int* tbl_s) {
  if constexpr (kPaged)
    return (size_t)tbl_s[cell / blk - first] * blk + cell % blk;
  else
    return (size_t)b * s_max + cell;
}

// The cluster's tile range for block rank r: [t0, t1) of the
// ceil(hi / FD_TILE) tiles of the live prefix [0, hi).
__device__ __forceinline__ void tile_range(int len, int s_max, int rank,
                                           int* t0, int* t1) {
  const int hi = max(0, min(len, s_max));
  const int n = (hi + FD_TILE - 1) / FD_TILE;
  *t0 = rank * n / FD_CLUSTER;
  *t1 = (rank + 1) * n / FD_CLUSTER;
}

// Stages of the K/V ring for a launch over s_max cells: as many as the
// longest block range can have tiles, between 2 and FD_STAGES.
__host__ __device__ __forceinline__ int ring_stages(int s_max) {
  const int tiles = (s_max + FD_TILE - 1) / FD_TILE;
  const int most = (tiles + FD_CLUSTER - 1) / FD_CLUSTER;
  return most < 2 ? 2 : (most > FD_STAGES ? FD_STAGES : most);
}

// Shared memory of one block, in this order: the 2 * n_st mbarriers (16
// bytes a stage), the K and V stages (FD_TILE rows of kstr bytes each),
// q (gh_max, dh) fp32, the partial acc (gh_max, dh) and (m, l)
// (gh_max, 2) fp32, then n_tbl int table entries (paged).
__host__ __device__ __forceinline__ size_t row_stride(int dh, int elt) {
  return (size_t)dh * elt + 16;
}
__host__ __device__ __forceinline__ size_t smem_bytes(int n_st, int gh_max,
                                                      int dh, int elt,
                                                      int n_tbl) {
  return 16 * (size_t)n_st + 2 * (size_t)n_st * FD_TILE *
         row_stride(dh, elt) + (size_t)gh_max * (2 * dh + 2) * 4 +
         (size_t)n_tbl * 4;
}

// One block per (cluster rank, kv head x head group, slot); clusters of
// FD_CLUSTER along x. LPC lanes share a cell row in P.V, each lane holding
// one 8-channel chunk (LPC = the power of two >= dh / 8); HPW is the most
// query heads a consumer warp owns (heads per cluster: FD_WARPS * HPW).
// A tile with no live cell is skipped by producer and consumers alike
// (it would change nothing), so ring slots count the live tiles only.
template <typename T, int LPC, int HPW, bool kPaged>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ length,
    const int* __restrict__ table, T* __restrict__ out,
    float* __restrict__ lse, int s_max, int blk, int n_blocks, int hk_n,
    int g_n, int n_hg, int dh, int window, float scale, int n_tbl) {
  constexpr int kCpw = 32 / LPC;              // cells per pass in P.V
  constexpr int kHg = FD_WARPS * HPW;         // heads per cluster
  constexpr int kNcp = LPC * sizeof(T) / 2;   // 16-byte chunks a row, to
                                              // a power of two
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];
  const int elt = (int)sizeof(T);
  const size_t kstr = row_stride(dh, elt);
  const size_t stage_bytes = FD_TILE * kstr;
  const int n_st = ring_stages(s_max);
  const int gh_max = min(kHg, g_n);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + n_st;
  unsigned char* k_s = smem + 16 * n_st;
  unsigned char* v_s = k_s + n_st * stage_bytes;
  float* q_s = reinterpret_cast<float*>(v_s + n_st * stage_bytes);
  float* part_acc = q_s + gh_max * dh;
  float* part_ml = part_acc + gh_max * dh;
  int* tbl_s = reinterpret_cast<int*>(part_ml + 2 * gh_max);

  const int rank = blockIdx.x;                // == cluster.block_rank()
  const int hk = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int gh = min(kHg, g_n - hg * kHg);    // heads of this cluster
  const int hq = hk_n * g_n;
  const size_t q_row = (size_t)b * hq + (size_t)hk * g_n + hg * kHg;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // entry: the length and q are loaded together, before anything waits
  FD_STAMP(0, threadIdx.x == 0);                    // phase 0: entry
  const int len = length[b];
  constexpr int kPer = 16 / sizeof(T);        // q elements per 16 bytes
  const int n16 = gh * dh / kPer;
  const uint4* q16 = reinterpret_cast<const uint4*>(q + q_row * dh);
  uint4 qraw = make_uint4(0, 0, 0, 0);
  if ((int)threadIdx.x < n16) qraw = q16[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_st; ++s) {
      mbar_init(&full[s], 32 * FD_PRODUCERS);   // the producers' lanes
      mbar_init(&empty[s], min(FD_WARPS, gh));  // the live consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if ((int)threadIdx.x < n16)
    q16_to_f(qraw, q, q_s + threadIdx.x * kPer);
  for (int i = threadIdx.x + kThreads; i < n16; i += kThreads)
    q16_to_f(q16[i], q, q_s + i * kPer);
  __syncthreads();
  FD_STAMP(1, threadIdx.x == 0);                    // 1: q in shared memory

  int t0, t1;
  tile_range(len, s_max, rank, &t0, &t1);
  const size_t row = (size_t)hk_n * dh;       // elements between rows
  const int nc = dh * elt / 16;               // 16-byte chunks a row

  if (warp >= FD_WARPS) {
    // producers: the paged range's table entries, then the K/V copies,
    // each producer warp issuing its share of every tile's chunks
    const int pt = threadIdx.x - FD_WARPS * 32;     // producer thread
    int first = 0;
    if constexpr (kPaged) {
      if (t1 > t0) {
        const int nb = s_max / blk;
        const int c_end = min(t1 * FD_TILE, s_max);
        first = t0 * FD_TILE / blk;
        const int n = (c_end - 1) / blk - first + 1;
        for (int i = pt; i < n && i < n_tbl; i += 32 * FD_PRODUCERS) {
          const int t = table[(size_t)b * nb + first + i];
          tbl_s[i] = t > 0 && t < n_blocks ? t : 0;
        }
        asm volatile("bar.sync 1, %0;\n" :: "r"(32 * FD_PRODUCERS)
                     : "memory");
      }
    }
    int i = 0;                                // live tiles so far
    for (int t = t0; t < t1; ++t) {
      const int cell = t * FD_TILE + lane;
      const bool lv = live(cell, len, s_max, window);
      const unsigned mask = __ballot_sync(0xffffffffu, lv);
      if (!mask) continue;
      const int st = i % n_st;
      if (i >= n_st) mbar_wait(&empty[st], ((i / n_st) - 1) & 1);
      // this lane's cell's row (a dead cell's is never read)
      const unsigned long long off = lv
          ? cell_row<kPaged>(b, cell, s_max, blk, first, tbl_s) * row +
            (size_t)hk * dh
          : 0;
      unsigned char* kst = k_s + st * stage_bytes;
      unsigned char* vst = v_s + st * stage_bytes;
#pragma unroll 4
      for (int e = pt; e < FD_TILE * kNcp; e += 32 * FD_PRODUCERS) {
        const int r = e / kNcp, c = e % kNcp;   // row r's chunk c
        const unsigned long long o = __shfl_sync(0xffffffffu, off, r);
        if (c < nc) {
          const uint32_t bytes = ((mask >> r) & 1u) ? 16u : 0u;
          copy16(kst + r * kstr + c * 16,
                 reinterpret_cast<const char*>(k + o) + c * 16, bytes);
          copy16(vst + r * kstr + c * 16,
                 reinterpret_cast<const char*>(v + o) + c * 16, bytes);
        }
      }
      copies_arrive(&full[st]);
      FD_STAMP(2, pt == 0 && i == 0);               // 2: first tile issued
      ++i;
    }
  } else if (warp < gh) {
    // consumer warp: heads g = warp + FD_WARPS * j of the cluster's group
    const int sub = lane / LPC, sl = lane % LPC;
    const bool chunk = sl < dh / 8;
    // m: the warp's running max; l: this lane's share of the running sum
    float m[HPW], l[HPW], acc[HPW][8];
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[j][x] = 0.f;
    }
    int i = 0;                                // live tiles so far
    for (int t = t0; t < t1; ++t) {
      const int cell = t * FD_TILE + lane;
      const bool lv = live(cell, len, s_max, window);
      if (!__ballot_sync(0xffffffffu, lv)) continue;
      const int st = i % n_st;
      mbar_wait(&full[st], (i / n_st) & 1);
      FD_STAMP(3, threadIdx.x == 0 && i == 0);      // 3: first tile landed
      const T* kr = reinterpret_cast<const T*>(k_s + st * stage_bytes +
                                               lane * kstr);
      const unsigned char* vr =
          v_s + st * stage_bytes + sub * kstr + sl * 8 * sizeof(T);
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        const int g = warp + FD_WARPS * j;
        if (g >= gh) break;                   // uniform across the warp
        // score of this lane's cell, eight independent partial sums
        const float* qg = q_s + g * dh;
        float d8[8];
#pragma unroll
        for (int x = 0; x < 8; ++x) d8[x] = 0.f;
#pragma unroll 4
        for (int c8 = 0; c8 < dh; c8 += 8) {
          float kf[8];
          load8(kr + c8, kf);
          const float4 qa = *reinterpret_cast<const float4*>(qg + c8);
          const float4 qb = *reinterpret_cast<const float4*>(qg + c8 + 4);
          d8[0] = fmaf(qa.x, kf[0], d8[0]); d8[1] = fmaf(qa.y, kf[1], d8[1]);
          d8[2] = fmaf(qa.z, kf[2], d8[2]); d8[3] = fmaf(qa.w, kf[3], d8[3]);
          d8[4] = fmaf(qb.x, kf[4], d8[4]); d8[5] = fmaf(qb.y, kf[5], d8[5]);
          d8[6] = fmaf(qb.z, kf[6], d8[6]); d8[7] = fmaf(qb.w, kf[7], d8[7]);
        }
        const float d = ((d8[0] + d8[1]) + (d8[2] + d8[3])) +
                        ((d8[4] + d8[5]) + (d8[6] + d8[7]));
        const float s = lv ? d * scale : kNegInf;
        float mt = s;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(m[j], mt);
        const float p = lv ? expf(s - mn) : 0.f;
        const float corr = expf(m[j] - mn);
        l[j] = fmaf(l[j], corr, p);
        m[j] = mn;
        // p-weighted V: lane (sub, sl) takes cells sub, sub + kCpw, ...
        float pc[LPC];
#pragma unroll
        for (int it = 0; it < LPC; ++it)
          pc[it] = __shfl_sync(0xffffffffu, p, sub + it * kCpw);
#pragma unroll
        for (int x = 0; x < 8; ++x) acc[j][x] *= corr;
        if (chunk) {
#pragma unroll
          for (int it = 0; it < LPC; ++it) {
            float vf[8];
            load8(reinterpret_cast<const T*>(vr + it * kCpw * kstr), vf);
#pragma unroll
            for (int x = 0; x < 8; ++x)
              acc[j][x] = fmaf(pc[it], vf[x], acc[j][x]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      ++i;
    }
    FD_STAMP(4, threadIdx.x == 0);                  // 4: last tile done
    // this block's partial: l and acc summed over the warp's lanes
#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      const int g = warp + FD_WARPS * j;
      if (g >= gh) break;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
#pragma unroll
      for (int off = LPC; off < 32; off <<= 1)
#pragma unroll
        for (int x = 0; x < 8; ++x)
          acc[j][x] += __shfl_xor_sync(0xffffffffu, acc[j][x], off);
      if (sub == 0 && chunk) {
        float4* dst = reinterpret_cast<float4*>(part_acc + g * dh + sl * 8);
        dst[0] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        dst[1] = make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
      }
      if (lane == 0) {
        part_ml[2 * g] = m[j];
        part_ml[2 * g + 1] = l[j];
      }
    }
  }
  cluster.sync();
  FD_STAMP(5, threadIdx.x == 0);                    // 5: partials ready

  // combine: rank r writes channels [d0, d0 + nd) of every head, reading
  // the C partials in rank order
  const int dpr = (dh + FD_CLUSTER - 1) / FD_CLUSTER;
  const int d0 = min(dh, rank * dpr), nd = min(dh, d0 + dpr) - d0;
  // one output a thread at the shapes the engines use: its block then
  // arrives on the final cluster barrier as soon as its remote reads have
  // returned, and waits for the others' only before it leaves
  const bool one_pass = gh * nd <= kThreads;
  for (int o = threadIdx.x; o < gh * nd; o += kThreads) {
    const int g = o / nd, d = d0 + o % nd;
    float ms[FD_CLUSTER], ls[FD_CLUSTER], as[FD_CLUSTER];
#pragma unroll
    for (int s = 0; s < FD_CLUSTER; ++s) {
      const float* ml = cluster.map_shared_rank(part_ml, s);
      ms[s] = ml[2 * g];
      ls[s] = ml[2 * g + 1];
      as[s] = cluster.map_shared_rank(part_acc, s)[g * dh + d];
    }
    if (one_pass) cluster_arrive();
    float m_all = kNegInf;
#pragma unroll
    for (int s = 0; s < FD_CLUSTER; ++s) m_all = fmaxf(m_all, ms[s]);
    float l_all = 0.f, a = 0.f;
#pragma unroll
    for (int s = 0; s < FD_CLUSTER; ++s) {
      const float e = expf(ms[s] - m_all);
      l_all += ls[s] * e;
      a = fmaf(as[s], e, a);
    }
    store(out + (q_row + g) * dh + d, a / fmaxf(l_all, 1e-30f));
    // the block variant: one log-sum-exp a query head (-inf: no cell)
    if (lse != nullptr && d == 0)
      lse[q_row + g] = l_all > 0.f ? m_all + logf(l_all) : -INFINITY;
  }
  if (!one_pass || (int)threadIdx.x >= gh * nd) cluster_arrive();
  FD_STAMP(6, threadIdx.x == 0);                    // 6: output written
  cluster_wait();             // no block leaves while it is being read
  FD_STAMP(7, threadIdx.x == 0);                    // 7: exit
}

// Heads per consumer warp (template): 1 up to FD_WARPS query heads a kv
// head, else 4; more than FD_WARPS * 4 heads take several head groups.
inline int hpw_for(int g_n) { return g_n <= FD_WARPS ? 1 : 4; }

inline int n_tbl_for(int s_max, int blk, bool paged) {
  if (!paged) return 0;
  const int tiles = (s_max + FD_TILE - 1) / FD_TILE;
  const int cells = (tiles + FD_CLUSTER - 1) / FD_CLUSTER * FD_TILE;
  return min(s_max / blk, cells / blk + 2);
}

inline size_t launch_smem(int g_n, int dh, int elt, int s_max, int blk,
                          bool paged) {
  const int gh_max = min(FD_WARPS * hpw_for(g_n), g_n);
  return smem_bytes(ring_stages(s_max), gh_max, dh, elt,
                    n_tbl_for(s_max, blk, paged));
}

template <typename T, int LPC, int HPW, bool kPaged>
int launch_one(const void* q, const void* k, const void* v,
               const void* length, const void* table, void* out,
               float* lse, int b,
               int s_max, int blk, int n_blocks, int hk_n, int g_n, int dh,
               int window, float scale, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<T, LPC, HPW, kPaged>;
  static bool attr_set = false;           // once per instance
  const size_t smem = launch_smem(g_n, dh, sizeof(T), s_max, blk, kPaged);
  if (smem > FD_MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FD_MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int n_hg = (g_n + FD_WARPS * HPW - 1) / (FD_WARPS * HPW);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(FD_CLUSTER, hk_n * n_hg, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = FD_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(length),
      static_cast<const int*>(table), static_cast<T*>(out), lse, s_max,
      blk, n_blocks, hk_n, g_n, n_hg, dh, window, scale,
      n_tbl_for(s_max, blk, kPaged));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// table == nullptr: dense cache with s_max cells per slot. Otherwise a
// pool of n_blocks blocks of blk cells and s_max = nb * blk.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           const void* table, void* out, float* lse, int b, int s_max,
           int blk,
           int n_blocks, int hk_n, int g_n, int dh, int window, float scale,
           cudaStream_t stream) {
  int lpc = 1;
  while (lpc * 8 < dh) lpc <<= 1;       // lanes per cell (dh <= 256: <= 32)
  const bool paged = table != nullptr;
  const bool many = hpw_for(g_n) > 1;
#define FLASH_DECODE_ONE(LPC, HPW, PAGED)                                    \
  return launch_one<T, LPC, HPW, PAGED>(q, k, v, length, table, out, lse,  \
                                        b, s_max, blk, n_blocks, hk_n, g_n,  \
                                        dh, window, scale, stream)
#define FLASH_DECODE_LPC(LPC)                                                \
  if (paged) {                                                               \
    if (many) FLASH_DECODE_ONE(LPC, 4, true);                                \
    FLASH_DECODE_ONE(LPC, 1, true);                                          \
  }                                                                          \
  if (many) FLASH_DECODE_ONE(LPC, 4, false);                                 \
  FLASH_DECODE_ONE(LPC, 1, false)
  switch (lpc) {
    case 1: FLASH_DECODE_LPC(1);
    case 2: FLASH_DECODE_LPC(2);
    case 4: FLASH_DECODE_LPC(4);
    case 8: FLASH_DECODE_LPC(8);
    case 16: FLASH_DECODE_LPC(16);
    default: FLASH_DECODE_LPC(32);
  }
#undef FLASH_DECODE_LPC
#undef FLASH_DECODE_ONE
}

}  // namespace

extern "C" {

#if FD_TRACE
// The phase stamps of the last traced launch, (FD_TRACE_BLOCKS,
// FD_PHASES) uint64 into `host`; zeroed first when `clear` (0 = unset).
int flash_decode_trace(void* host, int clear) {
  static unsigned long long zero[FD_TRACE_BLOCKS][FD_PHASES];
  if (clear)
    return static_cast<int>(
        cudaMemcpyToSymbol(fd_trace, zero, sizeof(zero)));
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, fd_trace, sizeof(fd_trace)));
}
#endif

// Dynamic shared memory of one block of a launch (the wrapper checks it
// against FD_MAX_SMEM before launching).
long long flash_decode_smem_bytes(int g_n, int dh, int is_bf16, int s_max,
                                  int blk, int paged) {
  return static_cast<long long>(launch_smem(g_n, dh, is_bf16 ? 2 : 4,
                                            s_max, blk, paged != 0));
}

// q (B, 1, Hq, dh), k/v (B, S_max, Hk, dh) contiguous, bf16 (is_bf16 = 1)
// or fp32; length (B,) int32; out like q. window < 0 means no sliding
// window. Returns the launch's CUDA error (0 on success).
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* length, void* out, int b, int s_max,
                        int hk_n, int g_n, int dh, int window, float scale,
                        int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, length, nullptr, out, nullptr, b,
                                 s_max, 1, 0, hk_n, g_n, dh, window, scale,
                                 st);
  return launch<float>(q, k, v, length, nullptr, out, nullptr, b, s_max, 1,
                       0, hk_n, g_n, dh, window, scale, st);
}

// The block variant: the dense kernel over one block of a cache, with no
// window (live cells: [0, length)), that also writes lse (B, Hq) fp32, the
// log-sum-exp of the scaled scores of the cells it read (-inf for a slot
// with none; its out is 0). Partials of disjoint blocks merge exactly
// (kernels/flash_decode.py: merge_partials).
int flash_decode_partial_launch(const void* q, const void* k, const void* v,
                                const void* length, void* out, void* lse,
                                int b, int s_max, int hk_n, int g_n, int dh,
                                float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, length, nullptr, out, l, b, s_max,
                                 1, 0, hk_n, g_n, dh, -1, scale, st);
  return launch<float>(q, k, v, length, nullptr, out, l, b, s_max, 1, 0,
                       hk_n, g_n, dh, -1, scale, st);
}

// The paged cache: k_pool/v_pool (N_blocks, blk, Hk, dh) contiguous,
// table (B, nb) int32 contiguous (-1 = unmapped); everything else as for
// flash_decode_launch, over S_max = nb * blk virtual cells.
int flash_decode_paged_launch(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* length, void* out, int b, int nb,
                              int blk, int n_blocks, int hk_n, int g_n,
                              int dh, int window, float scale, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, length, table, out,
                                 nullptr, b, nb * blk, blk, n_blocks, hk_n,
                                 g_n, dh, window, scale, st);
  return launch<float>(q, k_pool, v_pool, length, table, out, nullptr, b,
                       nb * blk, blk, n_blocks, hk_n, g_n, dh, window, scale,
                       st);
}

}  // extern "C"
