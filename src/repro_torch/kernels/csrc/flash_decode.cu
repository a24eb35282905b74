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
// At B=4, 512 live cells, Hk=8, dh=128 in bf16 that is 8.4 MB per layer,
// about 2.5 us at the H100's 3.35 TB/s; q, the fp32 partials and the output
// are a few hundred KB. There is one FMA per K or V element read, far below
// the card's compute roof.
//
// Design. The TPU grid walks S in order and carries (m, l, acc) across it;
// Hopper blocks run in no order, and B * Hk blocks (32 at the serving
// shape) would fill a quarter of the 132 SMs. So S is split:
//   * split kernel, one block per (32-cell split, kv head, slot): a few
//     lanes per cell load its K and V rows in 16-byte chunks, all loads of
//     the block issued before any is used (the block waits for memory about
//     once); scores of the G query heads (shuffle reduction), a local
//     softmax (m, l) and the p-weighted sum of V rows follow, in fp32, and
//     it writes fp32 partials (m, l, acc[G, dh]). Dead cells are never
//     read, and a split with no live cell writes an empty partial and
//     leaves.
//   * combine kernel, one block per (slot, query head): rescales the
//     partials to the global max, sums, divides by max(l, 1e-30) so an
//     empty slot comes back exactly 0, and writes q's dtype.
// The scale dh^-0.5 is applied to the fp32 score after the dot, and query
// head h reads kv head h / G, as on the TPU.
//
// Paged. The split kernel is templated on how a cell's K/V row is
// addressed and nothing else: a paged block first loads the table entries
// its 32 cells touch (at most 32 / blk + 1) into shared memory, then runs
// the dense block's code with the row offset taken from them (64-bit).
// Masks come from the virtual cell, as in the dense kernel. With one
// accumulation order the paged kernel is bitwise equal to the dense kernel
// on the gathered view, for any block size. The table's bytes are
// negligible beside the K/V rows, so the bound is the dense kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // split kernel block size
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 32;      // cache cells per split

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
// block, from the split's table entries in shared memory (first = the
// split's first virtual block).
template <bool kPaged>
__device__ __forceinline__ size_t cell_row(int b, int cell, int s_max,
                                           int blk, int first,
                                           const int* tbl_s) {
  if constexpr (kPaged)
    return (size_t)tbl_s[cell / blk - first] * blk + cell % blk;
  else
    return (size_t)b * s_max + cell;
}

// One block per (split, kv head, slot). LPC lanes share a cell, each lane
// holding one 8-element chunk of the cell's K and V rows (LPC = the power of
// two >= dh / 8); a warp covers 32 / LPC cells per pass. Every K and V load
// of the block is issued before any is used, so the block waits for memory
// about once. kPaged selects the row addressing (cell_row).
template <typename T, int LPC, bool kPaged>
__global__ void __launch_bounds__(kThreads) split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ length,
    const int* __restrict__ table, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int s_max, int blk, int n_blocks,
    int hk_n, int g_n, int dh, int window, float scale) {
  constexpr int kCpw = 32 / LPC;                    // cells per warp per pass
  constexpr int kGroups = kWarps * kCpw;            // cells per pass
  constexpr int kPasses = (kCells + kGroups - 1) / kGroups;
  extern __shared__ float smem[];
  float* q_s = smem;                    // (G, dh) query rows, fp32
  float* p_s = q_s + g_n * dh;          // (G, kCells) scores, then probs
  __shared__ int live_s[kCells];
  __shared__ int tbl_s[kCells];                // paged: the split's blocks
  __shared__ float red_s[kGroups * LPC * 8];   // one head's per-group sums

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int len = length[b];
  const int c0 = split * kCells;
  const int n_cells = min(kCells, s_max - c0);
  const size_t part = ((size_t)(b * hk_n + hk) * gridDim.x + split) * g_n;
  float* acc_out = part_acc + part * dh;
  float* ml_out = part_ml + part * 2;

  // paged: the table entries of virtual blocks first .. last, loaded once
  // by the threads that do not test liveness; -1 or out of the pool -> 0
  const int first = kPaged ? c0 / blk : 0;
  if constexpr (kPaged) {
    const int i = threadIdx.x - kCells;
    if (i >= 0 && i <= (c0 + n_cells - 1) / blk - first) {
      const int t = table[(size_t)b * (s_max / blk) + first + i];
      tbl_s[i] = t > 0 && t < n_blocks ? t : 0;
    }
  }
  int mine = 0;
  if (threadIdx.x < kCells) {
    mine = threadIdx.x < n_cells && live(c0 + threadIdx.x, len, s_max, window);
    live_s[threadIdx.x] = mine;
  }
  if (!__syncthreads_or(mine)) {        // no live cell: empty partial
    for (int i = threadIdx.x; i < g_n * dh; i += kThreads) acc_out[i] = 0.f;
    for (int g = threadIdx.x; g < g_n; g += kThreads) {
      ml_out[2 * g] = kNegInf;
      ml_out[2 * g + 1] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = warp * kCpw + lane / LPC, sl = lane % LPC;
  const bool chunk = sl < dh / 8;       // this lane holds channels sl*8..+8
  const size_t row = (size_t)hk_n * dh;          // elements between cells
  const T* k_h = k + (size_t)hk * dh + sl * 8;
  const T* v_h = v + (size_t)hk * dh + sl * 8;
  float kf[kPasses][8], vf[kPasses][8];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = p * kGroups + group;
    if (chunk && c < n_cells && live_s[c]) {
      const size_t off =
          cell_row<kPaged>(b, c0 + c, s_max, blk, first, tbl_s) * row;
      load8(k_h + off, kf[p]);
      load8(v_h + off, vf[p]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) kf[p][j] = vf[p][j] = 0.f;
    }
  }

  // this kv head's G query heads: q rows h = hk * G + g
  const T* q_b = q + ((size_t)b * hk_n + hk) * g_n * dh;
  for (int i = threadIdx.x; i < g_n * dh; i += kThreads) q_s[i] = to_f(q_b[i]);
  __syncthreads();

  // scores q . k * scale, reduced over the LPC lanes of a cell
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int c = p * kGroups + group;
    const bool in = c < n_cells && live_s[c];
    for (int g = 0; g < g_n; ++g) {
      float d = 0.f;
      if (in && chunk) {
        const float* qg = q_s + g * dh + sl * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qg[j], kf[p][j], d);
      }
#pragma unroll
      for (int off = LPC / 2; off > 0; off >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, off);
      if (sl == 0 && c < n_cells) p_s[g * kCells + c] = in ? d * scale : kNegInf;
    }
  }
  __syncthreads();

  // local softmax of each query head over the split: one warp per head
  for (int g = warp; g < g_n; g += kWarps) {
    float* pg = p_s + g * kCells;
    float m = kNegInf;
    for (int c = lane; c < n_cells; c += 32) m = fmaxf(m, pg[c]);
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int c = lane; c < n_cells; c += 32) {
      const float p = live_s[c] ? expf(pg[c] - m) : 0.f;
      pg[c] = p;
      l += p;
    }
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ml_out[2 * g] = m;
      ml_out[2 * g + 1] = l;
    }
  }
  __syncthreads();

  // p-weighted V: each lane sums its cells' V chunks, then the block sums
  // the groups' partials channel by channel, one query head at a time
  for (int g = 0; g < g_n; ++g) {
    float a[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] = 0.f;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int c = p * kGroups + group;
      const float w = c < n_cells ? p_s[g * kCells + c] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) a[j] = fmaf(w, vf[p][j], a[j]);
    }
    if (chunk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red_s[group * LPC * 8 + sl * 8 + j] = a[j];
    }
    __syncthreads();
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float sum = 0.f;
      for (int grp = 0; grp < kGroups; ++grp) sum += red_s[grp * LPC * 8 + d];
      acc_out[g * dh + d] = sum;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int n_splits, int g_n,
                               int dh) {
  // block r = (b * Hk + hk) * G + g = b * Hq + h: one output row
  const int r = blockIdx.x;
  const int bh = r / g_n, g = r % g_n;
  const float* ml = part_ml + ((size_t)bh * n_splits * g_n + g) * 2;
  const float* acc = part_acc + ((size_t)bh * n_splits * g_n + g) * dh;
  const size_t step = (size_t)g_n;      // partials of one row, split-major
  float m_all = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) m_all = fmaxf(m_all, ml[s * step * 2]);
  float l_all = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s)
    l_all += ml[s * step * 2 + 1] * expf(ml[s * step * 2] - m_all);
  const float denom = fmaxf(l_all, 1e-30f);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_splits; ++s)
      a = fmaf(acc[s * step * dh + d], expf(ml[s * step * 2] - m_all), a);
    store(out + (size_t)r * dh + d, a / denom);
  }
}

// table == nullptr: dense cache with s_max cells per slot. Otherwise a
// pool of n_blocks blocks of blk cells and s_max = nb * blk.
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* length,
           const void* table, void* part_acc, void* part_ml, void* out,
           int b, int s_max, int blk, int n_blocks, int hk_n, int g_n,
           int dh, int window, float scale, cudaStream_t stream) {
  const int n_splits = (s_max + kCells - 1) / kCells;
  const size_t smem = (size_t)g_n * (dh + kCells) * sizeof(float);
  const dim3 grid(n_splits, hk_n, b);
  int lpc = 1;
  while (lpc * 8 < dh) lpc <<= 1;       // lanes per cell (dh <= 256: <= 32)
#define FLASH_DECODE_SPLIT_PAGED(LPC, PAGED)                                 \
  split_kernel<T, LPC, PAGED><<<grid, kThreads, smem, stream>>>(             \
      static_cast<const T*>(q), static_cast<const T*>(k),                    \
      static_cast<const T*>(v), static_cast<const int*>(length),             \
      static_cast<const int*>(table), static_cast<float*>(part_acc),         \
      static_cast<float*>(part_ml), s_max, blk, n_blocks, hk_n, g_n, dh,     \
      window, scale)
#define FLASH_DECODE_SPLIT(LPC)                                              \
  if (table) FLASH_DECODE_SPLIT_PAGED(LPC, true);                            \
  else FLASH_DECODE_SPLIT_PAGED(LPC, false)
  switch (lpc) {
    case 1: FLASH_DECODE_SPLIT(1); break;
    case 2: FLASH_DECODE_SPLIT(2); break;
    case 4: FLASH_DECODE_SPLIT(4); break;
    case 8: FLASH_DECODE_SPLIT(8); break;
    case 16: FLASH_DECODE_SPLIT(16); break;
    default: FLASH_DECODE_SPLIT(32); break;
  }
#undef FLASH_DECODE_SPLIT
#undef FLASH_DECODE_SPLIT_PAGED
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((dh + 31) / 32) * 32;
  combine_kernel<T><<<b * hk_n * g_n, threads, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), n_splits, g_n, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Cache cells per split: the wrapper sizes the fp32 partials with it.
int flash_decode_cells() { return kCells; }

// q (B, 1, Hq, dh), k/v (B, S_max, Hk, dh) contiguous, bf16 (is_bf16 = 1)
// or fp32; length (B,) int32; part_acc (B, Hk, n_splits, G, dh) and
// part_ml (B, Hk, n_splits, G, 2) fp32 scratch; out like q. window < 0
// means no sliding window. Returns cudaGetLastError() after the launches.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* length, void* part_acc, void* part_ml,
                        void* out, int b, int s_max, int hk_n, int g_n,
                        int dh, int window, float scale, int is_bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, length, nullptr, part_acc, part_ml,
                                 out, b, s_max, 1, 0, hk_n, g_n, dh, window,
                                 scale, st);
  return launch<float>(q, k, v, length, nullptr, part_acc, part_ml, out, b,
                       s_max, 1, 0, hk_n, g_n, dh, window, scale, st);
}

// The paged cache: k_pool/v_pool (N_blocks, blk, Hk, dh) contiguous,
// table (B, nb) int32 contiguous (-1 = unmapped); everything else as for
// flash_decode_launch, with n_splits over S_max = nb * blk cells.
int flash_decode_paged_launch(const void* q, const void* k_pool,
                              const void* v_pool, const void* table,
                              const void* length, void* part_acc,
                              void* part_ml, void* out, int b, int nb,
                              int blk, int n_blocks, int hk_n, int g_n,
                              int dh, int window, float scale, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, length, table, part_acc,
                                 part_ml, out, b, nb * blk, blk, n_blocks,
                                 hk_n, g_n, dh, window, scale, st);
  return launch<float>(q, k_pool, v_pool, length, table, part_acc, part_ml,
                       out, b, nb * blk, blk, n_blocks, hk_n, g_n, dh, window,
                       scale, st);
}

}  // extern "C"
