// PRIME int8 codec kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/int8_quant.py:
//   encode_hist / pseudograd_encode_hist (one kernel, `fused` flag) and
//   decode / decode_add (one kernel, `accumulate` flag).
// Every call takes all `rows` rows of a (rows, n) tensor at once (the
// ring quantizes one bucket per worker row); lo, width and scale are
// per-row device arrays, so no call needs a host sync.
//
// Bound: bytes. encode reads 4 (8 fused) bytes and writes 1 per element;
// decode reads 1 (5 with acc) and writes 4. The encode's deterministic
// histogram costs about 20 instructions per 32 elements, which on an H100
// keeps it at several times its byte bound (PERF.md). The design:
//   * codes = clip(floor((x - lo) / width), 0, 255) with a true IEEE
//     division (nvcc without --use_fast_math), as repro/kernels/ref.py
//     computes it: the Pallas body multiplies by 1/width, which can move
//     a code by one at a bucket edge;
//   * 64-bit element offsets throughout (one ring row here is GBs);
//   * 16-byte loads and stores where the row allows them;
//   * the 256-bin (sum, count) histogram is deterministic run to run and
//     uses no atomics at all: in each warp, __match_any_sync groups the
//     lanes that hold the same code, the group's lowest lane sums its
//     peers' values in lane order into its warp's own shared-memory
//     histogram; warp histograms combine in warp order into a per-block
//     partial, and a second kernel combines the partials in block order.
//     Counts are integers.
//   * decode keeps the row's 256-entry codebook in shared memory and
//     gathers directly (the TPU needed a one-hot matmul only because it
//     has no vector gather). decode_add may write in place (out == acc).
#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_BUCKETS 256
#define ENC_THREADS 256                      // == NUM_BUCKETS
#define ENC_WARPS (ENC_THREADS / 32)
#define ENC_ITERS 64                         // float4 loads per thread
#define ENC_TILE (ENC_THREADS * 4 * ENC_ITERS)  // elements per block
#define RED_GROUPS 4
#define DEC_THREADS 256                      // == NUM_BUCKETS
#define DEC_PER_THREAD 16
#define INVALID_CODE 0xFFFFFFFFu

// One element per lane into the warp's histogram, deterministically.
__device__ __forceinline__ void hist_round(float v, unsigned code, int lane,
                                           volatile float* stage,
                                           float* wsum, int* wcnt) {
  stage[lane] = v;
  __syncwarp();
  const unsigned peers = __match_any_sync(0xffffffffu, code);
  if (code != INVALID_CODE && lane == __ffs(peers) - 1) {
    float s = 0.0f;
    for (unsigned m = peers; m; m &= m - 1) s += stage[__ffs(m) - 1];
    wsum[code] += s;
    wcnt[code] += __popc(peers);
  }
  __syncwarp();
}

__device__ __forceinline__ unsigned encode_one(float v, float lo,
                                               float width) {
  float q = floorf((v - lo) / width);
  q = fminf(fmaxf(q, 0.0f), (float)(NUM_BUCKETS - 1));
  return (unsigned)q;
}

__global__ void __launch_bounds__(ENC_THREADS)
encode_hist_kernel(const float* __restrict__ x,
                   const float* __restrict__ anchor,
                   const float* __restrict__ lo,
                   const float* __restrict__ width,
                   const float* __restrict__ scale,
                   uint8_t* __restrict__ codes,
                   float* __restrict__ part_sum,
                   int* __restrict__ part_cnt,
                   long long n, int fused, int vec) {
  __shared__ float wsum[ENC_WARPS][NUM_BUCKETS];
  __shared__ int wcnt[ENC_WARPS][NUM_BUCKETS];
  __shared__ float stage[ENC_WARPS][32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.y;
  for (int i = tid; i < ENC_WARPS * NUM_BUCKETS; i += ENC_THREADS) {
    (&wsum[0][0])[i] = 0.0f;
    (&wcnt[0][0])[i] = 0;
  }
  __syncthreads();

  const float rlo = lo[row], rw = width[row];
  const float rs = fused ? scale[row] : 1.0f;
  const long long base = (long long)row * n;
  const float* xr = x + base;
  const float* ar = fused ? anchor + base : nullptr;
  uint8_t* cr = codes + base;
  const long long t0 = (long long)blockIdx.x * ENC_TILE;

  for (int it = 0; it < ENC_ITERS; ++it) {
    const long long i0 = t0 + ((long long)it * ENC_THREADS + tid) * 4;
    float v[4];
    unsigned c[4];
    if (vec && i0 + 4 <= n) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + i0);
      v[0] = xv.x; v[1] = xv.y; v[2] = xv.z; v[3] = xv.w;
      if (fused) {
        const float4 av = *reinterpret_cast<const float4*>(ar + i0);
        v[0] = (av.x - v[0]) * rs; v[1] = (av.y - v[1]) * rs;
        v[2] = (av.z - v[2]) * rs; v[3] = (av.w - v[3]) * rs;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = encode_one(v[j], rlo, rw);
      uchar4 cv;
      cv.x = (uint8_t)c[0]; cv.y = (uint8_t)c[1];
      cv.z = (uint8_t)c[2]; cv.w = (uint8_t)c[3];
      *reinterpret_cast<uchar4*>(cr + i0) = cv;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        if (i < n) {
          v[j] = fused ? (ar[i] - xr[i]) * rs : xr[i];
          c[j] = encode_one(v[j], rlo, rw);
          cr[i] = (uint8_t)c[j];
        } else {
          v[j] = 0.0f;
          c[j] = INVALID_CODE;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hist_round(v[j], c[j], lane, stage[warp], wsum[warp], wcnt[warp]);
  }
  __syncthreads();

  float s = 0.0f;
  int cnt = 0;
  for (int w = 0; w < ENC_WARPS; ++w) {   // warp order
    s += wsum[w][tid];
    cnt += wcnt[w][tid];
  }
  const long long p =
      ((long long)row * gridDim.x + blockIdx.x) * NUM_BUCKETS + tid;
  part_sum[p] = s;
  part_cnt[p] = cnt;
}

// Per-row combine of the block partials, in block order: RED_GROUPS
// groups of 256 threads each sum a contiguous range of blocks, then the
// group sums add in group order.
__global__ void __launch_bounds__(NUM_BUCKETS * RED_GROUPS)
hist_reduce_kernel(const float* __restrict__ part_sum,
                   const int* __restrict__ part_cnt,
                   float* __restrict__ sums, int* __restrict__ counts,
                   int nblocks) {
  __shared__ float gs[RED_GROUPS][NUM_BUCKETS];
  __shared__ int gc[RED_GROUPS][NUM_BUCKETS];
  const int row = blockIdx.x;
  const int bin = threadIdx.x % NUM_BUCKETS, g = threadIdx.x / NUM_BUCKETS;
  const int per = (nblocks + RED_GROUPS - 1) / RED_GROUPS;
  const int b0 = min(nblocks, g * per), b1 = min(nblocks, b0 + per);
  const long long off = (long long)row * nblocks * NUM_BUCKETS + bin;
  const float* ps = part_sum + off;
  const int* pc = part_cnt + off;
  float s = 0.0f;
  int c = 0;
  int b = b0;
  for (; b + 8 <= b1; b += 8) {    // eight loads in flight, summed in order
    float t[8];
    int u[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      t[k] = ps[(long long)(b + k) * NUM_BUCKETS];
      u[k] = pc[(long long)(b + k) * NUM_BUCKETS];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) { s += t[k]; c += u[k]; }
  }
  for (; b < b1; ++b) {
    s += ps[(long long)b * NUM_BUCKETS];
    c += pc[(long long)b * NUM_BUCKETS];
  }
  gs[g][bin] = s;
  gc[g][bin] = c;
  __syncthreads();
  if (g == 0) {
    s = 0.0f;
    c = 0;
    for (int k = 0; k < RED_GROUPS; ++k) { s += gs[k][bin]; c += gc[k][bin]; }
    sums[row * NUM_BUCKETS + bin] = s;
    counts[row * NUM_BUCKETS + bin] = c;
  }
}

__device__ __forceinline__ float4 gather4(const float* book, unsigned w) {
  return make_float4(book[w & 0xff], book[(w >> 8) & 0xff],
                     book[(w >> 16) & 0xff], book[w >> 24]);
}

// out = codebook[codes] (+ acc). out may alias acc: each element is read
// and written by one thread, so neither is __restrict__.
__global__ void __launch_bounds__(DEC_THREADS)
decode_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ codebook, const float* acc,
              float* out, long long n, int accumulate, int vec) {
  __shared__ float book[NUM_BUCKETS];
  const int row = blockIdx.y;
  book[threadIdx.x] = codebook[row * NUM_BUCKETS + threadIdx.x];
  __syncthreads();
  const long long i0 =
      ((long long)blockIdx.x * DEC_THREADS + threadIdx.x) * DEC_PER_THREAD;
  if (i0 >= n) return;
  const long long base = (long long)row * n;
  if (vec && i0 + DEC_PER_THREAD <= n) {
    const uint4 cv = *reinterpret_cast<const uint4*>(codes + base + i0);
    const unsigned words[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float4 o = gather4(book, words[q]);
      const long long e = base + i0 + 4 * q;
      if (accumulate) {
        const float4 a = *reinterpret_cast<const float4*>(acc + e);
        o.x = a.x + o.x; o.y = a.y + o.y; o.z = a.z + o.z; o.w = a.w + o.w;
      }
      *reinterpret_cast<float4*>(out + e) = o;
    }
  } else {
    for (int j = 0; j < DEC_PER_THREAD; ++j) {
      const long long i = i0 + j;
      if (i >= n) break;
      float o = book[codes[base + i]];
      if (accumulate) o = acc[base + i] + o;
      out[base + i] = o;
    }
  }
}

extern "C" {

long long int8_encode_tile(void) { return ENC_TILE; }

// codes (rows, n) u8; part_sum/part_cnt (rows, nblocks, 256) scratch with
// nblocks = ceil(n / int8_encode_tile()); sums/counts (rows, 256).
int int8_encode_hist_launch(const void* x, const void* anchor,
                            const void* lo, const void* width,
                            const void* scale, void* codes, void* part_sum,
                            void* part_cnt, void* sums, void* counts,
                            long long n, int rows, int fused, int vec,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nblocks = (n + ENC_TILE - 1) / ENC_TILE;
  dim3 grid((unsigned)nblocks, (unsigned)rows);
  encode_hist_kernel<<<grid, ENC_THREADS, 0, s>>>(
      (const float*)x, (const float*)anchor, (const float*)lo,
      (const float*)width, (const float*)scale, (uint8_t*)codes,
      (float*)part_sum, (int*)part_cnt, n, fused, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_reduce_kernel<<<rows, NUM_BUCKETS * RED_GROUPS, 0, s>>>(
      (const float*)part_sum, (const int*)part_cnt, (float*)sums,
      (int*)counts, (int)nblocks);
  return (int)cudaGetLastError();
}

int int8_decode_launch(const void* codes, const void* codebook,
                       const void* acc, void* out, long long n, int rows,
                       int accumulate, int vec, void* stream) {
  const long long per_block = (long long)DEC_THREADS * DEC_PER_THREAD;
  dim3 grid((unsigned)((n + per_block - 1) / per_block), (unsigned)rows);
  decode_kernel<<<grid, DEC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)codebook, (const float*)acc,
      (float*)out, n, accumulate, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
