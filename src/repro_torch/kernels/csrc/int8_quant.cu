// PRIME int8 codec kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/int8_quant.py:
//   encode_hist / pseudograd_encode_hist (_encode_hist_call, :141; one
//   kernel here with a `fused` flag) and decode / decode_add
//   (_decode_call, :243; one kernel with an `accumulate` flag).
// Every call takes all `rows` rows of a (rows, n) tensor at once (the
// ring quantizes one bucket per worker row); lo, width and scale are
// per-row device arrays, so no call needs a host sync.
//
// Bound: bytes. encode reads 4 (8 fused) bytes and writes 1 per element;
// decode reads 1 (5 with acc) and writes 4. On an NVIDIA H100 80GB HBM3
// at 700 W (chip_smoke.py, the ring's 2 x 378.5 M hop) the fused encode
// runs at 1.2x that bound and the plain one at 1.7x, where the
// histogram's instructions show beside half the bytes; PERF.md holds
// each kernel's times.
//
// Encode:
//   * codes = clip(floor((v - lo) / width), 0, 255) with a true IEEE
//     division (nvcc without --use_fast_math), as repro/kernels/ref.py
//     computes it (the Pallas body multiplies by 1/width, which can move
//     a code by one at a bucket edge); fused: v = (anchor - theta) * scale;
//   * 64-bit element offsets throughout (one ring row is GBs), 16-byte
//     loads and stores where the row allows them, ENC_UNROLL loads in
//     flight per thread before any is used;
//   * the 256-bin (sum, count) histogram is integer, so shared and global
//     atomics give the same bits in every order: a call is repeatable bit
//     for bit whatever the grid's schedule. Sums are fixed point:
//     per row, e is the exponent with r = max(|lo|, |lo + 256 width|)
//     < 2^e (clamped to [FIX_EXP_MIN, 128]), and every element with
//     |v| < lim = 2^(e+1) (the codes' whole range, and clipped values up
//     to 2r) gives the integer term q = round(v * 2^(FIX_BITS-1-e)),
//     |q| < 2^46. Only 32-bit shared atomics are native (a 64-bit shared
//     add compiles to a compare-and-swap loop, which collides on skewed
//     rows), so each warp adds q's low 23 bits and its signed high part
//     into its own 32-bit words, and folds them into its 64-bit sums
//     every ENC_UNROLL float4s a lane (256 terms a word: none can
//     overflow). Counts are 32-bit increments, which the compiler
//     aggregates over a warp (ATOMS.POPC.INC). A warp whose 128 elements
//     of one float4 load share one code (a constant row) sums them by
//     REDUX and adds once: 32 lanes on one word would run one after
//     another. Elements with |v| >= lim are clipped far outliers, code 0
//     or 255 by their sign: the warp's ballot sends them, rarely, to two
//     fp64 sums of lane 0 in element order; warps then blocks combine
//     those in a fixed order, so they are repeatable too;
//   * the cross-block combine is integer: each block (ENC_TILE = 2^16
//     elements, so its sums stay under 2^62) splits its sums into a low
//     32-bit part and a signed high part and adds them, and its counts,
//     with global atomics into a (rows, 3, 256) int64 array the wrapper
//     zeroes (the low totals stay under 2^47 and the high ones under
//     2^45 in magnitude for any n < 2^31). hist_finish_kernel turns each
//     row's totals into fp64 once (one rounding), scales by the power of
//     two, adds the fp64 far sums to buckets 0 and 255 and rounds to
//     fp32.
//   Error of a bucket's sum: each term is off by at most 2^(e-46) <=
//   2^-45 r (2^-126 where e is clamped), the far sums by fp64 rounding,
//   the result by one fp32 rounding: |sum - exact| <= count 2^-45 r +
//   2^-24 |exact| + count 2^-53 sum|x|. The check of the tests and of
//   chip_smoke.py, |kernel - plain| <= 1e-4 sum|x| of the bucket, holds
//   wherever the bucket's mean |x| is at least 2^-45 r / 1e-4, about
//   3e-10 r: every bucket of a continuous distribution, and exact zeros
//   (which add exactly 0). Terms under 2^-46 r round to 0.
//   Skewed rows collide: a heavy-tailed row puts most of a warp on two
//   codes, whose atomics then serialize (PERF.md has its time).
//
// Decode keeps the row's 256-entry codebook in shared memory and gathers
// directly (the TPU needed a one-hot matmul only because it has no vector
// gather). decode_add may write in place (out == acc).
#include <cuda_runtime.h>
#include <stdint.h>

#define NUM_BUCKETS 256
#define ENC_THREADS 256                      // == NUM_BUCKETS
#define ENC_WARPS (ENC_THREADS / 32)
#define ENC_ITERS 64                         // float4 loads per thread
#define ENC_UNROLL 2                         // float4 loads in flight
#define ENC_TILE (ENC_THREADS * 4 * ENC_ITERS)  // 2^16 elements per block
#define FIX_BITS 46                          // |q| < 2^46
#define FIX_EXP_MIN (-80)                    // 2^(FIX_BITS-1-e) stays normal
#define LO_BITS 23                           // a term's unsigned low part
#define DEC_THREADS 256                      // == NUM_BUCKETS
#define DEC_PER_THREAD 16
#define FULL_MASK 0xffffffffu

struct RowFix {
  float scale;   // 2^shift: fixed-point units per unit of v
  float lim;     // 2^(e+1) (inf for e = 128): |v| >= lim takes the far path
  int shift;     // FIX_BITS - 1 - e
};

// The row's fixed-point format, computed alike by both kernels.
__device__ __forceinline__ RowFix row_fix(float lo, float width) {
  const float r = fmaxf(fabsf(lo), fabsf(lo + 256.0f * width));
  int e = 128;
  if (r < INFINITY) frexpf(r, &e);          // r < 2^e; r = 0 gives e = 0
  e = max(e, FIX_EXP_MIN);
  RowFix f;
  f.shift = FIX_BITS - 1 - e;
  f.scale = ldexpf(1.0f, f.shift);
  f.lim = ldexpf(1.0f, e + 1);
  return f;
}

__device__ __forceinline__ unsigned encode_one(float v, float lo,
                                               float width) {
  const float d = v - lo;
  float q = 0.0f;                  // 0 / width is 0: a constant row skips
  if (d != 0.0f) q = floorf(d / width);  // the division's slow path
  q = fminf(fmaxf(q, 0.0f), (float)(NUM_BUCKETS - 1));
  return (unsigned)q;
}

// A term into the warp's 32-bit words: its low LO_BITS bits (unsigned),
// its signed high part, and k elements to the block's count.
__device__ __forceinline__ void add_term(unsigned* wlo, int* whi,
                                         unsigned* bcnt, unsigned c,
                                         unsigned ql, int qh, unsigned k) {
  atomicAdd(&wlo[c], ql);
  atomicAdd(&whi[c], qh);
  atomicAdd(&bcnt[c], k);
}

// Far outliers (rare) into lane 0's fp64 sums, in lane order.
__device__ __forceinline__ void far_add(float v, bool far, int lane,
                                        double& eneg, double& epos) {
  for (unsigned m = __ballot_sync(FULL_MASK, far); m; m &= m - 1) {
    const float f = __shfl_sync(FULL_MASK, v, __ffs(m) - 1);
    if (lane == 0) {
      if (f < 0.0f) eneg += f; else epos += f;
    }
  }
}

__global__ void __launch_bounds__(ENC_THREADS)
encode_hist_kernel(const float* __restrict__ x,
                   const float* __restrict__ anchor,
                   const float* __restrict__ lo,
                   const float* __restrict__ width,
                   const float* __restrict__ scale,
                   uint8_t* __restrict__ codes,
                   unsigned long long* __restrict__ acc,
                   double* __restrict__ part_far,
                   long long n, int fused, int vec) {
  __shared__ unsigned wlo[ENC_WARPS][NUM_BUCKETS];
  __shared__ int whi[ENC_WARPS][NUM_BUCKETS];
  __shared__ long long wsum[ENC_WARPS][NUM_BUCKETS];
  __shared__ unsigned bcnt[NUM_BUCKETS];
  __shared__ double wfar[ENC_WARPS][2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.y;
  for (int w = 0; w < ENC_WARPS; ++w) {
    wlo[w][tid] = 0u;
    whi[w][tid] = 0;
    wsum[w][tid] = 0ll;
  }
  bcnt[tid] = 0u;
  __syncthreads();

  const float rlo = lo[row], rw = width[row];
  const float rs = fused ? scale[row] : 1.0f;
  const RowFix fx = row_fix(rlo, rw);
  const long long base = (long long)row * n;
  const float* xr = x + base;
  const float* ar = fused ? anchor + base : nullptr;
  uint8_t* cr = codes + base;
  const long long t0 = (long long)blockIdx.x * ENC_TILE;
  double eneg = 0.0, epos = 0.0;            // lane 0's far sums

  for (int it = 0; it < ENC_ITERS; it += ENC_UNROLL) {
    float v[ENC_UNROLL][4];
    int nv[ENC_UNROLL];                      // valid elements of the float4
#pragma unroll
    for (int u = 0; u < ENC_UNROLL; ++u) {   // all loads first
      const long long i0 =
          t0 + ((long long)(it + u) * ENC_THREADS + tid) * 4;
      const long long left = n - i0;
      nv[u] = left >= 4 ? 4 : (left > 0 ? (int)left : 0);
      if (vec && nv[u] == 4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + i0);
        v[u][0] = xv.x; v[u][1] = xv.y; v[u][2] = xv.z; v[u][3] = xv.w;
        if (fused) {
          const float4 av = *reinterpret_cast<const float4*>(ar + i0);
          v[u][0] = (av.x - v[u][0]) * rs; v[u][1] = (av.y - v[u][1]) * rs;
          v[u][2] = (av.z - v[u][2]) * rs; v[u][3] = (av.w - v[u][3]) * rs;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[u][j] = 0.0f;
          if (j < nv[u])
            v[u][j] = fused ? (ar[i0 + j] - xr[i0 + j]) * rs : xr[i0 + j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ENC_UNROLL; ++u) {
      const long long i0 =
          t0 + ((long long)(it + u) * ENC_THREADS + tid) * 4;
      unsigned c[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = encode_one(v[u][j], rlo, rw);
      if (vec && nv[u] == 4) {
        uchar4 cv;
        cv.x = (uint8_t)c[0]; cv.y = (uint8_t)c[1];
        cv.z = (uint8_t)c[2]; cv.w = (uint8_t)c[3];
        *reinterpret_cast<uchar4*>(cr + i0) = cv;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nv[u]) cr[i0 + j] = (uint8_t)c[j];
      }
      unsigned ql[4];
      int qh[4];
      bool far[4], anyfar = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = j < nv[u];
        far[j] = in && !(fabsf(v[u][j]) < fx.lim);
        anyfar |= far[j];
        const long long q =
            (in && !far[j]) ? __float2ll_rn(v[u][j] * fx.scale) : 0;
        ql[j] = (unsigned)q & ((1u << LO_BITS) - 1);
        qh[j] = (int)(q >> LO_BITS);
      }
      // A warp whose 128 elements share one code (a constant row) sums
      // them by REDUX and adds once; 32 lanes on one word would collide.
      const unsigned c0 = __shfl_sync(FULL_MASK, c[0], 0);
      if (__all_sync(FULL_MASK, nv[u] == 4 && c[0] == c0 && c[1] == c0 &&
                                    c[2] == c0 && c[3] == c0)) {
        const unsigned sl = __reduce_add_sync(      // < 128 * 2^23
            FULL_MASK, ql[0] + ql[1] + ql[2] + ql[3]);
        const int sh = __reduce_add_sync(
            FULL_MASK, qh[0] + qh[1] + qh[2] + qh[3]);
        if (lane == 0) add_term(wlo[warp], whi[warp], bcnt, c0, sl, sh, 128u);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nv[u])
            add_term(wlo[warp], whi[warp], bcnt, c[j], ql[j], qh[j], 1u);
      }
      if (__any_sync(FULL_MASK, anyfar)) {
#pragma unroll
        for (int j = 0; j < 4; ++j) far_add(v[u][j], far[j], lane, eneg, epos);
      }
    }
    // The warp's 32-bit words into its 64-bit sums, each lane 8 buckets.
    // Between two flushes a word takes at most 8 x 32 = 256 terms: low
    // parts < 256 * 2^23 = 2^31, high parts in [-2^31, 2^31).
    __syncwarp();
#pragma unroll
    for (int k = 0; k < NUM_BUCKETS / 32; ++k) {
      const int b = lane + 32 * k;
      wsum[warp][b] += (long long)whi[warp][b] * (1ll << LO_BITS)
                       + (long long)wlo[warp][b];
      wlo[warp][b] = 0u;
      whi[warp][b] = 0;
    }
    __syncwarp();
  }
  if (lane == 0) {
    wfar[warp][0] = eneg;
    wfar[warp][1] = epos;
  }
  __syncthreads();

  // The block's words into the row's global integer sums: low 32 bits,
  // signed high part, count. Integer adds: any block order, same bits.
  long long s = 0;                           // |s| < 2^16 * 2^46
  for (int w = 0; w < ENC_WARPS; ++w) s += wsum[w][tid];
  const unsigned cnt = bcnt[tid];
  unsigned long long* g = acc + (long long)row * 3 * NUM_BUCKETS;
  if (cnt) {
    atomicAdd(&g[tid], (unsigned long long)(s & 0xffffffffll));
    atomicAdd(&g[NUM_BUCKETS + tid], (unsigned long long)(s >> 32));
    atomicAdd(&g[2 * NUM_BUCKETS + tid], (unsigned long long)cnt);
  }
  if (tid < 2) {                             // far sums in warp order
    double f = 0.0;
    for (int w = 0; w < ENC_WARPS; ++w) f += wfar[w][tid];
    part_far[((long long)row * gridDim.x + blockIdx.x) * 2 + tid] = f;
  }
}

// Per row: the integer words to fp32 sums and int32 counts; the blocks'
// far sums add in a fixed order (a strided pass, then a tree).
__global__ void __launch_bounds__(NUM_BUCKETS)
hist_finish_kernel(const unsigned long long* __restrict__ acc,
                   const double* __restrict__ part_far,
                   const float* __restrict__ lo,
                   const float* __restrict__ width,
                   float* __restrict__ sums, int* __restrict__ counts,
                   int nblocks) {
  __shared__ double red[2][NUM_BUCKETS];
  const int row = blockIdx.x, tid = threadIdx.x;
  const double* pf = part_far + (long long)row * nblocks * 2;
  double fneg = 0.0, fpos = 0.0;
  for (int b = tid; b < nblocks; b += NUM_BUCKETS) {
    fneg += pf[2 * b];
    fpos += pf[2 * b + 1];
  }
  red[0][tid] = fneg;
  red[1][tid] = fpos;
  __syncthreads();
  for (int h = NUM_BUCKETS / 2; h; h >>= 1) {
    if (tid < h) {
      red[0][tid] += red[0][tid + h];
      red[1][tid] += red[1][tid + h];
    }
    __syncthreads();
  }
  const RowFix fx = row_fix(lo[row], width[row]);
  const unsigned long long* g = acc + (long long)row * 3 * NUM_BUCKETS;
  const double fixed = (double)(long long)g[NUM_BUCKETS + tid] * 4294967296.0
                       + (double)g[tid];
  double s = ldexp(fixed, -fx.shift);        // exact: a power of two
  if (tid == 0) s += red[0][0];
  if (tid == NUM_BUCKETS - 1) s += red[1][0];
  sums[row * NUM_BUCKETS + tid] = (float)s;
  counts[row * NUM_BUCKETS + tid] = (int)g[2 * NUM_BUCKETS + tid];
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

// codes (rows, n) u8; acc (rows, 3, 256) int64 zeroed by the caller;
// part_far (rows, nblocks, 2) fp64 scratch with
// nblocks = ceil(n / int8_encode_tile()); sums/counts (rows, 256).
int int8_encode_hist_launch(const void* x, const void* anchor,
                            const void* lo, const void* width,
                            const void* scale, void* codes, void* acc,
                            void* part_far, void* sums, void* counts,
                            long long n, int rows, int fused, int vec,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long nblocks = (n + ENC_TILE - 1) / ENC_TILE;
  dim3 grid((unsigned)nblocks, (unsigned)rows);
  encode_hist_kernel<<<grid, ENC_THREADS, 0, s>>>(
      (const float*)x, (const float*)anchor, (const float*)lo,
      (const float*)width, (const float*)scale, (uint8_t*)codes,
      (unsigned long long*)acc, (double*)part_far, n, fused, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hist_finish_kernel<<<rows, NUM_BUCKETS, 0, s>>>(
      (const unsigned long long*)acc, (const double*)part_far,
      (const float*)lo, (const float*)width, (float*)sums, (int*)counts,
      (int)nblocks);
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
