// Gumbel sampling over rows of logits, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of ocrl_tpu/ops/gumbel.py:
//   gumbel_soft  <- _soft_kernel (launched by _soft_pallas):
//       y[r, :] = softmax((logits[r, :] + g[r, :]) / tau)
//   gumbel_ids   <- _ids_kernel (launched by _ids_pallas):
//       ids[r]  = argmax(logits[r, :] + g[r, :])   (first index on ties;
//                 NaN ranks above every number, as in jnp.argmax)
// with g = -log(-log(u) + tiny), u uniform strictly inside (0, 1), made in
// the kernel. The TPU draws its bits with the core's own generator seeded by
// seed + program_id; a GPU has none, so here the bits come from a
// counter-based Philox4x32-10 keyed by (seed, stream) and counted by
// (column / 4, row): a value depends on the seed and its position only, not
// on the launch shape. The soft and the id kernels use two streams, as the
// TPU kernel offsets the ids' seed by 0x5E3779B9.
//
// What bounds them: at the SLATE training step (R = 24 * 16 * 16 = 6144
// rows of V = 4096) gumbel_soft reads and writes 100.7 MB each and
// gumbel_ids reads 100.7 MB and writes 24 KB; the work per value (one Philox
// call per four values, two logs, one exp) is far below what the card does
// in the time those bytes take, so both are bound by device-memory bytes.
//
// Design: one block per row. The row lives in registers (G float4 per
// thread, e.g. 256 threads x 16 values at V = 4096), so the logits are read
// once, with 16-byte loads, and y is written once: noise, row max, exp-sum
// and the write are one pass over device memory. Block reductions go through
// warp shuffles and one word per warp in shared memory.
//
// Two options for checks: `noise` (not null) makes the kernel read the field
// g instead of drawing it, and `g_out` (not null) makes it also write the
// field it drew or read, so that its output can be held against the plain
// version fed the same field. Both are null on the timed path.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kIdsStream = 0x5E3779B9u;

struct Key {
  uint32_t lo, hi;
};

// Philox4x32-10 (Salmon et al., SC'11), the Random123 round and key schedule.
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, Key k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i > 0) {
      k.lo += kW0;
      k.hi += kW1;
    }
    const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
    const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.lo, lo1, hi0 ^ c.w ^ k.hi, lo0);
  }
  return c;
}

// 23 random bits -> (2m + 1) * 2^-24: exact in fp32, from 2^-24 to
// 1 - 2^-24, so u is never 0 or 1 and -log(u) is never 0 or infinite.
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  const float u = (static_cast<float>(bits >> 9) + 0.5f) * 1.1920928955078125e-07f;
  return -logf(-logf(u) + 1.17549435e-38f);
}

__device__ __forceinline__ float4 gumbel4(Key key, uint32_t col4, uint32_t row) {
  const uint4 r = philox4x32_10(make_uint4(col4, row, 0u, 0u), key);
  return make_float4(gumbel_of(r.x), gumbel_of(r.y), gumbel_of(r.z),
                     gumbel_of(r.w));
}

__device__ __forceinline__ Key key_of(const int64_t* seed, uint32_t stream) {
  const uint64_t s = static_cast<uint64_t>(*seed);
  return Key{static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32) + stream};
}

// The field g of one float4 of the row: drawn, or read from `noise`; also
// written to `g_out` when it is given.
__device__ __forceinline__ float4 field(const float4* noise, float4* g_out,
                                        Key key, uint32_t c4, uint32_t row) {
  const float4 g = noise ? noise[c4] : gumbel4(key, c4, row);
  if (g_out) g_out[c4] = g;
  return g;
}

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) x = fmaxf(x, red[w]);
  __syncthreads();   // red is reused by the next reduction
  return x;
}

__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) x += red[w];
  return x;
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
gumbel_soft_kernel(const float* __restrict__ logits,
                   const float* __restrict__ noise, float* __restrict__ y,
                   float* __restrict__ g_out, const int64_t* __restrict__ seed,
                   int V, float tau) {
  __shared__ float red[kMaxThreads / 32];
  const uint32_t row = blockIdx.x;
  const int v4 = V / 4;
  const size_t off = static_cast<size_t>(row) * v4;
  const float4* lr = reinterpret_cast<const float4*>(logits) + off;
  const float4* nr = noise ? reinterpret_cast<const float4*>(noise) + off : nullptr;
  float4* gr = g_out ? reinterpret_cast<float4*>(g_out) + off : nullptr;
  const Key key = key_of(seed, 0u);

  float4 x[G];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) {
      const float4 l = lr[c4];
      const float4 g = field(nr, gr, key, c4, row);
      x[j] = make_float4((l.x + g.x) / tau, (l.y + g.y) / tau,
                         (l.z + g.z) / tau, (l.w + g.w) / tau);
      m = fmaxf(m, fmaxf(fmaxf(x[j].x, x[j].y), fmaxf(x[j].z, x[j].w)));
    }
  }
  m = block_max(m, red);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) {
      x[j] = make_float4(expf(x[j].x - m), expf(x[j].y - m), expf(x[j].z - m),
                         expf(x[j].w - m));
      s += (x[j].x + x[j].y) + (x[j].z + x[j].w);
    }
  }
  s = block_sum(s, red);
  float4* yr = reinterpret_cast<float4*>(y) + off;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4)
      yr[c4] = make_float4(x[j].x / s, x[j].y / s, x[j].z / s, x[j].w / s);
  }
}

// Keeps the larger value; NaN counts as larger than any number, and on a
// tie (two NaN included) the smaller index wins, as jnp.argmax and
// torch.argmax do. Any candidate beats the start (-inf, V), so a row of V
// values never ends with the id V.
__device__ __forceinline__ void keep_max(float& best, int& idx, float v, int i) {
  const bool v_nan = isnan(v), best_nan = isnan(best);
  const bool take = v_nan ? (!best_nan || i < idx)
                          : (!best_nan && (v > best || (v == best && i < idx)));
  if (take) {
    best = v;
    idx = i;
  }
}

// keep_max for a thread's own values, which it visits in rising index
// order from a real first value: an equal later value never wins, so the
// index needs no comparison.
__device__ __forceinline__ void keep_later(float& best, int& idx, float v, int i) {
  if (v > best || (isnan(v) && !isnan(best))) {
    best = v;
    idx = i;
  }
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
gumbel_ids_kernel(const float* __restrict__ logits,
                  const float* __restrict__ noise, int32_t* __restrict__ ids,
                  float* __restrict__ g_out, const int64_t* __restrict__ seed,
                  int V) {
  __shared__ float red_v[kMaxThreads / 32];
  __shared__ int red_i[kMaxThreads / 32];
  const uint32_t row = blockIdx.x;
  const int v4 = V / 4;
  const size_t off = static_cast<size_t>(row) * v4;
  const float4* lr = reinterpret_cast<const float4*>(logits) + off;
  const float4* nr = noise ? reinterpret_cast<const float4*>(noise) + off : nullptr;
  float4* gr = g_out ? reinterpret_cast<float4*>(g_out) + off : nullptr;
  const Key key = key_of(seed, kIdsStream);

  float best = -INFINITY;   // a thread without values keeps (-inf, V)
  int idx = V;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) {
      const float4 l = lr[c4];
      const float4 g = field(nr, gr, key, c4, row);
      if (j == 0) {            // the thread's first value, whatever it is
        best = l.x + g.x;
        idx = 4 * c4;
      } else {
        keep_later(best, idx, l.x + g.x, 4 * c4);
      }
      keep_later(best, idx, l.y + g.y, 4 * c4 + 1);
      keep_later(best, idx, l.z + g.z, 4 * c4 + 2);
      keep_later(best, idx, l.w + g.w, 4 * c4 + 3);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, best, o);
    const int oi = __shfl_xor_sync(kFullMask, idx, o);
    keep_max(best, idx, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
      keep_max(best, idx, red_v[w], red_i[w]);
    ids[row] = idx;
  }
}

// Threads per row and float4 per thread for rows of V values.
void shape_of(int V, int* threads, int* groups) {
  const int v4 = V / 4;
  const int t = ((v4 + 31) / 32) * 32;
  *threads = t < kMaxThreads ? t : kMaxThreads;
  *groups = (v4 + *threads - 1) / *threads;
}

}  // namespace

#define OCRL_GUMBEL_SWITCH(G, CALL) \
  switch (G) {                      \
    case 1: CALL(1); break;         \
    case 2: CALL(2); break;         \
    case 3: CALL(3); break;         \
    case 4: CALL(4); break;         \
    case 5: CALL(5); break;         \
    case 6: CALL(6); break;         \
    case 7: CALL(7); break;         \
    case 8: CALL(8); break;         \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

// logits, noise, y, g_out: [R, V] fp32, contiguous, 16-byte aligned; noise
// and g_out may be null. seed: one int64 on the device. The caller checks
// V % 4 == 0 and V <= 8192. Returns the launch's CUDA error code (0 = none).
extern "C" int gumbel_soft(const float* logits, const float* noise, float* y,
                           float* g_out, const int64_t* seed, int R, int V,
                           float tau, void* stream) {
  int threads, groups;
  shape_of(V, &threads, &groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OCRL_SOFT(n) \
  gumbel_soft_kernel<n><<<R, threads, 0, st>>>(logits, noise, y, g_out, seed, V, tau)
  OCRL_GUMBEL_SWITCH(groups, OCRL_SOFT)
#undef OCRL_SOFT
  return static_cast<int>(cudaGetLastError());
}

// As gumbel_soft, with ids: [R] int32.
extern "C" int gumbel_ids(const float* logits, const float* noise,
                          int32_t* ids, float* g_out, const int64_t* seed,
                          int R, int V, void* stream) {
  int threads, groups;
  shape_of(V, &threads, &groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define OCRL_IDS(n) \
  gumbel_ids_kernel<n><<<R, threads, 0, st>>>(logits, noise, ids, g_out, seed, V)
  OCRL_GUMBEL_SWITCH(groups, OCRL_IDS)
#undef OCRL_IDS
  return static_cast<int>(cudaGetLastError());
}
