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
// rows of V = 4096) gumbel_soft reads and writes 100.7 MB each (0.060 ms
// at 3.35 TB/s) and gumbel_ids reads 100.7 MB and writes 48 KB (0.030 ms).
// The noise is not small beside those bytes: a Philox call per four values
// is 20 wide multiplies (IMAD.WIDE) and 20 xors, and g takes two logs. On
// an H100 (80GB HBM3, 700 W; scripts/gumbel_split.py), gumbel_ids with two
// IEEE logf a value took 0.092 ms; reading and comparing the logits alone
// (the noise a constant) 0.039 ms, drawing and comparing the noise alone
// (no logits read) 0.087 ms: the arithmetic set the time, not the bytes.
//
// Design, around that arithmetic:
// - g in log2 units with two MUFU.LG2 and a short series near u = 1, which
//   keeps the right tail of g, the values that win the argmax, exact to a
//   few ulps (gumbel_of); no fast-math flag, so nothing else changes.
// - A thread's Philox calls go round by round together, up to four at a
//   time, so that the key schedule is formed once for them (add_field).
// - One block a row, the row in registers (G float4 a thread, 256 threads
//   x 16 values at V = 4096), read once with 16-byte loads; every load of
//   the row is issued before the noise is drawn, which does not depend on
//   the logits, so that the stream overlaps the arithmetic. A persistent
//   grid that prefetched the next row into registers, and 128 threads a
//   row, were both slower: fewer warps hid less.
// - gumbel_ids: each thread keeps its first largest value with two
//   comparisons a value; the block reduces (key, index) pairs with
//   redux.sync over keys in the argmax's order (order_key), instead of a
//   shuffle tree of NaN-aware comparisons.
// - gumbel_soft keeps its own structure (row max, exp-sum, normalise, y
//   written once); it shares the noise.
// Measured the same way: gumbel_ids 0.043 ms (the stream alone 0.035, the
// arithmetic alone 0.039), gumbel_soft 0.073 ms (0.114 with the IEEE logs).
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

// One round of Philox4x32 (Salmon et al., SC'11), as Random123 has it.
__device__ __forceinline__ uint4 philox_round(uint4 c, Key k) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t hi0 = __umulhi(kM0, c.x), lo0 = kM0 * c.x;
  const uint32_t hi1 = __umulhi(kM1, c.z), lo1 = kM1 * c.z;
  return make_uint4(hi1 ^ c.y ^ k.lo, lo1, hi0 ^ c.w ^ k.hi, lo0);
}

__device__ __forceinline__ float lg2_approx(float x) {   // one MUFU.LG2
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// g = -log(E + tiny), E = -log(u) standard exponential, from the top 23 bits
// m of a word: u = (2m + 1) 2^-24, from 2^-24 to 1 - 2^-24, so E is never 0
// or infinite. E >= -log(1 - 2^-24) > 2^-25 makes E + tiny == E in fp32, so
// the tiny is left out. The work is in log2 units, E2 = E / ln 2:
// - u is exact: f = 1 + m 2^-23 from the bits, u = f - (1 - 2^-24) (Sterbenz).
// - E2 needs relative accuracy, since g = -log(E) turns a relative error of E
//   into an absolute one of g. lg2.approx errs by up to 2^-22 absolutely for
//   u in [1/2, 2) (relatively elsewhere), which near u = 1, where E is tiny
//   and g is largest (the values that win the argmax), is an O(1) relative
//   error. So for w = 1 - u < 1/16 (exact, as u > 1/2) E2 comes from the
//   series -log(1 - w) = w + w^2/2 + ... to w^5 (truncation below 2e-7 of
//   E), and from -lg2.approx(u) above, where E >= 0.064 keeps g within
//   2.6e-6.
// - The outer log needs only absolute accuracy: g = -ln 2 lg2(E2) - log(ln 2).
// Two MUFU.LG2 and about ten fp32 instructions a value, against two IEEE
// logf of about twenty each.
__device__ __forceinline__ float gumbel_of(uint32_t bits) {
  constexpr float kSeriesBelow = 0.0625f;
  constexpr float kLn2 = 0.693147181f, kMinusLogLn2 = 0.366512921f;
  constexpr float kC1 = 1.44269504f, kC2 = 0.721347520f, kC3 = 0.480898347f,
                  kC4 = 0.360673760f, kC5 = 0.288539008f;   // 1 / (k ln 2)
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 0.99999994f;
  const float w = 1.0f - u;
  float p = fmaf(kC5, w, kC4);
  p = fmaf(p, w, kC3);
  p = fmaf(p, w, kC2);
  p = fmaf(p, w, kC1);
  const float e2 = w < kSeriesBelow ? w * p : -lg2_approx(u);
  return fmaf(lg2_approx(e2), -kLn2, kMinusLogLn2);
}

__device__ __forceinline__ Key key_of(const int64_t* seed, uint32_t stream) {
  const uint64_t s = static_cast<uint64_t>(*seed);
  return Key{static_cast<uint32_t>(s), static_cast<uint32_t>(s >> 32) + stream};
}

// Adds the field g to a thread's G float4 of the row, x[j] at columns
// 4 (c4 + j stride) + 0..3 below V = 4 v4: g drawn, or read from `noise`;
// g is also written to `g_out` when it is given. A drawn float4 is one
// Philox4x32-10 call, counter (c4 + j stride, row, 0, 0). The calls go in
// chunks of up to kTogether, round by round together, so that each round's
// key (Random123's schedule: + kW0, + kW1 a round) is formed once a chunk
// and a chunk's noise is one branch-free stretch of independent work;
// values past the row are drawn and added too, and never used.
template <int G>
__device__ __forceinline__ void add_field(const float4* noise, float4* g_out,
                                          const Key key, uint32_t c4,
                                          uint32_t stride, uint32_t v4,
                                          uint32_t row, float4 (&x)[G]) {
  constexpr uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
  constexpr int kTogether = 4;
#pragma unroll
  for (int j0 = 0; j0 < G; j0 += kTogether) {
    const auto col = [&](int j) { return c4 + (j0 + j) * stride; };
    const auto in_row = [&](int j) { return j0 + j < G && col(j) < v4; };
    float4 g[kTogether];
    if (noise) {
#pragma unroll
      for (int j = 0; j < kTogether; ++j)
        if (in_row(j)) g[j] = noise[col(j)];
    } else {
      uint4 c[kTogether];
#pragma unroll
      for (int j = 0; j < kTogether; ++j) c[j] = make_uint4(col(j), row, 0u, 0u);
      Key k = key;
#pragma unroll
      for (int i = 0; i < 10; ++i) {
        if (i > 0) {
          k.lo += kW0;
          k.hi += kW1;
        }
#pragma unroll
        for (int j = 0; j < kTogether; ++j)
          if (j0 + j < G) c[j] = philox_round(c[j], k);
      }
#pragma unroll
      for (int j = 0; j < kTogether; ++j)
        if (j0 + j < G)
          g[j] = make_float4(gumbel_of(c[j].x), gumbel_of(c[j].y), gumbel_of(c[j].z),
                             gumbel_of(c[j].w));
    }
    if (g_out) {
#pragma unroll
      for (int j = 0; j < kTogether; ++j)
        if (in_row(j)) g_out[col(j)] = g[j];
    }
#pragma unroll
    for (int j = 0; j < kTogether; ++j) {
      if (j0 + j < G) {
        float4& v = x[j0 + j];
        v = make_float4(v.x + g[j].x, v.y + g[j].y, v.z + g[j].z, v.w + g[j].w);
      }
    }
  }
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
#pragma unroll
  for (int j = 0; j < G; ++j) {   // the logits in flight before the noise
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) x[j] = lr[c4];
  }
  add_field<G>(nr, gr, key, threadIdx.x, blockDim.x, v4, row, x);
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) {
      x[j] = make_float4(x[j].x / tau, x[j].y / tau, x[j].z / tau, x[j].w / tau);
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

// An unsigned key in the order of the argmax: NaN above every number (all
// NaN alike), -0 and +0 alike (v + 0 turns -0 into +0), numbers in their
// order. Ties of keys go to the smaller index, as jnp.argmax and
// torch.argmax do.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v + 0.0f);
  return isnan(v) ? 0xFFFFFFFFu : (b >> 31 ? ~b : b | 0x80000000u);
}

// Over the warp: the largest key, and the smallest index that holds it.
__device__ __forceinline__ uint32_t first_max(uint32_t key, uint32_t idx,
                                              uint32_t* top) {
  *top = __reduce_max_sync(kFullMask, key);
  return __reduce_min_sync(kFullMask, key == *top ? idx : 0xFFFFFFFFu);
}

// The argmax's rule for a thread's own values, which it visits in rising
// index order from a real first value: the larger value wins, NaN above
// every number, and an equal later value never wins. !(v <= best) is
// v > best or v NaN, and best == best keeps a NaN best: two comparisons a
// value.
__device__ __forceinline__ void keep_later(float& best, int& pos, float v, int p) {
  if (!(v <= best) && best == best) {
    best = v;
    pos = p;
  }
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
gumbel_ids_kernel(const float* __restrict__ logits,
                  const float* __restrict__ noise, int64_t* __restrict__ ids,
                  float* __restrict__ g_out, const int64_t* __restrict__ seed,
                  int V) {
  __shared__ uint32_t red_k[kMaxThreads / 32], red_i[kMaxThreads / 32];
  const uint32_t row = blockIdx.x;
  const int v4 = V / 4;
  const size_t off = static_cast<size_t>(row) * v4;
  const float4* lr = reinterpret_cast<const float4*>(logits) + off;
  const float4* nr = noise ? reinterpret_cast<const float4*>(noise) + off : nullptr;
  float4* gr = g_out ? reinterpret_cast<float4*>(g_out) + off : nullptr;
  const Key key = key_of(seed, kIdsStream);

  // Every load of the thread's part of the row is in flight before the
  // noise, which does not depend on the logits, is drawn.
  float4 x[G];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) x[j] = lr[c4];
  }
  add_field<G>(nr, gr, key, threadIdx.x, blockDim.x, v4, row, x);
  // pos: the thread's own position 4 j + k of its best value, a constant
  // of the unrolled loop; the column is formed once, after it.
  float best = -INFINITY;   // a thread without values keeps (-inf, V)
  int pos = -1;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c4 = threadIdx.x + j * blockDim.x;
    if (c4 < v4) {
      if (j == 0) {            // the thread's first value, whatever it is
        best = x[j].x;
        pos = 0;
      } else {
        keep_later(best, pos, x[j].x, 4 * j);
      }
      keep_later(best, pos, x[j].y, 4 * j + 1);
      keep_later(best, pos, x[j].z, 4 * j + 2);
      keep_later(best, pos, x[j].w, 4 * j + 3);
    }
  }
  // Across the block, by the keys: in each warp with two redux.sync, then
  // the warps' winners in warp 0. (-inf, V) loses to any value of the row.
  const uint32_t idx =
      pos < 0 ? V : 4 * (threadIdx.x + (pos >> 2) * blockDim.x) + (pos & 3);
  uint32_t top;
  const uint32_t first = first_max(order_key(best), idx, &top);
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_k[warp] = top;
    red_i[warp] = first;
  }
  __syncthreads();
  if (warp == 0) {
    const bool real = lane < (blockDim.x >> 5);
    const uint32_t id = first_max(real ? red_k[lane] : 0u,
                                  real ? red_i[lane] : 0xFFFFFFFFu, &top);
    if (lane == 0) ids[row] = id;
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

// As gumbel_soft, with ids: [R] int64.
extern "C" int gumbel_ids(const float* logits, const float* noise,
                          int64_t* ids, float* g_out, const int64_t* seed,
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
