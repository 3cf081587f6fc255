// Slot-attention routing sweep, forward and backward, for Hopper (sm_90a).
//
// Forward: replaces the TPU kernel
// ocrl_tpu/ops/slot_routing.py::_sweep_fwd_kernel (launched by
// _route_sweep_fwd). It computes the same function:
//   a[b, n, :]        = softmax over slots of k[b, n, :] . q[b, s, :]
//   partial[b, c, s, :] = sum over the tokens n of chunk c of a[b, n, s] v[b, n, :]
// The sums over chunks (A_v) and over tokens (S_a) stay in torch, as they
// stay in jnp on the TPU.
//
// What bounds it: k and v, [B, N, D] fp32, are each read once; everything
// else is slot-sized. At B = 16, N = 4096, D = 192 that is 100.7 MB against
// about 0.25 GFLOP of fp32 work, so the kernel is memory-bound (about 30 us
// at 3.35 TB/s on an H100 SXM).
//
// Design: one block per (chunk of tokens, batch row); the TPU's sequential
// grid carried nothing between programs, so neither does this. q[b] sits in
// shared memory. Phase 1: each warp takes one token at a time; its lanes read
// the token's k row coalesced, form the S dot products, reduce them with an
// xor butterfly (every lane ends with the same sum), take the softmax over S
// in registers and write a to device memory and to shared memory. Phase 2:
// one thread per feature column reads v coalesced down the chunk and keeps S
// partial sums in registers, then writes the chunk's [S, D] partial once.
// No atomics anywhere, so the result is deterministic.
//
// Backward: replaces ocrl_tpu/ops/slot_routing.py::_sweep_bwd_kernel
// (launched by _route_sweep_bwd), the VJP of the forward given the
// cotangents g_av [B, S, D] and g_a [B, N, S] (the caller has folded the
// cotangent of S_a into g_a). Per token:
//   da_s = v_n . g_av_s + g_a_ns,   dl = a_n * (da - sum_s da_s a_ns)
//   gk_n = dl q,   gv_n = a_n g_av,   and per chunk the [S, D] partial dl^T k
// whose sum over chunks (gq) stays in torch.
//
// What bounds it: k and v are read once and gk and gv written once, four
// [B, N, D] fp32 streams (302 MB at B = 24, N = 4096, D = 192) against about
// 0.5 GFLOP, so it is memory-bound too (about 92 us at 3.35 TB/s).
//
// Design: the forward's grid and its two phases. q[b] and g_av[b] sit in
// shared memory. Phase 1, one warp per token: the lanes read v's row
// coalesced for the S dot products with g_av (xor butterfly), every lane
// forms dl in registers, then writes its columns of gk and gv coalesced;
// dl goes to shared memory. Phase 2, one thread per feature column, reads k
// down the chunk for the partial dl^T k. No atomics: deterministic.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
sweep_fwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ q, float* __restrict__ a,
                 float* __restrict__ partial, int N, int D, int chunk) {
  extern __shared__ float smem[];
  float* sq = smem;           // [S, D]
  float* sa = smem + S * D;   // [chunk, S]

  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int num_chunks = gridDim.x;
  const int n0 = c * chunk;
  const int count = min(chunk, N - n0);   // the last chunk may be ragged
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;

  const float* qb = q + static_cast<size_t>(b) * S * D;
  for (int i = tid; i < S * D; i += blockDim.x) sq[i] = qb[i];
  __syncthreads();

  // Phase 1: a = softmax over slots of k q^T, one token per warp at a time.
  for (int t = warp; t < count; t += num_warps) {
    const size_t row = static_cast<size_t>(b) * N + n0 + t;
    const float* kr = k + row * D;
    float dot[S];
#pragma unroll
    for (int s = 0; s < S; ++s) dot[s] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float kv = kr[d];
#pragma unroll
      for (int s = 0; s < S; ++s) dot[s] = fmaf(kv, sq[s * D + d], dot[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot[s] += __shfl_xor_sync(kFullMask, dot[s], off);
    }
    float m = dot[0];
#pragma unroll
    for (int s = 1; s < S; ++s) m = fmaxf(m, dot[s]);
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      dot[s] = expf(dot[s] - m);
      sum += dot[s];
    }
    float mine = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float as = dot[s] / sum;
      if (lane == s) mine = as;
    }
    if (lane < S) {
      a[row * S + lane] = mine;
      sa[t * S + lane] = mine;
    }
  }
  __syncthreads();

  // Phase 2: the chunk's partial a^T v, one thread per feature column.
  const float* vb = v + (static_cast<size_t>(b) * N + n0) * D;
  float* pb = partial + (static_cast<size_t>(b) * num_chunks + c) * S * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
#pragma unroll 4
    for (int t = 0; t < count; ++t) {
      const float vv = vb[static_cast<size_t>(t) * D + d];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = fmaf(sa[t * S + s], vv, acc[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) pb[static_cast<size_t>(s) * D + d] = acc[s];
  }
}

template <int S>
__global__ void __launch_bounds__(kMaxThreads)
sweep_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ q,
                 const float* __restrict__ g_av, const float* __restrict__ g_a,
                 float* __restrict__ gk, float* __restrict__ gv,
                 float* __restrict__ gq_partial, int N, int D, int chunk) {
  extern __shared__ float smem[];
  float* sq = smem;               // [S, D]
  float* sg = smem + S * D;       // [S, D]
  float* sdl = smem + 2 * S * D;  // [chunk, S]

  const int b = blockIdx.y;
  const int c = blockIdx.x;
  const int num_chunks = gridDim.x;
  const int n0 = c * chunk;
  const int count = min(chunk, N - n0);   // the last chunk may be ragged
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int num_warps = blockDim.x >> 5;

  const float* qb = q + static_cast<size_t>(b) * S * D;
  const float* gb = g_av + static_cast<size_t>(b) * S * D;
  for (int i = tid; i < S * D; i += blockDim.x) {
    sq[i] = qb[i];
    sg[i] = gb[i];
  }
  __syncthreads();

  // Phase 1: dl, gk and gv, one token per warp at a time.
  for (int t = warp; t < count; t += num_warps) {
    const size_t row = static_cast<size_t>(b) * N + n0 + t;
    const float* vr = v + row * D;
    float da[S], as[S];
#pragma unroll
    for (int s = 0; s < S; ++s) da[s] = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float vv = vr[d];
#pragma unroll
      for (int s = 0; s < S; ++s) da[s] = fmaf(vv, sg[s * D + d], da[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        da[s] += __shfl_xor_sync(kFullMask, da[s], off);
    }
    float inner = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      as[s] = a[row * S + s];
      da[s] += g_a[row * S + s];
      inner = fmaf(da[s], as[s], inner);
    }
    float mine = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      da[s] = as[s] * (da[s] - inner);   // da now holds dl
      if (lane == s) mine = da[s];
    }
    if (lane < S) sdl[t * S + lane] = mine;
    float* gkr = gk + row * D;
    float* gvr = gv + row * D;
    for (int d = lane; d < D; d += 32) {
      float x = 0.f, y = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        x = fmaf(da[s], sq[s * D + d], x);
        y = fmaf(as[s], sg[s * D + d], y);
      }
      gkr[d] = x;
      gvr[d] = y;
    }
  }
  __syncthreads();

  // Phase 2: the chunk's partial dl^T k, one thread per feature column.
  const float* kb = k + (static_cast<size_t>(b) * N + n0) * D;
  float* pb = gq_partial + (static_cast<size_t>(b) * num_chunks + c) * S * D;
  for (int d = tid; d < D; d += blockDim.x) {
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
#pragma unroll 4
    for (int t = 0; t < count; ++t) {
      const float kv = kb[static_cast<size_t>(t) * D + d];
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = fmaf(sdl[t * S + s], kv, acc[s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) pb[static_cast<size_t>(s) * D + d] = acc[s];
  }
}

template <int S>
cudaError_t launch(const float* k, const float* v, const float* q, float* a,
                   float* partial, int B, int N, int D, int chunk,
                   cudaStream_t stream) {
  const int threads = D < kMaxThreads ? D : kMaxThreads;
  const int num_chunks = (N + chunk - 1) / chunk;
  const size_t smem = static_cast<size_t>(S * D + chunk * S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_chunks, B);
  sweep_fwd_kernel<S><<<grid, threads, smem, stream>>>(k, v, q, a, partial, N,
                                                       D, chunk);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_bwd(const float* k, const float* v, const float* a,
                       const float* q, const float* g_av, const float* g_a,
                       float* gk, float* gv, float* gq_partial, int B, int N,
                       int D, int chunk, cudaStream_t stream) {
  const int threads = D < kMaxThreads ? D : kMaxThreads;
  const int num_chunks = (N + chunk - 1) / chunk;
  const size_t smem =
      static_cast<size_t>(2 * S * D + chunk * S) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sweep_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_chunks, B);
  sweep_bwd_kernel<S><<<grid, threads, smem, stream>>>(
      k, v, a, q, g_av, g_a, gk, gv, gq_partial, N, D, chunk);
  return cudaGetLastError();
}

}  // namespace

// k, v: [B, N, D]; q: [B, S, D]; a: [B, N, S];
// partial: [B, ceil(N / chunk), S, D]. All fp32, contiguous, on one device.
// The caller checks 1 <= S <= 16, D a positive multiple of 32 and the
// shared-memory size; returns the CUDA error code of the launch (0 = none).
extern "C" int slot_routing_fwd(const float* k, const float* v,
                                const float* q, float* a, float* partial,
                                int B, int N, int S, int D, int chunk,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define OCRL_SWEEP_CASE(n) \
  case n:                  \
    return launch<n>(k, v, q, a, partial, B, N, D, chunk, st);
    OCRL_SWEEP_CASE(1)
    OCRL_SWEEP_CASE(2)
    OCRL_SWEEP_CASE(3)
    OCRL_SWEEP_CASE(4)
    OCRL_SWEEP_CASE(5)
    OCRL_SWEEP_CASE(6)
    OCRL_SWEEP_CASE(7)
    OCRL_SWEEP_CASE(8)
    OCRL_SWEEP_CASE(9)
    OCRL_SWEEP_CASE(10)
    OCRL_SWEEP_CASE(11)
    OCRL_SWEEP_CASE(12)
    OCRL_SWEEP_CASE(13)
    OCRL_SWEEP_CASE(14)
    OCRL_SWEEP_CASE(15)
    OCRL_SWEEP_CASE(16)
#undef OCRL_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// k, v: [B, N, D]; a: [B, N, S]; q, g_av: [B, S, D]; g_a: [B, N, S];
// gk, gv: [B, N, D]; gq_partial: [B, ceil(N / chunk), S, D]. All fp32,
// contiguous, on one device; the caller checks the shapes as for the
// forward. Returns the CUDA error code of the launch (0 = none).
extern "C" int slot_routing_bwd(const float* k, const float* v, const float* a,
                                const float* q, const float* g_av,
                                const float* g_a, float* gk, float* gv,
                                float* gq_partial, int B, int N, int S, int D,
                                int chunk, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define OCRL_SWEEP_CASE(n)                                                  \
  case n:                                                                   \
    return launch_bwd<n>(k, v, a, q, g_av, g_a, gk, gv, gq_partial, B, N, D, \
                         chunk, st);
    OCRL_SWEEP_CASE(1)
    OCRL_SWEEP_CASE(2)
    OCRL_SWEEP_CASE(3)
    OCRL_SWEEP_CASE(4)
    OCRL_SWEEP_CASE(5)
    OCRL_SWEEP_CASE(6)
    OCRL_SWEEP_CASE(7)
    OCRL_SWEEP_CASE(8)
    OCRL_SWEEP_CASE(9)
    OCRL_SWEEP_CASE(10)
    OCRL_SWEEP_CASE(11)
    OCRL_SWEEP_CASE(12)
    OCRL_SWEEP_CASE(13)
    OCRL_SWEEP_CASE(14)
    OCRL_SWEEP_CASE(15)
    OCRL_SWEEP_CASE(16)
#undef OCRL_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
