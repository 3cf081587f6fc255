// What bounds the streamed routing kernels' inner loop on an NVIDIA Hopper
// card: the fp32 FMA rate of an 8 x 8 outer product a thread fed from
// shared memory (two float4 reads an operand a step, as
// ocrl_tpu_torch/ops/csrc/slot_routing.cu wide_fma reads them), alone and
// beside each way of bringing data into shared memory.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/fma_ceiling \
//       scripts/fma_ceiling.cu && build/fma_ceiling
//
// Modes (a barrier every 16 steps in all of them):
//   peak      FMAs on registers alone (no shared memory);
//   smem      the outer product from shared memory, [kk][m] rows;
//   rows      the same from [m][kk] rows of 20 floats, one float a row a
//             step (an operand contiguous along the summed axis, untransposed);
//   cp16      smem + 8 cp.async of 16 bytes a thread every 16 steps;
//   cp4       smem + 8 cp.async of 4 bytes a thread every 16 steps;
//   bulk      smem + 2 bulk copies of 4 KB a block every 16 steps;
//   ldg       smem + 4 float4 loads a thread every 16 steps streaming
//             through 1 GB, stored to shared memory after the FMAs.
// Prints TFLOP/s for tiles of 128 x 64 and 128 x 128 outputs a block.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

enum Mode { kSmem, kRows, kCp16, kCp4, kBulk, kLdg };

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(256, 2) peak(float* out, int iters) {
  float acc[64];
  for (int i = 0; i < 64; ++i) acc[i] = threadIdx.x * 1e-3f + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = fmaf(acc[i], 1.0001f, 0.9999f);
  }
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kMode>
__global__ void __launch_bounds__(256, 2) outer(float* out, const float* src, int iters, int em,
                                                int en) {
  extern __shared__ __align__(128) float sm[];
  __shared__ __align__(8) uint64_t bar;
  const int ldx = em + 4, ldy = en + 4;
  float* xs0 = sm;
  float* ys0 = sm + 20 * (em + en);
  float* spare = sm + 40 * (em + en);
  for (int i = threadIdx.x; i < 40 * (em + en); i += blockDim.x) sm[i] = 1e-3f * (i % 97);
  if (threadIdx.x == 0) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&bar)));
  __syncthreads();
  const int tpr = en >> 3, tx = threadIdx.x % tpr, ty = threadIdx.x / tpr;
  float acc[8][8] = {};
  uint32_t phase = 0;
  float4 pre[4];
  auto stream = [&](int it, int c) {
    const long long e =
        ((static_cast<long long>(it) * gridDim.x + blockIdx.x) * blockDim.x * 4 +
         c * blockDim.x + threadIdx.x) * 4;
    return reinterpret_cast<const float4*>(src + e % (1LL << 28));
  };
  if (kMode == kLdg)
    for (int c = 0; c < 4; ++c) pre[c] = *stream(0, c);
  for (int it = 0; it < iters; ++it) {
    if (kMode == kCp16)
      for (int c = 0; c < 8; ++c)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 16;" ::"r"(
                         saddr(spare + 4 * (threadIdx.x + c * blockDim.x))),
                     "l"(src + 4 * ((threadIdx.x + c * blockDim.x + blockIdx.x * 997) & 65535)));
    if (kMode == kCp4)
      for (int c = 0; c < 8; ++c)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, 4;" ::"r"(
                         saddr(spare + threadIdx.x + c * blockDim.x)),
                     "l"(src + ((threadIdx.x + c * blockDim.x + blockIdx.x * 997) & 262143)));
    if (kMode == kCp16 || kMode == kCp4) asm volatile("cp.async.commit_group;");
    if (kMode == kBulk && threadIdx.x == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 8192;" ::"r"(saddr(&bar)));
      for (int c = 0; c < 2; ++c)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], "
            "4096, [%2];" ::"r"(saddr(spare + 1024 * c)),
            "l"(src + 1024 * ((c + blockIdx.x * 7 + it) & 255)), "r"(saddr(&bar)));
    }
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float xv[8], yv[8];
      if (kMode == kRows) {
        for (int i = 0; i < 8; ++i) xv[i] = xs0[(ty + (em >> 3) * i) * 20 + kk];
        for (int j = 0; j < 8; ++j) yv[j] = ys0[(tx + (en >> 3) * j) * 20 + kk];
      } else {
        const float* xs = xs0 + 4 * ty;
        const float* ys = ys0 + 4 * tx;
        const float4 x0 = *reinterpret_cast<const float4*>(xs + kk * ldx);
        const float4 x1 = *reinterpret_cast<const float4*>(xs + kk * ldx + (em >> 1));
        const float4 y0 = *reinterpret_cast<const float4*>(ys + kk * ldy);
        const float4 y1 = *reinterpret_cast<const float4*>(ys + kk * ldy + (en >> 1));
        xv[0] = x0.x, xv[1] = x0.y, xv[2] = x0.z, xv[3] = x0.w;
        xv[4] = x1.x, xv[5] = x1.y, xv[6] = x1.z, xv[7] = x1.w;
        yv[0] = y0.x, yv[1] = y0.y, yv[2] = y0.z, yv[3] = y0.w;
        yv[4] = y1.x, yv[5] = y1.y, yv[6] = y1.z, yv[7] = y1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
    }
    if (kMode == kLdg) {
      for (int c = 0; c < 4; ++c)
        reinterpret_cast<float4*>(spare)[c * blockDim.x + threadIdx.x] = pre[c];
      for (int c = 0; c < 4; ++c) pre[c] = *stream(it + 1, c);
    }
    if (kMode == kCp16 || kMode == kCp4) asm volatile("cp.async.wait_group 0;");
    if (kMode == kBulk) {
      asm volatile(
          "{\n.reg .pred p;\nW:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
          "@!p bra W;\n}" ::"r"(saddr(&bar)),
          "r"(phase));
      phase ^= 1;
    }
    __syncthreads();
  }
  float s = 0.f;
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) s += acc[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <int kMode>
void run(const char* name, float* out, const float* src, int em, int en, int sms) {
  const int threads = em * en / 64, blocks = sms * 8, iters = 512;
  const size_t smem = (40 * (em + en) + 16 * 256 * 4) * 4;
  cudaFuncSetAttribute(outer<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  outer<kMode><<<blocks, threads, smem>>>(out, src, 4, em, en);
  cudaEventRecord(a);
  outer<kMode><<<blocks, threads, smem>>>(out, src, iters, em, en);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  int occupancy = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occupancy, outer<kMode>, threads, smem);
  const double flops = 2.0 * 64 * 16 * iters * static_cast<double>(blocks) * threads;
  std::printf("%-5s %3d x %3d outputs a block, %d blocks an SM: %.2f TFLOP/s (%s)\n", name, em,
              en, occupancy, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float *out, *src;
  cudaMalloc(&out, 1 << 26);
  cudaMalloc(&src, (1LL << 30) + 4096);
  cudaMemset(src, 0, (1LL << 30) + 4096);
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  peak<<<sms * 8, 256>>>(out, 16);
  cudaEventRecord(a);
  peak<<<sms * 8, 256>>>(out, 4096);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  std::printf("peak  FMAs on registers: %.2f TFLOP/s\n",
              2.0 * 64 * 4096 * sms * 8 * 256 / ms / 1e9);
  for (int em_en : {64, 128}) {
    run<kSmem>("smem", out, src, 128, em_en, sms);
    run<kRows>("rows", out, src, 128, em_en, sms);
    run<kCp16>("cp16", out, src, 128, em_en, sms);
    run<kCp4>("cp4", out, src, 128, em_en, sms);
    run<kBulk>("bulk", out, src, 128, em_en, sms);
    run<kLdg>("ldg", out, src, 128, em_en, sms);
  }
  return 0;
}
