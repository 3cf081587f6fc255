// Slot-attention routing sweep, forward and backward, for Hopper (sm_90a).
//
// Forward (B3): replaces the TPU kernel
// ocrl_tpu/ops/slot_routing.py::_sweep_fwd_kernel (launched by
// _route_sweep_fwd) and the jnp sums around it:
//   a[b, n, :]  = softmax over slots of k[b, n, :] . q[b, s, :]
//   S_a[b, s]   = sum over n of a[b, n, s]
//   A_v[b, s, :] = sum over n of a[b, n, s] v[b, n, :]
// What bounds it: k and v, [B, N, D] fp32, are each read once; everything
// else is slot-sized. At B = 24, N = 4096, D = 192 that is 151 MB against
// 0.38 GFLOP (2.5 FLOP a byte, far below the fp32 ridge), so it is bound by
// device-memory bytes (46 us at 3.35 TB/s). Tensor cores cannot help, and
// TF32 would break the fp32 parity with the JAX package.
//
// Backward (B4): replaces ocrl_tpu/ops/slot_routing.py::_sweep_bwd_kernel
// (launched by _route_sweep_bwd), the VJP of the forward given the
// cotangents g_av [B, S, D] and g_a [B, N, S] (the caller has folded the
// cotangent of S_a into g_a). Per token:
//   da_s = v_n . g_av_s + g_a_ns,   dl = a_n * (da - sum_s da_s a_ns)
//   gk_n = dl q,   gv_n = a_n g_av,   gq = sum over n of dl_n^T k_n
// What bounds it: k and v read once and gk and gv written once, four
// [B, N, D] fp32 streams (302 MB at B = 24), against 0.75 GFLOP: bytes
// again (91 us at 3.35 TB/s).
//
// Design, both kernels: a bandwidth skeleton.
// - Grid: persistent, one block per SM (the wrapper passes the SM count; a
//   small input takes one block per tile). The B * N tokens, taken as one
//   stream, are cut into G equal contiguous ranges; block g walks its range
//   in tiles of T tokens, a tile never crossing a batch row. The C entry
//   chooses T: the largest of kFwdTiles (B3; at most 32 for S > 8) or
//   kBwdTiles (B4) whose ring fits in the card's shared memory a block; at
//   S = 5, D = 192, B3 takes 64 tokens and B4 32.
// - Stream: one producer thread (warp 8) keeps a ring of tiles in shared
//   memory (B3 2 stages, B4 4) filled with 1-D bulk copies (cp.async.bulk,
//   completion on an mbarrier per stage). A tile of k and the same tile of
//   v arrive together (B4 also takes the tile's span of a and g_a), so both
//   streams always move. Rows of [B, N, D] are contiguous, so a tile is one
//   span; D % 32 == 0 keeps it 16-byte aligned and a multiple of 16 bytes.
//   The [T, S] spans of a and g_a start anywhere: the producer fetches the
//   16-byte-aligned span that covers them, cut at the last whole 16 bytes of
//   the tensor, and reads the 1-3 floats after that cut with plain loads.
// - Compute: 8 consumer warps. The S dot products per token (k . q in B3,
//   v . g_av in B4) take 8 lanes per token (16 for S > 8), with 16-byte
//   shared loads and an xor butterfly; lane s of the token's lanes then
//   forms the softmax (B3) or dl (B4) of slot s. Then the tile's tokens are
//   walked per feature column: in B3 a thread takes four columns and every
//   4th token, adding a_t v_t into an [S] float4 accumulator in registers
//   (the warp's 4 token groups are summed with shuffles at the end); in B4
//   a thread takes one column, forms gk and gv (q and g_av of its column in
//   registers), writes them over k and v in the stage, and adds dl_t k_t
//   into its [S] accumulator. B4's producer sends gk and gv out with bulk
//   stores (cp.async.bulk.global.shared::cta) before it refills the stage;
//   dl never leaves the block.
// - Reduction: one partial per (block, batch row) it touches, kept in
//   registers across the block's tiles and written once to a scratch slot
//   (g + b). A second small kernel, launched from the same C entry, sums the
//   slots of each row in block order and writes S_a and A_v (B3) or gq (B4).
//   No atomics: the result is bitwise the same from run to run.
// PERF.md has the times against the bound and how the counts were chosen.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kConsumers = 256;               // 8 consumer warps
constexpr int kThreads = kConsumers + 32;     // and one producer warp
constexpr int kFwdStages = 2;                 // tiles in each kernel's ring
constexpr int kBwdStages = 4;
// Tokens a tile, the largest first; the C entry takes the first that fits.
constexpr int kFwdTiles[] = {64, 48, 32, 24, 16, 8};
constexpr int kBwdTiles[] = {32, 24, 16, 8};
constexpr int kFwdMaxTile = kFwdTiles[0];
constexpr int kFwdMaxTileManySlots = 32;      // B3 for S > 8
constexpr int kBwdMaxTile = kBwdTiles[0];
constexpr int kMaxWidth = kConsumers;         // one feature column a thread
constexpr int kHeaderBytes = 128;             // the mbarriers
constexpr int kReduceThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

__host__ __device__ constexpr int padded(int S) { return (S + 3) & ~3; }

// The forward's A_v phase: lane l of a warp takes 4 feature columns,
// 4 (8 w + l % 8).., and every kTokenGroups-th token from l / 8; the four
// groups of a warp are summed with shuffles before the partial is written.
constexpr int kTokenGroups = 4;

// Floats of one stage's span of a (or g_a): T * S values that may start up
// to 3 floats after a 16-byte boundary and end up to 3 before one.
__host__ __device__ inline int span_floats(int T, int S) {
  return (T * S + 6 + 3) & ~3;
}

__host__ __device__ inline size_t fwd_smem_bytes(int S, int D, int T) {
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(kFwdStages) * 2 * T * D + S * D +
                          2 * T * padded(S) + kConsumers / 8 * padded(S));
}

__host__ __device__ inline size_t bwd_smem_bytes(int S, int D, int T) {
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(kBwdStages) *
                              (2 * T * D + 2 * span_floats(T, S)) +
                          S * D + 4 * T * padded(S));
}

// -- PTX wrappers: mbarriers, bulk copies, the consumers' named barrier ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {   // sources free again
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {    // writes done
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later bulk copies.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Sets up the stage barriers: `full` completes when a tile has landed (one
// arrival with its byte count), `empty` when every consumer warp is done.
template <int kStages>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A consumer warp gives its stage back (after its reads, and writes).
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// The tiles of one block: its range [pos, end) of the B * N token stream,
// cut at T tokens and at the end of every batch row.
// (One division at the start; the walk itself adds and compares.)
struct Tiles {
  long long pos, end, row_end;   // row_end: the end of batch row `row`
  int row, N, T;
  __device__ bool valid() const { return pos < end; }
  __device__ int b() const { return row; }
  __device__ int count() const {
    const long long stop = row_end < end ? row_end : end;
    return static_cast<int>(stop - pos < T ? stop - pos : T);
  }
  // Whether the tile at pos is the last of its (block, row) segment.
  __device__ bool ends_segment() const {
    const long long next = pos + count();
    return next == end || next == row_end;
  }
  __device__ void next() {
    pos += count();
    if (pos == row_end) {
      ++row;
      row_end += N;
    }
  }
};

// Block g's range of the token stream: [g * BN / G, (g + 1) * BN / G).
__device__ __forceinline__ Tiles block_tiles(long long BN, int N, int T) {
  const long long g = blockIdx.x, G = gridDim.x;
  const long long pos = g * BN / G;
  const int row = static_cast<int>(pos / N);
  return Tiles{pos, (g + 1) * BN / G, static_cast<long long>(row + 1) * N, row, N, T};
}

// How the 256 consumer threads share the S dot products of a tile of up to
// kTileMax tokens: L lanes per token (8 up to 8 slots, else 16, so that
// lane s of the L can own slot s), so kGroups = 256 / L groups, and R
// tokens per lane. Token r of group g is g + r * kGroups.
template <int S, int kTileMax>
struct DotLanes {
  static constexpr int L = S <= 8 ? 8 : 16;
  static constexpr int kGroups = kConsumers / L;
  static constexpr int R = kTileMax / kGroups;
};

// The forward's largest tile: two tokens a lane at most (so 32 for S > 8).
template <int S>
__host__ __device__ constexpr int fwd_max_tile() {
  return S <= 8 ? kFwdMaxTile : kFwdMaxTileManySlots;
}

// The S dot products of this lane's R tokens `tok` of a [T, D] tile with an
// [S, D] matrix m, both in shared memory: every lane of a group of L ends
// with the full sums (an xor butterfly inside the group).
template <int S, int kTileMax>
__device__ __forceinline__ void tile_dots(
    const float* tile, const float* m, int D,
    const int (&tok)[DotLanes<S, kTileMax>::R], int lane,
    float (&dot)[DotLanes<S, kTileMax>::R][S]) {
  constexpr int L = DotLanes<S, kTileMax>::L, R = DotLanes<S, kTileMax>::R;
  const int D4 = D >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(tile);
  const float4* m4 = reinterpret_cast<const float4*>(m);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < S; ++s) dot[r][s] = 0.f;
  // unrolled for D = 192 (48 / L steps); one step at a time for many
  // slots, whose S float4 of m a step already take 4 S registers
  constexpr int kUnroll = S <= 8 ? 3 : 1;
#pragma unroll kUnroll
  for (int c4 = lane; c4 < D4; c4 += L) {
    float4 x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = x4[tok[r] * D4 + c4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 w = m4[s * D4 + c4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        dot[r][s] = fmaf(x[r].x, w.x, dot[r][s]);
        dot[r][s] = fmaf(x[r].y, w.y, dot[r][s]);
        dot[r][s] = fmaf(x[r].z, w.z, dot[r][s]);
        dot[r][s] = fmaf(x[r].w, w.w, dot[r][s]);
      }
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int s = 0; s < S; ++s)
        dot[r][s] += __shfl_xor_sync(kFullMask, dot[r][s], off);
}

// Entry `lane` of the S values x (0 where lane >= S).
template <int S>
__device__ __forceinline__ float pick(const float (&x)[S], int lane) {
  float mine = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (lane == s) mine = x[s];
  return mine;
}

// The S weights of token t, padded to a multiple of 4 in shared memory.
template <int S>
__device__ __forceinline__ void load_row(const float* w, float (&x)[padded(S)]) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < padded(S) / 4; ++j) {
    const float4 f = w4[j];
    x[4 * j] = f.x;
    x[4 * j + 1] = f.y;
    x[4 * j + 2] = f.z;
    x[4 * j + 3] = f.w;
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
sweep_fwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ q, float* __restrict__ a,
                 float* __restrict__ partial, int B, int N, int D, int T) {
  constexpr int SP = padded(S);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kFwdStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int tile = T * D;                           // floats of one tensor tile
  float* sq = ring + kFwdStages * 2 * tile;            // [S, D] q of the row
  float* sw = sq + S * D;                           // [2][T][SP] softmax weights
  float* sred = sw + 2 * T * SP;                    // [32][SP] S_a per group
  const long long BN = static_cast<long long>(B) * N;
  const int tid = threadIdx.x;

  init_barriers<kFwdStages>(full, empty);

  if (tid >= kConsumers) {                          // the producer
    if (tid == kConsumers) {
      Tiles it = block_tiles(BN, N, T);
      for (int i = 0; it.valid(); ++i, it.next()) {
        const int st = i % kFwdStages;
        if (i >= kFwdStages) mbar_wait(&empty[st], ((i / kFwdStages) - 1) & 1);
        const uint32_t bytes = it.count() * D * sizeof(float);
        float* dst = ring + st * 2 * tile;
        mbar_expect_tx(&full[st], 2 * bytes);
        bulk_load(dst, k + it.pos * D, bytes, &full[st]);
        bulk_load(dst + tile, v + it.pos * D, bytes, &full[st]);
      }
    }
    return;
  }

  using Lanes = DotLanes<S, fwd_max_tile<S>()>;
  constexpr int R = Lanes::R;
  const int lane = tid % Lanes::L, grp = tid / Lanes::L;
  const int D4 = D >> 2;
  const int c4 = (tid >> 5) * 8 + (tid & 7);   // A_v: columns 4 c4..,
  const int tg = (tid >> 3) & 3;               // tokens tg + 4 j
  float4 acc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
  float sacc = 0.f;   // S_a of this lane's slot over its group's tokens
  int row = -1;

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {                   // a new row: its q into shared memory
      const float* qb = q + static_cast<size_t>(b) * S * D;
      for (int e = tid; e < S * D; e += kConsumers) sq[e] = qb[e];
      consumer_sync();
      row = b;
    }
    const int st = i % kFwdStages;
    mbar_wait(&full[st], (i / kFwdStages) & 1);
    const float* kt = ring + st * 2 * tile;
    const float* vt = kt + tile;
    float* w = sw + (i & 1) * T * SP;

    // a = softmax over slots of k q^T: lane s of a group takes exp of
    // slot s, the group sums them with a butterfly
    int tok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = grp + r * Lanes::kGroups;
      tok[r] = t < count ? t : 0;
    }
    float dot[R][S];
    tile_dots<S, fwd_max_tile<S>()>(kt, sq, D, tok, lane, dot);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = dot[r][0];
#pragma unroll
      for (int s = 1; s < S; ++s) m = fmaxf(m, dot[r][s]);
      const float e = lane < S ? expf(pick<S>(dot[r], lane) - m) : 0.f;
      float sum = e;
#pragma unroll
      for (int off = Lanes::L / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      const int t = grp + r * Lanes::kGroups;
      if (t < count && lane < S) {
        const float mine = e / sum;
        a[(it.pos + t) * S + lane] = mine;
        w[t * SP + lane] = mine;
        sacc += mine;
      }
    }
    consumer_sync();

    // A_v: four feature columns a thread, every 4th token of the tile
    if (c4 < D4) {
      const float4* v4 = reinterpret_cast<const float4*>(vt);
#pragma unroll 2
      for (int t = tg; t < count; t += kTokenGroups) {
        const float4 x = v4[t * D4 + c4];
        float ws[SP];
        load_row<S>(w + t * SP, ws);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          acc[s].x = fmaf(ws[s], x.x, acc[s].x);
          acc[s].y = fmaf(ws[s], x.y, acc[s].y);
          acc[s].z = fmaf(ws[s], x.z, acc[s].z);
          acc[s].w = fmaf(ws[s], x.w, acc[s].w);
        }
      }
    }
    release(&empty[st]);

    if (it.ends_segment()) {          // this block's partial of row b
      float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * (S * D + SP);
#pragma unroll
      for (int s = 0; s < S; ++s) {   // the 4 token groups of the warp, summed
#pragma unroll
        for (int off = 8; off <= 16; off <<= 1) {
          acc[s].x += __shfl_xor_sync(kFullMask, acc[s].x, off);
          acc[s].y += __shfl_xor_sync(kFullMask, acc[s].y, off);
          acc[s].z += __shfl_xor_sync(kFullMask, acc[s].z, off);
          acc[s].w += __shfl_xor_sync(kFullMask, acc[s].w, off);
        }
      }
      if (tg == 0 && c4 < D4) {
        float4* p4 = reinterpret_cast<float4*>(p) + c4;
#pragma unroll
        for (int s = 0; s < S; ++s) p4[s * D4] = acc[s];
      }
#pragma unroll
      for (int s = 0; s < S; ++s) acc[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lane < S) sred[grp * SP + lane] = sacc;   // per group
      sacc = 0.f;
      consumer_sync();
      if (tid < S) {                  // S_a: the groups in order
        float total = 0.f;
        for (int g = 0; g < Lanes::kGroups; ++g) total += sred[g * SP + tid];
        p[S * D + tid] = total;
      }
    }
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
sweep_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ q,
                 const float* __restrict__ g_av, const float* __restrict__ g_a,
                 float* __restrict__ gk, float* __restrict__ gv,
                 float* __restrict__ partial, int B, int N, int D, int T) {
  constexpr int SP = padded(S);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kBwdStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int tile = T * D;
  const int span = span_floats(T, S);
  const int stage = 2 * tile + 2 * span;   // k, v, then the spans of a, g_a
  float* sg = ring + kBwdStages * stage;      // [S, D] g_av of the row
  float* sdl0 = sg + S * D;                // [2][T][SP] dl of the tile
  float* sa0 = sdl0 + 2 * T * SP;          // [2][T][SP] a of the tile
  const long long BN = static_cast<long long>(B) * N;
  const int tid = threadIdx.x;

  init_barriers<kBwdStages>(full, empty);

  if (tid >= kConsumers) {                 // the producer
    if (tid == kConsumers) {
      Tiles load = block_tiles(BN, N, T), out = load;
      auto store = [&](int st) {           // gk, gv of tile `out`, then next
        const uint32_t bytes = out.count() * D * sizeof(float);
        float* src = ring + st * stage;
        bulk_store(gk + out.pos * D, src, bytes);
        bulk_store(gv + out.pos * D, src + tile, bytes);
        bulk_commit();
        out.next();
      };
      int i = 0;
      for (; load.valid(); ++i, load.next()) {
        const int st = i % kBwdStages;
        if (i >= kBwdStages) {
          mbar_wait(&empty[st], ((i / kBwdStages) - 1) & 1);
          store(st);
          bulk_wait_read();
        }
        const int count = load.count();
        const uint32_t bytes = count * D * sizeof(float);
        // the tile's floats [f0, f1) of a and g_a: the bulk copies take
        // [s0, s1), 16-byte aligned and never past the tensor's last whole
        // 16 bytes; plain loads take the 1-3 floats of [s1, f1) after it
        const long long f0 = load.pos * S, f1 = f0 + static_cast<long long>(count) * S;
        const long long s0 = f0 & ~3LL;
        long long s1 = (f1 + 3) & ~3LL;
        if (s1 > ((BN * S) & ~3LL)) s1 = (BN * S) & ~3LL;
        if (s1 < s0) s1 = s0;
        const uint32_t span_bytes = static_cast<uint32_t>((s1 - s0) * sizeof(float));
        float* dst = ring + st * stage;
        for (long long f = s1; f < f1; ++f) {
          dst[2 * tile + (f - s0)] = a[f];
          dst[2 * tile + span + (f - s0)] = g_a[f];
        }
        if (s1 < f1) fence_async_shared();   // before a later bulk copy here
        // the arrival below releases the plain stores with the tile
        mbar_expect_tx(&full[st], 2 * bytes + 2 * span_bytes);
        bulk_load(dst, k + load.pos * D, bytes, &full[st]);
        bulk_load(dst + tile, v + load.pos * D, bytes, &full[st]);
        if (span_bytes) {
          bulk_load(dst + 2 * tile, a + s0, span_bytes, &full[st]);
          bulk_load(dst + 2 * tile + span, g_a + s0, span_bytes, &full[st]);
        }
      }
      for (int j = i < kBwdStages ? 0 : i - kBwdStages; j < i; ++j) {
        const int st = j % kBwdStages;
        mbar_wait(&empty[st], (j / kBwdStages) & 1);
        store(st);
      }
      bulk_wait_all();
    }
    return;
  }

  using Lanes = DotLanes<S, kBwdMaxTile>;
  constexpr int R = Lanes::R;
  const int lane = tid % Lanes::L, grp = tid / Lanes::L;
  float acc[S], qc[S], gc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = qc[s] = gc[s] = 0.f;
  int row = -1;

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {   // a new row: g_av into shared memory, q and g_av of
                      // this thread's column into registers
      const float* qb = q + static_cast<size_t>(b) * S * D;
      const float* gb = g_av + static_cast<size_t>(b) * S * D;
      for (int e = tid; e < S * D; e += kConsumers) sg[e] = gb[e];
      if (tid < D) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          qc[s] = qb[s * D + tid];
          gc[s] = gb[s * D + tid];
        }
      }
      consumer_sync();
      row = b;
    }
    const int st = i % kBwdStages;
    mbar_wait(&full[st], (i / kBwdStages) & 1);
    float* kt = ring + st * stage;
    float* vt = kt + tile;
    const int off = static_cast<int>((it.pos * S) & 3);   // into the spans
    const float* at = kt + 2 * tile + off;
    const float* gat = kt + 2 * tile + span + off;
    float* sdl = sdl0 + (i & 1) * T * SP;   // two buffers: the next tile's
    float* sa = sa0 + (i & 1) * T * SP;     // writes race no reader of these

    // dl: lane s of a group forms slot s
    int tok[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = grp + r * Lanes::kGroups;
      tok[r] = t < count ? t : 0;
    }
    float da[R][S];
    tile_dots<S, kBwdMaxTile>(vt, sg, D, tok, lane, da);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int t = grp + r * Lanes::kGroups;
      const int tr = tok[r];
      float as[S];
      float inner = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        as[s] = at[tr * S + s];
        da[r][s] += gat[tr * S + s];
        inner = fmaf(da[r][s], as[s], inner);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) da[r][s] = as[s] * (da[r][s] - inner);
      const float dl = pick<S>(da[r], lane), am = pick<S>(as, lane);
      if (t < count && lane < S) {
        sdl[t * SP + lane] = dl;
        sa[t * SP + lane] = am;
      }
    }
    consumer_sync();

    // gk, gv over k and v in the stage; gq's partial in registers
    if (tid < D) {
#pragma unroll 4
      for (int t = 0; t < count; ++t) {
        const float x = kt[t * D + tid];
        float dl[SP], as[SP];
        load_row<S>(sdl + t * SP, dl);
        load_row<S>(sa + t * SP, as);
        float gkx = 0.f, gvx = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          gkx = fmaf(dl[s], qc[s], gkx);
          gvx = fmaf(as[s], gc[s], gvx);
          acc[s] = fmaf(dl[s], x, acc[s]);
        }
        kt[t * D + tid] = gkx;
        vt[t * D + tid] = gvx;
      }
    }
    fence_async_shared();
    release(&empty[st]);

    if (it.ends_segment() && tid < D) {   // this block's partial of row b
      float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * (S * D);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        p[s * D + tid] = acc[s];
        acc[s] = 0.f;
      }
    }
  }
}

// Sums the partials of each batch row in block order: row b's partials are
// in the slots g + b, of `width` floats, of the blocks g whose ranges meet
// it. A slot's first `split` floats go to out0[b], the next `rest` to
// out1[b].
__global__ void __launch_bounds__(kReduceThreads)
reduce_rows(const float* __restrict__ partial, float* __restrict__ out0,
            float* __restrict__ out1, int width, int split, int rest, int N,
            long long BN, int G) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= split + rest) return;
  // the block holding token t is (t + 1) * G - 1 over BN, rounded down
  const long long first = static_cast<long long>(b) * N;
  const int g0 = static_cast<int>(((first + 1) * G - 1) / BN);
  const int g1 = static_cast<int>(((first + N) * G - 1) / BN);
  const float* p = partial + static_cast<size_t>(b) * width + e;
  float sum = 0.f;
#pragma unroll 8
  for (int g = g0; g <= g1; ++g) sum += p[static_cast<size_t>(g) * width];
  if (e < split)
    out0[static_cast<size_t>(b) * split + e] = sum;
  else
    out1[static_cast<size_t>(b) * rest + e - split] = sum;
}

bool shape_ok(int B, int N, int D, int max_blocks) {
  return B > 0 && N > 0 && D > 0 && D % 32 == 0 && D <= kMaxWidth &&
         max_blocks > 0;
}

// Dynamic shared memory one block of the current device may use.
size_t smem_limit() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return static_cast<size_t>(bytes);
}

// The tile of each kernel: the largest of its list whose ring fits, or 0.
int fwd_tile(int S, int D) {
  const size_t limit = smem_limit();
  for (int T : kFwdTiles)
    if ((S <= 8 || T <= kFwdMaxTileManySlots) && fwd_smem_bytes(S, D, T) <= limit)
      return T;
  return 0;
}

int bwd_tile(int S, int D) {
  const size_t limit = smem_limit();
  for (int T : kBwdTiles)
    if (bwd_smem_bytes(S, D, T) <= limit) return T;
  return 0;
}

// Blocks of one launch: one per SM, or one per tile of a small input.
int blocks(int B, int N, int T, int max_blocks) {
  const long long tiles = (static_cast<long long>(B) * N + T - 1) / T;
  return static_cast<int>(tiles < max_blocks ? tiles : max_blocks);
}

cudaError_t launch_reduce(const float* partial, float* out0, float* out1,
                          int width, int split, int rest, int B, int N, int G,
                          cudaStream_t stream) {
  const dim3 grid((split + rest + kReduceThreads - 1) / kReduceThreads, B);
  reduce_rows<<<grid, kReduceThreads, 0, stream>>>(
      partial, out0, out1, width, split, rest, N,
      static_cast<long long>(B) * N, G);
  return cudaGetLastError();
}

template <int S>
cudaError_t launch_fwd(const float* k, const float* v, const float* q, float* a,
                       float* sa, float* av, float* scratch, int B, int N, int D,
                       int max_blocks, cudaStream_t stream) {
  const int T = fwd_tile(S, D);
  if (T == 0) return cudaErrorInvalidValue;
  const int G = blocks(B, N, T, max_blocks);
  const size_t smem = fwd_smem_bytes(S, D, T);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_fwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sweep_fwd_kernel<S><<<G, kThreads, smem, stream>>>(k, v, q, a, scratch, B, N,
                                                     D, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, av, sa, S * D + padded(S), S * D, S, B, N, G,
                       stream);
}

template <int S>
cudaError_t launch_bwd(const float* k, const float* v, const float* a,
                       const float* q, const float* g_av, const float* g_a,
                       float* gk, float* gv, float* gq, float* scratch, int B,
                       int N, int D, int max_blocks, cudaStream_t stream) {
  const int T = bwd_tile(S, D);
  if (T == 0) return cudaErrorInvalidValue;
  const int G = blocks(B, N, T, max_blocks);
  const size_t smem = bwd_smem_bytes(S, D, T);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  sweep_bwd_kernel<S><<<G, kThreads, smem, stream>>>(k, v, a, q, g_av, g_a, gk,
                                                     gv, scratch, B, N, D, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, gq, nullptr, S * D, S * D, 0, B, N, G, stream);
}

// -- The heads kernels: any head count H dividing D, any S up to 32 --------
//
// The same function with H heads of hd = D / H columns: the logit of token
// n for slot s of head h is the dot product over head h's columns, the
// softmax runs jointly over the H * S logits, and column c of A_v takes the
// weights of its own head h(c) = c / hd. a, S_a and a's cotangent hold H * S
// values a token, in (h, s) order. The skeleton is the kernels' above (one
// producer thread, bulk copies into a ring, 8 consumer warps, one partial a
// (block, batch row), the row sums in reduce_rows); what differs:
// - Spans: a tile of k or v starts wherever pos * D puts it; the producer
//   fetches the 16-byte-aligned span that covers it, and reads the 1-3
//   floats after the tensor's last whole 16 bytes with plain loads (as the
//   single-head backward reads a and g_a). gk and gv go out with plain
//   stores from the consumers, so the backward's ring is only read.
// - Logits: a warp takes kTok tokens at a time and a lane one logit j of
//   each chunk of 32 (j = 32 jb + lane). q (the backward: g_av) of the row
//   sits in shared memory as qh[cc][j], cc the column within head h(j), so
//   the 32 lanes read 32 consecutive entries while the k values of a token
//   are one broadcast a head. V = 4 reads both 16 bytes at a time where
//   hd % 4 == 0 (so D % 4 == 0 and every tile starts 16-byte aligned), each
//   lane keeping V partial sums a token; V = 1 reads floats. The logits go
//   to a [T][H][SP] buffer in shared memory (SP = S rounded up to 4, the
//   padding 0), where the warp then takes the softmax (the backward: dl)
//   of each of its tokens.
// - Columns: a consumer thread takes columns tid, tid + 256, ... one at a
//   time, all S slots of it in registers (SM, the bucket of S: 8, 16 or
//   32), and walks every token of the tile reading its head's weights as
//   float4 broadcasts; the column's sums over the tile are added to the
//   block's partial of the row in the scratch, which only this thread
//   touches (written at the segment's first tile), so nothing is kept in
//   registers across tiles and D has no limit but shared memory.
// - Tiles and stages: the C entry chooses the largest tile of kHeadsTiles
//   whose ring fits the card's shared memory (the backward takes 3 stages
//   where they fit, else 2); a shape that does not fit with one token is
//   refused.
// Bound: bytes, as above: k and v are read once (the backward also writes
// gk and gv), a and g_a are B * N * H * S floats, and the FLOPs do not grow
// with H (H * S dot products of length hd).

constexpr int kWarps = kConsumers / 32;
constexpr int kTok = 4;                        // tokens a warp takes at once
constexpr int kHeadsMaxSlots = 32;
constexpr int kHeadsTiles[] = {64, 48, 32, 24, 16, 8, 4, 2, 1};
constexpr int kHeadsFwdStages = 2;
constexpr int kHeadsBwdStages[] = {3, 2};      // preferred first, for each tile
constexpr int kMaxStages = kHeaderBytes / (2 * static_cast<int>(sizeof(uint64_t)));

__host__ __device__ inline size_t heads_fwd_smem_bytes(int S, int D, int H, int T,
                                                       int stages) {
  const size_t HSP = static_cast<size_t>(H) * padded(S);
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(stages) * 2 * span_floats(T, D) +
                          padded(S * D) + 2 * T * HSP);
}

__host__ __device__ inline size_t heads_bwd_smem_bytes(int S, int D, int H, int T,
                                                       int stages) {
  const size_t HSP = static_cast<size_t>(H) * padded(S);
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(stages) *
                              (2 * span_floats(T, D) + 2 * span_floats(T, H * S)) +
                          2 * padded(S * D) + 4 * T * HSP);
}

__device__ __forceinline__ void init_barriers_n(uint64_t* full, uint64_t* empty,
                                                int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The floats [f0, f1) of a tensor of `total` floats, fetched into dst: the
// bulk copy takes [s0, s1), 16-byte aligned and never past the tensor's last
// whole 16 bytes; plain loads take [s1, f1). dst[f - s0] holds float f.
struct Span {
  long long s0, s1;
  __device__ Span(long long f0, long long f1, long long total) {
    s0 = f0 & ~3LL;
    s1 = (f1 + 3) & ~3LL;
    if (s1 > (total & ~3LL)) s1 = total & ~3LL;
    if (s1 < s0) s1 = s0;
  }
  __device__ uint32_t bytes() const {
    return static_cast<uint32_t>((s1 - s0) * sizeof(float));
  }
  // The plain loads; true where there were any.
  __device__ bool tail(float* dst, const float* src, long long f1) const {
    for (long long f = s1; f < f1; ++f) dst[f - s0] = src[f];
    return s1 < f1;
  }
  __device__ void bulk(float* dst, const float* src, uint64_t* bar) const {
    if (s1 > s0) bulk_load(dst, src + s0, bytes(), bar);
  }
};

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

template <int V>
struct Vec {
  float x[V];
};

template <int V>
__device__ __forceinline__ Vec<V> load_vec(const float* p) {
  Vec<V> r;
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    r.x[0] = f.x;
    r.x[1] = f.y;
    r.x[2] = f.z;
    r.x[3] = f.w;
  } else {
    r.x[0] = *p;
  }
  return r;
}

// Row b's [S, D] matrix m (q or g_av) into shared memory as mh: entry
// (cc, j) of column cc of head h, logit j = h S + s, at
// (cc / V) * H * S * V + j * V + cc % V.
template <int V>
__device__ __forceinline__ void load_heads(float* mh, const float* m, int S, int D,
                                           int H) {
  const int hd = D / H, HS = H * S;
  for (int e = threadIdx.x; e < S * D; e += kConsumers) {
    const int s = e / D, c = e - s * D, h = c / hd, cc = c - h * hd;
    mh[(cc / V) * HS * V + (h * S + s) * V + cc % V] = m[e];
  }
}

// Where logit j = h S + s of token t sits in a [T][H][SP] buffer.
__device__ __forceinline__ int at_logit(int t, int j, int S, int SP, int HSP) {
  const int h = j / S;
  return t * HSP + h * SP + (j - h * S);
}

// The logits of this warp's tokens of a [T, D] tile x against mh, into the
// [T][H][SP] buffer out: tokens t0 + kWarps r (r < kTok, those below count),
// lane j of each chunk of 32 logits the dot product over head h(j)'s
// columns of x's token with logit j of mh.
template <int V>
__device__ __forceinline__ void head_dots(const float* x, const float* mh, float* out,
                                          int t0, int count, int D, int hd, int S,
                                          int SP, int HSP, int lane) {
  const int HS = (D / hd) * S;
  int tok[kTok];
#pragma unroll
  for (int r = 0; r < kTok; ++r) {
    const int t = t0 + r * kWarps;
    tok[r] = t < count ? t : t0;
  }
  for (int j = lane; j - lane < HS; j += 32) {
    const int jj = j < HS ? j : HS - 1;
    const float* xr = x + (jj / S) * hd;
    const float* mr = mh + jj * V;
    float acc[kTok][V];
#pragma unroll
    for (int r = 0; r < kTok; ++r)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
#pragma unroll 2
    for (int cc = 0; cc < hd; cc += V) {
      const Vec<V> w = load_vec<V>(mr + cc * HS);
#pragma unroll
      for (int r = 0; r < kTok; ++r) {
        const Vec<V> xv = load_vec<V>(xr + tok[r] * D + cc);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = fmaf(xv.x[e], w.x[e], acc[r][e]);
      }
    }
    if (j < HS) {
#pragma unroll
      for (int r = 0; r < kTok; ++r) {
        float sum = acc[r][0];
#pragma unroll
        for (int e = 1; e < V; ++e) sum += acc[r][e];
        if (t0 + r * kWarps < count) out[at_logit(tok[r], j, S, SP, HSP)] = sum;
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFullMask, x, off);
  return x;
}

// Adds x to a partial this thread owns, or writes it at a segment's first tile.
__device__ __forceinline__ void add_partial(float* p, float x, bool fresh) {
  *p = fresh ? x : *p + x;
}

template <int SM, int V>
__global__ void __launch_bounds__(kThreads, 1)
heads_fwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ q, float* __restrict__ a,
                 float* __restrict__ partial, int B, int N, int S, int D, int H,
                 int T, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int HS = H * S, hd = D / H, SP = padded(S), HSP = H * SP;
  const int span = span_floats(T, D);       // k, then v, a stage
  float* qh = ring + stages * 2 * span;     // q of the row, in head order
  float* w0 = qh + padded(S * D);           // [2][T][H][SP] logits, then weights
  const long long BN = static_cast<long long>(B) * N;
  const size_t width = static_cast<size_t>(S) * D + padded(HS);
  const int tid = threadIdx.x;

  init_barriers_n(full, empty, stages);

  if (tid >= kConsumers) {                  // the producer
    if (tid == kConsumers) {
      Tiles it = block_tiles(BN, N, T);
      for (int i = 0; it.valid(); ++i, it.next()) {
        const int st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        const long long f0 = it.pos * D, f1 = f0 + static_cast<long long>(it.count()) * D;
        const Span sp(f0, f1, BN * D);
        float* dst = ring + st * 2 * span;
        const bool tail = sp.tail(dst, k, f1) | sp.tail(dst + span, v, f1);
        if (tail) fence_async_shared();   // before a later bulk copy here
        mbar_expect_tx(&full[st], 2 * sp.bytes());
        sp.bulk(dst, k, &full[st]);
        sp.bulk(dst + span, v, &full[st]);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 2 * T * HSP; e += kConsumers) w0[e] = 0.f;   // the padding
  bool fresh = true;   // the tile starts this block's partial of its row
  int row = -1;

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {                   // a new row: its q into shared memory
      consumer_sync();                // (nobody reads the last row's any more)
      load_heads<V>(qh, q + static_cast<size_t>(b) * S * D, S, D, H);
      consumer_sync();
      row = b;
    }
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const int off = static_cast<int>((it.pos * D) & 3);
    const float* kt = ring + st * 2 * span + off;
    const float* vt = kt + span;
    float* w = w0 + (i & 1) * T * HSP;

    // the per-head dot products, then a = their softmax over heads x slots
    for (int t0 = warp; t0 < count; t0 += kWarps * kTok)
      head_dots<V>(kt, qh, w, t0, count, D, hd, S, SP, HSP, lane);
    __syncwarp();
    for (int t = warp; t < count; t += kWarps) {
      float m = neg_inf(), sum = 0.f;
      for (int j = lane; j < HS; j += 32) m = fmaxf(m, w[at_logit(t, j, S, SP, HSP)]);
      m = warp_max(m);
      for (int j = lane; j < HS; j += 32) {
        float* x = w + at_logit(t, j, S, SP, HSP);
        *x = expf(*x - m);
        sum += *x;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < HS; j += 32) {
        float* x = w + at_logit(t, j, S, SP, HSP);
        *x = *x / sum;
        a[(it.pos + t) * HS + j] = *x;
      }
    }
    consumer_sync();

    // A_v and S_a of the tile, into this block's partial of row b
    float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * width;
    for (int c = tid; c < D; c += kConsumers) {
      float acc[SM];
#pragma unroll
      for (int s = 0; s < SM; ++s) acc[s] = 0.f;
      const float* wr = w + (c / hd) * SP;
#pragma unroll 2
      for (int t = 0; t < count; ++t) {
        const float x = vt[t * D + c];
        const float4* w4 = reinterpret_cast<const float4*>(wr + t * HSP);
#pragma unroll
        for (int s4 = 0; s4 < SM / 4; ++s4) {
          if (4 * s4 < S) {
            const float4 f = w4[s4];
            acc[4 * s4] = fmaf(f.x, x, acc[4 * s4]);
            acc[4 * s4 + 1] = fmaf(f.y, x, acc[4 * s4 + 1]);
            acc[4 * s4 + 2] = fmaf(f.z, x, acc[4 * s4 + 2]);
            acc[4 * s4 + 3] = fmaf(f.w, x, acc[4 * s4 + 3]);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) add_partial(p + s * D + c, acc[s], fresh);
    }
    for (int j = tid; j < HS; j += kConsumers) {
      float total = 0.f;
      for (int t = 0; t < count; ++t) total += w[at_logit(t, j, S, SP, HSP)];
      add_partial(p + S * D + j, total, fresh);
    }
    release(&empty[st]);
    fresh = it.ends_segment();
  }
}

template <int SM, int V>
__global__ void __launch_bounds__(kThreads, 1)
heads_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ q,
                 const float* __restrict__ g_av, const float* __restrict__ g_a,
                 float* __restrict__ gk, float* __restrict__ gv,
                 float* __restrict__ partial, int B, int N, int S, int D, int H,
                 int T, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int HS = H * S, hd = D / H, SP = padded(S), HSP = H * SP;
  const int span = span_floats(T, D), span_a = span_floats(T, HS);
  const int stage = 2 * span + 2 * span_a;  // k, v, then the spans of a, g_a
  float* qh = ring + stages * stage;        // q and g_av of the row, head order
  float* gh = qh + padded(S * D);
  float* sdl0 = gh + padded(S * D);         // [2][T][H][SP] da, then dl
  float* sa0 = sdl0 + 2 * T * HSP;          // [2][T][H][SP] a of the tile
  const long long BN = static_cast<long long>(B) * N;
  const int tid = threadIdx.x;

  init_barriers_n(full, empty, stages);

  if (tid >= kConsumers) {                  // the producer
    if (tid == kConsumers) {
      Tiles it = block_tiles(BN, N, T);
      for (int i = 0; it.valid(); ++i, it.next()) {
        const int st = i % stages;
        if (i >= stages) mbar_wait(&empty[st], ((i / stages) - 1) & 1);
        const long long count = it.count();
        const long long f0 = it.pos * D, f1 = f0 + count * D;
        const long long h0 = it.pos * HS, h1 = h0 + count * HS;
        const Span sp(f0, f1, BN * D), sp_a(h0, h1, BN * HS);
        float* dst = ring + st * stage;
        bool tail = sp.tail(dst, k, f1) | sp.tail(dst + span, v, f1);
        tail |= sp_a.tail(dst + 2 * span, a, h1) |
                sp_a.tail(dst + 2 * span + span_a, g_a, h1);
        if (tail) fence_async_shared();   // before a later bulk copy here
        mbar_expect_tx(&full[st], 2 * sp.bytes() + 2 * sp_a.bytes());
        sp.bulk(dst, k, &full[st]);
        sp.bulk(dst + span, v, &full[st]);
        sp_a.bulk(dst + 2 * span, a, &full[st]);
        sp_a.bulk(dst + 2 * span + span_a, g_a, &full[st]);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int e = tid; e < 4 * T * HSP; e += kConsumers) sdl0[e] = 0.f;   // the padding
  bool fresh = true;
  int row = -1;

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {   // a new row: q and g_av into shared memory
      consumer_sync();
      load_heads<V>(qh, q + static_cast<size_t>(b) * S * D, S, D, H);
      load_heads<V>(gh, g_av + static_cast<size_t>(b) * S * D, S, D, H);
      consumer_sync();
      row = b;
    }
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const float* base = ring + st * stage;
    const float* kt = base + ((it.pos * D) & 3);
    const float* vt = base + span + ((it.pos * D) & 3);
    const float* at = base + 2 * span + ((it.pos * HS) & 3);
    const float* gat = at + span_a;
    float* sdl = sdl0 + (i & 1) * T * HSP;   // two buffers: the next tile's
    float* sa = sa0 + (i & 1) * T * HSP;     // writes race no reader of these

    // da = v . g_av per head + g_a, then dl = a (da - sum_j da_j a_j)
    for (int t0 = warp; t0 < count; t0 += kWarps * kTok)
      head_dots<V>(vt, gh, sdl, t0, count, D, hd, S, SP, HSP, lane);
    __syncwarp();
    for (int t = warp; t < count; t += kWarps) {
      float inner = 0.f;
      for (int j = lane; j < HS; j += 32) {
        const int x = at_logit(t, j, S, SP, HSP);
        const float aj = at[t * HS + j], da = sdl[x] + gat[t * HS + j];
        sdl[x] = da;
        sa[x] = aj;
        inner = fmaf(da, aj, inner);
      }
      inner = warp_sum(inner);
      for (int j = lane; j < HS; j += 32) {
        const int x = at_logit(t, j, S, SP, HSP);
        sdl[x] = sa[x] * (sdl[x] - inner);
      }
    }
    consumer_sync();

    // gk, gv of columns tid, tid + 256, ...; gq's sums into the partial
    float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * (static_cast<size_t>(S) * D);
    for (int c = tid; c < D; c += kConsumers) {
      const int h = c / hd, cc = c - h * hd;
      const float* qc_at = qh + (cc / V) * HS * V + h * S * V + cc % V;
      const float* gc_at = gh + (qc_at - qh);
      float qc[SM], gc[SM], acc[SM];
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        qc[s] = s < S ? qc_at[s * V] : 0.f;
        gc[s] = s < S ? gc_at[s * V] : 0.f;
        acc[s] = 0.f;
      }
      const float* dlr = sdl + h * SP;
      const float* ar = sa + h * SP;
#pragma unroll 2
      for (int t = 0; t < count; ++t) {
        const float x = kt[t * D + c];
        const float4* dl4 = reinterpret_cast<const float4*>(dlr + t * HSP);
        const float4* a4 = reinterpret_cast<const float4*>(ar + t * HSP);
        float gkx[4] = {0.f, 0.f, 0.f, 0.f}, gvx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int s4 = 0; s4 < SM / 4; ++s4) {
          if (4 * s4 < S) {
            const float4 d = dl4[s4], f = a4[s4];
            const float dv[4] = {d.x, d.y, d.z, d.w}, av[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              gkx[e] = fmaf(dv[e], qc[4 * s4 + e], gkx[e]);
              gvx[e] = fmaf(av[e], gc[4 * s4 + e], gvx[e]);
              acc[4 * s4 + e] = fmaf(dv[e], x, acc[4 * s4 + e]);
            }
          }
        }
        const long long at_t = (it.pos + t) * D + c;
        gk[at_t] = (gkx[0] + gkx[1]) + (gkx[2] + gkx[3]);
        gv[at_t] = (gvx[0] + gvx[1]) + (gvx[2] + gvx[3]);
      }
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) add_partial(p + s * D + c, acc[s], fresh);
    }
    release(&empty[st]);
    fresh = it.ends_segment();
  }
}

bool heads_shape_ok(int B, int N, int S, int D, int H, int max_blocks) {
  return B > 0 && N > 0 && S >= 1 && S <= kHeadsMaxSlots && H >= 1 && D > 0 &&
         D % H == 0 && max_blocks > 0;
}

// The heads kernels' tile and stages: the largest tile whose ring fits
// (the backward with 3 stages where they fit, else 2), or T = 0.
struct Plan {
  int T, stages;
};

Plan heads_fwd_plan(int S, int D, int H) {
  const size_t limit = smem_limit();
  for (int T : kHeadsTiles)
    if (heads_fwd_smem_bytes(S, D, H, T, kHeadsFwdStages) <= limit)
      return {T, kHeadsFwdStages};
  return {0, 0};
}

Plan heads_bwd_plan(int S, int D, int H) {
  const size_t limit = smem_limit();
  for (int T : kHeadsTiles)
    for (int stages : kHeadsBwdStages)
      if (heads_bwd_smem_bytes(S, D, H, T, stages) <= limit) return {T, stages};
  return {0, 0};
}

template <int SM, int V>
cudaError_t launch_heads_fwd(const float* k, const float* v, const float* q, float* a,
                             float* sa, float* av, float* scratch, int B, int N,
                             int S, int D, int H, int max_blocks,
                             cudaStream_t stream) {
  const Plan plan = heads_fwd_plan(S, D, H);
  if (plan.T == 0) return cudaErrorInvalidValue;
  const int G = blocks(B, N, plan.T, max_blocks);
  const size_t smem = heads_fwd_smem_bytes(S, D, H, plan.T, plan.stages);
  cudaError_t err = cudaFuncSetAttribute(heads_fwd_kernel<SM, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  heads_fwd_kernel<SM, V><<<G, kThreads, smem, stream>>>(k, v, q, a, scratch, B, N, S,
                                                         D, H, plan.T, plan.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, av, sa, S * D + padded(H * S), S * D, H * S, B, N, G,
                       stream);
}

template <int SM, int V>
cudaError_t launch_heads_bwd(const float* k, const float* v, const float* a,
                             const float* q, const float* g_av, const float* g_a,
                             float* gk, float* gv, float* gq, float* scratch, int B,
                             int N, int S, int D, int H, int max_blocks,
                             cudaStream_t stream) {
  const Plan plan = heads_bwd_plan(S, D, H);
  if (plan.T == 0) return cudaErrorInvalidValue;
  const int G = blocks(B, N, plan.T, max_blocks);
  const size_t smem = heads_bwd_smem_bytes(S, D, H, plan.T, plan.stages);
  cudaError_t err = cudaFuncSetAttribute(heads_bwd_kernel<SM, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  heads_bwd_kernel<SM, V><<<G, kThreads, smem, stream>>>(
      k, v, a, q, g_av, g_a, gk, gv, scratch, B, N, S, D, H, plan.T, plan.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, gq, nullptr, S * D, S * D, 0, B, N, G, stream);
}

}  // namespace

// The heads kernels' instantiations: the bucket of S (8, 16 or 32) and V (4
// where the head width is a multiple of 4, else 1).
#define OCRL_HEADS_DISPATCH(FN, ...)                                         \
  const bool v4 = (D / H) % 4 == 0;                                          \
  if (S <= 8)                                                                \
    return static_cast<int>(v4 ? FN<8, 4>(__VA_ARGS__) : FN<8, 1>(__VA_ARGS__)); \
  if (S <= 16)                                                               \
    return static_cast<int>(v4 ? FN<16, 4>(__VA_ARGS__)                      \
                               : FN<16, 1>(__VA_ARGS__));                    \
  return static_cast<int>(v4 ? FN<32, 4>(__VA_ARGS__) : FN<32, 1>(__VA_ARGS__))

#define OCRL_SWEEP_CASES(CASE) \
  CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) \
  CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)

// k, v: [B, N, D]; q: [B, S, D]; a: [B, N, S]; sa: [B, S]; av: [B, S, D];
// scratch: [min(max_blocks, B * N) + B, S * D + S rounded up to 4]. All
// fp32, contiguous, 16-byte aligned, on the current device. At most
// max_blocks blocks (the SM count). 1 <= S <= 16 and D a multiple of 32 up
// to 256; returns the CUDA error code of the launches (0 = none).
extern "C" int slot_routing_fwd(const float* k, const float* v,
                                const float* q, float* a, float* sa, float* av,
                                float* scratch, int B, int N, int S, int D,
                                int max_blocks, void* stream) {
  if (!shape_ok(B, N, D, max_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define OCRL_SWEEP_CASE(n) \
  case n:                  \
    return launch_fwd<n>(k, v, q, a, sa, av, scratch, B, N, D, max_blocks, st);
    OCRL_SWEEP_CASES(OCRL_SWEEP_CASE)
#undef OCRL_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// k, v: [B, N, D]; a: [B, N, S]; q, g_av: [B, S, D]; g_a: [B, N, S];
// gk, gv: [B, N, D]; gq: [B, S, D]; scratch: [min(max_blocks, B * N) + B,
// S * D]. All fp32, contiguous, 16-byte aligned, on the current device;
// shapes as for the forward. Returns the CUDA error code of the launches
// (0 = none).
extern "C" int slot_routing_bwd(const float* k, const float* v, const float* a,
                                const float* q, const float* g_av,
                                const float* g_a, float* gk, float* gv,
                                float* gq, float* scratch, int B, int N, int S,
                                int D, int max_blocks, void* stream) {
  if (!shape_ok(B, N, D, max_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (S) {
#define OCRL_SWEEP_CASE(n)                                                   \
  case n:                                                                    \
    return launch_bwd<n>(k, v, a, q, g_av, g_a, gk, gv, gq, scratch, B, N, D, \
                         max_blocks, st);
    OCRL_SWEEP_CASES(OCRL_SWEEP_CASE)
#undef OCRL_SWEEP_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// k, v: [B, N, D]; q: [B, S, D]; a: [B, N, H S]; sa: [B, H S]; av: [B, S,
// D]; scratch: [min(max_blocks, B * N) + B, S * D + H S rounded up to 4].
// All fp32, contiguous, 16-byte aligned, on the current device. k holds each
// head's columns pre-scaled by (D / H)^-0.5. 1 <= S <= 32, H dividing D,
// and a ring of one token that fits the card's shared memory
// (heads_fwd_smem_bytes, heads_bwd_smem_bytes); returns the CUDA error code
// of the launches (0 = none).
extern "C" int slot_routing_heads_fwd(const float* k, const float* v,
                                      const float* q, float* a, float* sa,
                                      float* av, float* scratch, int B, int N,
                                      int S, int D, int H, int max_blocks,
                                      void* stream) {
  if (!heads_shape_ok(B, N, S, D, H, max_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  OCRL_HEADS_DISPATCH(launch_heads_fwd, k, v, q, a, sa, av, scratch, B, N, S, D, H,
                      max_blocks, st);
}

// k, v: [B, N, D]; a, g_a: [B, N, H S]; q, g_av: [B, S, D]; gk, gv: [B, N,
// D]; gq: [B, S, D]; scratch: [min(max_blocks, B * N) + B, S * D]. As the
// heads forward for the rest; returns the CUDA error code of the launches.
extern "C" int slot_routing_heads_bwd(const float* k, const float* v,
                                      const float* a, const float* q,
                                      const float* g_av, const float* g_a,
                                      float* gk, float* gv, float* gq,
                                      float* scratch, int B, int N, int S, int D,
                                      int H, int max_blocks, void* stream) {
  if (!heads_shape_ok(B, N, S, D, H, max_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  OCRL_HEADS_DISPATCH(launch_heads_bwd, k, v, a, q, g_av, g_a, gk, gv, gq, scratch, B,
                      N, S, D, H, max_blocks, st);
}
