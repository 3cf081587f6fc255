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
#include <initializer_list>

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
// values a token, in (h, s) order. They replace the same TPU kernels where
// those hold one head, and the sums of JAX's einsum route
// (ocrl_tpu/models/slot_attention.py:96-103) for more.
// What bounds them: bytes, as above (k and v read once, the backward also
// writes gk and gv; a and g_a are B * N * H * S floats). The FLOPs do not
// grow with H but come near the bytes at many slots: at 24 slots of 256 the
// forward's fp32 FMAs take 57 % of its bytes' time on the CUDA cores. So
// every shared-memory load has to feed several FMAs (shared memory returns
// 128 bytes a cycle to an SM's 128 FMA lanes), and no lane may idle.
//
// The skeleton is the kernels' above (one producer thread, bulk copies into
// a ring, 8 consumer warps, one partial a (block, batch row), the row sums
// in reduce_rows). What differs:
// - Spans: a tile of k or v starts wherever pos * D puts it; the producer
//   fetches the 16-byte-aligned span that covers it, and reads the 1-3
//   floats after the tensor's last whole 16 bytes with plain loads (as the
//   single-head backward reads a and g_a).
// - Logits (the backward: da = v . g_av): a job is M tokens x one head x a
//   block of 8 slots, taken by a group of GH lanes (GH = 4 and M = 4 where
//   there are at least 4 (head, slot block) pairs or the head is narrow,
//   else GH = 32, M = 8 in the forward and 4 in the backward). Lane l of the
//   group reads chunks l, l + GH, .. of V floats of the head's columns of
//   each token and of each slot's row of q (g_av) of the row, [S, D] in
//   shared memory: distinct 16-byte words, no broadcasts, and a chunk of k
//   feeds 8 slots, a chunk of q M tokens. The M x 8 partial dot products
//   stay in registers; an xor reduce-scatter over the group leaves each
//   logit with one lane. A warp takes the jobs of its own blocks of M tokens
//   (tokens M (w + 8 i) ..).
// - Softmax (the backward: dl) in the lanes that hold the logits: a token's
//   logits lie with a few lanes a fixed xor apart (warp_logits), which take
//   its max and sum (the backward: sum_j da_j a_j) with butterflies and
//   write the weights (dl) to a [T][H][SP] buffer (SP = S rounded up to 8,
//   the padding 0) and a to global memory; where a block of tokens has more
//   than 8 jobs, the logits go through the buffer and a lane a logit
//   finishes each token. One consumer barrier a tile, before the columns.
// - Columns: a consumer thread owns a column item, V columns x a block of 8
//   slots, and walks every `groups`-th token of the tile: one load of V
//   floats of v (the backward: k) and two float4 of weights feed 8 V FMAs.
//   items x groups fills the 256 threads (at most 16 groups). The forward
//   adds the weights into S_a beside A_v. The backward also keeps q and g_av
//   of its item in registers, forms gk and gv of its V columns over its 8
//   slots, sums them over the item's slot blocks with full-warp shuffles
//   (lane groups of 1, 2 or 4, the padding lanes holding q = g_av = 0) and
//   stores 16 bytes each. Past 16 slots at V = 4 the backward takes the
//   column layout instead: an item is one column with all its slots (the
//   same 32 floats of registers), so no lane pads a slot block, no shuffle
//   sums gk and gv, and a warp's 32 lanes store 128 contiguous bytes of
//   each. A_v, S_a and gq stay in registers across the block's tiles; at a
//   segment's end the token groups are added in a fixed order through
//   shared memory (all but the first written at once, the first adding them
//   in group order) and the total goes to the block's scratch slot once.
//   Where the items pass 256 (groups = 0, the scratch variant: over 8 heads
//   of 512, say), a thread loops over items and adds each tile's sums into
//   the scratch slot, whose entries only it touches.
// - Registers: the block is 8 consumer warps and a producer warpgroup that
//   hands its registers to them (setmaxnreg), so the consumers hold an
//   item's 96 floats and a logits job without spilling.
// - The plan (heads_plan, mirrored by ops/slot_routing.py): V = 4 where hd
//   is a multiple of 4, else 1; GH; the items; the largest tile of
//   kHeadsTiles whose ring fits the card's shared memory (the backward with
//   3 stages where they fit, else 2), with the registers variant where its
//   token groups' buffer fits too; a shape that does not fit with one token
//   is refused. PERF.md has what each step bought on the card.

constexpr int kWarps = kConsumers / 32;
constexpr int kHeadsMaxSlots = 32;
constexpr int kHeadsTiles[] = {64, 48, 32, 24, 16, 8, 4, 2, 1};
constexpr int kHeadsFwdStages = 2;
constexpr int kHeadsBwdStages[] = {3, 2};      // preferred first, for each tile
constexpr int kMaxStages = kHeaderBytes / (2 * static_cast<int>(sizeof(uint64_t)));
constexpr int kSlotBlock = 8;                  // slots of a logits job, of a column item
constexpr int kNarrowLanes = 4;                // lanes of a logits job: 4 tokens
constexpr int kWideLanes = 32;                 // or 8 (the backward: 4)
constexpr int kNarrowHead = 16;                // chunks of a head below which GH = 4
constexpr int kMaxGroups = 16;                 // token groups of the column items
// A block: 8 consumer warps and a producer warpgroup (one thread of it
// streams), whose registers go to the consumers (setmaxnreg): ptxas reports
// 168 a thread (at launch a scheduler holds three of the 12 warps), and the
// code after the split runs with 56 (producer) and 224 (consumers).
constexpr int kHeadsThreads = kConsumers + 128;
constexpr int kProducerRegs = 56, kConsumerRegs = 224;

__host__ __device__ constexpr int padded8(int S) { return (S + 7) & ~7; }
__host__ __device__ constexpr int slot_blocks(int S) {
  return (S + kSlotBlock - 1) / kSlotBlock;
}
// The backward's slot blocks of a column item, padded to 1, 2 or 4 lanes.
__host__ __device__ constexpr int lane_blocks(int S) {
  return slot_blocks(S) == 1 ? 1 : slot_blocks(S) == 2 ? 2 : 4;
}
// Floats a column item keeps across tiles: its A_v (gq) and, forward, S_a.
__host__ __device__ constexpr int item_floats(int V, bool fwd) {
  return kSlotBlock * V + (fwd ? kSlotBlock : 0);
}

// `red` floats: the token groups' buffer, which shares the region of the
// logits buffers.
__host__ __device__ inline size_t heads_fwd_smem_bytes(int S, int D, int H, int T,
                                                       int stages, int red) {
  const size_t w = 2 * static_cast<size_t>(T) * H * padded8(S);
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(stages) * 2 * span_floats(T, D) +
                          padded(S * D) + (w > static_cast<size_t>(red) ? w : red));
}

__host__ __device__ inline size_t heads_bwd_smem_bytes(int S, int D, int H, int T,
                                                       int stages, int red) {
  const size_t w = 4 * static_cast<size_t>(T) * H * padded8(S);
  return kHeaderBytes +
         sizeof(float) * (static_cast<size_t>(stages) *
                              (2 * span_floats(T, D) + 2 * span_floats(T, H * S)) +
                          padded(S * D) + (w > static_cast<size_t>(red) ? w : red));
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

// The warpgroups' register split: every thread of a warpgroup calls one.
__device__ __forceinline__ void release_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void claim_registers() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
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

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *p = x[0];
}

// The 8 floats at p (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float (&x)[kSlotBlock]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4 f0 = p4[0], f1 = p4[1];
  x[0] = f0.x, x[1] = f0.y, x[2] = f0.z, x[3] = f0.w;
  x[4] = f1.x, x[5] = f1.y, x[6] = f1.z, x[7] = f1.w;
}

// Step K of reduce_scatter: offset GH >> K over the first N >> (K - 1)
// entries; a lane keeps one half (the upper where its bit is set) and adds
// its partner's copy of that half.
template <int N, int GH, int K>
__device__ __forceinline__ void reduce_scatter_step(float (&x)[N], int gl) {
  if constexpr ((GH >> K) > 0) {
    constexpr int o = GH >> K, n = N >> K;
    const bool up = gl & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = up ? x[i] : x[i + n];
      const float keep = up ? x[i + n] : x[i];
      x[i] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
    reduce_scatter_step<N, GH, K + 1>(x, gl);
  }
}

// Sums x over the GH lanes of a group (the lanes whose lane ids differ in
// their low log2(GH) bits only), each lane keeping N / GH of the sums: lane
// l ends with the sums of entries l N / GH .. (l + 1) N / GH - 1 in x[0 ..].
template <int N, int GH>
__device__ __forceinline__ void reduce_scatter(float (&x)[N], int gl) {
  reduce_scatter_step<N, GH, 1>(x, gl);
}

// One logits job: tokens t0 .. t0 + M - 1 (those below count) of the tile x
// (rows of D floats) against slots s0 .. s0 + 7 (those below S) of m (q or
// g_av of the row, rows of D floats) over head h's columns; lane gl of the
// group takes chunks gl, gl + GH, .. of V floats. The sums end in
// acc[0 .. M 8 / GH): lane gl holds entries gl M 8 / GH .. of the job's
// [M][8] logits (reduce_scatter). A job that is not live adds zeros (every
// lane of the warp takes part in the shuffles).
template <int V, int GH, int M>
__device__ __forceinline__ void logits_job(const float* x, const float* m,
                                           float (&acc)[M * kSlotBlock], int count, int D,
                                           int hd, int S, int t0, int h, int s0, bool live,
                                           int gl) {
#pragma unroll
  for (int i = 0; i < M * kSlotBlock; ++i) acc[i] = 0.f;
  if (live) {
    const int ns = S - s0;
    const float* xh = x + h * hd;
    const float* mh = m + s0 * D + h * hd;
    int row[M];
#pragma unroll
    for (int r = 0; r < M; ++r) row[r] = (t0 + r < count ? t0 + r : t0) * D;
    for (int c = gl * V; c < hd; c += GH * V) {
      Vec<V> xv[M];
#pragma unroll
      for (int r = 0; r < M; ++r) xv[r] = load_vec<V>(xh + row[r] + c);
#pragma unroll
      for (int s = 0; s < kSlotBlock; ++s) {
        if (s < ns) {
          const Vec<V> w = load_vec<V>(mh + s * D + c);
#pragma unroll
          for (int r = 0; r < M; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[r * kSlotBlock + s] = fmaf(xv[r].x[e], w.x[e], acc[r * kSlotBlock + s]);
        }
      }
    }
  }
  reduce_scatter<M * kSlotBlock, GH>(acc, gl);
}

// Where a tile's logits go once summed: the [T][H][SP] buffer w (the
// forward's weights or logits, the backward's da and then dl), the
// backward's a in sa ([T][H][SP]), the forward's a of the tile's first token
// (global, H S floats a token), the backward's spans of a and g_a.
struct TileOut {
  float* w;
  float* sa;
  float* a;
  const float* at;
  const float* gat;
  int S, SP, HS, HSP;
};

// The softmax (kFwd: the weights into w, a into global) or dl (into w, a
// into sa) of the logits this lane holds, entry k logit (h[k], s[k]) of
// token t[k] of the tile where ok[k]; the token's other logits are held by
// the lanes lane ^ o, o = o_lo, 2 o_lo, .. below o_hi.
template <bool kFwd, int K>
__device__ __forceinline__ void finish_held(const TileOut& f, const float (&x)[K],
                                            const int (&t)[K], const int (&h)[K],
                                            const int (&s)[K], const bool (&ok)[K],
                                            int o_lo, int o_hi) {
  if constexpr (kFwd) {
    float m = neg_inf();
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (ok[k]) m = fmaxf(m, x[k]);
    for (int o = o_lo; o < o_hi; o <<= 1) m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
    float e[K], sum = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k] = ok[k] ? expf(x[k] - m) : 0.f;
      sum += e[k];
    }
    for (int o = o_lo; o < o_hi; o <<= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
        const float y = e[k] / sum;
        f.w[t[k] * f.HSP + h[k] * f.SP + s[k]] = y;
        f.a[static_cast<size_t>(t[k]) * f.HS + h[k] * f.S + s[k]] = y;
      }
    }
  } else {
    float da[K], aj[K], inner = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      da[k] = aj[k] = 0.f;
      if (ok[k]) {
        const int j = t[k] * f.HS + h[k] * f.S + s[k];
        aj[k] = f.at[j];
        da[k] = x[k] + f.gat[j];
        inner = fmaf(da[k], aj[k], inner);
      }
    }
    for (int o = o_lo; o < o_hi; o <<= 1) inner += __shfl_xor_sync(kFullMask, inner, o);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (ok[k]) {
        const int y = t[k] * f.HSP + h[k] * f.SP + s[k];
        f.w[y] = aj[k] * (da[k] - inner);
        f.sa[y] = aj[k];
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

// Where logit j = h S + s sits in a token's [H][SP] row.
__device__ __forceinline__ int at_logit(int j, int S, int SP) {
  const int h = j / S;
  return h * SP + (j - h * S);
}

// The softmax of one token's H S logits (its [H][SP] row wt), in place and
// into a_t (H S floats in (h, s) order); x: this lane's logit where HS <= 32.
__device__ __forceinline__ void softmax_token(float* wt, float* a_t, int S, int SP, int HS,
                                              int x, int lane) {
  if (HS <= 32) {
    const float l = lane < HS ? wt[x] : neg_inf();
    const float m = warp_max(l);
    const float e = lane < HS ? expf(l - m) : 0.f;
    const float sum = warp_sum(e);
    if (lane < HS) {
      const float y = e / sum;
      wt[x] = y;
      a_t[lane] = y;
    }
    return;
  }
  float m = neg_inf(), sum = 0.f;
  for (int j = lane; j < HS; j += 32) m = fmaxf(m, wt[at_logit(j, S, SP)]);
  m = warp_max(m);
  for (int j = lane; j < HS; j += 32) {
    float* y = wt + at_logit(j, S, SP);
    *y = expf(*y - m);
    sum += *y;
  }
  sum = warp_sum(sum);
  for (int j = lane; j < HS; j += 32) {
    float* y = wt + at_logit(j, S, SP);
    *y = *y / sum;
    a_t[j] = *y;
  }
}

// dl = a (da - sum_j da_j a_j) of one token, da = its [H][SP] row dt (v .
// g_av) + g_a: dt becomes dl and at_s gets a, both in [H][SP] order; a_t,
// ga_t: the token's H S floats of a and g_a.
__device__ __forceinline__ void dl_token(float* dt, float* at_s, const float* a_t,
                                         const float* ga_t, int S, int SP, int HS, int x,
                                         int lane) {
  if (HS <= 32) {
    float aj = 0.f, da = 0.f;
    if (lane < HS) {
      aj = a_t[lane];
      da = dt[x] + ga_t[lane];
    }
    const float inner = warp_sum(da * aj);
    if (lane < HS) {
      dt[x] = aj * (da - inner);
      at_s[x] = aj;
    }
    return;
  }
  float inner = 0.f;
  for (int j = lane; j < HS; j += 32) {
    const int y = at_logit(j, S, SP);
    const float aj = a_t[j], da = dt[y] + ga_t[j];
    dt[y] = da;
    at_s[y] = aj;
    inner = fmaf(da, aj, inner);
  }
  inner = warp_sum(inner);
  for (int j = lane; j < HS; j += 32) {
    const int y = at_logit(j, S, SP);
    dt[y] = at_s[y] * (dt[y] - inner);
  }
}

// The logits of warp `warp`'s blocks of M tokens (tokens M (warp + 8 i) ..)
// and their softmax (kFwd) or dl, into f. A block's jobs are its H heads x
// slot blocks, J of them:
// - GH = 32 (J <= 3 by the plan): the warp takes its blocks one by one and
//   each block's jobs in turn; lane l ends with kMine logits of token
//   kMine l / 8 in each job, and a token's logits lie with 8 / kMine lanes.
// - GH = 4, J <= 8: a round takes 8 / Jp blocks (Jp: J rounded up to a
//   power of two), group g job g % Jp of block g / Jp; lane gl of a group
//   holds the 8 logits of token gl of its job, and a token's logits lie with
//   the lanes 4 apart across the block's Jp groups.
// Both finish the tokens in registers (finish_held). Else (GH = 4, J > 8)
// the groups take the jobs in turn, the logits go to f.w, and a lane a
// logit finishes each token from there (softmax_token, dl_token).
template <int V, int GH, int M, bool kFwd>
__device__ __forceinline__ void warp_logits(const float* x, const float* m,
                                            const TileOut& f, int count, int D, int hd,
                                            int H, int S, int warp, int lane, int x_lane) {
  constexpr int kGroups = 32 / GH, N = M * kSlotBlock, kMine = N / GH;
  const int nsb = slot_blocks(S), J = H * nsb;
  const int blocks = (count + M - 1) / M;
  const int grp = lane / GH, gl = lane % GH;
  if constexpr (GH == kWideLanes) {
    constexpr int kJobs = 3, K = kJobs * kMine;
    for (int bi = warp; bi < blocks; bi += kWarps) {
      const int t0 = bi * M;
      float held[K];
      int t[K], h[K], s[K];
      bool ok[K];
#pragma unroll
      for (int j = 0; j < kJobs; ++j) {
        float acc[N];
        const int hj = j < J ? j / nsb : 0, sb = j < J ? j - hj * nsb : 0;
        if (j < J)
          logits_job<V, GH, M>(x, m, acc, count, D, hd, S, t0, hj, sb * kSlotBlock, true,
                               gl);
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          const int idx = kMine * gl + i, r = idx / kSlotBlock;
          const int k = j * kMine + i;
          held[k] = j < J ? acc[i] : 0.f;
          t[k] = t0 + r;
          h[k] = hj;
          s[k] = sb * kSlotBlock + idx % kSlotBlock;
          ok[k] = j < J && t0 + r < count && s[k] < S;
        }
      }
      finish_held<kFwd, K>(f, held, t, h, s, ok, 1, kSlotBlock / kMine);
    }
  } else {
    const int mine = warp < blocks ? (blocks - warp + kWarps - 1) / kWarps : 0;
    if (J <= kGroups) {
      const int Jp = J == 1 ? 1 : J == 2 ? 2 : J <= 4 ? 4 : 8;
      const int per_round = kGroups / Jp, b_in = grp / Jp, j = grp - b_in * Jp;
      const int hj = j < J ? j / nsb : 0, sb = j < J ? j - hj * nsb : 0;
      for (int b0 = 0; b0 < mine; b0 += per_round) {
        const int bl = b0 + b_in, t0 = (warp + bl * kWarps) * M;
        const bool live = bl < mine && j < J;
        float acc[N];
        logits_job<V, GH, M>(x, m, acc, count, D, hd, S, t0, hj, sb * kSlotBlock, live, gl);
        int t[kMine], h[kMine], s[kMine];
        bool ok[kMine];
#pragma unroll
        for (int i = 0; i < kMine; ++i) {
          t[i] = t0 + gl;
          h[i] = hj;
          s[i] = sb * kSlotBlock + i;
          ok[i] = live && t0 + gl < count && s[i] < S;
        }
        float held[kMine];
#pragma unroll
        for (int i = 0; i < kMine; ++i) held[i] = acc[i];
        finish_held<kFwd, kMine>(f, held, t, h, s, ok, GH, GH * Jp);
      }
    } else {
      const int jobs = mine * J;
      for (int j0 = 0; j0 < jobs; j0 += kGroups) {
        const int j = j0 + grp;
        const bool live = j < jobs;
        const int jj = live ? j : 0;
        const int hb = jj / nsb, sb = jj - hb * nsb;
        const int bi = hb / H, hj = hb - bi * H, t0 = (warp + bi * kWarps) * M;
        float acc[N];
        logits_job<V, GH, M>(x, m, acc, count, D, hd, S, t0, hj, sb * kSlotBlock, live, gl);
        if (live) {
#pragma unroll
          for (int i = 0; i < kMine; ++i) {
            const int idx = kMine * gl + i, r = idx / kSlotBlock;
            const int sl = sb * kSlotBlock + idx % kSlotBlock;
            if (t0 + r < count && sl < S) f.w[(t0 + r) * f.HSP + hj * f.SP + sl] = acc[i];
          }
        }
      }
      __syncwarp();
      for (int t0 = warp * M; t0 < count; t0 += kWarps * M)
        for (int t = t0; t < t0 + M && t < count; ++t) {
          if constexpr (kFwd)
            softmax_token(f.w + t * f.HSP, f.a + static_cast<size_t>(t) * f.HS, S, f.SP,
                          f.HS, x_lane, lane);
          else
            dl_token(f.w + t * f.HSP, f.sa + t * f.HSP, f.at + t * f.HS, f.gat + t * f.HS,
                     S, f.SP, f.HS, x_lane, lane);
        }
    }
  }
}

// A column item's sums over tokens t0, t0 + step, .. < count of a tile:
// x[s V + e] += w_ts v_t[e] and x[8 V + s] += w_ts, its V floats of v at
// vt + t * D and its 8 weights at wt + t * HSP.
template <int V>
__device__ __forceinline__ void av_tokens(const float* vt, const float* wt, int D, int HSP,
                                          int t0, int step, int count,
                                          float (&x)[item_floats(V, true)]) {
#pragma unroll 2
  for (int t = t0; t < count; t += step) {
    const Vec<V> y = load_vec<V>(vt + t * D);
    float w[kSlotBlock];
    load8(wt + t * HSP, w);
#pragma unroll
    for (int s = 0; s < kSlotBlock; ++s) {
#pragma unroll
      for (int e = 0; e < V; ++e) x[s * V + e] = fmaf(w[s], y.x[e], x[s * V + e]);
      x[kSlotBlock * V + s] += w[s];
    }
  }
}

// The backward of a column item over tokens t0, t0 + step, .. < count
// where live: gk and gv of its V columns over its 8 slots (dl q and a g_av,
// q and g_av of the item in qc and gc), summed over its group of nl lanes
// (its slot blocks) and stored by lanes 0 and nl / 2 of the group (lane 0
// both where nl = 1) at gk + t * D and gv + t * D; x[s V + e] += dl_ts
// k_t[e]. Its V floats of k are at kt + t * D, its dl and a at dlt, at + t *
// HSP. Every lane of the warp goes round count / step times (rounded up),
// the shuffles taking all 32 lanes; a round past count, or of a lane that
// is not live, adds and stores nothing.
template <int V>
__device__ __forceinline__ void bwd_tokens(const float* kt, const float* dlt,
                                           const float* at, float* gk, float* gv, int D,
                                           int HSP, int t0, int step, int count, bool live,
                                           const float (&qc)[kSlotBlock * V],
                                           const float (&gc)[kSlotBlock * V],
                                           float (&x)[kSlotBlock * V], int sb, int nl) {
  const int o = nl >> 1, rounds = (count + step - 1) / step;
  const bool up = sb & o, owner = (sb & (o - 1)) == 0;
  for (int i = 0; i < rounds; ++i) {
    const int t = t0 + i * step;
    const bool on = live && t < count;
    float g[2 * V];
#pragma unroll
    for (int e = 0; e < 2 * V; ++e) g[e] = 0.f;
    if (on) {
      const Vec<V> y = load_vec<V>(kt + t * D);
      float dl[kSlotBlock], as[kSlotBlock];
      load8(dlt + t * HSP, dl);
      load8(at + t * HSP, as);
#pragma unroll
      for (int s = 0; s < kSlotBlock; ++s) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          g[e] = fmaf(dl[s], qc[s * V + e], g[e]);
          g[V + e] = fmaf(as[s], gc[s * V + e], g[V + e]);
          x[s * V + e] = fmaf(dl[s], y.x[e], x[s * V + e]);
        }
      }
    }
    if (nl == 1) {
      if (on) {
        store_vec<V>(gk + t * D, g);
        store_vec<V>(gv + t * D, g + V);
      }
      continue;
    }
    // keep gk (gv where the lane's bit o is set), add the partner's copy
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float send = up ? g[e] : g[V + e];
      const float keep = up ? g[V + e] : g[e];
      g[e] = keep + __shfl_xor_sync(kFullMask, send, o);
    }
    if (nl == 4)
#pragma unroll
      for (int e = 0; e < V; ++e) g[e] += __shfl_xor_sync(kFullMask, g[e], 1);
    if (on && owner) store_vec<V>((up ? gv : gk) + t * D, g);
  }
}

// The backward of one column over tokens t0, t0 + step, .. < count (the
// column layout: more than 16 slots, V = 4): gk and gv of the column over
// all S slots (dl q and a g_av, q and g_av of the column in qc and gc,
// slots 0 .. 31), stored at gk + t * D and gv + t * D; x[s] += dl_ts k_t.
// The column's k is at kt + t * D, its head's dl and a at dlt, at + t *
// HSP. No lane waits on another: a lane that is not live does nothing.
template <int F>
__device__ __forceinline__ void col_tokens(const float* kt, const float* dlt,
                                           const float* at, float* gk, float* gv, int D,
                                           int HSP, int t0, int step, int count, bool live,
                                           const float (&qc)[F], const float (&gc)[F],
                                           float (&x)[F], int S) {
  if (!live) return;
  for (int t = t0; t < count; t += step) {
    const float y = kt[t * D];
    float gk4[4] = {0.f, 0.f, 0.f, 0.f}, gv4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s4 = 0; s4 < F / 4; ++s4) {
      if (4 * s4 < S) {
        const float4 d = *reinterpret_cast<const float4*>(dlt + t * HSP + 4 * s4);
        const float4 a = *reinterpret_cast<const float4*>(at + t * HSP + 4 * s4);
        const float dv[4] = {d.x, d.y, d.z, d.w}, av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          gk4[e] = fmaf(dv[e], qc[4 * s4 + e], gk4[e]);
          gv4[e] = fmaf(av[e], gc[4 * s4 + e], gv4[e]);
          x[4 * s4 + e] = fmaf(dv[e], y, x[4 * s4 + e]);
        }
      }
    }
    gk[t * D] = (gk4[0] + gk4[1]) + (gk4[2] + gk4[3]);
    gv[t * D] = (gv4[0] + gv4[1]) + (gv4[2] + gv4[3]);
  }
}

// Writes (add: adds) one column's gq sums x[s], s < S, into the block's
// partial p of the row at s D + c (the column layout).
template <int F>
__device__ __forceinline__ void flush_col(float* p, const float (&x)[F], int S, int D,
                                          int c, bool add) {
#pragma unroll
  for (int s = 0; s < F; ++s) {
    if (s < S) {
      float* y = p + s * D + c;
      *y = add ? *y + x[s] : x[s];
    }
  }
}

// Writes (add: adds) a column item's sums x into the block's partial p of
// the row: x[s V + e] to A_v (gq) at (s0 + s) D + cv V + e, and in the
// forward (kSa) x[8 V + s] to S_a at S D + h S + s0 + s from the item that
// holds its head's first chunk; slots from S on are padding.
template <int V, bool kSa>
__device__ __forceinline__ void flush_item(float* p, const float* x, int S, int D, int hd,
                                           int cv, int sb, bool add) {
  const int s0 = sb * kSlotBlock, c = cv * V;
#pragma unroll
  for (int s = 0; s < kSlotBlock; ++s) {
    if (s0 + s < S) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float* y = p + (s0 + s) * D + c + e;
        *y = add ? *y + x[s * V + e] : x[s * V + e];
      }
    }
  }
  if (kSa && c % hd == 0) {
    float* y = p + S * D + (c / hd) * S + s0;
#pragma unroll
    for (int s = 0; s < kSlotBlock; ++s)
      if (s0 + s < S) y[s] = add ? y[s] + x[kSlotBlock * V + s] : x[kSlotBlock * V + s];
  }
}

// Sums a column item's kept floats x over the token groups: groups 1 ..
// write theirs to red ([groups - 1][F][items] in shared memory) together and
// group 0 adds them in group order, ending with the total; then clears the
// region of `clear` floats that red shares with the logits buffers (their
// padding must read 0) and waits for every consumer. Every consumer thread
// calls it.
template <int F>
__device__ __forceinline__ void sum_groups(float (&x)[F], float* red, int clear, int items,
                                           int item, int tg, int groups, bool kept) {
  consumer_sync();                  // nobody reads the logits buffers any more
  if (kept && tg > 0) {
#pragma unroll
    for (int e = 0; e < F; ++e) red[((tg - 1) * F + e) * items + item] = x[e];
  }
  consumer_sync();
  if (kept && tg == 0) {
    for (int g = 1; g < groups; ++g)
#pragma unroll
      for (int e = 0; e < F; ++e) x[e] += red[((g - 1) * F + e) * items + item];
  }
  consumer_sync();
  for (int e = threadIdx.x; e < clear; e += kConsumers) red[e] = 0.f;
  consumer_sync();
}

template <int V, int GH>
__global__ void __launch_bounds__(kHeadsThreads, 1)
heads_fwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ q, float* __restrict__ a,
                 float* __restrict__ partial, int B, int N, int S, int D, int H,
                 int T, int stages, int groups) {
  constexpr int M = GH == kWideLanes ? 8 : 4;     // tokens a logits job
  constexpr int F = item_floats(V, true);         // A_v, then S_a, of an item
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int HS = H * S, hd = D / H, SP = padded8(S), HSP = H * SP;
  const int span = span_floats(T, D);       // k, then v, a stage
  float* sq = ring + stages * 2 * span;     // [S, D] q of the row
  float* w0 = sq + padded(S * D);           // [2][T][H][SP] logits, then weights
  const long long BN = static_cast<long long>(B) * N;
  const size_t width = static_cast<size_t>(S) * D + padded(HS);
  const int tid = threadIdx.x;

  init_barriers_n(full, empty, stages);

  if (tid >= kConsumers) {                  // the producer
    release_registers();
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
  claim_registers();

  const int warp = tid >> 5, lane = tid & 31;
  const int nsb = slot_blocks(S), items = D / V * nsb;
  const int region = max(2 * T * HSP, groups > 1 ? (groups - 1) * items * F : 0);
  for (int e = tid; e < region; e += kConsumers) w0[e] = 0.f;   // the padding
  const int x_lane = lane < HS ? at_logit(lane, S, SP) : 0;
  // this thread's column item and token group (the registers variant)
  const int tg = groups > 0 ? tid / items : 0;
  const int item = tid - tg * items;
  const bool kept = groups > 0 && tg < groups;
  const int cv = item / nsb, sb = item - cv * nsb;
  float keep[F];
#pragma unroll
  for (int e = 0; e < F; ++e) keep[e] = 0.f;
  bool fresh = true;   // the tile starts this block's partial of its row
  int row = -1;

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {                   // a new row: its q into shared memory
      consumer_sync();                // (nobody reads the last row's any more)
      const float* qb = q + static_cast<size_t>(b) * S * D;
      for (int e = tid; e < S * D; e += kConsumers) sq[e] = qb[e];
      consumer_sync();
      row = b;
    }
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const int off = static_cast<int>((it.pos * D) & 3);
    const float* kt = ring + st * 2 * span + off;
    const float* vt = kt + span;
    float* w = w0 + (i & 1) * T * HSP;

    // the logits of this warp's tokens, then a = their softmax
    const TileOut out{w, nullptr, a + it.pos * HS, nullptr, nullptr, S, SP, HS, HSP};
    warp_logits<V, GH, M, true>(kt, sq, out, count, D, hd, H, S, warp, lane, x_lane);
    __syncwarp();
    consumer_sync();

    // A_v and S_a of the column items
    float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * width;
    if (kept) {
      av_tokens<V>(vt + cv * V, w + (cv * V / hd) * SP + sb * kSlotBlock, D, HSP, tg,
                   groups, count, keep);
    } else if (groups == 0) {   // the scratch variant: keep holds one item's sums
      for (int j = tid; j < items; j += kConsumers) {
        const int jc = j / nsb, js = j - jc * nsb;
#pragma unroll
        for (int e = 0; e < F; ++e) keep[e] = 0.f;
        av_tokens<V>(vt + jc * V, w + (jc * V / hd) * SP + js * kSlotBlock, D, HSP, 0, 1,
                     count, keep);
        flush_item<V, true>(p, keep, S, D, hd, jc, js, !fresh);
      }
    }
    release(&empty[st]);

    if (it.ends_segment() && groups > 0) {   // this block's partial of row b
      if (groups > 1) sum_groups<F>(keep, w0, region, items, item, tg, groups, kept);
      if (kept && tg == 0) flush_item<V, true>(p, keep, S, D, hd, cv, sb, false);
#pragma unroll
      for (int e = 0; e < F; ++e) keep[e] = 0.f;
    }
    fresh = it.ends_segment();
  }
}

template <int V, int GH>
__global__ void __launch_bounds__(kHeadsThreads, 1)
heads_bwd_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ a, const float* __restrict__ q,
                 const float* __restrict__ g_av, const float* __restrict__ g_a,
                 float* __restrict__ gk, float* __restrict__ gv,
                 float* __restrict__ partial, int B, int N, int S, int D, int H,
                 int T, int stages, int groups) {
  constexpr int M = 4;                      // tokens a logits job
  constexpr int F = item_floats(V, false);  // gq of an item
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kHeaderBytes);
  const int HS = H * S, hd = D / H, SP = padded8(S), HSP = H * SP;
  const int span = span_floats(T, D), span_a = span_floats(T, HS);
  const int stage = 2 * span + 2 * span_a;  // k, v, then the spans of a, g_a
  float* sg = ring + stages * stage;        // [S, D] g_av of the row
  float* sdl0 = sg + padded(S * D);         // [2][T][H][SP] da, then dl
  float* sa0 = sdl0 + 2 * T * HSP;          // [2][T][H][SP] a of the tile
  const long long BN = static_cast<long long>(B) * N;
  const int tid = threadIdx.x;

  init_barriers_n(full, empty, stages);

  if (tid >= kConsumers) {                  // the producer
    release_registers();
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
  claim_registers();

  const int warp = tid >> 5, lane = tid & 31;
  // the column layout (an item is one column with all its slots) where
  // the slots pass 16 and the registers of 8 slots x 4 columns hold 32
  const bool cols = V == 4 && S > 2 * kSlotBlock;
  const int nsb = slot_blocks(S), nl = lane_blocks(S), items = cols ? D : D / V * nl;
  const int region = max(4 * T * HSP, groups > 1 ? (groups - 1) * items * F : 0);
  for (int e = tid; e < region; e += kConsumers) sdl0[e] = 0.f;   // the padding
  const int x_lane = lane < HS ? at_logit(lane, S, SP) : 0;
  const int tg = groups > 0 ? tid / items : 0;
  const int item = tid - tg * items;
  const bool kept = groups > 0 && tg < groups;
  const int cv = cols ? item : item / nl, sb = cols ? 0 : item - cv * nl;
  float qc[F], gc[F], keep[F];
#pragma unroll
  for (int e = 0; e < F; ++e) qc[e] = gc[e] = keep[e] = 0.f;
  bool fresh = true;
  int row = -1;

  // q and g_av of item (jc, js) of row b: 0 past S (and for padding lanes);
  // in the column layout, of column jc's slots 0 .. F - 1
  auto item_rows = [&](int b, int jc, int js, float (&qx)[F], float (&gx)[F]) {
    const float* qb = q + static_cast<size_t>(b) * S * D + jc * (cols ? 1 : V);
    const float* gb = g_av + static_cast<size_t>(b) * S * D + jc * (cols ? 1 : V);
    if (cols) {
#pragma unroll
      for (int sl = 0; sl < F; ++sl) {
        qx[sl] = sl < S ? qb[sl * D] : 0.f;
        gx[sl] = sl < S ? gb[sl * D] : 0.f;
      }
      return;
    }
#pragma unroll
    for (int s = 0; s < kSlotBlock; ++s) {
      const int sl = js * kSlotBlock + s;
      const bool in = js < nsb && sl < S;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        qx[s * V + e] = in ? qb[sl * D + e] : 0.f;
        gx[s * V + e] = in ? gb[sl * D + e] : 0.f;
      }
    }
  };

  Tiles it = block_tiles(BN, N, T);
  for (int i = 0; it.valid(); ++i, it.next()) {
    const int b = it.b(), count = it.count();
    if (b != row) {   // a new row: g_av into shared memory, the item's into registers
      consumer_sync();
      const float* gb = g_av + static_cast<size_t>(b) * S * D;
      for (int e = tid; e < S * D; e += kConsumers) sg[e] = gb[e];
      if (kept) item_rows(b, cv, sb, qc, gc);
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

    // da = v . g_av per head (this warp's tokens), then dl
    const TileOut out{sdl, sa, nullptr, at, gat, S, SP, HS, HSP};
    warp_logits<V, GH, M, false>(vt, sg, out, count, D, hd, H, S, warp, lane, x_lane);
    __syncwarp();
    consumer_sync();

    // gk, gv and gq's sums of the column items
    float* p = partial + (static_cast<size_t>(blockIdx.x) + b) * (static_cast<size_t>(S) * D);
    const long long g0 = it.pos * D;
    if (cols && groups > 0) {
      const int w_at = (cv / hd) * SP;
      col_tokens<F>(kt + cv, sdl + w_at, sa + w_at, gk + g0 + cv, gv + g0 + cv, D, HSP, tg,
                    groups, count, kept, qc, gc, keep, S);
    } else if (cols) {   // the scratch variant, a column at a time
      for (int j = tid; j < items; j += kConsumers) {
#pragma unroll
        for (int e = 0; e < F; ++e) keep[e] = 0.f;
        item_rows(b, j, 0, qc, gc);
        const int w_at = (j / hd) * SP;
        col_tokens<F>(kt + j, sdl + w_at, sa + w_at, gk + g0 + j, gv + g0 + j, D, HSP, 0, 1,
                      count, true, qc, gc, keep, S);
        flush_col<F>(p, keep, S, D, j, !fresh);
      }
    } else if (groups > 0) {   // every consumer thread (the shuffles), the kept ones live
      const int w_at = (cv * V / hd) * SP + (sb < nsb ? sb : 0) * kSlotBlock;
      bwd_tokens<V>(kt + cv * V, sdl + w_at, sa + w_at, gk + g0 + cv * V,
                    gv + g0 + cv * V, D, HSP, tg < groups ? tg : 0, groups, count, kept, qc,
                    gc, keep, sb, nl);
    } else {
      // the scratch variant: qc, gc and keep hold one item's rows and sums
      // at a time; every lane of a warp goes round together
      for (int j0 = 0; j0 < items; j0 += kConsumers) {
        const int j = j0 + tid;
        const bool live = j < items;
        const int jc = live ? j / nl : 0, js = live ? j - jc * nl : 0;
#pragma unroll
        for (int e = 0; e < F; ++e) keep[e] = 0.f;
        item_rows(b, jc, js, qc, gc);
        const int w_at = (jc * V / hd) * SP + (js < nsb ? js : 0) * kSlotBlock;
        bwd_tokens<V>(kt + jc * V, sdl + w_at, sa + w_at, gk + g0 + jc * V,
                      gv + g0 + jc * V, D, HSP, 0, 1, count, live, qc, gc, keep, js, nl);
        if (live && js < nsb) flush_item<V, false>(p, keep, S, D, hd, jc, js, !fresh);
      }
    }
    release(&empty[st]);

    if (it.ends_segment() && groups > 0) {   // this block's partial of row b
      if (groups > 1) sum_groups<F>(keep, sdl0, region, items, item, tg, groups, kept);
      if (kept && tg == 0 && cols) flush_col<F>(p, keep, S, D, cv, false);
      if (kept && tg == 0 && !cols && sb < nsb)
        flush_item<V, false>(p, keep, S, D, hd, cv, sb, false);
#pragma unroll
      for (int e = 0; e < F; ++e) keep[e] = 0.f;
    }
    fresh = it.ends_segment();
  }
}

bool heads_shape_ok(int B, int N, int S, int D, int H, int max_blocks) {
  return B > 0 && N > 0 && S >= 1 && S <= kHeadsMaxSlots && H >= 1 && D > 0 &&
         D % H == 0 && max_blocks > 0;
}

// The heads kernels' plan for one shape (see the note above): the tile and
// stages, the lanes of a logits job, the floats of a chunk, the column items
// and their token groups (0: the scratch variant); T = 0 where nothing fits.
struct HeadsPlan {
  int T, stages, lanes, V, items, groups;
};

HeadsPlan heads_plan(int S, int D, int H, bool fwd) {
  HeadsPlan p{};
  const int hd = D / H;
  p.V = hd % 4 == 0 ? 4 : 1;
  p.lanes = H * slot_blocks(S) >= 4 || hd / p.V < kNarrowHead ? kNarrowLanes : kWideLanes;
  p.items = fwd ? D / p.V * slot_blocks(S)
                : p.V == 4 && S > 2 * kSlotBlock ? D : D / p.V * lane_blocks(S);
  const int fill = p.items <= kConsumers ? kConsumers / p.items : 0;
  const int kept = fill < kMaxGroups ? fill : kMaxGroups;   // token groups
  const int fwd_stages[] = {kHeadsFwdStages};
  const int* stage_list = fwd ? fwd_stages : kHeadsBwdStages;
  const int n_stages = fwd ? 1 : 2;
  const int variants[] = {kept, 0};          // the registers variant first
  const size_t limit = smem_limit();
  for (int T : kHeadsTiles)
    for (int n = 0; n < n_stages; ++n)
      for (int groups : variants) {
        const int red = groups > 1 ? (groups - 1) * p.items * item_floats(p.V, fwd) : 0;
        const size_t bytes = fwd ? heads_fwd_smem_bytes(S, D, H, T, stage_list[n], red)
                                 : heads_bwd_smem_bytes(S, D, H, T, stage_list[n], red);
        if (bytes <= limit) {
          p.T = T;
          p.stages = stage_list[n];
          p.groups = groups;
          return p;
        }
      }
  p.T = 0;
  return p;
}

size_t heads_bytes(int S, int D, int H, const HeadsPlan& p, bool fwd) {
  const int red = p.groups > 1 ? (p.groups - 1) * p.items * item_floats(p.V, fwd) : 0;
  return fwd ? heads_fwd_smem_bytes(S, D, H, p.T, p.stages, red)
             : heads_bwd_smem_bytes(S, D, H, p.T, p.stages, red);
}

template <int V, int GH>
cudaError_t launch_heads_fwd(const HeadsPlan& plan, const float* k, const float* v,
                             const float* q, float* a, float* sa, float* av,
                             float* scratch, int B, int N, int S, int D, int H,
                             int max_blocks, cudaStream_t stream) {
  const int G = blocks(B, N, plan.T, max_blocks);
  const size_t smem = heads_bytes(S, D, H, plan, true);
  cudaError_t err = cudaFuncSetAttribute(heads_fwd_kernel<V, GH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  heads_fwd_kernel<V, GH><<<G, kHeadsThreads, smem, stream>>>(
      k, v, q, a, scratch, B, N, S, D, H, plan.T, plan.stages, plan.groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, av, sa, S * D + padded(H * S), S * D, H * S, B, N, G,
                       stream);
}

template <int V, int GH>
cudaError_t launch_heads_bwd(const HeadsPlan& plan, const float* k, const float* v,
                             const float* a, const float* q, const float* g_av,
                             const float* g_a, float* gk, float* gv, float* gq,
                             float* scratch, int B, int N, int S, int D, int H,
                             int max_blocks, cudaStream_t stream) {
  const int G = blocks(B, N, plan.T, max_blocks);
  const size_t smem = heads_bytes(S, D, H, plan, false);
  cudaError_t err = cudaFuncSetAttribute(heads_bwd_kernel<V, GH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  heads_bwd_kernel<V, GH><<<G, kHeadsThreads, smem, stream>>>(
      k, v, a, q, g_av, g_a, gk, gv, scratch, B, N, S, D, H, plan.T, plan.stages,
      plan.groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(scratch, gq, nullptr, S * D, S * D, 0, B, N, G, stream);
}

}  // namespace

// The heads kernels' instantiations: V (4 where the head width is a multiple
// of 4, else 1) and the lanes of a logits job (4 or 32), from the plan.
#define OCRL_HEADS_DISPATCH(FN, ...)                                           \
  if (plan.V == 4)                                                             \
    return static_cast<int>(plan.lanes == kWideLanes                           \
                                ? FN<4, kWideLanes>(plan, __VA_ARGS__)         \
                                : FN<4, kNarrowLanes>(plan, __VA_ARGS__));     \
  return static_cast<int>(plan.lanes == kWideLanes                             \
                              ? FN<1, kWideLanes>(plan, __VA_ARGS__)           \
                              : FN<1, kNarrowLanes>(plan, __VA_ARGS__))

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
// and a ring of one token that fits the card's shared memory (heads_plan);
// returns the CUDA error code of the launches (0 = none).
extern "C" int slot_routing_heads_fwd(const float* k, const float* v,
                                      const float* q, float* a, float* sa,
                                      float* av, float* scratch, int B, int N,
                                      int S, int D, int H, int max_blocks,
                                      void* stream) {
  if (!heads_shape_ok(B, N, S, D, H, max_blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const HeadsPlan plan = heads_plan(S, D, H, true);
  if (plan.T == 0) return static_cast<int>(cudaErrorInvalidValue);
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
  const HeadsPlan plan = heads_plan(S, D, H, false);
  if (plan.T == 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  OCRL_HEADS_DISPATCH(launch_heads_bwd, k, v, a, q, g_av, g_a, gk, gv, gq, scratch, B,
                      N, S, D, H, max_blocks, st);
}

// The plans the heads entries choose on the current device for S slots of
// width D in H heads: plan[0..6) tile, stages, lanes of a logits job, floats
// of a chunk, column items and token groups (0: the scratch variant) of the
// forward, plan[6..12) of the backward, and plan[12], plan[13] the shared
// memory of each in bytes. Returns cudaErrorInvalidValue, writing nothing,
// where the entries refuse the shape.
extern "C" int slot_routing_heads_plan(int S, int D, int H, int* plan) {
  if (!heads_shape_ok(1, 1, S, D, H, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const HeadsPlan fwd = heads_plan(S, D, H, true), bwd = heads_plan(S, D, H, false);
  if (fwd.T == 0 || bwd.T == 0) return static_cast<int>(cudaErrorInvalidValue);
  int i = 0;
  for (const HeadsPlan& p : {fwd, bwd}) {
    for (int x : {p.T, p.stages, p.lanes, p.V, p.items, p.groups}) plan[i++] = x;
  }
  plan[12] = static_cast<int>(heads_bytes(S, D, H, fwd, true));
  plan[13] = static_cast<int>(heads_bytes(S, D, H, bwd, false));
  return 0;
}
