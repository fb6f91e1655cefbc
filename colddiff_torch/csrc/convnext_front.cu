// ConvNeXt block front on Hopper (sm_90a): depthwise 7x7 conv (zero pad 3)
// + conv bias + per-image conditioning + channel LayerNorm, one pass.
//
//   out[b,h,w,:] = LN_c(dwconv7x7(x)[b,h,w,:] + bias + cond[b]) * gamma + beta
//
// Replaces the TPU kernel in colddiff/ops/pallas/convnext_front.py
// (_pallas_forward_packed -> _kernel_packed).  None of the TPU layout tricks
// carry over (lane packing, pltpu.roll, H tiling): they exist for 128-lane
// vector registers.  x and out are NHWC in memory (NCHW tensors in
// channels_last format); taps, bias, conditioning and the LayerNorm
// statistics are fp32 for fp32 and bf16 inputs, and the output rounds once.
// Three paths, picked by C: small C, the tile kernel, and its cluster form
// for wide C.
//
// Tile kernel (C >= 32, up to 1024).  What bounds it on the H100: operations
// in bf16, bytes in fp32.  Each output costs 49 fp32 FMAs; at the
// (16,128,128,64) front that is 822 M FMAs, 24.5 us at the 67 TFLOP/s fp32
// peak, while x read once and out written once are 67 MB in bf16 (20 us at
// 3.35 TB/s) and 134 MB in fp32 (40 us).  So the FMA pipe has to be kept
// busy: every other instruction (a shared load, a bf16 widening, an
// address) takes an issue slot from it, and the design is about issuing
// few of them per FMA.  How it gets each property:
//
// 1. A block owns a TH x TW tile of one image and all C channels of it
//    (grid ceil(W/TW) x ceil(H/TH) x B), so the LayerNorm closes inside the
//    block and one cond row serves it.  A thread owns one run of R
//    consecutive outputs along W and one channel pair in each of NIT chunks
//    of CK channels: 32 fp32 accumulators, 256 threads and 8,192 outputs a
//    block (512 and 16,384 at the largest tile).  The configuration is
//    compile-time and follows C (TileC64 .. TileC1024): 8x16 with R = 16 at
//    C <= 64, 8x8 with R = 8 at <= 128, 4x8 with R = 8 at <= 256, 4x4 with
//    R = 4 at <= 512 and at <= 1024 (CK = 256, 512 threads).  Where a
//    configuration would give the card fewer than kMinBlocks blocks (the
//    16 px levels), the next one is taken: 256 blocks at (16,16,16,256),
//    (16,16,16,512) and (16,16,16,1024).  The 4x4 tile at C = 1024 re-reads
//    the weights and the halo half as often as a 2x4 one, which was L2-bound.
// 2. The input halo of one channel chunk, (TH+6) x (TW+6) x CK, is staged
//    in shared memory once, in the input's dtype, zero outside the image
//    and beyond C, so the tap loop has no edge branches.  It arrives by
//    16-byte cp.async copies whose zero-fill (src-size 0) gives the
//    padding, whenever C fills 16-byte units and x is 16-byte aligned;
//    element loads otherwise.  Chunks stream through that buffer (largest
//    halo: 51 KB bf16 / 102 KB fp32 at the 4x4 tile, CK = 256), and the
//    accumulators stay in registers across them.  A warp reads 32
//    consecutive channel pairs of one pixel (4 or 8 bytes a lane,
//    contiguous), so the reads meet in no bank and need no swizzle.
// 3. x is reused from registers: for each of the 7 rows of its window, a
//    thread reads the R+6 inputs of that row once and the 7 weights of
//    that row once and does 7R FMAs per channel: (R+6+7)/(7R) shared loads
//    per FMA, 0.26 at R = 16, where one warp per pixel made 2 global loads
//    per FMA.  The dy and dx loops are unrolled; offsets inside the tile are
//    32-bit.  bf16 widens at the FMA (a shift or a mask per value).
// 4. The weights arrive in their torch layout [C, 49] ([C,1,7,7]
//    contiguous, already in the compute dtype): each chunk's CK x 49 run
//    is read with 16-byte loads and transposed into shared [49][CK+2] as
//    fp32, widened once per block (the padding of 2 staggers the banks of
//    the transposing stores).  bias + cond, gamma and beta are read once
//    per block into shared fp32 vectors.
// 5. The LayerNorm keeps the two-pass form (mean, then the mean of squared
//    deviations; biased variance), fp32.  A pixel's channels lie on the
//    threads of its run: within a warp a reduce-scatter over shuffles sums
//    the R pixels of the run (R - 1 shuffles, then R to broadcast), and
//    where a run spans several warps a shared array sums across them.  The
//    rounded outputs are staged in shared memory (the halo buffer, free by
//    then) and each pixel's C outputs leave with 16-byte stores.
// 6. It replaces an earlier warp-per-pixel kernel (2 global loads per FMA,
//    no reuse in registers, a weight transpose copy per call), whose
//    times stay in PERF.md.  Instantiations: the five configurations, each
//    for fp32 and bf16.
//
// Small C (C < 32): a second kernel, for the same TPU kernel at the
// channel counts it never took (the C=3 stem of every UNet, C=1 for MNIST,
// the narrow test UNets' C=8/16), where a channel pair per thread would
// idle most of a warp.  The small-C kernel gives each output pixel one
// thread, which holds all C channels in fp32 registers (padded to CP, a
// power of two, zeros beyond C) and runs the LayerNorm alone: no shuffles,
// no idle lanes, and each thread writes its C contiguous outputs beside its
// neighbour's.  A block owns a 16x16 output tile of one image (grid
// ceil(W/16) x ceil(H/16) x B, so one cond row per block) and first copies
// its 22x22xC input halo into shared memory as fp32, zeros outside the image
// and in the padding channels, so the 49-tap loop has no branches and reads
// only shared memory: 16-byte loads once CP >= 4, with the 16-byte chunks of
// each pixel XOR-swizzled at CP >= 8 so that a quarter-warp's loads meet in
// no bank.  Each input row of the tile is one contiguous NHWC run of 22*C
// elements, loaded coalesced, 8 loads per thread in flight at a time.  The
// weights arrive in their torch layout [C, 49] ([C,1,7,7] contiguous, no
// transpose copy per call) and are stored tap-major [49][CP] in shared
// memory.  Tile and shared bytes per CP (halo + weights + bias/cond, gamma,
// beta, all fp32): 16x16 at every CP; CP=1 2,144 B, 2 4,288, 4 8,576,
// 8 17,152, 16 34,304, 32 68,608 (dynamic shared memory above 48 KB, after
// cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// Its bound at the stem (16,128,128,3), counting one read of x and one write
// of out, 49 FMAs per output at 3.35 TB/s and 67 TFLOP/s fp32: 1.88 us in
// fp32 (6.29 MB, bytes-bound), 1.15 us in bf16 (77 MFLOP, operations-bound).
// What it spends instead: 49 shared loads of x and 49 broadcast loads of the
// weights per output (one 16-byte load each at CP=4), so shared-memory
// bandwidth, not device memory, sets its pace; reusing a row of x across
// several outputs of one thread is the next step.  Measured times beside
// these bounds are in PERF.md.
//
// Wide C (kTileMaxChannels < C <= kMaxChannels): the tile kernel's cluster
// form (TileCfg SPLIT).  One block holding all C channels of a tile would
// need shared memory past the 227 KB a block may have, and a tile shrunk to
// fit re-reads its halo and weights for few outputs (4x4 at C = 1024).  So
// the k = ceil(C / S) blocks of a thread block cluster (k <= 8, the
// portable size; grid k * tiles_x x tiles_y x B, cluster k x 1 x 1) share
// one spatial tile, and the block of cluster rank r runs the tile kernel's
// body on the slab of channels [r*S, min(C, (r+1)*S)): S = CAP, a multiple
// of 128 channels, so the 16-byte cp.async halo copies and output stores
// stay aligned; the last slab may be short, none is empty.  Only the
// LayerNorm's per-pixel sums cross between blocks: each block sums its slab
// (run_sum) into shared memory, and after a cluster barrier every block
// adds the k slab sums through distributed shared memory in rank order, so
// the k slabs of a pixel are normalized with bitwise the same mean and
// rstd; the same again for the squared deviations; a last barrier keeps
// each block's sums alive until its peers have read them.  Nothing goes
// through device memory but one read of x (with its halo) and one write of
// the output: no workspace.  The tile no longer shrinks as C grows: with
// S = 256 up to C = 2048 (4x16 in bf16, 8x8 in fp32), 4x4 with S = 512
// (256 threads) up to 4096 and with S = 1024 (512 threads) up to 8192; of
// six variants timed in turns (PERF.md), these were the fastest or level.
// Before the first launch at each k the launcher asks
// cudaOccupancyMaxActiveClusters whether the card can place one; if not,
// it returns the error rather than take another path.  Instantiations:
// three configurations for each of fp32 and bf16.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kTileMaxChannels = 1024;  // the tile kernel's largest C
constexpr int kMaxChannels = 8192;      // the cluster form's largest C
constexpr int kMaxCluster = 8;          // blocks of a cluster: the portable limit
constexpr int kSmallCLimit = 32;  // C < kSmallCLimit takes the small-C kernel
constexpr int kTile = 16;         // small-C output tile: kTile x kTile pixels
constexpr int kHalo = kTile + 6;  // its input tile side (zero pad 3 each way)
constexpr int kMinBlocks = 256;   // tile kernel: take a smaller tile below this

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Channels c, c+1 at p (4-byte aligned for bf16, 8 for fp32), widened.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);  // c in the low half
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 16 bytes global -> shared, asynchronous; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The two halves of a cluster barrier: all threads of all blocks arrive,
// then wait; the release / acquire order shared-memory accesses across it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct TileArgs {
  const void *x, *w, *bias, *cond, *gamma, *beta;
  void* out;
  int H, W, C, norm;
  float eps;
  int vec;   // C fills 16-byte units and x, out are 16-byte aligned
  int wvec;  // w is 16-byte aligned
};

// A tile kernel configuration: runs of R outputs along W, NIT chunks of CK
// channels, a TH x TW output tile; a thread for each of the (TH * TW / R)
// runs and CK / 2 channel pairs, 2 * NIT * R accumulators each.  SPLIT: the
// cluster form, where the blocks of a cluster share the tile and each holds
// a slab of CAP channels.
template <int R_, int NIT_, int CK_, int TH_, int TW_, bool SPLIT_ = false>
struct TileCfg {
  static constexpr int R = R_, NIT = NIT_, CK = CK_, TH = TH_, TW = TW_;
  static constexpr bool SPLIT = SPLIT_;
  static constexpr int HW = TW + 6;               // halo row length
  static constexpr int GK = CK / 2;               // threads per run
  static constexpr int CAP = NIT * CK;            // channels a block holds
  static constexpr int WP = CK + 2;               // shared weight row pitch
  static constexpr int HALO = (TH + 6) * HW * CK;  // halo elements of a chunk
  // the halo buffer also holds the staged outputs [TH*TW][CAP]
  static constexpr int XS = HALO > TH * TW * CAP ? HALO : TH * TW * CAP;
  static_assert(TW % R == 0 && XS % 8 == 0, "tile shape");
  static constexpr int THREADS = (TH * TW / R) * GK;  // one per run and channel pair
  static constexpr int MIN_BLOCKS = THREADS > 256 ? 1 : 2;
  static constexpr int RED = THREADS / 32 * R;        // partial sums of one pass
  static constexpr int STATS = SPLIT ? 3 * TH * TW : 0;  // slab sums of two passes, totals
  template <typename T>
  static constexpr int smem_bytes() {
    return (int)sizeof(T) * XS + (int)sizeof(float) * (49 * WP + 3 * CAP + 2 * RED + STATS);
  }
};
using TileC64 = TileCfg<16, 1, 64, 8, 16>;
using TileC128 = TileCfg<8, 2, 64, 8, 8>;
using TileC256 = TileCfg<8, 2, 128, 4, 8>;
using TileC512 = TileCfg<4, 4, 128, 4, 4>;
using TileC1024 = TileCfg<4, 4, 256, 4, 4>;
// the cluster form, by the largest C it takes (kMaxCluster slabs of CAP).
// Up to 2048 channels bf16 takes a 4x16 tile with R = 16 (fewer shared loads
// per FMA; its 56 KB halo leaves room for two blocks an SM), fp32 an 8x8
// tile (a 4x16 halo would be 112 KB, one block an SM).
template <typename T>
using SplitC2048 = std::conditional_t<sizeof(T) == 2, TileCfg<16, 2, 128, 4, 16, true>,
                                      TileCfg<8, 2, 128, 8, 8, true>>;
using SplitC4096 = TileCfg<4, 4, 128, 4, 4, true>;
using SplitC8192 = TileCfg<4, 4, 256, 4, 4, true>;

// One reduce-scatter step per level: with N partial sums a lane keeps N/2,
// the upper half where its lane bit o is set, and adds its partner's.
template <int N, int R>
__device__ __forceinline__ void reduce_scatter(float (&t)[R], int lane) {
  if constexpr (N > 1) {
    constexpr int h = N / 2, o = 16 * N / R;
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? t[i] : t[i + h], keep = up ? t[i + h] : t[i];
      t[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    reduce_scatter<h, R>(t, lane);
  }
}

// Sums v[r] over the GK threads of each run (a run's threads are GK
// consecutive ones: GK / 32 whole warps, or one); red holds THREADS / 32 * R
// floats.  Within a warp a reduce-scatter (R - 1 shuffles, not 5R) leaves
// lane l with the total of value l >> S; R shuffles hand every lane all R.
template <int R, int GK>
__device__ __forceinline__ void run_sum(float (&v)[R], float* red) {
  constexpr int S = R == 16 ? 1 : R == 8 ? 2 : R == 4 ? 3 : -1;  // 5 - log2(R)
  static_assert(S > 0, "R is 4, 8 or 16");
  const int lane = threadIdx.x & 31;
  float t[R];
#pragma unroll
  for (int r = 0; r < R; ++r) t[r] = v[r];
  reduce_scatter<R, R>(t, lane);
#pragma unroll
  for (int o = (1 << S) >> 1; o > 0; o >>= 1) t[0] += __shfl_xor_sync(0xffffffffu, t[0], o);
  if constexpr (GK > 32) {
    constexpr int nw = GK / 32;
    const int run = threadIdx.x / GK, wr = (threadIdx.x % GK) / 32;
    float* rr = red + run * R * nw;
    if ((lane & ((1 << S) - 1)) == 0) rr[(lane >> S) * nw + wr] = t[0];
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < nw; ++i) s += rr[r * nw + i];
      v[r] = s;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __shfl_sync(0xffffffffu, t[0], r << S);
  }
}

// The cluster form's LayerNorm sums: v[r], this block's slab sum for pixel r
// of its run (from run_sum), becomes the sum over the cluster's blocks,
// added in rank order, so every block of a cluster gets bitwise the same
// totals.  mine: this pass's [TH*TW] slab sums, read by the peers through
// distributed shared memory after the cluster barrier; it is not written
// again, and a block exits only after a last barrier.  tot: [TH*TW].
template <typename Cfg>
__device__ __forceinline__ void cluster_sum(float (&v)[Cfg::R], float* mine, float* tot,
                                            int run, int g) {
  constexpr int R = Cfg::R, P = Cfg::TH * Cfg::TW;
  cg::cluster_group cluster = cg::this_cluster();
  if (g == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) mine[run * R + r] = v[r];
  }
  cluster.sync();  // every block's slab sums are in place
  const unsigned k = cluster.num_blocks();
  for (int p = threadIdx.x; p < P; p += Cfg::THREADS) {
    float s = 0.f;
    for (unsigned q = 0; q < k; ++q) s += cluster.map_shared_rank(mine, q)[p];
    tot[p] = s;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = tot[run * R + r];
}

template <typename T, typename Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
convnext_front_tile_kernel(const TileArgs a) {
  constexpr int R = Cfg::R, NIT = Cfg::NIT, CK = Cfg::CK, TH = Cfg::TH, TW = Cfg::TW;
  constexpr int NT = Cfg::THREADS;
  constexpr int HW = Cfg::HW, GK = Cfg::GK, CAP = Cfg::CAP, WP = Cfg::WP;
  constexpr int U = 16 / sizeof(T);  // elements per 16-byte unit
  extern __shared__ float4 smem4[];
  T* xs = reinterpret_cast<T*>(smem4);  // [(TH+6)*(TW+6)][CK], later [TH*TW][CAP]
  float* ws = reinterpret_cast<float*>(xs + Cfg::XS);  // [49][WP], tap-major, fp32
  float* vs = ws + 49 * WP;   // [3][CAP]: bias+cond, gamma, beta
  float* red = vs + 3 * CAP;  // [2][THREADS/32*R]: LayerNorm partial sums
  float* stats = red + 2 * Cfg::RED;  // SPLIT: [3][TH*TW], see cluster_sum
  const int H = a.H, W = a.W, C = a.C;
  // the block's channels [cs, cs + cn): all C, or the slab of its cluster rank
  int tile_x = blockIdx.x, cs = 0;
  if constexpr (Cfg::SPLIT) {
    const cg::cluster_group cluster = cg::this_cluster();
    tile_x = blockIdx.x / cluster.num_blocks();
    cs = cluster.block_rank() * CAP;
  }
  const int cn = C - cs < CAP ? C - cs : CAP;
  const int nch = (cn + CK - 1) / CK;  // chunks that hold channels (<= NIT)
  const int tid = threadIdx.x;
  const int g = tid % GK, run = tid / GK;
  const int ty = run / (TW / R), tx0 = (run % (TW / R)) * R;
  const int x0 = tile_x * TW, y0 = blockIdx.y * TH;
  const int64_t b = blockIdx.z;
  const T* xb = static_cast<const T*>(a.x) + b * H * W * C + cs;
  const T* w = static_cast<const T*>(a.w) + cs * 49;

  for (int c = tid; c < CAP; c += NT) {
    float add = 0.f, gm = 0.f, bt = 0.f;
    if (c < cn) {
      add = to_f32(static_cast<const T*>(a.bias)[cs + c]);
      if (a.cond != nullptr) add += to_f32(static_cast<const T*>(a.cond)[b * C + cs + c]);
      if (a.norm) {
        gm = to_f32(static_cast<const T*>(a.gamma)[cs + c]);
        bt = to_f32(static_cast<const T*>(a.beta)[cs + c]);
      }
    }
    vs[c] = add;
    vs[CAP + c] = gm;
    vs[2 * CAP + c] = bt;
  }

  float2 acc[NIT][R];
#pragma unroll
  for (int j = 0; j < NIT; ++j) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[j][r] = make_float2(0.f, 0.f);
    if (j >= nch) continue;  // block-uniform
    if (j > 0) __syncthreads();  // the previous chunk's reads of xs and ws are done
    const int c0 = j * CK;
    // the halo of channels c0 .. c0+CK-1, zeros outside the image and from cn on
    if (a.vec) {
      constexpr int upp = CK / U, total = (TH + 6) * HW * upp;
      for (int i = tid; i < total; i += NT) {
        const int p = i / upp, u = i % upp;
        const int yy = y0 - 3 + p / HW, xx = x0 - 3 + p % HW, c = c0 + u * U;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W && c < cn;
        cp_async16(xs + p * CK + u * U, in ? xb + ((int64_t)yy * W + xx) * C + c : xb,
                   in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < Cfg::HALO; i += NT) {
        const int p = i / CK, c = c0 + i % CK;
        const int yy = y0 - 3 + p / HW, xx = x0 - 3 + p % HW;
        const bool in = yy >= 0 && yy < H && xx >= 0 && xx < W && c < cn;
        xs[i] = in ? xb[((int64_t)yy * W + xx) * C + c] : from_f32<T>(0.f);
      }
    }
    // the weights [C, 49]: this chunk's run of CK * 49, read coalesced (16
    // bytes a load where w is aligned; the run starts at a multiple of 64
    // channels), stored tap-major
    const T* wc = w + c0 * 49;
    const int nw = (cn - c0 < CK ? cn - c0 : CK) * 49;  // elements that exist
    if (a.wvec) {
      for (int i = tid * U; i < CK * 49; i += NT * U) {
        union {
          float4 f4;
          T e[U];
        } v;
        if (i + U <= nw) {
          v.f4 = *reinterpret_cast<const float4*>(wc + i);
        } else {
#pragma unroll
          for (int e = 0; e < U; ++e) v.e[e] = i + e < nw ? wc[i + e] : from_f32<T>(0.f);
        }
        int cl = i / 49, tap = i % 49;
#pragma unroll
        for (int e = 0; e < U; ++e) {
          ws[tap * WP + cl] = to_f32(v.e[e]);
          if (++tap == 49) {
            tap = 0;
            ++cl;
          }
        }
      }
    } else {
      for (int i = tid; i < CK * 49; i += NT)
        ws[(i % 49) * WP + i / 49] = i < nw ? to_f32(wc[i]) : 0.f;
    }
    cp_async_wait_all();
    __syncthreads();

    const T* xr0 = xs + (ty * HW + tx0) * CK + 2 * g;
    const float* wr0 = ws + 2 * g;
#pragma unroll
    for (int dy = 0; dy < 7; ++dy) {
      float2 wv[7];
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) wv[dx] = load2(wr0 + (dy * 7 + dx) * WP);
      const T* xr = xr0 + dy * HW * CK;
#pragma unroll
      for (int k = 0; k < R + 6; ++k) {
        const float2 xv = load2(xr + k * CK);
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) {
          const int r = k - dx;
          if (r >= 0 && r < R) {
            acc[j][r].x = fmaf(xv.x, wv[dx].x, acc[j][r].x);
            acc[j][r].y = fmaf(xv.y, wv[dx].y, acc[j][r].y);
          }
        }
      }
    }
  }

  // + bias + cond; channels from cn on hold 0 (zero x, weights and vectors)
  float part[R];
#pragma unroll
  for (int r = 0; r < R; ++r) part[r] = 0.f;
#pragma unroll
  for (int j = 0; j < NIT; ++j) {
    const float2 add = make_float2(vs[j * CK + 2 * g], vs[j * CK + 2 * g + 1]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[j][r].x += add.x;
      acc[j][r].y += add.y;
      part[r] += acc[j][r].x + acc[j][r].y;
    }
  }
  if (a.norm) {  // block-uniform
    run_sum<R, GK>(part, red);
    if constexpr (Cfg::SPLIT) cluster_sum<Cfg>(part, stats, stats + 2 * TH * TW, run, g);
    float mean[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mean[r] = part[r] / (float)C;
      part[r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NIT; ++j) {
      const int c = j * CK + 2 * g;
      const float m0 = c < cn ? 1.f : 0.f, m1 = c + 1 < cn ? 1.f : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d0 = (acc[j][r].x - mean[r]) * m0, d1 = (acc[j][r].y - mean[r]) * m1;
        part[r] = fmaf(d0, d0, fmaf(d1, d1, part[r]));
      }
    }
    run_sum<R, GK>(part, red + Cfg::RED);
    if constexpr (Cfg::SPLIT) {
      cluster_sum<Cfg>(part, stats + TH * TW, stats + 2 * TH * TW, run, g);
      cluster_arrive();  // this block's reads of its peers' sums are done
    }
#pragma unroll
    for (int r = 0; r < R; ++r) part[r] = rsqrtf(part[r] / (float)C + a.eps);
#pragma unroll
    for (int j = 0; j < NIT; ++j) {
      const int c = j * CK + 2 * g;
      const float g0 = vs[CAP + c], g1 = vs[CAP + c + 1];
      const float b0 = vs[2 * CAP + c], b1 = vs[2 * CAP + c + 1];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[j][r].x = (acc[j][r].x - mean[r]) * part[r] * g0 + b0;
        acc[j][r].y = (acc[j][r].y - mean[r]) * part[r] * g1 + b1;
      }
    }
  }

  // stage the rounded outputs [TH*TW][CAP] in the halo buffer, then store
  // each in-image pixel's cn outputs
  __syncthreads();  // every thread's reads of the last halo are done
#pragma unroll
  for (int j = 0; j < NIT; ++j) {
    if (j >= nch) continue;
#pragma unroll
    for (int r = 0; r < R; ++r)
      store2(xs + (run * R + r) * CAP + j * CK + 2 * g, acc[j][r].x, acc[j][r].y);
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + b * H * W * C + cs;
  if (a.vec) {
    const int upp = cn / U, total = TH * TW * upp;
    for (int i = tid; i < total; i += NT) {
      const int p = i / upp, u = i - p * upp;
      const int py = y0 + p / TW, px = x0 + p % TW;
      if (py < H && px < W)
        *reinterpret_cast<float4*>(ob + ((int64_t)py * W + px) * C + u * U) =
            *reinterpret_cast<const float4*>(xs + p * CAP + u * U);
    }
  } else {
    const int total = TH * TW * cn;
    for (int i = tid; i < total; i += NT) {
      const int p = i / cn, c = i - p * cn;
      const int py = y0 + p / TW, px = x0 + p % TW;
      if (py < H && px < W) ob[((int64_t)py * W + px) * C + c] = xs[p * CAP + c];
    }
  }
  // a block's sums stay in its shared memory until its peers have read them
  if constexpr (Cfg::SPLIT) {
    if (a.norm) cluster_wait();
  }
}

template <typename T, typename Cfg>
cudaError_t launch_tile_cfg(const TileArgs& a, int B, cudaStream_t stream) {
  constexpr int smem = Cfg::template smem_bytes<T>();
  const auto kernel = convnext_front_tile_kernel<T, Cfg>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int k = Cfg::SPLIT ? (a.C + Cfg::CAP - 1) / Cfg::CAP : 1;  // blocks per tile
  const dim3 grid(k * ((a.W + Cfg::TW - 1) / Cfg::TW), (a.H + Cfg::TH - 1) / Cfg::TH, B);
  if constexpr (!Cfg::SPLIT) {
    kernel<<<grid, Cfg::THREADS, smem, stream>>>(a);
    return cudaGetLastError();
  } else {
    if (k > kMaxCluster) return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = k;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(Cfg::THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    // before the first launch of each cluster size: can the card place one?
    static bool placed[kMaxCluster + 1];
    if (!placed[k]) {
      int clusters = 0;
      const cudaError_t e =
          cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel, &cfg);
      if (e != cudaSuccess) return e;
      if (clusters == 0) return cudaErrorInvalidConfiguration;
      placed[k] = true;
    }
    return cudaLaunchKernelEx(&cfg, kernel, a);
  }
}

// Blocks of a TH x TW tile over the batch.
template <typename Cfg>
int64_t tile_blocks(int B, int H, int W) {
  return (int64_t)((W + Cfg::TW - 1) / Cfg::TW) * ((H + Cfg::TH - 1) / Cfg::TH) * B;
}

// kTileMaxChannels < C <= kMaxChannels: f(Cfg{}) for the cluster form
// whose kMaxCluster slabs hold C.
template <typename T, typename F>
auto with_split_cfg(int C, F f) {
  if (C <= kMaxCluster * SplitC2048<T>::CAP) return f(SplitC2048<T>{});
  if (C <= kMaxCluster * SplitC4096::CAP) return f(SplitC4096{});
  return f(SplitC8192{});
}

// 32 <= C <= kMaxChannels; w is [C, 49], the torch layout.  Up to
// kTileMaxChannels, takes the first configuration that holds C and gives at
// least kMinBlocks blocks (or TileC1024); above, the cluster form.
template <typename T>
cudaError_t launch_tile(TileArgs a, int B, cudaStream_t stream) {
  if (B > 65535 || a.H > 65535) return cudaErrorInvalidValue;
  a.vec = a.C % (16 / (int)sizeof(T)) == 0 &&
          ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.out)) % 16) == 0;
  a.wvec = reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  const int C = a.C, H = a.H, W = a.W;
  if (C <= TileC64::CAP && tile_blocks<TileC64>(B, H, W) >= kMinBlocks)
    return launch_tile_cfg<T, TileC64>(a, B, stream);
  if (C <= TileC128::CAP && tile_blocks<TileC128>(B, H, W) >= kMinBlocks)
    return launch_tile_cfg<T, TileC128>(a, B, stream);
  if (C <= TileC256::CAP && tile_blocks<TileC256>(B, H, W) >= kMinBlocks)
    return launch_tile_cfg<T, TileC256>(a, B, stream);
  if (C <= TileC512::CAP && tile_blocks<TileC512>(B, H, W) >= kMinBlocks)
    return launch_tile_cfg<T, TileC512>(a, B, stream);
  if (C <= kTileMaxChannels) return launch_tile_cfg<T, TileC1024>(a, B, stream);
  return with_split_cfg<T>(C, [&](auto cfg) {
    return launch_tile_cfg<T, decltype(cfg)>(a, B, stream);
  });
}

// Shared floats of the small-C kernel: the halo tile [kHalo*kHalo][CP], the
// weights [49][CP], and bias+cond, gamma, beta [3][CP].
template <int CP>
constexpr int small_c_smem_floats() {
  return (kHalo * kHalo + 49 + 3) * CP;
}

// Where the 16-byte chunk k (channels 4k..4k+3) of halo pixel p sits in the
// pixel's CP floats: chunk k ^ swizzle<CP>(p).  A quarter-warp's 8 threads
// read 8 consecutive pixels; with CP >= 8 they would meet in the same bank
// groups (2-, 4- or 8-way at CP = 8, 16, 32), and the XOR spreads them over
// all 8 groups of 16 bytes.  At CP <= 4 a pixel is one chunk or less.
template <int CP>
__device__ __forceinline__ int swizzle(int p) {
  constexpr int kChunks = CP / 4;
  if constexpr (kChunks <= 1) {
    return 0;
  } else {
    return (p / (8 / kChunks)) % kChunks;
  }
}

template <typename T, int CP>
__global__ void __launch_bounds__(kTile * kTile)
convnext_front_small_c_kernel(const T* __restrict__ x, const T* __restrict__ w,
                              const T* __restrict__ bias, const T* __restrict__ cond,
                              const T* __restrict__ gamma, const T* __restrict__ beta,
                              T* __restrict__ out, int H, int W, int C, int norm,
                              float eps) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kHalo*kHalo][CP]
  float* ws = xs + kHalo * kHalo * CP;          // [49][CP], tap-major
  float* vs = ws + 49 * CP;                     // [3][CP]: bias+cond, gamma, beta
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * H * W * C;

  // Consecutive threads take consecutive channels of consecutive pixels, so
  // each tile row is read as one coalesced run; zeros outside the image and
  // in the channels C..CP-1.  Loads go in batches of 8 per thread, all in
  // flight before their stores.
  constexpr int kThreads = kTile * kTile;
  constexpr int kTileFloats = kHalo * kHalo * CP;
  constexpr int kBatch = 8;
  for (int i0 = tid; i0 < kTileFloats; i0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      const int c = i % CP, p = i / CP;
      const int yy = y0 - 3 + p / kHalo, xx = x0 - 3 + p % kHalo;
      v[u] = 0.f;
      if (i < kTileFloats && c < C && yy >= 0 && yy < H && xx >= 0 && xx < W)
        v[u] = to_f32(xb[((int64_t)yy * W + xx) * C + c]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i >= kTileFloats) continue;
      if constexpr (CP <= 4) {
        xs[i] = v[u];
      } else {
        const int c = i % CP, p = i / CP;
        xs[p * CP + (((c >> 2) ^ swizzle<CP>(p)) << 2) + (c & 3)] = v[u];
      }
    }
  }
  for (int i = tid; i < 49 * CP; i += kThreads) {
    const int c = i % CP, tap = i / CP;
    ws[i] = c < C ? to_f32(w[c * 49 + tap]) : 0.f;
  }
  if (tid < CP) {
    float add = 0.f, g = 0.f, be = 0.f;
    if (tid < C) {
      add = to_f32(bias[tid]);
      if (cond != nullptr) add += to_f32(cond[b * C + tid]);
      if (norm) {
        g = to_f32(gamma[tid]);
        be = to_f32(beta[tid]);
      }
    }
    vs[tid] = add;
    vs[CP + tid] = g;
    vs[2 * CP + tid] = be;
  }
  __syncthreads();

  const int tx = tid % kTile, ty = tid / kTile;
  const int px = x0 + tx, py = y0 + ty;
  if (px >= W || py >= H) return;  // after the block's only barrier

  float acc[CP];
#pragma unroll
  for (int k = 0; k < CP; ++k) acc[k] = 0.f;
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 7; ++dx) {
      const int p = (ty + dy) * kHalo + tx + dx;
      const float* xp = xs + p * CP;
      const float* wp = ws + (dy * 7 + dx) * CP;
      if constexpr (CP >= 4) {
        const int s = swizzle<CP>(p);
#pragma unroll
        for (int k = 0; k < CP; k += 4) {
          const float4 xv = *reinterpret_cast<const float4*>(xp + (((k >> 2) ^ s) << 2));
          const float4 wv = *reinterpret_cast<const float4*>(wp + k);
          acc[k] = fmaf(xv.x, wv.x, acc[k]);
          acc[k + 1] = fmaf(xv.y, wv.y, acc[k + 1]);
          acc[k + 2] = fmaf(xv.z, wv.z, acc[k + 2]);
          acc[k + 3] = fmaf(xv.w, wv.w, acc[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[k] = fmaf(xp[k], wp[k], acc[k]);
      }
    }
  }

  // the padding channels hold 0 here: zero x, zero weights, zero bias
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    acc[k] += vs[k];
    s += acc[k];
  }
  if (norm) {
    const float mean = s / (float)C;
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < CP; ++k) {
      if (k < C) {
        const float d = acc[k] - mean;
        v += d * d;
      }
    }
    const float rstd = rsqrtf(v / (float)C + eps);
#pragma unroll
    for (int k = 0; k < CP; ++k) acc[k] = (acc[k] - mean) * rstd * vs[CP + k] + vs[2 * CP + k];
  }

  T* op = out + (((b * H) + py) * W + px) * C;
#pragma unroll
  for (int k = 0; k < CP; ++k) {
    if (k < C) op[k] = from_f32<T>(acc[k]);
  }
}

template <typename T, int CP>
cudaError_t launch_small_c_cp(const void* x, const void* w, const void* bias,
                              const void* cond, const void* gamma, const void* beta,
                              void* out, int B, int H, int W, int C, int norm, float eps,
                              cudaStream_t stream) {
  constexpr int smem = (int)sizeof(float) * small_c_smem_floats<CP>();
  const auto kernel = convnext_front_small_c_kernel<T, CP>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  kernel<<<grid, kTile * kTile, smem, stream>>>(
      (const T*)x, (const T*)w, (const T*)bias, (const T*)cond, (const T*)gamma,
      (const T*)beta, (T*)out, H, W, C, norm, eps);
  return cudaGetLastError();
}

// C < kSmallCLimit; w is [C, 49], the torch layout.
template <typename T>
cudaError_t launch_small_c(const void* x, const void* w, const void* bias, const void* cond,
                           const void* gamma, const void* beta, void* out, int B, int H,
                           int W, int C, int norm, float eps, cudaStream_t stream) {
  if (B > 65535 || (H + kTile - 1) / kTile > 65535) return cudaErrorInvalidValue;
#define COLDDIFF_SMALL_C_LAUNCH(N) \
  launch_small_c_cp<T, N>(x, w, bias, cond, gamma, beta, out, B, H, W, C, norm, eps, stream)
  if (C <= 1) return COLDDIFF_SMALL_C_LAUNCH(1);
  if (C <= 2) return COLDDIFF_SMALL_C_LAUNCH(2);
  if (C <= 4) return COLDDIFF_SMALL_C_LAUNCH(4);
  if (C <= 8) return COLDDIFF_SMALL_C_LAUNCH(8);
  if (C <= 16) return COLDDIFF_SMALL_C_LAUNCH(16);
  return COLDDIFF_SMALL_C_LAUNCH(32);
#undef COLDDIFF_SMALL_C_LAUNCH
}

}  // namespace

// C entry point, bound with ctypes by colddiff_torch/ops/convnext_front.py.
// x, out: [B,H,W,C] (NHWC memory); w: [C,49] (the torch layout [C,1,7,7]);
// bias, gamma, beta: [C]; cond: [B,C] or NULL; gamma/beta are read only
// when norm != 0.  The kernel follows C: C < 32 launches the small-C
// kernel, 32 <= C <= 1024 the tile kernel, 1024 < C <= 8192 its cluster
// form.  dtype: 0 = float32, 1 = bfloat16 (all tensors share it).
// Returns the cudaError_t of the launch (0 = launched); for a cluster
// configuration that the card cannot place, cudaErrorInvalidConfiguration.
extern "C" int colddiff_convnext_front(const void* x, const void* w, const void* bias,
                                       const void* cond, const void* gamma,
                                       const void* beta, void* out, int B, int H, int W,
                                       int C, int norm, float eps, int dtype,
                                       void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C < kSmallCLimit) {
    if (dtype == 0)
      return (int)launch_small_c<float>(x, w, bias, cond, gamma, beta, out, B, H, W, C,
                                        norm, eps, s);
    if (dtype == 1)
      return (int)launch_small_c<__nv_bfloat16>(x, w, bias, cond, gamma, beta, out, B, H,
                                                W, C, norm, eps, s);
    return (int)cudaErrorInvalidValue;
  }
  const TileArgs a{x, w, bias, cond, gamma, beta, out, H, W, C, norm, eps, 0, 0};
  if (dtype == 0) return (int)launch_tile<float>(a, B, s);
  if (dtype == 1) return (int)launch_tile<__nv_bfloat16>(a, B, s);
  return (int)cudaErrorInvalidValue;
}

// The cluster form's configuration for kTileMaxChannels < C <= kMaxChannels
// in dtype (0 = float32, 1 = bfloat16): cfg[0..5] = blocks per cluster k,
// slab S, tile TH, TW, run R, chunk CK.  Returns 0, or cudaErrorInvalidValue
// for a C or dtype that takes no cluster form.
extern "C" int colddiff_convnext_front_cluster(int C, int dtype, int* cfg) {
  if (C <= kTileMaxChannels || C > kMaxChannels || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const auto describe = [&](auto tag) {
    using Cfg = decltype(tag);
    const int v[6] = {(C + Cfg::CAP - 1) / Cfg::CAP, Cfg::CAP, Cfg::TH, Cfg::TW, Cfg::R,
                      Cfg::CK};
    for (int i = 0; i < 6; ++i) cfg[i] = v[i];
    return 0;
  };
  return dtype == 0 ? with_split_cfg<float>(C, describe)
                    : with_split_cfg<__nv_bfloat16>(C, describe);
}
